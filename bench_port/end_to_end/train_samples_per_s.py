"""Samples trained a second: every row of every step after the warm-up that
the trainer's lagged readback consumed, over the whole window's seconds on
the host clock (from the synchronisation after the warm-up to the one after
the readback drained)."""


def read(ctx):
    if not ctx.window_s or ctx.window_s <= 0:
        return None
    return ctx.samples / ctx.window_s
