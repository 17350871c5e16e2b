"""Batches copied from the host a step in the window (``Trainer.host_batches``
delta over the steps): 1 when every batch streams, 0 when the device batch
pool serves them."""


def read(ctx):
    if not ctx.window_steps:
        return None
    return ctx.counters.get("host_batches", 0) / ctx.window_steps
