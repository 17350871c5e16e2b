"""Share of the profiled stretch in which the device ran nothing: one minus
the union of its kernels', copies' and sets' intervals over the stretch's
length (``torch.profiler``'s device trace)."""


def read(ctx):
    s = ctx.stretch
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
