"""Calls a step by which the host hands the device work: kernel and graph
launches, copies and sets (the profiler's CUDA runtime and driver rows)."""

LAUNCHES = r"Launch|Memcpy|Memset"


def read(ctx):
    s = ctx.stretch
    if s is None or not s.steps:
        return None
    return s.runtime_calls(LAUNCHES) / s.steps
