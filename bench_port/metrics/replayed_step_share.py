"""Share of the window's train steps that replayed a captured step graph
(``step_graph.REPLAYS`` over replays and eager steps, counter deltas over
the window)."""


def read(ctx):
    replays, eager = ctx.counters.get("replays", 0), ctx.counters.get("eager_steps", 0)
    if replays + eager == 0:
        return None
    return 100.0 * replays / (replays + eager)
