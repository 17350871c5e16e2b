"""The flash attention kernels' share of their roofline: the least time of
the profiled steps' attention forward and backward in every layer
(``work.flash_bound_s`` of each batch's valid key lengths, the padded query
count, heads and head size) over the device time of the kernels in
``kernels/flash.txt`` (forward, delta, dQ, dK / dV)."""


def read(ctx):
    if not ctx.stretch_batches:
        return None
    s = ctx.stretch.kernel_s("flash")
    if not s:
        return None
    tr = ctx.model["encoder"]["transformer"]
    bins = int(ctx.widths["bins"])
    bound = sum(ctx.work.flash_bound_s(b["lengths"], bins, tr["n_heads"],
                                       tr["hidden_size"] // tr["n_heads"], tr["n_layers"])
                for b in ctx.stretch_batches)
    return 100.0 * bound / s
