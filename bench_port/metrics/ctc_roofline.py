"""The CTC kernels' share of their roofline: the least time of the profiled
steps' CTC losses with their gradients (``work.ctc_fused_bound_s`` of each
batch's rows at the padded stacked frames, vocabulary and padded target
width: the log-probs and their gradient are read and written whole) over
the device time of the kernels in ``kernels/ctc.txt``."""


def read(ctx):
    if ctx.method != "ctc" or not ctx.stretch_batches:
        return None
    s = ctx.stretch.kernel_s("ctc")
    if not s:
        return None
    stack = ctx.model["encoder"]["embedder"]["stack"]
    bins = int(ctx.widths["bins"])
    frames = (bins - int(stack["size"])) // int(stack["stride"]) + 1 if stack["active"] else bins
    width = int(ctx.widths["targets"])
    bound = sum(ctx.work.ctc_fused_bound_s(b["rows"], frames, ctx.n_outputs, width)
                for b in ctx.stretch_batches)
    return 100.0 * bound / s
