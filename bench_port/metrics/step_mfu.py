"""The whole training step's share of one H100's bfloat16 peak: the model's
matrix-product operations of every sample trained in the traced run's
unprofiled stretch, each at its own length (the reference module's
``step_flops_per_sample``: counted from the configuration's shapes, nothing
recomputed, padding not counted), over that stretch's seconds on the host
clock and 989 TFLOP/s."""


def read(ctx):
    if not ctx.unprofiled_batches or not ctx.unprofiled_s:
        return None
    flops = sum(ctx.reference.step_flops_per_sample(ctx.model, int(n), ctx.n_channels,
                                                    ctx.n_outputs)
                for b in ctx.unprofiled_batches for n in b["lengths"])
    return 100.0 * flops / ctx.unprofiled_s / ctx.work.PEAK_OPS["bfloat16"]
