"""Device milliseconds a step of the optimizer: AdamW's multi-tensor kernels
and the gradients' zeroing (``kernels/optimizer.txt``)."""


def read(ctx):
    return ctx.kernel_ms_per_step("optimizer")
