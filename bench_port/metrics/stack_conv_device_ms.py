"""Device milliseconds a step of the kernels of ``StackProjection``'s
strided convolution, forward and both gradients (``kernels/stack_conv.txt``)."""


def read(ctx):
    return ctx.kernel_ms_per_step("stack_conv")
