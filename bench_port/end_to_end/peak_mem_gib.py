"""The run's peak of device memory, in GiB: ``torch.cuda.max_memory_allocated``
over set-up, warm-up and window (read before the reference runs)."""


def read(ctx):
    return ctx.peak_bytes / 2**30
