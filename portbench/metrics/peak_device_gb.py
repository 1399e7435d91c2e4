"""peak_device_gb: the most device memory PyTorch held at once, over
set-up and window (``torch.cuda.max_memory_allocated`` after a reset at
the start), in GB (1e9 bytes)."""


def read(ctx):
    if ctx.memory_peak_bytes is None:
        return None
    return ctx.memory_peak_bytes / 1e9
