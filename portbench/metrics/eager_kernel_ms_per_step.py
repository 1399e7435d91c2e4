"""eager_kernel_ms_per_step: device time per step of the kernels that
are not built from the program's CUDA sources (PyTorch's own), from the
traced window."""

from portbench.trace import base_name


def read(ctx):
    ns = sum(k.end_ns - k.start_ns for k in ctx.trace.kernels
             if base_name(k.name) not in ctx.csrc_names)
    if not ns or not ctx.steps:
        return None
    return ns / 1e6 / ctx.steps
