"""k1_roofline: for the launches of K1's instances in the traced
window (``lanes_kernel`` and ``parked_lanes_kernel`` of
``csrc/carbonate_dual.cu``), the least time by bytes over their device
time.  A launch's bytes follow from its instance (in its name) and its
lanes: the dual instance solves every cell of the mesh; the bracket-in
instance either the surface pair (two lanes a column) or one lane a cell
(the env cache's stand-in), told apart by the launch's threads, one a
lane.  A launch that matches neither is left out."""

from portbench.roofline import (k1_bracket_bytes, k1_dual_bytes,
                                seconds_at_peak)
from portbench.trace import base_name

K1_KERNELS = ("lanes_kernel", "parked_lanes_kernel")


def launch_bytes(kernel, levels, columns, dtype):
    """The least bytes of one K1 launch, or None."""
    cells = levels * columns
    if "DualLanes" in kernel.name:
        return k1_dual_bytes(cells, dtype)
    if "BracketLanes" in kernel.name and kernel.threads:
        # one thread a lane: the largest lane count the grid covers
        fits = [(lanes, shared) for lanes, shared in
                ((cells, cells), (2 * columns, columns))
                if lanes <= kernel.threads]
        if fits:
            return k1_bracket_bytes(*fits[0], dtype)
    return None


def read(ctx):
    nbytes, ns = 0, 0
    for k in ctx.trace.kernels:
        if base_name(k.name) not in K1_KERNELS:
            continue
        b = launch_bytes(k, ctx.levels, ctx.columns, ctx.dtype)
        if b is None:
            continue
        nbytes += b
        ns += k.end_ns - k.start_ns
    if not ns:
        return None
    return 100.0 * seconds_at_peak(nbytes) / (ns / 1e9)
