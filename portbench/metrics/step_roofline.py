"""step_roofline: the least time of one step by bytes (the state, the
forcing and the grid read once, the state written once, at the HBM
rate; ``roofline.step_bytes``) over the wall time per step of the
window's steps after the traced ones, by the host's clock.  It depends
on the step's inputs and outputs, not on which kernels compute them."""

from portbench.roofline import seconds_at_peak, step_bytes


def read(ctx):
    if not ctx.step_wall_s:
        return None
    least = seconds_at_peak(step_bytes(ctx.levels, ctx.columns, ctx.dtype))
    return 100.0 * least / ctx.step_wall_s
