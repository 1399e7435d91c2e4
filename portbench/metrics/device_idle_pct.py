"""device_idle_pct: the share of a step's wall time in which no kernel and
no copy runs on the card: the device's busy time per step (the union of
its activity intervals over the traced steps) against the wall time per
step of the untraced window, since recording the card's activity slows
the host, which paces this step."""


def read(ctx):
    if not ctx.step_wall_s or not ctx.steps:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.steps / ctx.step_wall_s)
