"""columns_per_s: columns times steps completed in the window over the
window's wall time, which ends in a device synchronisation."""


def read(ctx):
    return ctx.columns * ctx.steps / ctx.window_s
