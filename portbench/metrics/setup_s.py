"""setup_s: seconds from the process's start to the first timed step:
imports, the card's start, the kernels' build or load, the world and
the forcing records, and the warm-up steps."""


def read(ctx):
    return ctx.setup_s
