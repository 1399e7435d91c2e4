"""host_ms_per_step: the host's wall time inside the program's calls
(``step``, and ``precompute_env`` where the mix keeps an env cache) per
step, over the window's steps after the traced ones, from the
benchmark's own spans around those calls, without a synchronisation.
Near the wall time per step, the host paces the card."""


def read(ctx):
    if not ctx.host_steps:
        return None
    return ctx.host_ns / 1e6 / ctx.host_steps
