"""loop_host_ms_per_step: the host's wall time per traced step inside the
sinking-particle level loop, the program's own ``interior.level_loop``
spans (``portbench/spans.py``); 0 where the steps ran without such a
span."""

from portbench.spans import host_ms_per_step


def read(ctx):
    return host_ms_per_step(ctx, "interior.level_loop")
