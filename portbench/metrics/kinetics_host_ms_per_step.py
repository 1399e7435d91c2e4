"""kinetics_host_ms_per_step: the host's wall time per traced step inside
the batched ecosystem kinetics, the program's own ``interior.kinetics``
spans (``portbench/spans.py``); 0 where the steps ran without such a
span."""

from portbench.spans import host_ms_per_step


def read(ctx):
    return host_ms_per_step(ctx, "interior.kinetics")
