"""surface_host_ms_per_step: the host's wall time per traced step inside
the surface fluxes (the BGC O2/CO2 pair and DMS), the program's own
``step.surface`` spans (``portbench/spans.py``); 0 where the steps ran
without such a span."""

from portbench.spans import host_ms_per_step


def read(ctx):
    return host_ms_per_step(ctx, "step.surface")
