"""host_syncs_per_step: the program's device-to-host readbacks and waits
for the card per traced step, the changes of its ``host_syncs`` counter
over its ``step`` spans (``portbench/spans.py``)."""

from portbench.spans import step_spans


def read(ctx):
    found = step_spans(ctx)
    if found is None:
        return None
    roots, _ = found
    return sum(s.counts.get("host_syncs", 0) for s in roots) / len(roots)
