"""The program's own spans and counters over the traced steps, for the
per-layer metrics that read them.

The program records a span (``ocean_bgc_tpu_torch/utils/profiling.py``:
name, start and end on the wall clock, parent, root, the counters'
changes) around each layer of its step while ``torch.profiler`` records,
on the clock the profiler stamps the card's events with.  A traced run
records its ``trace_steps`` steps with the card's activity alone, runs
the untraced window, then records 2 steps with the host's operators;
the spans read here are those of the ``step`` roots that overlap the
first trace's bounds (``ctx.trace``), so the 2 later steps are left out.

This module imports nothing of the program: it reads the program's
module where the run has loaded it (``program.py`` is the harness's one
importer of the program), and finds nothing where the program records no
spans.
"""

from __future__ import annotations

import sys

PROFILING = "ocean_bgc_tpu_torch.utils.profiling"


def recorded():
    """The program's recorded spans, or None where the program records
    none."""
    read = getattr(sys.modules.get(PROFILING), "spans", None)
    return read() if callable(read) else None


def step_spans(ctx):
    """(the ``step`` roots of the traced steps, every span under them),
    or None unless exactly ``ctx.steps`` roots overlap the trace's
    bounds (which also holds the spans and the trace to one clock)."""
    spans = recorded() if ctx.trace is not None else None
    if spans is None:
        return None
    lo, hi = ctx.trace.start_ns, ctx.trace.end_ns
    roots = [s for s in spans if s.name == "step" and s.parent is None
             and s.end_ns > lo and s.start_ns < hi]
    if not roots or len(roots) != ctx.steps:
        return None
    ids = {s.index for s in roots}
    return roots, [s for s in spans if s.root in ids and s.parent is not None]


def intervals(ctx, name):
    """The sorted (start, end) of the spans called ``name`` in the traced
    steps, and the number of steps; None where :func:`step_spans` is."""
    found = step_spans(ctx)
    if found is None:
        return None
    roots, inside = found
    return sorted((s.start_ns, s.end_ns) for s in inside
                  if s.name == name), len(roots)


def host_ms_per_step(ctx, name):
    """The host's time in the spans called ``name``, per traced step: 0
    where the steps ran without such a span."""
    found = intervals(ctx, name)
    if found is None:
        return None
    spans, steps = found
    return sum(e - s for s, e in spans) / 1e6 / steps


def overlap_ns(a, b):
    """The time two sorted lists of disjoint (start, end) intervals share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
