"""loop_idle_ms_per_step: the card's idle time per traced step while the
host is inside the sinking-particle level loop: the idle gaps of the
card-only trace (no kernel and no copy running) intersected with the
program's ``interior.level_loop`` spans, on the clock they share
(``portbench/spans.py``); 0 where the steps ran without the loop."""

from portbench.spans import intervals, overlap_ns


def read(ctx):
    found = intervals(ctx, "interior.level_loop")
    if found is None:
        return None
    loops, steps = found
    return overlap_ns(ctx.trace.idle_gaps(), loops) / 1e6 / steps
