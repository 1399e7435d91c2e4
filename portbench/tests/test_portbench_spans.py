"""The readers of the program's spans (``portbench/spans.py`` and the six
metrics on it) on a trace and a span list made by hand: which steps the
window takes, the card's idle time inside the level loop, 0 for a layer
the steps ran without and None where no step was found."""

import sys
from collections import namedtuple
from types import SimpleNamespace

import pytest

from portbench.run import reader
from portbench.spans import PROFILING, overlap_ns
from portbench.trace import Kernel, Trace

# the program's span record, field for field
Span = namedtuple("Span", "index name start_ns end_ns parent root counts")
METRICS = ("surface_host_ms_per_step", "interior_host_ms_per_step",
           "kinetics_host_ms_per_step", "loop_host_ms_per_step",
           "loop_idle_ms_per_step", "host_syncs_per_step")
EAGER = "void at::native::vectorized_elementwise_kernel<2, add>(int)"


def _step(first, start, loop=True, syncs=0):
    """A step root at ``start`` (ns) and its spans; indices from
    ``first``."""
    i = first
    spans = [Span(i + 1, "step.surface", start, start + 200, i, i, {}),
             Span(i + 3, "interior.kinetics", start + 300, start + 600,
                  i + 2, i, {})]
    if loop:
        spans.append(Span(i + 4, "interior.level_loop", start + 600,
                          start + 1600, i + 2, i, {}))
    spans += [Span(i + 2, "step.interior", start + 200, start + 1800, i, i,
                   {}),
              Span(i, "step", start, start + 2000, None, i,
                   {"host_syncs": syncs} if syncs else {})]
    return spans


def _world(loop=True, syncs=0):
    """A warm-up step before the trace, two traced steps, and the two
    steps traced with the host's operators ~30 s later."""
    spans = (_step(0, 100 - 2000, loop, syncs) + _step(10, 900, loop, syncs)
             + _step(20, 3000, loop, syncs)
             + _step(30, 30_000_000_000, loop, syncs)
             + _step(40, 30_000_003_000, loop, syncs))
    # the card busy from the first traced kernel to the last, with gaps
    # at [1600, 1700], [2000, 2400] (step 1's loop: [1500, 2500]) and
    # [3100, 3200], [4000, 4100] (step 2's loop: [3600, 4600])
    busy = [(1000, 1600), (1700, 2000), (2400, 3100), (3200, 4000),
            (4100, 5000)]
    trace = Trace(1000, 5000, kernels=[Kernel(EAGER, s, e, 1)
                                       for s, e in busy])
    return spans, SimpleNamespace(trace=trace, steps=2)


@pytest.fixture()
def program(monkeypatch):
    """Puts a program that records ``spans`` in the run's modules."""

    def load(spans):
        monkeypatch.setitem(sys.modules, PROFILING,
                            SimpleNamespace(spans=lambda: list(spans)))
    return load


def _read(ctx):
    return {name: reader(name)(ctx) for name in METRICS}


def test_the_window_takes_the_traced_steps_alone(program):
    spans, ctx = _world(syncs=1)
    program(spans)
    got = _read(ctx)
    # per traced step, in ms: surface 200 ns, interior 1600, kinetics
    # 300, loop 1000; the first traced step starts before the first
    # kernel and is in, the warm-up step ends before it and the later
    # steps start after the last, and are out
    assert got["surface_host_ms_per_step"] == pytest.approx(200e-6)
    assert got["interior_host_ms_per_step"] == pytest.approx(1600e-6)
    assert got["kinetics_host_ms_per_step"] == pytest.approx(300e-6)
    assert got["loop_host_ms_per_step"] == pytest.approx(1000e-6)
    assert got["host_syncs_per_step"] == 1.0


def test_idle_inside_the_loop_is_the_intersection(program):
    spans, ctx = _world()
    program(spans)
    # gaps [1600, 1700] and [2000, 2400] in step 1's loop [1500, 2500]:
    # 500 ns; [3100, 3200] and [4000, 4100] against step 2's [3600,
    # 4600]: 100 ns
    assert reader("loop_idle_ms_per_step")(ctx) == pytest.approx(
        600 / 2 / 1e6)
    assert overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert overlap_ns([(0, 10)], []) == 0


def test_a_layer_the_steps_ran_without_reads_zero(program):
    spans, ctx = _world(loop=False)
    program(spans)
    got = _read(ctx)
    assert got["loop_host_ms_per_step"] == 0.0
    assert got["loop_idle_ms_per_step"] == 0.0
    assert got["host_syncs_per_step"] == 0.0
    assert got["kinetics_host_ms_per_step"] == pytest.approx(300e-6)


def test_no_step_found_reads_nothing(program, monkeypatch):
    spans, ctx = _world()
    # a program that records no spans (none loaded, or no reader)
    monkeypatch.delitem(sys.modules, PROFILING, raising=False)
    assert set(_read(ctx).values()) == {None}
    monkeypatch.setitem(sys.modules, PROFILING, SimpleNamespace())
    assert set(_read(ctx).values()) == {None}
    # more or fewer step roots in the window than traced steps
    program(spans)
    for steps in (1, 3):
        assert set(_read(SimpleNamespace(trace=ctx.trace,
                                         steps=steps)).values()) == {None}
    program([s for s in spans if s.name != "step"])
    assert set(_read(ctx).values()) == {None}
