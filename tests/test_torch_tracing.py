"""The port's spans and counters (``utils/profiling.py``) on the CPU.

Spans nest with their parent and step; without a profiler ``span`` is
one shared no-op; under ``torch.profiler`` a 6-level, 4-column step
records the layers' spans, once each (the level loop once, not once a
level), and ``profiling.trace`` writes them into its Chrome trace;
``host_syncs`` counts the env check's readback; outputs are bitwise the
same with the spans on and off; the kernels' launch counts live in the
one registry.  The clock the spans share with the card's kernels is held
on the card (``tests/test_torch_cuda.py``).  No JAX."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ocean_bgc_tpu_torch.models.coupled import step
from ocean_bgc_tpu_torch.ops import cuda_carbonate, cuda_step
from ocean_bgc_tpu_torch.ops.bgc import precompute_env
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.utils import profiling
from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world

DT = 3600.0
# the spans of a step, by parent
STEP_CHILDREN = {"step.surface", "step.interior", "step.dms", "step.macros",
                 "step.deposit", "step.update"}
INTERIOR_CHILDREN = {"interior.carbonate", "interior.kinetics",
                     "interior.level_loop", "interior.assembly"}


@pytest.fixture(scope="module")
def world():
    return synthetic_world(nlev=6, ncol=4, seed=3, device="cpu")


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _recorded(fn):
    """The spans recorded while ``fn()`` runs under the profiler."""
    profiling.reset_spans()
    with _cpu_profile():
        fn()
    return profiling.spans()


def test_spans_nest_with_their_parent_and_step():
    def nested():
        for _ in range(2):
            with profiling.span("step"):
                with profiling.span("step.interior"):
                    with profiling.span("interior.level_loop"):
                        profiling.count("test.inner", 2)
                with profiling.span("step.update"):
                    pass

    recs = _recorded(nested)
    assert [r.name for r in recs] == [
        "interior.level_loop", "step.interior", "step.update", "step"] * 2
    by = {r.index: r for r in recs}
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.name == "step":
            assert r.parent is None and r.root == r.index
            assert r.counts == {"test.inner": 2}
            continue
        parent = by[r.parent]
        assert parent.start_ns <= r.start_ns and r.end_ns <= parent.end_ns
        assert parent.name == {"interior.level_loop": "step.interior"}.get(
            r.name, "step")
        assert by[r.root].name == "step" and r.root in (recs[3].index,
                                                        recs[7].index)
    assert recs[0].root == recs[3].index and recs[4].root == recs[7].index
    assert recs[0].counts == {"test.inner": 2}
    assert recs[2].counts == {}


def test_span_without_profiler_is_one_shared_no_op(monkeypatch):
    profiling.reset_spans()

    def no_clock():
        raise AssertionError("a span read the clock with no profiler")

    monkeypatch.setattr(profiling.time, "time_ns", no_clock)
    a, b = profiling.span("step"), profiling.span("step.surface")
    assert a is b
    with a:
        with b:
            pass
    assert profiling.spans() == []


def test_a_step_records_the_layers_spans(world):
    s, g, f = world
    p = ModelParams()

    def run():
        env = precompute_env(g, f, p.bgc)
        s1, _ = step(s, g, f, p, DT, compute_diags=False, env=env)
        step(s1, g, f, p, DT)        # the default call, diagnostics on

    recs = _recorded(run)
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["precompute_env", "step", "step"]
    by = {r.index: r for r in recs}
    for n, root in enumerate(roots[1:]):
        mine = [r for r in recs if r.root == root.index and r is not root]
        children = [r.name for r in mine if r.parent == root.index]
        assert sorted(children) == sorted(STEP_CHILDREN)
        interior = next(r for r in mine if r.name == "step.interior")
        inner = [r.name for r in mine if r.parent == interior.index]
        # the level loop is one span a step, not one a level
        want = INTERIOR_CHILDREN | ({"interior.diags"} if n else set())
        assert sorted(inner) == sorted(want)
        assert len(mine) == len(STEP_CHILDREN) + len(want)
        assert all(by[r.parent].start_ns <= r.start_ns
                   and r.end_ns <= by[r.parent].end_ns for r in mine)
    # nothing is recorded with the profiler off
    step(s, g, f, p, DT, compute_diags=False)
    assert len(profiling.spans()) == len(recs)


def test_trace_json_holds_the_spans(world, tmp_path):
    s, g, f = world
    p = ModelParams()
    with profiling.trace(str(tmp_path)):
        s1, _ = step(s, g, f, p, DT, compute_diags=False)
        step(s1, g, f, p, DT, compute_diags=False)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e.get("name") for e in events if e.get("ph") == "X"]
    assert names.count("step") == 2
    assert names.count("interior.level_loop") == 2
    for name in STEP_CHILDREN | INTERIOR_CHILDREN:
        assert names.count(name) == 2, name


@pytest.mark.parametrize("check", [False, True], ids=["unchecked",
                                                      "checked"])
def test_host_syncs_count_the_env_check(world, monkeypatch, check):
    """``OBGC_CHECK_ENV=1`` reads one scalar back each step.  A readback
    of a CPU tensor is no host synchronisation, so on the CPU the count
    stays 0; counting every readback as a card's, the check adds exactly
    one a step (the plain pH solve's own readbacks, which the card's
    kernels do not make, come on both sides)."""
    s, g, f = world
    p = ModelParams()
    env = precompute_env(g, f, p.bgc)
    if check:
        monkeypatch.setenv("OBGC_CHECK_ENV", "1")
    else:
        monkeypatch.delenv("OBGC_CHECK_ENV", raising=False)

    def syncs_per_step(nsteps=2):
        state = s
        before = profiling.counters()["host_syncs"]
        counts = []
        for _ in range(nsteps):
            n = profiling.counters()["host_syncs"]
            state, _ = step(state, g, f, p, DT, compute_diags=False,
                            env=env)
            counts.append(profiling.counters()["host_syncs"] - n)
        assert sum(counts) == profiling.counters()["host_syncs"] - before
        return counts

    assert syncs_per_step() == [0, 0]
    monkeypatch.setattr(profiling, "_on_card", lambda t: True)
    every = syncs_per_step()
    monkeypatch.setenv("OBGC_CHECK_ENV", "0")
    assert [a - b for a, b in zip(every, syncs_per_step())] == (
        [1, 1] if check else [0, 0])


def test_outputs_are_bitwise_with_spans_on_and_off(world):
    s, g, f = world
    p = ModelParams()
    off_state, off_diags = step(s, g, f, p, DT)
    with _cpu_profile():
        on_state, on_diags = step(s, g, f, p, DT)
    for a, b in zip((off_state.bgc.tracers, off_state.dms,
                     off_state.macros, off_state.bgc.surface_ph),
                    (on_state.bgc.tracers, on_state.dms, on_state.macros,
                     on_state.bgc.surface_ph)):
        assert torch.equal(a, b)
    assert off_diags.keys() == on_diags.keys()
    assert all(torch.equal(off_diags[k], on_diags[k]) for k in off_diags)


def test_counters_are_one_registry():
    before = profiling.counters()
    profiling.count("test.registry")
    profiling.count("test.registry", 4)
    after = profiling.counters()
    assert after["test.registry"] - before["test.registry"] == 5
    assert after["never.counted"] == 0
    after["test.registry"] += 100          # a copy, not the registry
    assert profiling.counters()["test.registry"] == (
        before["test.registry"] + 5)
    # the kernels' launch counts are the registry's alone
    for fn in (cuda_carbonate.co3_terms_dual_coeffs,
               cuda_carbonate.carbonate_coeffs_sat,
               cuda_carbonate.solve_htotal_brackets,
               cuda_step._launch_solve, cuda_step._launch_bio):
        assert not {"launches", "seeded_launches",
                    "stats_launches"} & set(vars(fn))
