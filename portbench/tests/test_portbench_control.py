"""``correct`` comes out false for the control and for each fault of the
timed path that a cell can have; true for the program as it is.

Each test drives the rest of a run on the CPU at a tiny size (the card's
look is skipped), with the program's step replaced underneath.  The
faults: a step that returns its state unchanged (it computes the new
one and drops it, so the window's pace stays the program's); half of the columns
left out (they keep their state); an answer altered where it is produced
(DIC off by a millionth in every cell).  A cell of one chip has no
exchange between chips to leave out.  The control is the program on its
own float32 path, the precision below the configuration's float64."""

import dataclasses

import pytest
import torch

from portbench import program
from portbench.run import resolve, run_cell

CELLS = ("ec30to60.coupled", "rrs18to6-share.coupled", "ec30to60.spinup")
TINY = dict(device="cpu", columns=24, levels=8)
DIC = 6


def unchanged(state, grid, forcing, params, dt, **kw):
    _, diags = program.step(state, grid, forcing, params, dt, **kw)
    return state, diags


def half_left_out(state, grid, forcing, params, dt, **kw):
    new, diags = program.step(state, grid, forcing, params, dt, **kw)
    keep = torch.arange(grid.ncol) < grid.ncol // 2

    def pick(a, b):
        return torch.where(keep, a, b)

    bgc = dataclasses.replace(new.bgc, **{
        f.name: pick(getattr(new.bgc, f.name), getattr(state.bgc, f.name))
        for f in dataclasses.fields(new.bgc)})
    return dataclasses.replace(new, bgc=bgc, dms=pick(new.dms, state.dms),
                               macros=pick(new.macros, state.macros)), diags


def altered(state, grid, forcing, params, dt, **kw):
    new, diags = program.step(state, grid, forcing, params, dt, **kw)
    trc = new.bgc.tracers.clone()
    trc[:, DIC] *= 1.0 + 1e-6
    return dataclasses.replace(
        new, bgc=dataclasses.replace(new.bgc, tracers=trc)), diags


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered],
                         ids=lambda f: f.__name__)
def test_a_fault_in_the_timed_path_is_not_correct(workload, fault):
    result, lines = run_cell(resolve(workload), 2**32 + 17, 0.3, False,
                             step_fn=fault, **TINY)
    assert not result["correct"], lines


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    result, lines = run_cell(resolve(workload), 2**32 + 19, 0.3, False,
                             dtype="float32", **TINY)
    assert not result["correct"], lines
    # it fails on the precision, not on a crash or a non-finite value
    checks = result["checks"]
    assert checks["nonfinite_values"]["value"] == 0
    assert any(c["value"] > c["limit"] for c in checks.values())


def test_a_fault_after_the_horizon_is_not_correct(monkeypatch):
    """A fault that starts after the check's horizon (a cache gone stale,
    a buffer that drifts) is caught over the last step, which the
    reference takes up from the program's own state."""
    from portbench import check
    lim = dict(check.limits_for("ec30to60.coupled"), check_steps=2)
    monkeypatch.setattr(check, "limits_for", lambda workload: lim)
    calls = []

    def late(state, grid, forcing, params, dt, **kw):
        calls.append(1)
        if len(calls) <= 4:
            return program.step(state, grid, forcing, params, dt, **kw)
        return altered(state, grid, forcing, params, dt, **kw)

    result, lines = run_cell(resolve("ec30to60.coupled"), 2**32 + 23, 0.3,
                             False, step_fn=late, **TINY)
    assert len(calls) > 5, lines
    checks = result["checks"]
    assert not result["correct"], lines
    early = ("tracers_gap", "trace_gas_gap", "ph_gap")
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in early)
    assert checks["last_tracers_gap"]["value"] > checks["last_tracers_gap"][
        "limit"]
