"""Long-horizon trajectory agreement of the port's step with the scalar
oracle: ``tests/test_trajectory.py``'s gate on the torch step, with its
horizon, tolerances and bounds.

The port's run (``models/coupled.py::run``: the env cache, diagnostics
off, the production step) is held to ``tests/oracle/coupled_ref.py``,
which imports neither JAX nor the port.  Nothing in this module imports
JAX, so ``chip_smoke.py`` runs the same gates on the card at the long
horizons (``OCEAN_BGC_TRAJ_STEPS`` here; the deep world's 1000 steps in
``tests/test_torch_deep_world.py``).

Over at most 120 steps (the pre-chaos horizon) the tolerances are
per channel: the tracers that carry the pH solve's tolerance (DIC,
DIC_ALT_CO2, O2, ALK) within rtol 2e-4, the rest within 5e-7.  Beyond
it the ecosystem is chaotic, and the mismatch is bounded by the model's
own response to a 1-ulp kick of the initial tracers (the chaos
yardstick).  The kicked run rides as extra columns of the run it is
compared with: columns never interact, so one run of twice the width
gives both, in half the steps.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ocean_bgc_tpu_torch.models.coupled import run
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.state import BGC_TRACER_NAMES, BGCTracers as T
from ocean_bgc_tpu_torch.utils.bridge import world_from_numpy
from ocean_bgc_tpu_torch.utils.synthetic import _synthetic_world_numpy
from tests.oracle.coupled_ref import coupled_step_ref

NSTEPS = int(os.environ.get("OCEAN_BGC_TRAJ_STEPS", "120"))
DT = 3600.0
PRE_CHAOS_STEPS = 120
# the 1-ulp kick of the chaos yardstick
ULP_KICK = 1e-15
SOLVE_TRACERS = (T.DIC, T.DIC_ALT_CO2, T.O2, T.ALK)
# the fused interior's qualification (scripts/qualify_fused.py): the
# relative kick of the envelope's initial f32 tracers, its world and its
# steps
QUALIFY_EPS = 1.2e-7
QUALIFY_WORLD = dict(nlev=60, ncol=256, seed=5, ragged=True)
QUALIFY_STEPS = 96


def oracle_state(world):
    """The oracle's state dict from a NumPy world (state, grid, forcing
    dicts as ``_synthetic_world_numpy`` returns them)."""
    state = world[0]
    b = state["bgc"]
    return dict(tracers=b["tracers"], ph_prev=b["ph_prev_3d"],
                ph_prev_alt=b["ph_prev_alt_3d"],
                surface_ph=b["surface_ph"], surface_ph_alt=b["surface_ph_alt"],
                dms=state["dms"], macros=state["macros"])


def oracle_run(world, nsteps, params=None):
    """``nsteps`` oracle steps from a NumPy world; the final state dict."""
    params = params or ModelParams()
    ostate = oracle_state(world)
    for _ in range(nsteps):
        ostate = coupled_step_ref(ostate, world[1], world[2], params, DT)
    return ostate


def widen(world, kick):
    """The world beside a copy of itself whose initial tracers are
    multiplied by ``1 + kick``: every field's columns (its last axis)
    twice, in one world of twice the width."""
    state, grid, forcing = world

    def twice(a):
        return np.concatenate([a, a], axis=-1)

    trc = state["bgc"]["tracers"]
    bgc = {k: twice(v) for k, v in state["bgc"].items()}
    bgc["tracers"] = np.concatenate([trc, trc * (1.0 + kick)], axis=-1)
    return ({"bgc": bgc, "dms": twice(state["dms"]),
             "macros": twice(state["macros"])},
            {k: twice(v) for k, v in grid.items()},
            {k: twice(v) for k, v in forcing.items()})


def port_run(world, nsteps, *, dtype=torch.float64, device="cpu",
             kick=None, params=None, interior_impl="auto", env_cache=True):
    """``nsteps`` steps of the port's ``run`` from a NumPy world, with
    ``interior_impl`` and ``env_cache`` as ``run`` takes them.

    Returns ``(final, kicked)``: the final state as NumPy arrays under the
    oracle's keys, and with ``kick`` the tracers of the kicked copy (the
    extra columns of the same run, :func:`widen`'s, its tracers
    multiplied by ``1 + kick`` in ``dtype``, as the reference scales
    them), else None."""
    params = params or ModelParams()
    ncol = world[1]["kmax"].shape[-1]
    state, grid, forcing = world_from_numpy(
        *(widen(world, 0.0) if kick is not None else world),
        device=device, dtype=dtype)
    if kick is not None:
        tracers = state.bgc.tracers.clone()
        tracers[..., ncol:] *= torch.tensor(1.0 + kick, dtype=dtype,
                                            device=tracers.device)
        state = dataclasses.replace(state, bgc=dataclasses.replace(
            state.bgc, tracers=tracers))
    final, _ = run(state, grid, forcing, params, DT, nsteps,
                   interior_impl=interior_impl, env_cache=env_cache)
    b = final.bgc
    out = {k: v.cpu().numpy() for k, v in dict(
        tracers=b.tracers, ph_prev=b.ph_prev_3d,
        ph_prev_alt=b.ph_prev_alt_3d, surface_ph=b.surface_ph,
        surface_ph_alt=b.surface_ph_alt, dms=final.dms,
        macros=final.macros).items()}
    kicked = None
    if kick is not None:
        kicked = out["tracers"][..., ncol:]
        out = {k: v[..., :ncol] for k, v in out.items()}
    return out, kicked


def fused_qualification(world, nsteps, *, device="cpu"):
    """``scripts/qualify_fused.py``'s qualification of the fused interior
    on the port: ``nsteps`` f32 steps of ``world`` (NumPy) with
    ``interior_impl="fused"`` against as many with the default interior,
    without the env cache, as there.  Per tracer, max|fused - default|
    within 30 times the envelope (the default run's distance from the run
    whose initial f32 tracers are scaled by f32(1 + 1.2e-7), riding as
    extra columns) plus 1e-2 of the tracer's scale plus 1e-12.  Returns
    the worst mismatch over its bound; raises AssertionError naming the
    tracers that fail."""
    want, kicked = port_run(world, nsteps, dtype=torch.float32,
                            device=device, kick=QUALIFY_EPS,
                            env_cache=False)
    got, _ = port_run(world, nsteps, dtype=torch.float32, device=device,
                      interior_impl="fused", env_cache=False)
    g = got["tracers"].astype(np.float64)
    w = want["tracers"].astype(np.float64)
    envelope = np.abs(kicked.astype(np.float64) - w)
    assert np.isfinite(g).all(), "non-finite tracers in the fused run"
    worst = {}
    for idx in range(T.CNT):
        mismatch = np.abs(g[:, idx] - w[:, idx]).max()
        bound = (30.0 * envelope[:, idx].max()
                 + 1e-2 * np.abs(w[:, idx]).max() + 1e-12)
        worst[BGC_TRACER_NAMES[idx]] = float(mismatch / bound)
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    assert not bad, (f"{nsteps} fused f32 steps against the default "
                     f"interior: mismatch / bound {bad}")
    return max(worst.values())


def _ratio(got, want, rtol, atol):
    """The largest |got - want| / (atol + rtol |want|): at most 1 is
    ``np.testing.assert_allclose(got, want, rtol, atol)``."""
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


def oracle_gate(got, want, nsteps, kicked=None, *, chaos=None):
    """``tests/test_trajectory.py``'s assertions on a port run ``got``
    against the oracle's ``want`` (state dicts).  Up to 120 steps the
    per-channel tolerances; beyond (or with ``chaos=True``), each
    tracer's mismatch within ten times the chaos yardstick (``kicked``
    against ``got``) plus 2e-4 of its scale; then the warm-start pH in H
    space.  Returns the worst mismatch over its bound (at most 1); raises
    AssertionError naming the field that fails."""
    g, w = got["tracers"], want["tracers"]
    worst = {}
    if chaos is None:
        chaos = nsteps > PRE_CHAOS_STEPS
    if not chaos:
        for idx in range(T.CNT):
            rtol, atol = ((2e-4, 1e-10) if idx in SOLVE_TRACERS
                          else (5e-7, 1e-18))
            worst[f"tracer {idx}"] = _ratio(g[:, idx], w[:, idx], rtol, atol)
        for name in ("dms", "macros"):
            worst[name] = _ratio(got[name], want[name], 5e-7, 1e-18)
    else:
        if kicked is None:
            raise ValueError("the chaos-yardstick gate needs the kicked "
                             "run")
        yard = np.abs(kicked - g)
        for idx in range(T.CNT):
            mismatch = np.abs(g[:, idx] - w[:, idx]).max()
            bound = (10.0 * yard[:, idx].max()
                     + 2e-4 * np.abs(w[:, idx]).max() + 1e-12)
            worst[f"tracer {idx}"] = float(mismatch / bound)
    worst["H"] = _ratio(10.0 ** (-got["ph_prev"]),
                        10.0 ** (-want["ph_prev"]), 5e-5, 5e-10)
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    assert not bad, (f"{nsteps} steps against the oracle: mismatch / "
                     f"bound {bad}")
    return max(worst.values())


def _world():
    return _synthetic_world_numpy(nlev=6, ncol=4, seed=31, ragged=False)


@pytest.fixture(scope="module")
def oracle_final():
    return oracle_run(_world(), NSTEPS)


@pytest.mark.parametrize("branch", ["horizon", "chaos_yardstick"])
def test_trajectory_matches_oracle(oracle_final, branch):
    """The port's f64 run of NSTEPS steps (120 by default) against the
    oracle's, under the horizon's own branch of the gate, and under the
    chaos-yardstick branch whatever the horizon (its bound is the one a
    long horizon takes; the kicked run rides as extra columns)."""
    if branch == "horizon":
        got, kicked = port_run(_world(), NSTEPS,
                               kick=None if NSTEPS <= PRE_CHAOS_STEPS
                               else ULP_KICK)
        oracle_gate(got, oracle_final, NSTEPS, kicked)
    else:
        got, kicked = port_run(_world(), NSTEPS, kick=ULP_KICK)
        oracle_gate(got, oracle_final, NSTEPS, kicked, chaos=True)


def test_kicked_columns_do_not_touch_the_run():
    """The yardstick's columns leave the run they ride with unchanged:
    the first half of a widened run with no kick is the narrow run (to
    rounding: torch's CPU kernels may round a vectorised tail apart from
    the body), and its second half is the first."""
    world = _world()
    narrow, _ = port_run(world, 3)
    wide, copy = port_run(world, 3, kick=0.0)
    np.testing.assert_array_equal(copy, wide["tracers"])
    for k, v in narrow.items():
        scale = np.abs(v).max() + 1e-300
        np.testing.assert_allclose(wide[k] / scale, v / scale, rtol=0,
                                   atol=1e-13, err_msg=k)


def test_fused_qualification_on_the_plain_route():
    """:func:`fused_qualification` (the card runs it on
    ``QUALIFY_WORLD`` for ``QUALIFY_STEPS``) at 6 x 8 for 4 steps; on CPU
    tensors the fused interior is its plain version, the default
    interior's code."""
    world = _synthetic_world_numpy(**dict(QUALIFY_WORLD, nlev=6, ncol=8))
    assert 0.0 <= fused_qualification(world, 4) <= 1.0
