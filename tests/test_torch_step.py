"""The slice end to end: the port's production step (diagnostics off, env
cache on) against the JAX package's, at f64 and f32, on one small ragged
world per dtype; plus the scipy oracle and the inactive-lane stand-in.
The step's options on top of the diags-off call are in
``tests/test_torch_step_options.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import ocean_bgc_tpu  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from ocean_bgc_tpu.models.coupled import step as jax_step
from ocean_bgc_tpu.ops.bgc import precompute_env as jax_precompute_env
from ocean_bgc_tpu.params import ModelParams as JaxModelParams
from ocean_bgc_tpu.utils.synthetic import synthetic_world as jax_world

from ocean_bgc_tpu_torch.constants import XACC
from ocean_bgc_tpu_torch.models.coupled import CoupledState, step
from ocean_bgc_tpu_torch.ops.bgc import precompute_env
from ocean_bgc_tpu_torch.state import BGCState, BGCTracers as T
from ocean_bgc_tpu_torch.utils.bridge import params_from_dict, world_from_numpy
from ocean_bgc_tpu_torch.utils.profiling import counters
from tests.oracle.coupled_ref import coupled_step_ref

NLEV, NCOL, NSTEPS, DT = 8, 32, 3, 3600.0
XACC_F32 = 1e-5 * 1e-8


def _np(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return np.asarray(x)


@pytest.fixture(scope="module", params=["float64", "float32"])
def trajectories(request):
    """NSTEPS states of each package from one world (built once per
    dtype: a JAX step compile costs seconds here)."""
    jdt = None if request.param == "float64" else jnp.float32
    js, jg, jf = jax_world(nlev=NLEV, ncol=NCOL, seed=21, ragged=True,
                           dtype=jdt)
    kmax = np.asarray(jg.kmax)
    assert (kmax == 0).any() and ((kmax > 0) & (kmax < NLEV)).any()
    jp = JaxModelParams()
    jenv = jax_precompute_env(jg, jf, jp.bgc)
    jfn = jax.jit(lambda s: jax_step(s, jg, jf, jp, DT, compute_diags=False,
                                     env=jenv)[0])
    ts, tg, tf = world_from_numpy(_np(js), _np(jg), _np(jf), device="cpu",
                                  dtype=getattr(torch, request.param))
    tp = params_from_dict(dataclasses.asdict(jp))
    tenv = precompute_env(tg, tf, tp.bgc)
    jout, tout = [], []
    for _ in range(NSTEPS):
        js = jfn(js)
        ts, diags = step(ts, tg, tf, tp, DT, compute_diags=False, env=tenv)
        assert diags == {}
        jout.append(_np(js))
        tout.append(ts)
    return request.param, jout, tout, tg


def test_step_matches_jax(trajectories):
    """Tracers, DMS and MACROS after each of 3 steps.  The interior pH
    feeds only the warm-start carry, so these differ only through
    per-op rounding: at f64 libm/XLA ulps (1e-13 of each field's scale;
    measured ~5e-16), at f32 the same ops in single precision (1e-5 of
    each tracer's scale, the scaled-atol form of
    tests/test_pallas_carbonate.py; measured ~2e-7)."""
    dtype, jout, tout, _ = trajectories
    tol = 1e-13 if dtype == "float64" else 1e-5
    for k, (j, t) in enumerate(zip(jout, tout)):
        a = j["bgc"]["tracers"]
        b = t.bgc.tracers.numpy()
        assert b.dtype == a.dtype and np.isfinite(b).all()
        for i in range(T.CNT):
            scale = np.abs(a[:, i]).max() + 1e-30
            np.testing.assert_allclose(b[:, i] / scale, a[:, i] / scale,
                                       rtol=0, atol=tol,
                                       err_msg=f"step {k} tracer {i}")
        for name in ("dms", "macros"):
            a, b = j[name], getattr(t, name).numpy()
            scale = np.abs(a).max(axis=(0, 2), keepdims=True) + 1e-30
            np.testing.assert_allclose(b / scale, a / scale, rtol=0,
                                       atol=tol, err_msg=f"step {k} {name}")


def test_ph_fields_match_jax_to_solver_tolerance(trajectories):
    """The interior roots come from differently built brackets (the
    kernel's pH-space window here, H-space warm brackets on JAX's XLA
    path), so they agree to solver tolerance |dH| <= 2 xacc, with the
    f32 pH output's own rounding (two ulps of pH, in H) added at f32."""
    dtype, jout, tout, _ = trajectories
    xacc = XACC if dtype == "float64" else XACC_F32
    for j, t in zip(jout, tout):
        for name in ("ph_prev_3d", "ph_prev_alt_3d", "surface_ph",
                     "surface_ph_alt"):
            a = j["bgc"][name]
            b = getattr(t.bgc, name).numpy()
            # cells without a solution keep the 0 sentinel in both
            np.testing.assert_array_equal(a == 0.0, b == 0.0, err_msg=name)
            a64, b64 = a.astype(np.float64), b.astype(np.float64)
            ha = np.where(a64 != 0.0, 10.0 ** -a64, 0.0)
            hb = np.where(b64 != 0.0, 10.0 ** -b64, 0.0)
            ulp = np.spacing(np.abs(a)).astype(np.float64)
            tol = 2 * xacc + (2 * np.log(10.0) * ha * ulp
                              if dtype == "float32" else 0.0)
            assert (np.abs(ha - hb) <= tol).all(), name


def test_inactive_lane_stand_in_leaves_outputs_unchanged():
    """Below-floor cells solve the stand-in problem with PO4 = SiO3 = 0
    (the host's padding never reaches the solve), and their results are
    discarded: fill values there change no public output."""
    state, grid, forcing = world_from_numpy(
        *_np_world(), device="cpu", dtype=torch.float64)
    params = params_from_dict(dataclasses.asdict(JaxModelParams()))
    env = precompute_env(grid, forcing, params.bgc)
    below = ~grid.active_mask()
    assert below.any()
    trc = state.bgc.tracers.clone()
    for i in (T.PO4, T.SIO3):
        trc[:, i] = torch.where(below, 1e6, trc[:, i])
    filled = CoupledState(
        bgc=dataclasses.replace(state.bgc, tracers=trc), dms=state.dms,
        macros=state.macros)
    a, b = state, filled
    for _ in range(2):
        a, _ = step(a, grid, forcing, params, DT, compute_diags=False,
                    env=env)
        b, _ = step(b, grid, forcing, params, DT, compute_diags=False,
                    env=env)
    active = grid.active_mask()[:, None, :].expand_as(trc)
    assert torch.equal(a.bgc.tracers[active], b.bgc.tracers[active])
    for name in ("ph_prev_3d", "ph_prev_alt_3d", "surface_ph",
                 "surface_ph_alt"):
        assert torch.equal(getattr(a.bgc, name), getattr(b.bgc, name))
    assert torch.equal(a.dms, b.dms) and torch.equal(a.macros, b.macros)


def _np_world(nlev=NLEV, ncol=NCOL, seed=21, ragged=True):
    js, jg, jf = jax_world(nlev=nlev, ncol=ncol, seed=seed, ragged=ragged)
    return _np(js), _np(jg), _np(jf)


def test_one_step_matches_oracle_and_env_free_step():
    """One f64 step against the scalar oracle (tests/oracle/coupled_ref.py,
    brentq pH, independent constant fits), with the pre-chaos tolerances
    of tests/test_trajectory.py; the env-free step (constants evaluated
    in-step) matches the cached one to 1e-12 of each tracer's scale."""
    s, g, f = _np_world(nlev=6, ncol=4, seed=31, ragged=False)
    state, grid, forcing = world_from_numpy(s, g, f, device="cpu")
    params = params_from_dict(dataclasses.asdict(JaxModelParams()))
    env = precompute_env(grid, forcing, params.bgc)
    got, _ = step(state, grid, forcing, params, DT, compute_diags=False,
                  env=env)
    nocache, _ = step(state, grid, forcing, params, DT,
                      compute_diags=False)
    a, b = got.bgc.tracers.numpy(), nocache.bgc.tracers.numpy()
    scale = np.abs(a).max(axis=(0, 2), keepdims=True) + 1e-30
    np.testing.assert_allclose(b / scale, a / scale, rtol=0, atol=1e-12)

    ostate = dict(tracers=s["bgc"]["tracers"], ph_prev=s["bgc"]["ph_prev_3d"],
                  ph_prev_alt=s["bgc"]["ph_prev_alt_3d"],
                  surface_ph=s["bgc"]["surface_ph"],
                  surface_ph_alt=s["bgc"]["surface_ph_alt"],
                  dms=s["dms"], macros=s["macros"])
    want = coupled_step_ref(ostate, g, f, JaxModelParams(), DT)
    for idx in range(T.CNT):
        strict = idx not in (T.DIC, T.DIC_ALT_CO2, T.O2, T.ALK)
        np.testing.assert_allclose(
            a[:, idx], want["tracers"][:, idx],
            rtol=5e-7 if strict else 2e-4,
            atol=1e-18 if strict else 1e-10, err_msg=f"tracer {idx}")
    np.testing.assert_allclose(got.dms.numpy(), want["dms"], rtol=5e-7,
                               atol=1e-18)
    np.testing.assert_allclose(got.macros.numpy(), want["macros"],
                               rtol=5e-7, atol=1e-18)


def test_cpu_step_never_counts_a_launch():
    state, grid, forcing = world_from_numpy(*_np_world(nlev=3, ncol=8),
                                            device="cpu")
    params = params_from_dict(dataclasses.asdict(JaxModelParams()))
    before = (counters()["k1.dual"], counters()["k1.coeffs"])
    out, _ = step(state, grid, forcing, params, DT, compute_diags=False)
    assert isinstance(out.bgc, BGCState)
    assert (counters()["k1.dual"],
            counters()["k1.coeffs"]) == before
    with pytest.raises(ValueError, match="CUDA"):
        step(state, grid, forcing, params, DT, compute_diags=False,
             carbonate_impl="kernel")


def test_cpu_step_with_the_plain_solves_equals_the_default_step():
    """carbonate_impl="torch" takes the plain route for the interior and
    the surface pair alike; on CPU tensors "auto" does too, so two steps
    are bitwise equal either way, with no launch counted."""
    state, grid, forcing = world_from_numpy(*_np_world(nlev=4, ncol=8),
                                            device="cpu")
    params = params_from_dict(dataclasses.asdict(JaxModelParams()))
    env = precompute_env(grid, forcing, params.bgc)
    before = (counters()["k1.dual"],
              counters()["k1.brackets"])
    a = b = state
    for _ in range(2):
        a, _ = step(a, grid, forcing, params, DT, compute_diags=False,
                    env=env)
        b, _ = step(b, grid, forcing, params, DT, compute_diags=False,
                    env=env, carbonate_impl="torch")
    for x, y in ((a.bgc.tracers, b.bgc.tracers), (a.dms, b.dms),
                 (a.macros, b.macros), (a.bgc.surface_ph, b.bgc.surface_ph),
                 (a.bgc.surface_ph_alt, b.bgc.surface_ph_alt),
                 (a.bgc.ph_prev_3d, b.bgc.ph_prev_3d)):
        assert torch.equal(x, y)
    assert (counters()["k1.dual"],
            counters()["k1.brackets"]) == before
