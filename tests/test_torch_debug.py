"""The port's env fingerprint and staleness guard and its debugging
utilities, on the CPU.

``env_fingerprint`` against JAX's; the ``OBGC_CHECK_ENV=1`` guard's three
cases; ``validate_state``, ``solver_health`` and ``poc_bounds_report``
against JAX's on the same numpy state and diagnostics (no JAX step: the
port steps where a stepped state is needed).  ``checked_step`` raising,
``step_timer`` and ``trace`` on CPU tensors are in
``tests/test_torch_debug_tools.py``.  The constants kernel under
``solver_health`` and the guard's host synchronisation on the card are in
tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

import ocean_bgc_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp

from ocean_bgc_tpu.models.coupled import CoupledState as JaxCoupledState
from ocean_bgc_tpu.ops.bgc import env_fingerprint as jax_env_fingerprint
from ocean_bgc_tpu.utils import debug as jdebug
from ocean_bgc_tpu.utils.synthetic import synthetic_world as jax_world

from ocean_bgc_tpu_torch.models.coupled import step
from ocean_bgc_tpu_torch.models.forcing_series import _blend_env
from ocean_bgc_tpu_torch.ops.bgc import (
    EnvCache,
    bgc_source_sink,
    check_env_cache,
    env_fingerprint,
    precompute_env,
)
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.utils import debug
from ocean_bgc_tpu_torch.utils.bridge import world_from_numpy
from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world

DT = 3600.0


def _np(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return np.asarray(x)


def _worlds(seed, nlev=6, ncol=8):
    """The same ragged world in both packages: (JAX's, the port's on the
    CPU), each (state, grid, forcing)."""
    jw = jax_world(nlev=nlev, ncol=ncol, seed=seed, ragged=True)
    tw = world_from_numpy(*(_np(x) for x in jw), device="cpu")
    return jw, tw


def _with_bgc(state, **fields):
    return dataclasses.replace(
        state, bgc=dataclasses.replace(state.bgc, **fields))


def test_env_fingerprint_matches_jax():
    """The five checksums of (T, S, dz, bottom depth, kmax) within 1e-12
    of JAX's, on the forcing's type and device."""
    (_, jg, jf), (_, tg, tf) = _worlds(3, nlev=7, ncol=40)
    want = np.asarray(jax_env_fingerprint(jg, jf))
    got = env_fingerprint(tg, tf)
    assert got.shape == (5,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0.0)
    assert np.all(want != 0.0)


@pytest.fixture(scope="module")
def guard_world():
    params = ModelParams().bgc
    state, grid, forcing = synthetic_world(nlev=6, ncol=8, seed=4,
                                           ragged=True, device="cpu")
    env = precompute_env(grid, forcing, params)
    stale = dataclasses.replace(
        forcing, potential_temperature=forcing.potential_temperature + 0.5)
    return state, grid, forcing, stale, env, params


@pytest.mark.parametrize("case", ["fresh", "stale", "off"])
def test_env_staleness_guard(guard_world, case, monkeypatch):
    """Under OBGC_CHECK_ENV=1 a cache used with the forcing it was built
    from passes and one used after (T, S) moved raises; with the guard
    off (the default) the same stale call goes through."""
    state, grid, forcing, stale, env, params = guard_world
    assert env.fingerprint is not None
    monkeypatch.setenv("OBGC_CHECK_ENV", "0" if case == "off" else "1")

    def call(f):
        return bgc_source_sink(state.bgc.tracers, grid, f,
                               state.bgc.ph_prev_3d, state.bgc.ph_prev_alt_3d,
                               params, compute_diags=False, env=env)

    if case == "fresh":
        out = call(forcing)
        check_env_cache(env, grid, forcing)
        assert torch.isfinite(out.tendencies).all()
    elif case == "stale":
        with pytest.raises(ValueError, match="stale EnvCache"):
            call(stale)
        with pytest.raises(ValueError, match="stale EnvCache"):
            check_env_cache(env, grid, stale)
        with pytest.raises(ValueError, match="no fingerprint"):
            check_env_cache(env._replace(fingerprint=None), grid, forcing)
    else:
        assert torch.isfinite(call(stale).tendencies).all()


def test_env_cache_keeps_its_positional_fields(guard_world):
    """The fingerprint is the cache's last, optional field: a cache built
    from its first six fields still works, and a forcing blend blends the
    fingerprint with the tables."""
    state, grid, forcing, _, env, params = guard_world
    bare = EnvCache(*env[:6])
    assert bare.fingerprint is None and bare[:6] == env[:6]
    a = bgc_source_sink(state.bgc.tracers, grid, forcing,
                        state.bgc.ph_prev_3d, state.bgc.ph_prev_alt_3d,
                        params, compute_diags=False, env=bare)
    b = bgc_source_sink(state.bgc.tracers, grid, forcing,
                        state.bgc.ph_prev_3d, state.bgc.ph_prev_alt_3d,
                        params, compute_diags=False, env=env)
    assert torch.equal(a.tendencies, b.tendencies)
    moved = env._replace(fingerprint=env.fingerprint + 1.0)
    half = _blend_env(env, moved, 0.5)
    assert torch.equal(half.fingerprint, env.fingerprint + 0.5)


def test_validate_state_matches_jax():
    """Per-field non-finite and negative counts on active cells, the
    worst field and the verdict, equal to JAX's on the same state, clean
    and with a NaN and negatives injected."""
    (js, jg, _), (ts, tg, _) = _worlds(51)
    assert debug.validate_state(ts, tg) == jdebug.validate_state(js, jg)
    assert debug.validate_state(ts, tg).ok
    bad = ts.bgc.tracers.clone()
    bad[0, 3, 2] = float("nan")
    bad[1, 5, 4] = -1.0
    dms = ts.dms.clone()
    dms[2, 1, 3] = -2.0
    ts = dataclasses.replace(_with_bgc(ts, tracers=bad), dms=dms)
    js = JaxCoupledState(
        bgc=dataclasses.replace(js.bgc, tracers=jnp.asarray(bad.numpy())),
        dms=jnp.asarray(dms.numpy()), macros=js.macros)
    got, want = debug.validate_state(ts, tg), jdebug.validate_state(js, jg)
    assert got == want
    assert not got.ok and got.n_nonfinite == 1
    assert got.worst_field == "bgc.tracers"


def test_solver_health_matches_jax():
    """The Newton step at the stored pH against JAX's, on warm starts off
    their roots (so the steps are well above rounding): max and mean
    within 1e-9, the cells checked equal; and after a step of the port,
    converged warm starts give steps below the solver's tolerance."""
    (js, jg, jf), (ts, tg, tf) = _worlds(53)
    rng = np.random.default_rng(53)
    active = tg.active_mask().numpy()
    ph = np.where(active & (rng.uniform(size=active.shape) < 0.8),
                  rng.uniform(7.6, 8.3, active.shape), 0.0)
    got = debug.solver_health(_with_bgc(ts, ph_prev_3d=torch.from_numpy(ph)),
                              tg, tf)
    want = jdebug.solver_health(
        JaxCoupledState(bgc=dataclasses.replace(js.bgc,
                                                ph_prev_3d=jnp.asarray(ph)),
                        dms=js.dms, macros=js.macros), jg, jf)
    assert got["cells_checked"] == want["cells_checked"] > 0
    for k in ("max_newton_step_h", "mean_newton_step_h"):
        assert got[k] > 1e-10
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, err_msg=k)
    s1, _ = step(ts, tg, tf, ModelParams(), DT, compute_diags=False)
    health = debug.solver_health(s1, tg, tf)
    assert health["cells_checked"] == int(active.sum())
    assert health["max_newton_step_h"] < 1e-9


def test_poc_bounds_report_matches_jax():
    """The poc_error observable from the port's default-call diagnostics,
    equal to JAX's on the same values, clean and with a manufactured
    violation."""
    _, (ts, tg, tf) = _worlds(91)
    _, diags = step(ts, tg, tf, ModelParams(), DT)
    got = debug.poc_bounds_report(diags)
    want = jdebug.poc_bounds_report({k: v.numpy() for k, v in diags.items()})
    assert got == want
    assert got["poc_error"] is False and got["n_violating_cells"] == 0
    bad = dict(diags, CaCO3_PROD=diags["CaCO3_PROD"] + 1.0)
    got = debug.poc_bounds_report(bad)
    assert got == jdebug.poc_bounds_report(
        {k: v.numpy() for k, v in bad.items()})
    assert got["poc_error"] is True and got["n_violating_cells"] > 0
    assert got["min_poc_prod_avail"] < 0.0
