"""The adjoint's gradients where they could break (CPU, f64 unless
stated): through forced runs and their env caches, at zero biomass and in
calm wind (ROADMAP queue 3 #6), on ragged worlds with inactive lanes,
through every numeric parameter as a tensor, and at f32 in dark cells."""

import dataclasses

import numpy as np
import pytest
import torch

from ocean_bgc_tpu_torch.models.adjoint import (
    get_param,
    override_params,
    parameter_sensitivities,
    run_diff,
)
from ocean_bgc_tpu_torch.models.forcing_series import (
    run_forced,
    stack_forcings,
)
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.state import BGCTracers as BT
from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world

DT = 3600.0
PATHS = ("bgc.parm_kappa_nitrif", "bgc.autotrophs[0].PCref",
         "bgc.parm_POC_diss")


def world(**kw):
    kw.setdefault("nlev", 6)
    kw.setdefault("ncol", 8)
    kw.setdefault("seed", 73)
    kw.setdefault("ragged", False)
    return synthetic_world(device="cpu", **kw)


def no3_functional(final):
    return torch.mean(final.bgc.tracers[:, BT.NO3] ** 2)


def with_tracers(state, tracers):
    return dataclasses.replace(
        state, bgc=dataclasses.replace(state.bgc, tracers=tracers))


@pytest.mark.parametrize("interp,env_mode", [("linear", "off"),
                                             ("linear", "interp"),
                                             ("hold", "hold")])
def test_grad_through_forced_run(interp, env_mode):
    """A forcing-series amplitude's gradient through run_forced: the
    per-record env caches (held, or blended by _blend_env) and the
    per-step constants without one.  More light -> more surface carbon
    fixation -> lower surface DIC: finite, negative, and within 2e-3 of
    central finite differences."""
    nlev, ncol, nrec = 5, 6, 3
    worlds = [world(nlev=nlev, ncol=ncol, seed=200 + r) for r in range(nrec)]
    state, grid, _ = worlds[0]
    series = stack_forcings([w[2] for w in worlds])
    params = ModelParams()

    def loss_of(scale):
        s2 = dataclasses.replace(
            series, shortwave_surface=series.shortwave_surface * scale)
        final, _ = run_forced(state, grid, s2, params, DT, 4, 2 * DT,
                              interp=interp, env_mode=env_mode)
        return torch.mean(final.bgc.tracers[0, BT.DIC])

    scale = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(loss_of(scale), scale)
    with torch.no_grad():
        fd = (float(loss_of(1.01)) - float(loss_of(0.99))) / 0.02
    assert np.isfinite(float(g))
    assert float(g) < 0.0
    np.testing.assert_allclose(float(g), fd, rtol=2e-3)


def _zeroed_world():
    """A ragged world whose zooplankton and phytoplankton are exactly 0 in
    some cells and whose wind is calm in some columns."""
    state, grid, forcing = synthetic_world(nlev=8, ncol=24, seed=9,
                                           ragged=True, device="cpu")
    tr = state.bgc.tracers.clone()
    tr[:3, BT.ZOOC, ::3] = 0.0
    for idx in (BT.SPC, BT.DIATC, BT.DIAZC, BT.PHAEOC, BT.SPCHL,
                BT.DIATCHL, BT.DIAZCHL, BT.PHAEOCHL):
        tr[:, idx, 1::4] = 0.0
    wind = forcing.wind_speed_squared_10m.clone()
    wind[::5] = 0.0
    return (with_tracers(state, tr), grid,
            dataclasses.replace(forcing, wind_speed_squared_10m=wind))


def test_step_gradient_is_finite_at_zero_biomass_and_calm_wind():
    """Two steps from a state with zero biomass in some cells and calm
    wind in some columns: the gradient of every prognostic output with
    respect to the tracers, the wind and three parameters is finite (the
    plain expressions' derivatives are NaN there)."""
    state, grid, forcing = _zeroed_world()
    tr = state.bgc.tracers.clone().requires_grad_()
    wind = forcing.wind_speed_squared_10m.clone().requires_grad_()
    params = ModelParams()
    theta = torch.ones(3, dtype=torch.float64, requires_grad=True)
    p = override_params(params, {
        "bgc.parm_z_mort2_0": params.bgc.parm_z_mort2_0 * theta[0],
        "dms.B_exp": params.dms.B_exp * theta[1],
        "dms.k_S_B": params.dms.k_S_B * theta[2]})
    final = run_diff(with_tracers(state, tr), grid,
                     dataclasses.replace(forcing,
                                         wind_speed_squared_10m=wind),
                     p, DT, 2)
    j = (final.bgc.tracers.mean() + final.dms.mean() + final.macros.mean())
    g_tr, g_w, g_th = torch.autograd.grad(j, (tr, wind, theta))
    for g in (g_tr, g_w, g_th):
        assert torch.isfinite(g).all()
    assert g_th.abs().min() > 0.0


def test_ragged_world_gradient_has_no_nan():
    """On a ragged world (land and shelf columns: the inactive lanes
    solve the stand-in problem, and their results are discarded), a
    functional of the tracers and of both pH states: the gradients with
    respect to the tracers and the three parameters are finite, and the
    inactive cells' tracers get none."""
    state, grid, forcing = synthetic_world(nlev=8, ncol=32, seed=5,
                                           ragged=True, device="cpu")
    params = ModelParams()
    base = [get_param(params, p) for p in PATHS]
    theta = torch.ones(3, dtype=torch.float64, requires_grad=True)
    p = override_params(params, {q: b * theta[i]
                                 for i, (q, b) in enumerate(zip(PATHS,
                                                                base))})
    tr = state.bgc.tracers.clone().requires_grad_()
    final = run_diff(with_tracers(state, tr), grid, forcing, p, DT, 2)
    active = grid.active_mask()
    j = (torch.where(active, final.bgc.tracers[:, BT.DIC], 0.0).mean()
         + torch.where(active, final.bgc.ph_prev_3d, 0.0).mean()
         + torch.where(active, final.bgc.ph_prev_alt_3d, 0.0).mean()
         + final.bgc.surface_ph.mean())
    g_tr, g_th = torch.autograd.grad(j, (tr, theta))
    assert torch.isfinite(g_tr).all() and torch.isfinite(g_th).all()
    assert (g_tr.permute(1, 0, 2)[:, ~active] == 0.0).all()
    assert g_tr.abs().max() > 0.0


def test_every_numeric_parameter_has_a_finite_gradient():
    """Every float field of the three parameter families (the autotrophs'
    too), each as a tensor at once: one step and its backward run, and
    every gradient is finite; the fields a tensor once went through a
    host number for (the north/south traits, the POC dissolution length,
    the GQSI Fe factor, the dissolution scale-length knots) get a nonzero
    gradient."""
    state, grid, forcing = world(nlev=6, ncol=16, ragged=True, seed=3)
    params = ModelParams()
    paths = []
    for fam in ("bgc", "dms", "macros"):
        obj = getattr(params, fam)
        paths += [f"{fam}.{f.name}" for f in dataclasses.fields(obj)
                  if type(getattr(obj, f.name)) is float]
    for g, au in enumerate(params.bgc.autotrophs):
        paths += [f"bgc.autotrophs[{g}].{f.name}"
                  for f in dataclasses.fields(au)
                  if type(getattr(au, f.name)) is float]
    paths += [f"bgc.parm_scalelen_vals[{i}]"
              for i in range(len(params.bgc.parm_scalelen_vals))]
    theta = torch.ones(len(paths), dtype=torch.float64, requires_grad=True)
    p = override_params(params, {q: get_param(params, q) * theta[i]
                                 for i, q in enumerate(paths)})
    final = run_diff(state, grid, forcing, p, DT, 2)
    j = (final.bgc.tracers.abs().mean() + final.dms.abs().mean()
         + final.macros.abs().mean())
    (g,) = torch.autograd.grad(j, theta)
    assert torch.isfinite(g).all()
    got = dict(zip(paths, g.tolist()))
    for q in ("bgc.parm_POC_diss", "bgc.autotrophs[1].kFe",
              "bgc.autotrophs[3].temp_optN", "bgc.parm_scalelen_vals[1]"):
        assert got[q] != 0.0, q


def test_f32_sweep_is_finite_in_dark_cells():
    """At f32 the photoadaptation ratio's denominator is subnormal in the
    deep, dark cells of a 60-level world; the sensitivities stay finite
    and within 1e-4 of f64's (they were NaN while safe_div's backward
    formed 1/den)."""
    paths = PATHS[1:]
    got = {}
    for dtype in (torch.float32, torch.float64):
        state, grid, forcing = synthetic_world(nlev=60, ncol=16, seed=17,
                                               ragged=True, dtype=dtype,
                                               device="cpu")
        got[dtype] = parameter_sensitivities(
            ModelParams(), paths, state, grid, forcing, DT, 2,
            no3_functional, remat=False)
    for p in paths:
        assert np.isfinite(got[torch.float32][p])
        np.testing.assert_allclose(got[torch.float32][p],
                                   got[torch.float64][p], rtol=1e-4)
