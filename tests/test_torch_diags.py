"""The default step (diagnostics on, no env cache) of the port against the
JAX package's, on the CPU: every diagnostic of two steps of a small
ragged world at f64 (at f32 in ``tests/test_torch_diags_f32.py``, which
runs these tests on its own fixture), the health counters,
``diag_filter``, ``diag_dtype`` and ``run`` with time averages.  K1's
coefficient-and-saturation instance's plain version against the Pallas
kernel and the XLA solve, and the diagnostics' independence from what
the solve's inactive lanes hold, are in
``tests/test_torch_diags_solve.py``.  The kernels themselves run on the
card only (tests/test_torch_cuda.py)."""

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
from ocean_bgc_tpu_torch.models.coupled import HEALTH_NAMES, run, step
from ocean_bgc_tpu_torch.ops import bgc
from ocean_bgc_tpu_torch.ops.bgc import precompute_env
from ocean_bgc_tpu_torch.ops.carbonate import XACC_F32
from ocean_bgc_tpu_torch.ops import cuda_carbonate
from ocean_bgc_tpu_torch.ops.cuda_carbonate import (
    carbonate_coeffs_sat,
    co3_terms_dual_coeffs,
    solve_htotal_brackets,
)
from ocean_bgc_tpu_torch.utils.bridge import params_from_dict, world_from_numpy
from ocean_bgc_tpu_torch.utils.diag import coupled_registry

NLEV, NCOL, NSTEPS, DT = 8, 32, 2, 3600.0

# the fields that carry a pH solve's result (the interior's and the
# surface pair's), held to the solver's tolerance rather than to rounding
SOLVE_FIELDS = ("pH_3D", "pH_3D_ALT_CO2", "CO3", "HCO3", "H2CO3",
                "CO3_ALT_CO2", "HCO3_ALT_CO2", "H2CO3_ALT_CO2",
                *(f"{x}{alt}" for x in ("co2star", "dco2star", "pco2surf",
                                        "dpco2")
                  for alt in ("", "_alt_co2")))
# conservation residuals: zero up to rounding, so held on the scale of the
# same budget over the top 100 m, whose terms they cancel
RESIDUALS = {f"Jint_{x}tot": f"Jint_100m_{x}tot" for x in "CNP"}
RESIDUALS["Jint_Sitot"] = "Jint_100m_Sitot"
# differences of sinking fluxes across a cell, fields up to a thousand
# times smaller than the fluxes: held to 1e-12 at f64 and 1e-4 at f32
FLUX_DIVERGENCES = ("dust_REMIN", "P_iron_REMIN", "SiO2_REMIN",
                    "CaCO3_REMIN", "POC_REMIN")


def _np(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return np.asarray(x)


def _h_close(ph_ref, ph, xacc, f32):
    """|dH| <= 2 xacc, plus two ulps of the f32 pH output in H at f32."""
    ref = np.asarray(ph_ref, np.float64)
    h_ref = 10.0 ** -ref
    h = 10.0 ** -np.asarray(ph, np.float64)
    tol = 2 * xacc + (2 * np.log(10.0) * h_ref
                      * np.spacing(np.abs(ph_ref)).astype(np.float64)
                      if f32 else 0.0)
    return np.abs(h - h_ref) <= tol


def _runs(dtype):
    """Two steps of the port's default call with health counters, from
    one ragged world, its own variants of the same two steps, and the JAX
    reference (one compile per dtype, ~12 s here): JAX's default call at
    f64; at f32 its call with the env cache, whose tables JAX builds
    eagerly as the port evaluates its constants, because JAX's jitted
    f32 constants differ from its eager ones by more than the solver's
    tolerance in pH (tests/test_torch_fused.py holds the f32 no-env
    interior the same way)."""
    jdt = None if dtype == "float64" else jnp.float32
    js, jg, jf = jax_world(nlev=NLEV, ncol=NCOL, seed=21, ragged=True,
                           dtype=jdt)
    jp = JaxModelParams()
    jenv = None if dtype == "float64" else jax_precompute_env(jg, jf, jp.bgc)
    jfn = jax.jit(lambda s: jax_step(s, jg, jf, jp, DT, health=True,
                                     env=jenv))
    ts, tg, tf = world_from_numpy(_np(js), _np(jg), _np(jf), device="cpu",
                                  dtype=getattr(torch, dtype))
    tp = params_from_dict(dataclasses.asdict(jp))
    out = dict(dtype=dtype, grid=tg, forcing=tf, params=tp, state0=ts,
               jax=[], port=[], plain=[], off=[])
    plain = off = ts
    before = (co3_terms_dual_coeffs.launches, carbonate_coeffs_sat.launches,
              solve_htotal_brackets.launches)
    for _ in range(NSTEPS):
        js, jd = jfn(js)
        ts, td = step(ts, tg, tf, tp, DT, health=True)
        plain, pd = step(plain, tg, tf, tp, DT)
        off, od = step(off, tg, tf, tp, DT, compute_diags=False)
        assert od == {}
        out["jax"].append(({k: np.asarray(v) for k, v in jd.items()},
                           _np(js)))
        out["port"].append((td, ts))
        out["plain"].append((pd, plain))
        out["off"].append(off)
    # CPU tensors: every solve took its plain version
    assert (co3_terms_dual_coeffs.launches, carbonate_coeffs_sat.launches,
            solve_htotal_brackets.launches) == before
    return out


@pytest.fixture(scope="module", params=["float64"])
def runs(request):
    """:func:`_runs` at f64 (``tests/test_torch_diags_f32.py`` runs the
    same tests at f32)."""
    return _runs(request.param)


def test_default_call_emits_the_jax_names(runs):
    """The default call returns exactly JAX's 155 diagnostics, the
    registry's names; with ``health=True`` the two counters besides."""
    for (jd, _), (td, _), (pd, _) in zip(runs["jax"], runs["port"],
                                         runs["plain"]):
        assert len(pd) == 155 and set(pd) == set(coupled_registry())
        assert set(td) == set(jd) == set(pd) | set(HEALTH_NAMES)
        # health=True changes no diagnostic
        for k, v in pd.items():
            assert torch.equal(td[k], v), k
            assert v.dtype == getattr(torch, runs["dtype"])
            assert torch.isfinite(v).all(), k


def _scale(name, jd):
    ref = jd[RESIDUALS.get(name, name)]
    return np.abs(ref.astype(np.float64)).max() + 1e-30


def test_diagnostics_match_jax(runs):
    """Every diagnostic of both steps against JAX's value, per field on
    its largest magnitude (conservation residuals on their top-100 m
    budget's): at f64 within 1e-13 (libm/XLA ulps), at f32 within 1e-5
    (the same ops in single precision), ten times that for the
    particulate remineralisation fields, differences of fluxes up to a
    thousand times larger.  The pH solve's fields are
    held to the solver's tolerance: pH by |dH| <= 2 xacc (plus the f32 pH
    output's rounding), the speciation and the surface CO2 fields within
    1e-9 relative at f64 and 2e-4 at f32 (where xacc_f32 = 1e-13 is
    ~1e-5 of H); the saturation
    values, whose exp() arguments sum terms near 400, within 1e-12 at f64
    and 2e-4 at f32.  The saturation depths are compared in
    test_saturation_depths_match_jax."""
    f32 = runs["dtype"] == "float32"
    xacc = XACC_F32 if f32 else XACC
    for (jd, _), (td, _) in zip(runs["jax"], runs["port"]):
        for name, a in jd.items():
            if name in HEALTH_NAMES or name in ("zsatcalc", "zsatarag"):
                continue
            b = td[name].numpy()
            assert b.shape == a.shape and b.dtype == a.dtype, name
            if name.startswith("pH_3D"):
                assert np.array_equal(a == 0.0, b == 0.0), name
                live = a != 0.0
                assert _h_close(a[live], b[live], xacc, f32).all(), name
                continue
            if name in SOLVE_FIELDS:
                tol = 2e-4 if f32 else 1e-9
            elif name.startswith("co3_sat"):
                tol = 2e-4 if f32 else 1e-12
            elif name in FLUX_DIVERGENCES:
                tol = 1e-4 if f32 else 1e-12
            else:
                tol = 1e-5 if f32 else 1e-13
            err = (np.abs(a.astype(np.float64) - b.astype(np.float64)).max()
                   / _scale(name, jd))
            assert err <= tol, (name, err)


def test_saturation_depths_match_jax(runs):
    """zsatcalc and zsatarag: the first level whose CO3 anomaly is <= 0.
    Where JAX's and the port's anomalies straddle 0 at some level (CO3
    within the solver's tolerance of saturation), the first crossing may
    sit one level apart: such columns are counted, printed and held to
    either package's crossing depth; every other column agrees to 1e-13
    (1e-5 at f32) of the field's scale."""
    f32 = runs["dtype"] == "float32"
    tol = 1e-5 if f32 else 1e-13
    straddling = 0
    for (jd, _), (td, _) in zip(runs["jax"], runs["port"]):
        for name, sat in (("zsatcalc", "co3_sat_calc"),
                          ("zsatarag", "co3_sat_arag")):
            a, b = jd[name], td[name].numpy()
            ja = jd["CO3"] - jd[sat]
            ta = td["CO3"].numpy() - td[sat].numpy()
            flips = ((ja <= 0.0) != (ta <= 0.0)).any(axis=0)
            scale = np.abs(a).max() + 1e-30
            close = np.abs(a.astype(np.float64) - b) <= tol * scale
            straddling += int((flips & ~close).sum())
            assert (close | flips).all(), name
    print(f"\n{runs['dtype']}: {straddling} column(s) with a crossing one "
          f"level apart")


def test_health_counters(runs):
    """The two counters: equal to JAX's at f64; at f32, where a cell's
    next Newton step can sit at the 2 xacc threshold, the non-converged
    counts may differ by a few cells (printed) and the POC-ballast counts
    agree."""
    for (jd, _), (td, _) in zip(runs["jax"], runs["port"]):
        for name in HEALTH_NAMES:
            a, b = float(jd[name]), td[name].item()
            assert td[name].dim() == 0 and b == int(b) >= 0
            if runs["dtype"] == "float64" or name == "health_poc_error_cells":
                assert a == b, name
            else:
                print(f"\nf32 {name}: JAX {a:g}, port {b:g}")
                assert abs(a - b) <= 3


def test_health_step_evaluates_the_constants_once(runs, monkeypatch):
    """Without an env cache a step with health counters evaluates the
    interior's equilibrium constants once, for the pH solve and the
    health residual alike (``carbonate_coeffs_sat``; its plain version
    on CPU tensors), and gives the tracers, diagnostics and counters of
    the fixture's first step, which the tests above hold to JAX."""
    calls = []
    plain = cuda_carbonate.carbonate_coeffs

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return plain(*args, **kwargs)
    monkeypatch.setattr(cuda_carbonate, "carbonate_coeffs", counted)
    monkeypatch.setattr(bgc, "carbonate_coeffs", counted)
    ts, td = step(runs["state0"], runs["grid"], runs["forcing"],
                  runs["params"], DT, health=True)
    assert calls == [(NLEV, NCOL)]
    want_d, want_s = runs["port"][0]
    assert torch.equal(ts.bgc.tracers, want_s.bgc.tracers)
    assert set(td) == set(want_d)
    for k, v in td.items():
        assert torch.equal(v, want_d[k]), k


def test_tracers_do_not_depend_on_diagnostics(runs):
    """Tracers, DMS, MACROS and pH after each step are bitwise equal
    with diagnostics on (with or without health counters) and off, and
    match JAX's state."""
    for (_, h), (_, p), o in zip(runs["port"], runs["plain"], runs["off"]):
        for x in (h, p):
            assert torch.equal(x.bgc.tracers, o.bgc.tracers)
            assert torch.equal(x.dms, o.dms)
            assert torch.equal(x.macros, o.macros)
            assert torch.equal(x.bgc.ph_prev_3d, o.bgc.ph_prev_3d)
            assert torch.equal(x.bgc.surface_ph, o.bgc.surface_ph)
    tol = 1e-5 if runs["dtype"] == "float32" else 1e-13
    a = runs["jax"][-1][1]["bgc"]["tracers"]
    b = runs["port"][-1][1].bgc.tracers.numpy()
    scale = np.abs(a).max(axis=(0, 2), keepdims=True) + 1e-30
    np.testing.assert_allclose(b / scale, a / scale, rtol=0, atol=tol)


def test_filter_dtype_and_health_options(runs):
    """``diag_filter`` returns exactly its names, bitwise the unfiltered
    values, with the health counters kept (listing them is allowed);
    ``diag_dtype`` casts the diagnostics, not the counters; unknown names
    raise KeyError, a filter without diagnostics ValueError; health alone
    with diagnostics off returns only the counters."""
    g, f, p, s0 = (runs[k] for k in ("grid", "forcing", "params", "state0"))
    full = runs["port"][0][0]
    names = ["CO3", "pH_3D", "zsatcalc", "photoC", "Jint_Ctot",
             "DMS_Cyano_frac", "MACROS_LIP_R_TOTAL", "co2star", "DMS_WS",
             "netFlux"]
    _, d = step(s0, g, f, p, DT, health=True, diag_filter=names,
                diag_dtype=torch.float32)
    assert set(d) == set(names) | set(HEALTH_NAMES)
    for k in names:
        assert d[k].dtype == torch.float32
        assert torch.equal(d[k], full[k].to(torch.float32)), k
    for k in HEALTH_NAMES:
        assert torch.equal(d[k], full[k])
    _, d = step(s0, g, f, p, DT, health=True,
                diag_filter=["pH_3D", HEALTH_NAMES[0]])
    assert set(d) == {"pH_3D", *HEALTH_NAMES}
    _, d = step(s0, g, f, p, DT, compute_diags=False, health=True)
    assert set(d) == set(HEALTH_NAMES)
    with pytest.raises(KeyError, match="not_a_diagnostic"):
        step(s0, g, f, p, DT, diag_filter=["pH_3D", "not_a_diagnostic"])
    with pytest.raises(ValueError, match="diag_filter"):
        step(s0, g, f, p, DT, compute_diags=False, diag_filter=["pH_3D"])


def test_run_sums_the_tracked_fields(runs):
    """``run`` with diagnostics and time averages equals two steps taken
    one by one (the env cache on, as run's default), bitwise: the final
    state, the final step's diagnostics and the sums of the tracked
    fields over both steps."""
    g, f, p, s0 = (runs[k] for k in ("grid", "forcing", "params", "state0"))
    track = ["photoC_TOT", "zsatcalc", "DMS_phytoN"]
    final, diags, tavg = run(s0, g, f, p, DT, NSTEPS, compute_diags=True,
                             tavg_fields=track)
    env = precompute_env(g, f, p.bgc)
    s, sums = s0, {k: 0.0 for k in track}
    for _ in range(NSTEPS):
        s, d = step(s, g, f, p, DT, env=env)
        sums = {k: sums[k] + d[k] for k in track}
    assert torch.equal(final.bgc.tracers, s.bgc.tracers)
    assert set(diags) == set(d)
    assert all(torch.equal(diags[k], d[k]) for k in d)
    assert int(tavg.count) == NSTEPS and set(tavg.sums) == set(track)
    for k in track:
        assert torch.equal(tavg.sums[k], sums[k])
        assert torch.equal(tavg.means()[k], sums[k] / NSTEPS)
    with pytest.raises(KeyError, match="nope"):
        run(s0, g, f, p, DT, 1, tavg_fields=["nope"])


