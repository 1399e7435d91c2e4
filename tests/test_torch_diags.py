"""The default step (diagnostics on, no env cache) of the port against the
JAX package's, on the CPU: K1's coefficient-and-saturation instance's
plain version against the Pallas kernel (interpret mode) and the XLA
solve, every diagnostic of two steps of a small ragged world at f64 and
f32, the health counters, ``diag_filter``, ``diag_dtype``, ``run`` with
time averages, and the diagnostics' independence from what the solve's
inactive lanes hold.  The kernel itself runs on the card only
(tests/test_torch_cuda.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import ocean_bgc_tpu  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from ocean_bgc_tpu.models.coupled import step as jax_step
from ocean_bgc_tpu.ops import carbonate as jcarb
from ocean_bgc_tpu.ops.bgc import _zsat_search as jax_zsat_search
from ocean_bgc_tpu.ops.bgc import precompute_env as jax_precompute_env
from ocean_bgc_tpu.ops.pallas_carbonate import co3_terms_dual_sat_pallas
from ocean_bgc_tpu.params import ModelParams as JaxModelParams
from ocean_bgc_tpu.utils.synthetic import synthetic_world as jax_world

from ocean_bgc_tpu_torch.constants import DEL_PH, XACC
from ocean_bgc_tpu_torch.models.coupled import HEALTH_NAMES, run, step
from ocean_bgc_tpu_torch.ops import bgc
from ocean_bgc_tpu_torch.ops.bgc import _zsat_search, precompute_env
from ocean_bgc_tpu_torch.ops.carbonate import XACC_F32
from ocean_bgc_tpu_torch.ops.dms import DMS_DIAG_NAMES, dms_source_sink
from ocean_bgc_tpu_torch.ops import cuda_carbonate
from ocean_bgc_tpu_torch.ops.cuda_carbonate import (
    carbonate_coeffs_sat,
    co3_terms_dual_coeffs,
    co3_terms_dual_sat,
    co3_terms_dual_sat_torch,
    solve_htotal_brackets,
)
from ocean_bgc_tpu_torch.state import BGCTracers as T
from ocean_bgc_tpu_torch.params import DMSParams
from ocean_bgc_tpu_torch.state import DMSTracers
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


def _cells(seed, nlev=6, ncol=100):
    """(nlev, ncol) carbonate inputs from a seed: depth growing with the
    level, the previous pH of each scenario cold (0) in a third of the
    cells, near the root in a third and 0.5 off it in the rest (the
    bracket must grow)."""
    rng = np.random.default_rng(seed)
    shape = (nlev, ncol)
    w = dict(depth=np.cumsum(rng.uniform(5.0, 900.0, shape), axis=0),
             temp=rng.uniform(-1.8, 31.0, shape),
             salt=rng.uniform(30.0, 40.0, shape),
             dic=rng.uniform(1800.0, 2400.0, shape),
             ta=rng.uniform(2000.0, 2500.0, shape),
             pt=rng.uniform(0.0, 3.5, shape),
             sit=rng.uniform(0.0, 150.0, shape))
    ph = rng.uniform(7.7, 8.2, shape)
    kind = rng.integers(0, 3, shape)
    w["ph_a"] = np.where(kind == 0, 0.0, np.where(kind == 1, ph, ph + 0.5))
    w["ph_b"] = np.where(kind == 1, 0.0, np.where(kind == 2, ph, ph - 0.5))
    return w


_KEYS = ("depth", "temp", "salt", "dic", "ta", "pt", "sit", "ph_a", "ph_b")


def _pallas_brackets(ph):
    """pH-space brackets as JAX's bgc_source_sink builds them for its
    kernel (ops/bgc.py:1189-1196)."""
    warm = ph != 0.0
    return (jnp.where(warm, ph - DEL_PH, 6.0),
            jnp.where(warm, ph + DEL_PH, 9.0))


def _h_close(ph_ref, ph, xacc, f32):
    """|dH| <= 2 xacc, plus two ulps of the f32 pH output in H at f32."""
    ref = np.asarray(ph_ref, np.float64)
    h_ref = 10.0 ** -ref
    h = 10.0 ** -np.asarray(ph, np.float64)
    tol = 2 * xacc + (2 * np.log(10.0) * h_ref
                      * np.spacing(np.abs(ph_ref)).astype(np.float64)
                      if f32 else 0.0)
    return np.abs(h - h_ref) <= tol


def test_dual_sat_plain_matches_pallas_kernel_f32():
    """The plain version of K1's coefficient-and-saturation instance
    against the Pallas kernel it ports, in interpret mode, in that
    instance (``coeffs=None, with_sat=True``), at f32.  Both evaluate the
    15 constants in f32 in their own order, and a constant's exp()
    argument sums terms near 1000 whose rounding (6e-5) moves it by up to
    ~2e-4 relative: roots agree to 2 xacc_f32 plus the pH output's
    rounding plus 1e-3 of H; speciation and saturation within 1e-3
    relative."""
    w = _cells(41)
    f32 = {k: w[k].astype(np.float32) for k in _KEYS}
    press = np.broadcast_to((np.arange(6) > 0)[:, None], f32["dic"].shape)
    lo_a, hi_a = _pallas_brackets(jnp.asarray(f32["ph_a"]))
    lo_b, hi_b = _pallas_brackets(jnp.asarray(f32["ph_b"]))
    ja, jb, jsat = co3_terms_dual_sat_pallas(
        *(jnp.asarray(f32[k]) for k in _KEYS[:7]), lo_a, hi_a, lo_b, hi_b,
        jnp.asarray(press), interpret=True, coeffs=None, with_sat=True)
    ta, tb, tsat = co3_terms_dual_sat_torch(
        *(torch.tensor(f32[k]) for k in _KEYS))
    for jo, to in ((ja, ta), (jb, tb)):
        assert to[0].dtype == torch.float32
        h_ok = _h_close(jo[0], to[0].numpy(), XACC_F32, True)
        hj = 10.0 ** -np.asarray(jo[0], np.float64)
        ht = 10.0 ** -to[0].numpy().astype(np.float64)
        assert (h_ok | (np.abs(hj - ht) <= 1e-3 * hj)).all()
        for a, b in zip(jo[1:], to[1:]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3)
    for a, b in zip(jsat, tsat):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3)


def test_dual_sat_plain_matches_jax_f64():
    """At f64, against JAX's XLA dual solve with its constants evaluated
    inside (``co3_terms_dual(coeffs=None)``) and ``co3_sat_vals``: roots
    to the solver's tolerance (|dH| <= 2 xacc), speciation within 1e-9
    relative (the same iteration from brackets built alike: H differs by
    ulps unless a last-step test flips, which quadratic convergence keeps
    far below xacc), saturation within 1e-12 relative (the same formulas;
    ulps of terms near 1000 in an exp argument)."""
    w = _cells(42)
    press = (np.arange(6) > 0)[:, None]
    lo_a, hi_a = _pallas_brackets(jnp.asarray(w["ph_a"]))
    lo_b, hi_b = _pallas_brackets(jnp.asarray(w["ph_b"]))
    ja, jb = jcarb.co3_terms_dual(
        *(jnp.asarray(w[k]) for k in _KEYS[:7]), lo_a, hi_a, lo_b, hi_b,
        jnp.asarray(press))
    jsat = jcarb.co3_sat_vals(*(jnp.asarray(w[k]) for k in _KEYS[:3]),
                              jnp.asarray(press))
    ta, tb, tsat = co3_terms_dual_sat_torch(
        *(torch.tensor(w[k]) for k in _KEYS))
    for jo, to in ((ja, ta), (jb, tb)):
        assert _h_close(jo[0], to[0].numpy(), XACC, False).all()
        for a, b in zip(jo[1:], to[1:]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9)
    for a, b in zip(jsat, tsat):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12)


def test_dual_sat_wrapper_on_cpu_tensors():
    """On CPU tensors "auto" and "torch" take the plain version (bitwise
    the same results, no launch of the constants kernel or the dual
    instance counted), ``with_sat=False`` returns no saturation values,
    and "kernel" raises."""
    w = _cells(43, nlev=3, ncol=10)
    args = [torch.tensor(w[k]) for k in _KEYS]
    before = (carbonate_coeffs_sat.launches, co3_terms_dual_coeffs.launches)
    a = co3_terms_dual_sat(*args)
    b = co3_terms_dual_sat(*args, impl="torch")
    for x, y in zip(a[0] + a[1] + a[2], b[0] + b[1] + b[2]):
        assert torch.equal(x, y)
    c = co3_terms_dual_sat(*args, with_sat=False)
    assert c[2] is None
    for x, y in zip(a[0] + a[1], c[0] + c[1]):
        assert torch.equal(x, y)
    assert (carbonate_coeffs_sat.launches,
            co3_terms_dual_coeffs.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        co3_terms_dual_sat(*args, impl="kernel")


@pytest.fixture(scope="module", params=["float64", "float32"])
def runs(request):
    """Two steps of the port's default call with health counters, from
    one ragged world, its own variants of the same two steps, and the JAX
    reference (one compile per dtype, ~12 s here): JAX's default call at
    f64; at f32 its call with the env cache, whose tables JAX builds
    eagerly as the port evaluates its constants, because JAX's jitted
    f32 constants differ from its eager ones by more than the solver's
    tolerance in pH (tests/test_torch_fused.py holds the f32 no-env
    interior the same way)."""
    dtype = request.param
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


def test_inactive_lane_fill_leaves_diagnostics_unchanged():
    """Below the ocean floor the port solves the stand-in problem with
    PO4 = SiO3 = 0 where JAX passes the host's padding: fill values there
    change no tracer, pH field, diagnostic or health counter of two
    default steps.  (The top cell of a land column is left alone: the
    surface fluxes and their diagnostics read every column's top cell,
    in both packages.)"""
    js, jg, jf = jax_world(nlev=NLEV, ncol=NCOL, seed=21, ragged=True)
    state, grid, forcing = world_from_numpy(_np(js), _np(jg), _np(jf),
                                            device="cpu")
    params = params_from_dict(dataclasses.asdict(JaxModelParams()))
    below = ~grid.active_mask()
    below[0] = False
    assert below.any()
    trc = state.bgc.tracers.clone()
    for i in (T.PO4, T.SIO3):
        trc[:, i] = torch.where(below, 1e6, trc[:, i])
    filled = dataclasses.replace(
        state, bgc=dataclasses.replace(state.bgc, tracers=trc))
    a, b = state, filled
    active = grid.active_mask()[:, None, :].expand_as(trc)
    for _ in range(2):
        a, da = step(a, grid, forcing, params, DT, health=True)
        b, db = step(b, grid, forcing, params, DT, health=True)
        assert torch.equal(a.bgc.tracers[active], b.bgc.tracers[active])
        assert torch.equal(a.bgc.ph_prev_3d, b.bgc.ph_prev_3d)
        assert torch.equal(a.bgc.ph_prev_alt_3d, b.bgc.ph_prev_alt_3d)
        assert set(da) == set(db)
        for k in da:
            assert torch.equal(da[k], db[k]), k


def test_zsat_search_matches_jax():
    """The first-crossing search against JAX's on hand-made anomalies:
    exact zeros, ties, columns of kmax 0, 1 and nlev, an undersaturated
    surface and no crossing; bitwise."""
    nlev, ncol = 5, 8
    rng = np.random.default_rng(7)
    anom = rng.uniform(-1.0, 1.0, (nlev, ncol))
    anom[0] = np.abs(anom[0]) + 0.1
    anom[:, 1] = [0.5, 0.0, 0.0, -1.0, 2.0]      # exact zeros: the first
    anom[:, 2] = [0.5, 0.3, 0.2, 0.1, 0.05]      # no crossing
    anom[0, 3] = -0.2                            # undersaturated surface
    anom[:, 4] = [0.5, -0.5, -0.5, 0.5, -0.5]    # ties in the mask
    kmax = np.array([5, 5, 5, 5, 3, 0, 1, 2])
    center = np.cumsum(rng.uniform(500.0, 2000.0, (nlev, ncol)), axis=0)
    bottom = center + 100.0
    prev_center = np.concatenate([np.zeros((1, ncol)), center[:-1]])
    active = np.arange(nlev)[:, None] < kmax[None, :]
    want = np.asarray(jax.jit(jax_zsat_search)(*(jnp.asarray(x) for x in (
        anom, center, prev_center, bottom, active, kmax))))
    got = _zsat_search(*(torch.tensor(x) for x in (
        anom, center, prev_center, bottom, active, kmax)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[5] == 0.0 and got[6] == -1.0 and got[2] == bottom[4, 2]


def test_dms_uv_field_matches_the_sequential_recurrence():
    """The DMS step's opt-in UV field (``compute_uv``, DMS_mod.F90:509-510,
    531-536) against the reference's level-by-level recurrence written
    out in NumPy (as tests/test_dms.py holds JAX's): 1% of surface PAR,
    attenuated by KUVdz = (0.01e-2 DOC + 0.04e-4) dz, within 1e-12
    relative; negative tracers clipped, a land column and a full one.
    The 27 diagnostics and the tendencies do not change with it (the
    default call's diagnostics are held to JAX's above)."""
    from ocean_bgc_tpu_torch.constants import F_QSW_PAR_DMS
    rng = np.random.default_rng(5)
    nlev, ncol = 7, 9
    tracers = rng.uniform(0.0, 2.0, (nlev, DMSTracers.CNT, ncol))
    tracers[2, :, 1] = -1.0
    dz = rng.uniform(500.0, 2000.0, (nlev, ncol))
    kmax = rng.integers(1, nlev + 1, ncol)
    kmax[0], kmax[-1] = 0, nlev
    active = np.arange(nlev)[:, None] < kmax[None, :]
    sst = rng.uniform(-1.8, 30.0, ncol)
    sw = rng.uniform(0.0, 350.0, ncol)
    args = [torch.tensor(a) for a in (tracers, dz, active, sst, sw)]
    tend, d = dms_source_sink(*args, DMSParams(), compute_uv=True)
    tend0, d0 = dms_source_sink(*args, DMSParams())
    assert set(d0) == set(DMS_DIAG_NAMES)
    assert set(d) == set(DMS_DIAG_NAMES) | {"UV_in", "UV_out", "UV_avg"}
    assert torch.equal(tend, tend0)
    assert all(torch.equal(d[k], d0[k]) for k in d0)
    doc = np.maximum(tracers[:, DMSTracers.DOC], 0.0)
    want = {k: np.zeros((nlev, ncol)) for k in ("UV_in", "UV_out",
                                                "UV_avg")}
    for col in range(ncol):
        uv_out = max(0.0, sw[col]) * F_QSW_PAR_DMS * 0.01
        for k in range(kmax[col]):
            kuv_dz = (0.01e-2 * doc[k, col] + 0.04e-4) * dz[k, col]
            uv_in, uv_out = uv_out, uv_out * np.exp(-kuv_dz)
            want["UV_in"][k, col] = uv_in
            want["UV_out"][k, col] = uv_out
            want["UV_avg"][k, col] = uv_in * (1.0 - np.exp(-kuv_dz)) / kuv_dz
    for k, w in want.items():
        np.testing.assert_allclose(d[k].numpy(), w, rtol=1e-12, atol=0.0)
