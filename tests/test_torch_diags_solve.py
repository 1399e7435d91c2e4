"""K1's coefficient-and-saturation instance's plain version against the
Pallas kernel (interpret mode) and JAX's XLA solve, on the CPU, and the
default step's diagnostics' independence from what the solve's inactive
lanes hold; JAX's saturation-depth search and the DMS step's UV field
against their references.  The default call's diagnostics against JAX's
are in ``tests/test_torch_diags.py``; the kernels themselves run on the
card only (tests/test_torch_cuda.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import ocean_bgc_tpu  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from ocean_bgc_tpu.ops import carbonate as jcarb
from ocean_bgc_tpu.ops.bgc import _zsat_search as jax_zsat_search
from ocean_bgc_tpu.ops.pallas_carbonate import co3_terms_dual_sat_pallas
from ocean_bgc_tpu.params import ModelParams as JaxModelParams
from ocean_bgc_tpu.utils.synthetic import synthetic_world as jax_world

from ocean_bgc_tpu_torch.constants import DEL_PH, XACC
from ocean_bgc_tpu_torch.models.coupled import step
from ocean_bgc_tpu_torch.ops.bgc import _zsat_search
from ocean_bgc_tpu_torch.ops.carbonate import XACC_F32
from ocean_bgc_tpu_torch.ops.dms import DMS_DIAG_NAMES, dms_source_sink
from ocean_bgc_tpu_torch.ops.cuda_carbonate import (
    co3_terms_dual_sat,
    co3_terms_dual_sat_torch,
)
from ocean_bgc_tpu_torch.params import DMSParams
from ocean_bgc_tpu_torch.state import BGCTracers as T
from ocean_bgc_tpu_torch.state import DMSTracers
from ocean_bgc_tpu_torch.utils.bridge import params_from_dict, world_from_numpy
from ocean_bgc_tpu_torch.utils.profiling import counters
from tests.test_torch_diags import DT, NCOL, NLEV, _h_close, _np


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
    before = (counters()["k1.coeffs"], counters()["k1.dual"])
    a = co3_terms_dual_sat(*args)
    b = co3_terms_dual_sat(*args, impl="torch")
    for x, y in zip(a[0] + a[1] + a[2], b[0] + b[1] + b[2]):
        assert torch.equal(x, y)
    c = co3_terms_dual_sat(*args, with_sat=False)
    assert c[2] is None
    for x, y in zip(a[0] + a[1], c[0] + c[1]):
        assert torch.equal(x, y)
    assert (counters()["k1.coeffs"],
            counters()["k1.dual"]) == before
    with pytest.raises(ValueError, match="CUDA"):
        co3_terms_dual_sat(*args, impl="kernel")


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
