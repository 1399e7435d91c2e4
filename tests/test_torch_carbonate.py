"""The port's carbonate chemistry and K1's plain version, held against the
JAX package (XLA path and the Pallas kernel in interpret mode) and the
scipy oracle.  Inputs are made with numpy from a seed and go through
both packages.  K1's bracket-in instance's plain route and the kernels'
argument layouts are in ``tests/test_torch_carbonate_brackets.py``."""

import numpy as np
import pytest
import torch

import ocean_bgc_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp

from ocean_bgc_tpu.ops import carbonate as jcarb
from ocean_bgc_tpu.ops.pallas_carbonate import co3_terms_dual_sat_pallas

from ocean_bgc_tpu_torch.constants import DEL_PH, XACC
from ocean_bgc_tpu_torch.ops import carbonate as tcarb
from ocean_bgc_tpu_torch.ops.cuda_carbonate import (
    COEFF_OUTPUTS,
    carbonate_coeffs_sat,
    co3_terms_dual_coeffs,
    co3_terms_dual_coeffs_torch,
)
from tests.oracle import carbonate_ref as oracle

# the f32 solver tolerance in H (carbonate.py:450-455)
XACC_F32 = 1e-5 * 1e-8


def _cells(seed, n):
    rng = np.random.default_rng(seed)
    return dict(depth=rng.uniform(0.0, 5000.0, n),
                temp=rng.uniform(-1.8, 31.0, n),
                salt=rng.uniform(30.0, 40.0, n),
                dic=rng.uniform(1800.0, 2400.0, n),
                ta=rng.uniform(2000.0, 2500.0, n),
                pt=rng.uniform(0.0, 3.5, n),
                sit=rng.uniform(0.0, 150.0, n),
                press=rng.random(n) < 0.8)


def _t(a, dtype=torch.float64):
    """A CPU tensor of ``a``, of ``dtype`` (None: ``a``'s own)."""
    return torch.tensor(np.asarray(a), dtype=dtype)


def _coeffs_both(w, dtype):
    """The same equilibrium constants for both packages: the port's f64
    values rounded to ``dtype`` (the env cache's role)."""
    cf = tcarb.carbonate_coeffs(_t(w["depth"]), _t(w["temp"]),
                                _t(w["salt"]), torch.tensor(w["press"]))
    arrs = [k.numpy().astype(dtype) for k in cf]
    return (jcarb.CarbCoeffs(*(jnp.asarray(a) for a in arrs)),
            tcarb.CarbCoeffs(*(torch.tensor(a) for a in arrs)))


# Formula ports: the same expressions in the same order, so the two
# packages differ only by libm/XLA ulps.  At f64, 1e-13 relative bounds a
# few ulps through the ~10-term exp arguments.  At f32 the exp arguments
# are sums of terms up to ~1.1e3 (kb's) that cancel to O(10): four f32
# roundings of such a term, 4 * 1.1e3 * 2**-24 ~ 2.6e-4, are that
# relative error in the constant, so 3e-4; the residual's terms (~2.5e-3
# mol/kg) carry it, so its atol is 3e-4 of that scale.
_FORMULA_TOL = {np.float64: dict(rtol=1e-13, fn_atol=1e-15, df_rtol=1e-12),
                np.float32: dict(rtol=3e-4, fn_atol=7.5e-7, df_rtol=3e-4)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_coeffs_talk_sat_match_jax_f64(dtype):
    """The constants, the alkalinity residual and the saturation values
    of both packages, the surface and interior forms, and the constants
    kernel's plain version (``carbonate_coeffs_sat`` on CPU tensors, with
    the pressure gate below the first level).  All on (20, 20) fields, so
    that JAX compiles each operation once."""
    tol = _FORMULA_TOL[dtype]
    w = {k: v.reshape(20, 20) for k, v in _cells(1, 400).items()}
    args = tuple(w[k].astype(dtype) for k in ("depth", "temp", "salt"))
    for ph_tot in (True, False):
        jc = jcarb.carbonate_coeffs(*(jnp.asarray(a) for a in args),
                                    jnp.asarray(w["press"]),
                                    k1_k2_ph_tot=ph_tot)
        tc = tcarb.carbonate_coeffs(*(_t(a, None) for a in args),
                                    torch.tensor(w["press"]),
                                    k1_k2_ph_tot=ph_tot)
        for name, a, b in zip(jcarb.CarbCoeffs._fields, jc, tc):
            assert b.dtype == _t(args[0], None).dtype
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=tol["rtol"], err_msg=name)
    # the surface form takes a Python bool gate
    jc0 = jcarb.carbonate_coeffs(*(jnp.asarray(a) for a in args), False)
    tc0 = tcarb.carbonate_coeffs(*(_t(a, None) for a in args), False)
    for a, b in zip(jc0, tc0):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   rtol=tol["rtol"])

    h = (10.0 ** -np.random.default_rng(2).uniform(6.5, 9.0, (20, 20))
         ).astype(dtype)
    m = [(w[k] * (1.0 / 1.026e6)).astype(dtype)
         for k in ("dic", "ta", "pt", "sit")]
    fj, dj = jcarb.talk(jc, *(jnp.asarray(a) for a in m), jnp.asarray(h))
    ft, dt = tcarb.talk(tc, *(_t(a, None) for a in m), _t(h, None))
    # fn is a difference of ~1e-3 terms near a root: compare on the
    # terms' scale, not relative to fn itself
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0,
                               atol=tol["fn_atol"])
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj),
                               rtol=tol["df_rtol"])

    sj = jcarb.co3_sat_vals(*(jnp.asarray(a) for a in args),
                            jnp.asarray(w["press"]))
    st = tcarb.co3_sat_vals(*(_t(a, None) for a in args),
                            torch.tensor(w["press"]))
    for a, b in zip(sj, st):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   rtol=tol["rtol"])

    # the constants kernel's plain version: pressure below the first level
    subsurface = np.repeat((np.arange(20) > 0)[:, None], 20, axis=1)
    jc = jcarb.carbonate_coeffs(*(jnp.asarray(a) for a in args),
                                jnp.asarray(subsurface), k1_k2_ph_tot=True)
    sj = jcarb.co3_sat_vals(*(jnp.asarray(a) for a in args),
                            jnp.asarray(subsurface))
    before = carbonate_coeffs_sat.launches
    for with_sat in (True, False):
        tc, st = carbonate_coeffs_sat(*(_t(a, None) for a in args),
                                      with_sat=with_sat)
        assert (st is None) != with_sat
        for name, a, b in zip(COEFF_OUTPUTS, (*jc, *sj), (*tc, *(st or ()))):
            assert b.dtype == _t(args[0], None).dtype
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=tol["rtol"], err_msg=name)
    assert carbonate_coeffs_sat.launches == before     # no kernel on CPU
    with pytest.raises(ValueError, match="CUDA"):
        carbonate_coeffs_sat(*(_t(a, None) for a in args), impl="kernel")


def _surface_inputs(seed, n):
    w = _cells(seed, n)
    rng = np.random.default_rng(seed + 100)
    w["dic_b"] = w["dic"] - rng.uniform(0.0, 80.0, n)
    w["xco2_a"] = np.full(n, 415.0)
    w["xco2_b"] = np.full(n, 284.0)
    w["atm"] = rng.uniform(0.95, 1.05, n)
    w["depth"] = np.zeros(n)
    return w


@pytest.mark.parametrize("warm", [False, True])
def test_co2calc_surface_dual_matches_jax_f64(warm):
    """The surface pair runs the same per-lane iteration in both packages
    (no trusted-bracket skip in the port; without bracket growth both
    orient the warm window the same way).  Roots agree to solver
    tolerance (|dH| <= 2 xacc); the flux terms derive from H, and
    Newton's quadratic convergence keeps a flipped last-step test far
    below xacc, so they agree to 1e-9 relative."""
    w = _surface_inputs(3, 300)
    keys = ("depth", "temp", "salt", "dic", "dic_b", "ta", "pt", "sit")
    ja = [jnp.asarray(w[k]) for k in keys]
    ta_ = [_t(w[k]) for k in keys]
    if warm:
        ph0 = np.random.default_rng(4).uniform(7.9, 8.3, 300)
        jbr = jcarb.warm_brackets_h(jnp.asarray(ph0), 7.0, 9.0, DEL_PH)
        tbr = tcarb.warm_brackets_h(_t(ph0), 7.0, 9.0, DEL_PH)
        jout = jcarb.co2calc_surface_dual(
            *ja, None, None, None, None, jnp.asarray(w["xco2_a"]),
            jnp.asarray(w["xco2_b"]), jnp.asarray(w["atm"]),
            brackets_a=jbr, brackets_b=jbr)
        tout = tcarb.co2calc_surface_dual(
            *ta_, None, None, None, None, _t(w["xco2_a"]), _t(w["xco2_b"]),
            _t(w["atm"]), brackets_a=tbr, brackets_b=tbr)
    else:
        lo, hi = np.full(300, 7.0), np.full(300, 9.0)
        jout = jcarb.co2calc_surface_dual(
            *ja, *(jnp.asarray(a) for a in (lo, hi, lo, hi)),
            jnp.asarray(w["xco2_a"]), jnp.asarray(w["xco2_b"]),
            jnp.asarray(w["atm"]))
        tout = tcarb.co2calc_surface_dual(
            *ta_, *(_t(a) for a in (lo, hi, lo, hi)), _t(w["xco2_a"]),
            _t(w["xco2_b"]), _t(w["atm"]))
    for js, ts in zip(jout, tout):
        hj = 10.0 ** -np.asarray(js[0])
        ht = 10.0 ** -ts[0].numpy()
        assert np.abs(hj - ht).max() <= 2 * XACC
        for a, b in zip(js[1:], ts[1:]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9,
                                       atol=1e-12)


def _k1_world(seed, n):
    """Cells in three groups: cold brackets (pH 0 sentinel), warm brackets
    around the root, and warm brackets off by 0.5 pH (> DEL_PH), which
    must grow before they straddle the root."""
    w = _cells(seed, n)
    w["press"] = np.ones(n, bool)
    mass = tcarb._to_mass_units(*(_t(w[k]) for k in
                                  ("dic", "ta", "pt", "sit")))
    cf = tcarb.carbonate_coeffs(_t(w["depth"]), _t(w["temp"]),
                                _t(w["salt"]), True)
    h = tcarb._solve_htotal_impl(cf, *mass, _t(np.full(n, 1e-9)),
                                 _t(np.full(n, 1e-6)))
    ph_root = -np.log10(h.numpy())
    third = n // 3
    ph_prev = ph_root.copy()
    ph_prev[:third] = 0.0
    ph_prev[third:2 * third] += np.random.default_rng(seed).uniform(
        -0.05, 0.05, third)
    ph_prev[2 * third:] += np.where(np.arange(n - 2 * third) % 2, 0.5, -0.5)
    return w, ph_prev


def _pallas_brackets(ph):
    """pH-space brackets exactly as bgc_source_sink builds them for the
    kernel path (ops/bgc.py:1189-1196)."""
    warm = ph != 0.0
    return (jnp.where(warm, ph - DEL_PH, 6.0),
            jnp.where(warm, ph + DEL_PH, 9.0))


def test_k1_plain_matches_pallas_kernel_f32():
    """K1's plain version against the Pallas kernel it ports, in
    interpret mode, in the instance the main path launches (cached
    coefficients, no saturation).  Roots to solver tolerance
    (|dH| <= 2 xacc_f32 = 2e-13 on H ~ 1e-8); speciation within 1e-4
    relative, which is the 2e-5 relative root tolerance plus f32
    rounding of the products.  H is recovered from the f32 pH output,
    whose own rounding (half an ulp of pH, up to ~4e-14 in H at pH 6.8)
    is added to the root tolerance for each of the two outputs."""
    n = 1500
    w, ph_prev = _k1_world(5, n)
    ph_b = np.roll(ph_prev, n // 3)      # scenario b: other bracket types
    f32 = np.float32
    jcf, tcf = _coeffs_both(w, f32)
    ins = {k: w[k].astype(f32) for k in ("depth", "temp", "salt", "dic",
                                          "ta", "pt", "sit")}
    pa, pb = ph_prev.astype(f32), ph_b.astype(f32)
    lo_a, hi_a = _pallas_brackets(jnp.asarray(pa))
    lo_b, hi_b = _pallas_brackets(jnp.asarray(pb))
    jout_a, jout_b, sat = co3_terms_dual_sat_pallas(
        *(jnp.asarray(ins[k]) for k in ("depth", "temp", "salt", "dic",
                                        "ta", "pt", "sit")),
        lo_a, hi_a, lo_b, hi_b, jnp.asarray(w["press"]), interpret=True,
        coeffs=jcf, with_sat=False)
    assert sat is None
    tout_a, tout_b, stats = co3_terms_dual_coeffs_torch(
        *(torch.tensor(ins[k]) for k in ("dic", "ta", "pt", "sit")),
        torch.tensor(pa), torch.tensor(pb), tcf, with_stats=True)
    # the three bracket kinds are exercised: only the off-window group
    # grows its bracket, and every lane converges
    third = n // 3
    grows = stats[0]["grows"].numpy()
    assert (grows[2 * third:] > 0).all() and (grows[:2 * third] == 0).all()
    assert all(st["converged"].all() for st in stats)
    for jo, to in ((jout_a, tout_a), (jout_b, tout_b)):
        assert to[0].dtype == torch.float32 and to[0].shape == (n,)
        ph_j = np.asarray(jo[0], np.float64)
        hj = 10.0 ** -ph_j
        ht = 10.0 ** -to[0].numpy().astype(np.float64)
        ph_ulp = np.spacing(np.abs(np.asarray(jo[0]))).astype(np.float64)
        tol = 2 * XACC_F32 + 2 * np.log(10.0) * hj * ph_ulp
        assert (np.abs(hj - ht) <= tol).all()
        for a, b in zip(jo[1:], to[1:]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4)


def test_k1_plain_matches_jax_dual_and_oracle_f64():
    """At f64, against the JAX XLA dual solve (same cells, same pH
    brackets) and against the scipy brentq oracle.  Roots to solver
    tolerance (|dH| <= 2 xacc = 2e-10); speciation within 1e-9 relative
    of JAX (both run the same iteration, so H differs by ulps unless a
    last-step test flips, which quadratic convergence keeps far below
    xacc)."""
    n = 600
    w, ph_prev = _k1_world(6, n)
    jcf, tcf = _coeffs_both(w, np.float64)
    lo, hi = _pallas_brackets(jnp.asarray(ph_prev))
    jout, _ = jcarb.co3_terms_dual(
        *(jnp.asarray(w[k]) for k in ("depth", "temp", "salt", "dic", "ta",
                                      "pt", "sit")),
        lo, hi, lo, hi, jnp.asarray(w["press"]), coeffs=jcf)
    tout, tout_b = co3_terms_dual_coeffs_torch(
        *(_t(w[k]) for k in ("dic", "ta", "pt", "sit")), _t(ph_prev),
        _t(ph_prev), tcf)
    ht = 10.0 ** -tout[0].numpy()
    np.testing.assert_array_equal(tout_b[0].numpy(), tout[0].numpy())
    assert np.abs(10.0 ** -np.asarray(jout[0]) - ht).max() <= 2 * XACC
    for a, b in zip(jout[1:], tout[1:]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9)

    # the oracle's brentq root, on every 4th cell (scalar Python solves)
    for i in range(0, n, 4):
        lo_i, hi_i = ((6.0, 9.0) if ph_prev[i] == 0.0
                      else (ph_prev[i] - DEL_PH, ph_prev[i] + DEL_PH))
        ph_ref, h2co3, hco3, co3 = oracle.co3_terms(
            w["depth"][i], w["temp"][i], w["salt"][i], w["dic"][i],
            w["ta"][i], w["pt"][i], w["sit"][i], lo_i, hi_i, True)
        h_ref = 10.0 ** -ph_ref
        assert abs(h_ref - ht[i]) <= 2 * XACC, i
        # the speciation carries the root's difference (xacc is loose
        # in relative terms) plus the oracle's independent constant fits
        dh_rel = (abs(ht[i] - h_ref) + 1e-13) / h_ref
        np.testing.assert_allclose(
            [tout[1][i].item(), tout[2][i].item(), tout[3][i].item()],
            [h2co3, hco3, co3], rtol=3 * dh_rel + 1e-9)


def test_k1_impl_selection():
    w, ph = _k1_world(7, 30)
    _, tcf = _coeffs_both(w, np.float64)
    args = [_t(w[k]) for k in ("dic", "ta", "pt", "sit")] + [_t(ph), _t(ph)]
    before = co3_terms_dual_coeffs.launches
    a = co3_terms_dual_coeffs(*args, tcf, impl="auto")
    b = co3_terms_dual_coeffs(*args, tcf, impl="torch")
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)
    assert co3_terms_dual_coeffs.launches == before   # no kernel on CPU
    with pytest.raises(ValueError, match="CUDA"):
        co3_terms_dual_coeffs(*args, tcf, impl="kernel")
    with pytest.raises(ValueError, match="unknown"):
        co3_terms_dual_coeffs(*args, tcf, impl="pallas")
