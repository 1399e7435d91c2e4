"""The port's single-point carbonate entry points (``comp_htotal``,
``co3_terms``, ``co2calc_surface``), its instrumented solve
``solve_htotal_stats`` and ``INTEGRATORS``, held against the JAX
package's functions of the same names and against the NumPy oracle
(``tests/oracle/carbonate_ref.py``), on n = 256 cells made with numpy from
a seed, as JAX's own tests make them.  On CPU tensors each runs K1's
plain version; on the card each is one launch of K1's bracket-in
instance, held bitwise to that plain version in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import ocean_bgc_tpu  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from ocean_bgc_tpu.models import integrators as jint
from ocean_bgc_tpu.ops import carbonate as jcarb

from ocean_bgc_tpu_torch.constants import (
    DEL_PH,
    PHHI_3D_INIT,
    PHLO_3D_INIT,
    XACC,
)
from ocean_bgc_tpu_torch.models import integrators as tint
from ocean_bgc_tpu_torch.ops import carbonate as tcarb
from ocean_bgc_tpu_torch.ops.carbonate import XACC_F32
from ocean_bgc_tpu_torch.ops.cuda_carbonate import solve_htotal_brackets
from tests.oracle import carbonate_ref as oracle

N = 256
DTYPES = {"f64": np.float64, "f32": np.float32}
# Roots: both packages run the same per-lane iteration, so at f64 they
# agree to the solver's tolerance (|dH| <= 2 xacc) and the speciation,
# which derives from H, to 1e-9 relative (quadratic convergence keeps a
# flipped last-step test far below xacc).  At f32 each package forms the
# constants itself: their exp arguments are sums of terms up to ~1.1e3
# that cancel to O(10), so a few f32 roundings of them (with each
# package's own f32 exp/log) move a constant by up to 3e-4 relative
# (tests/test_torch_carbonate.py's formula tolerance), and H and every
# derived value with it: 1e-3 relative, which is 1e-9 mol/kg of H (at
# most 1e-6 in the [6, 9] window) beside the 2 xacc of the solve.
TOL = {"f64": dict(h=2 * XACC, rel=1e-9),
       "f32": dict(h=2 * XACC_F32 + 1e-9, rel=1e-3)}


def _cells(seed, n=N):
    rng = np.random.default_rng(seed)
    return dict(depth=rng.uniform(0.0, 5000.0, n),
                temp=rng.uniform(-1.8, 30.0, n),
                salt=rng.uniform(31.0, 38.0, n),
                dic=rng.uniform(1850.0, 2350.0, n),
                ta=rng.uniform(2100.0, 2450.0, n),
                pt=rng.uniform(0.0, 3.0, n),
                sit=rng.uniform(0.0, 120.0, n),
                xco2=rng.uniform(280.0, 560.0, n),
                atm=rng.uniform(0.95, 1.05, n),
                press=rng.random(n) < 0.7)


def _both(w, keys, dtype):
    """(JAX arrays, torch CPU tensors) of ``w[k]`` for ``keys`` at
    ``dtype``."""
    arrs = [np.asarray(w[k]).astype(dtype) for k in keys]
    return [jnp.asarray(a) for a in arrs], [torch.tensor(a) for a in arrs]


def _close(got, want, rel, label):
    want = np.asarray(want, np.float64)
    got = got.detach().numpy().astype(np.float64)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert err.max() <= rel, (label, err.max())


def _h_close(ph_t, ph_j, tol, label):
    """H from the two pH fields within ``tol`` (mol/kg)."""
    ht = 10.0 ** -ph_t.detach().numpy().astype(np.float64)
    hj = 10.0 ** -np.asarray(ph_j, np.float64)
    assert np.abs(ht - hj).max() <= tol, (label, np.abs(ht - hj).max())


@pytest.mark.parametrize("name", list(DTYPES))
def test_single_point_api_matches_jax(name):
    """``co3_terms`` with ``apply_pressure`` as a bool (True and False)
    and as a mask, ``co2calc_surface`` with either k1/k2 fit, and
    ``comp_htotal`` on the surface constants, against JAX's on the same
    cells, cold [6, 9] window; the CPU tensors take the plain route and
    launch nothing."""
    dtype, tol = DTYPES[name], TOL[name]
    w = _cells(11)
    keys = ("depth", "temp", "salt", "dic", "ta", "pt", "sit")
    ja, ta = _both(w, keys, dtype)
    lo, hi = np.full(N, 6.0, dtype), np.full(N, 9.0, dtype)
    before = (solve_htotal_brackets.launches,
              solve_htotal_brackets.stats_launches)
    for label, press in (("no pressure", False), ("pressure", True),
                         ("mask", w["press"])):
        jout = jcarb.co3_terms(*ja, jnp.asarray(lo), jnp.asarray(hi),
                               jnp.asarray(press))
        tout = tcarb.co3_terms(*ta, torch.tensor(lo), torch.tensor(hi),
                               press if isinstance(press, bool)
                               else torch.tensor(press))
        assert all(t.dtype == ta[0].dtype and t.shape == (N,) for t in tout)
        _h_close(tout[0], jout[0], tol["h"], label)
        for t, j in zip(tout[1:], jout[1:]):
            _close(t, j, tol["rel"], f"co3_terms {label}")
    surf = [jnp.zeros(N, dtype), *ja[1:]], [torch.zeros(N, dtype=ta[0].dtype),
                                           *ta[1:]]
    (jx, jatm), (tx, tatm) = _both(w, ("xco2", "atm"), dtype)
    for fix in (True, False):
        jout = jcarb.co2calc_surface(*surf[0], jnp.asarray(lo),
                                     jnp.asarray(hi), jx, jatm,
                                     locmip_k1_k2_bug_fix=fix)
        tout = tcarb.co2calc_surface(*surf[1], torch.tensor(lo),
                                     torch.tensor(hi), tx, tatm,
                                     locmip_k1_k2_bug_fix=fix)
        _h_close(tout[0], jout[0], tol["h"],
                 f"surface {fix}")
        # dco2star and dpco2 are differences of O(1) terms: relative to
        # the terms they differ from (co2star, pco2surf)
        for i, (t, j) in enumerate(zip(tout[1:], jout[1:])):
            scale = np.abs(np.asarray(jout[1 if i < 2 else 3], np.float64))
            err = (np.abs(t.numpy().astype(np.float64) - np.asarray(j))
                   / scale)
            assert err.max() <= tol["rel"], (fix, i, err.max())
    jcf = jcarb.carbonate_coeffs(*surf[0][:3], False)
    tcf = tcarb.carbonate_coeffs(*surf[1][:3], False)
    jh, jd = jcarb.comp_htotal(jcf, *ja[3:], jnp.asarray(lo),
                               jnp.asarray(hi))
    th, td = tcarb.comp_htotal(tcf, *ta[3:], torch.tensor(lo),
                               torch.tensor(hi))
    assert np.abs(th.numpy() - np.asarray(jh)).max() <= tol["h"]
    _close(td, jd, 1e-15 if name == "f64" else 1e-7, "comp_htotal dic")
    assert (solve_htotal_brackets.launches,
            solve_htotal_brackets.stats_launches) == before


def test_single_point_api_matches_oracle_and_differentiates():
    """At f64 against the scalar oracle's brentq roots (every 4th cell),
    with pressure where the mask says; and the gradient of the surface
    pCO2 with respect to DIC and ALK through the solve's
    implicit-function rule against JAX's ``jax.grad`` (1e-8 relative:
    both are the implicit-function derivative at roots that agree to
    2 xacc)."""
    w = _cells(12)
    keys = ("depth", "temp", "salt", "dic", "ta", "pt", "sit")
    _, ta = _both(w, keys, np.float64)
    press = torch.tensor(w["press"])
    ph, h2co3, hco3, co3 = tcarb.co3_terms(*ta, 6.0, 9.0, press)
    surf = tcarb.co2calc_surface(torch.zeros(N, dtype=torch.float64),
                                 *ta[1:], 7.0, 9.0,
                                 torch.tensor(w["xco2"]),
                                 torch.tensor(w["atm"]))
    for i in range(0, N, 4):
        args = [w[k][i] for k in keys]
        ref = oracle.co3_terms(*args, 6.0, 9.0, bool(w["press"][i]))
        h_ref = 10.0 ** -ref[0]
        assert abs(10.0 ** -ph[i].item() - h_ref) <= 2 * XACC, i
        dh_rel = (abs(10.0 ** -ph[i].item() - h_ref) + 1e-13) / h_ref
        np.testing.assert_allclose(
            [h2co3[i].item(), hco3[i].item(), co3[i].item()], ref[1:],
            rtol=3 * dh_rel + 1e-9)
        sref = oracle.co2calc_surface(0.0, *args[1:], 7.0, 9.0,
                                      w["xco2"][i], w["atm"][i])
        h_ref = 10.0 ** -sref[0]
        assert abs(10.0 ** -surf[0][i].item() - h_ref) <= 2 * XACC, i
        dh_rel = (abs(10.0 ** -surf[0][i].item() - h_ref) + 1e-13) / h_ref
        np.testing.assert_allclose([surf[1][i].item(), surf[3][i].item()],
                                   [sref[1], sref[3]],
                                   rtol=3 * dh_rel + 1e-9)

    dic = torch.tensor(w["dic"], requires_grad=True)
    alk = torch.tensor(w["ta"], requires_grad=True)
    zero = torch.zeros(N, dtype=torch.float64)
    pco2 = tcarb.co2calc_surface(zero, ta[1], ta[2], dic, alk, ta[5],
                                 ta[6], 7.0, 9.0, 400.0, 1.0)[3]
    gd, ga = torch.autograd.grad(pco2.sum(), (dic, alk))

    def jax_pco2(d, a):
        return jcarb.co2calc_surface(
            jnp.zeros(N), jnp.asarray(w["temp"]), jnp.asarray(w["salt"]), d,
            a, jnp.asarray(w["pt"]), jnp.asarray(w["sit"]),
            jnp.full(N, 7.0), jnp.full(N, 9.0), 400.0, 1.0)[3].sum()
    jd, ja_ = jax.grad(jax_pco2, (0, 1))(jnp.asarray(w["dic"]),
                                         jnp.asarray(w["ta"]))
    np.testing.assert_allclose(gd.numpy(), np.asarray(jd), rtol=1e-8)
    np.testing.assert_allclose(ga.numpy(), np.asarray(ja_), rtol=1e-8)


def _stats_inputs(seed, dtype, n=N):
    w = _cells(seed, n)
    keys = ("temp", "salt", "dic", "ta", "pt", "sit")
    ja, ta = _both(w, keys, dtype)
    jcf = jcarb.carbonate_coeffs(jnp.zeros(n, dtype), ja[0], ja[1], False)
    # the same constants in both packages (the env cache's role), so that
    # the two solves iterate on the same residual
    tcf = tcarb.CarbCoeffs(*(torch.tensor(np.asarray(k)) for k in jcf))
    jm = jcarb._to_mass_units(*ja[2:])
    tm = tcarb._to_mass_units(*ta[2:])
    return (jcf, *jm), (tcf, *tm)


@pytest.mark.parametrize("name", list(DTYPES))
def test_solve_htotal_stats_matches_jax(name):
    """``solve_htotal_stats`` against JAX's on the same constants, cold
    [6, 9] window, warm +/-DEL_PH windows around roots moved by up to
    0.15 pH, and seeded at the previous root: the converged flags equal
    lane for lane, and at f64 the steps too, with H within 2 xacc (the
    same iteration on the same residual).

    At f32 JAX's jitted residual is not the op-by-op IEEE one the port
    (and K1 on the card) evaluates: XLA fuses it, and its last bits
    differ in ~60 of these 256 lanes.  The f32 iteration ends in a
    bisection tail on the residual's rounding noise, so such a bit moves
    a lane's step count: 87-120 lanes differ, by up to 21 steps, the
    means by up to 1.02 steps, and H by up to 2.6 xacc_f32.  Held here:
    H within 4 xacc_f32 and the mean steps within 1.5."""
    dtype = DTYPES[name]
    xacc = XACC if name == "f64" else XACC_F32
    jin, tin = _stats_inputs(13, dtype)
    rng = np.random.default_rng(14)
    cold = [np.full(N, 10.0 ** -PHHI_3D_INIT, dtype),
            np.full(N, 10.0 ** -PHLO_3D_INIT, dtype)]
    h0 = tcarb.solve_htotal_stats(*tin, *(torch.tensor(x) for x in cold))[0]
    ph = (-np.log10(h0.numpy().astype(np.float64))
          + rng.uniform(-0.15, 0.15, N)).astype(dtype)
    warm = [x.numpy() for x in tcarb.warm_brackets_h(
        torch.tensor(ph), PHLO_3D_INIT, PHHI_3D_INIT, DEL_PH,
        with_seed=True)]
    for label, br in (("cold", cold), ("warm", warm[:2]),
                      ("seeded", warm)):
        jh, jit, jcv = jcarb.solve_htotal_stats(
            *jin, *(jnp.asarray(x) for x in br[:2]),
            x0=jnp.asarray(br[2]) if len(br) > 2 else None)
        th, tit, tcv = tcarb.solve_htotal_stats(
            *tin, *(torch.tensor(x) for x in br))
        assert tit.dtype == torch.int32 and tcv.dtype == torch.bool
        dh = np.abs(th.numpy().astype(np.float64)
                    - np.asarray(jh, np.float64)).max()
        np.testing.assert_array_equal(tcv.numpy(), np.asarray(jcv),
                                      err_msg=label)
        assert tcv.all(), label
        if name == "f64":
            assert dh <= 2 * xacc, label
            np.testing.assert_array_equal(tit.numpy(), np.asarray(jit),
                                          err_msg=label)
        else:
            assert dh <= 4 * xacc, label
            assert abs(tit.double().mean().item()
                       - float(np.asarray(jit).mean())) <= 1.5, label
    with pytest.raises(RuntimeError, match="require grad"):
        tcarb.solve_htotal_stats(tin[0], tin[1].requires_grad_(), *tin[2:],
                                 *(torch.tensor(x) for x in cold))


def test_warm_start_halves_iterations():
    """JAX's protocol (tests/test_solver_stats.py) on the port: the cold
    [1e-9, 1e-6] window against +/-0.2 pH windows around its roots; both
    converge everywhere to the same root (1e-4 relative, 2e-10 absolute),
    and the mean steps fall by more than a third, within the reference's
    documented ranges (~12 cold, ~5 warm)."""
    _, tin = _stats_inputs(15, np.float64)
    ones = torch.ones(N, dtype=torch.float64)
    h_cold, it_cold, cv_cold = tcarb.solve_htotal_stats(
        *tin, 1e-9 * ones, 1e-6 * ones)
    assert cv_cold.all()
    ph = -torch.log10(h_cold)
    h_warm, it_warm, cv_warm = tcarb.solve_htotal_stats(
        *tin, torch.pow(10.0, -(ph + 0.2)), torch.pow(10.0, -(ph - 0.2)))
    assert cv_warm.all()
    np.testing.assert_allclose(h_warm.numpy(), h_cold.numpy(), rtol=1e-4,
                               atol=2e-10)
    mean_cold = it_cold.double().mean().item()
    mean_warm = it_warm.double().mean().item()
    assert mean_cold > 1.5 * mean_warm, (mean_cold, mean_warm)
    assert 3.0 <= mean_cold <= 25.0 and 1.0 <= mean_warm <= 10.0


def test_x0_seed_same_root_fewer_iterations():
    """JAX's seed protocol (tests/test_carbonate.py:300-340) on the port:
    seeded at the previous root, the solve reaches the midpoint-seeded
    root within 3e-10 in fewer steps on average (by more than half a
    step) and at most as many at worst."""
    _, tin = _stats_inputs(16, np.float64, n=512)
    ones = torch.ones(512, dtype=torch.float64)
    h_prev, _, conv = tcarb.solve_htotal_stats(
        *tin, 10.0 ** -PHHI_3D_INIT * ones, 10.0 ** -PHLO_3D_INIT * ones)
    assert conv.all()
    x1, x2, x0 = tcarb.warm_brackets_h(-torch.log10(h_prev), PHLO_3D_INIT,
                                       PHHI_3D_INIT, DEL_PH, with_seed=True)
    h_mid, it_mid, cv1 = tcarb.solve_htotal_stats(*tin, x1, x2)
    h_x0, it_x0, cv2 = tcarb.solve_htotal_stats(*tin, x1, x2, x0=x0)
    assert cv1.all() and cv2.all()
    np.testing.assert_allclose(h_x0.numpy(), h_mid.numpy(), rtol=0,
                               atol=3e-10)
    assert it_x0.double().mean() < it_mid.double().mean() - 0.5
    assert it_x0.max() <= it_mid.max()


def test_integrators_by_name():
    """``INTEGRATORS`` names JAX's integrators: forward Euler as None (the
    coupled step itself), RK2 and RK4 as the port's steps."""
    assert list(tint.INTEGRATORS) == list(jint.INTEGRATORS)
    assert tint.INTEGRATORS == {"euler": None, "rk2": tint.step_rk2,
                                "rk4": tint.step_rk4}
