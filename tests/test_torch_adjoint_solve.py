"""The implicit-function backward of K1's routes at the carbonate level
(CPU, f64), held to JAX's custom VJP live (``jax.grad`` of
``co3_terms_dual`` and ``co2calc_surface_dual``) and to finite
differences; the guarded division's den**2-free backward; and the three
sites whose plain derivative is not finite at 0 (ROADMAP queue 3 #6).
Inputs are made with numpy from a seed."""

import numpy as np
import pytest
import torch

import ocean_bgc_tpu  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from ocean_bgc_tpu.ops import carbonate as jcarb

from ocean_bgc_tpu_torch.constants import DEL_PH, PHHI_3D_INIT, PHLO_3D_INIT
from ocean_bgc_tpu_torch.ops import carbonate as tcarb
from ocean_bgc_tpu_torch.ops import cuda_carbonate as cc
from ocean_bgc_tpu_torch.ops.numerics import (
    pow_floor0,
    safe_div,
    sqrt_abs,
    z_sqrt_z,
)


def _cells(seed, n):
    rng = np.random.default_rng(seed)
    return dict(depth=rng.uniform(0.0, 5000.0, n),
                temp=rng.uniform(-1.8, 31.0, n),
                salt=rng.uniform(30.0, 40.0, n),
                dic=rng.uniform(1800.0, 2400.0, n),
                ta=rng.uniform(2000.0, 2500.0, n),
                pt=rng.uniform(0.0, 3.5, n),
                sit=rng.uniform(0.0, 150.0, n),
                press=rng.random(n) < 0.8,
                ph=rng.uniform(7.6, 8.3, n))


def _weights(seed, k, n):
    return np.random.default_rng(seed).uniform(0.5, 1.5, (k, n))


def _weighted(outs, w, scales):
    return sum((o * wi).sum() / s for o, wi, s in zip(outs, w, scales))


ARGS = ("temp", "salt", "dic", "ta", "pt", "sit")
# the two packages run the same per-lane iteration to the same roots
# (|dH| <= 2 xacc); with Newton's quadratic convergence the roots agree
# far below xacc, and the gradients, formed at the roots, to 1e-8
GRAD_RTOL = 1e-8


def test_interior_solve_gradient_matches_jax():
    """The dual instance's route (both scenarios' pH, H2CO3, HCO3, CO3)
    against jax.grad of co3_terms_dual, through the constants, with
    respect to T, S, DIC, ALK, PO4 and SiO3 of 64 seeded cells; in half
    of them the ambient scenario solves from the cold window and ALT_CO2
    from a warm one, in the other half the other way round."""
    n = 64
    w = _cells(11, n)
    half = np.arange(n) < n // 2
    ph_a = np.where(half, 0.0, w["ph"])
    ph_b = np.where(half, w["ph"], 0.0)
    wts = _weights(12, 8, n)

    def window(ph):
        cold = ph == 0.0
        return (np.where(cold, PHLO_3D_INIT, ph - DEL_PH),
                np.where(cold, PHHI_3D_INIT, ph + DEL_PH))

    (lo_a, hi_a), (lo_b, hi_b) = window(ph_a), window(ph_b)
    ja = jcarb.co3_terms_dual(*(jnp.asarray(w[k]) for k in ("depth",) + ARGS),
                              *(jnp.asarray(x) for x in (lo_a, hi_a, lo_b,
                                                         hi_b)),
                              jnp.asarray(w["press"]))
    scales = [float(jnp.mean(jnp.abs(o))) for o in (*ja[0], *ja[1])]

    def jloss(*xs):
        a, b = jcarb.co3_terms_dual(
            jnp.asarray(w["depth"]), *xs,
            *(jnp.asarray(x) for x in (lo_a, hi_a, lo_b, hi_b)),
            jnp.asarray(w["press"]))
        return _weighted((*a, *b), jnp.asarray(wts), scales)

    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(
        *(jnp.asarray(w[k]) for k in ARGS))

    xs = [torch.tensor(w[k], requires_grad=True) for k in ARGS]
    coeffs = tcarb.carbonate_coeffs(torch.tensor(w["depth"]), xs[0], xs[1],
                                    torch.tensor(w["press"]))
    a, b = cc.co3_terms_dual_coeffs(*xs[2:], torch.tensor(ph_a),
                                    torch.tensor(ph_b), coeffs)
    tg = torch.autograd.grad(_weighted((*a, *b), torch.tensor(wts), scales),
                             xs)
    for name, j, t in zip(ARGS, jg, tg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=GRAD_RTOL,
                                   atol=1e-12 * float(jnp.abs(j).max()),
                                   err_msg=name)


def test_surface_solve_gradient_matches_jax():
    """The surface pair's route (the bracket-in instance; both scenarios'
    pH, CO2*, dCO2*, pCO2, dpCO2) against jax.grad of
    co2calc_surface_dual with respect to T, S, both DICs, ALK, PO4 and
    SiO3 of 64 seeded cells, half of them from the cold [7, 9] window
    (the 0 sentinel) and half from warm windows."""
    n = 64
    w = _cells(21, n)
    w["dic_b"] = w["dic"] - np.random.default_rng(22).uniform(0.0, 80.0, n)
    xco2_a, xco2_b = np.full(n, 415.0), np.full(n, 284.0)
    atm = np.random.default_rng(23).uniform(0.95, 1.05, n)
    wts = _weights(24, 10, n)
    keys = ("temp", "salt", "dic", "dic_b", "ta", "pt", "sit")
    ph0 = np.where(np.arange(n) < n // 2, 0.0, w["ph"])

    def jrun(*xs):
        br = jcarb.warm_brackets_h(jnp.asarray(ph0), 7.0, 9.0, DEL_PH)
        return jcarb.co2calc_surface_dual(
            jnp.zeros(n), *xs, None, None, None, None,
            jnp.asarray(xco2_a), jnp.asarray(xco2_b), jnp.asarray(atm),
            brackets_a=br, brackets_b=br)

    jout = jrun(*(jnp.asarray(w[k]) for k in keys))
    scales = [float(jnp.mean(jnp.abs(o))) for o in (*jout[0], *jout[1])]
    def jloss(*xs):
        a, b = jrun(*xs)
        return _weighted((*a, *b), jnp.asarray(wts), scales)

    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(7))))(
        *(jnp.asarray(w[k]) for k in keys))

    xs = [torch.tensor(w[k], requires_grad=True) for k in keys]
    br = tcarb.warm_brackets_h(torch.tensor(ph0), 7.0, 9.0, DEL_PH)
    a, b = tcarb.co2calc_surface_dual(
        torch.zeros(n, dtype=torch.float64), *xs, None, None, None, None,
        torch.tensor(xco2_a), torch.tensor(xco2_b), torch.tensor(atm),
        brackets_a=br, brackets_b=br)
    tg = torch.autograd.grad(_weighted((*a, *b), torch.tensor(wts), scales),
                             xs)
    for name, j, t in zip(keys, jg, tg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=GRAD_RTOL,
                                   atol=1e-12 * float(jnp.abs(j).max()),
                                   err_msg=name)


def test_ph_gradient_matches_finite_difference():
    """As tests/test_autodiff.py:20 and :39: dpH/dDIC of one interior cell
    and dpCO2/dALK, dpCO2/dT of one surface cell, against central finite
    differences (the solver truncates at xacc, so the steps keep the
    signal above its noise) and in sign."""
    def ph_of_dic(dic):
        coeffs = tcarb.carbonate_coeffs(torch.zeros(1, dtype=torch.float64),
                                        torch.full((1,), 15.0,
                                                   dtype=torch.float64),
                                        torch.full((1,), 35.0,
                                                   dtype=torch.float64),
                                        False)
        one = torch.ones(1, dtype=torch.float64)
        (ph, *_), _ = cc.co3_terms_dual_coeffs(
            dic.reshape(1), 2300.0 * one, one, 30.0 * one, 0.0 * one,
            0.0 * one, coeffs)
        return ph[0]

    dic0 = torch.tensor(2100.0, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(ph_of_dic(dic0), dic0)
    with torch.no_grad():
        fd = (float(ph_of_dic(dic0 + 1.0)) - float(ph_of_dic(dic0 - 1.0))) / 2
    np.testing.assert_allclose(float(g), fd, rtol=5e-3)
    assert float(g) < 0.0   # more DIC -> more acidic

    def pco2_of(alk, temp):
        one = torch.ones(1, dtype=torch.float64)
        a, _ = tcarb.co2calc_surface_dual(
            0.0 * one, temp.reshape(1), 35.0 * one, 2050.0 * one,
            2050.0 * one, alk.reshape(1), 0.5 * one, 5.0 * one, 7.0 * one,
            9.0 * one, 7.0 * one, 9.0 * one, 415.0 * one, 415.0 * one, one)
        return a[3][0]

    alk = torch.tensor(2300.0, dtype=torch.float64, requires_grad=True)
    temp = torch.tensor(18.0, dtype=torch.float64, requires_grad=True)
    g_alk, g_t = torch.autograd.grad(pco2_of(alk, temp), (alk, temp))
    assert float(g_alk) < 0.0   # more alkalinity -> lower pCO2
    assert float(g_t) > 0.0     # warmer -> higher pCO2
    with torch.no_grad():
        fd = (float(pco2_of(alk + 1e-2, temp))
              - float(pco2_of(alk - 1e-2, temp))) / 2e-2
    np.testing.assert_allclose(float(g_alk), fd, rtol=1e-3)


def test_dual_route_backward_matches_the_solve_function():
    """The dual route's backward (H recovered from each returned pH, the
    speciation rebuilt) against autograd through the plain solve
    Function and the speciation as recorded, within 1e-10: the recovery
    costs a few ulps of H, which the weighted sums' cancellations carry
    to ~4e-12 of a gradient."""
    n = 64
    w = _cells(31, n)
    wts = torch.tensor(_weights(32, 8, n))
    xs = [torch.tensor(w[k], requires_grad=True) for k in ARGS]

    def grads(fn):
        coeffs = tcarb.carbonate_coeffs(torch.tensor(w["depth"]), xs[0],
                                        xs[1], torch.tensor(w["press"]))
        a, b = fn(*xs[2:], torch.tensor(w["ph"]), torch.zeros(n), coeffs)
        return torch.autograd.grad(
            sum((o * wi).sum() / o.detach().abs().mean()
                for o, wi in zip((*a, *b), wts)), xs)

    got = grads(cc.co3_terms_dual_coeffs)
    want = grads(cc.co3_terms_dual_coeffs_torch)
    for name, t, r in zip(ARGS, got, want):
        np.testing.assert_allclose(t.numpy(), r.numpy(), rtol=1e-10,
                                   atol=1e-14 * float(r.abs().max()),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the guarded division and the sites whose plain derivative is not finite
# ---------------------------------------------------------------------------


def test_safe_div_backward_at_a_tiny_f32_denominator():
    """At den = 1e-23 in f32, den**2 flushes to 0 and the plain division's
    backward is inf; safe_div's den**2-free backward is finite and equals
    the analytic 1/den and -num/den**2 (formed as -(num/den)/den); at
    den = 0 both are 0."""
    num = torch.tensor([2e-23, 3.0e-24, 5.0], dtype=torch.float32,
                       requires_grad=True)
    den = torch.tensor([1e-23, 1e-23, 0.0], dtype=torch.float32,
                       requires_grad=True)
    q = safe_div(num, den)
    d_num, d_den = torch.autograd.grad(q.sum(), (num, den))
    assert torch.isfinite(d_num).all() and torch.isfinite(d_den).all()
    n64, d64 = num.detach().double(), den.detach().double()
    np.testing.assert_allclose(d_num[:2].numpy(), (1.0 / d64[:2]).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(d_den[:2].numpy(),
                               (-(n64[:2] / d64[:2]) / d64[:2]).numpy(),
                               rtol=1e-6)
    assert d_num[2] == 0.0 and d_den[2] == 0.0
    plain = torch.autograd.grad((num / den)[:2].sum(), den)[0]
    assert not torch.isfinite(plain).all()
    # a subnormal den with a zero incoming gradient: 1/den overflows at
    # f32, and a zero gradient times it would be NaN
    sub = torch.tensor([1e-40, 1e-40], dtype=torch.float32,
                       requires_grad=True)
    top = torch.tensor([1e-41, 3e-41], dtype=torch.float32,
                       requires_grad=True)
    g = torch.autograd.grad(safe_div(top, sub), (top, sub),
                            torch.tensor([0.0, 1e-3]))
    assert all(torch.isfinite(x).all() for x in g)
    assert g[0][0] == 0.0 and g[1][0] == 0.0
    # the forward is the guarded quotient, bitwise
    with torch.no_grad():
        assert torch.equal(q, torch.where(den != 0.0,
                                          num / torch.where(den != 0.0, den,
                                                            1.0), 0.0))


@pytest.mark.parametrize("site", ["z_sqrt_z", "pow_floor0", "sqrt_abs"])
def test_sites_have_finite_derivatives_at_zero(site):
    """The three sites of ROADMAP queue 3 #6 at exactly 0 and above: the
    forward bitwise the plain expression, the derivative finite at 0 (the
    chosen value: 0 for all three; for z**1.5 also the one-sided
    difference's limit, within sqrt(h) of it) and within 1e-6 of central
    differences above 0; for x**b also the derivative in b, x**b ln x,
    with its limit 0 at x = 0."""
    x = torch.tensor([0.0, 1e-3, 0.37, 2.5], dtype=torch.float64,
                     requires_grad=True)
    b = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    fn, plain = {
        "z_sqrt_z": (z_sqrt_z, lambda v: v * torch.sqrt(v)),
        "pow_floor0": (lambda v: pow_floor0(v, b), lambda v: v ** 0.5),
        "sqrt_abs": (sqrt_abs, lambda v: torch.sqrt(torch.abs(v))),
    }[site]
    y = fn(x)
    assert torch.equal(y.detach(), plain(x.detach()))
    (g,) = torch.autograd.grad(y.sum(), x, retain_graph=True)
    assert torch.isfinite(g).all() and g[0] == 0.0
    plain_g = torch.autograd.grad(plain(x).sum(), x)[0]
    assert not torch.isfinite(plain_g[0])   # what the sites repair
    h = 1e-7
    with torch.no_grad():
        for i in (1, 2, 3):
            xi = x.detach()[i]
            fd = (fn(xi + h) - fn(xi - h)) / (2 * h)
            np.testing.assert_allclose(float(g[i]), float(fd), rtol=1e-6)
        if site == "z_sqrt_z":
            one_sided = (fn(x.detach()[0] + h) - fn(x.detach()[0])) / h
            assert abs(float(one_sided) - float(g[0])) <= h ** 0.5
    if site == "pow_floor0":
        (gb,) = torch.autograd.grad(y.sum(), b)
        xs = x.detach()[1:]
        np.testing.assert_allclose(float(gb), float(
            (xs ** 0.5 * torch.log(xs)).sum()), rtol=1e-12)
