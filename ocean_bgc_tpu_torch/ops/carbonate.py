"""Carbonate-system chemistry: equilibrium constants, total-alkalinity
root-find, speciation, and saturation states.

Counterpart of ``ocean_bgc_tpu/ops/carbonate.py`` (the reference's
``co2calc``, co2calc.F90:1-1242).  Every routine is elementwise over
tensors of any shape.  The pH solve (:func:`_solve_htotal_impl`) is the
plain PyTorch form of the bracketed safe-Newton iteration: every lane
carries its own bracket and Newton state and freezes when it converges,
so each lane's result is independent of its batchmates — the property
that lets the CUDA kernel (``ops/cuda_carbonate.py``) run one thread per
cell with its own loop and still agree with this code.  For autograd the
root is :func:`solve_htotal` (:func:`implicit_root` for a kernel's root):
the implicit-function backward, never a derivative through the
iteration.

Every sum and product keeps the JAX package's association order; the
docstring of :func:`talk` says why.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ocean_bgc_tpu_torch.constants import (
    ALK_MIN,
    DIC_MIN,
    INV_R_GAS,
    MASS_TO_VOL,
    MAXIT,
    SALT_MIN,
    T0_KELVIN,
    VOL_TO_MASS,
    XACC,
)
from ocean_bgc_tpu_torch.utils.profiling import readback

_LN10 = 2.302585092994045684   # ln(10)
_LN_001 = -4.605170185988091368  # ln(1e-2)
_BRACKET_GROW_GUARD = 60   # geometric growth; reference loop is unbounded
                           # (abort commented out, co2calc.F90:931-933)
# the f32 solver tolerance: H ~ 1e-8 mol/kg at f32 eps ~ 1.2e-7 relative
XACC_F32 = 1e-5 * 1e-8


class CarbCoeffs(NamedTuple):
    """The 11 equilibrium constants + 3 total concentrations of
    comp_co3_coeffs (co2calc.F90:320-777), one value per cell."""

    k0: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    ff: torch.Tensor      # CO2 fugacity factor
    kb: torch.Tensor
    k1p: torch.Tensor
    k2p: torch.Tensor
    k3p: torch.Tensor
    ksi: torch.Tensor
    kw: torch.Tensor
    ks: torch.Tensor
    kf: torch.Tensor
    bt: torch.Tensor      # total borate
    st: torch.Tensor      # total sulfate
    ft: torch.Tensor      # total fluoride


def x0_seed_enabled() -> bool:
    """``OBGC_X0_SEED=1`` opts into seeding the solver iteration at the
    previous step's root instead of the reference's bracket midpoint
    (ocean_bgc_tpu/ops/carbonate.py::x0_seed_enabled): ~1 warm iteration
    instead of 2-3, the same root to solver tolerance but not the
    reference's iterate sequence, so not the bitwise contract path.  Read
    at every call (the port runs eagerly; the JAX package reads it when
    it traces)."""
    return os.environ.get("OBGC_X0_SEED", "0") == "1"


def solver_xacc(dtype: torch.dtype) -> float:
    """The solver tolerance in H (mol/kg): the reference's at f64, one
    representable at single precision otherwise (carbonate.py:450-455)."""
    return XACC if dtype == torch.float64 else XACC_F32


def press_bar_from_depth(depth_m):
    """POP reference pressure (bars) at depth (m) (co2calc.F90:156-157)."""
    return (0.059808 * (torch.exp(-0.025 * depth_m) - 1.0)
            + 0.100766 * depth_m + 2.28405e-7 * (depth_m * depth_m))


def _pressure_ln_factor(deltaV, kappa, press_bar, invRtk):
    """(-dV + 0.5*kappa*P) * P / (R*T): the log of the Millero pressure
    correction factor, folded into the corrected constant's exp()."""
    return (-deltaV + 0.5 * kappa * press_bar) * press_bar * invRtk


def carbonate_coeffs(depth_m, temp, salt, apply_pressure, *,
                     k1_k2_ph_tot=True) -> CarbCoeffs:
    """All thermodynamic constants at (T, S, depth).

    ``apply_pressure`` is the reference's ``k > 1`` gate (pressure
    corrections below the surface level, co2calc.F90:480-490): a Python
    bool or a bool tensor broadcastable against the inputs.
    ``k1_k2_ph_tot`` selects Lueker-2000 total-scale k1/k2 versus the
    legacy OCMIP2 seawater-scale fit (co2calc.F90:461-471).
    """
    press = press_bar_from_depth(depth_m)

    salt_lim = torch.clamp_min(salt, SALT_MIN)
    tk = T0_KELVIN + temp
    tk100 = tk * 1e-2
    tk1002 = tk100 * tk100
    invtk = 1.0 / tk
    dlogtk = torch.log(tk)
    invRtk = INV_R_GAS * invtk

    ionic = 19.924 * salt_lim / (1000.0 - 1.005 * salt_lim)
    ionic2 = ionic * ionic
    sqrtis = torch.sqrt(ionic)
    sqrts = torch.sqrt(salt_lim)
    s2 = salt_lim * salt_lim
    scl = salt_lim / 1.80655
    log_1_m_1p005em3_s = torch.log(1.0 - 0.001005 * salt_lim)

    def padd(deltaV, kappa):
        """Additive (log-space) pressure correction, exactly 0.0 at the
        surface."""
        ln_fac = _pressure_ln_factor(deltaV, kappa, press, invRtk)
        if isinstance(apply_pressure, bool):
            return ln_fac if apply_pressure else 0.0
        return torch.where(apply_pressure, ln_fac, 0.0)

    # ff — Weiss & Price 1980 (co2calc.F90:423-431)
    ff = torch.exp(-162.8301 + 218.2968 / tk100
                   + 90.9241 * (dlogtk + _LN_001) - 1.47696 * tk1002
                   + salt_lim * (0.025695 - 0.025225 * tk100
                                 + 0.0049867 * tk1002))

    # k0 — Weiss 1974 (co2calc.F90:437-444)
    k0 = torch.exp(93.4517 / tk100 - 60.2409
                   + 23.3585 * (dlogtk + _LN_001)
                   + salt_lim * (0.023517 - 0.023656 * tk100
                                 + 0.0047036 * tk1002))

    # k1, k2 — Lueker 2000 (total) or Millero 1995 (seawater)
    # (co2calc.F90:461-519); pressure corr Millero 1995 p.675
    if k1_k2_ph_tot:
        arg1 = (3633.86 * invtk - 61.2172 + 9.67770 * dlogtk
                - 0.011555 * salt_lim + 0.0001152 * s2)
        arg2 = (471.78 * invtk + 25.9290 - 3.16967 * dlogtk
                - 0.01781 * salt_lim + 0.0001122 * s2)
    else:
        arg1 = (3670.7 * invtk - 62.008 + 9.7944 * dlogtk
                - 0.0118 * salt_lim + 0.000116 * s2)
        arg2 = (1394.7 * invtk + 4.777 - 0.0184 * salt_lim + 0.000118 * s2)
    k1 = torch.exp(-_LN10 * arg1
                   + padd(-25.5 + 0.1271 * temp,
                          (-3.08 + 0.0877 * temp) * 1e-3))
    k2 = torch.exp(-_LN10 * arg2
                   + padd(-15.82 - 0.0219 * temp,
                          (1.13 - 0.1475 * temp) * 1e-3))

    # kb — Millero 1995 / Dickson 1990 (co2calc.F90:529-551)
    kb = torch.exp((-8966.90 - 2890.53 * sqrts - 77.942 * salt_lim
                    + 1.728 * salt_lim * sqrts - 0.0996 * s2) * invtk
                   + (148.0248 + 137.1942 * sqrts + 1.62142 * salt_lim)
                   + (-24.4344 - 25.085 * sqrts - 0.2474 * salt_lim) * dlogtk
                   + 0.053105 * sqrts * tk
                   + padd(-29.48 + (0.1622 - 0.002608 * temp) * temp,
                          -2.84e-3))

    # k1p — DOE 1994 eq 7.2.20 (co2calc.F90:560-580)
    k1p = torch.exp(-4576.752 * invtk + 115.525 - 18.453 * dlogtk
                    + (-106.736 * invtk + 0.69171) * sqrts
                    + (-0.65643 * invtk - 0.01844) * salt_lim
                    + padd(-14.51 + (0.1211 - 0.000321 * temp) * temp,
                           (-2.67 + 0.0427 * temp) * 1e-3))

    # k2p — DOE 1994 eq 7.2.23 (co2calc.F90:589-609)
    k2p = torch.exp(-8814.715 * invtk + 172.0883 - 27.927 * dlogtk
                    + (-160.340 * invtk + 1.3566) * sqrts
                    + (0.37335 * invtk - 0.05778) * salt_lim
                    + padd(-23.12 + (0.1758 - 0.002647 * temp) * temp,
                           (-5.15 + 0.09 * temp) * 1e-3))

    # k3p — DOE 1994 eq 7.2.26 (co2calc.F90:618-637)
    k3p = torch.exp(-3070.75 * invtk - 18.141
                    + (17.27039 * invtk + 2.81197) * sqrts
                    + (-44.99486 * invtk - 0.09984) * salt_lim
                    + padd(-26.57 + (0.202 - 0.003042 * temp) * temp,
                           (-4.08 + 0.0714 * temp) * 1e-3))

    # ksi — Millero 1995 / Yao & Millero (co2calc.F90:647-669);
    # pressure correction borrows the boric-acid values
    ksi = torch.exp(-8904.2 * invtk + 117.385 - 19.334 * dlogtk
                    + (-458.79 * invtk + 3.5913) * sqrtis
                    + (188.74 * invtk - 1.5998) * ionic
                    + (-12.1652 * invtk + 0.07871) * ionic2
                    + log_1_m_1p005em3_s
                    + padd(-29.48 + (0.1622 - 0.002608 * temp) * temp,
                           -2.84e-3))

    # kw — Millero 1995 composite (co2calc.F90:681-700)
    kw = torch.exp(-13847.26 * invtk + 148.9652 - 23.6521 * dlogtk
                   + (118.67 * invtk - 5.977 + 1.0495 * dlogtk) * sqrts
                   - 0.01615 * salt_lim
                   + padd(-20.02 + (0.1119 - 0.001409 * temp) * temp,
                          (-5.13 + 0.0794 * temp) * 1e-3))

    # ks — Dickson 1990, free scale (co2calc.F90:709-731)
    ks = torch.exp(-4276.1 * invtk + 141.328 - 23.093 * dlogtk
                   + (-13856.0 * invtk + 324.57 - 47.986 * dlogtk) * sqrtis
                   + (35474.0 * invtk - 771.54 + 114.723 * dlogtk) * ionic
                   - 2698.0 * invtk * ionic * sqrtis
                   + 1776.0 * invtk * ionic2
                   + log_1_m_1p005em3_s
                   + padd(-18.03 + (0.0466 + 0.000316 * temp) * temp,
                          (-4.53 + 0.09 * temp) * 1e-3))

    # kf — Dickson & Riley 1979, converted to total scale
    # (co2calc.F90:740-764); note dependence on ks computed above
    log_1_p_tot_sulfate_div_ks = torch.log(
        1.0 + (0.1400 / 96.062) * scl / ks)
    kf = torch.exp(1590.2 * invtk - 12.641 + 1.525 * sqrtis
                   + log_1_m_1p005em3_s + log_1_p_tot_sulfate_div_ks
                   + padd(-9.78 - (0.009 + 0.000942 * temp) * temp,
                          (-3.91 + 0.054 * temp) * 1e-3))

    # total borate (Uppstrom 1974), sulfate (Morris & Riley 1966),
    # fluoride (Riley 1965) (co2calc.F90:773-775)
    bt = 0.000232 / 10.811 * scl
    st = 0.14 / 96.062 * scl
    ft = 0.000067 / 18.9984 * scl

    return CarbCoeffs(k0=k0, k1=k1, k2=k2, ff=ff, kb=kb, k1p=k1p, k2p=k2p,
                      k3p=k3p, ksi=ksi, kw=kw, ks=ks, kf=kf,
                      bt=bt, st=st, ft=ft)


def talk(coeffs: CarbCoeffs, dic, ta, pt, sit, x):
    """Total alkalinity fn(H) and d(fn)/dH at htotal = x.

    The 12-term TA residual of the reference's ``talk_row``
    (co2calc.F90:1001-1092), by chemical species.  Every sum and product
    keeps the JAX package's association order (its docstring calls the
    order load-bearing for f64 trajectory parity), and the CUDA kernel
    repeats it term by term.  All concentrations in mol/kg.

    fn = hco3 + 2*co3 + borate + oh + hpo4 + 2*po4 + silicate
         - hfree - hso4 - hf - h3po4 - ta
    """
    h = x                               # total-scale [H+]
    inv_h = 1.0 / h
    h2 = h * h
    inv_h2 = inv_h * inv_h
    h3 = h2 * h
    k12 = coeffs.k1 * coeffs.k2         # carbonic K1*K2
    k12p = coeffs.k1p * coeffs.k2p      # phosphoric K1*K2
    k123p = k12p * coeffs.k3p           # phosphoric K1*K2*K3
    # phosphate speciation denominator h^3 + K1p h^2 + K1p K2p h + K1p K2p K3p
    phos_den = h3 + coeffs.k1p * h2 + k12p * h + k123p
    inv_phos_den = 1.0 / phos_den
    inv_phos_den2 = inv_phos_den * inv_phos_den
    dphos_den = 3.0 * h2 + 2.0 * coeffs.k1p * h + k12p
    # carbonate speciation denominator h^2 + K1 h + K1 K2
    carb_den = h2 + coeffs.k1 * h + k12
    inv_carb_den = 1.0 / carb_den
    inv_carb_den2 = inv_carb_den * inv_carb_den
    dcarb_den = 2.0 * h + coeffs.k1
    # total-to-free hydrogen scale conversion 1 + ST/KS
    htot_per_hfree = 1.0 + coeffs.st / coeffs.ks
    hfree_per_htot = 1.0 / htot_per_hfree
    inv_borate_den = 1.0 / (coeffs.kb + h)      # B(OH)4- denominator
    inv_sili_den = 1.0 / (coeffs.ksi + h)       # SiO(OH)3- denominator
    # HSO4- fraction of total sulfate: 1 / (1 + (1+ST/KS)*KS/H)
    hso4_frac = 1.0 / (1.0 + htot_per_hfree * coeffs.ks * inv_h)
    hf_frac = 1.0 / (1.0 + coeffs.kf * inv_h)   # HF fraction of fluoride

    fn = (coeffs.k1 * dic * h * inv_carb_den            # HCO3-
          + 2.0 * dic * k12 * inv_carb_den              # 2 CO3=
          + coeffs.bt * coeffs.kb * inv_borate_den      # B(OH)4-
          + coeffs.kw * inv_h                           # OH-
          + pt * k12p * h * inv_phos_den                # HPO4=
          + 2.0 * pt * k123p * inv_phos_den             # 2 PO4---
          + sit * coeffs.ksi * inv_sili_den             # SiO(OH)3-
          - h * hfree_per_htot                          # - free H+
          - coeffs.st * hso4_frac                       # - HSO4-
          - coeffs.ft * hf_frac                         # - HF
          - pt * h3 * inv_phos_den                      # - H3PO4
          - ta)

    df = (coeffs.k1 * dic * (carb_den - h * dcarb_den) * inv_carb_den2
          - 2.0 * dic * k12 * dcarb_den * inv_carb_den2
          - coeffs.bt * coeffs.kb * inv_borate_den * inv_borate_den
          - coeffs.kw * inv_h2
          + (pt * k12p * (phos_den - h * dphos_den)) * inv_phos_den2
          - 2.0 * pt * k123p * dphos_den * inv_phos_den2
          - sit * coeffs.ksi * inv_sili_den * inv_sili_den
          - 1.0 * hfree_per_htot
          - coeffs.st * hso4_frac * hso4_frac
            * (htot_per_hfree * coeffs.ks * inv_h2)
          - coeffs.ft * hf_frac * hf_frac * coeffs.kf * inv_h2
          - pt * h2 * (3.0 * phos_den - h * dphos_den) * inv_phos_den2)

    return fn, df


def _solve_htotal_impl(coeffs: CarbCoeffs, dic, ta, pt, sit, x1, x2,
                       with_stats=False, x0=None):
    """Lane-parallel bracketed safe-Newton root-find for htotal
    (drtsafe_row, co2calc.F90:872-997), with per-lane freezing.

    Bracket phase: evaluate both endpoints, grow every lane that does not
    straddle the root geometrically (at most 60 times), then orient so
    that f(xlo) < 0 (co2calc.F90:920-949).  Iteration: at most MAXIT
    Newton-or-bisection steps per lane; a lane freezes once its step is
    below :func:`solver_xacc` or stalls (co2calc.F90:951-991).  The loops end when
    no lane is left to grow or iterate (one ``any()`` per trip, which
    synchronises with the host on a CUDA tensor).

    ``with_stats``: also return per-lane counts, as a dict with
    ``iters`` (Newton/bisection steps), ``grows`` (bracket growth steps)
    and ``converged`` (bool) — for measuring work and monitoring.

    ``x0``: the opt-in iteration seed (:func:`x0_seed_enabled`), the
    previous root per lane (0 = none): a lane with ``x0 > 0`` starts at
    ``x0`` clamped into its oriented (possibly grown) bracket instead of
    the bracket midpoint (JAX carbonate.py:531-547); the bracket phase
    and ``dxold`` are those of the unseeded solve.
    """
    shape = torch.broadcast_shapes(x1.shape, x2.shape)
    x1 = x1.expand(shape)
    x2 = x2.expand(shape)
    xacc = solver_xacc(x1.dtype)

    def f_of(x):
        return talk(coeffs, dic, ta, pt, sit, x)

    def not_bracketed(flo, fhi):
        return ((flo > 0.0) & (fhi > 0.0)) | ((flo < 0.0) & (fhi < 0.0))

    flo, _ = f_of(x1)
    fhi, _ = f_of(x2)
    grows = torch.zeros(flo.shape, dtype=torch.int32, device=flo.device)
    for _ in range(_BRACKET_GROW_GUARD):
        m = not_bracketed(flo, fhi)
        if not bool(readback(m.any())):
            break
        growth = torch.sqrt(x2 / x1)
        x1 = torch.where(m, x1 / growth, x1)
        x2 = torch.where(m, x2 * growth, x2)
        flo_n, _ = f_of(x1)
        fhi_n, _ = f_of(x2)
        flo = torch.where(m, flo_n, flo)
        fhi = torch.where(m, fhi_n, fhi)
        grows += m
    neg_at_x1 = flo < 0.0
    xlo = torch.where(neg_at_x1, x1, x2)
    xhi = torch.where(neg_at_x1, x2, x1)

    soln = 0.5 * (xlo + xhi)
    if x0 is not None:
        x0 = x0.expand(shape)
        soln = torch.where(x0 > 0.0, torch.clamp(x0, torch.minimum(xlo, xhi),
                                                 torch.maximum(xlo, xhi)),
                           soln)
    dxold = torch.abs(xlo - xhi)
    dx = dxold
    f, df = f_of(soln)
    active = torch.ones(soln.shape, dtype=torch.bool, device=soln.device)
    iters = torch.zeros_like(grows)
    for _ in range(MAXIT):
        if not bool(readback(active.any())):
            break
        # bisect when Newton would leave the bracket or converges too
        # slowly (co2calc.F90:962-976)
        leave_bracket = (((soln - xhi) * df - f)
                         * ((soln - xlo) * df - f)) >= 0.0
        dx_decrease = torch.abs(2.0 * f) <= torch.abs(dxold * df)
        bisect = leave_bracket | (~dx_decrease)

        dxold_n = dx
        dx_bis = 0.5 * (xhi - xlo)
        dx_newt = -f / df
        dx_n = torch.where(bisect, dx_bis, dx_newt)
        soln_n = torch.where(bisect, xlo + dx_bis, soln + dx_newt)
        stalled = ((bisect & (xlo == soln_n))
                   | (~bisect & (soln == soln_n)))
        converged = stalled | (torch.abs(dx_n) < xacc)

        soln = torch.where(active, soln_n, soln)
        dx = torch.where(active, dx_n, dx)
        dxold = torch.where(active, dxold_n, dxold)
        iters += active
        active = active & (~converged)

        f_n, df_n = f_of(soln)
        f = torch.where(active, f_n, f)
        df = torch.where(active, df_n, df)
        # re-bracket (co2calc.F90:983-989)
        xlo = torch.where((f_n < 0.0) & active, soln, xlo)
        xhi = torch.where((f_n >= 0.0) & active, soln, xhi)
    if with_stats:
        return soln, {"iters": iters, "grows": grows, "converged": ~active}
    return soln


def implicit_vjp(g, h, coeffs: CarbCoeffs, dic, ta, pt, sit, needs):
    """The gradient of a loss with respect to (dic, ta, pt, sit, *coeffs)
    through a root h of ``talk(coeffs, dic, ta, pt, sit, h) = 0``, given
    the loss's gradient ``g`` with respect to h, by the implicit function
    theorem (JAX ``_solve_htotal_bwd``, ocean_bgc_tpu/ops/carbonate.py:
    611-634): with ``lam = -g / f_h`` at the root, the VJP of the
    residual with respect to the inputs, from one residual evaluation.
    ``needs`` flags which of the 19 inputs want a gradient; the others
    get None.

    ``lam`` is 0 wherever ``g`` is, so a lane whose root the caller
    discards (an inactive cell, whose residual slope may be 0 or not
    finite) adds no NaN to the inputs' gradients."""
    inputs = (dic, ta, pt, sit, *coeffs)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(n))
                  for t, n in zip(inputs, needs)]
        fn, f_h = talk(CarbCoeffs(*leaves[4:]), *leaves[:4], h.detach())
        lam = torch.where(g == 0.0, 0.0, -g / f_h.detach())
        wanted = [t for t, n in zip(leaves, needs) if n]
        got = iter(torch.autograd.grad(fn, wanted, lam, allow_unused=True)
                   if wanted else ())
    return tuple(next(got) if n else None for n in needs)


class _ImplicitRoot(torch.autograd.Function):
    """The root h of the alkalinity residual from a given solver, with
    the implicit-function backward: the solver (the plain iteration or a
    kernel) runs unrecorded, and the brackets and the seed it closes
    over take no gradient (the root does not depend on them)."""

    @staticmethod
    def forward(ctx, solver, dic, ta, pt, sit, *coeffs):
        h = solver()
        ctx.save_for_backward(h, dic, ta, pt, sit, *coeffs)
        return h

    @staticmethod
    def backward(ctx, g):
        h, dic, ta, pt, sit, *coeffs = ctx.saved_tensors
        return (None, *implicit_vjp(g, h, CarbCoeffs(*coeffs), dic, ta, pt,
                                    sit, ctx.needs_input_grad[1:]))


def implicit_root(solver, coeffs: CarbCoeffs, dic, ta, pt, sit):
    """``solver()``, the root H of ``talk(coeffs, dic, ta, pt, sit, H) =
    0``, as a function of those inputs for autograd (the implicit-function
    backward of :func:`implicit_vjp`)."""
    return _ImplicitRoot.apply(solver, dic, ta, pt, sit, *coeffs)


def solve_htotal(coeffs: CarbCoeffs, dic, ta, pt, sit, x1, x2, x0=None):
    """:func:`_solve_htotal_impl` (its ``x0`` seed included) as a function
    of (coeffs, dic, ta, pt, sit) for autograd, with the JAX package's
    implicit-function backward (``solve_htotal``/``solve_htotal_warm``,
    ocean_bgc_tpu/ops/carbonate.py:416-434, :611-676) in place of a
    derivative through every iteration: the forward is the plain solve,
    unrecorded."""
    return implicit_root(
        lambda: _solve_htotal_impl(coeffs, dic, ta, pt, sit, x1, x2, x0=x0),
        coeffs, dic, ta, pt, sit)


def _to_mass_units(dic_in, ta_in, pt_in, sit_in):
    """Floor tracers and convert (mmol/m^3) -> (mol/kg) (comp_htotal,
    co2calc.F90:843-846)."""
    dic = torch.clamp_min(dic_in, DIC_MIN) * VOL_TO_MASS
    ta = torch.clamp_min(ta_in, ALK_MIN) * VOL_TO_MASS
    pt = torch.clamp_min(pt_in, 0.0) * VOL_TO_MASS
    sit = torch.clamp_min(sit_in, 0.0) * VOL_TO_MASS
    return dic, ta, pt, sit


def solve_htotal_stats(coeffs: CarbCoeffs, dic, ta, pt, sit, x1, x2,
                       x0=None, *, impl="auto"):
    """The instrumented solve (JAX ``solve_htotal_stats``, ocean_bgc_tpu/
    ops/carbonate.py:437-444): ``(htotal, iters, converged)``, with the
    Newton-or-bisection steps each lane took (int32, the step that
    converges counted) and whether it converged or stalled before MAXIT
    (bool) — the convergence observability the reference silently drops
    (co2calc.F90:993-995).  ``x0``: the iteration seed (0 = none), as
    :func:`_solve_htotal_impl` takes it.  The arguments broadcast against
    each other.  ``impl`` as :func:`co2calc_surface_dual` takes it: on
    CUDA tensors one launch of K1's bracket-in instance's statistics
    variant (``ops/cuda_carbonate.py::solve_htotal_brackets``, counted in
    ``k1.brackets_stats``), on CPU tensors the plain
    :func:`_solve_htotal_impl`.  Not differentiable: inputs that require
    grad raise."""
    from ocean_bgc_tpu_torch.ops.cuda_carbonate import solve_htotal_brackets
    coeffs, dic, ta, pt, sit, x1, x2, x0 = _as_lanes(
        coeffs, dic, ta, pt, sit, x1, x2, x0)
    return solve_htotal_brackets(coeffs, dic, ta, pt, sit, x1, x2, seed=x0,
                                 impl=impl, with_stats=True)


def _as_lanes(coeffs: CarbCoeffs, dic, *fields):
    """``coeffs``, ``dic`` and ``fields`` (tensors, numbers, or None,
    kept) broadcast to one shape, contiguous, numbers as tensors of
    ``dic``'s type and device: one lane per element, every field read
    per lane, the layout K1's bracket-in instance takes (its shared
    fields as many as its lanes)."""
    def tensor(x):
        return (x if isinstance(x, torch.Tensor) or x is None
                else torch.as_tensor(x, dtype=dic.dtype, device=dic.device))
    fields = [tensor(x) for x in fields]
    given = [*coeffs, dic, *(x for x in fields if x is not None)]
    shape = torch.broadcast_shapes(*(t.shape for t in given))

    def lanes(t):
        return None if t is None else t.expand(shape).contiguous()
    return (CarbCoeffs(*map(lanes, coeffs)), lanes(dic),
            *map(lanes, fields))


def comp_htotal(coeffs: CarbCoeffs, dic_in, ta_in, pt_in, sit_in, phlo,
                phhi, *, impl="auto"):
    """Solve for H+ from (DIC, TA) with a pH bracket [phlo, phhi]
    (comp_htotal, co2calc.F90:781-868; JAX ``comp_htotal``): the tracers
    floored and in mol/kg, the H-space bracket ``10**-phhi``,
    ``10**-phlo``, one lane per cell.  ``impl`` as
    :func:`co2calc_surface_dual` takes it (on CUDA tensors one launch of
    K1's bracket-in instance); differentiable through the solve's
    implicit-function rule.  Returns ``(htotal, dic)``, both in mol/kg."""
    from ocean_bgc_tpu_torch.ops.cuda_carbonate import solve_htotal_brackets
    dic = _to_mass_units(dic_in, ta_in, pt_in, sit_in)[0]
    lanes = htotal_lanes(coeffs, dic_in, ta_in, pt_in, sit_in, phlo, phhi)
    return solve_htotal_brackets(*lanes, impl=impl), dic


def htotal_lanes(coeffs: CarbCoeffs, dic_in, ta_in, pt_in, sit_in, phlo,
                 phhi):
    """:func:`comp_htotal`'s solver arguments, ``(coeffs, dic, ta, pt,
    sit, x1, x2)`` in mol/kg, one lane per cell (``solve_htotal_brackets``'s
    layout)."""
    dic, ta, pt, sit = _to_mass_units(dic_in, ta_in, pt_in, sit_in)
    x1, x2 = (torch.pow(10.0, -torch.as_tensor(ph, dtype=dic.dtype,
                                               device=dic.device))
              for ph in (phhi, phlo))
    return _as_lanes(coeffs, dic, ta, pt, sit, x1, x2)


def co3_terms(depth_m, temp, salt, dic_in, ta_in, pt_in, sit_in, phlo,
              phhi, apply_pressure, *, impl="auto"):
    """Carbonate speciation H2CO3/HCO3/CO3 and pH (comp_CO3terms,
    co2calc.F90:214-316; JAX ``co3_terms``): the Lueker constants, with
    pressure corrections where ``apply_pressure`` (a bool or a bool
    tensor), and :func:`comp_htotal`'s root.  Returns ``(ph, h2co3,
    hco3, co3)``, the concentrations in mmol/m^3."""
    coeffs = carbonate_coeffs(depth_m, temp, salt, apply_pressure,
                              k1_k2_ph_tot=True)
    htotal, dic = comp_htotal(coeffs, dic_in, ta_in, pt_in, sit_in, phlo,
                              phhi, impl=impl)
    htotal2 = htotal * htotal
    denom = 1.0 / (htotal2 + coeffs.k1 * htotal + coeffs.k1 * coeffs.k2)
    h2co3 = dic * htotal2 * denom * MASS_TO_VOL
    hco3 = dic * coeffs.k1 * htotal * denom * MASS_TO_VOL
    co3 = dic * coeffs.k1 * coeffs.k2 * denom * MASS_TO_VOL
    return -torch.log10(htotal), h2co3, hco3, co3


def warm_brackets_h(ph_prev, lo_init, hi_init, del_ph, with_seed=False):
    """H-space solver brackets: ph_prev -/+ del_ph where ph_prev != 0
    (BGC_mod.F90:943-956), with one pow per cell; lanes with the 0
    sentinel take the wide bracket [10**-hi_init, 10**-lo_init].
    ``with_seed``: also return the previous root itself, the iteration
    seed (0 on cold lanes), as a third element."""
    warm = ph_prev != 0.0
    h_prev = torch.pow(10.0, -torch.where(warm, ph_prev, 8.0))
    x1 = torch.where(warm, h_prev * (10.0 ** -del_ph), 10.0 ** -hi_init)
    x2 = torch.where(warm, h_prev * (10.0 ** del_ph), 10.0 ** -lo_init)
    if with_seed:
        return x1, x2, torch.where(warm, h_prev, 0.0)
    return x1, x2


def co2calc_surface_dual(depth_m, temp, salt, dic_a, dic_b, ta_in, pt_in,
                         sit_in, phlo_a, phhi_a, phlo_b, phhi_b,
                         xco2_a, xco2_b, atmpres, *,
                         locmip_k1_k2_bug_fix=True, brackets_a=None,
                         brackets_b=None, impl="auto"):
    """The surface ambient + ALT_CO2 pair (BGC_mod.F90:2881-2912): shared
    coefficients, DIC/xCO2/bracket differing per scenario, one stacked
    solve.  ``brackets_a``/``brackets_b`` give H-space ``(x1, x2)``
    directly (:func:`warm_brackets_h`), and the phlo/phhi arguments are
    then ignored; ``(x1, x2, x0)`` (``with_seed=True``) also seeds the
    iteration at ``x0`` (:func:`x0_seed_enabled`).  ``impl`` picks the solve as
    ``ops/cuda_carbonate.py::solve_htotal_brackets`` does: its kernel on
    CUDA tensors ("auto", "kernel") or :func:`_solve_htotal_impl`
    ("torch", or CPU tensors); the two scenarios' lanes read the shared
    coefficients and tracers in place.  Returns two (ph, co2star,
    dco2star, pco2surf, dpco2) tuples, co2star terms in mmol/m^3 and pCO2
    in ppmv."""
    # the kernel's wrapper imports this module
    from ocean_bgc_tpu_torch.ops.cuda_carbonate import solve_htotal_brackets
    coeffs = carbonate_coeffs(depth_m, temp, salt, False,
                              k1_k2_ph_tot=locmip_k1_k2_bug_fix)
    da, ta, pt, sit = _to_mass_units(dic_a, ta_in, pt_in, sit_in)
    db, _, _, _ = _to_mass_units(dic_b, ta_in, pt_in, sit_in)

    dic = torch.stack([da, db])
    shp = da.shape
    if brackets_a is None:
        brackets_a = (torch.pow(10.0, -phhi_a), torch.pow(10.0, -phlo_a))
        brackets_b = (torch.pow(10.0, -phhi_b), torch.pow(10.0, -phlo_b))
    x1 = torch.stack([brackets_a[0].expand(shp), brackets_b[0].expand(shp)])
    x2 = torch.stack([brackets_a[1].expand(shp), brackets_b[1].expand(shp)])
    seed = None
    if len(brackets_a) == 3:
        seed = torch.stack([brackets_a[2].expand(shp),
                            brackets_b[2].expand(shp)])
    htotal = solve_htotal_brackets(coeffs, dic, ta, pt, sit, x1, x2,
                                   seed=seed, impl=impl)

    xco2 = torch.stack([xco2_a.expand(shp), xco2_b.expand(shp)]) * 1e-6
    htotal2 = htotal * htotal
    co2star = dic * htotal2 / (htotal2 + coeffs.k1 * htotal
                               + coeffs.k1 * coeffs.k2)
    dco2star = xco2 * coeffs.ff * atmpres - co2star
    pco2surf = co2star / coeffs.ff
    dpco2 = pco2surf - xco2 * atmpres
    ph = -torch.log10(htotal)

    def pick(i):
        return (ph[i], co2star[i] * MASS_TO_VOL,
                dco2star[i] * MASS_TO_VOL, pco2surf[i] * 1e6,
                dpco2[i] * 1e6)

    return pick(0), pick(1)


def co2calc_surface(depth_m, temp, salt, dic_in, ta_in, pt_in, sit_in,
                    phlo, phhi, xco2_in, atmpres, *,
                    locmip_k1_k2_bug_fix=True, impl="auto"):
    """Surface CO2*, delta-CO2* and pCO2 of one scenario (co2calc_1point,
    co2calc.F90:75-210; JAX ``co2calc_surface``): the surface level, no
    pressure corrections; ``locmip_k1_k2_bug_fix`` picks the Lueker
    total-scale k1/k2 over the OCMIP2 fit; the root of
    :func:`comp_htotal` (``impl`` as it takes it).  Returns ``(ph,
    co2star, dco2star, pco2surf, dpco2)``, the co2star terms in mmol/m^3
    and pCO2 in ppmv."""
    coeffs = carbonate_coeffs(depth_m, temp, salt, False,
                              k1_k2_ph_tot=locmip_k1_k2_bug_fix)
    htotal, dic = comp_htotal(coeffs, dic_in, ta_in, pt_in, sit_in, phlo,
                              phhi, impl=impl)
    xco2 = xco2_in * 1e-6
    htotal2 = htotal * htotal
    co2star = dic * htotal2 / (htotal2 + coeffs.k1 * htotal
                               + coeffs.k1 * coeffs.k2)
    dco2star = xco2 * coeffs.ff * atmpres - co2star
    pco2surf = co2star / coeffs.ff
    dpco2 = pco2surf - xco2 * atmpres
    return (-torch.log10(htotal), co2star * MASS_TO_VOL,
            dco2star * MASS_TO_VOL, pco2surf * 1e6, dpco2 * 1e6)


def co3_sat_vals(depth_m, temp, salt, apply_pressure):
    """CO3= concentration at calcite and aragonite saturation
    (comp_co3_sat_vals, co2calc.F90:1096-1238); Mucci 1983 solubilities
    with Millero 1979 pressure corrections.  Returns mmol/m^3."""
    press = press_bar_from_depth(depth_m)

    salt_lim = torch.clamp_min(salt, SALT_MIN)
    tk = T0_KELVIN + temp
    log10tk = torch.log(tk) / _LN10
    invtk = 1.0 / tk
    invRtk = INV_R_GAS * invtk
    sqrts = torch.sqrt(salt_lim)
    s15 = sqrts * salt_lim

    def gate(ln_fac):
        if isinstance(apply_pressure, bool):
            return ln_fac if apply_pressure else 0.0
        return torch.where(apply_pressure, ln_fac, 0.0)

    deltaV_calc = -48.76 + 0.5304 * temp
    kappa = (-11.76 + 0.3692 * temp) * 1e-3
    ln_fac_calc = _pressure_ln_factor(deltaV_calc, kappa, press, invRtk)
    k_calc = torch.exp(_LN10 * (
        -171.9065 - 0.077993 * tk + 2839.319 * invtk + 71.595 * log10tk
        + (-0.77712 + 0.0028426 * tk + 178.34 * invtk) * sqrts
        - 0.07711 * salt_lim + 0.0041249 * s15)
        + gate(ln_fac_calc))

    # the reference reuses the calcite correction with deltaV shifted by
    # +2.8 and the same kappa (co2calc.F90:1212-1221)
    ln_fac_arag = _pressure_ln_factor(deltaV_calc + 2.8, kappa, press,
                                      invRtk)
    k_arag = torch.exp(_LN10 * (
        -171.945 - 0.077993 * tk + 2903.293 * invtk + 71.595 * log10tk
        + (-0.068393 + 0.0017276 * tk + 88.135 * invtk) * sqrts
        - 0.10018 * salt_lim + 0.0059415 * s15)
        + gate(ln_fac_arag))

    inv_ca = (35.0 / 0.01028) / salt_lim
    co3_sat_calc = k_calc * inv_ca * MASS_TO_VOL
    co3_sat_arag = k_arag * inv_ca * MASS_TO_VOL
    return co3_sat_calc, co3_sat_arag
