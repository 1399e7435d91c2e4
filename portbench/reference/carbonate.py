"""Scalar carbonate chemistry of the benchmark's plain reference.

Equilibrium-constant fits are taken from the same literature the model
family uses (Weiss 1974/1980, Lueker et al. 2000, Millero 1995, Dickson
1990, DOE 1994, Mucci 1983) with Millero pressure corrections.  Total
alkalinity is written from first principles (explicit species
concentrations) with its slope in H.  The pH root-find is the model's
own iteration as co2calc.F90 (drtsafe, :872-997) states it: grow the
bracket until it straddles the root, then safe Newton (bisection where
Newton would leave the bracket or converge too slowly) until a step is
below ``XACC`` (1e-10 mol/kg) or stalls, at most ``MAXIT`` steps.  The
model's answer is the root to that tolerance, not the exact root: the
two differ by up to ~6e-5 in pH.  One cell at a time.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

T0K = 273.15
RHO_SW = 1.026
MASS_TO_VOL = 1e6 * RHO_SW
SALT_MIN = 0.1
DIC_MIN = SALT_MIN / 35.0 * 1944.0
ALK_MIN = SALT_MIN / 35.0 * 2225.0
RGAS = 83.1451
LN10 = math.log(10.0)
XACC = 1e-10          # co2calc.F90's step tolerance in H (mol/kg)
MAXIT = 100           # its iteration cap
GROW_GUARD = 60       # bracket growths before giving up on straddling


def press_bar(depth_m: float) -> float:
    return (0.059808 * (math.exp(-0.025 * depth_m) - 1.0)
            + 0.100766 * depth_m + 2.28405e-7 * depth_m ** 2)


@dataclass
class Ks:
    k0: float
    k1: float
    k2: float
    ff: float
    kb: float
    k1p: float
    k2p: float
    k3p: float
    ksi: float
    kw: float
    ks: float
    kf: float
    bt: float
    st: float
    ft: float


def _pfac(dV: float, kap: float, pb: float, tk: float) -> float:
    return math.exp((-dV + 0.5 * kap * pb) * pb / (RGAS * tk))


def equilibrium_constants(depth_m: float, temp: float, salt: float,
                          subsurface: bool, total_scale_k1k2: bool = True) -> Ks:
    s = max(salt, SALT_MIN)
    tk = T0K + temp
    pb = press_bar(depth_m)
    lntk = math.log(tk)
    tk100 = tk / 100.0
    ist = 19.924 * s / (1000.0 - 1.005 * s)
    scl = s / 1.80655
    lg = math.log(1.0 - 0.001005 * s)

    ff = math.exp(-162.8301 + 218.2968 / tk100
                  + 90.9241 * math.log(tk100) - 1.47696 * tk100 ** 2
                  + s * (0.025695 - 0.025225 * tk100
                         + 0.0049867 * tk100 ** 2))
    k0 = math.exp(93.4517 / tk100 - 60.2409 + 23.3585 * math.log(tk100)
                  + s * (0.023517 - 0.023656 * tk100
                         + 0.0047036 * tk100 ** 2))

    if total_scale_k1k2:
        pk1 = (3633.86 / tk - 61.2172 + 9.67770 * lntk
               - 0.011555 * s + 0.0001152 * s * s)
        pk2 = (471.78 / tk + 25.9290 - 3.16967 * lntk
               - 0.01781 * s + 0.0001122 * s * s)
    else:
        pk1 = 3670.7 / tk - 62.008 + 9.7944 * lntk - 0.0118 * s + 0.000116 * s * s
        pk2 = 1394.7 / tk + 4.777 - 0.0184 * s + 0.000118 * s * s
    k1 = 10.0 ** (-pk1)
    k2 = 10.0 ** (-pk2)

    kb = math.exp((-8966.90 - 2890.53 * math.sqrt(s) - 77.942 * s
                   + 1.728 * s * math.sqrt(s) - 0.0996 * s * s) / tk
                  + 148.0248 + 137.1942 * math.sqrt(s) + 1.62142 * s
                  + (-24.4344 - 25.085 * math.sqrt(s) - 0.2474 * s) * lntk
                  + 0.053105 * math.sqrt(s) * tk)
    k1p = math.exp(-4576.752 / tk + 115.525 - 18.453 * lntk
                   + (-106.736 / tk + 0.69171) * math.sqrt(s)
                   + (-0.65643 / tk - 0.01844) * s)
    k2p = math.exp(-8814.715 / tk + 172.0883 - 27.927 * lntk
                   + (-160.340 / tk + 1.3566) * math.sqrt(s)
                   + (0.37335 / tk - 0.05778) * s)
    k3p = math.exp(-3070.75 / tk - 18.141
                   + (17.27039 / tk + 2.81197) * math.sqrt(s)
                   + (-44.99486 / tk - 0.09984) * s)
    ksi = math.exp(-8904.2 / tk + 117.385 - 19.334 * lntk
                   + (-458.79 / tk + 3.5913) * math.sqrt(ist)
                   + (188.74 / tk - 1.5998) * ist
                   + (-12.1652 / tk + 0.07871) * ist * ist + lg)
    kw = math.exp(-13847.26 / tk + 148.9652 - 23.6521 * lntk
                  + (118.67 / tk - 5.977 + 1.0495 * lntk) * math.sqrt(s)
                  - 0.01615 * s)
    ks = math.exp(-4276.1 / tk + 141.328 - 23.093 * lntk
                  + (-13856.0 / tk + 324.57 - 47.986 * lntk) * math.sqrt(ist)
                  + (35474.0 / tk - 771.54 + 114.723 * lntk) * ist
                  - 2698.0 / tk * ist ** 1.5 + 1776.0 / tk * ist * ist + lg)

    if subsurface:
        k1 *= _pfac(-25.5 + 0.1271 * temp, (-3.08 + 0.0877 * temp) * 1e-3, pb, tk)
        k2 *= _pfac(-15.82 - 0.0219 * temp, (1.13 - 0.1475 * temp) * 1e-3, pb, tk)
        kb *= _pfac(-29.48 + (0.1622 - 0.002608 * temp) * temp, -2.84e-3, pb, tk)
        k1p *= _pfac(-14.51 + (0.1211 - 0.000321 * temp) * temp,
                     (-2.67 + 0.0427 * temp) * 1e-3, pb, tk)
        k2p *= _pfac(-23.12 + (0.1758 - 0.002647 * temp) * temp,
                     (-5.15 + 0.09 * temp) * 1e-3, pb, tk)
        k3p *= _pfac(-26.57 + (0.202 - 0.003042 * temp) * temp,
                     (-4.08 + 0.0714 * temp) * 1e-3, pb, tk)
        ksi *= _pfac(-29.48 + (0.1622 - 0.002608 * temp) * temp, -2.84e-3, pb, tk)
        kw *= _pfac(-20.02 + (0.1119 - 0.001409 * temp) * temp,
                    (-5.13 + 0.0794 * temp) * 1e-3, pb, tk)
        ks *= _pfac(-18.03 + (0.0466 + 0.000316 * temp) * temp,
                    (-4.53 + 0.09 * temp) * 1e-3, pb, tk)

    # kf depends on the (possibly pressure-corrected? no — reference computes
    # kf from the *corrected* ks only via scl/ks inside log, but reads ks(1)
    # AFTER its pressure correction block) — order: ks is corrected first,
    # then kf formula uses corrected ks, then kf gets its own correction.
    kf = math.exp(1590.2 / tk - 12.641 + 1.525 * math.sqrt(ist) + lg
                  + math.log(1.0 + (0.1400 / 96.062) * scl / ks))
    if subsurface:
        kf *= _pfac(-9.78 - (0.009 + 0.000942 * temp) * temp,
                    (-3.91 + 0.054 * temp) * 1e-3, pb, tk)

    bt = 0.000232 / 10.811 * scl
    st = 0.14 / 96.062 * scl
    ft = 0.000067 / 18.9984 * scl
    return Ks(k0, k1, k2, ff, kb, k1p, k2p, k3p, ksi, kw, ks, kf, bt, st, ft)


def total_alkalinity(H: float, K: Ks, dic: float, pt: float,
                     sit: float):
    """TA from explicit species concentrations (mol/kg) at total-scale H,
    and its slope d(TA)/dH."""
    cden = H * H + K.k1 * H + K.k1 * K.k2
    dcden = 2.0 * H + K.k1
    hco3 = dic * K.k1 * H / cden
    d_hco3 = dic * K.k1 * (K.k1 * K.k2 - H * H) / (cden * cden)
    co3 = dic * K.k1 * K.k2 / cden
    d_co3 = -dic * K.k1 * K.k2 * dcden / (cden * cden)
    borate = K.bt * K.kb / (K.kb + H)
    d_borate = -K.bt * K.kb / ((K.kb + H) * (K.kb + H))
    oh = K.kw / H
    d_oh = -K.kw / (H * H)
    pden = H ** 3 + K.k1p * H ** 2 + K.k1p * K.k2p * H + K.k1p * K.k2p * K.k3p
    dpden = 3.0 * H * H + 2.0 * K.k1p * H + K.k1p * K.k2p
    pden2 = pden * pden
    h3po4 = pt * H ** 3 / pden
    d_h3po4 = pt * H * H * (3.0 * pden - H * dpden) / pden2
    hpo4 = pt * K.k1p * K.k2p * H / pden
    d_hpo4 = pt * K.k1p * K.k2p * (pden - H * dpden) / pden2
    po4 = pt * K.k1p * K.k2p * K.k3p / pden
    d_po4 = -pt * K.k1p * K.k2p * K.k3p * dpden / pden2
    sioh3 = sit * K.ksi / (K.ksi + H)
    d_sioh3 = -sit * K.ksi / ((K.ksi + H) * (K.ksi + H))
    free_per_tot = 1.0 / (1.0 + K.st / K.ks)
    hfree = H * free_per_tot
    hso4 = K.st * hfree / (K.ks + hfree)
    d_hso4 = K.st * K.ks * free_per_tot / ((K.ks + hfree) * (K.ks + hfree))
    hf = K.ft * H / (K.kf + H)
    d_hf = K.ft * K.kf / ((K.kf + H) * (K.kf + H))
    ta = (hco3 + 2.0 * co3 + borate + oh + hpo4 + 2.0 * po4 + sioh3
          - hfree - hso4 - hf - h3po4)
    dta = (d_hco3 + 2.0 * d_co3 + d_borate + d_oh + d_hpo4 + 2.0 * d_po4
           + d_sioh3 - free_per_tot - d_hso4 - d_hf - d_h3po4)
    return ta, dta


def drtsafe(fdf, x1: float, x2: float, xacc: float = XACC) -> float:
    """co2calc.F90's bracketed safe-Newton root of ``fdf(x) -> (f, f')``
    from the bracket (x1, x2)."""
    flo, fhi = fdf(x1)[0], fdf(x2)[0]
    for _ in range(GROW_GUARD):
        if not ((flo > 0.0 and fhi > 0.0) or (flo < 0.0 and fhi < 0.0)):
            break
        g = math.sqrt(x2 / x1)
        x1, x2 = x1 / g, x2 * g
        flo, fhi = fdf(x1)[0], fdf(x2)[0]
    xlo, xhi = (x1, x2) if flo < 0.0 else (x2, x1)
    soln = 0.5 * (xlo + xhi)
    dxold = abs(xlo - xhi)
    dx = dxold
    f, df = fdf(soln)
    for _ in range(MAXIT):
        bisect = (((soln - xhi) * df - f) * ((soln - xlo) * df - f) >= 0.0
                  or abs(2.0 * f) > abs(dxold * df))
        dxold = dx
        if bisect:
            dx = 0.5 * (xhi - xlo)
            new = xlo + dx
            stalled = xlo == new
        else:
            dx = -f / df
            new = soln + dx
            stalled = soln == new
        soln = new
        if stalled or abs(dx) < xacc:
            break
        f, df = fdf(soln)
        if f < 0.0:
            xlo = soln
        else:
            xhi = soln
    return soln


def solve_h(K: Ks, dic_in: float, ta_in: float, pt_in: float, sit_in: float,
            phlo: float, phhi: float, xacc: float = XACC) -> float:
    """The pH solve with the model's unit floors, from the pH window
    (phlo, phhi)."""
    v2m = 1.0 / MASS_TO_VOL
    dic = max(dic_in, DIC_MIN) * v2m
    ta = max(ta_in, ALK_MIN) * v2m
    pt = max(pt_in, 0.0) * v2m
    sit = max(sit_in, 0.0) * v2m

    def fdf(H):
        t, dt = total_alkalinity(H, K, dic, pt, sit)
        return t - ta, dt

    return drtsafe(fdf, 10.0 ** (-phhi), 10.0 ** (-phlo), xacc)


def co3_terms(depth_m, temp, salt, dic_in, ta_in, pt_in, sit_in, phlo, phhi,
              subsurface):
    K = equilibrium_constants(depth_m, temp, salt, subsurface, True)
    H = solve_h(K, dic_in, ta_in, pt_in, sit_in, phlo, phhi)
    dic = max(dic_in, DIC_MIN) / MASS_TO_VOL
    den = H * H + K.k1 * H + K.k1 * K.k2
    h2co3 = dic * H * H / den * MASS_TO_VOL
    hco3 = dic * K.k1 * H / den * MASS_TO_VOL
    co3 = dic * K.k1 * K.k2 / den * MASS_TO_VOL
    return -math.log10(H), h2co3, hco3, co3


def co2calc_surface(depth_m, temp, salt, dic_in, ta_in, pt_in, sit_in,
                    phlo, phhi, xco2_ppm, atmpres):
    K = equilibrium_constants(depth_m, temp, salt, False, True)
    H = solve_h(K, dic_in, ta_in, pt_in, sit_in, phlo, phhi)
    dic = max(dic_in, DIC_MIN) / MASS_TO_VOL
    xco2 = xco2_ppm * 1e-6
    co2star = dic * H * H / (H * H + K.k1 * H + K.k1 * K.k2)
    dco2star = xco2 * K.ff * atmpres - co2star
    pco2 = co2star / K.ff
    dpco2 = pco2 - xco2 * atmpres
    return (-math.log10(H), co2star * MASS_TO_VOL, dco2star * MASS_TO_VOL,
            pco2 * 1e6, dpco2 * 1e6)


def co3_sat(depth_m, temp, salt, subsurface):
    s = max(salt, SALT_MIN)
    tk = T0K + temp
    pb = press_bar(depth_m)
    l10 = math.log10(tk)
    sq = math.sqrt(s)
    log_kc = (-171.9065 - 0.077993 * tk + 2839.319 / tk + 71.595 * l10
              + (-0.77712 + 0.0028426 * tk + 178.34 / tk) * sq
              - 0.07711 * s + 0.0041249 * sq * s)
    log_ka = (-171.945 - 0.077993 * tk + 2903.293 / tk + 71.595 * l10
              + (-0.068393 + 0.0017276 * tk + 88.135 / tk) * sq
              - 0.10018 * s + 0.0059415 * sq * s)
    kc = 10.0 ** log_kc
    ka = 10.0 ** log_ka
    if subsurface:
        dV = -48.76 + 0.5304 * temp
        kap = (-11.76 + 0.3692 * temp) * 1e-3
        kc *= _pfac(dV, kap, pb, tk)
        ka *= _pfac(dV + 2.8, kap, pb, tk)
    inv_ca = (35.0 / 0.01028) / s
    return kc * inv_ca * MASS_TO_VOL, ka * inv_ca * MASS_TO_VOL
