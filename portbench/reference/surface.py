"""Scalar oracle for air-sea surface fluxes (one column at a time)."""

from __future__ import annotations

import math

from portbench.reference import carbonate as cref

T0K = 273.15
XKW_COEFF = 8.6e-9


def schmidt_o2(sst):
    return 1638.0 + sst * (-81.83 + sst * (1.483 + sst * (-0.008004)))


def schmidt_co2(sst):
    return 2073.1 + sst * (-125.62 + sst * (3.6276 + sst * (-0.043219)))


def schmidt_dms(sst):
    return 2674.0 + sst * (-147.12 + sst * (3.726 + sst * (-0.038)))


def o2sat(sst, sss):
    ts = math.log(((T0K + 25.0) - sst) / (T0K + sst))
    a = (2.00907 + ts * (3.22014 + ts * (4.05010 + ts * (
        4.94457 + ts * (-2.56847e-1 + ts * 3.88767)))))
    b = sss * ((-6.24523e-3 + ts * (-7.37614e-3 + ts * (
        -1.03410e-2 + ts * -8.17083e-3))) + sss * -4.88682e-7)
    return math.exp(a + b) / 0.0223916


def bgc_surface_column(dic, dic_alt, alk, po4, sio3, o2,
                       sst, sss, press, ice, wind2, xco2, xco2_alt,
                       depth, ph0, ph0_alt, fe_bioavail=1.0):
    """Returns dict with o2 flux, co2 fluxes, new pH values, diags."""
    ice = min(max(ice, 0.0), 1.0)
    xkw_ice = (1.0 - ice) * XKW_COEFF * wind2

    sc_o2 = schmidt_o2(sst)
    pv_o2 = xkw_ice * math.sqrt(660.0 / sc_o2)
    o2s = press * o2sat(sst, sss)
    flux_o2 = pv_o2 * (o2s - max(o2, 0.0))

    sc_co2 = schmidt_co2(sst)
    pv_co2 = xkw_ice * math.sqrt(660.0 / sc_co2)
    if ph0 != 0.0:
        lo, hi = ph0 - 0.2, ph0 + 0.2
    else:
        lo, hi = 7.0, 9.0
    ph, co2s, dco2s, pco2, dpco2 = cref.co2calc_surface(
        depth, sst, sss, max(dic, 0.0), max(alk, 0.0), max(po4, 0.0),
        max(sio3, 0.0), lo, hi, xco2, press)
    flux_co2 = pv_co2 * dco2s
    if ph0_alt != 0.0:
        lo, hi = ph0_alt - 0.2, ph0_alt + 0.2
    else:
        lo, hi = 7.0, 9.0
    ph_alt, _, dco2s_alt, _, _ = cref.co2calc_surface(
        depth, sst, sss, max(dic_alt, 0.0), max(alk, 0.0), max(po4, 0.0),
        max(sio3, 0.0), lo, hi, xco2_alt, press)
    flux_co2_alt = pv_co2 * dco2s_alt
    return dict(flux_o2=flux_o2, flux_co2=flux_co2,
                flux_co2_alt=flux_co2_alt, ph=ph, ph_alt=ph_alt,
                o2sat=o2s, pv_o2=pv_o2, pv_co2=pv_co2)


def dms_surface_column(dms, sst, sss, ice, wind2, press):
    ice = min(max(ice, 0.0), 1.0)
    sc = schmidt_dms(sst)
    wind = math.sqrt(abs(wind2)) * 0.01
    a, e2, e3 = 0.31, 2.85, 0.612
    w92 = a * (660.0 / sc) ** 0.5 * wind * wind
    lm86 = e2 * (600.0 / sc) ** 0.5 * (wind - 3.6) + e3 * (600.0 / sc) ** 0.667
    if wind < 3.6:
        xkw = w92
    elif wind < 5.6:
        f = 0.5 * (wind - 3.6)
        xkw = (1.0 - f) * w92 + f * lm86
    else:
        xkw = lm86
    xkw = xkw / 3600.0 * (1.0 - ice)
    pv = xkw * math.sqrt(660.0 / sc)
    return pv * (press * 0.0 - max(dms, 0.0))
