"""Scalar loop-based oracle for the DMS and MACROS source-sink kernels.

Written cell-by-cell with plain Python control flow (if/else instead of
masks, explicit downward loop carrying PAR), independently of the
vectorized scan kernels.
"""

from __future__ import annotations

import math

import numpy as np

EPSC = 1.0e-8


def par_attenuation(par_in: float, chl: float, dz: float):
    w = max(chl, 0.02)
    if w < 0.13224:
        k = 0.000919 * w ** 0.3536
    else:
        k = 0.001131 * w ** 0.4562
    kdz = k * dz
    return par_in * math.exp(-kdz), par_in * (1.0 - math.exp(-kdz)) / kdz, kdz


def macros_source_sink(tracers, kmax, p):
    """tracers: (nlev, 8, ncol) [PROT, POLY, LIP, zooC, spC, diatC, diazC,
    phaeoC]; returns (tendencies, diags dict)."""
    nlev, _, ncol = tracers.shape
    tend = np.zeros_like(tracers)
    diags = {k: np.zeros((nlev, ncol)) for k in
             ("PROT_S_TOTAL", "POLY_S_TOTAL", "LIP_S_TOTAL",
              "PROT_R_TOTAL", "POLY_R_TOTAL", "LIP_R_TOTAL")}
    for col in range(ncol):
        for k in range(int(kmax[col])):
            prot, poly, lip, zooC, spC, diatC, diazC, phaeoC = (
                max(0.0, tracers[k, i, col]) for i in range(8))
            k_C_p = p.k_C_p_base * (p.mort + zooC / p.zooC_avg)
            phytoC = diatC + phaeoC + spC + diazC
            ps = p.inject_scale * p.f_prot * k_C_p * phytoC
            ys = p.inject_scale * p.f_poly * k_C_p * phytoC
            ls = p.inject_scale * p.f_lip * k_C_p * phytoC
            pr = p.k_prot_bac * prot
            yr = p.k_poly_bac * poly
            lr = p.k_lip_bac * lip
            tend[k, 0, col] = ps - pr
            tend[k, 1, col] = ys - yr
            tend[k, 2, col] = ls - lr
            diags["PROT_S_TOTAL"][k, col] = ps
            diags["POLY_S_TOTAL"][k, col] = ys
            diags["LIP_S_TOTAL"][k, col] = ls
            diags["PROT_R_TOTAL"][k, col] = pr
            diags["POLY_R_TOTAL"][k, col] = yr
            diags["LIP_R_TOTAL"][k, col] = lr
    return tend, diags


def dms_source_sink(tracers, cell_thickness, kmax, sst, shortwave, p):
    """tracers: (nlev, 14, ncol) in DMSTracers order.  Returns tendencies
    plus a few spot-check diagnostics."""
    nlev, _, ncol = tracers.shape
    tend = np.zeros_like(tracers)
    diag_phytoN = np.zeros((nlev, ncol))
    diag_zooS = np.zeros((nlev, ncol))
    diag_yield_proxy = np.zeros((nlev, ncol))
    for col in range(ncol):
        par_out = max(0.0, shortwave[col]) * 0.45
        sst_c = sst[col]
        for k in range(int(kmax[col])):
            (dms, dmsp, no3, doc, zooC, spC, spCaCO3, diatC, diazC, phaeoC,
             spChl, diatChl, diazChl, phaeoChl) = (
                max(0.0, tracers[k, i, col]) for i in range(14))
            dz = cell_thickness[k, col]

            k_S_p = p.k_S_p_base * (p.mort + zooC / 0.3)
            chl = spChl + diatChl + diazChl + phaeoChl
            par_in = par_out
            par_out, par_avg, _ = par_attenuation(par_in, chl, dz)
            j_dms = p.j_dms_perI * par_avg

            fcocco = spCaCO3 / (spC + EPSC)
            if fcocco > 0.4:
                fcocco = 0.4
            t_ind = (sst_c - p.T_lo) / (p.T_hi - p.T_lo)
            t_ind = min(max(t_ind, 0.0), 1.0)
            cyano = (1.0 - fcocco) * (
                t_ind * (p.Max_cyano_frac - p.Min_cyano_frac)
                + p.Min_cyano_frac)
            eukar = 1.0 - fcocco - cyano

            diatN = p.R * diatC
            phaeoN = p.R * phaeoC
            coccoN = fcocco * p.R * spC
            cyanoN = cyano * p.R * spC
            eukarN = eukar * p.R * spC
            diazN = p.R * diazC
            zooN = p.R * zooC
            phytoN = diatN + coccoN + cyanoN + eukarN + diazN + phaeoN

            sp_dec = min(max((p.Sp_ref - spChl) / p.Sp_ref, 0.0), 1.0)
            stress = min(1.0 + p.Stress_mult * sp_dec * sp_dec, 10.0)

            yld = t_ind * (p.Max_yld - p.Min_yld) + p.Min_yld
            if p.T_cryo_lo < sst_c < p.T_cryo_hi:
                yld = 0.5
            if sst_c < -1.0:
                yld = 0.25

            diatS = p.Rs2n_diat * diatN
            phaeoS = p.Rs2n_phaeo * phaeoN
            coccoS = p.Rs2n_cocco * coccoN
            cyanoS = p.Rs2n_cyano * cyanoN
            eukarS = p.Rs2n_eukar * eukarN * stress
            diazS = p.Rs2n_diaz * diazN
            phytoS = (diatS + coccoS + cyanoS + eukarS + diazS
                      + p.G_phaeo_S * phaeoS)

            if phytoN > 0.0:
                rs2n_zoo = (p.Rs2n_diat * diatN
                            + p.G_phaeo_S * p.Rs2n_phaeo * phaeoN
                            + p.Rs2n_cocco * coccoN + p.Rs2n_cyano * cyanoN
                            + p.Rs2n_eukar * eukarN * stress
                            + p.Rs2n_diaz * diazN) / phytoN
            else:
                rs2n_zoo = (p.Rs2n_diat + p.Rs2n_cocco + p.Rs2n_cyano
                            + p.Rs2n_eukar + p.Rs2n_diaz + p.Rs2n_phaeo) / 6.0
            zooS = rs2n_zoo * zooN

            b = p.B_preexp * phytoN ** p.B_exp

            dms_s = yld * p.k_conv * dmsp
            dms_r = (p.k_S_B * b * dms + j_dms * dms + p.k_bkgnd * dms)
            dmsp_s = (p.inject_scale * p.k_S_p_base * phaeoS
                      + p.inject_scale * k_S_p * phytoS
                      + p.inject_scale * p.k_S_z * zooS)
            dmsp_r = p.k_conv * dmsp + p.k_bkgnd * dmsp

            tend[k, 0, col] = dms_s - dms_r
            tend[k, 1, col] = dmsp_s - dmsp_r
            diag_phytoN[k, col] = phytoN
            diag_zooS[k, col] = zooS
            diag_yield_proxy[k, col] = yld
    return tend, {"phytoN": diag_phytoN, "zooS": diag_zooS,
                  "yield": diag_yield_proxy}
