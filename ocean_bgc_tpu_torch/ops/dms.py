"""DMS / DMSP sulfur-cycle source-sink step.

Counterpart of ``ocean_bgc_tpu/ops/dms.py`` (DMS_SourceSink,
DMS_mod.F90:156-770): fuzzy partition of the small-phytoplankton pool
into coccolithophore / cyanobacteria / eukaryote fractions, nitrogen and
sulfur currency conversions, diagnosed bacteria, and first/second-order
DMS and DMSP kinetics.  The PAR attenuation (DMS_mod.F90:531-551) is the
closed-form exclusive cumulative product over levels, so the step is
batched over (nlev, ncol) cells.  It returns the 27 diagnostics
(DMS_parms.F90:125-154) and, on request, the UV field that the reference
computes but never consumes (DMS_mod.F90:509-510, 531-536).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ocean_bgc_tpu_torch.constants import EPSC, F_QSW_PAR_DMS
from ocean_bgc_tpu_torch.ops.numerics import (
    exp,
    morel_kpar,
    pow_floor0,
    safe_div,
)
from ocean_bgc_tpu_torch.params import DMSParams
from ocean_bgc_tpu_torch.state import DMSTracers as DT

DMS_DIAG_NAMES = (
    "DMS_S_DMSP", "DMS_S_TOTAL",
    "DMS_R_B", "DMS_R_PHOT", "DMS_R_BKGND", "DMS_R_TOTAL",
    "DMSP_S_PHAEO", "DMSP_S_NONPHAEO", "DMSP_S_ZOO", "DMSP_S_TOTAL",
    "DMSP_R_B", "DMSP_R_BKGND", "DMSP_R_TOTAL",
    "Cyano_frac", "Cocco_frac", "Eukar_frac",
    "diatS", "diatN", "phytoN", "coccoS", "cyanoS", "eukarS", "diazS",
    "phaeoS", "zooS", "zooCC", "RSNzoo",
)


def dms_source_sink(
    tracers: torch.Tensor,         # (nlev, DT.CNT, ncol)
    cell_thickness: torch.Tensor,  # (nlev, ncol) cm
    active_mask: torch.Tensor,     # (nlev, ncol) bool
    sst: torch.Tensor,             # (ncol,)
    shortwave_surface: torch.Tensor,  # (ncol,) W/m^2
    params: DMSParams,
    *,
    compute_uv: bool = False,
    compute_diags: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Tendencies (nlev, DT.CNT, ncol), of which only DMS and DMSP are
    nonzero, and the 27 diagnostics (:data:`DMS_DIAG_NAMES`), each an
    (nlev, ncol) field; inactive cells produce zeros.

    ``compute_uv``: also the DOC-attenuated UV field as ``UV_in``,
    ``UV_out`` and ``UV_avg``.  ``compute_diags=False`` returns an empty
    dict and skips the diagnostics' masking (eager PyTorch evaluates what
    XLA's dead-code elimination drops in the JAX package)."""

    p = params

    clip = torch.clamp_min(tracers, 0.0)   # (DMS_mod.F90:471-485)

    dms = clip[:, DT.DMS]
    dmsp = clip[:, DT.DMSP]
    doc = clip[:, DT.DOC]
    zooC = clip[:, DT.ZOOC]
    spC = clip[:, DT.SPC]
    spCaCO3 = clip[:, DT.SPCACO3]
    diatC = clip[:, DT.DIATC]
    diazC = clip[:, DT.DIAZC]
    phaeoC = clip[:, DT.PHAEOC]
    spChl = clip[:, DT.SPCHL]
    diatChl = clip[:, DT.DIATCHL]
    diazChl = clip[:, DT.DIAZCHL]
    phaeoChl = clip[:, DT.PHAEOCHL]

    dz = cell_thickness
    active = active_mask

    # whole-column PAR attenuation (DMS_mod.F90:538-551) as an exclusive
    # cumulative product; a sub-floor cell only shades cells below it,
    # all inactive, and every tendency is masked by ``active``
    par_surf = torch.clamp_min(shortwave_surface, 0.0) * F_QSW_PAR_DMS

    total_chl = spChl + diatChl + diazChl + phaeoChl
    chl = torch.clamp_min(total_chl, 0.02)
    kpar = morel_kpar(chl)
    kpar_dz = kpar * dz
    att = exp(-kpar_dz)
    cum = torch.cumprod(att, dim=0)
    par_in = par_surf[None, :] * torch.cat([torch.ones_like(cum[:1]),
                                            cum[:-1]], dim=0)
    par_avg = par_in * (1.0 - att) / kpar_dz

    # zoo-modulated phyto S release constant (DMS_mod.F90:529);
    # the reference hard-codes the 0.3 zooC normalization here
    k_S_p = p.k_S_p_base * (p.mort + zooC / 0.3)

    # photolysis scales with PAR (DMS_mod.F90:562)
    j_dms = p.j_dms_perI * par_avg

    # coccolithophore fraction from CaCO3 quota (DMS_mod.F90:570-573)
    cocco_frac = torch.clamp_max(spCaCO3 / (spC + EPSC), 0.4)

    # SST-interpolated cyanobacteria fraction (DMS_mod.F90:584-592)
    t_ind = torch.clamp((sst - p.T_lo) / (p.T_hi - p.T_lo), 0.0, 1.0)
    cyano_frac = (t_ind * (p.Max_cyano_frac - p.Min_cyano_frac)
                  + p.Min_cyano_frac)
    cyano_frac = (1.0 - cocco_frac) * cyano_frac
    eukar_frac = 1.0 - cocco_frac - cyano_frac

    # nitrogen currency (DMS_mod.F90:598-604)
    diatN = p.R * diatC
    phaeoN = p.R * phaeoC
    coccoN = cocco_frac * p.R * spC
    cyanoN = cyano_frac * p.R * spC
    eukarN = eukar_frac * p.R * spC
    diazN = p.R * diazC
    zooN = p.R * zooC
    phytoN = diatN + coccoN + cyanoN + eukarN + diazN + phaeoN

    # oxidant-stress upregulation via chlorophyll decrement
    # (DMS_mod.F90:621-628)
    sp_dec = torch.clamp((p.Sp_ref - spChl) / p.Sp_ref, 0.0, 1.0)
    stress_fac = torch.clamp_max(1.0 + p.Stress_mult * sp_dec * sp_dec, 10.0)

    # temperature-dependent bacterial yield with cryoprotection
    # overrides (DMS_mod.F90:637-640)
    yield_ = t_ind * (p.Max_yld - p.Min_yld) + p.Min_yld
    yield_ = torch.where((sst < p.T_cryo_hi) & (sst > p.T_cryo_lo),
                         0.5, yield_)
    yield_ = torch.where(sst < -1.0, 0.25, yield_)

    # per-class sulfur content (DMS_mod.F90:647-660)
    diatS = p.Rs2n_diat * diatN
    phaeoS = p.Rs2n_phaeo * phaeoN
    coccoS = p.Rs2n_cocco * coccoN
    cyanoS = p.Rs2n_cyano * cyanoN
    eukarS = p.Rs2n_eukar * eukarN * stress_fac
    diazS = p.Rs2n_diaz * diazN
    phytoS = (diatS + coccoS + cyanoS + eukarS + diazS
              + p.G_phaeo_S * phaeoS)

    # food-weighted zooplankton sulfur (DMS_mod.F90:671-684); the
    # phytoN <= 0 value of the guarded division is discarded below
    rs2n_zoo_weighted = safe_div(
        p.Rs2n_diat * diatN
        + p.G_phaeo_S * p.Rs2n_phaeo * phaeoN
        + p.Rs2n_cocco * coccoN
        + p.Rs2n_cyano * cyanoN
        + p.Rs2n_eukar * eukarN * stress_fac
        + p.Rs2n_diaz * diazN, phytoN)
    rs2n_zoo_fallback = (p.Rs2n_diat + p.Rs2n_cocco + p.Rs2n_cyano
                         + p.Rs2n_eukar + p.Rs2n_diaz
                         + p.Rs2n_phaeo) / 6.0
    rs2n_zoo = torch.where(phytoN > 0.0, rs2n_zoo_weighted,
                           rs2n_zoo_fallback)
    zooS = rs2n_zoo * zooN

    # diagnosed bacteria (DMS_mod.F90:695); the derivative in phytoN is
    # taken as 0 at phytoN = 0, where it is infinite
    b_diagnosed = p.B_preexp * pow_floor0(phytoN, p.B_exp)

    # kinetic terms (DMS_mod.F90:701-716)
    dms_s = yield_ * p.k_conv * dmsp
    dms_r_B = p.k_S_B * b_diagnosed * dms
    dms_r_phot = j_dms * dms
    dms_r_bkgnd = p.k_bkgnd * dms
    dms_r = dms_r_B + dms_r_phot + dms_r_bkgnd

    dmsp_s_phaeo = p.inject_scale * p.k_S_p_base * phaeoS
    dmsp_s_nonphaeo = p.inject_scale * k_S_p * phytoS
    dmsp_s_zoo = p.inject_scale * p.k_S_z * zooS
    dmsp_s = dmsp_s_phaeo + dmsp_s_nonphaeo + dmsp_s_zoo
    dmsp_r_B = p.k_conv * dmsp
    dmsp_r_bkgnd = p.k_bkgnd * dmsp
    dmsp_r = dmsp_r_B + dmsp_r_bkgnd

    tend = torch.zeros_like(tracers)
    tend[:, DT.DMS] = torch.where(active, dms_s - dms_r, 0.0)
    tend[:, DT.DMSP] = torch.where(active, dmsp_s - dmsp_r, 0.0)
    if not compute_diags:
        return tend, {}

    shape = dms.shape
    diags = {
        "DMS_S_DMSP": dms_s, "DMS_S_TOTAL": dms_s,
        "DMS_R_B": dms_r_B, "DMS_R_PHOT": dms_r_phot,
        "DMS_R_BKGND": dms_r_bkgnd, "DMS_R_TOTAL": dms_r,
        "DMSP_S_PHAEO": dmsp_s_phaeo,
        "DMSP_S_NONPHAEO": dmsp_s_nonphaeo,
        "DMSP_S_ZOO": dmsp_s_zoo, "DMSP_S_TOTAL": dmsp_s,
        "DMSP_R_B": dmsp_r_B, "DMSP_R_BKGND": dmsp_r_bkgnd,
        "DMSP_R_TOTAL": dmsp_r,
        "Cyano_frac": cyano_frac.expand(shape),
        "Cocco_frac": cocco_frac,
        "Eukar_frac": eukar_frac.expand(shape),
        "diatS": diatS, "diatN": diatN, "phytoN": phytoN,
        "coccoS": coccoS, "cyanoS": cyanoS, "eukarS": eukarS,
        "diazS": diazS, "phaeoS": phaeoS, "zooS": zooS,
        "zooCC": zooC, "RSNzoo": rs2n_zoo,
    }
    if compute_uv:
        # UV: 1% of surface PAR, attenuated by DOC (DMS_mod.F90:509-510,
        # 531-536), the same exclusive cumulative product as PAR's
        kuv_dz = (0.01e-2 * doc + 0.04e-4) * dz
        att_uv = exp(-kuv_dz)
        cum_uv = torch.cumprod(att_uv, dim=0)
        uv_in = ((par_surf * 0.01)[None, :]
                 * torch.cat([torch.ones_like(cum_uv[:1]), cum_uv[:-1]],
                             dim=0))
        diags["UV_in"] = uv_in
        diags["UV_out"] = uv_in * att_uv
        diags["UV_avg"] = uv_in * (1.0 - att_uv) / kuv_dz
    return tend, {k: torch.where(active, v, 0.0) for k, v in diags.items()}
