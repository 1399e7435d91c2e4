"""Macromolecule (proteins / polysaccharides / lipids) source-sink step.

Counterpart of ``ocean_bgc_tpu/ops/macros.py`` (MACROS_SourceSink,
MACROS_mod.F90:137-411): three first-order production/removal pairs
driven by total phytoplankton carbon and a zooplankton-modulated
disruption rate, pure per-cell algebra over (nlev, ncol).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ocean_bgc_tpu_torch.params import MACROSParams
from ocean_bgc_tpu_torch.state import MACROSTracers as MT


def macros_source_sink(
    tracers: torch.Tensor,          # (nlev, MT.CNT, ncol)
    active_mask: torch.Tensor,      # (nlev, ncol) bool
    params: MACROSParams,
    *,
    compute_diags: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Tendencies (nlev, MT.CNT, ncol) and the 6 diagnostics
    (MACROS_parms.F90:105-113); inactive cells produce zeros.
    ``compute_diags=False`` returns an empty dict."""

    def clip(i):
        return torch.clamp_min(tracers[:, i], 0.0)

    zooC = clip(MT.ZOOC)
    phytoC = (clip(MT.DIATC) + clip(MT.PHAEOC) + clip(MT.SPC)
              + clip(MT.DIAZC))                    # (MACROS_mod.F90:366)

    # zoo-modulated disruption rate (MACROS_mod.F90:349)
    k_C_p = params.k_C_p_base * (params.mort + zooC / params.zooC_avg)

    prot_s = params.inject_scale * params.f_prot * k_C_p * phytoC
    poly_s = params.inject_scale * params.f_poly * k_C_p * phytoC
    lip_s = params.inject_scale * params.f_lip * k_C_p * phytoC

    prot_r = params.k_prot_bac * clip(MT.PROT)
    poly_r = params.k_poly_bac * clip(MT.POLY)
    lip_r = params.k_lip_bac * clip(MT.LIP)

    tend = torch.zeros_like(tracers)
    tend[:, MT.PROT] = torch.where(active_mask, prot_s - prot_r, 0.0)
    tend[:, MT.POLY] = torch.where(active_mask, poly_s - poly_r, 0.0)
    tend[:, MT.LIP] = torch.where(active_mask, lip_s - lip_r, 0.0)
    if not compute_diags:
        return tend, {}
    diags = {
        "PROT_S_TOTAL": prot_s, "POLY_S_TOTAL": poly_s,
        "LIP_S_TOTAL": lip_s, "PROT_R_TOTAL": prot_r,
        "POLY_R_TOTAL": poly_r, "LIP_R_TOTAL": lip_r,
    }
    return tend, {k: torch.where(active_mask, v, 0.0)
                  for k, v in diags.items()}
