"""The parameters K2 reads, packed into one flat tuple of floats.

``pack_bgc_params(params)`` lays out every scalar of :class:`BGCParams`
that the interior kernel (``csrc/interior_step.cu``) reads, in the order
of :data:`GLOBAL_FIELDS`, then the traits of each of the four autotroph
groups in the order of :data:`TRAIT_FIELDS`.  The kernel mirrors both
lists as the enums ``GlobalParam`` and ``TraitParam``;
``tests/test_torch_fused.py`` holds the enums, these lists and the
parameters the plain version reads equal, since a mismatch would give
plausible but wrong physics.

The pack stays in double at both working types: the kernel takes it by
value as a launch argument and forms each product of parameters (as
``c.CKS * au.kFe``) in double, as Python forms it, before rounding to the
working type, as PyTorch rounds a Python scalar.  Booleans and the
integer traits are stored as 0.0/1.0 and small whole numbers.

Parameters the kernel does not read stay out: the dissolution lengths
``parm_SiO2_diss``, ``parm_CaCO3_diss`` and the scale-length table reach
it through the precomputed dissolution factors
(``particulates.precompute_dissolution``), and the surface-flux switches
and ``parm_Fe_bioavail`` belong to ``ops/surface.py``.
"""

from __future__ import annotations

import torch

from ocean_bgc_tpu_torch.constants import AUTOTROPH_CNT
from ocean_bgc_tpu_torch.params import BGCParams
from ocean_bgc_tpu_torch.state import BGCTracers as T

GLOBAL_FIELDS = (
    "parm_o2_min", "parm_o2_min_delta", "parm_kappa_nitrif",
    "parm_nitrif_par_lim", "parm_z_mort_0", "parm_z_mort2_0",
    "parm_labile_ratio", "parm_POMbury", "parm_BSIbury",
    "parm_fe_scavenge_rate0", "parm_f_prod_sp_CaCO3", "parm_POC_diss",
    "lrest_po4", "lrest_no3", "lrest_sio3", "alt_co2_use_eco",
)

TRAIT_FIELDS = (
    "nfixer", "imp_calcifier", "exp_calcifier", "grazee_ind",
    "temp_function", "has_si",
    "kFe", "kPO4", "kDOP", "kNO3", "kNH4", "kSiO3", "Qp", "gQfe_0",
    "gQfe_min", "alphaPI", "PCref", "thetaN_max", "loss_thres",
    "loss_thres2", "temp_thres", "temp_thresN", "temp_thresS", "temp_optN",
    "temp_optS", "mort", "mort2", "agg_rate_max", "agg_rate_min",
    "z_umax_0", "z_grz", "graze_zoo", "graze_poc", "graze_doc", "loss_poc",
    "f_zoo_detr",
)

NUM_PARAMS = len(GLOBAL_FIELDS) + AUTOTROPH_CNT * len(TRAIT_FIELDS)


def check_traits(params: BGCParams) -> None:
    """Raise unless the autotroph traits fit the tracer layout the kernel
    is built for: four groups, Si traits exactly where the layout has a
    Si slot, calcification exactly where it has a CaCO3 slot (the plain
    version needs the same to run)."""
    autos = params.autotrophs
    if len(autos) != AUTOTROPH_CNT:
        raise ValueError(f"the interior kernel takes {AUTOTROPH_CNT} "
                         f"autotroph groups, got {len(autos)}")
    for g, au in enumerate(autos):
        if au.has_si != (T.SI_IND[g] is not None):
            raise ValueError(f"group {g} ({au.sname}): has_si={au.has_si} "
                             f"but the tracer layout's Si slot is "
                             f"{T.SI_IND[g]}")
        if au.imp_calcifier != (T.CACO3_IND[g] is not None) or (
                au.exp_calcifier and T.CACO3_IND[g] is None):
            raise ValueError(f"group {g} ({au.sname}): calcifier traits "
                             f"do not match the CaCO3 slot "
                             f"{T.CACO3_IND[g]}")


def pack_bgc_params(params: BGCParams) -> tuple:
    """``NUM_PARAMS`` floats: :data:`GLOBAL_FIELDS` of ``params``, then
    :data:`TRAIT_FIELDS` of each autotroph group.  A value that requires
    grad (a parameter under calibration) raises: the kernel reads it by
    value, and its gradient would be lost."""
    check_traits(params)
    named = [(f, getattr(params, f)) for f in GLOBAL_FIELDS]
    for g, au in enumerate(params.autotrophs):
        named += [(f"autotrophs[{g}].{f}", getattr(au, f))
                  for f in TRAIT_FIELDS]
    for name, v in named:
        if torch.is_tensor(v) and v.requires_grad:
            raise ValueError(f"pack_bgc_params: {name} requires grad; the "
                             f"interior kernel takes its parameters by "
                             f"value and has no backward")
    return tuple(float(v) for _, v in named)
