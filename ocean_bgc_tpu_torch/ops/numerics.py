"""Shared numerical primitives: the Morel PAR attenuation fit and the
guarded division (counterpart of ``ocean_bgc_tpu/ops/numerics.py``,
forward only; the den**2-free backward of ``safe_div`` arrives with the
adjoint)."""

from __future__ import annotations

import math

import torch

# two-band Morel (2001) chlorophyll attenuation fit, shared by the BGC
# and DMS PAR fields (BGC_mod.F90:907-924, DMS_mod.F90:538-551)
_MOREL_BREAK = 0.13224
_LOG_MOREL_A1 = math.log(0.000919)
_LOG_MOREL_A2 = math.log(0.001131)
_MOREL_P1 = 0.3536
_MOREL_P2 = 0.4562


def morel_kpar(chl: torch.Tensor) -> torch.Tensor:
    """PAR attenuation coefficient (1/cm) from total chlorophyll, as
    ``exp(log(a) + p*log(chl))`` with one shared log (callers floor chl
    at 0.02)."""
    log_chl = torch.log(chl)
    return torch.exp(torch.where(chl < _MOREL_BREAK,
                                 _LOG_MOREL_A1 + _MOREL_P1 * log_chl,
                                 _LOG_MOREL_A2 + _MOREL_P2 * log_chl))


def safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num/den with den == 0 mapped to 0 (guarded selects, not NaN)."""
    nz = den != 0.0
    return torch.where(nz, num / torch.where(nz, den, 1.0), 0.0)
