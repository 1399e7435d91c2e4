"""Carry a parameter set and a world across from numpy.

The reference package's dataclasses reach this module as plain Python
data: ``dataclasses.asdict`` of its parameters, and dicts of numpy arrays
keyed by its dataclasses' field names for the state, grid and forcing.
Nothing here imports the reference package.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np
import torch

from ocean_bgc_tpu_torch.models.coupled import CoupledState
from ocean_bgc_tpu_torch.params import (
    AutotrophTraits,
    BGCParams,
    DMSParams,
    MACROSParams,
    ModelParams,
)
from ocean_bgc_tpu_torch.state import BGCForcing, BGCState, ColumnGrid


def resolve_device(device) -> torch.device:
    """The device a tensor-creating entry point builds on: CUDA unless the
    caller asks otherwise; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return dev


def params_from_dict(d: Mapping) -> ModelParams:
    """``ModelParams`` from ``dataclasses.asdict`` of a parameter set with
    the same fields (the reference's ``ModelParams``)."""
    bgc = dict(d["bgc"])
    bgc["autotrophs"] = tuple(AutotrophTraits(**a)
                              for a in bgc["autotrophs"])
    for key in ("parm_scalelen_z", "parm_scalelen_vals"):
        bgc[key] = tuple(bgc[key])
    return ModelParams(bgc=BGCParams(**bgc), dms=DMSParams(**d["dms"]),
                       macros=MACROSParams(**d["macros"]))


def _build(cls, fields: Mapping, device, dtype):
    def conv(name):
        a = np.asarray(fields[name])
        if np.issubdtype(a.dtype, np.floating):
            return torch.tensor(a, dtype=dtype, device=device)
        return torch.tensor(a, device=device)
    return cls(**{f.name: conv(f.name) for f in dataclasses.fields(cls)})


def world_from_numpy(state: Mapping, grid: Mapping, forcing: Mapping, *,
                     device=None, dtype=torch.float64
                     ) -> Tuple[CoupledState, ColumnGrid, BGCForcing]:
    """The port's (CoupledState, ColumnGrid, BGCForcing) from numpy.

    ``state`` is ``{"bgc": {BGCState fields}, "dms": ..., "macros": ...}``,
    ``grid`` and ``forcing`` map the field names of ``ColumnGrid`` and
    ``BGCForcing`` to arrays.  Floating arrays become ``dtype``, integer
    arrays (``kmax``) keep their type.  ``device`` defaults to CUDA."""
    dev = resolve_device(device)
    cstate = CoupledState(
        bgc=_build(BGCState, state["bgc"], dev, dtype),
        dms=torch.tensor(np.asarray(state["dms"]), dtype=dtype, device=dev),
        macros=torch.tensor(np.asarray(state["macros"]), dtype=dtype,
                            device=dev))
    return (cstate, _build(ColumnGrid, grid, dev, dtype),
            _build(BGCForcing, forcing, dev, dtype))
