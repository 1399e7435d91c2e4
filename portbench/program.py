"""The system under test, as the benchmark reaches it: the one module of
the harness that imports ``ocean_bgc_tpu_torch``.

It puts the benchmark's world (tensors on the device) and namelist into
the program's containers and calls the program's own entry points: ``step`` and
``precompute_env``.  The program's kernel names are read from its CUDA
sources, so that a kernel a later change adds is counted with them.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import torch

from ocean_bgc_tpu_torch.models.coupled import CoupledState, step
from ocean_bgc_tpu_torch.ops.bgc import precompute_env
from ocean_bgc_tpu_torch.state import BGCForcing, BGCState, ColumnGrid
from ocean_bgc_tpu_torch.utils.bridge import params_from_dict

import ocean_bgc_tpu_torch

CSRC = Path(ocean_bgc_tpu_torch.__file__).resolve().parent / "csrc"
_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*"
                     r"\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(")

__all__ = ["step", "precompute_env", "world", "params", "with_record",
           "csrc_kernel_names"]


def world(state, grid, forcing, *, dtype):
    """(CoupledState, ColumnGrid, BGCForcing) from the benchmark's dicts
    of tensors, floating fields in ``dtype`` (the tensors themselves where
    they are of it already), kmax as it is."""

    def cast(t):
        return t.to(dtype) if t.is_floating_point() else t

    def build(cls, fields):
        return cls(**{f.name: cast(fields[f.name])
                      for f in dataclasses.fields(cls)})

    return (CoupledState(bgc=build(BGCState, state["bgc"]),
                         dms=cast(state["dms"]),
                         macros=cast(state["macros"])),
            build(ColumnGrid, grid), build(BGCForcing, forcing))


def params(namelist: dict):
    """The program's ``ModelParams`` from the benchmark's namelist."""
    return params_from_dict(namelist)


def with_record(forcing, record: dict, dtype):
    """The program's forcing with a record's fields in place, in
    ``dtype``."""
    return dataclasses.replace(
        forcing, **{k: v.to(dtype) for k, v in record.items()})


def csrc_kernel_names():
    """The names of the ``__global__`` functions the program's CUDA
    sources define."""
    names = set()
    for path in sorted(CSRC.glob("*.cu")):
        names.update(_GLOBAL.findall(path.read_text()))
    return names
