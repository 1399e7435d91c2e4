"""Checkpoint / resume for the coupled model state.

Counterpart of ``ocean_bgc_tpu/utils/checkpoint.py``'s portable ``.npz``
layout: one array per key of :data:`_FIELDS` plus ``__step__``, so that a
checkpoint of either package resumes in the other.  The restart payload is
exactly the tracer fields plus the pH warm-start fields (SURVEY.md par.5:
PH_PREV_3D / PH_PREV_ALT_CO2_3D / surface_pH / surface_pH_alt_co2, with
pH == 0 meaning "no previous solution"); arrays keep their types, so a
resume is bitwise.

The JAX package's orbax directories and its sharded restore
(``mesh=``) wait for the multi-device slice (ROADMAP queue 1 item 13);
both raise here.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ocean_bgc_tpu_torch.io.model_io import from_numpy, to_numpy
from ocean_bgc_tpu_torch.models.coupled import CoupledState
from ocean_bgc_tpu_torch.state import BGCState
from ocean_bgc_tpu_torch.utils.bridge import resolve_device

_FIELDS = (
    "tracers", "ph_prev_3d", "ph_prev_alt_3d", "surface_ph",
    "surface_ph_alt", "dms", "macros",
)


def _flatten(state: CoupledState):
    return {
        "tracers": state.bgc.tracers,
        "ph_prev_3d": state.bgc.ph_prev_3d,
        "ph_prev_alt_3d": state.bgc.ph_prev_alt_3d,
        "surface_ph": state.bgc.surface_ph,
        "surface_ph_alt": state.bgc.surface_ph_alt,
        "dms": state.dms,
        "macros": state.macros,
    }


def save(path: str, state: CoupledState, *,
         step: Optional[int] = None) -> str:
    """Write a ``.npz`` checkpoint (the suffix is added if missing);
    returns the path written."""
    flat = {k: to_numpy(v) for k, v in _flatten(state).items()}
    if step is not None:
        flat["__step__"] = np.asarray(step)
    path = path if path.endswith(".npz") else path + ".npz"
    np.savez(path, **flat)
    return path


def restore(path: str, *, device=None, mesh=None):
    """Read a ``.npz`` checkpoint of either package; returns (state,
    step-or-None).  ``device`` defaults to CUDA.  An orbax checkpoint (a
    directory) and a sharded restore (``mesh``) raise: neither is ported
    (ROADMAP queue 1 item 13)."""
    if mesh is not None:
        raise ValueError("sharded restore (mesh=...) is not ported: the "
                         "multi-device slice (ROADMAP queue 1 item 13) has "
                         "not been done")
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory, an orbax checkpoint; the "
                         f"port reads only the portable .npz layout (write "
                         f"it with the JAX package's save(..., "
                         f"use_orbax=False))")
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    dev = resolve_device(device)
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    step = flat.pop("__step__", None)
    missing = set(_FIELDS) - set(flat)
    if missing:
        raise KeyError(f"{path}: not a checkpoint, missing {sorted(missing)}")
    t = {k: from_numpy(flat[k], dev) for k in _FIELDS}
    state = CoupledState(
        bgc=BGCState(tracers=t["tracers"], ph_prev_3d=t["ph_prev_3d"],
                     ph_prev_alt_3d=t["ph_prev_alt_3d"],
                     surface_ph=t["surface_ph"],
                     surface_ph_alt=t["surface_ph_alt"]),
        dms=t["dms"], macros=t["macros"])
    return state, (int(step) if step is not None else None)
