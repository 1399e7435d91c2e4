"""Checkpoint / resume for the coupled model state.

Counterpart of ``ocean_bgc_tpu/utils/checkpoint.py``'s portable ``.npz``
layout: one array per key of :data:`_FIELDS` plus ``__step__``, so that a
checkpoint of either package resumes in the other.  The restart payload is
exactly the tracer fields plus the pH warm-start fields (SURVEY.md par.5:
PH_PREV_3D / PH_PREV_ALT_CO2_3D / surface_pH / surface_pH_alt_co2, with
pH == 0 meaning "no previous solution"); arrays keep their types, so a
resume is bitwise.

A multi-device run saves per-rank shards (``save(..., mesh=...)``): a
directory of ``ck_p<rank>.npz`` files, each with the rank's column block
and its offset.  These stand in for the JAX package's orbax directories,
which the port does not read.  ``restore(path, mesh=...)`` gives a rank
its block of any checkpoint: shards written at any rank count, or the
single file; without ``mesh`` it gives the whole state.  Every route is
bitwise: no arithmetic touches the data.
"""

from __future__ import annotations

import glob
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


SHARD_TAG = "ck"


def save(path: str, state: CoupledState, *, step: Optional[int] = None,
         mesh=None) -> str:
    """Write a checkpoint; returns the path written.

    Without ``mesh``: one ``.npz`` file (the suffix is added if missing),
    the layout both packages read.  With ``mesh`` (a
    ``parallel.distributed.ColumnMesh``; every rank calls it with its
    block of the state): the directory ``path`` (a ``.npz`` suffix
    dropped) gets this rank's ``ck_p<rank>.npz``, holding its block, its
    first column, the global width, the rank count and the step."""
    flat = {k: to_numpy(v) for k, v in _flatten(state).items()}
    if step is not None:
        flat["__step__"] = np.asarray(step)
    if mesh is None:
        path = path if path.endswith(".npz") else path + ".npz"
        np.savez(path, **flat)
        return path
    from ocean_bgc_tpu_torch.parallel.distributed import host_local_columns
    from ocean_bgc_tpu_torch.utils.history import remove_stale_shards

    path = path[:-len(".npz")] if path.endswith(".npz") else path
    width = flat["tracers"].shape[-1]
    total = width * mesh.world_size
    lo, _ = host_local_columns(total, mesh)
    os.makedirs(path, exist_ok=True)
    remove_stale_shards(path, SHARD_TAG, mesh)
    np.savez(os.path.join(path, f"{SHARD_TAG}_p{mesh.rank}.npz"),
             __col0__=np.asarray(lo), __ncol__=np.asarray(total),
             __nranks__=np.asarray(mesh.world_size), **flat)
    return path


def _shard_files(path: str):
    """The shard files of a directory checkpoint, in rank order, checked
    to be one per rank of the run that wrote them; ``(files, ncol)``."""
    files = glob.glob(os.path.join(path, f"{SHARD_TAG}_p*.npz"))
    if not files:
        raise ValueError(f"{path} is a directory without {SHARD_TAG}_p*.npz "
                         f"shards (an orbax checkpoint?); the port reads "
                         f"its own shards and the portable .npz layout "
                         f"(write it with the JAX package's save(..., "
                         f"use_orbax=False))")
    heads = {}
    for p in files:
        with np.load(p) as f:
            heads[p] = (int(f["__col0__"]), int(f["__ncol__"]),
                        int(f["__nranks__"]), f["tracers"].shape[-1])
    ncol, nranks = next(iter(heads.values()))[1:3]
    if len(files) != nranks or any(h[1:3] != (ncol, nranks)
                                   for h in heads.values()):
        raise ValueError(f"{path}: {len(files)} shard files that disagree "
                         f"on the run that wrote them")
    files.sort(key=lambda p: heads[p][0])
    col = 0
    for p in files:
        if heads[p][0] != col:
            raise ValueError(f"{path}: no shard holds column {col}")
        col += heads[p][3]
    if col != ncol:
        raise ValueError(f"{path}: shards hold {col} of {ncol} columns")
    return [(p, heads[p][0], heads[p][0] + heads[p][3]) for p in files], ncol


def _read(path: str, mesh):
    """The flat checkpoint (``_FIELDS``, ``__step__``) as NumPy arrays:
    the columns of ``mesh``'s rank, or all of them."""
    from ocean_bgc_tpu_torch.parallel.distributed import host_local_columns

    if os.path.isdir(path):
        files, ncol = _shard_files(path)
        lo, hi = (host_local_columns(ncol, mesh) if mesh is not None
                  else (0, ncol))
        parts, step = {k: [] for k in _FIELDS}, None
        for p, a, b in files:
            if b <= lo or a >= hi:
                continue
            with np.load(p) as f:
                for k in _FIELDS:
                    parts[k].append(f[k][..., max(lo, a) - a:min(hi, b) - a])
                if "__step__" in f.files:
                    step = f["__step__"]
        flat = {k: np.concatenate(v, axis=-1) for k, v in parts.items()}
        if step is not None:
            flat["__step__"] = step
        return flat
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    missing = set(_FIELDS) - set(flat)
    if missing:
        raise KeyError(f"{path}: not a checkpoint, missing {sorted(missing)}")
    if mesh is not None:
        lo, hi = host_local_columns(flat["tracers"].shape[-1], mesh)
        flat.update({k: flat[k][..., lo:hi] for k in _FIELDS})
    return flat


def restore(path: str, *, device=None, mesh=None):
    """Read a checkpoint; returns (state, step-or-None).

    ``path``: a ``.npz`` file of either package, or a directory of
    per-rank shards (:func:`save` with ``mesh``) written at any rank
    count.  ``mesh``: a ``ColumnMesh``; the state comes back as that
    rank's column block, on its device.  Without it the whole state comes
    back on ``device`` (CUDA by default).  A directory without shards (the
    JAX package's orbax layout) raises."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    flat = _read(path, mesh)
    step = flat.pop("__step__", None)
    t = {k: from_numpy(flat[k], dev) for k in _FIELDS}
    state = CoupledState(
        bgc=BGCState(tracers=t["tracers"], ph_prev_3d=t["ph_prev_3d"],
                     ph_prev_alt_3d=t["ph_prev_alt_3d"],
                     surface_ph=t["surface_ph"],
                     surface_ph_alt=t["surface_ph_alt"]),
        dms=t["dms"], macros=t["macros"])
    return state, (int(step) if step is not None else None)
