"""Time-averaged history: the running sums ``models/coupled.py::run`` keeps,
and the ``.npz`` history writer and reader.

Counterpart of ``ocean_bgc_tpu/utils/history.py`` (the host model's
"tavg" layer, BGC_mod.F90:1794), in the same file layout; with the
multi-device history writer (:func:`write_history_shards`, one file per
rank) and its stitcher, in the JAX package's shard layout, so that either
package's stitcher reads the other's files.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ocean_bgc_tpu_torch.utils.diag import coupled_registry


@dataclasses.dataclass(frozen=True)
class TavgState:
    """Running sums of selected diagnostics + the sample count."""

    sums: Dict[str, torch.Tensor]
    count: torch.Tensor     # scalar int32

    @staticmethod
    def create(template: Dict[str, torch.Tensor],
               fields: Optional[Sequence[str]] = None) -> "TavgState":
        names = list(fields) if fields is not None else list(template)
        missing = set(names) - set(template)
        if missing:
            raise KeyError(f"unknown diagnostics: {sorted(missing)}")
        device = next(iter(template.values())).device if template else None
        return TavgState(
            sums={n: torch.zeros_like(template[n]) for n in names},
            count=torch.zeros((), dtype=torch.int32, device=device))

    def accumulate(self, diags: Dict[str, torch.Tensor]) -> "TavgState":
        return TavgState(
            sums={n: s + diags[n] for n, s in self.sums.items()},
            count=self.count + 1)

    def means(self) -> Dict[str, torch.Tensor]:
        dtype = (next(iter(self.sums.values())).dtype if self.sums
                 else torch.float64)
        c = torch.clamp_min(self.count, 1).to(dtype)
        return {n: s / c for n, s in self.sums.items()}

    def reset(self) -> "TavgState":
        return TavgState(
            sums={n: torch.zeros_like(s) for n, s in self.sums.items()},
            count=torch.zeros_like(self.count))


def write_history(path: str, tavg: TavgState, *,
                  attrs: Optional[Dict[str, str]] = None) -> str:
    """Write the current means to ``path`` (.npz) with units/long-name
    metadata from the diagnostics registry."""
    registry = coupled_registry()
    means = {n: v.detach().cpu().numpy() for n, v in tavg.means().items()}
    meta = {}
    for n in means:
        spec = registry.get(n)
        if spec is not None:
            meta[f"__units__{n}"] = np.str_(spec.units)
            meta[f"__desc__{n}"] = np.str_(spec.description)
    if attrs:
        meta.update({f"__attr__{k}": np.str_(v) for k, v in attrs.items()})
    path = path if path.endswith(".npz") else path + ".npz"
    np.savez(path, __count__=tavg.count.cpu().numpy(), **means, **meta)
    return path


def _mesh_or_single(mesh):
    """``mesh``, else the current group's mesh, else one rank of one."""
    import torch.distributed as tdist

    from ocean_bgc_tpu_torch.parallel.distributed import (
        ColumnMesh,
        global_mesh,
    )
    if mesh is not None:
        return mesh
    if tdist.is_initialized():
        return global_mesh()
    return ColumnMesh(rank=0, world_size=1, device=torch.device("cpu"))


def remove_stale_shards(dirpath: str, tag: str, mesh) -> None:
    """Rank 0 removes ``<tag>_p<k>.npz`` of ranks k the group does not
    have (files an earlier run of more ranks left), which no rank of this
    group writes."""
    if mesh.rank != 0:
        return
    for p in glob.glob(os.path.join(dirpath, f"{tag}_p*.npz")):
        k = os.path.basename(p)[len(tag) + 2:-len(".npz")]
        if not k.isdigit() or int(k) >= mesh.world_size:
            os.remove(p)


def write_history_shards(dirpath: str, fields: Dict[str, torch.Tensor], *,
                         mesh=None, tag: str = "hist") -> str:
    """The multi-device history writer: each rank writes only its own
    column block, with its global offset, to a file of its own; no
    gather, no collective (``make_sharded_step(local_diags=...)`` yields
    such blocks).  A rank's block starts at ``host_local_columns``' ``lo``
    (every rank holds as many columns).  Scalars are replicated (the
    global sums and health totals) and rank 0 alone writes them.

    Layout (the JAX package's): ``<dirpath>/<tag>_p<rank>.npz`` holding
    ``<name>@<col0>`` blocks (``<name>@r`` for a replicated one) and a
    ``__shape__<name>`` global shape per field;
    :func:`stitch_history_shards` reassembles the global arrays bitwise.
    ``mesh``: the rank's ``ColumnMesh`` (default: the current group's,
    or a single process).  Returns the written path."""
    from ocean_bgc_tpu_torch.parallel.distributed import host_local_columns

    mesh = _mesh_or_single(mesh)
    os.makedirs(dirpath, exist_ok=True)
    remove_stale_shards(dirpath, tag, mesh)
    out: Dict[str, np.ndarray] = {}
    for name, arr in fields.items():
        if "@" in name or name.startswith("__"):
            raise ValueError(f"field name {name!r} collides with the "
                             "shard-file key syntax")
        a = (arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor)
             else np.asarray(arr))
        if a.ndim == 0:
            out[f"__shape__{name}"] = np.asarray(a.shape, np.int64)
            if mesh.rank == 0:
                out[f"{name}@r"] = a
            continue
        total = a.shape[-1] * mesh.world_size
        lo, hi = host_local_columns(total, mesh)
        if a.shape[-1] != hi - lo:
            raise ValueError(f"{name}: a block of {a.shape[-1]} columns, "
                             f"but rank {mesh.rank} holds {hi - lo} of "
                             f"{total}")
        out[f"__shape__{name}"] = np.asarray(a.shape[:-1] + (total,),
                                             np.int64)
        out[f"{name}@{lo}"] = a
    path = os.path.join(dirpath, f"{tag}_p{mesh.rank}.npz")
    np.savez(path, **out)
    return path


def stitch_history_shards(dirpath: str, *, tag: str = "hist"
                          ) -> Dict[str, np.ndarray]:
    """Reassemble the global history arrays from every rank's shard file
    (:func:`write_history_shards`, or the JAX package's).  Blocks are
    concatenated along the trailing (columns) axis in offset order; full
    coverage is verified against the recorded global shapes, overlapping
    blocks must be bitwise identical, and a replicated field must have
    its recorded shape (a ValueError otherwise).  No arithmetic touches
    the data."""
    parts = sorted(glob.glob(os.path.join(dirpath, f"{tag}_p*.npz")))
    if not parts:
        raise FileNotFoundError(
            f"no {tag}_p*.npz shard files under {dirpath}")
    shapes: Dict[str, tuple] = {}
    blocks: Dict[str, Dict[int, np.ndarray]] = {}
    replicated: Dict[str, np.ndarray] = {}
    for p in parts:
        with np.load(p) as f:
            for key in f.files:
                if key.startswith("__shape__"):
                    shapes[key[len("__shape__"):]] = tuple(
                        int(x) for x in f[key])
                    continue
                name, off = key.rsplit("@", 1)
                if off == "r":
                    replicated[name] = f[key]
                    continue
                prev = blocks.setdefault(name, {}).get(int(off))
                if prev is not None:
                    if not np.array_equal(prev, f[key]):
                        raise ValueError(
                            f"overlapping shards of {name!r} at column "
                            f"{off} disagree across processes")
                else:
                    blocks[name][int(off)] = f[key]
    unshaped = (set(blocks) | set(replicated)) - set(shapes)
    if unshaped:
        raise ValueError(f"no recorded global shape for {sorted(unshaped)}")
    out: Dict[str, np.ndarray] = {}
    for name, shape in shapes.items():
        if name in replicated:
            if replicated[name].shape != shape:
                raise ValueError(
                    f"replicated {name!r} has shape "
                    f"{replicated[name].shape}, recorded {shape}")
            out[name] = replicated[name]
            continue
        offs = sorted(blocks.get(name, {}))
        got = 0
        for o in offs:
            if o != got:
                raise ValueError(
                    f"missing shard of {name!r}: gap at column {got}")
            got = o + blocks[name][o].shape[-1]
        if got != shape[-1]:
            raise ValueError(
                f"missing trailing shards of {name!r}: have {got} of "
                f"{shape[-1]} columns")
        out[name] = np.concatenate([blocks[name][o] for o in offs],
                                   axis=-1)
        if out[name].shape != shape:
            raise ValueError(
                f"stitched shape {out[name].shape} != recorded "
                f"{shape} for {name!r}")
    return out


def read_history(path: str):
    """Returns (means dict, count, metadata dict)."""
    with np.load(path) as f:
        count = int(f["__count__"])
        means, meta = {}, {}
        for k in f.files:
            if k == "__count__":
                continue
            if k.startswith("__"):
                meta[k] = str(f[k])
            else:
                means[k] = f[k]
    return means, count, meta
