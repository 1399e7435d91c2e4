"""Time-averaged history: the running sums ``models/coupled.py::run`` keeps,
and the ``.npz`` history writer and reader.

Counterpart of ``ocean_bgc_tpu/utils/history.py`` (the host model's
"tavg" layer, BGC_mod.F90:1794), in the same file layout.  The
per-process shard writer and its stitcher wait for the multi-device slice
(ROADMAP queue 1 item 13).
"""

from __future__ import annotations

import dataclasses
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
