"""Time-averaged history: the running sums ``models/coupled.py::run`` keeps.

Counterpart of the accumulator in ``ocean_bgc_tpu/utils/history.py``
(the host model's "tavg" layer, BGC_mod.F90:1794).  The history writers
(the .npz writer, the per-process shard writer and its stitcher) are not
ported yet (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch


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
