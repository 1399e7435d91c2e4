"""Column-chunked stepping for worlds larger than device memory.

Counterpart of ``ocean_bgc_tpu/models/chunked.py``.  A 0.1-degree global
grid is ~6.5M columns; at 60 levels x 35 tracers in float64 the
prognostic state alone is ~100 GB, more than one card holds.  This module
keeps the world in host memory (pinned, where a CUDA device exists),
streams column chunks through the device, and steps each chunk on its
own.  Columns never communicate (SURVEY.md §2), so chunking is
column-exact: every chunk has the same width, the tail chunk is padded
with land columns (every field 0: ``kmax = 0`` and the pH fields' "no
previous solution"), whose tendencies are zero and whose results are
dropped.  Every operation of the eager step is elementwise over columns
or a per-lane solve, so a chunked step equals the unchunked one bitwise.

Transfers overlap compute: each chunk is staged in pinned memory and
copied with ``non_blocking=True``, the next chunk is queued before the
previous one's results are copied back (one chunk in flight), and results
go back into the host copy chunk by chunk.
"""

from __future__ import annotations

import dataclasses

import torch

from ocean_bgc_tpu_torch.models.coupled import CoupledState, step
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.state import BGCForcing, ColumnGrid
from ocean_bgc_tpu_torch.utils.bridge import resolve_device


def _map(fn, tree):
    """``fn`` over every tensor of a state, grid or forcing."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(**{f.name: _map(fn, getattr(tree, f.name))
                         for f in dataclasses.fields(tree)})


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``, in pinned memory where a CUDA device can
    copy from it asynchronously."""
    out = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                      pin_memory=torch.cuda.is_available())
    out.copy_(t)
    return out


def host_world_like(state: CoupledState, grid: ColumnGrid,
                    forcing: BGCForcing):
    """Copy a world to host memory (the chunked driver's resident
    representation), pinned where a CUDA device exists."""
    return _map(_pinned, state), _map(_pinned, grid), _map(_pinned, forcing)


def _chunk(tree, lo: int, width: int, total: int, device):
    """Columns [lo, lo + width) of every field (columns last), 0 past
    ``total``, staged in pinned memory and copied to ``device`` without
    blocking."""
    hi = min(lo + width, total)

    def take(a):
        buf = torch.zeros((*a.shape[:-1], width), dtype=a.dtype,
                          pin_memory=torch.cuda.is_available())
        buf[..., :hi - lo] = a[..., lo:hi]
        return buf.to(device, non_blocking=True)

    return _map(take, tree)


def _write_back(dst, src, lo: int, total: int):
    """Copy a chunk's results into the host state (trimming the pad)."""
    hi = min(lo + src.bgc.tracers.shape[-1], total)
    pairs = zip((dst.bgc, dst), (src.bgc, src))
    for d, s in pairs:
        for f in dataclasses.fields(d):
            a, b = getattr(d, f.name), getattr(s, f.name)
            if isinstance(a, torch.Tensor):
                a[..., lo:hi] = b[..., :hi - lo]


def step_chunked(
    host_state: CoupledState,     # host tensors, columns last
    host_grid: ColumnGrid,
    host_forcing: BGCForcing,
    params: ModelParams,
    dt: float,
    *,
    chunk: int = 65536,
    nsteps: int = 1,
    device=None,
    carbonate_impl: str = "auto",
) -> CoupledState:
    """Advance a host-resident world ``nsteps`` by streaming column
    chunks of width ``chunk`` through ``device`` (CUDA by default), each
    chunk ``step``ped with diagnostics off and no env cache, as the JAX
    package steps it.  Returns the updated host state (a copy; the
    input is not changed)."""
    total = host_grid.kmax.shape[-1]
    chunk = min(chunk, total)
    dev = resolve_device(device)
    out = _map(_pinned, host_state)

    def run(s, g, f):
        for _ in range(nsteps):
            s, _ = step(s, g, f, params, dt, compute_diags=False,
                        carbonate_impl=carbonate_impl)
        return s

    pending = []   # (lo, device result): drained one behind the head
    for lo in range(0, total, chunk):
        pending.append((lo, run(
            *(_chunk(t, lo, chunk, total, dev)
              for t in (host_state, host_grid, host_forcing)))))
        if len(pending) > 1:   # keep one chunk in flight
            _write_back(out, pending[0][1], pending[0][0], total)
            del pending[0]
    for lo, done in pending:
        _write_back(out, done, lo, total)
    return out
