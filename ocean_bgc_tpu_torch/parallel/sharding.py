"""Multi-device runs: the columns split over ranks.

Counterpart of ``ocean_bgc_tpu/parallel/sharding.py``.  The reference's
host model shards the horizontal grid over MPI ranks and calls the column
physics on local blocks (SURVEY.md par.2); here the ranks are the
processes of a ``torch.distributed`` group (``parallel/distributed.py``):

* every state, grid and forcing field carries its columns on the LAST
  axis, and rank r holds the r-th contiguous block of them
  (:func:`shard_world`);
* the step makes no collective: columns never communicate (the only
  coupling is vertical, inside a column), so each rank runs the port's
  ``models/coupled.py::step`` on its block, with every kernel launch of
  the unsharded step;
* what crosses ranks is the global reduction of the scalar monitoring
  diagnostics (the Jint conservation sums, the global integrals and the
  health counters): one stacked ``all_reduce`` per step that computes
  them, where the JAX package makes 6 + 2 ``psum``s;
* a file that holds every column (``run_model``'s NetCDF history and
  world file) is written by rank 0 from the ranks' blocks gathered to it
  (:func:`gather_columns`), as the JAX package writes it from its global
  arrays.

The JAX package's pjit twins (``make_pjit_step``,
``make_pjit_forced_run``) were a validation harness for XLA's
partitioner and have no counterpart.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.distributed as tdist

from ocean_bgc_tpu_torch.models.coupled import CoupledState, step
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.parallel.distributed import (
    ColumnMesh,
    global_mesh,
    host_local_columns,
)
from ocean_bgc_tpu_torch.state import BGCForcing, ColumnGrid
from ocean_bgc_tpu_torch.utils.profiling import count, readback
from ocean_bgc_tpu_torch.utils.tree import tree_map

COLUMNS = "columns"

# diagnostics whose global sums a host model monitors every step
GLOBAL_SUM_DIAGS = (
    "Jint_Ctot", "Jint_Ntot", "Jint_Ptot", "Jint_Sitot",
    "photoC_TOT_zint", "tot_CaCO3_form_zint",
)

HEALTH_DIAGS = ("health_solver_nonconverged_cells",
                "health_poc_error_cells")


def make_mesh() -> ColumnMesh:
    """The columns mesh of the current process group (``parallel/
    distributed.py::initialize`` first)."""
    return global_mesh()


def shard_columns(tree, mesh: ColumnMesh, total_columns: int):
    """This rank's block of every leaf of a global tree: its last axis
    sliced to ``host_local_columns`` (a contiguous copy on the rank's
    device); scalars are replicated."""
    lo, hi = host_local_columns(total_columns, mesh)

    def block(path, x):
        x = torch.as_tensor(x)
        if x.ndim == 0:
            return x.to(mesh.device)
        if x.shape[-1] != total_columns:
            raise ValueError(f"{path or 'leaf'}: {x.shape[-1]} columns, "
                             f"not the {total_columns} of the world")
        return x[..., lo:hi].to(mesh.device).contiguous()

    return tree_map(block, tree)


def shard_world(state: CoupledState, grid: ColumnGrid, forcing: BGCForcing,
                mesh: ColumnMesh):
    """This rank's block of a whole world's state, grid and forcing."""
    ncol = grid.ncol
    return tuple(shard_columns(t, mesh, ncol)
                 for t in (state, grid, forcing))


def all_reduce_sum(values: Sequence[torch.Tensor], mesh: ColumnMesh
                   ) -> list:
    """The sums over ranks of scalar tensors, in one ``all_reduce`` of
    them stacked in float64 (counts stay exact), each returned in its
    own dtype.  Each call adds one to the counter
    ``collectives.all_reduce``."""
    buf = torch.stack([v.to(torch.float64) for v in values])
    tdist.all_reduce(buf, group=mesh.group)
    count("collectives.all_reduce")
    return [buf[i].to(v.dtype) for i, v in enumerate(values)]


def gather_columns(tree, mesh: ColumnMesh):
    """Every rank's column block of ``tree`` on rank 0, joined along the
    last axis in rank order (``host_local_columns``): the global tree on
    rank 0, None on the others.  Scalars are replicated and come from
    rank 0.  One ``gather`` over the mesh's group of the tree's leaves as
    bytes, so every leaf keeps its type and its bits (on a Gloo group
    through the host; NCCL gathers on the cards).  Every rank calls it
    with a tree of the same structure, shapes and types; each call adds
    one to the counter ``collectives.gather``."""
    leaves = []

    def collect(path, x):
        leaves.append(torch.as_tensor(x))
        return x

    tree_map(collect, tree)
    on = (mesh.device if tdist.get_backend(mesh.group) == "nccl"
          else torch.device("cpu"))
    if on.type == "cpu":
        leaves = [readback(x) for x in leaves]
    raw = [x.to(on).contiguous().reshape(-1).view(torch.uint8)
           for x in leaves]
    buf = torch.cat(raw) if raw else torch.empty(0, dtype=torch.uint8,
                                                 device=on)
    blocks = ([torch.empty_like(buf) for _ in range(mesh.world_size)]
              if mesh.rank == 0 else None)
    dst = 0 if mesh.group is None else tdist.get_global_rank(mesh.group, 0)
    tdist.gather(buf, blocks, dst=dst, group=mesh.group)
    count("collectives.gather")
    if mesh.rank != 0:
        return None
    parts = [b.split([r.numel() for r in raw]) for b in blocks]
    index = iter(range(len(leaves)))

    def join(path, _):
        i = next(index)
        x = leaves[i]
        # a copy per piece: a view of the buffer at another type needs an
        # aligned offset
        pieces = [p[i].clone().view(x.dtype).reshape(x.shape)
                  for p in parts]
        joined = pieces[0] if x.ndim == 0 else torch.cat(pieces, dim=-1)
        return joined.to(x.device)

    return tree_map(join, tree)



def make_sharded_step(mesh: ColumnMesh, params: ModelParams, dt: float, *,
                      compute_diags: bool = False, nsteps: int = 1,
                      interior_impl: str = "auto", health: bool = False,
                      local_diags=None):
    """The distributed step: this rank's column physics, then the global
    monitoring sums.

    Returns ``fn(state, grid, forcing) -> (state', global_diags)`` on
    this rank's block (:func:`shard_world`).  ``fn`` takes ``nsteps``
    steps, the first ``nsteps - 1`` of them with diagnostics off; each is
    ``models/coupled.py::step`` without an env cache, with
    ``interior_impl`` ("fused": K2 on every rank).  ``global_diags`` maps
    each GLOBAL_SUM_DIAGS name (``compute_diags``) to its sum over every
    column of every rank, and with ``health`` each HEALTH_DIAGS counter to
    its total over ranks (exact), all in one ``all_reduce``; a step with
    neither makes no collective.

    ``local_diags``: diagnostic names to return as this rank's column
    blocks (the history path: each rank writes its own block, no gather);
    the return becomes ``(state', global_diags, local)``.  A health
    counter named there is its global total.  Requires ``compute_diags``
    (a ValueError otherwise: without diagnostics there are none to
    select); the global sums are computed whatever the selection."""
    local_diags = tuple(local_diags) if local_diags is not None else None
    if local_diags is not None and not compute_diags:
        raise ValueError("local_diags requires compute_diags=True (with "
                         "compute_diags=False there are no diagnostics to "
                         "select; the health counters are in global_diags "
                         "with health=True)")
    if nsteps < 1:
        raise ValueError(f"nsteps={nsteps}: a sharded step takes at least "
                         f"one step")
    names = ((GLOBAL_SUM_DIAGS if compute_diags else ())
             + (HEALTH_DIAGS if health else ()))
    # the global sums must exist whatever the local selection
    dfilter = (local_diags + tuple(n for n in GLOBAL_SUM_DIAGS
                                   if n not in local_diags)
               if local_diags is not None else None)

    def fn(state, grid, forcing):
        for _ in range(nsteps - 1):
            state, _ = step(state, grid, forcing, params, dt,
                            compute_diags=False, interior_impl=interior_impl)
        new_state, diags = step(state, grid, forcing, params, dt,
                                compute_diags=compute_diags,
                                interior_impl=interior_impl, health=health,
                                diag_filter=dfilter)
        global_diags: Dict[str, torch.Tensor] = {}
        if names:
            local = [diags[n].sum() if n in GLOBAL_SUM_DIAGS else diags[n]
                     for n in names]
            global_diags = dict(zip(names, all_reduce_sum(local, mesh)))
        if local_diags is not None:
            # a health counter is a scalar per rank: its local value is
            # the global total (as the JAX package resolves it)
            return (new_state, global_diags,
                    {n: global_diags[n] if n in HEALTH_DIAGS and health
                     else diags[n] for n in local_diags})
        return new_state, global_diags

    return fn


def make_sharded_forced_run(mesh: ColumnMesh, params: ModelParams,
                            dt: float, nsteps: int, record_dt: float, *,
                            interp: str = "linear",
                            env_mode: str = "auto"):
    """Distributed time-varying-forcing integration: this rank's block
    through ``models/forcing_series.py::run_forced``.  The forcing series
    shards like a snapshot (columns last; :func:`shard_columns` with the
    world's width), so the interpolation and the per-record env tables
    stay on each rank: no collective.  Returns ``fn(state, grid, series)
    -> state'``."""
    from ocean_bgc_tpu_torch.models.forcing_series import run_forced

    def fn(state, grid, series):
        final, _ = run_forced(state, grid, series, params, dt, nsteps,
                              record_dt, interp=interp, env_mode=env_mode)
        return final

    return fn

