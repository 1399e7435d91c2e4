"""Multi-process initialization and data placement on ``torch.distributed``.

Counterpart of ``ocean_bgc_tpu/parallel/distributed.py``.  The reference's
host model distributes columns across MPI ranks; here each rank is one
process with one device, and holds one contiguous block of the columns,
in rank order (:func:`host_local_columns`).  Columns never communicate,
so a rank needs only its block: a caller may build or load just that
block and place it (:func:`host_local_to_global`), or build the whole
world and slice it (``parallel/sharding.py::shard_world``, as
``run_model --sharded`` does).  The one collective of a step with
diagnostics is the stacked ``all_reduce`` of the global sums
(``parallel/sharding.py``).

Typical use, launched as ``python -m torch.distributed.run
--nproc_per_node N script.py``::

    from ocean_bgc_tpu_torch.parallel import distributed as dist
    dist.initialize()                 # once per process
    mesh = dist.global_mesh()
    lo, hi = dist.host_local_columns(total_columns, mesh)
    # build or load this rank's columns [lo:hi), then:
    state = dist.host_local_to_global(local_state, mesh, total_columns)

Without a launcher, :func:`initialize` forms a one-rank group.  The
backend is NCCL on CUDA (one card per rank) and Gloo on the CPU; Gloo
also takes CUDA tensors, so Gloo ranks may share a card.  A failure
raises: there is no fallback to another backend or device.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as tdist

from ocean_bgc_tpu_torch.utils.bridge import resolve_device
from ocean_bgc_tpu_torch.utils.tree import tree_map

# this process's device, set by initialize()
_device: Optional[torch.device] = None


@dataclasses.dataclass(frozen=True)
class ColumnMesh:
    """The 1-D columns mesh seen from one rank: its rank, the number of
    ranks, its device and its process group (None: the default group).
    Rank r holds the r-th contiguous block of the columns."""

    rank: int
    world_size: int
    device: torch.device
    group: Optional[object] = None


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None, device=None) -> None:
    """Join (or form) the process group, once per process.

    The arguments default to the launcher's environment
    (``torch.distributed.run`` sets ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and ``MASTER_ADDR``); without
    one, this process forms a one-rank group on a free local port.
    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of
    rank 0.  ``device`` defaults to ``cuda:<local rank>``; pass "cpu" to
    run on the CPU.  ``backend`` defaults to "nccl" on CUDA and "gloo"
    on the CPU.  NCCL takes one card per rank: more ranks on this host
    than cards, or a device other than ``cuda:<local rank>``, raises.
    Every failure of the rendezvous raises."""
    global _device
    if tdist.is_initialized():
        raise RuntimeError("torch.distributed is already initialised in "
                           "this process")
    env = os.environ
    launched = "RANK" in env and "WORLD_SIZE" in env
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"]) if launched else 1
    if process_id is None:
        process_id = int(env["RANK"]) if launched else 0
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not a rank of "
                         f"{num_processes} processes")
    local_rank = int(env.get("LOCAL_RANK", process_id))
    if device is None:
        device = f"cuda:{local_rank}"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        on_host = int(env.get("LOCAL_WORLD_SIZE", num_processes))
        cards = torch.cuda.device_count()
        if on_host > cards:
            raise ValueError(f"NCCL needs a card per rank: {on_host} ranks "
                             f"on this host, {cards} cards")
        if dev != torch.device("cuda", local_rank):
            raise ValueError(f"NCCL places rank {process_id} (local rank "
                             f"{local_rank}) on cuda:{local_rank}, not on "
                             f"{dev}")
    if coordinator_address is not None:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    elif launched and "MASTER_ADDR" in env:
        init = "env://"
    elif num_processes == 1:
        init = f"tcp://localhost:{_free_port()}"
    else:
        raise ValueError(f"{num_processes} processes need a "
                         f"coordinator_address or a launcher's environment")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tdist.init_process_group(backend, init_method=init,
                             world_size=num_processes, rank=process_id)
    _device = dev


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    global _device
    if tdist.is_initialized():
        tdist.destroy_process_group()
    _device = None


def global_mesh() -> ColumnMesh:
    """This rank's view of the columns mesh over every rank of the
    default group; :func:`initialize` first."""
    if not tdist.is_initialized() or _device is None:
        raise RuntimeError("call ocean_bgc_tpu_torch.parallel.distributed."
                           "initialize() first")
    return ColumnMesh(rank=tdist.get_rank(),
                      world_size=tdist.get_world_size(), device=_device)


def host_local_columns(total_columns: int, mesh: ColumnMesh
                       ) -> Tuple[int, int]:
    """The [lo, hi) slice of the global column axis this rank holds
    (columns are block-distributed in rank order)."""
    per = total_columns // mesh.world_size
    if per * mesh.world_size != total_columns:
        raise ValueError(f"total_columns={total_columns} must divide into "
                         f"the {mesh.world_size} ranks")
    return mesh.rank * per, (mesh.rank + 1) * per


def host_local_to_global(local_tree, mesh: ColumnMesh, total_columns: int):
    """This rank's share of a global pytree, from its column block.

    A torch rank holds its block, not a global array: this checks that
    every leaf with a column axis is ``host_local_columns``' width wide on
    its last axis (a ValueError names the leaf that is not) and places
    every leaf on the rank's device.  Scalars pass as replicated."""
    lo, hi = host_local_columns(total_columns, mesh)

    def place(path, x):
        x = torch.as_tensor(x)
        if x.ndim and x.shape[-1] != hi - lo:
            raise ValueError(f"{path or 'leaf'}: {x.shape[-1]} columns, but "
                             f"rank {mesh.rank} holds {hi - lo} of "
                             f"{total_columns}")
        return x.to(mesh.device)

    return tree_map(place, local_tree)
