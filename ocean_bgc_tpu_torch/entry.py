"""Entry points for a driver: the flagship step as ``(fn, args)``, and a
multi-device dry run.

Counterpart of the JAX repository's ``__graft_entry__.py`` (``entry``,
``dryrun_multichip``)::

    python -m ocean_bgc_tpu_torch.entry                # one flagship step
    python -m ocean_bgc_tpu_torch.entry dryrun 4       # four ranks, cards
    python -m ocean_bgc_tpu_torch.entry dryrun 2 cpu   # Gloo on the CPU
"""

from __future__ import annotations

import sys


def entry(device=None):
    """``(fn, example_args)``: one coupled forward step (diagnostics off,
    no env cache: ``__graft_entry__.entry``'s call) on the flagship
    configuration, 60 levels x 256 columns of the synthetic world at
    float64, on the card unless ``device`` says otherwise."""
    from ocean_bgc_tpu_torch.models.coupled import step
    from ocean_bgc_tpu_torch.params import ModelParams
    from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world

    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=60, ncol=256, seed=7,
                                           device=device)

    def fn(state, grid, forcing):
        new_state, _ = step(state, grid, forcing, params, 3600.0,
                            compute_diags=False)
        return new_state

    return fn, (state, grid, forcing)


def rank_placement(rank: int, n: int, cards: int, device=None):
    """``(device, backend)`` of rank ``rank`` of :func:`dryrun_multichip`'s
    ``n``: on the cards unless ``device`` is "cpu" -- NCCL, one card per
    rank, where ``n`` cards exist, else Gloo ranks sharing the cards
    (rank r on ``cuda:<r % cards>``).  No card raises."""
    if device == "cpu":
        return "cpu", "gloo"
    if device not in (None, "cuda"):
        raise ValueError(f"device must be None, 'cuda' or 'cpu', not "
                         f"{device!r}")
    if cards == 0:
        raise RuntimeError(f"dryrun_multichip({n}) runs on the card and "
                           f"this host has none; pass device='cpu' for "
                           f"Gloo ranks on the CPU")
    if n <= cards:
        return f"cuda:{rank}", "nccl"
    return f"cuda:{rank % cards}", "gloo"


def _dryrun_rank(rank, n, address, device):
    """One rank of :func:`dryrun_multichip`: the whole model's
    communication pattern (the sharded step with diagnostics and health:
    one stacked ``all_reduce``) on a 6 x (8 n) world."""
    import torch

    from ocean_bgc_tpu_torch.parallel import (
        make_mesh,
        make_sharded_step,
        shard_world,
    )
    from ocean_bgc_tpu_torch.parallel import distributed as dist
    from ocean_bgc_tpu_torch.params import ModelParams
    from ocean_bgc_tpu_torch.utils.profiling import readback
    from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world

    dev, backend = rank_placement(rank, n, torch.cuda.device_count(), device)
    dist.initialize(address, n, rank, backend=backend, device=dev)
    try:
        mesh = make_mesh()
        state, grid, forcing = shard_world(
            *synthetic_world(nlev=6, ncol=8 * n, seed=9, device=mesh.device),
            mesh)
        fn = make_sharded_step(mesh, ModelParams(), 3600.0,
                               compute_diags=True, health=True)
        new_state, global_diags = fn(state, grid, forcing)
        assert bool(readback(new_state.bgc.tracers.isfinite().all()))
        assert float(readback(global_diags["photoC_TOT_zint"])) >= 0.0
        assert float(readback(
            global_diags["health_solver_nonconverged_cells"])) == 0.0
    finally:
        dist.shutdown()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run one sharded step with diagnostics and health on ``n_devices``
    ranks, each a spawned process, on the cards (:func:`rank_placement`:
    NCCL ranks where ``n_devices`` cards exist, else Gloo ranks sharing
    them); with ``device="cpu"``, Gloo ranks on the CPU.  Raises if there
    is no card and the CPU was not asked for, or if a rank fails."""
    import torch
    import torch.multiprocessing as mp

    from ocean_bgc_tpu_torch.parallel.distributed import _free_port

    # the parent's check, so that a host without a card raises here
    rank_placement(0, n_devices, torch.cuda.device_count(), device)
    address = f"localhost:{_free_port()}"
    mp.start_processes(_dryrun_rank, args=(n_devices, address, device),
                       nprocs=n_devices, join=True, start_method="spawn")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "dryrun":
        n = int(sys.argv[2]) if len(sys.argv) > 2 else 8
        dryrun_multichip(n, device=sys.argv[3] if len(sys.argv) > 3
                         else None)
        print(f"dryrun_multichip({n}): OK")
    else:
        from ocean_bgc_tpu_torch.utils.profiling import synchronize
        fn, args = entry()
        out = fn(*args)
        synchronize()
        print("entry(): ran OK")
