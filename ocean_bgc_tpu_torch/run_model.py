"""The model runner (``python -m ocean_bgc_tpu_torch.run_model``).

Counterpart of ``ocean_bgc_tpu/run_model.py``, with its flags and its
closing JSON summary line: config from TOML, a synthetic or NetCDF world,
an optional forcing series, optional checkpointed initial state, stepping
(forward Euler, RK2 or RK4), periodic checkpoints and time-averaged
history, and a summary with throughput and the carbon conservation
residual.  Runs on the CUDA device unless ``--device cpu``.

``--sharded`` splits the columns over the ranks of a
``torch.distributed`` group, one contiguous block per rank
(``parallel/``): launched as ``python -m torch.distributed.run
--nproc_per_node N -m ocean_bgc_tpu_torch.run_model --sharded ...`` (NCCL
on CUDA, one card per rank; Gloo with ``--device cpu``), or without a
launcher as one rank.  Each rank steps its block with no collective and
writes its history and checkpoint shards (``hist_<step>/hist_p<rank>.npz``,
``ck_<step>/ck_p<rank>.npz``); ``--restore`` reads shards written at any
rank count, or a single file.  ``--netcdf-history`` and ``--save-world``
write one file of every column: the ranks' blocks are gathered to rank 0
(``parallel/sharding.py::gather_columns``), which alone writes it.  Rank
0 prints the summary, reduced over ranks.

Examples::

    python -m ocean_bgc_tpu_torch.run_model --steps 240 --ncol 4096
    python -m ocean_bgc_tpu_torch.run_model --config run.toml --steps 480 \\
        --restore ck_000240 --checkpoint-every 240 --out /tmp/run1
    python -m ocean_bgc_tpu_torch.run_model --world w.nc \\
        --forcing-series s.nc --interp hold --solver-seed --steps 24 \\
        --history-every 12 --checkpoint-every 12 --health
    python -m torch.distributed.run --nproc_per_node 4 \\
        -m ocean_bgc_tpu_torch.run_model --sharded --ncol 32768 --steps 24
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ocean_bgc_tpu_torch.run_model",
        description="Run the coupled BGC+DMS+MACROS column model.")
    p.add_argument("--config", help="TOML parameter overrides")
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--dt", type=float, default=3600.0,
                   help="timestep (s), default 1 h")
    p.add_argument("--nlev", type=int, default=60)
    p.add_argument("--ncol", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--integrator", choices=("euler", "rk2", "rk4"),
                   default="euler")
    p.add_argument("--sharded", action="store_true",
                   help="split the columns over the ranks of a "
                        "torch.distributed group (launch under python -m "
                        "torch.distributed.run; without a launcher, one "
                        "rank)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' "
                        "runs the kernels' plain versions)")
    p.add_argument("--restore", help="checkpoint path to resume from")
    p.add_argument("--out", default=".",
                   help="output directory for checkpoints/history")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="steps between checkpoints (0 = only final)")
    p.add_argument("--history-every", type=int, default=0,
                   help="steps between history writes (0 = none)")
    p.add_argument("--history-fields",
                   help="comma-separated diagnostic names to emit "
                        "(default: all ~150); the others are still "
                        "computed, then dropped")
    p.add_argument("--fp32", action="store_true",
                   help="opt-in single-precision fast path")
    p.add_argument("--world",
                   help="NetCDF world file (io.model_io.save_world "
                        "layout) supplying grid/forcing/initial state "
                        "instead of the synthetic generator")
    p.add_argument("--save-world",
                   help="write the final grid/forcing/state as a "
                        "NetCDF world file")
    p.add_argument("--forcing-series",
                   help="NetCDF forcing series (leading time axis; see "
                        "models/forcing_series.save_forcing_series) — "
                        "interpolated per step instead of held forcing")
    p.add_argument("--interp", choices=("linear", "hold"),
                   default="linear",
                   help="forcing-series interpolation mode")
    p.add_argument("--no-env-cache", action="store_true",
                   help="recompute the coefficient tables every step "
                        "(the reference's semantics) instead of "
                        "amortizing them per forcing snapshot/record")
    p.add_argument("--health", action="store_true",
                   help="accumulate pH-solver non-convergence and "
                        "poc_error counters into the summary")
    p.add_argument("--solver-seed", action="store_true",
                   help="opt into the previous-root pH-solver seed "
                        "(OBGC_X0_SEED=1): fewer solver iterations; root "
                        "equal to solver tolerance but not the reference "
                        "iterate sequence (qualified, "
                        "tests/test_x0_seed_trajectory.py)")
    p.add_argument("--netcdf-history", action="store_true",
                   help="write history as NetCDF instead of npz")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.history_fields and not args.history_every > 0:
        raise SystemExit("--history-fields requires --history-every N "
                         "(without history output there are no "
                         "diagnostics to select)")
    # the solver reads the flag at every call (ops/carbonate.py::
    # x0_seed_enabled); set it for this run only
    before = os.environ.get("OBGC_X0_SEED")
    if args.solver_seed:
        os.environ["OBGC_X0_SEED"] = "1"
    own_group = False
    try:
        if args.sharded:
            import torch.distributed as tdist

            from ocean_bgc_tpu_torch.parallel import distributed as dist
            if not tdist.is_initialized():
                # the launcher's environment, or one rank
                dist.initialize(device=None if args.device == "cuda"
                                else args.device)
                own_group = True
        return _run(args)
    finally:
        if own_group:
            dist.shutdown()
        if args.solver_seed:
            if before is None:
                os.environ.pop("OBGC_X0_SEED", None)
            else:
                os.environ["OBGC_X0_SEED"] = before


def _run(args) -> int:
    import numpy as np
    import torch

    from ocean_bgc_tpu_torch.models import integrators
    from ocean_bgc_tpu_torch.models.coupled import step
    from ocean_bgc_tpu_torch.ops.bgc import precompute_env
    from ocean_bgc_tpu_torch.params import ModelParams
    from ocean_bgc_tpu_torch.utils import checkpoint as ckpt
    from ocean_bgc_tpu_torch.utils.bridge import resolve_device
    from ocean_bgc_tpu_torch.utils.history import TavgState, write_history
    from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world

    mesh = None
    if args.sharded:
        import torch.distributed as tdist

        from ocean_bgc_tpu_torch.parallel.distributed import global_mesh
        from ocean_bgc_tpu_torch.parallel.sharding import (
            all_reduce_sum,
            gather_columns,
            shard_columns,
            shard_world,
        )
        from ocean_bgc_tpu_torch.utils.history import write_history_shards
        mesh = global_mesh()
        device = mesh.device
        if mesh.rank != 0:
            args.quiet = True
    else:
        device = resolve_device(args.device)
    params = ModelParams()
    if args.config:
        from ocean_bgc_tpu_torch.utils.config import params_from_toml
        params = params_from_toml(args.config)

    dtype = torch.float32 if args.fp32 else torch.float64
    if args.world:
        from ocean_bgc_tpu_torch.io.model_io import load_world
        state, grid, forcing = load_world(
            args.world, dtype=dtype if args.fp32 else None, device=device)
        if not args.quiet:
            print(f"world <- {args.world} "
                  f"({state.bgc.nlev} levels x {state.bgc.ncol} columns)")
    else:
        state, grid, forcing = synthetic_world(
            nlev=args.nlev, ncol=args.ncol, seed=args.seed, dtype=dtype,
            device=device)
    total_columns = state.bgc.ncol
    if mesh is not None:
        state, grid, forcing = shard_world(state, grid, forcing, mesh)
        if not args.quiet:
            print(f"sharded over {mesh.world_size} rank(s), "
                  f"{state.bgc.ncol} columns each")

    start_step = 0
    if args.restore:
        state, n = ckpt.restore(args.restore, device=device, mesh=mesh)
        held = state.bgc.tracers.dtype
        if held != dtype:
            raise SystemExit(f"{args.restore} holds {held} tracers, but this "
                             f"run is {dtype} (--fp32 selects float32)")
        start_step = n or 0
        if not args.quiet:
            print(f"resumed from {args.restore} at step {start_step}")

    step_impl = integrators.INTEGRATORS[args.integrator] or step
    want_diags = args.history_every > 0

    series = record_dt = None
    if args.forcing_series:
        from ocean_bgc_tpu_torch.models.forcing_series import (
            forcing_at, forcing_record, load_forcing_series, num_records)
        series, record_dt = load_forcing_series(
            args.forcing_series, dtype=dtype if args.fp32 else None,
            device=device)
        nrec = num_records(series)
        if mesh is not None:
            series = shard_columns(series, mesh, total_columns)
        if not args.quiet:
            print(f"forcing series <- {args.forcing_series} "
                  f"({nrec} records, {record_dt:.0f} s apart, "
                  f"{args.interp})")

    # env cache: constant forcing -> build once; series + hold -> rebuild
    # at record boundaries (exact); series + linear -> recompute per step
    use_env = not args.no_env_cache
    dfilter = (tuple(x for x in args.history_fields.split(",") if x)
               if args.history_fields else None)

    def advance(s, f, env):
        return step_impl(s, grid, f, params, args.dt,
                         compute_diags=want_diags, env=env,
                         health=args.health, diag_filter=dfilter)

    os.makedirs(args.out, exist_ok=True)
    tavg = None
    env = (precompute_env(grid, forcing, params.bgc)
           if use_env and series is None else None)
    cur_rec = None
    forcing_now = forcing
    health_tot = {"health_solver_nonconverged_cells": 0.0,
                  "health_poc_error_cells": 0.0}
    t0 = time.perf_counter()
    for i in range(start_step, start_step + args.steps):
        if series is not None:
            t = (i + 0.5) * args.dt / record_dt
            if args.interp == "hold":
                rec = int(np.clip(np.floor(t), 0, nrec - 1))
                forcing_now = forcing_record(series, rec)
                if use_env and rec != cur_rec:
                    env = precompute_env(grid, forcing_now, params.bgc)
                    cur_rec = rec
            else:
                forcing_now = forcing_at(series, t)
                env = None
        state, diags = advance(state, forcing_now, env)
        if args.health:
            for k in health_tot:
                health_tot[k] = health_tot[k] + diags[k]
        if want_diags:
            if tavg is None:
                tavg = TavgState.create(diags)
            tavg = tavg.accumulate(diags)
            if (i + 1) % args.history_every == 0:
                stem = os.path.join(args.out, f"hist_{i + 1:06d}")
                means = tavg.means()
                if mesh is not None:
                    # scalars (the health counters' means) are the ranks'
                    # totals: one all_reduce per history write
                    scalars = [k for k, v in means.items() if v.ndim == 0]
                    if scalars:
                        means.update(zip(scalars, all_reduce_sum(
                            [means[k] for k in scalars], mesh)))
                if args.netcdf_history:
                    from ocean_bgc_tpu_torch.io.model_io import (
                        save_history_netcdf)
                    if mesh is not None:
                        # one file of every column, written by rank 0
                        means = gather_columns(means, mesh)
                    path = None
                    if means is not None:
                        path = save_history_netcdf(
                            stem + ".nc", means, nlev=state.bgc.nlev,
                            ncol=total_columns, count=int(tavg.count),
                            attrs={"dt": args.dt, "step": np.int32(i + 1)})
                elif mesh is not None:
                    path = write_history_shards(stem, means, mesh=mesh)
                else:
                    path = write_history(
                        stem, tavg,
                        attrs={"dt": str(args.dt), "step": str(i + 1)})
                tavg = tavg.reset()
                if not args.quiet:
                    print(f"history -> {path}")
        if args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
            path = ckpt.save(os.path.join(args.out, f"ck_{i + 1:06d}"),
                             state, step=i + 1, mesh=mesh)
            if not args.quiet:
                print(f"checkpoint -> {path}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0

    final_ck = ckpt.save(os.path.join(args.out, "ck_final"), state,
                         step=start_step + args.steps, mesh=mesh)
    if args.save_world:
        from ocean_bgc_tpu_torch.io.model_io import save_world
        world = (state, grid, forcing)
        if mesh is not None:
            # one file of every column, written by rank 0
            world = gather_columns(world, mesh)
        if world is not None:
            save_world(args.save_world, *world,
                       attrs={"step": np.int32(start_step + args.steps)})
        if not args.quiet:
            print(f"world -> {args.save_world}")
    # the summary needs only the conservation residual
    _, final_diags = step(state, grid, forcing_now, params, args.dt,
                          compute_diags=True, diag_filter=("Jint_Ctot",))
    jint = final_diags["Jint_Ctot"].abs().max()
    finite = torch.isfinite(state.bgc.tracers).all()
    if mesh is not None:
        # the summary over ranks: the largest residual and elapsed time,
        # every block finite, the health totals summed
        worst = torch.stack([jint.to(torch.float64),
                             (~finite).to(torch.float64),
                             jint.new_full((), elapsed, dtype=torch.float64)])
        tdist.all_reduce(worst, op=tdist.ReduceOp.MAX, group=mesh.group)
        jint, finite, elapsed = worst[0], worst[1] == 0, float(worst[2])
        if args.health:
            health_tot = dict(zip(health_tot, all_reduce_sum(
                [torch.as_tensor(v, device=device).to(torch.float64)
                 for v in health_tot.values()], mesh)))
    summary = {
        "steps": args.steps,
        "columns": total_columns,
        "columns_per_s": round(total_columns * args.steps / elapsed, 1),
        "elapsed_s": round(elapsed, 2),
        "final_checkpoint": final_ck,
        "max_abs_Jint_Ctot": float(jint),
        "finite": bool(finite),
    }
    if args.health:
        summary.update({f"{k}_total": float(v)
                        for k, v in health_tot.items()})
    if mesh is None or mesh.rank == 0:
        print(json.dumps(summary))
    if mesh is not None:
        # every rank returns once rank 0's files are written
        tdist.barrier(group=mesh.group)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
