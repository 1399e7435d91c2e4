"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; there is no CPU fallback):

0. at the start, four child processes for the long-horizon gates
   (:func:`gate_child`; joined after phase 10, their runs overlapping the
   phases between): the NumPy oracle's 1000 steps of the deep ragged
   world (``tests/test_torch_deep_world.py``), the port's 1000 f64 steps
   of it on the card with its 1-ulp kicked copy as extra columns, then
   held to the oracle's under tests/test_trajectory.py's chaos
   yardstick, with the bottom-branch pin and the t=0 branch firing; and
   the f32 gates on the card (``tests/test_torch_fp32_*.py``): the
   envelope over 720 steps at 6 x 8 and the no-drift gate, the deep
   world's branches under f32, its 96-step envelope and the flush
   range audit, and (measured, not gated) the envelope of 32 f32 runs
   kicked in their last bits; and the fused interior's gates:
   ``scripts/qualify_fused.py``'s 96 f32 steps of its 60 x 256 ragged
   world (seed 5, no env cache) against the default interior within 30
   times the envelope of a (1 + 1.2e-7) kick + 1% of scale, and the deep
   world's 1000 f64 steps with the fused interior held to the oracle's
   as the default run is; each gate's worst mismatch over its bound
   and wall time are printed.  Every time the script prints (not the
   phases' wall times) is taken with these children paused, their queued
   work on the card finished first (:func:`gates_paused`);
1. build every CUDA kernel of the port from ``ocean_bgc_tpu_torch/csrc``
   (one ``nvcc`` each, all started together);
2. one f64 step of a small world against the scalar NumPy/SciPy oracle
   (``tests/oracle/coupled_ref.py``);
3. the default path, at f64 and f32 — ``synthetic_world(60, 8192,
   ragged)``, ``precompute_env`` once, 10 ``step``s with diagnostics off
   — with every kernel's launches counted (the dual K1 10, its bracket-in
   instance 10 for the surface pair, K2's two kernels 0) and no host
   synchronisation in a step (``torch.cuda.set_sync_debug_mode``; so
   too the fused step and the default call with health counters);
   tracers/DMS/MACROS bitwise equal between ``carbonate_impl="kernel"``
   and ``"torch"``, pH within the solver's tolerance; K1 against its
   plain version on cold and warm inputs (all 8 outputs bitwise equal);
   the bracket-in instance against its plain version on the surface pair
   and the stand-in (bitwise); then the single-point carbonate API and
   the bracket-in instance's statistics variant (:func:`point_phase`):
   ``co3_terms`` over the world's 491,520 cells from the cold [6, 9]
   window and from +/-0.2 around that solve's pH, and ``co2calc_surface``
   over its 8192 columns, each one launch and bitwise ``impl="torch"``,
   timed beside its bound; ``solve_htotal_stats`` on those lanes,
   unseeded and seeded (H bitwise, steps and converged flags the plain
   version's lane for lane, timed against the launch without statistics
   in turns, mean cold steps > 1.5 x warm); and, counted, the card's step
   distribution over ``scripts/ph_iter_stats.py``'s cases after 5 steps;
4. the fused path (``interior_impl="fused"``), at f64 and f32 on the
   same world: 10 steps with the launches counted (K2's solve kernel 10
   and its biology kernel 10, the dual K1 0, the bracket-in instance 10);
   K2 against its plain version on cold and warm inputs (pH bitwise
   equal, tendencies within 1e-10 (f64) / 3e-5 (f32) of each tracer's
   scale); 24 fused steps against 24 default steps within 30 times the
   default path's distance from a run of perturbed initial tracers
   (``scripts/qualify_fused.py``'s envelope);
5. the JAX package's default call, ``step(state, grid, forcing, params,
   dt)`` — diagnostics on, no env cache — at f64 and f32 on the same
   world: 10 steps with the launches counted (K1's constants kernel 10,
   the dual K1 10 on its constants, the bracket-in instance 10, K2 0),
   then 10 diags-on steps with the env cache (the dual K1 10, the
   constants kernel 0); the constants kernel against its plain version
   (all 17 outputs bitwise equal), with its registers, spills, SASS
   instruction mix, time and bound, and the coefficient-and-saturation
   route (the constants kernel, then the dual K1) against its plain
   version on cold, warm and off-window inputs (all 10 outputs bitwise
   equal), and the plain constants' device time (the eager evaluation
   the kernel replaces on the health and fused paths without an env cache);
   tracers and every diagnostic bitwise equal between
   ``carbonate_impl="kernel"`` and ``"torch"``, tracers bitwise equal with
   diagnostics on and off; the diagnostics' names those of the registry
   (``utils/diag.py``), every one finite; the default call with health
   counters timed;
6. the host-coupling API (``ocean_bgc_tpu_torch/host_api.py``), f64, on
   the same world written out as the host's NumPy arrays
   (``utils/bridge.py::host_arguments``): ``BGC_SourceSink`` and
   ``BGC_SurfaceFluxes`` cold and warm, ``DMS_SourceSink``,
   ``DMS_SurfaceFluxes``, ``MACROS_SourceSink``, each with a shuffled
   tracer order, ``BGC_SourceSink`` with ``diag_names``, and a seeded warm
   pair, with every launch counted (per ``BGC_SourceSink`` the constants
   kernel 1 and the dual K1 1, per ``BGC_SurfaceFluxes`` the bracket-in
   instance 1, DMS and MACROS none; the seeded pair the constants kernel,
   the seeded dual and the seeded bracket-in instance 1 each); the BGC
   pair bitwise ``bgc_source_sink`` (diagnostics on, no env cache) and
   ``bgc_surface_fluxes`` on the level-major world, and the plain route's
   values (pH within 2 xacc); the shuffled order and the filter bitwise
   the canonical run; the ``OBGC_CHECK_ENV=1`` staleness guard and
   ``checked_step`` raising; each call's wall, device, ingest, compute and
   egress times and K1's device time in a cold and a warm call;
7. the production driver and K1's seeded variants (``OBGC_X0_SEED=1``), at
   f64 and f32 on the same world: each seeded variant of K1 (the dual
   instance on the env cache's constants and on the constants kernel's,
   and the bracket-in instance) against its seeded plain version on
   cold, warm, off-window and mixed inputs (every output bitwise equal),
   the f32 dual instance at the parked-tail caps 0, 1, its default and
   MAXIT; its time in its default schedule, one lane per thread in the
   fastest blocks of a sweep of block sizes (and of caps, at f32 for the
   dual instance) and in 256-thread blocks, in turns, the step counts'
   quantiles beside each schedule's modelled lane-steps per problem, an
   empty kernel's launch as the floor, bound and iterations per warm
   problem beside the unseeded ones; then
   ``python -m ocean_bgc_tpu_torch.run_model`` through ``run_model.main``
   on the world written as a NetCDF world file and a 3-record forcing
   series (T +0, +0.5, -0.5 C, 8 h apart): 24 held-record steps with the
   seed, the 10-field history every 12 steps, checkpoints and health,
   with every launch counted (the seeded dual instance 25: 24 on the env
   cache's constants and 1 on the constants kernel's, the constants
   kernel 1, the seeded bracket-in instance 25, the unseeded bracket-in
   instance 3, the rest 0), and a resume from the step-12 checkpoint bitwise equal to it; at
   f64 also linear interpolation, RK2, RK4 and no env cache with their
   launches counted, the driver's columns/s under constant, held and
   interpolated forcing with and without the seed, ``run_forced`` with
   the env tables blended and held, and 24 seeded steps against 24
   unseeded ones inside tests/test_x0_seed_trajectory.py's envelope;
8. the adjoint (``models/adjoint.py``; :func:`adjoint_phase`): one
   reverse sweep of ``parameter_sensitivities`` over three parameters and
   8 steps with remat at 60 x 8192 f64, on the kernel route and on the
   plain route (equal within 1e-12), its kappa entry against central
   finite differences (2e-3), K1's launches in the sweep (the forward's
   and the recompute's), remat against no remat at 60 x 1024 (1e-12),
   the calibration twin experiment at 6 x 8 (PCref within 3%), the f32
   sweep, the seconds per forward and backward step, K1's backwards'
   share and the peak memory;
9. P, the probe (``ocean_bgc_tpu_torch/probe.py``), one launch on its
   path, against its plain version at the probe's 12 x 5 x 128 and at
   1, 12 and 60 levels by 1, 31, 33, 257 and 8192 columns (kmax over
   0..nlev), its launch shape (more than one block), and its time in
   each tile in turns beside the launch floor;
10. one f64 step of each path at 60 x 131072 columns (diagnostics off),
   and one step of that world streamed through the card in chunks of
   32768 columns (``models/chunked.py::step_chunked``) against the
   unchunked step (values differing: 0 required), with wall times and
   peak device memory;
11. numbers: columns/s of every step configuration (diagnostics off with
   each interior; diagnostics on without and with the env cache and with
   a 10-field ``diag_filter``), each kernel's time beside its plain
   version's and its bound, each kernel's registers and spills from the
   build log, and where each step's time goes (the default path's and
   the diags-on step's breakdowns at f64 only);
12. multi-device (``parallel/``; :func:`md_phase`), the 60 x 8192 ragged
   world at f64 and f32, each rank a child process: (a) one NCCL rank,
   (b) two Gloo ranks sharing cuda:0 — the sharded step with diagnostics,
   health and ``local_diags``, the sharded fused step and the f64 forced
   run, their history shards stitched and gated against the unsharded
   step here (the kernels' pH fields bitwise, every field within 1e-12 /
   1e-5 of its scale, the bitwise share printed, health totals exact,
   global sums within 1e-12 / 1e-5 of their budgets), each rank's
   launches equal to the unsharded step's and its collectives one per
   step with diagnostics, none otherwise, and the ranks' ms/step and
   ``all_reduce`` ms; (c) ``run_model --sharded`` under
   ``torch.distributed.run`` with one NCCL rank, its summary, checkpoint
   shards (restored whole and onto two ranks' blocks) and history shards
   against the same run unsharded here, bitwise, and a 2-step f64 run
   with ``--netcdf-history --save-world`` whose two files are the
   unsharded run's bytes; in (a) and (b) each rank's blocks of the f64
   step's local diagnostics and of its world gathered to rank 0
   (``parallel/sharding.py::gather_columns``), which alone writes the
   NetCDF history and the world file, bitwise those of the unsharded
   step; (d)
   ``entry.dryrun_multichip(2)`` with its default placement, on the card.

``python3 chip_smoke.py --gate NAME ...`` and ``--rank-worker CONFIG``
are its own child processes.  The line before the last is
``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

NLEV, NCOL, NCOL_BIG, DT = 60, 8192, 131072, 3600.0
# the column chunk of the chunked step of the big world
CHUNK = 32768
SEED = 17
# H100 SXM: HBM3 bandwidth and peak non-tensor-core rates (NVIDIA data
# sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float64: 34e12, torch.float32: 67e12}
# K1's arithmetic, counted from csrc/carbonate_dual.cu (each add, mul,
# div, compare, sqrt, exp or log one operation): one alkalinity residual
# with its slope, the residual alone, one Newton/bisection step besides
# the residual, one bracket growth besides its two residuals, and the
# fixed work of a cell (mass units) and of a scenario (bracket,
# iteration start, speciation)
OPS_TALK, OPS_TALK_FN, OPS_ITER, OPS_GROW = 124, 63, 22, 8
OPS_CELL, OPS_SCENARIO = 8, 7 + 4 + 18
# the bracket-in instance's work per lane besides its residuals and
# steps: the orientation and the iteration's start
OPS_BRACKET_LANE = 4
# the seeded variants' work besides the unseeded one's: per interior
# scenario the seed from the pH window (carbonate_solve.cuh::ph_seed: two
# adds, a multiply, a compare, the exp argument and the exp), per problem
# the seed's test and its clamp into the bracket (four compares)
OPS_SEED_WINDOW, OPS_SEED_CLAMP = 6, 5
# it reads dic, x1, x2 and writes H per lane, and reads ta, pt, sit and
# the 15 constants per shared element; its statistics variant also writes
# per lane the steps (int32) and the converged flag (one byte)
BRACKET_FIELDS_LANE, BRACKET_FIELDS_SHARED = 4, 18
STATS_BYTES_LANE = 4 + 1
# K1 reads 21 fields per cell and writes 8; of the 8 the production step
# (diagnostics off) reads only the two pH fields
K1_FIELDS_IN, K1_FIELDS_OUT, K1_FIELDS_OUT_READ = 21, 8, 2
# K2's arithmetic besides the pH solve, counted from
# csrc/interior_step.cu as K1's is (each group's expressions four times,
# selects not counted): kinetics 994, sinking 160, assembly 374, the
# level loop's clipping, scavenging and masking 164
OPS_K2_CELL = 994 + 160 + 374 + 164
# K2 solves as K1 does but writes pH only: one log10 in place of K1's
# speciation per scenario
OPS_K2_NO_SPECIATION = OPS_SCENARIO - 18 + 1
# P's arithmetic per cell besides its Newton steps (counted from
# csrc/probe_patterns.cu), and per Newton step
OPS_P_CELL, OPS_P_NEWTON = 27, 6
# carbonate_coeffs and co3_sat_vals per cell, counted from
# csrc/carbonate_coeffs.cuh as K1's arithmetic is: the 15 constants (13
# exp, 3 log, 2 sqrt among them), and the two saturation values besides
# the terms they share with the constants
OPS_COEFFS, OPS_SAT = 339, 68
# the constants kernel reads depth, T and S per cell and writes the 15
# constants, and the two saturation values besides when asked
COEFF_FIELDS_IN, COEFF_FIELDS_OUT = 3, 17
# the coefficient-and-saturation function (the TPU kernel's coeffs_in=
# False, with_sat=True variant) reads depth, T, S, the four tracers and
# the two previous pH fields per cell and writes 8 fields, 10 with the
# saturation values
SAT_FIELDS_IN, SAT_FIELDS_OUT = 9, 10
# the production history's 10 fields (scripts/bench_ragged_ab.py:50-52)
PROD_FILTER = ("pco2surf", "dpco2", "NITRIF", "DENITRIF", "POC_FLUX_IN",
               "photoC_TOT_zint", "tot_CaCO3_form_zint", "Jint_Ctot",
               "O2_ZMIN", "Chl_TOT_zint_100m")
# the trajectory gate (scripts/qualify_fused.py:57-76): steps, the
# relative perturbation of the initial tracers and the floor (times each
# tracer's scale) at each dtype
TRAJ_STEPS = 24
TRAJ_EPS_FLOOR = {torch.float64: (4e-16, 1e-12), torch.float32: (1.2e-7, 1e-2)}
# K2 against its plain version: tendencies to this share of each
# tracer's largest magnitude
K2_TOL = {torch.float64: 1e-10, torch.float32: 3e-5}
# a device sleep of ~10 ms at the H100's 1.98 GHz boost clock
SLEEP_CYCLES = 20_000_000


def log(*args):
    print(*args, flush=True)


# the gate children (process, path of its ready marker), paused while
# this process takes a time (their work would share the card and the
# host's cores)
GATE_CHILDREN = []
# how long a paused child may take to finish its queued work on the card
PAUSE_WAIT_S = 120
_paused_depth = 0


def _pause_self(signum, frame):
    """A gate child's SIGUSR1 handler: finish this process's queued work
    on the card, then stop (SIGSTOP) until the parent's SIGCONT."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    os.kill(os.getpid(), signal.SIGSTOP)


def _is_stopped(pid):
    with open(f"/proc/{pid}/stat") as f:
        return f.read().rsplit(")", 1)[1].split()[0] in ("T", "t")


@contextlib.contextmanager
def gates_paused():
    """Pause every running gate child for the duration and let them go on
    after.  A child that has installed :func:`_pause_self` (its ready
    marker exists) is asked to stop (SIGUSR1) and is waited for until it
    has stopped, so that nothing it queued on the card is left running;
    one that has not is still importing, has no work on the card, and is
    stopped at once.  Nested uses pause once."""
    global _paused_depth
    running = [] if _paused_depth else [
        p for p, _ in GATE_CHILDREN if p.poll() is None]
    for p, ready in GATE_CHILDREN:
        if p in running:
            os.kill(p.pid, signal.SIGUSR1 if os.path.exists(ready)
                    else signal.SIGSTOP)
    _paused_depth += 1
    try:
        t0 = time.perf_counter()
        for p in running:
            while p.poll() is None and not _is_stopped(p.pid):
                if time.perf_counter() - t0 > PAUSE_WAIT_S:
                    raise AssertionError(f"gate child {p.pid} did not stop "
                                         f"within {PAUSE_WAIT_S} s")
                time.sleep(0.002)
        yield
    finally:
        _paused_depth -= 1
        for p in running:
            if p.poll() is None:
                os.kill(p.pid, signal.SIGCONT)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2, rounds=5, device_only=False):
    """Median over ``rounds`` of the mean ms per call of ``fn`` over
    ``reps`` calls, by CUDA events, after ``warmup`` calls.

    ``device_only``: each round's calls are queued behind a device sleep
    of ~10 ms, so that the events time the device's work alone, not the
    host's launches (for ``fn`` that makes no host synchronisation)."""
    for _ in range(warmup):
        fn()
    times = []
    with gates_paused():
        for _ in range(rounds):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            if device_only:
                torch.cuda._sleep(SLEEP_CYCLES)
            t0.record()
            for _ in range(reps):
                fn()
            t1.record()
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1) / reps)
    return statistics.median(times)


# every kernel launch count, by its name here and in the port's counters
# (``utils/profiling.py``): K1's two instances unseeded and seeded, the
# bracket-in instance's statistics variant and K1's constants kernel,
# K2's two kernels
LAUNCH_COUNTERS = dict(
    k1="k1.dual", coeffs="k1.coeffs", brackets="k1.brackets",
    k1_seeded="k1.dual_seeded", brackets_seeded="k1.brackets_seeded",
    brackets_stats="k1.brackets_stats", k2_solve="k2.solve",
    k2_bio="k2.bio")
_COUNTS_AT_RESET = {}


def reset_counts():
    """Count every kernel's launches from 0 here on."""
    from ocean_bgc_tpu_torch.utils.profiling import counters
    _COUNTS_AT_RESET.clear()
    _COUNTS_AT_RESET.update(counters())


def read_counts():
    """Each kernel's launches since :func:`reset_counts`."""
    from ocean_bgc_tpu_torch.utils.profiling import counters
    now = counters()
    return {k: now[name] - _COUNTS_AT_RESET.get(name, 0)
            for k, name in LAUNCH_COUNTERS.items()}


def expected(**nonzero):
    """The launch counts of a run in which only ``nonzero`` launched."""
    return {k: nonzero.get(k, 0) for k in LAUNCH_COUNTERS}


def ptxas_lines(log_text):
    """One line per kernel entry of an ``nvcc -Xptxas -v`` log: its name
    (demangled where c++filt is found), registers, spill bytes and static
    shared memory."""
    rows, name, spill = [], None, ("?", "?")
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m[1]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (m[1], m[2])
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((name, m[1], *spill, smem[1] if smem else "0"))
            name, spill = None, ("?", "?")
    names = [r[0] for r in rows]
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and names:
        out = subprocess.run([cxxfilt], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0:
            names = out.stdout.splitlines()
    names = [n.replace("obgc::", "").replace("(anonymous namespace)::", "")
             .split("(")[0] for n in names]
    return [f"    {n}: {r[1]} registers, {r[2]} B spill stores, {r[3]} B "
            f"spill loads, {r[4]} B static shared memory"
            for n, r in zip(names, rows)]


def k1_inputs(state, grid, forcing, env):
    """K1's arguments as the step's bgc_source_sink gives them."""
    from ocean_bgc_tpu_torch.ops.bgc import carbonate_inputs
    return carbonate_inputs(state.bgc.tracers, grid, forcing,
                            state.bgc.ph_prev_3d, state.bgc.ph_prev_alt_3d,
                            env)


def solve_ops_of(args, cells=None, seed=False):
    """(operations, mean iterations per scenario) of K1's dual solve on
    these inputs, over ``cells`` (a mask; all cells if None), iteration
    counts from the plain version, which runs the same per-lane
    iteration; ``seed``: of the seeded variant."""
    from ocean_bgc_tpu_torch.ops.cuda_carbonate import (
        co3_terms_dual_coeffs_torch)
    *_, stats = co3_terms_dual_coeffs_torch(*args, with_stats=True,
                                            seed=seed)
    if cells is None:
        cells = torch.ones_like(args[0], dtype=torch.bool)
    n = int(cells.sum())
    ops = OPS_CELL * n
    per_scenario = OPS_SCENARIO + (OPS_SEED_WINDOW + OPS_SEED_CLAMP
                                   if seed else 0)
    for st in stats:
        iters = st["iters"].double()[cells]
        grows = st["grows"].double()[cells]
        ops += (n * (per_scenario + 2 * OPS_TALK_FN + OPS_TALK)
                + (grows * (OPS_GROW + 2 * OPS_TALK_FN)).sum().item()
                + (iters * OPS_ITER).sum().item()
                + ((iters - 1).clamp_min(0) * OPS_TALK).sum().item())
    return ops, [st["iters"].double()[cells].mean().item() for st in stats]


def bound(nbytes, ops, dtype):
    """(bound_ms, bound_by): the larger of ``nbytes`` over the HBM rate
    and ``ops`` over the peak rate of the type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_bound(args, dtype, seed=False):
    """(bound_ms, bound_by, bytes, operations, mean iterations, path
    bound_ms): the larger of K1's bytes over the HBM rate and of the
    operations these inputs need over the peak rate of the type.  The
    path bound counts only the outputs the step reads."""
    n = args[0].numel()
    ops, iters_mean = solve_ops_of(args, seed=seed)
    nbytes = (K1_FIELDS_IN + K1_FIELDS_OUT) * args[0].element_size() * n
    path_bytes = ((K1_FIELDS_IN + K1_FIELDS_OUT_READ)
                  * args[0].element_size() * n)
    path_ms = bound(path_bytes, ops, dtype)[0]
    return (*bound(nbytes, ops, dtype), nbytes, ops, iters_mean, path_ms)


def check_k1(dtype, world, env, warm_state):
    """Phase 2: K1 against its plain version on cold and warm inputs;
    returns the numbers measured on the warm (steady-state) ones.

    Tolerance: none, all 8 outputs must be bitwise equal.  The kernel
    runs each lane's iteration in the plain version's order, with its
    association order term by term, --fmad=false, IEEE division and the
    CUDA math library's exp/log10/sqrt, which PyTorch's CUDA ops also
    call; a difference means the kernel computes something else.  max
    |dH|/xacc (the solver's tolerance) is printed beside it."""
    from ocean_bgc_tpu_torch.ops.carbonate import solver_xacc
    from ocean_bgc_tpu_torch.ops.cuda_carbonate import (
        co3_terms_dual_coeffs as k1, co3_terms_dual_coeffs_torch as plain)
    state, grid, forcing = world
    xacc = solver_xacc(dtype)
    for label, st in (("cold", state), ("warm", warm_state)):
        args = k1_inputs(st, grid, forcing, env)
        got = k1(*args, impl="kernel")
        torch.cuda.synchronize()
        want = plain(*args)
        dh = max((10.0 ** -g[0].double() - 10.0 ** -w[0].double())
                 .abs().max().item() for g, w in zip(got, want))
        dph = max((g[0] - w[0]).abs().max().item()
                  for g, w in zip(got, want))
        # over all 8 outputs: pH and the three species in mmol/m^3
        err = max((x - y).abs().max().item()
                  for g, w in zip(got, want) for x, y in zip(g, w))
        finite = all(torch.isfinite(x).all().item() for g in got for x in g)
        log(f"K1 {dtype} {label}: max|dH|/xacc {dh / xacc:.3g}, max|dpH| "
            f"{dph:.3g}, max abs error over all 8 outputs {err:.3g} (limit "
            f"0, bitwise), finite {finite}")
        if not finite or err != 0.0:
            raise AssertionError(f"K1 {dtype} {label} disagrees with its "
                                 f"plain version")
    from ocean_bgc_tpu_torch.ops.cuda_carbonate import _launch
    call_ms = cuda_ms(lambda: k1(*args, impl="kernel"), reps=20)
    fields = (*args[:6], *args[6])
    ms = cuda_ms(lambda: _launch(fields, dtype), reps=20, device_only=True)
    log(f"K1 {dtype} warm: {call_ms:.4f} ms per call of the wrapper (its "
        f"host work included)")
    plain_ms = cuda_ms(lambda: plain(*args), reps=1, warmup=1, rounds=3)
    bound_ms, bound_by, nbytes, ops, iters, path_ms = k1_bound(args, dtype)
    log(f"K1 {dtype} warm: {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
        f"{ops / 1e9:.3f} Gop, mean iterations {iters[0]:.2f} / "
        f"{iters[1]:.2f}); bound of the {K1_FIELDS_IN} + "
        f"{K1_FIELDS_OUT_READ} fields the step needs {path_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def surface_lanes(state, forcing, seed=False):
    """The surface pair's solver arguments as co2calc_surface_dual builds
    them in a step from ``state``: lanes (2, ncol), the rest (ncol,);
    ``seed``: and the lanes' iteration seeds."""
    from ocean_bgc_tpu_torch import constants as c
    from ocean_bgc_tpu_torch.ops import carbonate as tc
    from ocean_bgc_tpu_torch.state import BGCTracers as T
    surf = state.bgc.tracers[0].clamp_min(0.0)
    coeffs = tc.carbonate_coeffs(forcing.surface_depth, forcing.sst,
                                 forcing.sss, False)
    da, ta, pt, sit = tc._to_mass_units(surf[T.DIC], surf[T.ALK],
                                        surf[T.PO4], surf[T.SIO3])
    db = tc._to_mass_units(surf[T.DIC_ALT_CO2], surf[T.ALK], surf[T.PO4],
                           surf[T.SIO3])[0]
    br = [tc.warm_brackets_h(ph, c.PHLO_SURF_INIT, c.PHHI_SURF_INIT,
                             c.DEL_PH, with_seed=seed)
          for ph in (state.bgc.surface_ph, state.bgc.surface_ph_alt)]
    return (coeffs, torch.stack([da, db]), ta, pt, sit,
            *(torch.stack([br[0][j], br[1][j]]) for j in range(len(br[0]))))


def standin_lanes(env):
    """precompute_env's stand-in solve: every cell, cold."""
    from ocean_bgc_tpu_torch import constants as c
    from ocean_bgc_tpu_torch.ops.carbonate import _to_mass_units
    full = torch.ones_like(env.standin_ph)
    m = _to_mass_units(2000.0 * full, 2300.0 * full, 0.0 * full,
                       0.0 * full)
    return (env.coeffs, *m, full * 10.0 ** -c.PHHI_3D_INIT,
            full * 10.0 ** -c.PHLO_3D_INIT)


def bracket_bound(args, dtype, stats=False):
    """(bound_ms, bound_by, bytes, operations, mean and most steps) of the
    bracket-in instance on these lanes (with an eighth argument, the
    seeds, of its seeded variant): each lane's and each shared element's
    fields once over the HBM rate, against the operations the plain
    version's per-lane counts need over the peak rate of the type.
    ``stats``: of its statistics variant, which also writes per lane its
    steps (4 B) and its converged flag (1 B)."""
    from ocean_bgc_tpu_torch.ops.carbonate import _solve_htotal_impl
    coeffs, dic, ta = args[0], args[1], args[2]
    seed = len(args) > 7
    _, st = _solve_htotal_impl(*args[:7], x0=args[7] if seed else None,
                               with_stats=True)
    iters, grows = st["iters"].double(), st["grows"].double()
    n = dic.numel()
    ops = (n * (2 * OPS_TALK_FN + OPS_BRACKET_LANE
                + (OPS_SEED_CLAMP if seed else 0))
           + (grows * (OPS_GROW + 2 * OPS_TALK_FN)).sum().item()
           + (iters * (OPS_ITER + OPS_TALK)).sum().item())
    # the seeded variant reads one field more per lane, its seed
    nbytes = (((BRACKET_FIELDS_LANE + seed) * n
               + BRACKET_FIELDS_SHARED * ta.numel()) * dic.element_size()
              + (STATS_BYTES_LANE * n if stats else 0))
    return (*bound(nbytes, ops, dtype), nbytes, ops, iters.mean().item(),
            iters.max().item())


def check_brackets(dtype, world, env, warm_state):
    """K1's bracket-in instance against its plain version
    (``_solve_htotal_impl``) on the surface pair of the cold and of the
    warm state and on the stand-in; returns the numbers measured on the
    warm surface pair.

    Tolerance: none, H bitwise equal (the same per-lane iteration in the
    same order, --fmad=false, IEEE division and sqrt)."""
    from ocean_bgc_tpu_torch.ops.carbonate import (
        _solve_htotal_impl as plain, co2calc_surface_dual)
    from ocean_bgc_tpu_torch.ops.cuda_carbonate import (
        _launch_brackets, solve_htotal_brackets as kb)
    from ocean_bgc_tpu_torch.state import BGCTracers as T
    state, grid, forcing = world
    cases = {"surface pair, cold": surface_lanes(state, forcing),
             "surface pair, warm": surface_lanes(warm_state, forcing),
             "stand-in": standin_lanes(env)}
    for label, args in cases.items():
        got = kb(*args, impl="kernel")
        torch.cuda.synchronize()
        want = plain(*args)
        err = (got - want).abs().max().item()
        ok = torch.equal(got, want) and bool(torch.isfinite(got).all())
        log(f"bracket-in K1 {dtype} {label} ({got.numel()} lanes): bitwise "
            f"equal to its plain version {ok}, max abs error {err:.3g} "
            f"(limit 0)")
        if not ok:
            raise AssertionError(f"the bracket-in K1 {dtype} {label} "
                                 f"disagrees with its plain version")
        if label == "surface pair, warm":
            warm_err = err
    args = cases["surface pair, warm"]
    fields = dict(dic=args[1], x1=args[5], x2=args[6], ta=args[2],
                  pt=args[3], sit=args[4], **args[0]._asdict())
    call_ms = cuda_ms(lambda: kb(*args, impl="kernel"), reps=20)
    ms = cuda_ms(lambda: _launch_brackets(fields), reps=20,
                 device_only=True)
    plain_ms = cuda_ms(lambda: plain(*args), reps=1, warmup=1, rounds=3)
    bound_ms, bound_by, nbytes, ops, mean_it, max_it = bracket_bound(
        args, dtype)
    surf = warm_state.bgc.tracers[0].clamp_min(0.0)

    def pair(impl):
        return co2calc_surface_dual(
            forcing.surface_depth, forcing.sst, forcing.sss, surf[T.DIC],
            surf[T.DIC_ALT_CO2], surf[T.ALK], surf[T.PO4], surf[T.SIO3],
            None, None, None, None, forcing.atm_co2, forcing.atm_co2_alt,
            forcing.surface_pressure, brackets_a=(args[5][0], args[6][0]),
            brackets_b=(args[5][1], args[6][1]), impl=impl)
    pair_ms = cuda_ms(lambda: pair("kernel"), reps=5, warmup=1, rounds=3)
    pair_plain_ms = cuda_ms(lambda: pair("torch"), reps=1, warmup=1,
                            rounds=3)
    sargs = cases["stand-in"]
    standin_ms = cuda_ms(lambda: kb(*sargs, impl="kernel"), reps=5,
                         device_only=True)
    standin_plain_ms = cuda_ms(lambda: plain(*sargs), reps=1, warmup=1,
                               rounds=3)
    log(f"bracket-in K1 {dtype}, surface pair ({NCOL} columns, warm): "
        f"{ms:.4f} ms/launch ({call_ms:.4f} per call of the wrapper), plain "
        f"{plain_ms:.3f} ms; bound {bound_ms:.2e} ms by "
        f"{bound_by} ({nbytes / 1e6:.3f} MB, {ops / 1e6:.3f} Mop, steps "
        f"mean {mean_it:.2f}, most {max_it:.0f}); co2calc_surface_dual "
        f"whole {pair_ms:.3f} ms on the kernel, {pair_plain_ms:.3f} ms "
        f"plain; stand-in ({NLEV * NCOL} lanes, cold) {standin_ms:.4f} ms, "
        f"plain {standin_plain_ms:.3f} ms")
    return dict(max_abs_err=warm_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# the single-point API's warm window, +/- this around the cold solve's pH
# (tests/test_solver_stats.py's protocol), and the steps of the f32 tail
# whose share of lanes the step distribution reports
POINT_WARM_DEL = 0.2
TAIL_STEPS = (14, 24)


def point_inputs(world):
    """The single-point API's arguments on the whole world: per cell depth
    (m), T, S and DIC, ALK, PO4, SiO3 clamped at 0 (as a step reads them)
    and the pressure gate below the first level; per column the
    surface's, then the atmosphere's xCO2 and pressure."""
    from ocean_bgc_tpu_torch.state import BGCTracers as T
    state, grid, forcing = world
    trc = state.bgc.tracers.clamp_min(0.0)
    tracers = [trc[:, i].contiguous() for i in (T.DIC, T.ALK, T.PO4,
                                                 T.SIO3)]
    depth = grid.cell_center_depth * 0.01
    press = (torch.arange(depth.shape[0], device=depth.device)
             > 0)[:, None].expand(depth.shape)
    return ((depth, forcing.potential_temperature, forcing.salinity,
             *tracers), press,
            (forcing.surface_depth, forcing.sst, forcing.sss,
             *(t[0] for t in tracers)),
            (forcing.atm_co2, forcing.surface_pressure))


def bracket_fields(lanes, seed=None):
    """The bracket-in instance's fields (``_launch_brackets``) of solver
    arguments ``(coeffs, dic, ta, pt, sit, x1, x2)``, seeded where
    ``seed`` is given."""
    coeffs, dic, ta, pt, sit, x1, x2 = lanes
    fields = dict(dic=dic, x1=x1, x2=x2, ta=ta, pt=pt, sit=sit,
                  **coeffs._asdict())
    if seed is not None:
        fields["x0"] = seed
    return fields


def lane_stats(iters, conv, mask=None):
    """The steps' mean, p50, p90, p99 and max, the converged share and the
    share of lanes taking TAIL_STEPS steps, over the lanes of ``mask``
    (all where None)."""
    if mask is not None:
        iters, conv = iters[mask], conv[mask]
    it = iters.double().reshape(-1)
    q = torch.quantile(it, torch.tensor([0.5, 0.9, 0.99], dtype=it.dtype,
                                        device=it.device)).tolist()
    lo, hi = TAIL_STEPS
    return dict(lanes=it.numel(), mean=it.mean().item(), p50=q[0],
                p90=q[1], p99=q[2], max=it.max().item(),
                converged=conv.double().mean().item(),
                tail=((it >= lo) & (it <= hi)).double().mean().item())


def stats_text(st):
    return (f"{st['lanes']} lanes: mean {st['mean']:.3f}, p50 "
            f"{st['p50']:.0f}, p90 {st['p90']:.0f}, p99 {st['p99']:.0f}, "
            f"max {st['max']:.0f}, converged {st['converged']:.6f}, "
            f"{TAIL_STEPS[0]}-{TAIL_STEPS[1]} steps {st['tail']:.4f}")


def point_phase(dtype, ctx):
    """Phase 3b at one dtype: the single-point carbonate API and the
    bracket-in instance's statistics variant; returns the statistics
    variant's numbers for the JSON line.

    (a) ``co3_terms`` over every cell of the world, from the cold [6, 9]
    window and from a +/-0.2 window around that solve's pH, and
    ``co2calc_surface`` over the surface columns from the cold surface
    window: each call one launch of the bracket-in instance and every
    output bitwise ``impl="torch"`` on the same tensors (tolerance none:
    the kernel is the plain version's per-lane iteration), its ms per
    launch behind the device sleep beside its bound and the plain
    version's ms.  (b) ``solve_htotal_stats`` on those lanes, unseeded
    and seeded at the cold roots: H bitwise the launch without
    statistics and the plain version, the steps and converged flags equal
    to the plain version's lane for lane, its time against the launch
    without statistics in turns; JAX's warm-start criterion (mean cold
    steps > 1.5 x mean warm); then, counted, the card's step distribution
    over ``scripts/ph_iter_stats.py``'s cases after 5 steps (the
    interior's two scenarios as ``bgc_source_sink`` forms them and the
    same cells cold, active and inactive cells apart, and the surface
    pair), each held to the plain version's counts."""
    from ocean_bgc_tpu_torch import constants as c
    from ocean_bgc_tpu_torch.ops import carbonate as tc
    from ocean_bgc_tpu_torch.ops.cuda_carbonate import (_launch_brackets,
                                                        _ph_brackets)
    t0 = time.perf_counter()
    world, env = ctx["world"], ctx["env"]
    interior, press, surface, (xco2, atm) = point_inputs(world)
    cold = (torch.full_like(interior[0], c.PHLO_3D_INIT),
            torch.full_like(interior[0], c.PHHI_3D_INIT))
    surf_cold = (torch.full_like(surface[0], c.PHLO_SURF_INIT),
                 torch.full_like(surface[0], c.PHHI_SURF_INIT))
    icoeffs = tc.carbonate_coeffs(*interior[:3], press)
    scoeffs = tc.carbonate_coeffs(*surface[:3], False)

    # -- (a) each call counted, bitwise, timed --
    def point_call(label, fn, args, coeffs, tracers, window):
        reset_counts()
        got = fn(*args, impl="kernel")
        torch.cuda.synchronize()
        counts = read_counts()
        want = fn(*args, impl="torch")
        compare(f"{label} {dtype}, kernel vs plain", got, want)
        if counts != expected(brackets=1):
            raise AssertionError(f"{label} {dtype}: launches {counts}, "
                                 f"expected the bracket-in instance 1")
        lanes = tc.htotal_lanes(coeffs, *tracers, *window)
        fields = bracket_fields(lanes)
        ms = cuda_ms(lambda: _launch_brackets(fields), reps=20,
                     device_only=True)
        plain_ms = cuda_ms(lambda: tc._solve_htotal_impl(*lanes), reps=1,
                           warmup=1, rounds=3)
        bound_ms, bound_by, nbytes, ops, mean_it, max_it = bracket_bound(
            lanes, dtype)
        n = lanes[1].numel()
        floor = cuda_ms(empty_launch(-(-n // 256), 256), reps=20,
                        device_only=True)
        log(f"{label} {dtype} ({n} lanes): launches {counts['brackets']}, "
            f"{ms:.4f} ms/launch, plain {plain_ms:.3f} ms; bound "
            f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
            f"{ops / 1e6:.3f} Mop, steps mean {mean_it:.2f}, most "
            f"{max_it:.0f}); launch floor {floor:.4f} ms")
        return got, lanes

    got, cold_lanes = point_call("co3_terms, cold window", tc.co3_terms,
                                 (*interior, *cold, press), icoeffs,
                                 interior[3:], cold)
    ph = got[0]
    warm = (ph - POINT_WARM_DEL, ph + POINT_WARM_DEL)
    _, warm_lanes = point_call(
        f"co3_terms, +/-{POINT_WARM_DEL} window", tc.co3_terms,
        (*interior, *warm, press), icoeffs, interior[3:], warm)
    point_call("co2calc_surface, cold window", tc.co2calc_surface,
               (*surface, *surf_cold, xco2, atm), scoeffs, surface[3:],
               surf_cold)

    # -- (b) the statistics variant on the same lanes --
    def held(label, lanes, seed=None):
        """solve_htotal_stats on ``lanes``, held to the launch without
        statistics and to the plain version; its outputs."""
        h, it, cv = tc.solve_htotal_stats(*lanes, x0=seed)
        torch.cuda.synchronize()
        bare = _launch_brackets(bracket_fields(lanes, seed))
        want, st = tc._solve_htotal_impl(*lanes, with_stats=True, x0=seed)
        same = (torch.equal(h, bare), torch.equal(h, want),
                torch.equal(it, st["iters"]),
                torch.equal(cv, st["converged"]))
        log(f"statistics variant {dtype} {label} ({h.numel()} lanes): H "
            f"bitwise the launch without statistics {same[0]} and the "
            f"plain version {same[1]}; steps equal lane for lane {same[2]}, "
            f"converged flags {same[3]}")
        if not all(same):
            raise AssertionError(f"the statistics variant {dtype} {label} "
                                 f"disagrees")
        return h, it, cv

    h_cold, it_cold, _ = held("cold window", cold_lanes)
    _, it_warm, _ = held(f"+/-{POINT_WARM_DEL} window", warm_lanes)
    _, it_seed, _ = held(f"+/-{POINT_WARM_DEL} window, seeded at the cold "
                         f"roots", warm_lanes, h_cold)
    means = [x.double().mean().item() for x in (it_cold, it_warm, it_seed)]
    log(f"statistics variant {dtype}: mean steps cold {means[0]:.3f}, warm "
        f"{means[1]:.3f}, seeded {means[2]:.3f}; JAX's warm-start criterion "
        f"cold > 1.5 x warm: {means[0] > 1.5 * means[1]}")
    if not means[0] > 1.5 * means[1]:
        raise AssertionError(f"warm starts do not cut the steps: {means}")
    times = {}
    for label, seed in (("warm", None), ("seeded", h_cold)):
        fields = bracket_fields(warm_lanes, seed)
        times[label] = in_turns(
            f"statistics variant {dtype} {label}, {warm_lanes[1].numel()} "
            f"lanes", {"with statistics": lambda f=fields: _launch_brackets(
                f, with_stats=True),
                       "without": lambda f=fields: _launch_brackets(f)})
    plain_ms = cuda_ms(lambda: tc._solve_htotal_impl(
        *warm_lanes, with_stats=True), reps=1, warmup=1, rounds=3)
    bound_ms, bound_by, nbytes, ops, _, _ = bracket_bound(warm_lanes, dtype,
                                                          stats=True)
    log(f"statistics variant {dtype} warm: "
        f"{times['warm']['with statistics']:.4f} ms/launch (without "
        f"{times['warm']['without']:.4f}), seeded "
        f"{times['seeded']['with statistics']:.4f} (without "
        f"{times['seeded']['without']:.4f}); plain {plain_ms:.3f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
        f"{ops / 1e6:.3f} Mop)")

    # -- the card's step distribution, counted --
    state, grid, forcing = world
    state5 = ctx["after"][4]
    dic, ta, pt, sit, ph_a, ph_b, coeffs = k1_inputs(state5, grid, forcing,
                                                     env)
    mass = tc._to_mass_units(dic, ta, pt, sit)
    cases = {name: (coeffs, *mass, *_ph_brackets(p)) for name, p in (
        ("interior ambient", ph_a), ("interior ALT_CO2", ph_b),
        ("interior cold", torch.zeros_like(ph_a)))}
    cases["surface pair"] = surface_lanes(state5, forcing)
    reset_counts()
    with gates_paused():
        out = {name: tc.solve_htotal_stats(*lanes)
               for name, lanes in cases.items()}
        torch.cuda.synchronize()
    counts = read_counts()
    if counts != expected(brackets_stats=len(cases)):
        raise AssertionError(f"the step distribution's launches {counts}, "
                             f"expected the statistics variant "
                             f"{len(cases)}")
    active = grid.active_mask()
    ocean = (grid.kmax > 0).expand(cases["surface pair"][1].shape)
    for name, lanes in cases.items():
        h, it, cv = out[name]
        want, st = tc._solve_htotal_impl(*lanes, with_stats=True)
        if not (torch.equal(h, want) and torch.equal(it, st["iters"])
                and torch.equal(cv, st["converged"])):
            raise AssertionError(f"the statistics variant {dtype} {name} "
                                 f"disagrees with its plain version")
        parts = ((("all", None), ("active", active), ("inactive", ~active))
                 if name.startswith("interior") else
                 (("all", None), ("ocean", ocean), ("land", ~ocean)))
        for part, mask in parts:
            if mask is None or mask.any():
                log(f"step distribution {dtype} (card), {name} after 5 "
                    f"steps, {part}, {stats_text(lane_stats(it, cv, mask))}")
    log(f"point phase {dtype}: launches {counts}; "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(launches=counts["brackets_stats"], max_abs_err=0.0,
                ms=times["warm"]["with statistics"], plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def breakdown(dtype, state, grid, forcing, params, env, step_ms):
    """Where one step's time goes: each part of the step called alone on
    the step's inputs (CUDA events, median of 3 single calls), and the
    device's busy share of a step (``step_ms``) from the profiler."""
    from ocean_bgc_tpu_torch import constants
    from ocean_bgc_tpu_torch.models import coupled
    from ocean_bgc_tpu_torch.ops import bgc, surface
    from ocean_bgc_tpu_torch.ops.cuda_carbonate import co3_terms_dual_coeffs
    from ocean_bgc_tpu_torch.ops.dms import dms_source_sink
    from ocean_bgc_tpu_torch.ops.macros import macros_source_sink
    args = k1_inputs(state, grid, forcing, env)
    active = grid.active_mask()
    tr = state.bgc.tracers.clamp_min(0.0)
    par = (forcing.shortwave_surface.clamp_min(0.0)[None, :]
           * constants.F_QSW_PAR)
    parts = {
        "surface fluxes": lambda: (
            surface.bgc_surface_fluxes(state.bgc.tracers, forcing,
                                       state.bgc.surface_ph,
                                       state.bgc.surface_ph_alt,
                                       params.bgc),
            surface.dms_surface_fluxes(state.dms[0, 0], forcing.sst,
                                       forcing.sss, forcing.ice_fraction,
                                       forcing.wind_speed_squared_10m,
                                       forcing.surface_pressure,
                                       params.dms)),
        "bgc_source_sink": lambda: bgc.bgc_source_sink(
            state.bgc.tracers, grid, forcing, state.bgc.ph_prev_3d,
            state.bgc.ph_prev_alt_3d, params.bgc, compute_diags=False,
            env=env),
        "  K1": lambda: co3_terms_dual_coeffs(*args),
        "  ecosystem_kinetics": lambda: bgc.ecosystem_kinetics(
            tr, forcing.potential_temperature, grid.cell_thickness,
            grid.cell_center_depth, active, grid.latitude, par, params.bgc,
            tfunc=env.tfunc),
        "dms + macros": lambda: (
            dms_source_sink(coupled.dms_tracer_block(state),
                            grid.cell_thickness, active, forcing.sst,
                            forcing.shortwave_surface, params.dms),
            macros_source_sink(coupled.macros_tracer_block(state), active,
                               params.macros)),
    }
    times = {k: cuda_ms(fn, reps=1, warmup=1, rounds=3)
             for k, fn in parts.items()}
    rest = (times["bgc_source_sink"] - times["  K1"]
            - times["  ecosystem_kinetics"])
    for k, v in times.items():
        log(f"  {dtype} {k}: {v:.3f} ms")
    log(f"  {dtype}   level recurrence + assembly + masking (remainder): "
        f"{rest:.3f} ms")
    busy = device_busy_ms(lambda: coupled.step(
        state, grid, forcing, params, DT, compute_diags=False, env=env))
    if busy is None:
        log(f"  {dtype} device busy share of a step: not measured (the "
            f"profiler reported no device time)")
    else:
        log(f"  {dtype} device busy share of a step: {busy:.3f} ms of "
            f"{step_ms:.3f} ms ({100 * busy / step_ms:.1f}%)")


def host_syncs(fn):
    """The host synchronisations that torch.cuda's sync debug mode reports
    in one call of ``fn`` (already warm)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing" in str(w.message) for w in caught)


def check_no_sync(label, fn):
    """Raise unless one call of ``fn`` makes no host synchronisation."""
    n = host_syncs(fn)
    log(f"{label}: {n} host synchronisations in one step (limit 0)")
    if n:
        raise AssertionError(f"{label} synchronises with the host")


def device_busy_ms(fn):
    """Sum of device kernel time over one call of ``fn`` (already warm),
    from torch.profiler, or None where the profiler sees no device
    activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with gates_paused(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total_us = sum(evt.time_range.elapsed_us() for evt in prof.events()
                   if evt.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / 1e3 if total_us > 0 else None


def main_path(dtype, params):
    """Phase 3 at one dtype; returns the kernel entry's numbers."""
    from ocean_bgc_tpu_torch.models.coupled import step
    from ocean_bgc_tpu_torch.ops.bgc import precompute_env
    from ocean_bgc_tpu_torch.ops.carbonate import solver_xacc
    from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world

    world = synthetic_world(nlev=NLEV, ncol=NCOL, seed=SEED, ragged=True,
                            dtype=dtype)
    state0, grid, forcing = world
    env = precompute_env(grid, forcing, params.bgc)

    # -- the main path, counted --
    reset_counts()
    with gates_paused():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = state0
        states = []
        for _ in range(10):
            state, _ = step(state, grid, forcing, params, DT,
                            compute_diags=False, env=env)
            states.append(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["k1"]
    log(f"main path {dtype}: 10 steps at {NLEV}x{NCOL} in {wall:.3f} s, "
        f"launches {counts}")
    if counts != expected(k1=10, brackets=10):
        raise AssertionError(f"the default path's launches in 10 steps: "
                             f"{counts}, expected k1 10, coeffs 0, brackets "
                             f"10, k2_solve 0, k2_bio 0")
    for name, t in (("tracers", state.bgc.tracers), ("dms", state.dms),
                    ("macros", state.macros)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite {name} after 10 steps")
    if not (state.bgc.ph_prev_3d[grid.active_mask()] > 6.0).all():
        raise AssertionError("interior pH out of range after 10 steps")
    check_no_sync(f"main path {dtype}", lambda: step(
        state, grid, forcing, params, DT, compute_diags=False, env=env))

    # -- kernel vs plain version through the whole step --
    a = b = state0
    for _ in range(2):
        a, _ = step(a, grid, forcing, params, DT, compute_diags=False,
                    env=env, carbonate_impl="kernel")
        b, _ = step(b, grid, forcing, params, DT, compute_diags=False,
                    env=env, carbonate_impl="torch")
    same = all(torch.equal(x, y) for x, y in (
        (a.bgc.tracers, b.bgc.tracers), (a.dms, b.dms),
        (a.macros, b.macros)))
    ph_diff = max((x - y).abs().max().item() for x, y in (
        (a.bgc.ph_prev_3d, b.bgc.ph_prev_3d),
        (a.bgc.ph_prev_alt_3d, b.bgc.ph_prev_alt_3d)))
    # pH to the solver's tolerance: |dH| <= 2 xacc
    h_diff = max((10.0 ** -x.double() - 10.0 ** -y.double()).abs().max()
                 .item() for x, y in (
                     (a.bgc.ph_prev_3d, b.bgc.ph_prev_3d),
                     (a.bgc.ph_prev_alt_3d, b.bgc.ph_prev_alt_3d)))
    xacc = solver_xacc(dtype)
    log(f"main path {dtype}: kernel vs torch over 2 steps: tracers/DMS/"
        f"MACROS bitwise equal {same}, max|dpH| {ph_diff:.3g}, max|dH|/xacc "
        f"{h_diff / xacc:.3g} (limit 2)")
    if not same:
        raise AssertionError("kernel and plain steps differ in tracers")
    if not h_diff <= 2 * xacc:
        raise AssertionError("kernel and plain steps differ in pH beyond "
                             "the solver's tolerance")

    # -- K1 against its plain version, cold (step 0) and warm (step 1) --
    k1 = check_k1(dtype, world, env, states[0])

    # -- columns/s of the step --
    cur = states[-1]

    def one():
        nonlocal cur
        cur, _ = step(cur, grid, forcing, params, DT, compute_diags=False,
                      env=env)
    ms = cuda_ms(one, reps=2, warmup=1, rounds=5)
    log(f"step {dtype} at {NLEV}x{NCOL} (ragged, env on, diags off): "
        f"{ms:.3f} ms/step, {NCOL / (ms / 1e3):.1f} columns/s")

    # -- the bracket-in instance: surface pair and stand-in --
    kb = check_brackets(dtype, world, env, states[0])

    if dtype == torch.float64:
        log(f"breakdown of one {dtype} step at {NLEV}x{NCOL}:")
        breakdown(dtype, states[-1], grid, forcing, params, env, ms)
    return (dict(launches=launches, **k1),
            dict(launches=counts["brackets"], **kb),
            dict(world=world, env=env, warm=states[0], after=states,
                 step_ms=ms))


def k2_bounds(fields, outs, dtype, k1_args, active):
    """(bytes, operations) of each of K2's two kernels on these inputs,
    the solve's and the biology's.  Bytes: what each kernel must read
    (per-cell inputs in the active cells of ``active``, the (nlev, ncol)
    mask; the previous pH fields in all cells; the per-column rows once)
    and write (every output once).  Operations, over the active cells:
    the solve counted as K1's dual solve on the same carbonate inputs
    (iteration counts from the plain version) less K1's speciation; the
    biology as OPS_K2_CELL."""
    from ocean_bgc_tpu_torch.ops.carbonate import CarbCoeffs
    n_act, ncell = int(active.sum()), active.numel()

    def moved(t, all_cells=False):
        if all_cells or t.numel() < ncell:
            return t.numel() * t.element_size()
        return t.numel() // ncell * n_act * t.element_size()
    solve_only = (*CarbCoeffs._fields, "ph_prev", "ph_prev_alt")
    # the solve reads DIC, ALK, PO4 and SiO3 of the tracers and its
    # constants in the active cells, kmax once, both previous pH fields
    # everywhere, and writes both pH fields
    solve_bytes = (4 * n_act * outs.tendencies.element_size()
                   + sum(moved(fields[k]) for k in CarbCoeffs._fields)
                   + moved(fields["ph_prev"], True)
                   + moved(fields["ph_prev_alt"], True)
                   + moved(fields["kmax"])
                   + moved(outs.ph_prev_3d, True)
                   + moved(outs.ph_prev_alt_3d, True))
    bio_bytes = (sum(moved(t) for k, t in fields.items()
                     if t is not None and k not in solve_only)
                 + moved(outs.tendencies, True))
    solve_ops = (solve_ops_of(k1_args, active)[0]
                 - 2 * n_act * (OPS_SCENARIO - OPS_K2_NO_SPECIATION))
    return dict(solve=(solve_bytes, solve_ops),
                bio=(bio_bytes, n_act * OPS_K2_CELL))


def check_k2(dtype, world, env, warm_state, params):
    """K2 against its plain version on cold and warm inputs; returns the
    numbers of its two kernels measured on the warm (steady-state) ones,
    by the names ``solve`` and ``bio``.

    pH: bitwise (the same device solve as K1 on the same inputs).
    Tendencies: within K2_TOL of each tracer's largest magnitude; the
    kernel repeats the plain version's operations in its order, so only
    the few sites where PyTorch's CUDA ops special-case an argument could
    differ.  The count of cells over the limit is printed with the
    worst error."""
    from ocean_bgc_tpu_torch.ops import cuda_step as cs
    from ocean_bgc_tpu_torch.ops.bgc import bgc_source_sink
    from ocean_bgc_tpu_torch.ops.cuda_carbonate import (
        co3_terms_dual_coeffs_torch)
    from ocean_bgc_tpu_torch.state import BGC_TRACER_NAMES
    k2, plain = cs.fused_interior_step, cs.fused_interior_step_torch
    state, grid, forcing = world
    for label, st in (("cold", state), ("warm", warm_state)):
        b = st.bgc
        args = (b.tracers, grid, forcing, b.ph_prev_3d, b.ph_prev_alt_3d,
                params.bgc)
        got = k2(*args, env=env, impl="kernel")
        torch.cuda.synchronize()
        want = plain(*args, env=env)
        ph_equal = (torch.equal(got.ph_prev_3d, want.ph_prev_3d)
                    and torch.equal(got.ph_prev_alt_3d, want.ph_prev_alt_3d))
        diff = (got.tendencies - want.tendencies).abs()
        rel = diff / (want.tendencies.abs().amax(dim=(0, 2), keepdim=True)
                      + 1e-30)
        worst = rel.max().item()
        over = rel > K2_TOL[dtype]
        tend_err = diff.max().item()
        ph_err = max((got.ph_prev_3d - want.ph_prev_3d).abs().max().item(),
                     (got.ph_prev_alt_3d - want.ph_prev_alt_3d).abs().max()
                     .item())
        finite = bool(torch.isfinite(got.tendencies).all())
        log(f"K2 {dtype} {label}: pH and pH_alt bitwise equal {ph_equal}; "
            f"tendencies: worst error / tracer scale {worst:.3g} (limit "
            f"{K2_TOL[dtype]:g}) in "
            f"{BGC_TRACER_NAMES[int(rel.amax(dim=(0, 2)).argmax())]}, "
            f"{int(over.sum())} cells over the limit, bitwise equal cells "
            f"{int((diff == 0).sum())} of {diff.numel()}; max abs error "
            f"{max(tend_err, ph_err):.3g}; finite {finite}")
        if over.any():
            k, i, col = (int(v) for v in over.nonzero()[0])
            log(f"  first cell over the limit: level {k}, "
                f"{BGC_TRACER_NAMES[i]}, column {col} (kmax "
                f"{int(grid.kmax[col])})")
        if not (ph_equal and finite and not over.any()):
            raise AssertionError(f"K2 {dtype} {label} disagrees with its "
                                 f"plain version")
    call_ms = cuda_ms(lambda: k2(*args, env=env, impl="kernel"), reps=10)
    fields = cs.kernel_inputs(*args, env)
    out = cs.FusedInteriorOut(*(torch.empty_like(t) for t in got))
    ms = dict(solve=cuda_ms(lambda: cs._launch_solve(fields, out), reps=10,
                            device_only=True),
              bio=cuda_ms(lambda: cs._launch_bio(fields, out, params.bgc),
                          reps=10, device_only=True))
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(out, got)):
        raise AssertionError(f"K2 {dtype}: the timed launches' outputs "
                             f"differ from the wrapper's")
    k1_args = k1_inputs(warm_state, grid, forcing, env)
    # the plain versions: of the solve, the dual pH solve on the same
    # cells; of the biology, the plain interior with its pH on K1's kernel
    plain_ms = dict(
        solve=cuda_ms(lambda: co3_terms_dual_coeffs_torch(*k1_args), reps=1,
                      warmup=1, rounds=3),
        bio=cuda_ms(lambda: bgc_source_sink(
            *args, compute_diags=False, carbonate_impl="kernel", env=env),
            reps=1, warmup=1, rounds=3))
    work = k2_bounds(fields, got, dtype, k1_args, grid.active_mask())
    res = {}
    for part, err in (("solve", ph_err), ("bio", tend_err)):
        nbytes, ops = work[part]
        bound_ms, bound_by = bound(nbytes, ops, dtype)
        log(f"K2 {dtype} warm, {part} kernel: {ms[part]:.4f} ms/launch, "
            f"plain {plain_ms[part]:.3f} ms, bound {bound_ms:.4f} ms by "
            f"{bound_by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} Gop)")
        res[part] = dict(max_abs_err=err, ms=ms[part],
                         plain_ms=plain_ms[part], bound_ms=bound_ms,
                         bound_by=bound_by)
    log(f"K2 {dtype} warm: solve {ms['solve']:.4f} + biology "
        f"{ms['bio']:.4f} = {ms['solve'] + ms['bio']:.4f} ms; "
        f"{call_ms:.4f} ms per call of the wrapper (both launches and its "
        f"host work); {int(grid.active_mask().sum())} of {NLEV * NCOL} "
        f"cells active")
    return res


def trajectory_gate(dtype, state0, grid, forcing, params, env, default):
    """TRAJ_STEPS fused steps against as many default steps from the same
    state: per tracer, max|fused - default| <= 30 envelope + floor scale,
    the envelope being the default path's distance from a run whose
    initial tracers were scaled by (1 + eps) (scripts/qualify_fused.py's
    criterion).  ``default`` holds the main path's first default steps
    from ``state0``; the default run continues from the last of them."""
    import dataclasses

    from ocean_bgc_tpu_torch.models.coupled import step
    from ocean_bgc_tpu_torch.state import BGC_TRACER_NAMES

    def run(s, impl, steps=TRAJ_STEPS):
        for _ in range(steps):
            s, _ = step(s, grid, forcing, params, DT, compute_diags=False,
                        env=env, interior_impl=impl)
        return s.bgc.tracers.double()

    eps, floor = TRAJ_EPS_FLOOR[dtype]
    t0 = time.perf_counter()
    fused = run(state0, "fused")
    ref = run(default[-1], "auto", TRAJ_STEPS - len(default))
    pert = dataclasses.replace(state0, bgc=dataclasses.replace(
        state0.bgc, tracers=state0.bgc.tracers * torch.tensor(
            1.0 + eps, dtype=dtype)))
    envelope = (run(pert, "auto") - ref).abs()
    worst, fails = 0.0, []
    for idx in range(len(BGC_TRACER_NAMES)):
        mismatch = (fused[:, idx] - ref[:, idx]).abs().max().item()
        scale = ref[:, idx].abs().max().item() + 1e-30
        bound = (30.0 * envelope[:, idx].max().item() + floor * scale
                 + 1e-12)
        worst = max(worst, mismatch / bound)
        if not mismatch <= bound:
            fails.append(f"{BGC_TRACER_NAMES[idx]} {mismatch:.3e} > "
                         f"{bound:.3e}")
    log(f"trajectory gate {dtype}: {TRAJ_STEPS} fused vs default steps, "
        f"eps {eps:g}, floor {floor:g}: worst mismatch / bound {worst:.3g} "
        f"(limit 1), finite {bool(torch.isfinite(fused).all())} "
        f"({time.perf_counter() - t0:.1f} s)")
    if fails or not torch.isfinite(fused).all():
        raise AssertionError(f"fused trajectory outside the envelope: "
                             f"{fails}")


def fused_breakdown(dtype, state, grid, forcing, params, env, step_ms):
    """Where one fused step's time goes: its parts alone (CUDA events),
    and the device's busy share from the profiler."""
    from ocean_bgc_tpu_torch.models import coupled
    from ocean_bgc_tpu_torch.ops import surface
    from ocean_bgc_tpu_torch.ops.cuda_step import fused_interior_step
    from ocean_bgc_tpu_torch.ops.dms import dms_source_sink
    from ocean_bgc_tpu_torch.ops.macros import macros_source_sink
    active = grid.active_mask()
    b = state.bgc
    parts = {
        "surface fluxes": lambda: (
            surface.bgc_surface_fluxes(b.tracers, forcing, b.surface_ph,
                                       b.surface_ph_alt, params.bgc),
            surface.dms_surface_fluxes(state.dms[0, 0], forcing.sst,
                                       forcing.sss, forcing.ice_fraction,
                                       forcing.wind_speed_squared_10m,
                                       forcing.surface_pressure,
                                       params.dms)),
        "K2 (wrapper + launch)": lambda: fused_interior_step(
            b.tracers, grid, forcing, b.ph_prev_3d, b.ph_prev_alt_3d,
            params.bgc, env=env),
        "dms + macros": lambda: (
            dms_source_sink(coupled.dms_tracer_block(state),
                            grid.cell_thickness, active, forcing.sst,
                            forcing.shortwave_surface, params.dms),
            macros_source_sink(coupled.macros_tracer_block(state), active,
                               params.macros)),
    }
    times = {k: cuda_ms(fn, reps=3, warmup=1, rounds=3)
             for k, fn in parts.items()}
    for k, v in times.items():
        log(f"  {dtype} {k}: {v:.3f} ms")
    log(f"  {dtype} the rest (tracer blocks, deposit, update; step minus "
        f"the parts): {step_ms - sum(times.values()):.3f} ms")
    busy = device_busy_ms(lambda: coupled.step(
        state, grid, forcing, params, DT, compute_diags=False, env=env,
        interior_impl="fused"))
    if busy is None:
        log(f"  {dtype} device busy share of a fused step: not measured "
            f"(the profiler reported no device time)")
    else:
        log(f"  {dtype} device busy share of a fused step: {busy:.3f} ms "
            f"of {step_ms:.3f} ms ({100 * busy / step_ms:.1f}%)")


def fused_path(dtype, params, ctx):
    """Phase 4 at one dtype; returns K2's kernel entry's numbers."""
    from ocean_bgc_tpu_torch.models.coupled import step

    world, env = ctx["world"], ctx["env"]
    state0, grid, forcing = world

    # -- the fused path, counted --
    reset_counts()
    with gates_paused():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = state0
        for _ in range(10):
            state, _ = step(state, grid, forcing, params, DT,
                            compute_diags=False, env=env,
                            interior_impl="fused")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    log(f"fused path {dtype}: 10 steps at {NLEV}x{NCOL} in {wall:.3f} s, "
        f"launches {counts}")
    if counts != expected(brackets=10, k2_solve=10, k2_bio=10):
        raise AssertionError(f"the fused path's launches in 10 steps: "
                             f"{counts}, expected k1 0, coeffs 0, brackets "
                             f"10, k2_solve 10, k2_bio 10")
    for name, t in (("tracers", state.bgc.tracers), ("dms", state.dms),
                    ("macros", state.macros),
                    ("pH", state.bgc.ph_prev_3d)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite {name} after 10 fused steps")
    check_no_sync(f"fused path {dtype}", lambda: step(
        state, grid, forcing, params, DT, compute_diags=False, env=env,
        interior_impl="fused"))

    k2 = check_k2(dtype, world, env, ctx["warm"], params)
    trajectory_gate(dtype, state0, grid, forcing, params, env, ctx["after"])

    cur = state

    def one():
        nonlocal cur
        cur, _ = step(cur, grid, forcing, params, DT, compute_diags=False,
                      env=env, interior_impl="fused")
    ms = cuda_ms(one, reps=3, warmup=1, rounds=5)
    log(f"fused step {dtype} at {NLEV}x{NCOL} (ragged, env on, diags off): "
        f"{ms:.3f} ms/step, {NCOL / (ms / 1e3):.1f} columns/s; default "
        f"step {ctx['step_ms']:.3f} ms/step, "
        f"{NCOL / (ctx['step_ms'] / 1e3):.1f} columns/s")
    log(f"breakdown of one fused {dtype} step at {NLEV}x{NCOL}:")
    fused_breakdown(dtype, cur, grid, forcing, params, env, ms)
    return {part: dict(launches=counts[f"k2_{part}"], **k2[part])
            for part in ("solve", "bio")}


def sat_bound(args, dtype, with_sat=True, seed=False):
    """(bound_ms, bound_by, bytes, operations, mean iterations) of K1's
    coefficient-and-saturation function on ``args`` (its inputs): its
    fields read and written once over the HBM rate (the constants need
    not leave the chip), against the constants', the saturation values'
    and the dual solve's operations (iteration counts from the plain
    version) over the peak rate; ``seed``: of its seeded variant."""
    from ocean_bgc_tpu_torch.ops.carbonate import carbonate_coeffs
    from ocean_bgc_tpu_torch.ops.cuda_carbonate import subsurface_of
    depth, temp, salt, *solve_args = args
    coeffs = carbonate_coeffs(depth, temp, salt, subsurface_of(depth))
    ops, iters = solve_ops_of((*solve_args, coeffs), seed=seed)
    n = depth.numel()
    ops += n * (OPS_COEFFS + (OPS_SAT if with_sat else 0))
    n_out = SAT_FIELDS_OUT if with_sat else SAT_FIELDS_OUT - 2
    nbytes = (SAT_FIELDS_IN + n_out) * depth.element_size() * n
    return (*bound(nbytes, ops, dtype), nbytes, ops, iters)


def coeffs_bound(args, dtype, with_sat=True):
    """(bound_ms, bound_by, bytes, operations) of K1's constants kernel
    on ``args`` (depth, T, S): its fields read and written once over the
    HBM rate, against the constants' and the saturation values'
    operations over the peak rate."""
    n = args[0].numel()
    n_out = COEFF_FIELDS_OUT if with_sat else COEFF_FIELDS_OUT - 2
    nbytes = (COEFF_FIELDS_IN + n_out) * args[0].element_size() * n
    ops = n * (OPS_COEFFS + (OPS_SAT if with_sat else 0))
    return (*bound(nbytes, ops, dtype), nbytes, ops)


# SASS opcode classes counted per kernel (the static instruction mix)
SASS_CLASSES = (
    ("DFMA", r"DFMA"), ("DMUL", r"DMUL"), ("DADD", r"DADD"),
    ("MUFU.RCP64H", r"MUFU\.RCP64H"), ("MUFU.RSQ64H", r"MUFU\.RSQ64H"),
    ("MUFU (f32)", r"MUFU\.(?!RCP64H|RSQ64H)"), ("FFMA", r"FFMA"),
    ("FMUL", r"FMUL"), ("FADD", r"FADD"), ("CALL", r"CALL"),
    ("BRA", r"BRA"), ("LDL", r"LDL"), ("STL", r"STL"), ("LDG", r"LDG"),
    ("STG", r"STG"))


def sass_mix(library, names):
    """{kernel: 'total N; DFMA n, ...'} of the static SASS instruction
    counts of the kernels of ``library`` (a built .so) whose demangled
    name contains one of ``names``, from ``cuobjdump -sass``."""
    from ocean_bgc_tpu_torch.ops import _kernels
    cuobjdump = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m[1], [])
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if m and cur is not None:
            cur.append(m[1])
    mangled = list(funcs)
    demangled = subprocess.run(["c++filt"], input="\n".join(mangled),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
    out = {}
    for raw, name in zip(mangled, demangled or mangled):
        name = name.replace("obgc::(anonymous namespace)::", "")
        name = name.split("(")[0]
        if not any(n in name for n in names):
            continue
        ops = funcs[raw]
        counts = [(k, sum(1 for op in ops if re.match(rx, op)))
                  for k, rx in SASS_CLASSES]
        out[name] = f"total {len(ops)}; " + ", ".join(
            f"{k} {v}" for k, v in counts if v)
    return out


def check_coeffs(dtype, world, warm_state):
    """K1's constants kernel against its plain version (``carbonate_coeffs``
    and ``co3_sat_vals`` in torch) on the cold and warm inputs of the step
    without an env cache, its registers, spills and SASS instruction mix,
    its time beside its bound; then the coefficient-and-saturation route
    (the constants kernel, then the dual K1 on its constants) against its
    plain version on cold, warm and off-window inputs, and its time.
    Returns the constants kernel's numbers on the warm inputs.

    Tolerance: none, every output bitwise equal.  The constants repeat the
    plain version's expressions in its order with PyTorch's CUDA
    semantics (a tensor over a Python scalar is a product with the
    scalar's reciprocal), --fmad=false, IEEE division and the CUDA math
    library's exp, log and sqrt; the solve is the dual K1's."""
    import dataclasses

    from ocean_bgc_tpu_torch.ops import _kernels, cuda_carbonate as cc
    from ocean_bgc_tpu_torch.ops.bgc import carbonate_inputs
    state, grid, forcing = world
    name = str(dtype).split(".")[-1]
    off = dataclasses.replace(warm_state, bgc=dataclasses.replace(
        warm_state.bgc, ph_prev_3d=off_window(warm_state.bgc.ph_prev_3d),
        ph_prev_alt_3d=off_window(warm_state.bgc.ph_prev_alt_3d)))
    cases = {}
    for label, st in (("cold", state), ("warm", warm_state),
                      ("off-window", off)):
        b = st.bgc
        cases[label] = carbonate_inputs(b.tracers, grid, forcing,
                                        b.ph_prev_3d, b.ph_prev_alt_3d)
    err = 0.0
    for label in ("cold", "warm"):
        cargs = cases[label][:3]
        want, want_sat = cc.carbonate_coeffs_sat_torch(*cargs)
        for with_sat in (True, False):
            got, sat = cc.carbonate_coeffs_sat(*cargs, with_sat=with_sat,
                                               impl="kernel")
            torch.cuda.synchronize()
            n_out = COEFF_FIELDS_OUT if with_sat else COEFF_FIELDS_OUT - 2
            e = compare(f"K1 constants kernel {name} {label}, with_sat "
                        f"{with_sat}", (*got, *(sat or ())),
                        (*want, *want_sat)[:n_out])
            err = max(err, e)
    for label, args in cases.items():
        got = cc.co3_terms_dual_sat(*args, impl="kernel")
        torch.cuda.synchronize()
        want = cc.co3_terms_dual_sat_torch(*args)
        compare(f"K1 coefficient-and-saturation route {name} {label}",
                [x for part in got for x in part],
                [x for part in want for x in part])

    log(f"K1 constants kernel, ptxas: see the build log above; SASS "
        f"(static instruction counts, cuobjdump):")
    libs = {"carbonate_coeffs": ("coeffs_kernel",),
            "carbonate_dual": ("DualLanes",)}
    for src, names in libs.items():
        for kname, mix in sass_mix(_kernels.library_path(src),
                                   names).items():
            log(f"    {kname}: {mix}")

    args = cases["warm"]
    cargs = args[:3]
    res = {}
    for with_sat in (True, False):
        ms = cuda_ms(lambda: cc._launch_coeffs(*cargs, with_sat), reps=50,
                     device_only=True)
        plain_ms = cuda_ms(lambda: cc.carbonate_coeffs_sat_torch(
            *cargs, with_sat=with_sat), reps=1, warmup=1, rounds=3)
        bound_ms, bound_by, nbytes, ops = coeffs_bound(cargs, dtype,
                                                       with_sat)
        log(f"K1 constants kernel {name} warm, with_sat {with_sat}: "
            f"{ms:.4f} ms/launch, plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
            f"{ops / 1e9:.3f} Gop)")
        if with_sat:
            res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
    busy = device_busy_ms(lambda: cc.carbonate_coeffs_sat_torch(
        *cargs, with_sat=False))
    log(f"K1 constants {name} warm, the plain version without the "
        f"saturation values (the eager evaluation the kernel replaces on "
        f"the health and fused paths without an env cache): device busy "
        + ("not measured" if busy is None else f"{busy:.4f} ms"))

    # the inactive cells (below the floor) keep their 0 pH sentinel without
    # an env cache and solve from the cold window every step
    active = grid.active_mask()
    coeffs = cc.carbonate_coeffs_sat(*cargs, with_sat=False)[0]
    its = [solve_ops_of((*args[3:], coeffs), cells=c)[1]
           for c in (active, ~active)]
    log(f"K1 coefficient-and-saturation route {name} warm: mean iterations "
        f"per scenario, active cells {its[0][0]:.2f} / {its[0][1]:.2f}, "
        f"inactive cells {its[1][0]:.2f} / {its[1][1]:.2f} "
        f"({int((~active).sum())} of {active.numel()} cells inactive)")

    coeffs = cc.carbonate_coeffs_sat(*cargs, impl="kernel")[0]
    for seed in (False, True):
        bound_ms, bound_by, nbytes, ops, _ = sat_bound(args, dtype,
                                                       seed=seed)
        dual_ms = cuda_ms(lambda: cc._launch((*args[3:], *coeffs), dtype,
                                             seed), reps=20, device_only=True)
        plain_ms = cuda_ms(lambda: cc.co3_terms_dual_sat_torch(
            *args, seed=seed), reps=1, warmup=1, rounds=3)
        ms = cuda_ms(lambda: cc.co3_terms_dual_sat(*args, seed=seed,
                                                   impl="kernel"),
                     reps=20, device_only=True)
        log(f"K1 coefficient-and-saturation route {name} warm, seed {seed}: "
            f"{ms:.4f} ms (the dual K1 alone on the kernel's constants "
            f"{dual_ms:.4f} ms), plain {plain_ms:.3f} ms, bound of the "
            f"function {bound_ms:.4f} ms by "
            f"{bound_by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} Gop)")
    return res


def diags_breakdown(dtype, state, grid, forcing, params, step_ms):
    """Where one default-call step's time goes (diagnostics on, no env
    cache): each part called alone on the step's inputs (CUDA events,
    median of 3 single calls), and the device's busy share of a step."""
    from ocean_bgc_tpu_torch import constants
    from ocean_bgc_tpu_torch.models import coupled
    from ocean_bgc_tpu_torch.ops import bgc, surface
    from ocean_bgc_tpu_torch.ops.cuda_carbonate import co3_terms_dual_sat
    from ocean_bgc_tpu_torch.ops.dms import dms_source_sink
    from ocean_bgc_tpu_torch.ops.macros import macros_source_sink
    b = state.bgc
    args = bgc.carbonate_inputs(b.tracers, grid, forcing, b.ph_prev_3d,
                                b.ph_prev_alt_3d)
    active = grid.active_mask()
    tr = b.tracers.clamp_min(0.0)
    par = (forcing.shortwave_surface.clamp_min(0.0)[None, :]
           * constants.F_QSW_PAR)
    parts = {
        "surface fluxes": lambda: (
            surface.bgc_surface_fluxes(b.tracers, forcing, b.surface_ph,
                                       b.surface_ph_alt, params.bgc),
            surface.dms_surface_fluxes(state.dms[0, 0], forcing.sst,
                                       forcing.sss, forcing.ice_fraction,
                                       forcing.wind_speed_squared_10m,
                                       forcing.surface_pressure,
                                       params.dms)),
        "bgc_source_sink (diagnostics on)": lambda: bgc.bgc_source_sink(
            b.tracers, grid, forcing, b.ph_prev_3d, b.ph_prev_alt_3d,
            params.bgc, compute_diags=True),
        "  K1 coefficient-and-saturation route": lambda: co3_terms_dual_sat(
            *args),
        "  ecosystem_kinetics": lambda: bgc.ecosystem_kinetics(
            tr, forcing.potential_temperature, grid.cell_thickness,
            grid.cell_center_depth, active, grid.latitude, par, params.bgc),
        "dms + macros (diagnostics on)": lambda: (
            dms_source_sink(coupled.dms_tracer_block(state),
                            grid.cell_thickness, active, forcing.sst,
                            forcing.shortwave_surface, params.dms),
            macros_source_sink(coupled.macros_tracer_block(state), active,
                               params.macros)),
    }
    times = {k: cuda_ms(fn, reps=1, warmup=1, rounds=3)
             for k, fn in parts.items()}
    for k, v in times.items():
        log(f"  {dtype} {k}: {v:.3f} ms")
    rest = (times["bgc_source_sink (diagnostics on)"]
            - times["  K1 coefficient-and-saturation route"]
            - times["  ecosystem_kinetics"])
    log(f"  {dtype}   level recurrence + assembly + diagnostics + masking "
        f"(remainder): {rest:.3f} ms")
    top = sum(v for k, v in times.items() if not k.startswith(" "))
    log(f"  {dtype} the rest (tracer blocks, deposit, update, the "
        f"diagnostics dict; step minus the parts): {step_ms - top:.3f} ms")
    busy = device_busy_ms(lambda: coupled.step(state, grid, forcing, params,
                                               DT))
    if busy is None:
        log(f"  {dtype} device busy share of a default-call step: not "
            f"measured (the profiler reported no device time)")
    else:
        log(f"  {dtype} device busy share of a default-call step: "
            f"{busy:.3f} ms of {step_ms:.3f} ms ({100 * busy / step_ms:.1f}%)")


def default_call(dtype, params, ctx):
    """Phase 5 at one dtype: the JAX package's default call; returns the
    constants kernel's entry's numbers."""
    from ocean_bgc_tpu_torch.models.coupled import step
    from ocean_bgc_tpu_torch.ops.carbonate import solver_xacc
    from ocean_bgc_tpu_torch.utils.diag import coupled_registry

    world, env = ctx["world"], ctx["env"]
    state0, grid, forcing = world
    registry = set(coupled_registry())

    # -- the default call, counted --
    reset_counts()
    with gates_paused():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, states = state0, []
        for _ in range(10):
            state, diags = step(state, grid, forcing, params, DT)
            states.append(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["coeffs"]
    log(f"default call {dtype}: 10 steps at {NLEV}x{NCOL} (diagnostics on, "
        f"no env cache) in {wall:.3f} s, launches {counts}")
    if counts != expected(coeffs=10, k1=10, brackets=10):
        raise AssertionError(f"the default call's launches in 10 steps: "
                             f"{counts}, expected k1 10, coeffs 10, brackets "
                             f"10, k2_solve 0, k2_bio 0")
    bad = sorted(k for k, v in diags.items() if not torch.isfinite(v).all())
    log(f"default call {dtype}: {len(diags)} diagnostics, the registry's "
        f"{len(registry)} names {set(diags) == registry}, non-finite {bad}")
    if set(diags) != registry or bad:
        raise AssertionError("the default call's diagnostics are not the "
                             "registry's, or not finite")
    if not torch.isfinite(state.bgc.tracers).all():
        raise AssertionError("non-finite tracers after 10 default calls")
    del diags
    check_no_sync(f"default call {dtype} with health counters", lambda: step(
        state, grid, forcing, params, DT, health=True))

    # -- diagnostics on with the env cache, counted --
    reset_counts()
    s = state0
    for _ in range(10):
        s, d = step(s, grid, forcing, params, DT, env=env)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"diags on with the env cache {dtype}: launches {counts}")
    if counts != expected(k1=10, brackets=10):
        raise AssertionError(f"the diags-on env-on launches in 10 steps: "
                             f"{counts}, expected k1 10, coeffs 0, brackets "
                             f"10, k2_solve 0, k2_bio 0")
    if set(d) != registry or not all(torch.isfinite(v).all() for v in
                                     d.values()):
        raise AssertionError("diags on with the env cache: diagnostics not "
                             "the registry's, or not finite")
    del s, d

    # -- kernel vs plain version, diags on vs off, over 2 steps --
    a = b = c = state0
    for _ in range(2):
        a, da = step(a, grid, forcing, params, DT, carbonate_impl="kernel")
        b, db = step(b, grid, forcing, params, DT, carbonate_impl="torch")
        c, _ = step(c, grid, forcing, params, DT, compute_diags=False)
    same_ab = all(torch.equal(x, y) for x, y in (
        (a.bgc.tracers, b.bgc.tracers), (a.dms, b.dms), (a.macros, b.macros)))
    same_ac = all(torch.equal(x, y) for x, y in (
        (a.bgc.tracers, c.bgc.tracers), (a.dms, c.dms), (a.macros, c.macros)))
    diag_differ = sorted(k for k in da if not torch.equal(da[k], db[k]))
    xacc = solver_xacc(dtype)
    h_diff = max((10.0 ** -x.double() - 10.0 ** -y.double()).abs().max()
                 .item() for x, y in (
                     (a.bgc.ph_prev_3d, b.bgc.ph_prev_3d),
                     (a.bgc.ph_prev_alt_3d, b.bgc.ph_prev_alt_3d)))
    log(f"default call {dtype}: kernel vs torch over 2 steps: tracers/DMS/"
        f"MACROS bitwise equal {same_ab}, diagnostics not bitwise equal "
        f"{diag_differ}, max|dH|/xacc {h_diff / xacc:.3g}; diags on vs off: "
        f"tracers/DMS/MACROS bitwise equal {same_ac}")
    if not (same_ab and same_ac) or diag_differ or not h_diff <= 2 * xacc:
        raise AssertionError("the default call differs between the kernel "
                             "and the plain version, or with diagnostics "
                             "off")
    del a, b, c, da, db

    k = check_coeffs(dtype, world, states[0])

    # -- ms/step of the diags-on configurations --
    def timed(label, **kw):
        cur = states[-1]

        def one():
            nonlocal cur
            cur, _ = step(cur, grid, forcing, params, DT, **kw)
        ms = cuda_ms(one, reps=2, warmup=1, rounds=3)
        log(f"step {dtype} at {NLEV}x{NCOL} (ragged, {label}): {ms:.3f} "
            f"ms/step, {NCOL / (ms / 1e3):.1f} columns/s")
        return ms
    ms = timed("diags on, env off: the default call")
    health_ms = timed("diags on, env off, health counters", health=True)
    timed("diags on, env on", env=env)
    timed(f"{len(PROD_FILTER)}-field diag_filter, env on", env=env,
          diag_filter=PROD_FILTER)
    if dtype == torch.float64:
        log(f"breakdown of one default-call {dtype} step at {NLEV}x{NCOL}:")
        diags_breakdown(dtype, states[-1], grid, forcing, params, ms)
        busy = device_busy_ms(lambda: step(states[-1], grid, forcing,
                                           params, DT, health=True))
        log(f"  {dtype} device busy share of a default-call step with "
            f"health counters: " + ("not measured (the profiler reported "
                                    "no device time)" if busy is None else
                                    f"{busy:.3f} ms of {health_ms:.3f} ms "
                                    f"({100 * busy / health_ms:.1f}%)"))
    return dict(launches=launches, **k)


def device_kernels_ms(fn):
    """{kernel name: device ms} over one call of ``fn`` (already warm),
    from torch.profiler; empty where the profiler sees no device
    activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with gates_paused(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out[evt.name] = out.get(evt.name, 0.0) + (
                evt.time_range.elapsed_us() / 1e3)
    return out


def compare_host(label, got, want):
    """Raise unless the NumPy arrays ``got`` and ``want`` (dicts, the same
    keys, nested dicts alike) are bitwise equal; returns the count of
    values compared."""
    if got.keys() != want.keys():
        raise AssertionError(f"{label}: keys {sorted(got)} against "
                             f"{sorted(want)}")
    n = 0
    for k, w in want.items():
        if isinstance(w, dict):
            n += compare_host(f"{label}.{k}", got[k], w)
            continue
        g = got[k]
        if g.shape != w.shape or g.dtype != w.dtype or not np_equal(g, w):
            raise AssertionError(f"{label}: {k} is not bitwise equal")
        n += w.size
    return n


def np_equal(a, b):
    """Bitwise equality of two arrays of one type (NaN equal to NaN)."""
    import numpy as np
    u = f"u{a.itemsize}"
    return bool(np.array_equal(np.ascontiguousarray(a).view(u),
                               np.ascontiguousarray(b).view(u)))


def _permuted(kw, names, seed):
    """``kw`` with every tracer block and flux in a shuffled host order,
    its index map and the permutation (canonical c at host perm[c])."""
    import numpy as np
    perm = np.random.default_rng(seed).permutation(len(names))
    out = dict(kw)
    for k in ("BGC_tracers", "DMS_tracers", "MACROS_tracers",
              "depositionFlux", "riverFlux", "gasFlux", "seaIceFlux"):
        if k in out:
            a = np.empty_like(out[k])
            a[..., perm] = out[k]
            out[k] = a
    return out, {n: int(perm[c]) for c, n in enumerate(names)}, perm


def host_api_phase(params, world, env):
    """Phase 6: the host-coupling API (``ocean_bgc_tpu_torch/host_api.py``)
    on the flagship world written out as the host's NumPy arrays, f64.
    Every call's launches counted; the BGC pair bitwise the port's own
    functions on the level-major world and the plain route's values;
    the tracer-order adapter and the diagnostics filter bitwise the
    canonical run; the seeded pair; the env staleness guard;
    ``checked_step``; then each call's wall, device, ingest, compute and
    egress times."""
    import numpy as np
    from ocean_bgc_tpu_torch import host_api as api
    from ocean_bgc_tpu_torch.io import host_layout
    from ocean_bgc_tpu_torch.models.coupled import step
    from ocean_bgc_tpu_torch.ops.bgc import bgc_source_sink
    from ocean_bgc_tpu_torch.ops.carbonate import solver_xacc
    from ocean_bgc_tpu_torch.ops.surface import bgc_surface_fluxes
    from ocean_bgc_tpu_torch.state import BGCTracers as T
    from ocean_bgc_tpu_torch.utils.bridge import host_arguments
    from ocean_bgc_tpu_torch.utils.debug import checked_step

    t_phase = time.perf_counter()
    state, grid, forcing = world
    b, p = state.bgc, params.bgc
    kw = host_arguments(state, grid, forcing)
    ss_kw, sf_kw = kw["BGC_SourceSink"], kw["BGC_SurfaceFluxes"]
    log(f"host API: {NLEV}x{NCOL} f64 world in the host's layout "
        f"(tracer block {ss_kw['BGC_tracers'].nbytes / 1e6:.1f} MB); native "
        f"packer loaded {host_layout.native_available()}")
    xacc = solver_xacc(torch.float64)

    def counted(label, fn, **want):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"host API {label}: launches {counts}")
        if counts != expected(**want):
            raise AssertionError(f"host API {label}: launches {counts}, "
                                 f"expected {want} and 0 elsewhere")
        return out

    def ss_dict(out):
        """A BGCSourceSinkOut as the API's dict (exact transposes)."""
        return {"BGC_tendencies": np.ascontiguousarray(
                    out.tendencies.cpu().numpy().transpose(2, 0, 1)),
                "PH_PREV_3D": np.ascontiguousarray(
                    out.ph_prev_3d.cpu().numpy().T),
                "PH_PREV_ALT_CO2_3D": np.ascontiguousarray(
                    out.ph_prev_alt_3d.cpu().numpy().T),
                "diags": {k: v.cpu().numpy() for k, v in out.diags.items()}}

    def sf_dict(out):
        return {"netFlux": np.ascontiguousarray(
                    out.net_flux.cpu().numpy().T),
                "surface_pH": out.surface_ph.cpu().numpy(),
                "surface_pH_alt_co2": out.surface_ph_alt.cpu().numpy(),
                "diags": {k: v.cpu().numpy() for k, v in out.diags.items()}}

    def against_plain(label, got, want, ph_keys):
        """The plain route's results: tendencies and diagnostics bitwise,
        pH within 2 xacc of H (as phase 5 holds the default call)."""
        h = max(float(np.abs(10.0 ** -got[k] - 10.0 ** -want[k]).max())
                for k in ph_keys)
        rest = {k: v for k, v in want.items() if k not in ph_keys}
        n = compare_host(label, {k: got[k] for k in rest}, rest)
        log(f"host API {label} against the plain route: {n} values bitwise "
            f"equal, max|dH|/xacc {h / xacc:.3g} (limit 2)")
        if not h <= 2 * xacc:
            raise AssertionError(f"host API {label}: pH beyond 2 xacc of "
                                 f"the plain route's")

    # -- the BGC pair, cold then warm, counted, against the port's own
    # functions on the level-major world and against the plain route --
    ss, sf, ph, sph = {}, {}, (b.ph_prev_3d, b.ph_prev_alt_3d), (
        b.surface_ph, b.surface_ph_alt)
    for mode in ("cold", "warm"):
        warm = {} if mode == "cold" else dict(
            PH_PREV_3D=ss["cold"]["PH_PREV_3D"],
            PH_PREV_ALT_CO2_3D=ss["cold"]["PH_PREV_ALT_CO2_3D"])
        swarm = {} if mode == "cold" else dict(
            surface_pH=sf["cold"]["surface_pH"],
            surface_pH_alt_co2=sf["cold"]["surface_pH_alt_co2"])
        ss[mode] = counted(f"BGC_SourceSink {mode}",
                           lambda: api.BGC_SourceSink(**ss_kw, **warm),
                           coeffs=1, k1=1)
        sf[mode] = counted(f"BGC_SurfaceFluxes {mode}",
                           lambda: api.BGC_SurfaceFluxes(**sf_kw, **swarm),
                           brackets=1)
        ref = bgc_source_sink(b.tracers, grid, forcing, *ph, p,
                              compute_diags=True, env=None)
        sref = bgc_surface_fluxes(b.tracers, forcing, *sph, p)
        n = compare_host(f"BGC_SourceSink {mode}", ss[mode], ss_dict(ref))
        n += compare_host(f"BGC_SurfaceFluxes {mode}", sf[mode],
                          sf_dict(sref))
        log(f"host API {mode} pair against bgc_source_sink and "
            f"bgc_surface_fluxes on the card: {n} values bitwise equal")
        against_plain(f"BGC_SourceSink {mode}", ss[mode], ss_dict(
            bgc_source_sink(b.tracers, grid, forcing, *ph, p,
                            compute_diags=True, carbonate_impl="torch")),
            ("PH_PREV_3D", "PH_PREV_ALT_CO2_3D"))
        against_plain(f"BGC_SurfaceFluxes {mode}", sf[mode], sf_dict(
            bgc_surface_fluxes(b.tracers, forcing, *sph, p,
                               carbonate_impl="torch")),
            ("surface_pH", "surface_pH_alt_co2"))
        ph = (ref.ph_prev_3d, ref.ph_prev_alt_3d)
        sph = (sref.surface_ph, sref.surface_ph_alt)
    log(f"host API checks, the BGC pair: {time.perf_counter() - t_phase:.1f}"
        f" s")
    warm_kw = dict(ss_kw, PH_PREV_3D=ss["cold"]["PH_PREV_3D"],
                   PH_PREV_ALT_CO2_3D=ss["cold"]["PH_PREV_ALT_CO2_3D"])
    swarm_kw = dict(sf_kw, surface_pH=sf["cold"]["surface_pH"],
                    surface_pH_alt_co2=sf["cold"]["surface_pH_alt_co2"])
    canon = {"BGC_SourceSink": ss["cold"], "BGC_SurfaceFluxes": sf["cold"]}
    for name in ("DMS_SourceSink", "DMS_SurfaceFluxes", "MACROS_SourceSink"):
        canon[name] = counted(name, lambda: getattr(api, name)(**kw[name]))
        bad = [k for k, v in canon[name].items()
               if isinstance(v, np.ndarray) and not np.isfinite(v).all()]
        if bad:
            raise AssertionError(f"host API {name}: non-finite {bad}")

    # -- the tracer-order adapter and the diagnostics filter --
    for i, (name, names) in enumerate((
            ("BGC_SourceSink", api.BGC_TRACER_NAMES),
            ("BGC_SurfaceFluxes", api.BGC_TRACER_NAMES),
            ("DMS_SourceSink", api.DMS_TRACER_NAMES),
            ("DMS_SurfaceFluxes", api.DMS_TRACER_NAMES),
            ("MACROS_SourceSink", api.MACROS_TRACER_NAMES))):
        shuffled, indices, perm = _permuted(kw[name], names, seed=100 + i)
        got = getattr(api, name)(**shuffled, indices=indices)
        want = dict(canon[name])
        for k in want:
            if k.endswith("tendencies") or k == "netFlux":
                a = np.empty_like(want[k])
                a[..., perm] = want[k]
                want[k] = a
        n = compare_host(f"{name} in a shuffled tracer order", got, want)
        log(f"host API {name} in a shuffled tracer order: {n} values "
            f"bitwise the canonical run's, permuted")
    # the history's fields that the interior emits (the other two,
    # pco2surf and dpco2, are BGC_SurfaceFluxes' and raise KeyError here,
    # as in the JAX package)
    names = tuple(k for k in PROD_FILTER if k in ss["cold"]["diags"])
    got = counted(f"BGC_SourceSink with diag_names (the history's "
                  f"{len(names)} interior fields)", lambda: api.BGC_SourceSink(
                      **ss_kw, diag_names=names), coeffs=1, k1=1)
    want = dict(ss["cold"], diags={k: ss["cold"]["diags"][k] for k in names})
    n = compare_host("BGC_SourceSink with diag_names", got, want)
    try:
        api.BGC_SourceSink(**ss_kw, diag_names=PROD_FILTER)
    except KeyError:
        pass
    else:
        raise AssertionError("diag_names took names BGC_SourceSink does "
                             "not emit")
    log(f"host API diag_names: {n} values bitwise the full run's; the "
        f"history's surface fields raise KeyError")

    log(f"host API checks, the adapter and the filter: "
        f"{time.perf_counter() - t_phase:.1f} s")

    # -- one warm pair under OBGC_X0_SEED=1 --
    os.environ["OBGC_X0_SEED"] = "1"
    try:
        seeded = counted("the seeded warm pair", lambda: (
            api.BGC_SourceSink(**warm_kw), api.BGC_SurfaceFluxes(**swarm_kw)),
            coeffs=1, k1_seeded=1, brackets_seeded=1)
    finally:
        del os.environ["OBGC_X0_SEED"]
    h = max(float(np.abs(10.0 ** -seeded[i][k] - 10.0 ** -w[k]).max())
            for i, w, keys in ((0, ss["warm"], ("PH_PREV_3D",
                                                "PH_PREV_ALT_CO2_3D")),
                               (1, sf["warm"], ("surface_pH",
                                                "surface_pH_alt_co2")))
            for k in keys)
    finite = all(np.isfinite(v).all() for out in seeded
                 for v in out.values() if isinstance(v, np.ndarray))
    log(f"host API seeded warm pair against the unseeded: max|dH|/xacc "
        f"{h / xacc:.3g} (limit 2), finite {finite}")
    if not (finite and h <= 2 * xacc):
        raise AssertionError("host API: the seeded pair is off the "
                             "unseeded roots")

    # -- the env staleness guard and checked_step --
    import dataclasses
    stale = dataclasses.replace(
        forcing, potential_temperature=forcing.potential_temperature + 0.5)
    os.environ["OBGC_CHECK_ENV"] = "1"
    try:
        bgc_source_sink(b.tracers, grid, forcing, *ph, p,
                        compute_diags=False, env=env)
        try:
            bgc_source_sink(b.tracers, grid, stale, *ph, p,
                            compute_diags=False, env=env)
        except ValueError as exc:
            log(f"staleness guard: a fresh env cache passes; a stale one "
                f"raises: {str(exc)[:60]}...")
        else:
            raise AssertionError("the staleness guard let a stale env "
                                 "cache through")
    finally:
        del os.environ["OBGC_CHECK_ENV"]
    col = int(torch.nonzero(grid.kmax > 0)[0])

    def poisoned(s):
        new, d = step(s, grid, forcing, params, DT, compute_diags=False,
                      env=env)
        tr = new.bgc.tracers.clone()
        tr[0, T.DIC, col] = float("nan")
        return dataclasses.replace(
            new, bgc=dataclasses.replace(new.bgc, tracers=tr)), d
    checked_step(lambda s: step(s, grid, forcing, params, DT,
                                compute_diags=False, env=env), grid)(state)
    try:
        checked_step(poisoned, grid)(state)
    except FloatingPointError as exc:
        log(f"checked_step: a clean step passes; a NaN injected into the "
            f"state raises: {str(exc)[:60]}...")
    else:
        raise AssertionError("checked_step let a NaN through")

    # -- times: wall (numpy in, numpy out), device, and the three parts --
    log(f"host API checks: {time.perf_counter() - t_phase:.1f} s")
    log(f"host API times at {NLEV}x{NCOL} f64 (wall: numpy in, numpy out, "
        f"median of 3; device: profiler, one call; parts: median of 3, "
        f"each synchronised):")
    dev = grid.kmax.device

    def k1_text(kernels):
        k1 = {k: v for k, v in kernels.items()
              if "coeffs_kernel" in k or "lanes_kernel" in k}
        return ", ".join(f"{k[:60]} {v:.4f} ms"
                         for k, v in sorted(k1.items())) or "not measured"

    with gates_paused():
        for name, args in (("BGC_SourceSink", warm_kw),
                           ("BGC_SurfaceFluxes", swarm_kw),
                           ("DMS_SourceSink", kw["DMS_SourceSink"]),
                           ("DMS_SurfaceFluxes", kw["DMS_SurfaceFluxes"]),
                           ("MACROS_SourceSink", kw["MACROS_SourceSink"])):
            fn = getattr(api, name)
            prm = {"BGC": p, "DMS": params.dms, "MACROS": params.macros}[
                name.split("_")[0]]
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(**args)
                walls.append((time.perf_counter() - t0) * 1e3)
            kernels = device_kernels_ms(lambda: fn(**args))
            parts = api.PARTS[name]
            split = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ins = parts.ingest(dev, None, **args)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = parts.compute(ins, prm)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                parts.egress(out, None)
                t3 = time.perf_counter()
                split.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                              (t3 - t2) * 1e3))
            ing, comp, egr = (statistics.median(x) for x in zip(*split))
            busy = sum(kernels.values())
            log(f"  {name} (warm): wall {statistics.median(walls):.3f} ms "
                f"(rounds {', '.join(f'{w:.1f}' for w in walls)}); device "
                f"busy (kernels and copies) "
                + (f"{busy:.3f} ms" if busy > 0 else "not measured")
                + f"; ingest {ing:.3f} ms, compute {comp:.3f} ms, egress "
                f"{egr:.3f} ms")
            if name.startswith("BGC"):
                log(f"    K1 in it (profiler): {k1_text(kernels)}")
        log(f"    K1 in a cold BGC_SourceSink (profiler): " + k1_text(
            device_kernels_ms(lambda: api.BGC_SourceSink(**ss_kw))))

        # -- the BGC tracer block's ingest, part by part, and the same block
        # copied as the host holds it and transposed on the card --
        blk = ss_kw["BGC_tracers"]

        def med(fn):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)

        def staged(a):
            buf = torch.empty(a.shape, dtype=torch.float64, pin_memory=True)
            buf.copy_(torch.from_numpy(a))
            return buf

        def on_card():
            return staged(blk).to(dev, non_blocking=True).permute(
                1, 2, 0).contiguous()

        packed = host_layout.pack_tracer_block(blk)
        pinned = staged(packed)
        same = torch.equal(on_card(), pinned.to(dev))
        t_pack = med(lambda: host_layout.pack_tracer_block(blk))
        t_stage = med(lambda: staged(packed))
        t_copy = med(lambda: pinned.to(dev, non_blocking=True))
        log(f"  BGC tracer block ingest ({blk.nbytes / 1e6:.1f} MB): "
            f"transpose (host_layout) {t_pack:.3f} ms, copy into pinned "
            f"memory {t_stage:.3f} ms, to the card {t_copy:.3f} ms; the "
            f"host's block staged, copied and transposed on the card "
            f"{med(on_card):.3f} ms, bitwise the same tensor {same}")
        if not same:
            raise AssertionError("a transpose on the card differs from the "
                                 "host's")


# P's shapes besides the probe's (levels, columns; kmax over 0..nlev) and
# the tiles (columns a block) timed at the probe's shape
PROBE_NLEVS, PROBE_NCOLS = (1, 12, 60), (1, 31, 33, 257, 8192)
PROBE_TILES = (1, 2, 4, 8, 16, 32)


def probe_phase():
    """Phase 9: P on its own path (probe.run), counted, then against its
    plain version at the probe's shape and at every shape of PROBE_NLEVS
    x PROBE_NCOLS; its launch shape, and its time in each tile of
    PROBE_TILES in turns beside the launch floor (an empty kernel of the
    default launch's shape); returns its kernel entry's numbers."""
    from ocean_bgc_tpu_torch import probe
    from ocean_bgc_tpu_torch.utils.profiling import counters
    before = counters()["probe"]
    out, tend, checksum = probe.run()
    torch.cuda.synchronize()
    launches = counters()["probe"] - before
    args = probe.probe_inputs()
    want = probe.probe_patterns_torch(*args)
    rel = probe.max_rel_err((out, tend), want)
    err = max((g - w).abs().max().item() for g, w in zip((out, tend), want))
    tile, blocks, threads = probe.launch_shape(probe.NLEV, probe.C)
    log(f"P: launches {launches}, {blocks} blocks of {threads} threads "
        f"({tile} columns a block), checksum {checksum:.6g}, max error / "
        f"scale {rel:.3g} (limit {probe.RTOL:g}), max abs error {err:.3g}")
    if launches != 1 or not rel <= probe.RTOL or blocks < 2:
        raise AssertionError("P disagrees with its plain version, or runs "
                             "in one block")
    worst = 0.0
    for nlev in PROBE_NLEVS:
        for seed, ncol in enumerate(PROBE_NCOLS):
            shaped = probe.shaped_inputs(nlev, ncol, seed=seed)
            before = counters()["probe"]
            r = probe.max_rel_err(probe.probe_patterns(*shaped),
                                  probe.probe_patterns_torch(*shaped))
            worst = max(worst, r)
            if counters()["probe"] != before + 1 or not (
                    r <= probe.RTOL):
                raise AssertionError(f"P at {nlev} x {ncol}: max error / "
                                     f"scale {r:.3g}")
    log(f"P at {PROBE_NLEVS} levels x {PROBE_NCOLS} columns (kmax over "
        f"0..nlev): worst max error / scale {worst:.3g} (limit "
        f"{probe.RTOL:g}), one launch each")
    fns = {f"tile {t}": lambda t=t: probe._launch(*args, tile=t)
           for t in PROBE_TILES}
    fns["floor"] = empty_launch(blocks, threads)
    turns = in_turns(f"P at {probe.NLEV}x{probe.NTR}x{probe.C}, blocks of "
                     f"each tile's columns, and the launch floor (an empty "
                     f"kernel of {blocks} blocks of {threads} threads)", fns)
    ms, floor_ms = turns[f"tile {probe.TILE}"], turns["floor"]
    plain_ms = cuda_ms(lambda: probe.probe_patterns_torch(*args), reps=1,
                       warmup=1, rounds=3)
    tr, temp, kmax = args
    # Newton steps per cell, as the plain version's per-lane loop takes
    # them
    x, act, iters = torch.ones_like(temp), torch.ones_like(temp, dtype=bool), 0
    for _ in range(20):
        xn = 0.5 * (x + temp / torch.clamp_min(x, 1e-6))
        iters += int(act.sum())
        conv = (xn - x).abs() < 1e-4
        x = torch.where(act, xn, x)
        act = act & ~conv
    ops = temp.numel() * OPS_P_CELL + iters * OPS_P_NEWTON
    nbytes = sum(t.numel() * t.element_size()
                 for t in (tr, temp, kmax, out, tend))
    bound_ms, bound_by = bound(nbytes, ops, torch.float32)
    log(f"P: {ms:.4f} ms/launch in {tile}-column tiles, launch floor "
        f"{floor_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.2e} "
        f"ms by {bound_by} (by bytes {bound(nbytes, 0, torch.float32)[0]:.2e}"
        f" ms, {nbytes} B; by operations "
        f"{bound(0, ops, torch.float32)[0]:.2e} ms, {ops} op)")
    return dict(launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                floor_ms=floor_ms)


def oracle_check(params):
    """One f64 step on the card of a small flat world against the scalar
    NumPy/SciPy oracle (tests/oracle/coupled_ref.py: brentq pH,
    independent constant fits), with the pre-chaos tolerances of
    tests/test_trajectory.py: rtol 2e-4 (atol 1e-10) for DIC, DIC_ALT_CO2,
    O2 and ALK, which carry the pH solve's tolerance, 5e-7 (atol 1e-18)
    for the other tracers, DMS and MACROS."""
    import numpy as np
    from ocean_bgc_tpu_torch.models.coupled import step
    from ocean_bgc_tpu_torch.ops.bgc import precompute_env
    from ocean_bgc_tpu_torch.state import BGCTracers as T
    from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world
    bind_tests()
    from tests.oracle.coupled_ref import coupled_step_ref
    state, grid, forcing = synthetic_world(nlev=6, ncol=4, seed=31,
                                           ragged=False)
    env = precompute_env(grid, forcing, params.bgc)
    got, _ = step(state, grid, forcing, params, DT, compute_diags=False,
                  env=env)
    b = state.bgc
    ostate = dict(tracers=b.tracers.cpu().numpy(),
                  ph_prev=b.ph_prev_3d.cpu().numpy(),
                  ph_prev_alt=b.ph_prev_alt_3d.cpu().numpy(),
                  surface_ph=b.surface_ph.cpu().numpy(),
                  surface_ph_alt=b.surface_ph_alt.cpu().numpy(),
                  dms=state.dms.cpu().numpy(),
                  macros=state.macros.cpu().numpy())
    as_np = {k: v.cpu().numpy() for k, v in vars(grid).items()}
    fs_np = {k: v.cpu().numpy() for k, v in vars(forcing).items()}
    want = coupled_step_ref(ostate, as_np, fs_np, params, DT)
    a = got.bgc.tracers.cpu().numpy()
    worst = 0.0
    for idx in range(T.CNT):
        solve = idx in (T.DIC, T.DIC_ALT_CO2, T.O2, T.ALK)
        rtol, atol = (2e-4, 1e-10) if solve else (5e-7, 1e-18)
        w = want["tracers"][:, idx]
        err = np.abs(a[:, idx] - w) / (atol + rtol * np.abs(w))
        worst = max(worst, float(err.max()))
    for name in ("dms", "macros"):
        w = want[name]
        err = np.abs(getattr(got, name).cpu().numpy() - w) / (
            1e-18 + 5e-7 * np.abs(w))
        worst = max(worst, float(err.max()))
    log(f"oracle check (f64 step on the card, 6x4 flat world vs "
        f"tests/oracle/coupled_ref.py): worst error / tolerance "
        f"{worst:.3g} (limit 1)")
    if not worst <= 1.0:
        raise AssertionError("the step disagrees with the scalar oracle")


def off_window(ph):
    """``ph`` moved off its warm window, by +0.5 and -0.5 (more than
    DEL_PH) on alternate cells, so that the seeded solve first grows its
    bracket; 0 (no previous solution) kept."""
    idx = torch.arange(ph.numel(), device=ph.device).view(ph.shape)
    step = torch.where(idx % 2 == 0, 0.5, -0.5).to(ph.dtype)
    return torch.where(ph != 0.0, ph + step, ph).contiguous()


def iteration_stats(stats, warm):
    """(mean, 99th percentile) of the per-problem iteration counts of
    ``stats`` (one per scenario) over its problems where ``warm``."""
    it = torch.cat([st["iters"][w].double() for st, w in zip(stats, warm)])
    return it.mean().item(), torch.quantile(it, 0.99).item()


def quantiles_text(iters):
    """p50 / p90 / p99 / max of the per-problem step counts ``iters``."""
    it = iters.double().reshape(-1)
    q = torch.quantile(it, torch.tensor([0.5, 0.9, 0.99], dtype=it.dtype,
                                        device=it.device)).tolist()
    return (f"p50 {q[0]:.0f}, p90 {q[1]:.0f}, p99 {q[2]:.0f}, max "
            f"{it.max().item():.0f}")


def issued_per_problem(iters, cap, threads):
    """Lane-steps a schedule issues per problem (Newton-or-bisection
    steps only; a warp issues 32 lane-steps per step of its slowest
    lane), from the plain version's per-lane step counts ``iters`` (one
    tensor per problem of a lane, lanes in launch order) on blocks of
    ``threads``: with ``cap`` >= MAXIT each warp runs as long as its lane
    with the most steps; with a smaller one each lane runs its problems
    up to ``cap`` steps each, and each block's parked problems, with the
    rest of their lanes, run in its first warps, one per thread in lane
    order."""
    its = [i.reshape(-1).long() for i in iters]
    n = its[0].numel()
    first = torch.zeros_like(its[0])
    rest = torch.zeros_like(its[0])
    parked = torch.zeros_like(its[0], dtype=torch.bool)
    for it in its:
        rest += torch.where(parked, it, 0)
        now = ~parked & (it > cap)
        first += torch.where(parked, 0, it.clamp(max=cap))
        rest += torch.where(now, it - cap, 0)
        parked |= now
    blocks = -(-n // threads)
    pad = blocks * threads - n
    first, rest = (torch.nn.functional.pad(t, (0, pad))
                   for t in (first, rest))
    parked = torch.nn.functional.pad(parked, (0, pad))
    issued = 32 * first.view(-1, 32).max(1).values.sum().item()
    key = (~parked).long().view(blocks, threads) * threads + torch.arange(
        threads, device=first.device)
    dense = rest.view(blocks, threads).gather(1, key.argsort(dim=1))
    issued += 32 * dense.view(blocks, -1, 32).max(2).values.sum().item()
    return issued / (len(its) * n)


def compare(label, got, want):
    """Raise unless ``got`` and ``want`` (sequences of tensors) are
    bitwise equal and finite; returns the max abs error (0)."""
    differ = sum(int((g != w).sum()) for g, w in zip(got, want))
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    n = sum(g.numel() for g in got)
    log(f"{label}: {differ} of {n} output values differ (limit 0, "
        f"bitwise), max abs error {err:.3g}, finite {finite}")
    if differ or not finite or len(got) != len(want):
        raise AssertionError(f"{label}: the outputs differ")
    return err


# the parked-tail caps at which check_seeded holds the seeded f32 dual
# instance bitwise (besides its default and MAXIT), those it times, and
# the block sizes it times every seeded instance at
SEEDED_CHECK_CAPS = (0, 1)
SEEDED_SWEEP_CAPS = (0, 1, 2, 3, 4, 6)
SEEDED_SWEEP_THREADS = (32, 64, 128, 256)


def empty_launch(blocks, threads):
    """A function that launches an empty kernel of ``blocks`` blocks of
    ``threads`` on the current stream: the launch floor of a kernel of
    that shape, timed as the kernel is."""
    import ctypes

    from ocean_bgc_tpu_torch.ops import _kernels
    lib = _kernels.load("carbonate_dual")
    lib.obgc_empty_launch.argtypes = [ctypes.c_uint, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.obgc_empty_launch.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: lib.obgc_empty_launch(blocks, threads, stream)


def in_turns(label, fns, reps=20):
    """Device ms per call of each of ``fns`` ({name: fn}), each timed
    behind the device sleep, in turns a, b, ..., b, a; the mean of each
    one's two turns.  Logs every turn."""
    order = list(fns) + list(fns)[::-1]
    with gates_paused():
        times = [(k, cuda_ms(fns[k], reps=reps, device_only=True))
                 for k in order]
    log(f"{label}, in turns: " + ", ".join(f"{k} {t:.4f}"
                                           for k, t in times) + " ms")
    return {k: statistics.mean(t for j, t in times if j == k) for k in fns}


def seeded_sweep(label, fn, iters, threads0, cap0=None):
    """Device ms per call of ``fn(threads=)`` one lane per thread at each
    sweep block size, and, where the instance parks (``cap0``, its
    default cap; ``fn`` then takes ``cap=`` too), at each sweep cap in
    the default blocks of ``threads0`` and at ``cap0`` at each block
    size; each logged beside the modelled lane-steps per problem
    (:func:`issued_per_problem` on the plain version's counts
    ``iters``).  Returns the block size of the fastest one-lane launch."""
    from ocean_bgc_tpu_torch.constants import MAXIT
    one = {} if cap0 is None else dict(cap=MAXIT)
    arms = {"one lane per thread": (MAXIT, one)}
    if cap0 is not None:
        arms[f"cap {cap0}"] = (cap0, dict(cap=cap0))
    with gates_paused():
        caps = [(c, cuda_ms(lambda c=c: fn(cap=c), reps=20,
                            device_only=True),
                 issued_per_problem(iters, c, threads0))
                for c in (*SEEDED_SWEEP_CAPS, MAXIT)] if cap0 is not None else []
        rows = {arm: [(t, cuda_ms(lambda t=t, kw=kw: fn(threads=t, **kw),
                                  reps=20, device_only=True),
                       issued_per_problem(iters, c, t))
                      for t in SEEDED_SWEEP_THREADS]
                for arm, (c, kw) in arms.items()}
    if caps:
        log(f"{label} sweep, {threads0}-thread blocks: " + ", ".join(
            f"cap {c} {t:.4f} ms (model {m:.3f})" for c, t, m in caps))
    for arm, row in rows.items():
        log(f"{label} sweep, {arm}: " + ", ".join(
            f"{k} threads {t:.4f} ms (model {m:.3f})" for k, t, m in row))
    return min(rows["one lane per thread"], key=lambda r: r[1])[0]


def check_seeded(dtype, world, env, warm_state):
    """Driver phase, part 1: K1's seeded variants against their seeded
    plain versions on cold, warm, off-window and mixed inputs (bitwise,
    every output), the f32 dual instance at the parked-tail caps 0, 1,
    its default and MAXIT, the bracket-in instance also in 256-thread
    blocks; then on the warm inputs each one's time per launch in its
    default schedule, one lane per thread in the fastest blocks of a
    sweep of block sizes (and caps, where it parks) and in 256-thread
    blocks, in turns behind a device sleep, the step counts' quantiles
    and the lane-steps each schedule issues per problem (from the plain
    version's counts), its plain version's time, its bound (operations
    from the seeded plain version's iteration counts), and the
    iterations per warm problem, seeded against unseeded; the
    coefficient-and-saturation route (the constants kernel, then the
    seeded dual instance) on env-off inputs too, and an empty kernel's
    launch as the floor beside the surface pair.  Returns {"dual",
    "brackets": the kernel entry's numbers}."""
    import dataclasses

    from ocean_bgc_tpu_torch.constants import MAXIT
    from ocean_bgc_tpu_torch.ops import cuda_carbonate as cc
    from ocean_bgc_tpu_torch.ops.bgc import carbonate_inputs
    from ocean_bgc_tpu_torch.ops.carbonate import _solve_htotal_impl
    state, grid, forcing = world
    name = str(dtype).split(".")[-1]
    # the dual instance parks at f32 only
    cap0 = cc.dual_cap(dtype)
    parks = cap0 < MAXIT
    caps = sorted({*SEEDED_CHECK_CAPS, cap0, MAXIT}) if parks else [MAXIT]

    def moved(st, surface, interior):
        b = st.bgc
        return dataclasses.replace(st, bgc=dataclasses.replace(
            b, surface_ph=surface(b.surface_ph),
            surface_ph_alt=off_window(b.surface_ph_alt),
            ph_prev_3d=interior(b.ph_prev_3d),
            ph_prev_alt_3d=off_window(b.ph_prev_alt_3d)))
    off = moved(warm_state, off_window, off_window)
    # the ambient problem warm and the ALT_CO2 one off its window, so
    # that ALT_CO2 problems park after their lane's ambient one is done
    mixed = moved(warm_state, lambda x: x, lambda x: x)
    cases = (("cold", state), ("warm", warm_state), ("off-window", off),
             ("mixed", mixed))
    res = {}

    def report(key, label, ms, plain_ms, bnd, seeded_it, plain_it, err):
        bound_ms, bound_by, nbytes, ops = bnd[:4]
        log(f"{label} {name} warm: {ms:.4f} ms/launch (default), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.4f} Gop); iterations per "
            f"warm problem: seeded mean {seeded_it[0]:.3f}, p99 "
            f"{seeded_it[1]:.0f}; unseeded mean {plain_it[0]:.3f}, p99 "
            f"{plain_it[1]:.0f}")
        res[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by)

    def timed(label, fn, iters, shape, cap, extra=None):
        """The sweep, then in turns the default schedule (``cap``, or
        one lane per thread where None), one lane per thread in the
        sweep's fastest blocks and in 256-thread blocks (and ``extra``);
        logs the default schedule, the step quantiles and the modelled
        lane-steps per problem of the default and of one lane per
        thread beside the measured times.  Returns the turns' means."""
        blocks, threads = shape
        one = {} if cap is None else dict(cap=MAXIT)
        best = seeded_sweep(label, fn, iters, threads, cap)
        turns = in_turns(label, dict(
            default=fn, one=lambda: fn(threads=best, **one),
            wide=lambda: fn(threads=256, **one), **(extra or {})))
        c = MAXIT if cap is None else cap
        m_one = issued_per_problem(iters, MAXIT, best)
        m_dflt = issued_per_problem(iters, c, threads)
        log(f"{label}: default "
            f"{'one lane per thread' if cap is None else f'cap {cap}'}, "
            f"{blocks} blocks of {threads} threads; steps per problem "
            f"{quantiles_text(torch.cat([i.reshape(-1) for i in iters]))}; "
            f"lane-steps issued per problem: default {m_dflt:.3f}, one lane "
            f"per thread in {best}-thread blocks {m_one:.3f} (model ratio "
            f"{m_dflt / m_one:.3f}); measured in turns: default "
            f"{turns['default']:.4f} ms, one lane per thread in the "
            f"sweep's fastest blocks ({best} threads) {turns['one']:.4f} ms "
            f"(ratio {turns['default'] / turns['one']:.3f}), one lane per "
            f"thread in 256-thread blocks {turns['wide']:.4f} ms")
        return turns

    # the cached-constants (dual) instance
    for label, st in cases:
        args = k1_inputs(st, grid, forcing, env)
        fields = (*args[:6], *args[6])
        want = cc.co3_terms_dual_coeffs_torch(*args, seed=True)
        want = (*want[0], *want[1])
        got = cc.co3_terms_dual_coeffs(*args, seed=True, impl="kernel")
        torch.cuda.synchronize()
        err = compare(f"K1 seeded {name} {label}", (*got[0], *got[1]), want)
        for cap in caps:
            compare(f"K1 seeded {name} {label} cap {cap}",
                    cc._launch(fields, dtype, True, cap=cap), want)
    args = k1_inputs(warm_state, grid, forcing, env)
    fields = (*args[:6], *args[6])
    stats = cc.co3_terms_dual_coeffs_torch(*args, with_stats=True,
                                           seed=True)[2]
    turns = timed(f"K1 seeded {name} warm",
                  lambda **kw: cc._launch(fields, dtype, True, **kw),
                  [st["iters"] for st in stats],
                  cc.seeded_schedule(fields[0]), cap0 if parks else None)
    plain_ms = cuda_ms(lambda: cc.co3_terms_dual_coeffs_torch(
        *args, seed=True), reps=1, warmup=1, rounds=3)
    warm = (args[4] != 0.0, args[5] != 0.0)
    its = [iteration_stats(cc.co3_terms_dual_coeffs_torch(
        *args, with_stats=True, seed=sd)[2], warm) for sd in (True, False)]
    report("dual", "K1 seeded", turns["default"], plain_ms,
           k1_bound(args, dtype, True), *its, err)

    # the coefficient-and-saturation route: the constants kernel, then
    # the seeded dual instance on its constants
    def route(sargs, **kw):
        coeffs, sat = cc.carbonate_coeffs_sat(*sargs[:3], impl="kernel")
        return (*cc._launch((*sargs[3:], *coeffs), dtype, True, **kw), *sat)

    for label, st in cases:
        b = st.bgc
        sargs = carbonate_inputs(b.tracers, grid, forcing, b.ph_prev_3d,
                                 b.ph_prev_alt_3d)
        want = cc.co3_terms_dual_sat_torch(*sargs, seed=True)
        want = [x for part in want for x in part]
        got = cc.co3_terms_dual_sat(*sargs, seed=True, impl="kernel")
        torch.cuda.synchronize()
        err = compare(f"K1 coefficient-and-saturation seeded {name} {label}",
                      [x for part in got for x in part], want)
        for cap in caps:
            compare(f"K1 coefficient-and-saturation seeded {name} {label} "
                    f"cap {cap}", route(sargs, cap=cap), want)
    b = warm_state.bgc
    sargs = carbonate_inputs(b.tracers, grid, forcing, b.ph_prev_3d,
                             b.ph_prev_alt_3d)
    stats = cc.co3_terms_dual_sat_torch(*sargs, seed=True,
                                        with_stats=True)[3]
    turns = timed(f"K1 coefficient-and-saturation route seeded {name} warm",
                  lambda **kw: route(sargs, **kw),
                  [st["iters"] for st in stats],
                  cc.seeded_schedule(sargs[3]), cap0 if parks else None)
    plain_ms = cuda_ms(lambda: cc.co3_terms_dual_sat_torch(
        *sargs, seed=True), reps=1, warmup=1, rounds=3)
    warm = (sargs[7] != 0.0, sargs[8] != 0.0)
    its = [iteration_stats(cc.co3_terms_dual_sat_torch(
        *sargs, seed=sd, with_stats=True)[3], warm) for sd in (True, False)]
    report("sat", "K1 coefficient-and-saturation route seeded",
           turns["default"], plain_ms, sat_bound(sargs, dtype, True,
                                                seed=True), *its, err)

    # the bracket-in instance, on the surface pair
    def bracket_fields(largs):
        return dict(dic=largs[1], x1=largs[5], x2=largs[6], x0=largs[7],
                    ta=largs[2], pt=largs[3], sit=largs[4],
                    **largs[0]._asdict())

    for label, st in cases:
        largs = surface_lanes(st, forcing, seed=True)
        want = _solve_htotal_impl(*largs[:7], x0=largs[7])
        got = cc.solve_htotal_brackets(*largs[:7], seed=largs[7],
                                       impl="kernel")
        torch.cuda.synchronize()
        err = compare(f"bracket-in K1 seeded {name} surface pair {label}",
                      (got,), (want,))
        compare(f"bracket-in K1 seeded {name} surface pair {label}, "
                f"256-thread blocks", (cc._launch_brackets(
                    bracket_fields(largs), threads=256),), (want,))
    largs = surface_lanes(warm_state, forcing, seed=True)
    fields = bracket_fields(largs)
    n = largs[1].numel()
    shape = cc.seeded_schedule(largs[1])
    iters = [_solve_htotal_impl(*largs[:7], x0=largs[7],
                                with_stats=True)[1]["iters"]]
    turns = timed(f"bracket-in K1 seeded {name} surface pair warm",
                  lambda **kw: cc._launch_brackets(fields, **kw), iters,
                  shape, None,
                  dict(floor=empty_launch(*shape)))
    log(f"bracket-in K1 seeded {name} surface pair: {shape[0]} blocks of "
        f"{shape[1]} threads ({n} lanes); launch floor (an empty kernel of "
        f"that shape, timed alike) {turns['floor']:.4f} ms")
    plain_ms = cuda_ms(lambda: _solve_htotal_impl(*largs[:7], x0=largs[7]),
                       reps=1, warmup=1, rounds=3)
    warm = largs[7] > 0.0
    its = [iteration_stats((_solve_htotal_impl(
        *largs[:7], x0=largs[7] if sd else None, with_stats=True)[1],),
        (warm,)) for sd in (True, False)]
    report("brackets", "bracket-in K1 seeded (surface pair)",
           turns["default"], plain_ms, bracket_bound(largs, dtype), *its,
           err)
    return res


# the keys of the JAX driver's summary line (ocean_bgc_tpu/run_model.py:
# 249-257; tests/test_torch_driver.py holds the port's to them)
SUMMARY_KEYS = {"steps", "columns", "columns_per_s", "elapsed_s",
                "final_checkpoint", "max_abs_Jint_Ctot", "finite"}
HEALTH_TOTALS = {"health_solver_nonconverged_cells_total",
                 "health_poc_error_cells_total"}
# the forcing series' record spacing: 24 one-hour steps cross 3 records
RECORD_DT = 8 * 3600.0


def write_driver_files(tmp, world):
    """The world file and a 3-record forcing series for the driver: the
    world's forcing with T (and SST) shifted by 0, +0.5 and -0.5 C."""
    import dataclasses

    from ocean_bgc_tpu_torch.io.model_io import save_world
    from ocean_bgc_tpu_torch.models.forcing_series import (
        save_forcing_series, stack_forcings)
    state, grid, forcing = world
    paths = (os.path.join(tmp, "world.nc"), os.path.join(tmp, "series.nc"))
    save_world(paths[0], state, grid, forcing)
    series = stack_forcings([dataclasses.replace(
        forcing, potential_temperature=forcing.potential_temperature + dt,
        sst=forcing.sst + dt) for dt in (0.0, 0.5, -0.5)])
    save_forcing_series(paths[1], series, record_dt=RECORD_DT)
    return paths


def run_driver(label, argv, want_counts=None):
    """``run_model.main(argv)`` with every launch counted; returns its
    summary (its last line of output)."""
    import contextlib
    import io

    from ocean_bgc_tpu_torch import run_model
    buf = io.StringIO()
    reset_counts()
    with gates_paused():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = run_model.main([*argv, "--quiet"])
        wall = time.perf_counter() - t0
    counts = read_counts()
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"driver, {label}: rc {rc}, {wall:.1f} s; summary {summary}; "
        f"launches { {k: v for k, v in counts.items() if v} }")
    if rc != 0 or not summary["finite"] or not SUMMARY_KEYS <= set(summary):
        raise AssertionError(f"driver run {label} failed: rc {rc}, "
                             f"{summary}")
    if want_counts is not None and counts != expected(**want_counts):
        raise AssertionError(f"driver run {label}: launches {counts}, "
                             f"expected {expected(**want_counts)}")
    return summary


def driver_phase(dtype, tmp, files, f64_only):
    """Driver phase, part 2: ``python -m ocean_bgc_tpu_torch.run_model``
    through ``run_model.main`` on the world file and the forcing series:
    24 held-record steps with the solver seed, history of the 10-field
    filter every 12 steps, checkpoints every 12 and health, its launches
    counted; a resume from the step-12 checkpoint (bitwise the 24-step
    run's final state); then (``f64_only``) linear interpolation, RK2, RK4,
    no env cache, and each forcing's columns/s seeded and unseeded.
    Returns the main run's launch counts."""
    from ocean_bgc_tpu_torch.utils import checkpoint as ckpt
    from ocean_bgc_tpu_torch.utils.history import read_history
    name = str(dtype).split(".")[-1]
    world, series = files
    fp = ["--fp32"] if dtype == torch.float32 else []
    base = ["--world", world, *fp]
    forced = [*base, "--forcing-series", series]
    out_a, out_b = (os.path.join(tmp, f"{name}_{x}") for x in "ab")
    hist = ["--history-every", "12", "--history-fields", ",".join(PROD_FILTER),
            "--checkpoint-every", "12", "--health", "--solver-seed"]
    # 24 steps cross 3 records: the env cache rebuilt 3 times (the stand-in
    # solve on the unseeded bracket-in instance); each step's interior on
    # the seeded dual instance and its surface pair on the seeded
    # bracket-in instance; the summary's closing step (no env cache,
    # Jint_Ctot) one launch of the constants kernel, one of the seeded
    # dual instance on its constants and one seeded surface pair
    main_counts = dict(k1_seeded=25, coeffs=1, brackets_seeded=25,
                       brackets=3)
    a = run_driver(f"{name}, hold, seeded, 24 steps", [
        *forced, "--interp", "hold", *hist, "--steps", "24", "--out", out_a,
        "--save-world", os.path.join(out_a, "final.nc")], main_counts)
    if not HEALTH_TOTALS <= set(a):
        raise AssertionError("the driver's summary has no health totals")
    for step_no in (12, 24):
        means, count, _ = read_history(
            os.path.join(out_a, f"hist_{step_no:06d}.npz"))
        missing = set(PROD_FILTER) - set(means)
        bad = [k for k, v in means.items() if not torch.isfinite(
            torch.as_tensor(v)).all()]
        log(f"driver, {name}: history at step {step_no}: {count} steps, "
            f"fields {sorted(means)}, missing {sorted(missing)}, "
            f"non-finite {bad}")
        if count != 12 or missing or bad:
            raise AssertionError("the driver's history is incomplete")
    b = run_driver(f"{name}, resumed at step 12, 12 steps", [
        *forced, "--interp", "hold", *hist, "--netcdf-history",
        "--restore", os.path.join(out_a, "ck_000012"), "--steps", "12",
        "--out", out_b])
    if not os.path.exists(os.path.join(out_b, "hist_000024.nc")):
        raise AssertionError("the resumed run wrote no NetCDF history")
    sa, na = ckpt.restore(a["final_checkpoint"])
    sb, nb = ckpt.restore(b["final_checkpoint"])
    fields = ("tracers", "ph_prev_3d", "ph_prev_alt_3d", "surface_ph",
              "surface_ph_alt")
    differ = sum(int((getattr(sa.bgc, f) != getattr(sb.bgc, f)).sum())
                 for f in fields)
    differ += int((sa.dms != sb.dms).sum()) + int((sa.macros != sb.macros)
                                                  .sum())
    log(f"driver, {name}: 24 straight steps against 12 + restore + 12: "
        f"{differ} values differ (limit 0, bitwise), steps {na} / {nb}")
    if differ or na != 24 or nb != 24:
        raise AssertionError("the resumed run differs from the straight one")
    if not f64_only:
        return main_counts
    run_driver(f"{name}, linear, seeded, 6 steps", [
        *forced, "--interp", "linear", "--solver-seed", "--steps", "6",
        "--out", os.path.join(tmp, "linear")],
        dict(coeffs=7, k1_seeded=7, brackets_seeded=7))
    run_driver(f"{name}, rk2, seeded, 2 steps", [
        *base, "--integrator", "rk2", "--solver-seed", "--steps", "2",
        "--out", os.path.join(tmp, "rk2")],
        dict(k1_seeded=5, coeffs=1, brackets=1, brackets_seeded=5))
    run_driver(f"{name}, rk4, seeded, 2 steps", [
        *base, "--integrator", "rk4", "--solver-seed", "--steps", "2",
        "--out", os.path.join(tmp, "rk4")],
        dict(k1_seeded=9, coeffs=1, brackets=1, brackets_seeded=9))
    run_driver(f"{name}, no env cache, 2 steps", [
        *base, "--no-env-cache", "--steps", "2", "--out",
        os.path.join(tmp, "noenv")], dict(coeffs=3, k1=3, brackets=3))
    for label, extra in (("constant forcing", base),
                         ("hold", [*forced, "--interp", "hold"]),
                         ("linear", [*forced, "--interp", "linear"])):
        for seed in ([], ["--solver-seed"]):
            run_driver(f"{name}, {label}, {'seeded' if seed else 'unseeded'}"
                       f", 8 steps (columns/s)", [
                           *extra, *seed, "--steps", "8", "--out",
                           os.path.join(tmp, "rate")])
    return main_counts


def forced_runs(params, world, series_path):
    """``run_forced`` under the forcing series with the env tables blended
    between records (``env_mode="interp"``) and held per record
    (``"hold"``), 6 steps each crossing a record: finite states."""
    from ocean_bgc_tpu_torch.models.forcing_series import (
        load_forcing_series, run_forced)
    state, grid, _ = world
    series, _ = load_forcing_series(series_path)
    for interp, env_mode in (("linear", "interp"), ("hold", "hold")):
        with gates_paused():
            t0 = time.perf_counter()
            final, _ = run_forced(state, grid, series, params, DT, 6, 3 * DT,
                                  interp=interp, env_mode=env_mode)
            torch.cuda.synchronize()
            ok = all(bool(torch.isfinite(t).all()) for t in (
                final.bgc.tracers, final.dms, final.macros))
            log(f"run_forced (interp {interp!r}, env_mode {env_mode!r}), 6 "
                f"f64 steps at {NLEV}x{NCOL}: "
                f"{time.perf_counter() - t0:.2f} s, finite {ok}")
        if not ok:
            raise AssertionError(f"run_forced ({env_mode}) is not finite")


def seed_qualification(params, ctx):
    """Driver phase, part 3: TRAJ_STEPS seeded f64 steps against as many
    unseeded ones from the same state (env cache, diagnostics off), inside
    tests/test_x0_seed_trajectory.py's envelope: per tracer, 30 times the
    response to a 1e-11 relative kick of the initial tracers plus 1e-3 of
    the tracer's scale.  The unseeded run continues the main path's first
    steps.  The seed must change the result."""
    import dataclasses

    from ocean_bgc_tpu_torch.models.coupled import step
    from ocean_bgc_tpu_torch.state import BGC_TRACER_NAMES
    state0, grid, forcing = ctx["world"]
    env, default = ctx["env"], ctx["after"]

    def run(s, steps=TRAJ_STEPS):
        for _ in range(steps):
            s, _ = step(s, grid, forcing, params, DT, compute_diags=False,
                        env=env)
        return s.bgc.tracers

    t0 = time.perf_counter()
    os.environ["OBGC_X0_SEED"] = "1"
    try:
        reset_counts()
        seeded = run(state0)
        counts = read_counts()
    finally:
        del os.environ["OBGC_X0_SEED"]
    if counts != expected(k1_seeded=TRAJ_STEPS, brackets_seeded=TRAJ_STEPS):
        raise AssertionError(f"seeded steps' launches {counts}")
    ref = run(default[-1], TRAJ_STEPS - len(default))
    pert = dataclasses.replace(state0, bgc=dataclasses.replace(
        state0.bgc, tracers=state0.bgc.tracers * (1.0 + 1e-11)))
    yard = (run(pert) - ref).abs()
    worst, fails = 0.0, []
    for idx in range(len(BGC_TRACER_NAMES)):
        mismatch = (seeded[:, idx] - ref[:, idx]).abs().max().item()
        scale = ref[:, idx].abs().max().item() + 1e-30
        limit = 30.0 * yard[:, idx].max().item() + 1e-3 * scale + 1e-12
        worst = max(worst, mismatch / limit)
        if not mismatch <= limit:
            fails.append(f"{BGC_TRACER_NAMES[idx]} {mismatch:.3e} > "
                         f"{limit:.3e}")
    changed = not torch.equal(seeded, ref)
    log(f"seed qualification f64: {TRAJ_STEPS} seeded vs unseeded steps at "
        f"{NLEV}x{NCOL}: worst mismatch / envelope {worst:.3g} (limit 1), "
        f"the seed changed the tracers {changed}, finite "
        f"{bool(torch.isfinite(seeded).all())} "
        f"({time.perf_counter() - t0:.1f} s)")
    if fails or not changed or not torch.isfinite(seeded).all():
        raise AssertionError(f"seeded trajectory outside the envelope, or "
                             f"the seed had no effect: {fails}")


def big_step(params):
    """Phase 6: one f64 step of each interior at 60 x NCOL_BIG columns,
    timed on its first call, with its peak device memory."""
    from ocean_bgc_tpu_torch.models.coupled import step
    from ocean_bgc_tpu_torch.ops.bgc import precompute_env
    from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world
    state, grid, forcing = synthetic_world(nlev=NLEV, ncol=NCOL_BIG,
                                           seed=SEED, ragged=True)
    env = precompute_env(grid, forcing, params.bgc)
    state_gb = sum(t.numel() * t.element_size() for t in (
        state.bgc.tracers, state.dms, state.macros)) / 1e9
    for impl in ("auto", "fused"):
        with gates_paused():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out, _ = step(state, grid, forcing, params, DT,
                          compute_diags=False, env=env, interior_impl=impl)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ok = all(torch.isfinite(t).all().item() for t in (
            out.bgc.tracers, out.dms, out.macros, out.bgc.ph_prev_3d))
        log(f"f64 step (interior_impl={impl!r}) at {NLEV}x{NCOL_BIG}: "
            f"{wall:.3f} s (first call), prognostic state {state_gb:.2f} "
            f"GB, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB, finite {ok}")
        if not ok:
            raise AssertionError(f"non-finite state after the big f64 "
                                 f"step ({impl})")
        del out
    del env
    chunked_step(params, state, grid, forcing)


def chunked_step(params, state, grid, forcing):
    """Driver phase, part 4: one step of the big world streamed through
    the card in column chunks of CHUNK from pinned host memory
    (``step_chunked``) against the unchunked step (both without an env
    cache, diagnostics off, as the JAX package's chunked driver steps):
    the count of differing values (columns never interact, so 0 is
    expected and required), the wall times and the peak device memory."""
    from ocean_bgc_tpu_torch.models.chunked import host_world_like, step_chunked
    from ocean_bgc_tpu_torch.models.coupled import step
    def peak_above(base):
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    with gates_paused():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        want, _ = step(state, grid, forcing, params, DT, compute_diags=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = peak_above(base)
        host = host_world_like(state, grid, forcing)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        got = step_chunked(*host, params, DT, chunk=CHUNK)
        wall_chunked = time.perf_counter() - t0
    peak_chunked = peak_above(base)
    differ, total, where = 0, 0, []
    pairs = [(f, getattr(got.bgc, f), getattr(want.bgc, f)) for f in (
        "tracers", "ph_prev_3d", "ph_prev_alt_3d", "surface_ph",
        "surface_ph_alt")] + [("dms", got.dms, want.dms),
                              ("macros", got.macros, want.macros)]
    for f, g, w in pairs:
        n = int((g != w.cpu()).sum())
        differ, total = differ + n, total + g.numel()
        if n:
            where.append(f"{f} {n}")
    log(f"chunked f64 step at {NLEV}x{NCOL_BIG}, chunks of {CHUNK} columns "
        f"from pinned host memory: {differ} of {total} values differ from "
        f"the unchunked step ({where or 'none'}; limit 0), "
        f"{wall_chunked:.3f} s with a peak of {peak_chunked:.2f} GB of device "
        f"memory above what was resident, unchunked {wall:.3f} s (first "
        f"call) with {peak:.2f} GB above the resident world")
    if differ:
        raise AssertionError("the chunked step differs from the unchunked "
                             "one")


# the adjoint phase: steps of the sweep, the parameters it differentiates
# (dJ/d ln p), the width of the remat comparison, and the twin experiment
# of tests/test_adjoint.py:195-227 at its own size
ADJ_STEPS = 8
ADJ_PATHS = ("bgc.parm_kappa_nitrif", "bgc.autotrophs[0].PCref",
             "bgc.parm_POC_diss")
REMAT_NCOL = 1024
TWIN = dict(nlev=6, ncol=8, seed=73, steps=6, iters=60, lr=0.1, start=1.4)


def adjoint_functional(active):
    """J(final) = mean NO3**2 + mean surface DIC + mean interior pH of the
    active cells: the NO3 term is JAX's (tests/test_adjoint.py:168-169);
    the DIC term reaches the surface pair's implicit-function backward
    through the air-sea CO2 flux, the pH term the dual instance's, which
    the NO3 term never reaches."""
    from ocean_bgc_tpu_torch.state import BGCTracers as BT
    n_active = active.sum()

    def functional(final):
        return (torch.mean(final.bgc.tracers[:, BT.NO3] ** 2)
                + torch.mean(final.bgc.tracers[0, BT.DIC])
                + torch.where(active, final.bgc.ph_prev_3d, 0.0).sum()
                / n_active)
    return functional


def k1_backward_ms(world, params):
    """Wall ms of one backward of each K1 route a sweep's step passes, on
    the kernel (the dual instance on the env cache's constants, the
    surface pair's bracket-in instance), each from its inputs as leaves,
    and the bytes each must move (every input read once, every gradient
    written once)."""
    from ocean_bgc_tpu_torch.constants import (
        DEL_PH, PHHI_SURF_INIT, PHLO_SURF_INIT)
    from ocean_bgc_tpu_torch.ops import cuda_carbonate as cc
    from ocean_bgc_tpu_torch.ops.bgc import carbonate_inputs, precompute_env
    from ocean_bgc_tpu_torch.ops.carbonate import (
        _to_mass_units, carbonate_coeffs, warm_brackets_h)
    from ocean_bgc_tpu_torch.state import BGCTracers as T
    state, grid, forcing = world
    env = precompute_env(grid, forcing, params.bgc)
    out = {}
    dic, ta, pt, sit, pa, pb, coeffs = carbonate_inputs(
        state.bgc.tracers, grid, forcing, state.bgc.ph_prev_3d,
        state.bgc.ph_prev_alt_3d, env)
    leaves = [t.clone().requires_grad_() for t in (dic, ta, pt, sit, *coeffs)]
    outs = cc.co3_terms_dual_coeffs(*leaves[:4], pa, pb,
                                    cc.CarbCoeffs(*leaves[4:]))
    outs = (*outs[0], *outs[1])
    grads = [torch.ones_like(o) for o in outs]

    def dual():
        torch.autograd.grad(outs, leaves, grads, retain_graph=True,
                            allow_unused=True)
        torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*leaves, pa, pb, *grads, *leaves))
    out["dual"] = (_wall_ms(dual), nbytes)

    surf = torch.clamp_min(state.bgc.tracers[0], 0.0)
    coeffs_s = carbonate_coeffs(torch.zeros_like(forcing.sst), forcing.sst,
                                forcing.sss, False)
    d_a, ta_s, pt_s, sit_s = _to_mass_units(surf[T.DIC], surf[T.ALK],
                                            surf[T.PO4], surf[T.SIO3])
    d_b = _to_mass_units(surf[T.DIC_ALT_CO2], surf[T.ALK], surf[T.PO4],
                         surf[T.SIO3])[0]
    x1, x2 = warm_brackets_h(state.bgc.surface_ph, PHLO_SURF_INIT,
                             PHHI_SURF_INIT, DEL_PH)
    x1b, x2b = warm_brackets_h(state.bgc.surface_ph_alt, PHLO_SURF_INIT,
                               PHHI_SURF_INIT, DEL_PH)
    s_leaves = [t.clone().requires_grad_()
                for t in (torch.stack([d_a, d_b]), ta_s, pt_s, sit_s,
                          *coeffs_s)]
    h = cc.solve_htotal_brackets(cc.CarbCoeffs(*s_leaves[4:]),
                                 *s_leaves[:4], torch.stack([x1, x1b]),
                                 torch.stack([x2, x2b]))
    g_h = torch.ones_like(h)

    def pair():
        torch.autograd.grad(h, s_leaves, g_h, retain_graph=True,
                            allow_unused=True)
        torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*s_leaves, h, g_h, *s_leaves))
    out["surface"] = (_wall_ms(pair), nbytes)
    return out


def _wall_ms(fn, reps=5):
    """Median wall ms of ``fn`` (which synchronises) after one warm-up."""
    fn()
    times = []
    with gates_paused():
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def adjoint_phase(params, card):
    """Phase 8 (the adjoint, ``models/adjoint.py``) on the ragged world at
    60 x 8192 columns, f64 unless stated:

    (a) ``parameter_sensitivities`` of :func:`adjoint_functional` over
        ADJ_PATHS and ADJ_STEPS steps with remat, on the kernel route and
        on the plain route (``carbonate_impl="torch"``): within 1e-12
        relative (the routes' forwards are bitwise equal and they share
        their backward);
    (b) the kappa entry against central finite differences (+-1%) of two
        more forward runs, rtol 2e-3 (JAX's bound);
    (c) the sweep's K1 launches: the bracket-in instance 1 + 2 * steps
        (the stand-in, the surface pair's forward and its recompute), the
        dual instance 2 * steps, nothing else; the plain route only the
        stand-in's 1;
    (d) remat against no remat at 60 x REMAT_NCOL: the gradients with
        respect to the parameters and the initial tracers within 1e-12 of
        each one's largest, with each one's peak memory;
    (e) the twin experiment of tests/test_adjoint.py at its own size
        (TWIN): the loss falls at least 100-fold and PCref is recovered
        within 3%;
    (f) the f32 sweep of (a): finite, the signs of f64's; the relative
        difference printed, not gated;
    (g) seconds per forward and per backward step of a timed sweep, the
        K1 backwards' share of the backward (from their wall time alone on
        the step's inputs), peak memory."""
    import dataclasses

    from ocean_bgc_tpu_torch.models.adjoint import (
        calibrate, get_param, override_params, parameter_sensitivities,
        run_diff)
    from ocean_bgc_tpu_torch.state import BGCTracers as BT
    from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world

    def world_at(ncol, dtype=torch.float64, **kw):
        kw = dict(nlev=NLEV, ncol=ncol, seed=SEED, ragged=True, **kw)
        return synthetic_world(dtype=dtype, **kw)

    def sweep(world, **kw):
        state, grid, forcing = world
        return parameter_sensitivities(
            params, ADJ_PATHS, state, grid, forcing, DT, ADJ_STEPS,
            adjoint_functional(grid.active_mask()), **kw)

    t_phase = time.perf_counter()
    world = world_at(NCOL)
    # (a) and (c): the kernel route, counted, and the plain route
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with gates_paused():
        t0 = time.perf_counter()
        sens = sweep(world)
        torch.cuda.synchronize()
        wall_kernel = time.perf_counter() - t0
    counts = read_counts()
    peak_kernel = torch.cuda.max_memory_allocated() / 1e9
    want = expected(k1=2 * ADJ_STEPS, brackets=1 + 2 * ADJ_STEPS)
    log(f"adjoint (c): launches of the sweep, {ADJ_STEPS} steps with remat "
        f"at {NLEV}x{NCOL} f64: {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"the sweep's K1 launches {counts} != {want}")
    reset_counts()
    with gates_paused():
        t0 = time.perf_counter()
        sens_plain = sweep(world, carbonate_impl="torch")
        wall_plain = time.perf_counter() - t0
    counts = read_counts()
    if counts != expected(brackets=1):
        raise AssertionError(f"the plain route's sweep launched {counts}")
    worst = max(_rel(sens[p], sens_plain[p]) for p in ADJ_PATHS)
    log(f"adjoint (a): dJ/dln p, kernel route {sens}, plain route "
        f"{sens_plain}; largest relative difference {worst:.3e} (limit "
        f"1e-12); sweeps {wall_kernel:.2f} s kernel, {wall_plain:.2f} s "
        f"plain (first calls), {card}")
    if not (worst <= 1e-12 and all(map(math.isfinite, sens.values()))):
        raise AssertionError("kernel and plain routes' sensitivities "
                             "differ, or are not finite")

    # (b) the kappa entry against central finite differences
    state, grid, forcing = world
    functional = adjoint_functional(grid.active_mask())
    path = ADJ_PATHS[0]
    p0 = get_param(params, path)

    def j_of(value):
        with torch.no_grad():
            final = run_diff(state, grid, forcing,
                             override_params(params, {path: value}), DT,
                             ADJ_STEPS)
            return float(functional(final))
    fd = (j_of(1.01 * p0) - j_of(0.99 * p0)) / 0.02
    err = _rel(sens[path], fd)
    log(f"adjoint (b): {path} dJ/dln p {sens[path]!r} vs central finite "
        f"differences {fd!r}: relative difference {err:.3e} (limit 2e-3)")
    if not err <= 2e-3:
        raise AssertionError("the adjoint disagrees with finite differences")

    # (g) a timed sweep: forward and backward apart, and K1's backward
    theta = torch.ones(len(ADJ_PATHS), dtype=torch.float64,
                       device=state.bgc.tracers.device, requires_grad=True)
    over = override_params(params, {
        p: get_param(params, p) * theta[i] for i, p in enumerate(ADJ_PATHS)})
    with gates_paused():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        j = functional(run_diff(state, grid, forcing, over, DT, ADJ_STEPS))
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        t0 = time.perf_counter()
        torch.autograd.grad(j, theta)
        torch.cuda.synchronize()
        t_bwd = time.perf_counter() - t0
    peak_timed = torch.cuda.max_memory_allocated() / 1e9
    del j, over, theta
    k1b = k1_backward_ms(world, params)
    k1b_ms = k1b["dual"][0] + k1b["surface"][0]
    share = ADJ_STEPS * k1b_ms / (t_bwd * 1e3)
    k1b_bytes = k1b["dual"][1] + k1b["surface"][1]
    k1b_bound = k1b_bytes / HBM_BYTES_PER_S * 1e3
    log(f"adjoint (g), {card}: {ADJ_STEPS}-step sweep at {NLEV}x{NCOL} f64 "
        f"with remat: forward {t_fwd / ADJ_STEPS:.4f} s/step, backward "
        f"(recompute included) {t_bwd / ADJ_STEPS:.4f} s/step, peak device "
        f"memory {peak_timed:.2f} GB (the counted sweep's "
        f"{peak_kernel:.2f} GB); K1's backwards per step: dual "
        f"{k1b['dual'][0]:.3f} ms + surface pair {k1b['surface'][0]:.3f} "
        f"ms wall (byte bound {k1b_bound:.4f} ms), "
        f"{100 * share:.1f}% of the backward")
    del world

    # (d) remat against no remat at 60 x REMAT_NCOL
    state, grid, forcing = world_at(REMAT_NCOL)
    functional = adjoint_functional(grid.active_mask())
    grads, peaks = {}, {}
    for remat in (True, False):
        theta = torch.ones(len(ADJ_PATHS), dtype=torch.float64,
                           device=state.bgc.tracers.device,
                           requires_grad=True)
        tr = state.bgc.tracers.clone().requires_grad_()
        over = override_params(params, {
            p: get_param(params, p) * theta[i]
            for i, p in enumerate(ADJ_PATHS)})
        s0 = dataclasses.replace(state, bgc=dataclasses.replace(
            state.bgc, tracers=tr))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        j = functional(run_diff(s0, grid, forcing, over, DT, ADJ_STEPS,
                                remat=remat))
        grads[remat] = torch.autograd.grad(j, (theta, tr))
        peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 1e9
        del j
    diff = max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(grads[True], grads[False]))
    log(f"adjoint (d): remat vs no remat, {ADJ_STEPS} steps at "
        f"{NLEV}x{REMAT_NCOL} f64, gradients in the parameters and the "
        f"initial tracers: largest difference {diff:.3e} of the largest "
        f"(limit 1e-12); peak device memory above the world {peaks[True]:.3f}"
        f" GB with remat, {peaks[False]:.3f} GB without, {card}")
    if not diff <= 1e-12:
        raise AssertionError("remat changes the gradient")
    del grads

    # (f) the f32 sweep
    sens32 = sweep(world_at(NCOL, torch.float32))
    rel32 = {p: _rel(sens32[p], sens[p]) for p in ADJ_PATHS}
    signs = all((sens32[p] > 0) == (sens[p] > 0) for p in ADJ_PATHS)
    log(f"adjoint (f): f32 sweep {sens32}: relative difference from f64 "
        f"{rel32} (not gated); finite "
        f"{all(map(math.isfinite, sens32.values()))}, signs of f64's {signs}")
    if not (signs and all(map(math.isfinite, sens32.values()))):
        raise AssertionError("the f32 sweep is not finite or flips a sign")

    # (e) the twin experiment
    t0 = time.perf_counter()
    state, grid, forcing = synthetic_world(
        nlev=TWIN["nlev"], ncol=TWIN["ncol"], seed=TWIN["seed"],
        ragged=False)
    path = "bgc.autotrophs[0].PCref"
    true_val = get_param(params, path)

    def obs_fn(s):
        return s.bgc.tracers[0][(BT.SPC, BT.SPCHL, BT.DIC), :]

    with torch.no_grad():
        _, observations = run_diff(state, grid, forcing, params, DT,
                                   TWIN["steps"], obs_fn=obs_fn)
    result = calibrate(
        override_params(params, {path: TWIN["start"] * true_val}), [path],
        state, grid, forcing, DT, TWIN["steps"], observations, obs_fn,
        iters=TWIN["iters"], learning_rate=TWIN["lr"])
    drop = result.losses[0] / max(result.losses[-1], 1e-300)
    err = _rel(result.values[path], true_val)
    log(f"adjoint (e): twin experiment at {TWIN['nlev']}x{TWIN['ncol']}, "
        f"{TWIN['steps']} steps, {TWIN['iters']} Adam iterations (lr "
        f"{TWIN['lr']}) from {TWIN['start']}x PCref: loss "
        f"{result.losses[0]:.3e} -> {result.losses[-1]:.3e} ({drop:.3g}x, "
        f"limit >= 100), PCref {result.values[path]!r} vs {true_val!r} "
        f"({100 * err:.3f}%, limit 3%), {time.perf_counter() - t0:.1f} s, "
        f"{card}")
    if not (drop >= 100.0 and err <= 0.03):
        raise AssertionError("the twin experiment did not recover PCref")
    log(f"adjoint phase: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# The long-horizon gates (tests/test_torch_trajectory.py and its siblings at
# the horizons the card affords), each in a child process that overlaps the
# phases above: the oracle's 1000 deep steps on the CPU, the port's on the
# card, the f32 gates on the card.
# ---------------------------------------------------------------------------

GATE_STEPS = dict(deep=1000, f32=720, deep_f32=96)
GATES = ("oracle", "deep64", "f32", "fused")
# kicked f32 runs of the deep world that measure the envelope's robustness
ENSEMBLE = 32
# the gates must be joined by this many seconds after the script started
GATE_DEADLINE_S = 1000
# a child's longest wait for the parent's build
BUILD_WAIT_S = 900


def bind_tests():
    """tests/ has no __init__.py, so an installed package named "tests"
    would take precedence over it: bind the name to this checkout's."""
    import types
    if getattr(sys.modules.get("tests"), "__path__", None) != [
            os.path.join(HERE, "tests")]:
        tests_pkg = types.ModuleType("tests")
        tests_pkg.__path__ = [os.path.join(HERE, "tests")]
        sys.modules["tests"] = tests_pkg


def start_gates(tmp):
    """Start the gate children (see :func:`gate_child`); those on the
    card wait for ``<tmp>/built``.  Returns {name: (process, path,
    log file, start time)}."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=HERE)
    procs = {}
    for name in GATES:
        out = os.path.join(tmp, name)
        logf = open(out + ".log", "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--gate",
             name, out, os.path.join(tmp, "built")], cwd=HERE, env=env,
            stdout=logf, stderr=subprocess.STDOUT), out, logf,
            time.perf_counter())
    return procs


def stop(procs):
    """Terminate every child still running."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def gate_child(name, out, built):
    """One gate child.  "oracle": tests/oracle's 1000 steps of the deep
    ragged world (NumPy, no card).  "deep64": the deep world's bottom-branch
    pin and its t=0 branch firing on the card, then the port's 1000 f64
    steps with the 1-ulp kicked copy as extra columns.  "f32": the f32
    envelope (720 steps at 6 x 8) and the no-drift gate, then the deep f32
    gates (branches, the 96-step envelope, the range audit).  "fused":
    scripts/qualify_fused.py's qualification of the fused interior (96 f32
    steps of its 60 x 256 world against the default interior), then the
    deep world's 1000 f64 steps with the fused interior and its 1-ulp
    kicked copy as extra columns.  Writes its results to ``out`` (.npz)
    and ``out.json``; an AssertionError exits 1.
    Pauses on SIGUSR1 (:func:`gates_paused`) once ``out.ready`` exists."""
    signal.signal(signal.SIGUSR1, _pause_self)
    open(out + ".ready", "w").close()
    torch.set_num_threads(1)
    bind_tests()
    import numpy as np
    from tests import test_torch_deep_world as deep
    from tests import test_torch_fp32_deep as f32deep
    from tests import test_torch_fp32_trajectory as f32traj
    from tests import test_torch_trajectory as traj
    from ocean_bgc_tpu_torch.utils.synthetic import _synthetic_world_numpy

    t0 = time.perf_counter()
    if name != "oracle":
        while not os.path.exists(built):
            if time.perf_counter() - t0 > BUILD_WAIT_S or os.getppid() == 1:
                raise SystemExit(f"gate {name}: no build to wait for")
            time.sleep(0.5)
    waited = time.perf_counter() - t0
    res = {"waited_s": waited}
    if name == "oracle":
        np.savez(out, **traj.oracle_run(deep.deep_ragged_world_numpy(),
                                        GATE_STEPS["deep"]))
    elif name == "deep64":
        t = time.perf_counter()
        res["bottom_branches"] = deep.bottom_branches_gate(device="cuda")
        deep.deep_branches_at_start(device="cuda")
        res["branches_s"] = time.perf_counter() - t
        t = time.perf_counter()
        got, kicked = traj.port_run(deep.deep_ragged_world_numpy(),
                                    GATE_STEPS["deep"], kick=traj.ULP_KICK,
                                    device="cuda")
        res["run_s"] = time.perf_counter() - t
        np.savez(out, kicked=kicked, **got)
    elif name == "fused":
        t = time.perf_counter()
        res["qualify"] = traj.fused_qualification(
            _synthetic_world_numpy(**traj.QUALIFY_WORLD),
            traj.QUALIFY_STEPS, device="cuda")
        res["qualify_s"] = time.perf_counter() - t
        t = time.perf_counter()
        got, kicked = traj.port_run(deep.deep_ragged_world_numpy(),
                                    GATE_STEPS["deep"], kick=traj.ULP_KICK,
                                    device="cuda", interior_impl="fused")
        res["run_s"] = time.perf_counter() - t
        np.savez(out, kicked=kicked, **got)
    else:
        t = time.perf_counter()
        res["envelope_6x8"] = f32traj.f32_envelope(
            _synthetic_world_numpy(nlev=6, ncol=8, seed=41, ragged=False),
            GATE_STEPS["f32"], device="cuda")
        res["envelope_6x8_s"] = time.perf_counter() - t
        t = time.perf_counter()
        res["drift_early_late"] = f32traj.drift_gate(GATE_STEPS["f32"],
                                                     device="cuda")
        res["drift_s"] = time.perf_counter() - t
        t = time.perf_counter()
        res["deep_bsi_ratio"] = f32deep.f32_branches(device="cuda")
        runs = f32deep.deep_runs(GATE_STEPS["deep_f32"], device="cuda")
        res["deep_envelope"] = f32deep.deep_envelope(runs)
        res["deep_audit_decades"] = math.log10(f32deep.range_audit(runs))
        res["deep_s"] = time.perf_counter() - t
        # how robust the envelope is at this horizon (a measurement, not
        # a gate): the same gate for f32 runs kicked in their last bits
        t = time.perf_counter()
        res["deep_ensemble"] = f32deep.kicked_ensemble(
            GATE_STEPS["deep_f32"], ENSEMBLE, device="cuda")
        res["deep_ensemble_s"] = time.perf_counter() - t
    res["wall_s"] = time.perf_counter() - t0
    with open(out + ".json", "w") as f:
        json.dump(res, f)
    return 0


def join_gates(procs, deadline_s):
    """Wait for the gate children, fail on any that failed, hold the
    port's 1000 deep steps, with each interior, to the oracle's (the
    chaos-yardstick branch of tests/test_trajectory.py), and log each
    gate's worst mismatch over its bound and its wall time."""
    import numpy as np
    bind_tests()
    from tests import test_torch_trajectory as traj
    results = {}
    for name, (proc, out, logf, t0) in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, deadline_s - time.perf_counter()))
        except subprocess.TimeoutExpired:
            stop([p for p, *_ in procs.values()])
            raise AssertionError(f"gate {name} ran past the script's "
                                 f"deadline")
        logf.close()
        with open(out + ".log") as f:
            text = f.read()
        if rc != 0:
            stop([p for p, *_ in procs.values()])
            raise AssertionError(f"gate {name} failed (exit {rc}):\n"
                                 f"{text[-6000:]}")
        with open(out + ".json") as f:
            results[name] = json.load(f)
        results[name]["joined_s"] = time.perf_counter() - t0
    with np.load(procs["oracle"][1] + ".npz") as f:
        want = {k: f[k] for k in f.files}
    worst = {}
    for name in ("deep64", "fused"):
        with np.load(procs[name][1] + ".npz") as f:
            got = {k: f[k] for k in f.files}
        kicked = got.pop("kicked")
        for k, v in list(got.items()) + list(want.items()):
            if not np.isfinite(v).all():
                raise AssertionError(f"non-finite {k} after the {name} "
                                     f"deep run")
        worst[name] = traj.oracle_gate(got, want, GATE_STEPS["deep"],
                                       kicked)
    r, d, o = results["f32"], results["deep64"], results["oracle"]
    fu = results["fused"]
    log(f"gate: deep world, {GATE_STEPS['deep']} f64 steps on the card vs "
        f"the oracle (chaos yardstick): worst mismatch / bound "
        f"{worst['deep64']:.4g} (limit 1); port run {d['run_s']:.1f} s, "
        f"oracle {o['wall_s']:.1f} s")
    log(f"gate: fused interior, scripts/qualify_fused.py's run "
        f"({traj.QUALIFY_STEPS} f32 steps at {traj.QUALIFY_WORLD}, env "
        f"off, fused vs default, 30 x the (1 + {traj.QUALIFY_EPS:g}) "
        f"envelope + 1e-2 scale + 1e-12): worst mismatch / bound "
        f"{fu['qualify']:.4g} (limit 1), {fu['qualify_s']:.1f} s")
    log(f"gate: fused interior, deep world, {GATE_STEPS['deep']} f64 "
        f"steps on the card vs the oracle (chaos yardstick of its own "
        f"kicked copy): worst mismatch / bound {worst['fused']:.4g} (limit "
        f"1), {fu['run_s']:.1f} s")
    log(f"gate: deep bottom branches (one step vs the oracle): worst "
        f"mismatch / tolerance {d['bottom_branches']:.4g}; t=0 branch "
        f"firing held; {d['branches_s']:.1f} s")
    log(f"gate: f32 envelope, {GATE_STEPS['f32']} steps at 6x8: worst "
        f"mismatch / bound {r['envelope_6x8']:.4g} (limit 1), "
        f"{r['envelope_6x8_s']:.1f} s")
    early, late = r["drift_early_late"]
    log(f"gate: f32 no drift, {GATE_STEPS['f32']} steps: max|Jint_Ctot| "
        f"{early:.4g} at step 4, {late:.4g} at the end (limits 1 and 50x "
        f"the early + 1e-6), {r['drift_s']:.1f} s")
    log(f"gate: deep f32, {GATE_STEPS['deep_f32']} steps: envelope worst "
        f"mismatch / bound {r['deep_envelope']:.4g} (limit 1); branches "
        f"held (bSi burial fractions' ratio {r['deep_bsi_ratio']:.3g}, limit "
        f"> 3); range audit: smallest nonzero f64 flux "
        f"{r['deep_audit_decades']:.2f} decades above the f32 flush "
        f"threshold (limit 12), no flush; {r['deep_s']:.1f} s")
    ens = sorted(r["deep_ensemble"])
    log(f"deep f32 envelope over {len(ens)} f32 runs whose initial tracers "
        f"differ by k 2^-24 (k = 0 the gate's run; a measurement, not a "
        f"gate): {sum(x > 1.0 for x in ens)} of {len(ens)} above their "
        f"bound, median {statistics.median(ens):.4g}, max {ens[-1]:.4g}; "
        f"{r['deep_ensemble_s']:.1f} s")
    log("gate children's wall times (s): " + ", ".join(
        f"{n} {v['wall_s']:.1f} (waited {v['waited_s']:.1f} for the "
        f"build, joined at {v['joined_s']:.1f})" for n, v in
        results.items()))


# ---------------------------------------------------------------------------
# The multi-device phase: each rank a child process.
# ---------------------------------------------------------------------------

MD_LOCAL = ("pco2surf", "NITRIF", "POC_FLUX_IN",
            "health_solver_nonconverged_cells")
# the state fields every rank writes, and those the kernels write per cell
# or per lane (K1's pH, the surface pair's)
MD_FIELDS = ("tracers", "ph_prev_3d", "ph_prev_alt_3d", "surface_ph",
             "surface_ph_alt", "dms", "macros")
MD_KERNEL_FIELDS = ("ph_prev_3d", "ph_prev_alt_3d", "surface_ph",
                    "surface_ph_alt")
MD_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
MD_DTYPES = (torch.float64, torch.float32)


def state_fields(state):
    b = state.bgc
    return dict(tracers=b.tracers, ph_prev_3d=b.ph_prev_3d,
                ph_prev_alt_3d=b.ph_prev_alt_3d, surface_ph=b.surface_ph,
                surface_ph_alt=b.surface_ph_alt, dms=state.dms,
                macros=state.macros)


def md_series(forcing):
    """Three forcing records: T +0, +0.5, -0.5 C."""
    import dataclasses

    from ocean_bgc_tpu_torch.models.forcing_series import stack_forcings
    return stack_forcings([dataclasses.replace(
        forcing, potential_temperature=forcing.potential_temperature + dt)
        for dt in (0.0, 0.5, -0.5)])


def md_rank(cfg):
    """One rank of the multi-device phase (``cfg``: its rank, the rank
    count, the coordinator's address, backend, device and output
    directory): at each dtype the sharded step with diagnostics, health and
    ``local_diags`` and the sharded fused step on its block of the 60 x
    8192 ragged world, each launch and collective counted, its blocks
    written as history shards (and as a plain file, to check the
    stitching); the f64 forced run and checkpoint shards; the card's times
    of each step and of the stacked all_reduce."""
    from ocean_bgc_tpu_torch.params import ModelParams
    from ocean_bgc_tpu_torch.parallel import distributed as dist
    from ocean_bgc_tpu_torch.parallel.sharding import (
        all_reduce_sum, gather_columns, make_mesh, make_sharded_forced_run,
        make_sharded_step, shard_columns, shard_world)
    from ocean_bgc_tpu_torch.utils import checkpoint as ckpt
    from ocean_bgc_tpu_torch.utils.history import write_history_shards
    from ocean_bgc_tpu_torch.utils.profiling import counters
    from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world
    import numpy as np

    dist.initialize(cfg["address"], cfg["world"], cfg["rank"],
                    backend=cfg["backend"], device=cfg["device"])
    mesh = make_mesh()
    params = ModelParams()
    out = cfg["out"]
    rec = {"backend": cfg["backend"], "device": str(mesh.device)}

    def counted(label, fn, *args):
        reset_counts()
        before = counters()["collectives.all_reduce"]
        result = fn(*args)
        torch.cuda.synchronize()
        rec[label] = dict(
            launches=read_counts(),
            collectives=counters()["collectives.all_reduce"] - before)
        return result

    def wall_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    for dtype in MD_DTYPES:
        name = str(dtype).split(".")[-1]
        state, grid, forcing = shard_world(*synthetic_world(
            nlev=NLEV, ncol=NCOL, seed=SEED, ragged=True, dtype=dtype,
            device=mesh.device), mesh)
        diag = make_sharded_step(mesh, params, DT, compute_diags=True,
                                 health=True, local_diags=MD_LOCAL)
        new, gsum, local = counted(f"diags_{name}", diag, state, grid,
                                   forcing)
        write_history_shards(os.path.join(out, f"diags_{name}"), {
            **state_fields(new), **local,
            **{f"global_{k}": v for k, v in gsum.items()}}, mesh=mesh)
        np.savez(os.path.join(out, f"block_{name}_p{mesh.rank}.npz"),
                 **{k: v.cpu().numpy() for k, v in local.items()})
        if dtype == torch.float64:
            ckpt.save(os.path.join(out, "ck"), new, step=1, mesh=mesh)
            # the two files of every column, gathered to rank 0 (each
            # rank names its own, so that what each writes shows)
            before = counters()["collectives.gather"]
            means = gather_columns(local, mesh)
            whole = gather_columns((new, grid, forcing), mesh)
            rec["gathers"] = counters()["collectives.gather"] - before
            if means is not None:
                write_md_files(out, f"_p{mesh.rank}", means, *whole)
            del whole
        fused = make_sharded_step(mesh, params, DT, interior_impl="fused")
        new, _ = counted(f"fused_{name}", fused, state, grid, forcing)
        write_history_shards(os.path.join(out, f"fused_{name}"),
                             state_fields(new), mesh=mesh)
        rec[f"diags_{name}_ms"] = wall_ms(
            lambda: diag(state, grid, forcing), 3)
        rec[f"fused_{name}_ms"] = wall_ms(
            lambda: fused(state, grid, forcing), 5)
        sums = list(gsum.values())
        rec[f"all_reduce_{name}_ms"] = wall_ms(
            lambda: all_reduce_sum(sums, mesh), 20)
        if dtype == torch.float64:
            whole = synthetic_world(nlev=NLEV, ncol=NCOL, seed=SEED,
                                    ragged=True, device=mesh.device)
            series = shard_columns(md_series(whole[2]), mesh, NCOL)
            del whole
            forced = make_sharded_forced_run(mesh, params, DT, 2,
                                             RECORD_DT, interp="hold")
            new = counted("forced", forced, state, grid, series)
            write_history_shards(os.path.join(out, "forced"),
                                 state_fields(new), mesh=mesh)
        del state, grid, forcing, new
    with open(os.path.join(out, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.shutdown()
    return 0


def write_md_files(out, suffix, means, state, grid, forcing):
    """The multi-device phase's NetCDF history of the step's local
    diagnostics and its world file, as ``run_model`` writes them:
    ``hist<suffix>.nc`` and ``world<suffix>.nc`` in ``out``."""
    import numpy as np

    from ocean_bgc_tpu_torch.io.model_io import (save_history_netcdf,
                                                 save_world)
    save_history_netcdf(os.path.join(out, f"hist{suffix}.nc"), means,
                        nlev=NLEV, ncol=NCOL, count=1,
                        attrs={"dt": DT, "step": np.int32(1)})
    save_world(os.path.join(out, f"world{suffix}.nc"), state, grid, forcing,
               attrs={"step": np.int32(1)})


def same_files(label, got, want):
    """Raise unless the files ``got`` and ``want`` hold the same bytes,
    naming the NetCDF variables that differ."""
    with open(got, "rb") as f, open(want, "rb") as g:
        if f.read() == g.read():
            return
    from ocean_bgc_tpu_torch.io import netcdf3 as nc
    a, b = nc.read(got), nc.read(want)
    differ = sorted(k for k in set(a.variables) | set(b.variables)
                    if k not in a.variables or k not in b.variables
                    or not (a.variables[k].data == b.variables[k].data).all())
    raise AssertionError(f"{label}: {os.path.basename(got)} differs from "
                         f"the unsharded twin's (variables {differ}, "
                         f"attributes equal {a.attrs == b.attrs})")


def spawn_ranks(label, n, backend, device, out):
    """Run ``n`` ranks of :func:`md_rank` as child processes and wait for
    them; a rank's failure stops the others and raises with its output."""
    from ocean_bgc_tpu_torch.parallel.distributed import _free_port
    os.makedirs(out, exist_ok=True)
    address = f"localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=HERE)
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(n):
            cfg = dict(address=address, world=n, rank=r, backend=backend,
                       device=device, out=out)
            logs.append(open(os.path.join(out, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--rank-worker", json.dumps(cfg)], cwd=HERE, env=env,
                stdout=logs[-1], stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.perf_counter() - t0 > 600:
                break
            time.sleep(0.2)
    finally:
        stop(procs)
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out, f"rank{r}.log")) as f:
                text = f.read()
            raise AssertionError(f"{label}: rank {r} failed (exit "
                                 f"{p.returncode}):\n{text[-6000:]}")
    wall = time.perf_counter() - t0
    recs = []
    for r in range(n):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs, wall


def md_compare(label, got, want, dtype, kernel_fields=MD_KERNEL_FIELDS):
    """The stitched fields against the unsharded step's: the kernels'
    per-cell outputs bitwise, every field within MD_TOL of its scale (per
    tracer for the tracer block).  Returns the share of values that are
    bitwise equal."""
    import numpy as np
    equal = total = 0
    worst = 0.0
    for k, w in want.items():
        w = w.cpu().numpy()
        g = got[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{label}: {k} is {g.dtype}{g.shape}, "
                                 f"want {w.dtype}{w.shape}")
        same = g == w
        equal += int(same.sum())
        total += same.size
        if k in kernel_fields and not same.all():
            raise AssertionError(f"{label}: the kernels' {k} differs in "
                                 f"{int((~same).sum())} cells")
        axes = (0, 2) if k == "tracers" else None
        scale = np.abs(w.astype(np.float64)).max(axis=axes, keepdims=True)
        err = float((np.abs(g.astype(np.float64) - w)
                     / (scale + 1e-300)).max())
        worst = max(worst, err)
    if not worst <= MD_TOL[dtype]:
        raise AssertionError(f"{label}: a field differs by {worst:.3g} of "
                             f"its scale (limit {MD_TOL[dtype]})")
    return equal / total, worst


def md_check(label, recs, out, ref):
    """Gate one configuration's ranks against the parent's unsharded
    step (``ref``): the stitched states, local diagnostics, global sums
    and health totals; the history blocks; every rank's launches equal to
    the unsharded step's and its collectives one per step with
    diagnostics and health, none otherwise."""
    import numpy as np

    from ocean_bgc_tpu_torch.parallel.sharding import (GLOBAL_SUM_DIAGS,
                                                       HEALTH_DIAGS)
    from ocean_bgc_tpu_torch.utils.history import stitch_history_shards
    for dtype in MD_DTYPES:
        name = str(dtype).split(".")[-1]
        r = ref[name]
        got = stitch_history_shards(os.path.join(out, f"diags_{name}"))
        share, worst = md_compare(f"{label} diags {name}", got,
                                  state_fields(r["diags_state"]), dtype)
        fshare, fworst = md_compare(
            f"{label} fused {name}",
            stitch_history_shards(os.path.join(out, f"fused_{name}")),
            state_fields(r["fused_state"]), dtype)
        lshare, lworst = md_compare(
            f"{label} local diags {name}", {k: got[k] for k in MD_LOCAL},
            {k: r["diags"][k] for k in MD_LOCAL}, dtype, kernel_fields=())
        for k in HEALTH_DIAGS:
            if float(got[f"global_{k}"]) != float(r["diags"][k]):
                raise AssertionError(f"{label} {name}: {k} total "
                                     f"{got[f'global_{k}']}, unsharded "
                                     f"{float(r['diags'][k])}")
        sums = []
        for k in GLOBAL_SUM_DIAGS:
            ref_k = r["diags"][k.replace("Jint_", "Jint_100m_")]
            budget = float(ref_k.double().abs().sum())
            err = abs(float(got[f"global_{k}"])
                      - float(r["diags"][k].double().sum()))
            sums.append(err / budget)
        if not max(sums) <= MD_TOL[dtype]:
            raise AssertionError(f"{label} {name}: global sums differ by "
                                 f"{max(sums):.3g} of their budgets")
        blocks = []
        for i in range(len(recs)):
            with np.load(os.path.join(out, f"block_{name}_p{i}.npz")) as f:
                blocks.append({k: f[k] for k in f.files})
        for k in MD_LOCAL:
            if k in HEALTH_DIAGS:
                continue
            cat = np.concatenate([b[k] for b in blocks], axis=-1)
            if not np.array_equal(cat, got[k]):
                raise AssertionError(f"{label} {name}: the history shards "
                                     f"of {k} do not stitch to the blocks")
        for i, rec in enumerate(recs):
            for step_name, calls in (("diags", 1), ("fused", 0)):
                got_rec = rec[f"{step_name}_{name}"]
                if got_rec["launches"] != r[f"{step_name}_launches"]:
                    raise AssertionError(
                        f"{label} rank {i} {step_name} {name}: launches "
                        f"{got_rec['launches']}, unsharded "
                        f"{r[f'{step_name}_launches']}")
                if got_rec["collectives"] != calls:
                    raise AssertionError(
                        f"{label} rank {i} {step_name} {name}: "
                        f"{got_rec['collectives']} collectives, want {calls}")
        log(f"multi-device {label} {name}: diags step bitwise share "
            f"{share:.6f}, worst {worst:.3g} of scale; fused step bitwise "
            f"share {fshare:.6f}, worst {fworst:.3g}; local diags bitwise "
            f"share {lshare:.6f}, worst {lworst:.3g}; global sums worst "
            f"{max(sums):.3g} of their budgets (limit {MD_TOL[dtype]}); "
            f"health totals exact; history shards stitch bitwise; launches "
            f"per rank {recs[0][f'diags_{name}']['launches']} (diags), "
            f"{recs[0][f'fused_{name}']['launches']} (fused), as unsharded; "
            f"collectives 1 / 0")
    for kind in ("hist", "world"):
        if any(os.path.exists(os.path.join(out, f"{kind}_p{i}.nc"))
               for i in range(1, len(recs))):
            raise AssertionError(f"{label}: a rank other than 0 wrote "
                                 f"{kind}")
        same_files(label, os.path.join(out, f"{kind}_p0.nc"),
                   ref[f"{kind}_twin"])
    if any(rec["gathers"] != 2 for rec in recs):
        raise AssertionError(f"{label}: gathers per rank "
                             f"{[rec['gathers'] for rec in recs]}, want 2")
    log(f"multi-device {label} float64: the NetCDF history and the world "
        f"file gathered to rank 0 (2 gathers per rank) bitwise the "
        f"unsharded twin's; no other rank wrote either")
    forced = stitch_history_shards(os.path.join(out, "forced"))
    fshare, fworst = md_compare(f"{label} forced", forced,
                                state_fields(ref["forced_state"]),
                                torch.float64)
    for i, rec in enumerate(recs):
        if rec["forced"]["collectives"] != 0:
            raise AssertionError(f"{label} rank {i}: the forced run made "
                                 f"{rec['forced']['collectives']} "
                                 f"collectives")
    log(f"multi-device {label} forced run (2 held-record steps, f64): "
        f"bitwise share {fshare:.6f}, worst {fworst:.3g}; collectives 0; "
        f"launches per rank {recs[0]['forced']['launches']}")


def md_reference(params, tmp):
    """The unsharded step with diagnostics and health, the fused step and
    the forced run on the whole world, each with its launches counted;
    at f64 the NetCDF history of the step's local diagnostics and its
    world file, written to ``tmp`` (the ranks' files' twins)."""
    from ocean_bgc_tpu_torch.models.coupled import step
    from ocean_bgc_tpu_torch.models.forcing_series import run_forced
    from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world
    ref = {}
    for dtype in MD_DTYPES:
        name = str(dtype).split(".")[-1]
        state, grid, forcing = synthetic_world(
            nlev=NLEV, ncol=NCOL, seed=SEED, ragged=True, dtype=dtype)
        reset_counts()
        new, diags = step(state, grid, forcing, params, DT, health=True)
        torch.cuda.synchronize()
        r = dict(diags_state=new, diags=diags, diags_launches=read_counts())
        if dtype == torch.float64:
            write_md_files(tmp, "_twin", {k: diags[k] for k in MD_LOCAL},
                           new, grid, forcing)
            for kind in ("hist", "world"):
                ref[f"{kind}_twin"] = os.path.join(tmp, f"{kind}_twin.nc")
        reset_counts()
        r["fused_state"], _ = step(state, grid, forcing, params, DT,
                                   compute_diags=False,
                                   interior_impl="fused")
        torch.cuda.synchronize()
        r["fused_launches"] = read_counts()
        if dtype == torch.float64:
            ref["forced_state"], _ = run_forced(
                state, grid, md_series(forcing), params, DT, 2, RECORD_DT,
                interp="hold")
        ref[name] = r
    return ref


def md_run_model(tmp, params):
    """Configuration (c): ``run_model --sharded`` under
    ``torch.distributed.run`` with one NCCL rank, at f64 and f32, then its
    checkpoint shards restored here (whole, and as the blocks of two
    ranks) and its history shards stitched, each against the same run
    unsharded in this process (bitwise: one rank holds every column)."""
    import numpy as np

    from ocean_bgc_tpu_torch import run_model
    from ocean_bgc_tpu_torch.parallel.distributed import ColumnMesh
    from ocean_bgc_tpu_torch.utils import checkpoint as ckpt
    from ocean_bgc_tpu_torch.utils.history import stitch_history_shards
    env = dict(os.environ, PYTHONPATH=HERE)
    common = ["--nlev", str(NLEV), "--ncol", str(NCOL), "--seed",
              str(SEED), "--steps", "4", "--history-every", "2",
              "--history-fields", ",".join(PROD_FILTER),
              "--checkpoint-every", "2", "--health"]
    for fp32 in (False, True):
        name = "float32" if fp32 else "float64"
        prec = ["--fp32"] if fp32 else []
        out = os.path.join(tmp, f"rm_{name}")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m", "ocean_bgc_tpu_torch.run_model",
             "--sharded", *common, *prec, "--out", out, "--quiet"],
            cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"run_model --sharded {name} failed "
                                 f"(exit {proc.returncode}):\n"
                                 f"{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        plain = run_driver(f"unsharded twin of run_model --sharded "
                           f"{name}", [*common, *prec, "--out",
                                       os.path.join(tmp, f"rm1_{name}")])
        for k in ("columns", "max_abs_Jint_Ctot", "finite",
                  *HEALTH_TOTALS):
            if summary[k] != plain[k]:
                raise AssertionError(f"run_model --sharded {name}: {k} "
                                     f"{summary[k]}, unsharded {plain[k]}")
        got, n = ckpt.restore(os.path.join(out, "ck_final"))
        want, _ = ckpt.restore(plain["final_checkpoint"])
        if n != 4 or not all(torch.equal(a, b) for a, b in zip(
                state_fields(got).values(), state_fields(want).values())):
            raise AssertionError(f"run_model --sharded {name}: its "
                                 f"restored checkpoint differs from the "
                                 f"unsharded run's")
        for r in range(2):
            mesh = ColumnMesh(rank=r, world_size=2,
                              device=torch.device("cuda", 0))
            block, _ = ckpt.restore(os.path.join(out, "ck_000002"),
                                    mesh=mesh)
            whole, _ = ckpt.restore(os.path.join(tmp, f"rm1_{name}",
                                                 "ck_000002.npz"))
            lo, hi = r * NCOL // 2, (r + 1) * NCOL // 2
            if not all(torch.equal(a, b[..., lo:hi]) for a, b in zip(
                    state_fields(block).values(),
                    state_fields(whole).values())):
                raise AssertionError(f"run_model --sharded {name}: rank "
                                     f"{r}'s block of its checkpoint "
                                     f"differs")
        hist = stitch_history_shards(os.path.join(out, "hist_000004"))
        with np.load(os.path.join(tmp, f"rm1_{name}",
                                  "hist_000004.npz")) as f:
            for k, v in hist.items():
                if not np.array_equal(v, f[k]):
                    raise AssertionError(f"run_model --sharded {name}: "
                                         f"history {k} differs")
        log(f"multi-device (c) run_model --sharded {name} (torch.distributed"
            f".run, 1 NCCL rank, 4 steps): {wall:.1f} s with the launcher, "
            f"{summary['columns_per_s']} columns/s; summary = the unsharded "
            f"run's; ck_final restored bitwise, its step-2 shards restored "
            f"onto 2 ranks bitwise, history ({len(hist)} fields) stitched "
            f"bitwise")
    # one file of every column: NetCDF history and the world file, f64
    files = {}
    for label, launch in (("sharded", [
            sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "1", "-m", "ocean_bgc_tpu_torch.run_model",
            "--sharded"]), ("unsharded", None)):
        out = os.path.join(tmp, f"rm_nc_{label}")
        argv = [*common[:6], "--steps", "2", *common[8:], "--netcdf-history",
                "--save-world", os.path.join(out, "world.nc"), "--out", out]
        if launch is None:
            run_driver("unsharded twin of run_model --sharded "
                       "--netcdf-history --save-world", argv)
        else:
            proc = subprocess.run([*launch, *argv, "--quiet"], cwd=HERE,
                                  env=env, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"run_model --sharded --netcdf-history "
                                     f"--save-world failed (exit "
                                     f"{proc.returncode}):\n"
                                     f"{proc.stderr[-3000:]}")
        files[label] = [os.path.join(out, f) for f in ("hist_000002.nc",
                                                       "world.nc")]
    for got, want in zip(files["sharded"], files["unsharded"]):
        same_files("(c) run_model --sharded", got, want)
    log("multi-device (c) run_model --sharded --netcdf-history --save-world "
        "(1 NCCL rank, 2 steps, f64): hist_000002.nc and world.nc bitwise "
        "the unsharded run's")


def md_phase(params, tmp):
    """The multi-device phase: the 60 x 8192 ragged world at f64 and f32
    (a) on one NCCL rank, (b) on two Gloo ranks sharing cuda:0, (c)
    through ``run_model --sharded`` under torch.distributed.run; each rank
    a child process, every result gated against the unsharded step
    here."""
    t0 = time.perf_counter()
    ref = md_reference(params, tmp)
    log(f"multi-device: unsharded launches, diags step "
        f"{ref['float64']['diags_launches']}, fused step "
        f"{ref['float64']['fused_launches']}")
    times = {}
    for label, n, backend in (("(a) 1 NCCL rank", 1, "nccl"),
                              ("(b) 2 Gloo ranks on cuda:0", 2, "gloo")):
        out = os.path.join(tmp, f"md_{n}")
        recs, wall = spawn_ranks(label, n, backend, "cuda:0", out)
        md_check(label, recs, out, ref)
        times[n] = recs
        for dtype in MD_DTYPES:
            name = str(dtype).split(".")[-1]
            log(f"multi-device {label} {name}: ms/step per rank, diags + "
                f"health step " + ", ".join(
                    f"{r[f'diags_{name}_ms']:.3f}" for r in recs)
                + "; fused step " + ", ".join(
                    f"{r[f'fused_{name}_ms']:.3f}" for r in recs)
                + "; stacked all_reduce of the 8 sums " + ", ".join(
                    f"{r[f'all_reduce_{name}_ms']:.4f}" for r in recs)
                + f" ms ({NCOL // n} columns per rank)")
        log(f"multi-device {label}: ranks' wall {wall:.1f} s")
    md_run_model(tmp, params)
    # (d) the driver's dry run with its default placement: on the cards,
    # never on the CPU (two Gloo ranks share a lone card)
    from ocean_bgc_tpu_torch.entry import dryrun_multichip, rank_placement
    placed = [rank_placement(r, 2, torch.cuda.device_count())
              for r in range(2)]
    t = time.perf_counter()
    dryrun_multichip(2)
    log(f"multi-device (d) entry.dryrun_multichip(2), default placement "
        f"{placed}: OK in {time.perf_counter() - t:.1f} s")
    log(f"multi-device phase: {time.perf_counter() - t0:.1f} s")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    from ocean_bgc_tpu_torch.ops import _kernels
    from ocean_bgc_tpu_torch.params import ModelParams

    t_start = time.perf_counter()
    card = card_line()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=_kernels.BUILD_DIR)
    # the long-horizon gates overlap every phase below
    gates = start_gates(tmp.name)
    GATE_CHILDREN.extend((p, out + ".ready") for p, out, *_ in
                         gates.values())
    try:
        kernels = phases(_kernels, card, tmp.name)
        join_gates(gates, t_start + GATE_DEADLINE_S)
        md_phase(ModelParams(), tmp.name)
    finally:
        stop([p for p, *_ in gates.values()])
    tmp.cleanup()
    log(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s")

    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phases(_kernels, card, tmp):
    """The build (then the gate children on the card may start) and
    phases 2-10; returns the kernels' entries of the JSON line."""
    from ocean_bgc_tpu_torch.params import ModelParams

    t0 = time.perf_counter()
    report = _kernels.build()
    open(os.path.join(tmp, "built"), "w").close()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name, r in report.items():
        log(f"  {name}: {r['seconds']:.2f} s; ptxas:")
        for line in ptxas_lines(r["log"]):
            log(line)

    params = ModelParams()
    oracle_check(params)
    kernels = []
    files = None
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split('.')[-1]
        k1, kb, ctx = main_path(dtype, params)
        kstats = point_phase(dtype, ctx)
        k2 = fused_path(dtype, params, ctx)
        kcoeffs = default_call(dtype, params, ctx)
        if dtype == torch.float64:
            t0 = time.perf_counter()
            host_api_phase(params, ctx["world"], ctx["env"])
            log(f"host API phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        seeded = check_seeded(dtype, ctx["world"], ctx["env"], ctx["warm"])
        if files is None:     # the f64 world, loaded at f32 with --fp32
            files = write_driver_files(tmp, ctx["world"])
        f64 = dtype == torch.float64
        counts = driver_phase(dtype, tmp, files, f64_only=f64)
        if f64:
            forced_runs(params, ctx["world"], files[1])
            seed_qualification(params, ctx)
        log(f"driver phase {name}: {time.perf_counter() - t0:.1f} s")
        del ctx
        kernels.append(dict(
            name=f"solve_htotal_brackets stats ({name})", route="cuda",
            source="ocean_bgc_tpu_torch/csrc/carbonate_dual.cu",
            replaces="ocean_bgc_tpu/ops/pallas_carbonate.py:63",
            library_ms=None, **kstats))
        for kname, key, k in (
                ("carbonate_dual seeded", "k1_seeded", seeded["dual"]),
                ("solve_htotal_brackets seeded", "brackets_seeded",
                 seeded["brackets"])):
            kernels.append(dict(
                name=f"{kname} ({name})", route="cuda",
                source="ocean_bgc_tpu_torch/csrc/carbonate_dual.cu",
                replaces="ocean_bgc_tpu/ops/pallas_carbonate.py:63",
                launches=counts.get(key, 0), library_ms=None, **k))
        for kname, src, tpu, k in (
                ("carbonate_dual", "carbonate_dual.cu",
                 "ocean_bgc_tpu/ops/pallas_carbonate.py:63", k1),
                ("solve_htotal_brackets", "carbonate_dual.cu",
                 "ocean_bgc_tpu/ops/pallas_carbonate.py:63", kb),
                ("carbonate_coeffs", "carbonate_coeffs.cu",
                 "ocean_bgc_tpu/ops/pallas_carbonate.py:63", kcoeffs),
                ("interior_step solve", "interior_step.cu",
                 "ocean_bgc_tpu/ops/pallas_step.py:146", k2["solve"]),
                ("interior_step biology", "interior_step.cu",
                 "ocean_bgc_tpu/ops/pallas_step.py:146", k2["bio"])):
            kernels.append(dict(
                name=f"{kname} ({name})", route="cuda",
                source=f"ocean_bgc_tpu_torch/csrc/{src}", replaces=tpu,
                launches=k["launches"], max_abs_err=k["max_abs_err"],
                ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
                bound_by=k["bound_by"], library_ms=None))
    adjoint_phase(params, card)
    p = probe_phase()
    kernels.append(dict(
        name="probe (float32)", route="cuda",
        source="ocean_bgc_tpu_torch/csrc/probe_patterns.cu",
        replaces="scripts/probe_mosaic.py:35", library_ms=None, **p))
    big_step(params)
    return kernels


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gate"]:
        sys.exit(gate_child(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(md_rank(json.loads(sys.argv[2])))
    sys.exit(main())
