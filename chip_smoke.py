"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; there is no CPU fallback):

1. build every CUDA kernel of the port from ``ocean_bgc_tpu_torch/csrc``
   (one ``nvcc`` each, all started together);
2. one f64 step of a small world against the scalar NumPy/SciPy oracle
   (``tests/oracle/coupled_ref.py``);
3. the default path, at f64 and f32 — ``synthetic_world(60, 8192,
   ragged)``, ``precompute_env`` once, 10 ``step``s with diagnostics off
   — with every kernel's launches counted (the dual K1 10, its bracket-in
   instance 10 for the surface pair, K2's two kernels 0);
   tracers/DMS/MACROS bitwise equal between ``carbonate_impl="kernel"``
   and ``"torch"``, pH within the solver's tolerance; K1 against its
   plain version on cold and warm inputs (all 8 outputs bitwise equal);
   the bracket-in instance against its plain version on the surface pair
   and the stand-in (bitwise);
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
   world: 10 steps with the launches counted (K1's coefficient-and-
   saturation instance 10, the bracket-in instance 10, the dual K1 and
   K2 0), then 10 diags-on steps with the env cache (the dual K1 10, the
   coefficient-and-saturation instance 0); the instance against its plain
   version on cold and warm inputs (all 10 outputs bitwise equal);
   tracers and every diagnostic bitwise equal between
   ``carbonate_impl="kernel"`` and ``"torch"``, tracers bitwise equal with
   diagnostics on and off; the diagnostics' names those of the registry
   (``utils/diag.py``), every one finite;
6. P, the probe (``ocean_bgc_tpu_torch/probe.py``), against its plain
   version;
7. one f64 step of each path at 60 x 131072 columns (diagnostics off);
8. numbers: columns/s of every step configuration (diagnostics off with
   each interior; diagnostics on without and with the env cache and with
   a 10-field ``diag_filter``), each kernel's time beside its plain
   version's and its bound, each kernel's registers and spills from the
   build log, and where each step's time goes (the default path's and
   the diags-on step's breakdowns at f64 only).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

NLEV, NCOL, NCOL_BIG, DT = 60, 8192, 131072, 3600.0
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
# it reads dic, x1, x2 and writes H per lane, and reads ta, pt, sit and
# the 15 constants per shared element
BRACKET_FIELDS_LANE, BRACKET_FIELDS_SHARED = 4, 18
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
# the coefficient-and-saturation instance reads depth, T, S, the four
# tracers and the two previous pH fields per cell and writes 8 fields, 10
# with the saturation values
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


def reset_counts():
    """Set every kernel wrapper's launch count to 0."""
    from ocean_bgc_tpu_torch.ops import cuda_carbonate, cuda_step
    cuda_carbonate.co3_terms_dual_coeffs.launches = 0
    cuda_carbonate.co3_terms_dual_sat.launches = 0
    cuda_carbonate.solve_htotal_brackets.launches = 0
    cuda_step._launch_solve.launches = 0
    cuda_step._launch_bio.launches = 0


def read_counts():
    from ocean_bgc_tpu_torch.ops import cuda_carbonate, cuda_step
    return dict(k1=cuda_carbonate.co3_terms_dual_coeffs.launches,
                k1_sat=cuda_carbonate.co3_terms_dual_sat.launches,
                brackets=cuda_carbonate.solve_htotal_brackets.launches,
                k2_solve=cuda_step._launch_solve.launches,
                k2_bio=cuda_step._launch_bio.launches)


def ptxas_lines(log_text):
    """One line per kernel entry of an ``nvcc -Xptxas -v`` log: its name
    (demangled where c++filt is found), registers and spill bytes."""
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
            rows.append((name, m[1], *spill))
            name, spill = None, ("?", "?")
    names = [r[0] for r in rows]
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and names:
        out = subprocess.run([cxxfilt], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0:
            names = out.stdout.splitlines()
    names = [n.replace("obgc::(anonymous namespace)::", "").split("(")[0]
             for n in names]
    return [f"    {n}: {r[1]} registers, {r[2]} B spill stores, {r[3]} B "
            f"spill loads" for n, r in zip(names, rows)]


def k1_inputs(state, grid, forcing, env):
    """K1's arguments as the step's bgc_source_sink gives them."""
    from ocean_bgc_tpu_torch.ops.bgc import carbonate_inputs
    return carbonate_inputs(state.bgc.tracers, grid, forcing,
                            state.bgc.ph_prev_3d, state.bgc.ph_prev_alt_3d,
                            env)


def solve_ops_of(args, cells=None):
    """(operations, mean iterations per scenario) of K1's dual solve on
    these inputs, over ``cells`` (a mask; all cells if None), iteration
    counts from the plain version, which runs the same per-lane
    iteration."""
    from ocean_bgc_tpu_torch.ops.cuda_carbonate import (
        co3_terms_dual_coeffs_torch)
    *_, stats = co3_terms_dual_coeffs_torch(*args, with_stats=True)
    if cells is None:
        cells = torch.ones_like(args[0], dtype=torch.bool)
    n = int(cells.sum())
    ops = OPS_CELL * n
    for st in stats:
        iters = st["iters"].double()[cells]
        grows = st["grows"].double()[cells]
        ops += (n * (OPS_SCENARIO + 2 * OPS_TALK_FN + OPS_TALK)
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


def k1_bound(args, dtype):
    """(bound_ms, bound_by, bytes, operations, mean iterations, path
    bound_ms): the larger of K1's bytes over the HBM rate and of the
    operations these inputs need over the peak rate of the type.  The
    path bound counts only the outputs the step reads."""
    n = args[0].numel()
    ops, iters_mean = solve_ops_of(args)
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


def surface_lanes(state, forcing):
    """The surface pair's solver arguments as co2calc_surface_dual builds
    them in a step from ``state``: lanes (2, ncol), the rest (ncol,)."""
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
                             c.DEL_PH)
          for ph in (state.bgc.surface_ph, state.bgc.surface_ph_alt)]
    return (coeffs, torch.stack([da, db]), ta, pt, sit,
            torch.stack([br[0][0], br[1][0]]),
            torch.stack([br[0][1], br[1][1]]))


def standin_lanes(env):
    """precompute_env's stand-in solve: every cell, cold."""
    from ocean_bgc_tpu_torch import constants as c
    from ocean_bgc_tpu_torch.ops.carbonate import _to_mass_units
    full = torch.ones_like(env.standin_ph)
    m = _to_mass_units(2000.0 * full, 2300.0 * full, 0.0 * full,
                       0.0 * full)
    return (env.coeffs, *m, full * 10.0 ** -c.PHHI_3D_INIT,
            full * 10.0 ** -c.PHLO_3D_INIT)


def bracket_bound(args, dtype):
    """(bound_ms, bound_by, bytes, operations, mean and most steps) of the
    bracket-in instance on these lanes: each lane's and each shared
    element's fields once over the HBM rate, against the operations the
    plain version's per-lane counts need over the peak rate of the
    type."""
    from ocean_bgc_tpu_torch.ops.carbonate import _solve_htotal_impl
    coeffs, dic, ta = args[0], args[1], args[2]
    _, st = _solve_htotal_impl(*args, with_stats=True)
    iters, grows = st["iters"].double(), st["grows"].double()
    n = dic.numel()
    ops = (n * (2 * OPS_TALK_FN + OPS_BRACKET_LANE)
           + (grows * (OPS_GROW + 2 * OPS_TALK_FN)).sum().item()
           + (iters * (OPS_ITER + OPS_TALK)).sum().item())
    nbytes = ((BRACKET_FIELDS_LANE * n + BRACKET_FIELDS_SHARED * ta.numel())
              * dic.element_size())
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


def device_busy_ms(fn):
    """Sum of device kernel time over one call of ``fn`` (already warm),
    from torch.profiler, or None where the profiler sees no device
    activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    if counts != dict(k1=10, k1_sat=0, brackets=10, k2_solve=0, k2_bio=0):
        raise AssertionError(f"the default path's launches in 10 steps: "
                             f"{counts}, expected k1 10, k1_sat 0, brackets "
                             f"10, k2_solve 0, k2_bio 0")
    for name, t in (("tracers", state.bgc.tracers), ("dms", state.dms),
                    ("macros", state.macros)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite {name} after 10 steps")
    if not (state.bgc.ph_prev_3d[grid.active_mask()] > 6.0).all():
        raise AssertionError("interior pH out of range after 10 steps")

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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = state0
    for _ in range(10):
        state, _ = step(state, grid, forcing, params, DT,
                        compute_diags=False, env=env, interior_impl="fused")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    log(f"fused path {dtype}: 10 steps at {NLEV}x{NCOL} in {wall:.3f} s, "
        f"launches {counts}")
    if counts != dict(k1=0, k1_sat=0, brackets=10, k2_solve=10, k2_bio=10):
        raise AssertionError(f"the fused path's launches in 10 steps: "
                             f"{counts}, expected k1 0, k1_sat 0, brackets "
                             f"10, k2_solve 10, k2_bio 10")
    for name, t in (("tracers", state.bgc.tracers), ("dms", state.dms),
                    ("macros", state.macros),
                    ("pH", state.bgc.ph_prev_3d)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite {name} after 10 fused steps")

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


def sat_bound(args, dtype, with_sat=True):
    """(bound_ms, bound_by, bytes, operations, mean iterations) of K1's
    coefficient-and-saturation instance on ``args`` (its inputs): its
    fields read and written once over the HBM rate, against the
    constants', the saturation values' and the dual solve's operations
    (iteration counts from the plain version) over the peak rate."""
    from ocean_bgc_tpu_torch.ops.carbonate import carbonate_coeffs
    from ocean_bgc_tpu_torch.ops.cuda_carbonate import subsurface_of
    depth, temp, salt, *solve_args = args
    coeffs = carbonate_coeffs(depth, temp, salt, subsurface_of(depth))
    ops, iters = solve_ops_of((*solve_args, coeffs))
    n = depth.numel()
    ops += n * (OPS_COEFFS + (OPS_SAT if with_sat else 0))
    n_out = SAT_FIELDS_OUT if with_sat else SAT_FIELDS_OUT - 2
    nbytes = (SAT_FIELDS_IN + n_out) * depth.element_size() * n
    return (*bound(nbytes, ops, dtype), nbytes, ops, iters)


def check_sat(dtype, world, warm_state):
    """K1's coefficient-and-saturation instance against its plain version
    (``co3_terms_dual_sat_torch``: ``carbonate_coeffs``, the dual solve,
    ``co3_sat_vals``) on the cold and warm inputs of the step without an
    env cache; returns the numbers measured on the warm ones.

    Tolerance: none, all 10 outputs bitwise equal.  The constants repeat
    the plain version's expressions in its order with PyTorch's CUDA
    semantics (a tensor over a Python scalar is a product with the
    scalar's reciprocal), --fmad=false, IEEE division and the CUDA math
    library's exp, log and sqrt; the solve is K1's."""
    from ocean_bgc_tpu_torch.ops.bgc import carbonate_inputs
    from ocean_bgc_tpu_torch.ops.carbonate import solver_xacc
    from ocean_bgc_tpu_torch.ops.cuda_carbonate import (
        _launch_sat, co3_terms_dual_sat as ks, co3_terms_dual_sat_torch as
        plain)
    state, grid, forcing = world
    xacc = solver_xacc(dtype)
    for label, st in (("cold", state), ("warm", warm_state)):
        b = st.bgc
        args = carbonate_inputs(b.tracers, grid, forcing, b.ph_prev_3d,
                                b.ph_prev_alt_3d)
        got = ks(*args, impl="kernel")
        torch.cuda.synchronize()
        want = plain(*args)
        outs = [(g, w) for gs, ws in zip(got, want) for g, w in zip(gs, ws)]
        differ = sum(int((g != w).sum()) for g, w in outs)
        err = max((g - w).abs().max().item() for g, w in outs)
        dh = max((10.0 ** -g[0].double() - 10.0 ** -w[0].double())
                 .abs().max().item() for g, w in zip(got[:2], want[:2]))
        finite = all(torch.isfinite(g).all().item() for g, _ in outs)
        log(f"K1 coefficient-and-saturation {dtype} {label}: {differ} of "
            f"{10 * args[0].numel()} output values differ, max abs error "
            f"over all 10 outputs {err:.3g} (limit 0, bitwise), max|dH|/xacc "
            f"{dh / xacc:.3g}, finite {finite}")
        if differ or not finite or len(outs) != 10:
            raise AssertionError(f"K1's coefficient-and-saturation instance "
                                 f"({dtype}, {label}) disagrees with its "
                                 f"plain version")
    res = {}
    for with_sat in (True, False):
        ms = cuda_ms(lambda: _launch_sat(args, with_sat), reps=20,
                     device_only=True)
        plain_ms = cuda_ms(lambda: plain(*args, with_sat=with_sat), reps=1,
                           warmup=1, rounds=3)
        bound_ms, bound_by, nbytes, ops, iters = sat_bound(args, dtype,
                                                           with_sat)
        log(f"K1 coefficient-and-saturation {dtype} warm, with_sat "
            f"{with_sat}: {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
            f"{ops / 1e9:.3f} Gop, mean iterations {iters[0]:.2f} / "
            f"{iters[1]:.2f})")
        if with_sat:
            res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
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
        "  K1 coefficient-and-saturation": lambda: co3_terms_dual_sat(
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
            - times["  K1 coefficient-and-saturation"]
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
    coefficient-and-saturation instance's kernel entry's numbers."""
    from ocean_bgc_tpu_torch.models.coupled import step
    from ocean_bgc_tpu_torch.ops.carbonate import solver_xacc
    from ocean_bgc_tpu_torch.utils.diag import coupled_registry

    world, env = ctx["world"], ctx["env"]
    state0, grid, forcing = world
    registry = set(coupled_registry())

    # -- the default call, counted --
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, states = state0, []
    for _ in range(10):
        state, diags = step(state, grid, forcing, params, DT)
        states.append(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["k1_sat"]
    log(f"default call {dtype}: 10 steps at {NLEV}x{NCOL} (diagnostics on, "
        f"no env cache) in {wall:.3f} s, launches {counts}")
    if counts != dict(k1=0, k1_sat=10, brackets=10, k2_solve=0, k2_bio=0):
        raise AssertionError(f"the default call's launches in 10 steps: "
                             f"{counts}, expected k1 0, k1_sat 10, brackets "
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

    # -- diagnostics on with the env cache, counted --
    reset_counts()
    s = state0
    for _ in range(10):
        s, d = step(s, grid, forcing, params, DT, env=env)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"diags on with the env cache {dtype}: launches {counts}")
    if counts != dict(k1=10, k1_sat=0, brackets=10, k2_solve=0, k2_bio=0):
        raise AssertionError(f"the diags-on env-on launches in 10 steps: "
                             f"{counts}, expected k1 10, k1_sat 0, brackets "
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

    k = check_sat(dtype, world, states[0])

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
    timed("diags on, env on", env=env)
    timed(f"{len(PROD_FILTER)}-field diag_filter, env on", env=env,
          diag_filter=PROD_FILTER)
    if dtype == torch.float64:
        log(f"breakdown of one default-call {dtype} step at {NLEV}x{NCOL}:")
        diags_breakdown(dtype, states[-1], grid, forcing, params, ms)
    return dict(launches=launches, **k)


def probe_phase():
    """Phase 5: P on its own path (probe.run), counted, then against its
    plain version; returns its kernel entry's numbers."""
    from ocean_bgc_tpu_torch import probe
    probe.probe_patterns.launches = 0
    out, tend, checksum = probe.run()
    torch.cuda.synchronize()
    launches = probe.probe_patterns.launches
    args = probe.probe_inputs()
    want = probe.probe_patterns_torch(*args)
    rel = probe.max_rel_err((out, tend), want)
    err = max((g - w).abs().max().item() for g, w in zip((out, tend), want))
    log(f"P: launches {launches}, checksum {checksum:.6g}, max error / "
        f"scale {rel:.3g} (limit {probe.RTOL:g}), max abs error {err:.3g}")
    if launches != 1 or not rel <= probe.RTOL:
        raise AssertionError("P disagrees with its plain version")
    ms = cuda_ms(lambda: probe.probe_patterns(*args), reps=20,
                 device_only=True)
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
    log(f"P: {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.2e} ms ({nbytes} B, {ops} op)")
    return dict(launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def oracle_check(params):
    """One f64 step on the card of a small flat world against the scalar
    NumPy/SciPy oracle (tests/oracle/coupled_ref.py: brentq pH,
    independent constant fits), with the pre-chaos tolerances of
    tests/test_trajectory.py: rtol 2e-4 (atol 1e-10) for DIC, DIC_ALT_CO2,
    O2 and ALK, which carry the pH solve's tolerance, 5e-7 (atol 1e-18)
    for the other tracers, DMS and MACROS."""
    import types

    import numpy as np
    from ocean_bgc_tpu_torch.models.coupled import step
    from ocean_bgc_tpu_torch.ops.bgc import precompute_env
    from ocean_bgc_tpu_torch.state import BGCTracers as T
    from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world
    # tests/ has no __init__.py, so an installed package named "tests"
    # would take precedence over it: bind the name to this checkout's
    tests_pkg = types.ModuleType("tests")
    tests_pkg.__path__ = [os.path.join(HERE, "tests")]
    sys.modules["tests"] = tests_pkg
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
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, _ = step(state, grid, forcing, params, DT, compute_diags=False,
                      env=env, interior_impl=impl)
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    from ocean_bgc_tpu_torch.ops import _kernels
    from ocean_bgc_tpu_torch.params import ModelParams

    card = card_line()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    report = _kernels.build()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name, r in report.items():
        log(f"  {name}: {r['seconds']:.2f} s; ptxas:")
        for line in ptxas_lines(r["log"]):
            log(line)

    params = ModelParams()
    oracle_check(params)
    kernels = []
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split('.')[-1]
        k1, kb, ctx = main_path(dtype, params)
        k2 = fused_path(dtype, params, ctx)
        ksat = default_call(dtype, params, ctx)
        del ctx
        for kname, src, tpu, k in (
                ("carbonate_dual", "carbonate_dual.cu",
                 "ocean_bgc_tpu/ops/pallas_carbonate.py:63", k1),
                ("solve_htotal_brackets", "carbonate_dual.cu",
                 "ocean_bgc_tpu/ops/pallas_carbonate.py:63", kb),
                ("carbonate_dual_sat", "carbonate_dual.cu",
                 "ocean_bgc_tpu/ops/pallas_carbonate.py:63", ksat),
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
    p = probe_phase()
    kernels.append(dict(
        name="probe (float32)", route="cuda",
        source="ocean_bgc_tpu_torch/csrc/probe_patterns.cu",
        replaces="scripts/probe_mosaic.py:35", library_ms=None, **p))
    big_step(params)

    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
