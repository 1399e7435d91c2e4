"""Drive the PyTorch port's production step on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; there is no CPU fallback):

1. build every CUDA kernel of the port from ``ocean_bgc_tpu_torch/csrc``;
2. hold K1 (the dual pH solve) against its plain PyTorch version at f64
   and f32 on the flagship's 60 x 8192 cells, cold and warm brackets:
   all 8 outputs bitwise equal;
3. one f64 step of a small world against the scalar NumPy/SciPy oracle
   (``tests/oracle/coupled_ref.py``); then the main path —
   ``synthetic_world(60, 8192, ragged)``,
   ``precompute_env`` once, 10 ``step``s with diagnostics off — at f64
   and f32, with K1's launches counted; tracers/DMS/MACROS bitwise equal
   between ``carbonate_impl="kernel"`` and ``"torch"``, pH within the
   solver's tolerance (|dH| <= 2 xacc); one f64 step at
   60 x 131072 columns;
4. numbers: columns/s of the step, K1's time beside its plain version's
   and its bound, the plain surface and stand-in solves, and where a
   step's time goes.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
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
# K1 reads 21 fields per cell and writes 8; of the 8 the step reads only
# the two pH fields (the speciation feeds diagnostics, not ported yet)
K1_FIELDS_IN, K1_FIELDS_OUT, K1_FIELDS_OUT_READ = 21, 8, 2


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2, rounds=5):
    """Median over ``rounds`` of the mean ms per call of ``fn`` over
    ``reps`` calls, by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / reps)
    return statistics.median(times)


def k1_inputs(state, grid, forcing, env):
    """K1's arguments as the step's bgc_source_sink gives them."""
    from ocean_bgc_tpu_torch.ops.bgc import carbonate_inputs
    return carbonate_inputs(state.bgc.tracers, grid, forcing,
                            state.bgc.ph_prev_3d, state.bgc.ph_prev_alt_3d,
                            env)


def k1_bound(args, dtype):
    """(bound_ms, bound_by, bytes, operations, mean iterations, path
    bound_ms): the larger of K1's bytes over the HBM rate and of the
    operations these inputs need (iteration counts from the plain
    version, which runs the same per-lane iteration) over the peak rate
    of the type.  The path bound counts only the outputs the step reads."""
    from ocean_bgc_tpu_torch.ops.cuda_carbonate import (
        co3_terms_dual_coeffs_torch)
    *_, stats = co3_terms_dual_coeffs_torch(*args, with_stats=True)
    n = args[0].numel()
    ops = OPS_CELL * n
    for st in stats:
        iters = st["iters"].double()
        grows = st["grows"].double()
        ops += (n * (OPS_SCENARIO + 2 * OPS_TALK_FN + OPS_TALK)
                + (grows * (OPS_GROW + 2 * OPS_TALK_FN)).sum().item()
                + (iters * OPS_ITER).sum().item()
                + ((iters - 1).clamp_min(0) * OPS_TALK).sum().item())
    nbytes = (K1_FIELDS_IN + K1_FIELDS_OUT) * args[0].element_size() * n
    path_bytes = ((K1_FIELDS_IN + K1_FIELDS_OUT_READ)
                  * args[0].element_size() * n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    path_ms = max(path_bytes / HBM_BYTES_PER_S * 1e3, t_ops)
    iters_mean = [st["iters"].double().mean().item() for st in stats]
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops, iters_mean, path_ms)


def check_k1(dtype, world, env, warm_state):
    """Phase 2: K1 against its plain version on cold and warm inputs;
    returns the measured numbers of the warm (steady-state) inputs.

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
    out = {}
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
        ms = cuda_ms(lambda: k1(*args, impl="kernel"), reps=20)
        plain_ms = cuda_ms(lambda: plain(*args), reps=1, warmup=1, rounds=3)
        bound_ms, bound_by, nbytes, ops, iters, path_ms = k1_bound(args,
                                                                   dtype)
        log(f"K1 {dtype} {label}: {ms:.4f} ms/launch, plain {plain_ms:.3f}"
            f" ms, bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f}"
            f" MB, {ops / 1e9:.3f} Gop, mean iterations {iters[0]:.2f} / "
            f"{iters[1]:.2f}); bound of the {K1_FIELDS_IN} + "
            f"{K1_FIELDS_OUT_READ} fields the step needs {path_ms:.4f} ms")
        out[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
    return out["warm"]


def breakdown(dtype, state, grid, forcing, params, env):
    """Where one step's time goes: each part of the step called alone on
    the step's inputs (CUDA events), and the device's busy share of a
    step from the profiler."""
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
        "step": lambda: coupled.step(state, grid, forcing, params, DT,
                                     compute_diags=False, env=env),
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
    times = {k: cuda_ms(fn, reps=3, warmup=1, rounds=3)
             for k, fn in parts.items()}
    rest = (times["bgc_source_sink"] - times["  K1"]
            - times["  ecosystem_kinetics"])
    for k, v in times.items():
        log(f"  {dtype} {k}: {v:.3f} ms")
    log(f"  {dtype}   level recurrence + assembly + masking (remainder): "
        f"{rest:.3f} ms")
    busy = device_busy_ms(parts["step"])
    if busy is None:
        log(f"  {dtype} device busy share of a step: not measured (the "
            f"profiler reported no device time)")
    else:
        log(f"  {dtype} device busy share of a step: {busy:.3f} ms of "
            f"{times['step']:.3f} ms ({100 * busy / times['step']:.1f}%)")


def device_busy_ms(fn):
    """Sum of device kernel time over one call, from torch.profiler, or
    None where the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
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
    from ocean_bgc_tpu_torch.ops.carbonate import co2calc_surface_dual
    from ocean_bgc_tpu_torch.ops.carbonate import _solve_htotal_impl
    from ocean_bgc_tpu_torch.ops.carbonate import _to_mass_units
    from ocean_bgc_tpu_torch.ops.carbonate import solver_xacc
    from ocean_bgc_tpu_torch.ops.carbonate import warm_brackets_h
    from ocean_bgc_tpu_torch.ops.cuda_carbonate import co3_terms_dual_coeffs
    from ocean_bgc_tpu_torch.state import BGCTracers as T
    from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world
    import ocean_bgc_tpu_torch.constants as c

    world = synthetic_world(nlev=NLEV, ncol=NCOL, seed=SEED, ragged=True,
                            dtype=dtype)
    state0, grid, forcing = world
    env = precompute_env(grid, forcing, params.bgc)

    # -- the main path, counted --
    co3_terms_dual_coeffs.launches = 0
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
    launches = co3_terms_dual_coeffs.launches
    log(f"main path {dtype}: 10 steps at {NLEV}x{NCOL} in {wall:.3f} s, "
        f"K1 launches {launches}")
    if launches != 10:
        raise AssertionError(f"K1 launched {launches} times in 10 steps")
    for name, t in (("tracers", state.bgc.tracers), ("dms", state.dms),
                    ("macros", state.macros)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite {name} after 10 steps")
    if not (state.bgc.ph_prev_3d[grid.active_mask()] > 6.0).all():
        raise AssertionError("interior pH out of range after 10 steps")

    # -- kernel vs plain version through the whole step --
    a = b = state0
    for _ in range(3):
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
    log(f"main path {dtype}: kernel vs torch over 3 steps: tracers/DMS/"
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
    ms = cuda_ms(one, reps=3, warmup=1, rounds=5)
    log(f"step {dtype} at {NLEV}x{NCOL} (ragged, env on, diags off): "
        f"{ms:.3f} ms/step, {NCOL / (ms / 1e3):.1f} columns/s")

    # -- the plain solves outside K1: surface pair and stand-in --
    surf = states[0].bgc.tracers[0].clamp_min(0.0)
    br = warm_brackets_h(states[0].bgc.surface_ph, c.PHLO_SURF_INIT,
                         c.PHHI_SURF_INIT, c.DEL_PH)
    surf_ms = cuda_ms(lambda: co2calc_surface_dual(
        forcing.surface_depth, forcing.sst, forcing.sss, surf[T.DIC],
        surf[T.DIC_ALT_CO2], surf[T.ALK], surf[T.PO4], surf[T.SIO3],
        None, None, None, None, forcing.atm_co2, forcing.atm_co2_alt,
        forcing.surface_pressure, brackets_a=br, brackets_b=br),
        reps=3, warmup=1, rounds=3)
    full = torch.full_like(env.standin_ph, 1.0)
    m = _to_mass_units(2000.0 * full, 2300.0 * full, 0.0 * full,
                       0.0 * full)
    standin_ms = cuda_ms(lambda: _solve_htotal_impl(
        env.coeffs, *m, full * 10.0 ** -c.PHHI_3D_INIT,
        full * 10.0 ** -c.PHLO_3D_INIT), reps=1, warmup=1, rounds=3)
    log(f"plain solves {dtype}: surface pair ({NCOL} columns, warm) "
        f"{surf_ms:.3f} ms/step; stand-in ({NLEV * NCOL} cells, cold, "
        f"once per forcing snapshot) {standin_ms:.3f} ms")

    log(f"breakdown of one {dtype} step at {NLEV}x{NCOL}:")
    breakdown(dtype, states[-1], grid, forcing, params, env)
    return dict(launches=launches, **k1)


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
    from ocean_bgc_tpu_torch.models.coupled import step
    from ocean_bgc_tpu_torch.ops.bgc import precompute_env
    from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world
    state, grid, forcing = synthetic_world(nlev=NLEV, ncol=NCOL_BIG,
                                           seed=SEED, ragged=True)
    env = precompute_env(grid, forcing, params.bgc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, _ = step(state, grid, forcing, params, DT, compute_diags=False,
                  env=env)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ok = all(torch.isfinite(t).all().item() for t in (
        out.bgc.tracers, out.dms, out.macros, out.bgc.ph_prev_3d))
    state_gb = sum(t.numel() * t.element_size() for t in (
        state.bgc.tracers, state.dms, state.macros)) / 1e9
    log(f"f64 step at {NLEV}x{NCOL_BIG}: {wall:.3f} s (first call), "
        f"prognostic state {state_gb:.2f} GB, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB, finite {ok}")
    if not ok:
        raise AssertionError("non-finite state after the big f64 step")


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
        log(f"  {name}: {r['seconds']:.2f} s\n{r['log'].strip()}")

    params = ModelParams()
    oracle_check(params)
    kernels = []
    for dtype in (torch.float64, torch.float32):
        k = main_path(dtype, params)
        kernels.append(dict(
            name=f"carbonate_dual ({str(dtype).split('.')[-1]})",
            route="cuda",
            source="ocean_bgc_tpu_torch/csrc/carbonate_dual.cu",
            replaces="ocean_bgc_tpu/ops/pallas_carbonate.py:63",
            launches=k["launches"], max_abs_err=k["max_abs_err"],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=None))
    big_step(params)

    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
