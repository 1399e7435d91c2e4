"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration, whose file gives the mesh, and a
traffic mix, ``portbench/traffic/<traffic>.json``, whose parameters the
one driver here reads.  Set-up makes the world and the mix's forcing
records from the seed, hands them to ``ocean_bgc_tpu_torch`` and warms
up every shape the mix uses; the window then steps the program in a
closed loop for ``--seconds`` and ends in a device synchronisation.
Each metric the cell reports is read by ``portbench/metrics/<name>.py``:
with ``--trace 0`` the end-to-end ones, with ``--trace 1`` the per-layer
ones from a device trace of the window.  Afterwards the plain reference
(``portbench/reference/``) follows columns drawn from the seed from the
inputs through the first steps, and takes up the last step from the
program's state before it; ``check.py`` decides ``correct``.

The last line of standard output is one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error.
Exit codes: 0 with a result, 2 without a card (or fewer than the cell
asks for), 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

_IMPORTED_NS = time.monotonic_ns()

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ocean_bgc_tpu")


def since_process_start() -> float:
    """Seconds since this process started (its start time as the kernel
    records it), or since this module was imported where that is not
    readable."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return (time.monotonic_ns() - _IMPORTED_NS) / 1e9


def forbidden_modules():
    """The loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``ocean_bgc_tpu_torch`` is not
    ``ocean_bgc_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def resolve(workload: str, root: Path = ROOT) -> SimpleNamespace:
    """A cell of ``BENCHMARK.json`` with its configuration, its traffic
    mix and the metrics it reports, found by name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return SimpleNamespace(
        name=workload, chips=int(w["chips"]), config_name=w["config"],
        config=load_json(root / cfg_entry["file"]),
        traffic_name=w["traffic"],
        mix=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])


def reader(name: str):
    """The ``read(ctx)`` of ``portbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Driver:
    """The traffic mix over the program: step ``i`` (from 0, warm-up
    included) reads record ``world.record_of(i)``; where the mix keeps an
    env cache it is rebuilt at each record's first step.  The host time
    inside the program's calls is summed (the benchmark's own spans).
    Before each step the sampled columns ``cols`` of the state it is
    handed are gathered on the device (``before``: the step's index and
    the fields), so that the check can take up the last step."""

    def __init__(self, program, state, grid, forcings, params, mix, dt,
                 cols, step_fn=None, after_step=None):
        import torch

        from portbench.world import record_of
        self.span = torch.profiler.record_function
        self.program, self.state, self.grid = program, state, grid
        self.forcings, self.params, self.mix, self.dt = (forcings, params,
                                                         mix, dt)
        self.cols = cols
        self.record_of = record_of
        self.step_fn = step_fn or program.step
        self.after_step = after_step
        self.env = None
        self.before = None
        self.steps = 0
        self.reset_spans()

    def reset_spans(self):
        self.host_ns = 0
        self.spanned = 0

    def advance(self):
        i = self.steps
        r = self.record_of(i, self.mix)
        forcing = self.forcings[r]
        self.before = (i, state_fields(self.state, self.cols))
        if self.mix["env_cache"] and (self.env is None
                                      or i % int(self.mix["hold_steps"])
                                      == 0):
            t = time.perf_counter_ns()
            with self.span("portbench.precompute_env"):
                self.env = self.program.precompute_env(self.grid, forcing,
                                                       self.params.bgc)
            self.host_ns += time.perf_counter_ns() - t
        t = time.perf_counter_ns()
        with self.span("portbench.step"):
            self.state, _ = self.step_fn(
                self.state, self.grid, forcing, self.params, self.dt,
                compute_diags=False, env=self.env)
        self.host_ns += time.perf_counter_ns() - t
        self.spanned += 1
        self.steps += 1
        if self.after_step is not None:
            self.after_step(self)


def state_fields(state, cols=None):
    """The program's state as a dict of its seven fields, on ``cols``
    (a device index tensor of columns) where given."""
    fields = dict(tracers=state.bgc.tracers, dms=state.dms,
                  macros=state.macros, ph_prev=state.bgc.ph_prev_3d,
                  ph_prev_alt=state.bgc.ph_prev_alt_3d,
                  surface_ph=state.bgc.surface_ph,
                  surface_ph_alt=state.bgc.surface_ph_alt)
    if cols is None:
        return fields
    return {k: v.index_select(-1, cols) for k, v in fields.items()}


def to_numpy(fields):
    import torch
    return {k: v.to("cpu", torch.float64).numpy() for k, v in fields.items()}


# the steps after the window that a traced run records with the host's
# operators, to name the card's idle gaps in ``breakdown``
HOST_TRACE_STEPS = 2


def run_cell(cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", dtype: str = None, step_fn=None,
             columns: int = None, levels: int = None):
    """One run of ``cell``; returns (result dict, lines compared).
    ``dtype`` overrides the configuration's (the control's lower
    precision), ``step_fn`` the program's step (the faults of the CPU
    tests), ``columns``/``levels`` its sizes (CPU rehearsals)."""
    import torch

    from portbench import check, program, world
    from portbench.reference.params import load_namelist, reference_params
    from portbench.trace import WINDOW, Recorder, breakdown

    phases = [("imports", since_process_start())]
    cfg, mix = cell.config, cell.mix
    dtype = dtype or cfg["dtype"]
    tdtype = getattr(torch, dtype)
    ncol = int(columns or cfg["columns"])
    nlev = int(levels or cfg["levels"])
    dt = float(cfg["dt_s"])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    phases.append(("card", since_process_start()))

    namelist = load_namelist()
    params = program.params(namelist)
    w_state, w_grid, w_forcing = world.synthetic_world(
        nlev, ncol, seed % (1 << 64), device=device, **cfg["world"])
    records = world.make_records(
        {k: w_forcing[k] for k in world.RECORD_FIELDS},
        w_grid["cell_center_depth"], mix, seed)

    # the check's sample, and the reference's inputs there, taken before
    # the program sees the world
    lim = check.limits_for(cell.name)
    cols = world.sample_columns(ncol, min(int(lim["columns"]), ncol), seed)
    idx = torch.as_tensor(cols, device=device)
    ref_in = [world.columns_numpy(t, idx)
              for t in (w_state, w_grid, w_forcing)]
    rec_cols = [world.columns_numpy(r, idx) for r in records]

    state, grid, forcing = program.world(w_state, w_grid, w_forcing,
                                         dtype=tdtype)
    forcings = [program.with_record(forcing, r, tdtype) for r in records]
    del w_state, w_grid, w_forcing, records
    phases.append(("world and records", since_process_start()))

    # the check's early horizon: the sample after the check's step,
    # gathered on the card as that step completes (no synchronisation)
    snap = {}

    def take(drv):
        if drv.steps == int(lim["check_steps"]):
            snap.update(steps=drv.steps,
                        fields=state_fields(drv.state, idx))

    drv = Driver(program, state, grid, forcings, params, mix, dt, idx,
                 step_fn, after_step=take)
    del state

    def sync():
        if on_card:
            torch.cuda.synchronize()

    for _ in range(int(mix["warmup_steps"])):
        drv.advance()
    sync()

    phases.append(("warm-up", since_process_start()))
    setup_s = since_process_start()

    # a traced run first records the card's activity alone (no host
    # operators) over ``trace_steps`` steps, bounded by the host's clock
    # from one synchronisation to the next, and reads it; the window
    # then runs untraced, as in any run, and gives the host's numbers
    # and the wall per step; after the window, a few steps are recorded
    # with the host's operators to name the card's idle gaps
    tr = host_tr = None
    if trace:
        if not on_card:
            raise RuntimeError("the per-layer metrics are read from the "
                               "card's trace, and there is no card")
        t = time.perf_counter()
        recorder = Recorder(host=False)
        recorder.start()
        t_traced = time.perf_counter()
        for _ in range(int(mix["trace_steps"])):
            drv.advance()
        sync()
        traced_wall = time.perf_counter() - t_traced
        recorder.stop()
        tr = recorder.read(traced_wall)
        trace_s = time.perf_counter() - t

    warm = drv.steps
    drv.reset_spans()
    t0 = time.perf_counter()
    while True:
        drv.advance()
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    steps = drv.steps - warm
    host_ns, host_steps = drv.host_ns, drv.spanned

    if trace:
        t = time.perf_counter()
        host_rec = Recorder(host=True)
        host_rec.start()
        with torch.profiler.record_function(WINDOW):
            for _ in range(HOST_TRACE_STEPS):
                drv.advance()
            sync()
        host_rec.stop()
        host_tr = host_rec.read()
        traced_steps = int(mix["trace_steps"])
        trace_note = (
            f"trace: {traced_steps} steps, {len(tr.kernels)} kernels and "
            f"{len(tr.copies)} copies, {traced_wall / traced_steps * 1e3:.1f}"
            f" ms a step traced against {window_s / steps * 1e3:.1f} in the "
            f"window, recorded and read in {trace_s:.1f} s; "
            f"{HOST_TRACE_STEPS} steps with {len(host_tr.host_ops)} host "
            f"operators after the window in {time.perf_counter() - t:.1f} s")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    reserved = torch.cuda.max_memory_reserved() if on_card else None

    # the device's per-layer metrics are per step of the traced steps,
    # the host's per step of the window's
    ctx = SimpleNamespace(
        columns=ncol, levels=nlev, dtype=dtype,
        steps=int(mix["trace_steps"]) if tr else steps, window_s=window_s,
        setup_s=setup_s, memory_peak_bytes=peak, trace=tr,
        host_ns=host_ns, host_steps=host_steps,
        step_wall_s=window_s / steps if steps else None,
        csrc_names=program.csrc_kernel_names())
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the whole state's values must be finite; the sampled columns are
    # compared from the inputs to the check's step (or the last one,
    # where the run ended before it), and over the last step from the
    # program's own state before it.  The program's buffers are freed
    # before the reference runs.
    fields = state_fields(drv.state)
    nonfinite = int(sum((~torch.isfinite(v)).sum().item()
                        for v in fields.values()))
    if not snap:
        snap.update(steps=drv.steps, fields=state_fields(drv.state, idx))
    got = to_numpy(snap["fields"])
    last_i, last_before = drv.before
    last_got = to_numpy(state_fields(drv.state, idx))
    last_before = to_numpy(last_before)
    schedule = [world.record_of(i, mix) for i in range(snap["steps"])]
    total_steps = drv.steps
    del fields, snap, drv, forcings, grid, forcing, idx
    if on_card:
        torch.cuda.empty_cache()

    (want, last_want), ref_s = check.reference_run(
        [(check.initial_state(ref_in[0]), schedule),
         (last_before, [world.record_of(last_i, mix)])],
        ref_in[1], ref_in[2], rec_cols, reference_params(namelist), dt)
    numbers = check.compare(got, want)
    numbers.update(check.compare(last_got, last_want, prefix="last_"))
    numbers["nonfinite_values"] = nonfinite
    correct, judged = check.judge(numbers, lim["limits"])
    setup_line = "setup: " + ", ".join(
        f"{name} to {t:.2f} s" for name, t in phases)
    if on_card:
        setup_line += (f"; peak {peak / 1e9:.3f} GB allocated, "
                       f"{reserved / 1e9:.3f} GB reserved")
    lines = [setup_line] + ([trace_note] if tr else []) + [
        f"window: {steps} steps in {window_s:.3f} s after {warm} steps of "
        f"warm-up{' and trace' if tr else ''}; {len(cols)} columns checked after step {len(schedule)} "
        f"from the inputs and over step {last_i + 1} of {total_steps} "
        f"from the program's state, the reference's in {ref_s:.1f} s"
    ] + judged

    result = {"correct": bool(correct), "attempted": steps * ncol,
              "failed": 0, "metrics": metrics}
    if on_card:
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(0),
                            "count": cell.chips,
                            "memory_peak_bytes": int(peak)}
        if tr is not None:
            result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
            result["breakdown"] = breakdown(tr, host_tr)
    result["checks"] = {k: {"value": numbers[k],
                            "limit": lim["limits"][k]}
                        for k in check.NUMBERS}
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = resolve(args.workload)
    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
