"""What decides ``correct``: the program's state on columns drawn from
the seed against the plain reference, over two stretches of the run.

Columns of this system are independent answers (no step couples two
columns), so a sample of them is a sample of the answers the window
produced.  Two correct float64 trajectories part beyond rounding after
a few dozen steps, where a value crosses a threshold of the ecosystem (a
clamp at zero, a limitation switch) in one and not in the other, so the
reference follows the program from the inputs only to a fixed horizon,
the trajectory's ``check_steps``-th step (warm-up included), and takes
up the run's last step from the program's own state before it.  The
numbers compared, each against its limit in ``limits/<workload>.json``
or else ``limits/default.json``:

* ``tracers_gap``: the 30 BGC tracers at the horizon; per tracer the
  largest gap over the sampled cells over that tracer's largest
  magnitude there, the worst tracer;
* ``trace_gas_gap``: the same over DMS, DMSP, PROT, POLY and LIP;
* ``ph_gap``: the largest gap, in pH, of the four pH warm-start fields
  (the interior's two a cell, the surface's two a column);
* ``last_tracers_gap``, ``last_trace_gas_gap``, ``last_ph_gap``: the
  same three after the last step;
* ``nonfinite_values``: values of the whole program state at the end of
  the run, every column, that are not finite (limit 0).
"""

from __future__ import annotations

import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from portbench.reference.coupled import coupled_step_ref

LIMITS = Path(__file__).resolve().parent / "limits"
NUMBERS = ("tracers_gap", "trace_gas_gap", "ph_gap", "last_tracers_gap",
           "last_trace_gas_gap", "last_ph_gap", "nonfinite_values")


def limits_for(workload: str) -> dict:
    """A cell's check: its own file where there is one (``{"limits":
    {number: limit}, "columns": n, "check_steps": k}``)."""
    own = LIMITS / f"{workload}.json"
    path = own if own.exists() else LIMITS / "default.json"
    return json.loads(path.read_text())


def initial_state(state):
    """The reference's state from a world's state as the generator makes
    it (``{"bgc": {...}, "dms", "macros"}``)."""
    return dict(tracers=state["bgc"]["tracers"],
                ph_prev=state["bgc"]["ph_prev_3d"],
                ph_prev_alt=state["bgc"]["ph_prev_alt_3d"],
                surface_ph=state["bgc"]["surface_ph"],
                surface_ph_alt=state["bgc"]["surface_ph_alt"],
                dms=state["dms"], macros=state["macros"])


def follow(state, grid, forcing, records, schedule, params, dt):
    """The reference's state (the dict of :func:`initial_state`) after
    the steps of ``schedule`` (the record each step reads), on some
    columns: ``grid`` and ``forcing`` NumPy dicts as the generator makes
    them, ``records`` dicts of the record fields."""
    for r in schedule:
        state = coupled_step_ref(state, grid, {**forcing, **records[r]},
                                 params, dt)
    return state


def reference_run(legs, grid, forcing, records, params, dt):
    """:func:`follow` for each leg, a (state, schedule) pair over the
    same sampled columns, which are independent: the columns of every
    leg split over as many worker processes as there are cores (spawned,
    and shut down and joined here; a worker that dies raises rather
    than hangs); returns ([state of each leg], seconds)."""
    t = time.perf_counter()
    ncol = grid["kmax"].shape[0]
    workers = max(1, min(ncol, os.cpu_count() or 1))
    parts = [p for p in np.array_split(np.arange(ncol), workers) if p.size]
    jobs = [(slice_columns(state, p), slice_columns(grid, p),
             slice_columns(forcing, p),
             [slice_columns(r, p) for r in records], schedule, params, dt)
            for state, schedule in legs for p in parts]
    if workers == 1:
        outs = [follow(*job) for job in jobs]
    else:
        with ProcessPoolExecutor(
                workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            outs = [f.result() for f in
                    [pool.submit(follow, *job) for job in jobs]]
    n = len(parts)
    legs_out = [{k: np.concatenate([o[k] for o in outs[i:i + n]], axis=-1)
                 for k in outs[i]} for i in range(0, len(outs), n)]
    return legs_out, time.perf_counter() - t


def _gap(got, want, axis):
    """Per slot along ``axis`` the largest |got - want| over that slot's
    largest |want|; the worst slot.  Non-finite values read infinite."""
    other = tuple(i for i in range(want.ndim) if i != axis)
    scale = np.abs(want).max(axis=other)
    gap = np.abs(got - want).max(axis=other) / np.where(scale > 0, scale,
                                                        1.0)
    return float(np.nan_to_num(gap, nan=np.inf).max())


def compare(got: dict, want: dict, prefix: str = "") -> dict:
    """The numbers of the sampled columns, their names after ``prefix``:
    ``got`` the program's fields (``tracers``, ``dms``, ``macros``,
    ``ph_prev``, ``ph_prev_alt``, ``surface_ph``, ``surface_ph_alt``,
    float64 NumPy), ``want`` the reference's."""
    ph = max(float(np.nan_to_num(np.abs(got[k] - want[k]),
                                 nan=np.inf).max())
             for k in ("ph_prev", "ph_prev_alt", "surface_ph",
                       "surface_ph_alt"))
    return {prefix + "tracers_gap": _gap(got["tracers"], want["tracers"], 1),
            prefix + "trace_gas_gap": max(_gap(got["dms"], want["dms"], 1),
                                          _gap(got["macros"], want["macros"],
                                               1)),
            prefix + "ph_gap": ph}


def judge(numbers: dict, limits: dict):
    """(correct, lines): each number beside its limit, and whether every
    one is within it."""
    ok = all(numbers[k] <= limits[k] for k in NUMBERS)
    lines = [f"{k} {numbers[k]!r} limit {limits[k]!r}" for k in NUMBERS]
    return ok, lines


def slice_columns(tree, cols):
    """Every array of a (nested) dict with its last axis cut to
    ``cols``."""
    if isinstance(tree, dict):
        return {k: slice_columns(v, cols) for k, v in tree.items()}
    return np.ascontiguousarray(tree[..., cols])
