"""Time-varying forcing: a forcing series, its interpolation, and forced runs.

Counterpart of ``ocean_bgc_tpu/models/forcing_series.py``.  The reference
library receives a fresh ``BGC_forcing_type`` every call — the host model
(MPAS-Ocean/POP) owns the time axis and interpolates its forcing
climatologies onto each coupling step (SURVEY.md §0).  A *forcing series*
is a :class:`~ocean_bgc_tpu_torch.state.BGCForcing` whose fields carry a
leading time-record axis; :func:`run_forced` integrates under it with
per-step linear interpolation or nearest-record hold.

The port runs eagerly: the steps are a Python loop, and the record index
and blend weight of each step are Python numbers computed on the host, so
picking a record reads nothing from the device.

Series files: :func:`ocean_bgc_tpu_torch.io.model_io.save_world` stores a
single snapshot; a series is the same variables with a leading ``time``
record dimension (:func:`save_forcing_series`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from ocean_bgc_tpu_torch.models.coupled import CoupledState, step
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.state import BGCForcing, ColumnGrid


def _map(fn, *forcings: BGCForcing) -> BGCForcing:
    return BGCForcing(**{
        f.name: fn(*(getattr(x, f.name) for x in forcings))
        for f in dataclasses.fields(BGCForcing)})


def num_records(series: BGCForcing) -> int:
    return series.potential_temperature.shape[0]


def _blend_point(t_frac: float, nrec: int) -> Tuple[int, int, float]:
    """(i0, i1, w) of fractional record index ``t_frac``, clamped to
    [0, nrec - 1], as Python numbers (JAX forcing_series.py:37-41)."""
    t = min(max(float(t_frac), 0.0), nrec - 1.0)
    i0 = min(max(int(math.floor(t)), 0), nrec - 1)
    return i0, min(i0 + 1, nrec - 1), t - i0


def forcing_at(series: BGCForcing, t_frac: float) -> BGCForcing:
    """Linearly interpolate a forcing series at fractional record index
    ``t_frac`` (clamped to [0, T-1]): ``a + (b - a) * w`` per field."""
    i0, i1, w = _blend_point(t_frac, num_records(series))
    return _map(lambda leaf: leaf[i0] + (leaf[i1] - leaf[i0]) * w, series)


def forcing_record(series: BGCForcing, index: int) -> BGCForcing:
    """Select record ``index`` (no interpolation — 'hold' mode)."""
    return _map(lambda leaf: leaf[int(index)], series)


def stack_forcings(records) -> BGCForcing:
    """Build a series from a sequence of per-record BGCForcing."""
    return _map(lambda *xs: torch.stack(xs, dim=0), *records)


def _blend_env(e0, e1, w: float):
    """``a + (b - a) * w`` over every tensor of two env caches (the
    coefficients, the saturation values, the Q10 response, the
    dissolution factors, the stand-in pH and the fingerprint alike)."""
    if isinstance(e0, torch.Tensor):
        return e0 + (e1 - e0) * w
    return type(e0)(*(_blend_env(a, b, w) for a, b in zip(e0, e1)))


def run_forced(
    state: CoupledState,
    grid: ColumnGrid,
    series: BGCForcing,
    params: ModelParams,
    dt: float,
    nsteps: int,
    record_dt: float,
    *,
    interp: str = "linear",
    t0: float = 0.0,
    compute_diags: bool = False,
    tavg_fields=None,
    carbonate_impl: str = "auto",
    env_mode: str = "auto",
):
    """Integrate ``nsteps`` under a time-varying forcing series.

    ``record_dt`` is the spacing (s) between consecutive forcing records;
    step ``i`` uses the forcing at model time ``t0 + (i + 1/2) * dt``
    (midpoint sampling).  ``interp``: "linear" blends the bracketing
    records, "hold" uses the nearest earlier record.

    ``env_mode`` — the forcing-invariant coefficient tables
    (:class:`ocean_bgc_tpu_torch.ops.bgc.EnvCache`) under a time-varying
    forcing:

    * ``"hold"`` — rebuild the cache only when a step crosses a record
      boundary.  Requires ``interp="hold"``; per-step inputs are then
      those of the uncached run.
    * ``"interp"`` — keep the two bracketing records' caches and blend
      every table linearly each step.  Requires ``interp="linear"``.  A
      qualified approximation (blending K(T0,S0) and K(T1,S1) is not
      K(T_blend, S_blend)), not for the float64 contract path.
    * ``"off"`` — recompute everything per step (the reference's
      semantics).
    * ``"auto"`` (default) — ``"hold"`` when ``interp="hold"``, ``"off"``
      when ``interp="linear"``.

    Returns ``(final state, diags)`` where ``diags`` belong to the final
    step taken (``compute_diags``).  With ``tavg_fields`` (see
    :func:`ocean_bgc_tpu_torch.models.coupled.run`) returns ``(final
    state, diags, TavgState)``.
    """
    from ocean_bgc_tpu_torch.ops.bgc import precompute_env
    from ocean_bgc_tpu_torch.utils.history import TavgState

    if interp not in ("linear", "hold"):
        raise ValueError(f"unknown interp mode {interp!r}")
    if env_mode == "auto":
        env_mode = "hold" if interp == "hold" else "off"
    if env_mode not in ("off", "hold", "interp"):
        raise ValueError(f"unknown env_mode {env_mode!r}")
    if env_mode == "hold" and interp != "hold":
        raise ValueError("env_mode='hold' is exact only under "
                         "interp='hold'; use env_mode='interp' (a "
                         "qualified approximation) with linear "
                         "interpolation")
    if env_mode == "interp" and interp != "linear":
        raise ValueError("env_mode='interp' blends bracketing records; "
                         "it requires interp='linear'")

    track = tuple(tavg_fields) if tavg_fields is not None else ()
    nrec = num_records(series)

    def t_frac(i):
        return (t0 + (i + 0.5) * dt) / record_dt

    def env_of(rec):
        return precompute_env(grid, forcing_record(series, rec), params.bgc)

    emit_final = compute_diags and nsteps >= 1
    final, tavg, cur_rec, env_c = state, None, None, None
    diags: Dict[str, torch.Tensor] = {}
    for i in range(nsteps):
        i0, i1, w = _blend_point(t_frac(i), nrec)
        forcing = (forcing_at(series, t_frac(i)) if interp == "linear"
                   else forcing_record(series, i0))
        env = None
        if env_mode != "off":
            if i0 != cur_rec:
                env_c = (env_of(i0) if env_mode == "hold"
                         else (env_of(i0), env_of(i1)))
                cur_rec = i0
            env = env_c if env_mode == "hold" else _blend_env(*env_c, w)
        last = emit_final and i == nsteps - 1
        final, d = step(final, grid, forcing, params, dt,
                        compute_diags=last or bool(track),
                        carbonate_impl=carbonate_impl, env=env,
                        diag_filter=None if last or not track else track)
        if track:
            if tavg is None:
                tavg = TavgState.create(d, track)
            tavg = tavg.accumulate(d)
        if last:
            diags = d
    if track:
        if tavg is None:
            raise ValueError("tavg_fields needs nsteps >= 1")
        return final, diags, tavg
    return final, diags


def save_forcing_series(path: str, series: BGCForcing, *,
                        record_dt: float) -> str:
    """Write a forcing series as NetCDF with ``time`` as the UNLIMITED
    record dimension (the JAX package's layout; readable by any netCDF
    tool and by :func:`load_forcing_series`)."""
    from ocean_bgc_tpu_torch.io import netcdf3 as nc
    from ocean_bgc_tpu_torch.io.model_io import to_numpy

    leaves = {f.name: to_numpy(getattr(series, f.name))
              for f in dataclasses.fields(BGCForcing)}
    sample = leaves["potential_temperature"]    # (T, nlev, ncol)
    nlev, ncol = sample.shape[1], sample.shape[2]
    ntrc = leaves["deposition_flux"].shape[1]

    ds = nc.Dataset()
    ds.dims = {"time": 0, "nlev": nlev, "ncol": ncol, "bgc_tracer": ntrc}
    ds.record_dim = "time"
    ds.attrs = {"title": "ocean_bgc_tpu forcing series",
                "record_dt_seconds": float(record_dt)}
    for name, a in leaves.items():
        if a.shape[1:] == (nlev, ncol):
            dims = ("time", "nlev", "ncol")
        elif a.shape[1:] == (ncol,):
            dims = ("time", "ncol")
        elif a.shape[1:] == (ntrc, ncol):
            dims = ("time", "bgc_tracer", "ncol")
        else:
            raise ValueError(f"{name}: unexpected shape {a.shape}")
        ds.variables[f"forcing_{name}"] = nc.Variable(dims, a)
    nc.write(path, ds)
    return path


def load_forcing_series(path: str, *, dtype=None, device=None):
    """Read a series written by :func:`save_forcing_series` (either
    package's).  Returns (series, record_dt_seconds); ``device`` defaults
    to CUDA."""
    from ocean_bgc_tpu_torch.io import netcdf3 as nc
    from ocean_bgc_tpu_torch.io.model_io import from_numpy
    from ocean_bgc_tpu_torch.utils.bridge import resolve_device

    ds = nc.read(path)
    dev = resolve_device(device)
    series = BGCForcing(**{
        f.name: from_numpy(ds.variables[f"forcing_{f.name}"].data, dev,
                           dtype)
        for f in dataclasses.fields(BGCForcing)})
    return series, float(ds.attrs["record_dt_seconds"])
