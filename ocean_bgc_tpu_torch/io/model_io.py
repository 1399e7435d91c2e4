"""NetCDF world exchange: grids, forcing, and restart state as files.

Counterpart of ``ocean_bgc_tpu/io/model_io.py`` on the port's state
classes, in the same file layout, so that each package reads the other's
files.  The reference's host model (MPAS-Ocean/POP) supplies forcing and
persists restart state via NetCDF; the library itself never touches files
(SURVEY.md §0, §5 checkpoint/resume).  A
:class:`~ocean_bgc_tpu_torch.state.ColumnGrid` +
:class:`~ocean_bgc_tpu_torch.state.BGCForcing` + coupled prognostic state
round-trips through a single classic-NetCDF file
(:mod:`ocean_bgc_tpu_torch.io.netcdf3`).

The restart contract mirrors the reference exactly: tracers plus the pH
warm-start fields (PH_PREV_3D / PH_PREV_ALT_CO2_3D, surface_pH ×2 —
BGC_parms.F90:151-152,171), with pH == 0 meaning "no previous solution".
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ocean_bgc_tpu_torch.io import netcdf3 as nc
from ocean_bgc_tpu_torch.models.coupled import CoupledState
from ocean_bgc_tpu_torch.state import (
    BGC_TRACER_NAMES,
    BGCForcing,
    BGCState,
    ColumnGrid,
)
from ocean_bgc_tpu_torch.utils.bridge import resolve_device

_GRID_FIELDS = ("cell_center_depth", "cell_thickness", "cell_bottom_depth",
                "latitude", "kmax")


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def from_numpy(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on ``device``; floating arrays cast to
    ``dtype`` where one is given."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _dims_for(name: str, shape: Tuple[int, ...], nlev: int, ncol: int,
              ntrc: int) -> Tuple[str, ...]:
    if shape == (nlev, ncol):
        return ("nlev", "ncol")
    if shape == (ncol,):
        return ("ncol",)
    if shape == (ntrc, ncol):
        return ("bgc_tracer", "ncol")
    if shape == (nlev, ntrc, ncol):
        return ("nlev", "bgc_tracer", "ncol")
    raise ValueError(f"{name}: unexpected shape {shape}")


def save_world(path: str, state: CoupledState, grid: ColumnGrid,
               forcing: BGCForcing, *,
               attrs: Optional[Dict[str, object]] = None) -> str:
    """Write grid + forcing + full prognostic state to one NetCDF file."""
    nlev, ntrc, ncol = state.bgc.tracers.shape
    ds = nc.Dataset()
    ds.dims = {"nlev": nlev, "ncol": ncol, "bgc_tracer": ntrc,
               "dms_tracer": state.dms.shape[1],
               "macros_tracer": state.macros.shape[1]}
    ds.attrs = {"title": "ocean_bgc_tpu world file",
                "conventions": "ocean_bgc_tpu-v1",
                "tracer_names": ",".join(BGC_TRACER_NAMES)}
    if attrs:
        ds.attrs.update(attrs)

    def put(name, arr, dims=None):
        a = to_numpy(arr)
        dims = dims or _dims_for(name, a.shape, nlev, ncol, ntrc)
        ds.variables[name] = nc.Variable(dims, a)

    for f in _GRID_FIELDS:
        put(f"grid_{f}", getattr(grid, f))
    for f in dataclasses.fields(BGCForcing):
        put(f"forcing_{f.name}", getattr(forcing, f.name))
    put("state_tracers", state.bgc.tracers,
        ("nlev", "bgc_tracer", "ncol"))
    put("state_ph_prev_3d", state.bgc.ph_prev_3d)
    put("state_ph_prev_alt_3d", state.bgc.ph_prev_alt_3d)
    put("state_surface_ph", state.bgc.surface_ph)
    put("state_surface_ph_alt", state.bgc.surface_ph_alt)
    put("state_dms", state.dms, ("nlev", "dms_tracer", "ncol"))
    put("state_macros", state.macros, ("nlev", "macros_tracer", "ncol"))

    nc.write(path, ds)
    return path


def load_world(path: str, *, dtype=None, device=None
               ) -> Tuple[CoupledState, ColumnGrid, BGCForcing]:
    """Read a file written by :func:`save_world` (either package's, or
    assembled by any netCDF tool following the same variable naming).
    ``dtype``: the torch type of the floating fields (the file's where
    None); ``kmax`` is int32.  ``device`` defaults to CUDA."""
    ds = nc.read(path)
    dev = resolve_device(device)

    def get(name):
        v = ds.variables[name].data
        if name == "grid_kmax":
            v = v.astype(np.int32)
        return from_numpy(v, dev, dtype)

    grid = ColumnGrid(**{f: get(f"grid_{f}") for f in _GRID_FIELDS})
    forcing = BGCForcing(**{
        f.name: get(f"forcing_{f.name}")
        for f in dataclasses.fields(BGCForcing)})
    bgc = BGCState(
        tracers=get("state_tracers"),
        ph_prev_3d=get("state_ph_prev_3d"),
        ph_prev_alt_3d=get("state_ph_prev_alt_3d"),
        surface_ph=get("state_surface_ph"),
        surface_ph_alt=get("state_surface_ph_alt"))
    state = CoupledState(bgc=bgc, dms=get("state_dms"),
                         macros=get("state_macros"))
    return state, grid, forcing


def save_history_netcdf(path: str, means: Dict[str, np.ndarray], *,
                        nlev: int, ncol: int, count: int = 0,
                        attrs: Optional[Dict[str, object]] = None) -> str:
    """Write time-averaged diagnostics (``TavgState.means()``, tensors or
    arrays) as NetCDF.

    Diagnostic arrays are (nlev, ncol), (ncol,), or (nlev, ngroup, ncol);
    units/long names from the registry are attached as attributes."""
    from ocean_bgc_tpu_torch.utils.diag import coupled_registry
    registry = coupled_registry()

    ds = nc.Dataset()
    ds.dims = {"nlev": nlev, "ncol": ncol}
    ds.attrs = {"title": "ocean_bgc_tpu history (time means)",
                "count": np.int32(count)}
    if attrs:
        ds.attrs.update(attrs)
    for name, val in means.items():
        a = to_numpy(val)
        if a.shape == (nlev, ncol):
            dims = ("nlev", "ncol")
        elif a.shape == (ncol,):
            dims = ("ncol",)
        elif a.ndim == 3 and a.shape[0] == nlev and a.shape[2] == ncol:
            g = f"group{a.shape[1]}"
            ds.dims.setdefault(g, a.shape[1])
            dims = ("nlev", g, "ncol")
        elif a.ndim == 0:
            dims = ()
        else:
            g = f"dim{a.shape[0]}"
            ds.dims.setdefault(g, a.shape[0])
            dims = (g,) + (("ncol",) if a.ndim == 2 else ())
        vattrs = {}
        spec = registry.get(name)
        if spec is not None:
            vattrs = {"units": spec.units, "long_name": spec.description}
        ds.variables[name] = nc.Variable(tuple(dims), a, vattrs)
    nc.write(path, ds)
    return path
