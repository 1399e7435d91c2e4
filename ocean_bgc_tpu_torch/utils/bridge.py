"""Carry a parameter set and a world across from numpy, and a world out
to a host's arrays.

The reference package's dataclasses reach this module as plain Python
data: ``dataclasses.asdict`` of its parameters, and dicts of numpy arrays
keyed by its dataclasses' field names for the state, grid and forcing.
Nothing here imports the reference package.  :func:`host_arguments`
writes a world out as the host-coupling API's arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ocean_bgc_tpu_torch.models.coupled import (
    CoupledState,
    dms_tracer_block,
    macros_tracer_block,
)
from ocean_bgc_tpu_torch.params import (
    AutotrophTraits,
    BGCParams,
    DMSParams,
    MACROSParams,
    ModelParams,
)
from ocean_bgc_tpu_torch.state import BGCForcing, BGCState, ColumnGrid
from ocean_bgc_tpu_torch.utils.profiling import readback


def resolve_device(device) -> torch.device:
    """The device a tensor-creating entry point builds on: CUDA unless the
    caller asks otherwise; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return dev


def params_from_dict(d: Mapping) -> ModelParams:
    """``ModelParams`` from ``dataclasses.asdict`` of a parameter set with
    the same fields (the reference's ``ModelParams``)."""
    bgc = dict(d["bgc"])
    bgc["autotrophs"] = tuple(AutotrophTraits(**a)
                              for a in bgc["autotrophs"])
    for key in ("parm_scalelen_z", "parm_scalelen_vals"):
        bgc[key] = tuple(bgc[key])
    return ModelParams(bgc=BGCParams(**bgc), dms=DMSParams(**d["dms"]),
                       macros=MACROSParams(**d["macros"]))


def _build(cls, fields: Mapping, device, dtype):
    def conv(name):
        a = np.asarray(fields[name])
        if np.issubdtype(a.dtype, np.floating):
            return torch.tensor(a, dtype=dtype, device=device)
        return torch.tensor(a, device=device)
    return cls(**{f.name: conv(f.name) for f in dataclasses.fields(cls)})


def world_from_numpy(state: Mapping, grid: Mapping, forcing: Mapping, *,
                     device=None, dtype=torch.float64
                     ) -> Tuple[CoupledState, ColumnGrid, BGCForcing]:
    """The port's (CoupledState, ColumnGrid, BGCForcing) from numpy.

    ``state`` is ``{"bgc": {BGCState fields}, "dms": ..., "macros": ...}``,
    ``grid`` and ``forcing`` map the field names of ``ColumnGrid`` and
    ``BGCForcing`` to arrays.  Floating arrays become ``dtype``, integer
    arrays (``kmax``) keep their type.  ``device`` defaults to CUDA."""
    dev = resolve_device(device)
    cstate = CoupledState(
        bgc=_build(BGCState, state["bgc"], dev, dtype),
        dms=torch.tensor(np.asarray(state["dms"]), dtype=dtype, device=dev),
        macros=torch.tensor(np.asarray(state["macros"]), dtype=dtype,
                            device=dev))
    return (cstate, _build(ColumnGrid, grid, dev, dtype),
            _build(BGCForcing, forcing, dev, dtype))


def host_arguments(state: CoupledState, grid: ColumnGrid,
                   forcing: BGCForcing) -> Dict[str, Dict[str, np.ndarray]]:
    """A world as the host-coupling API's keyword arguments, by entry
    point (``host_api.BGC_SourceSink`` etc.): every field as a float64
    NumPy array in the host's layout, ``(ncol, nlev[, ntracer])``, per
    column ``(ncol,)`` and per-tracer fluxes ``(ncol, 30)``, canonical
    tracer order, ``kmax`` int32.  The pH warm starts are left out (a
    cold call); the caller adds them."""

    def host(t):
        a = readback(t).detach().to("cpu", torch.float64).numpy()
        if a.ndim == 3:            # (nlev, ntracer, ncol) tracer block
            return np.ascontiguousarray(a.transpose(2, 0, 1))
        return np.ascontiguousarray(a.T)

    f = {k.name: host(getattr(forcing, k.name))
         for k in dataclasses.fields(forcing)}
    dz = host(grid.cell_thickness)
    kmax = np.ascontiguousarray(
        readback(grid.kmax).cpu().numpy().astype(np.int32))
    bgc = host(state.bgc.tracers)
    dms = host(dms_tracer_block(state))
    surface = dict(SST=f["sst"], SSS=f["sss"], iceFraction=f["ice_fraction"],
                   windSpeedSquared10m=f["wind_speed_squared_10m"],
                   surfacePressure=f["surface_pressure"])
    return {
        "BGC_SourceSink": dict(
            BGC_tracers=bgc, PotentialTemperature=f["potential_temperature"],
            Salinity=f["salinity"],
            cell_center_depth=host(grid.cell_center_depth),
            cell_thickness=dz, cell_bottom_depth=host(grid.cell_bottom_depth),
            cell_latitude=host(grid.latitude), number_of_active_levels=kmax,
            dust_FLUX_IN=f["dust_flux_in"],
            ShortWaveFlux_surface=f["shortwave_surface"],
            FESEDFLUX=f["fesedflux"], NUTR_RESTORE_RTAU=f["nutr_restore_rtau"],
            NO3_CLIM=f["no3_clim"], PO4_CLIM=f["po4_clim"],
            SiO3_CLIM=f["sio3_clim"]),
        "BGC_SurfaceFluxes": dict(
            BGC_tracers=bgc, atmCO2=f["atm_co2"],
            atmCO2_ALT_CO2=f["atm_co2_alt"], surfaceDepth=f["surface_depth"],
            depositionFlux=f["deposition_flux"], riverFlux=f["river_flux"],
            gasFlux=f["gas_flux"], seaIceFlux=f["seaice_flux"], **surface),
        "DMS_SourceSink": dict(
            DMS_tracers=dms, cell_thickness=dz, number_of_active_levels=kmax,
            SST=f["sst"], ShortWaveFlux_surface=f["shortwave_surface"]),
        "DMS_SurfaceFluxes": dict(DMS_tracers=dms, **surface),
        "MACROS_SourceSink": dict(
            MACROS_tracers=host(macros_tracer_block(state)),
            number_of_active_levels=kmax),
    }
