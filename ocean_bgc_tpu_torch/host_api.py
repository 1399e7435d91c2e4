"""The host-coupling API: the reference's nine public entry points.

Counterpart of ``ocean_bgc_tpu/host_api.py``.  A host ocean model coupled
to the reference library calls (SURVEY.md §0)::

    BGC_parms_init / BGC_init          DMS_parms_init / DMS_init
    MACROS_parms_init / MACROS_init
    BGC_SourceSink   BGC_SurfaceFluxes
    DMS_SourceSink   DMS_SurfaceFluxes
    MACROS_SourceSink

This module exposes the same operations with host-friendly conventions:
NumPy arrays in the host's column-major layout ``(column, level[,
tracer])``, tracer columns in the canonical order of
``state.BGCTracers`` / ``DMSTracers`` / ``MACROSTracers``, float64
whatever type the host passes.  State that the reference carries in its
argument structs (the pH warm starts) is passed in and returned.  Results
are the JAX package's dicts, with the same keys and layouts.

Each entry point is three parts (:data:`PARTS`, for callers that time
them apart):

- **ingest**: host layout to level-major through ``io.host_layout`` (the
  native C++ packer, or its NumPy path), then, on CUDA, staged in pinned
  memory and copied to the card without blocking, as
  ``models/chunked.py`` stages its chunks;
- **compute**: a plain function on tensors, the port's
  ``bgc_source_sink`` (diagnostics on, no env cache: on the card K1's
  constants kernel, then its dual instance), ``bgc_surface_fluxes`` (the
  surface pair on K1's bracket-in instance), ``dms_source_sink``,
  ``dms_surface_fluxes`` and ``macros_source_sink``;
- **egress**: the results copied back into pinned host memory (one
  synchronisation per call) and to the host layout.

Every layout change is an exact transpose, so an entry point returns
bitwise what its compute function gives on the same level-major tensors.
Each takes ``device``: CUDA unless the caller passes another (``"cpu"``
runs every kernel's plain version).

**Tracer order: canonical inside, host-configurable at the boundary.**
The reference lets the host assign tracer indices into its
``*_indices_type`` structs at init (BGC_parms.F90:81-125).  Every entry
point takes an optional ``indices`` mapping (canonical short name ->
0-based position in the host's tracer axis); arrays are permuted
host->canonical once on ingest and canonical->host once on egress, and
the mapping is validated as a complete bijection, so a wrong or partial
host order is an error, never silent wrong physics.  Without ``indices``
the host stores tracers in canonical order (``bgc_init().short_name``).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ocean_bgc_tpu_torch.io import host_layout as hl
from ocean_bgc_tpu_torch.ops.bgc import BGCSourceSinkOut, bgc_source_sink
from ocean_bgc_tpu_torch.ops.dms import dms_source_sink
from ocean_bgc_tpu_torch.ops.macros import macros_source_sink
from ocean_bgc_tpu_torch.ops.surface import (
    bgc_surface_fluxes,
    dms_surface_fluxes,
)
from ocean_bgc_tpu_torch.params import BGCParams, DMSParams, MACROSParams
from ocean_bgc_tpu_torch.state import (
    BGC_TRACER_LONG_NAMES,
    BGC_TRACER_NAMES,
    DMS_TRACER_LONG_NAMES,
    DMS_TRACER_NAMES,
    MACROS_TRACER_LONG_NAMES,
    MACROS_TRACER_NAMES,
    BGCForcing,
    BGCTracers,
    ColumnGrid,
    bgc_tracer_units,
)
from ocean_bgc_tpu_torch.utils.bridge import resolve_device

BGC_tracer_cnt = BGCTracers.CNT        # 30 (BGC_mod.F90:117-118)
DMS_tracer_cnt = 14                    # DMS_mod.F90:61-62
MACROS_tracer_cnt = 8                  # MACROS_mod.F90:60-61

_F64 = torch.float64


class TracerMetadata(NamedTuple):
    short_name: Tuple[str, ...]
    long_name: Tuple[str, ...]
    units: Tuple[str, ...]


def tracer_permutation(indices, names) -> np.ndarray:
    """Validate a host tracer-index mapping and return the ingest
    permutation.

    ``indices`` maps each canonical short name in ``names`` to its
    0-based position in the host's tracer axis, the analogue of the host
    filling ``BGC_indices_type`` / ``DMS_indices_type`` /
    ``MACROS_indices_type`` at init (BGC_parms.F90:81-125,
    DMS_parms.F90:62-83, MACROS_parms.F90:62-77).  The mapping must be a
    complete bijection: every canonical tracer named exactly once,
    positions a permutation of ``range(len(names))``.  Returns ``perm``
    with ``canonical[..., c] == host[..., perm[c]]``; ``np.argsort(perm)``
    inverts it for egress.
    """
    names = tuple(names)
    extra = set(indices) - set(names)
    missing = set(names) - set(indices)
    if extra or missing:
        raise ValueError(
            f"tracer index map must cover exactly the canonical set: "
            f"missing={sorted(missing)} unknown={sorted(extra)}")
    perm = np.asarray([int(indices[n]) for n in names])
    if sorted(perm.tolist()) != list(range(len(names))):
        raise ValueError(
            f"tracer index positions must be a permutation of "
            f"0..{len(names) - 1}, got {perm.tolist()}")
    return perm


def _ingest_perm(indices, names):
    """(perm, inverse-perm) or (None, None) when no mapping is given."""
    if indices is None:
        return None, None
    perm = tracer_permutation(indices, names)
    return perm, np.argsort(perm)


def bgc_parms_init(**overrides) -> BGCParams:
    """Default parameter set (BGC_parms_init, BGC_parms.F90:497-699)."""
    return BGCParams(**overrides)


def bgc_init() -> TracerMetadata:
    """Tracer metadata registration (BGC_init, BGC_mod.F90:184-333)."""
    return TracerMetadata(BGC_TRACER_NAMES, BGC_TRACER_LONG_NAMES,
                          bgc_tracer_units())


def dms_parms_init(**overrides) -> DMSParams:
    return DMSParams(**overrides)


def dms_init() -> TracerMetadata:
    """Sulfur-tracer metadata registration (DMS_init,
    DMS_mod.F90:101-144): the reference's long names verbatim and its
    blanket 'mmol/m^3' units (DMS_mod.F90:144)."""
    return TracerMetadata(DMS_TRACER_NAMES, DMS_TRACER_LONG_NAMES,
                          ("mmol/m^3",) * DMS_tracer_cnt)


def macros_parms_init(**overrides) -> MACROSParams:
    return MACROSParams(**overrides)


def macros_init() -> TracerMetadata:
    """Macromolecule-tracer metadata registration (MACROS_init,
    MACROS_mod.F90:100-126; blanket units MACROS_mod.F90:126)."""
    return TracerMetadata(MACROS_TRACER_NAMES, MACROS_TRACER_LONG_NAMES,
                          ("mmol/m^3",) * MACROS_tracer_cnt)


# ---------------------------------------------------------------------------
# marshaling
# ---------------------------------------------------------------------------

def _put(a: np.ndarray, dev: torch.device, dtype=_F64) -> torch.Tensor:
    """A host array as a ``dtype`` tensor on ``dev`` (a copy): on CUDA
    staged in pinned memory and copied without blocking."""
    src = torch.from_numpy(np.ascontiguousarray(a))
    buf = torch.empty(src.shape, dtype=dtype, pin_memory=dev.type == "cuda")
    buf.copy_(src)
    return buf.to(dev, non_blocking=True) if dev.type == "cuda" else buf


def _level_major(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host ``(ncol, nlev)`` field as an ``(nlev, ncol)`` f64 tensor."""
    return _put(hl.to_level_major(a), dev)


def _tracer_block(a: np.ndarray, perm, dev: torch.device) -> torch.Tensor:
    """A host ``(ncol, nlev, ntracer)`` block, in canonical tracer order,
    as an ``(nlev, ntracer, ncol)`` f64 tensor (f32 widened)."""
    if perm is not None:
        a = a[..., perm]
    return _put(hl.pack_tracer_block(a), dev)


def _to_host(tensors: Sequence[torch.Tensor]):
    """NumPy copies of ``tensors``: on CUDA every copy queued into pinned
    memory, then one wait for the stream."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.numpy().copy() for t in tensors]
    bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for b, t in zip(bufs, tensors):
        b.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [b.numpy() for b in bufs]


def _host_tracers(block: np.ndarray, inv) -> np.ndarray:
    """A level-major ``(nlev, ntracer, ncol)`` block in the host's layout
    and tracer order."""
    out = hl.unpack_tracer_block(block)
    return out if inv is None else np.ascontiguousarray(out[..., inv])


def _active(kmax: torch.Tensor, nlev: int) -> torch.Tensor:
    """(nlev, ncol) bool: level k active iff k < kmax(col)."""
    k = torch.arange(nlev, dtype=kmax.dtype, device=kmax.device)[:, None]
    return k < kmax[None, :]


# ---------------------------------------------------------------------------
# the entry points' parts
# ---------------------------------------------------------------------------

def _bgc_ss_ingest(dev, perm, *, BGC_tracers, PotentialTemperature,
                   Salinity, cell_center_depth, cell_thickness,
                   cell_bottom_depth, cell_latitude, number_of_active_levels,
                   dust_FLUX_IN, ShortWaveFlux_surface, FESEDFLUX=None,
                   NUTR_RESTORE_RTAU=None, NO3_CLIM=None, PO4_CLIM=None,
                   SiO3_CLIM=None, PH_PREV_3D=None, PH_PREV_ALT_CO2_3D=None):
    """``(tracers, grid, forcing, ph_prev_3d, ph_prev_alt_3d)``,
    level-major; fields the host omits are zeros (the pH fields' "no
    previous solution")."""
    ncol, nlev = PotentialTemperature.shape

    def col(a):
        return _put(a, dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=_F64, device=dev)

    def lm(a):
        return _level_major(a, dev) if a is not None else zeros(nlev, ncol)

    grid = ColumnGrid(
        cell_center_depth=lm(cell_center_depth),
        cell_thickness=lm(cell_thickness),
        cell_bottom_depth=lm(cell_bottom_depth),
        latitude=col(cell_latitude),
        kmax=_put(number_of_active_levels, dev, torch.int32))
    forcing = BGCForcing(
        potential_temperature=lm(PotentialTemperature),
        salinity=lm(Salinity),
        dust_flux_in=col(dust_FLUX_IN),
        shortwave_surface=col(ShortWaveFlux_surface),
        surface_pressure=torch.ones(ncol, dtype=_F64, device=dev),
        ice_fraction=zeros(ncol), wind_speed_squared_10m=zeros(ncol),
        atm_co2=zeros(ncol), atm_co2_alt=zeros(ncol),
        surface_depth=zeros(ncol), sst=zeros(ncol), sss=zeros(ncol),
        fesedflux=lm(FESEDFLUX), nutr_restore_rtau=lm(NUTR_RESTORE_RTAU),
        no3_clim=lm(NO3_CLIM), po4_clim=lm(PO4_CLIM),
        sio3_clim=lm(SiO3_CLIM),
        deposition_flux=zeros(BGC_tracer_cnt, ncol),
        river_flux=zeros(BGC_tracer_cnt, ncol),
        seaice_flux=zeros(BGC_tracer_cnt, ncol),
        gas_flux=zeros(BGC_tracer_cnt, ncol))
    return (_tracer_block(BGC_tracers, perm, dev), grid, forcing,
            lm(PH_PREV_3D), lm(PH_PREV_ALT_CO2_3D))


def _bgc_ss_compute(ins, params: BGCParams,
                    diag_names=None) -> BGCSourceSinkOut:
    """The interior with every diagnostic and no env cache (JAX's
    ``_bgc_ss_jit``), then the requested diagnostics."""
    out = bgc_source_sink(*ins, params, compute_diags=True, env=None)
    if diag_names is None:
        return out
    unknown = set(diag_names) - set(out.diags)
    if unknown:
        raise KeyError(f"unknown diagnostics {sorted(unknown)}; valid names: "
                       f"{sorted(out.diags)}")
    return out._replace(diags={k: out.diags[k] for k in diag_names})


def _bgc_ss_egress(out: BGCSourceSinkOut, inv) -> Dict[str, np.ndarray]:
    tend, ph, ph_alt, *diags = _to_host(
        [out.tendencies, out.ph_prev_3d, out.ph_prev_alt_3d,
         *out.diags.values()])
    return {
        "BGC_tendencies": _host_tracers(tend, inv),
        "PH_PREV_3D": hl.from_level_major(ph),
        "PH_PREV_ALT_CO2_3D": hl.from_level_major(ph_alt),
        "diags": dict(zip(out.diags, diags)),
    }


def _bgc_sf_ingest(dev, perm, *, BGC_tracers, SST, SSS, surfacePressure,
                   iceFraction, windSpeedSquared10m, atmCO2, atmCO2_ALT_CO2,
                   surfaceDepth, surface_pH=None, surface_pH_alt_co2=None,
                   depositionFlux=None, riverFlux=None, gasFlux=None,
                   seaIceFlux=None):
    """``(tracers, forcing, surface_ph, surface_ph_alt)``.  Only the top
    level of the tracer block crosses, as a one-level block
    (``bgc_surface_fluxes`` reads no other)."""
    ncol = BGC_tracers.shape[0]

    def zeros(*shape):
        return torch.zeros(shape, dtype=_F64, device=dev)

    def col(a):
        return _put(a, dev) if a is not None else zeros(ncol)

    def flux(a):        # (ncol, 30) host -> (30, ncol), canonical order
        if a is None:
            return zeros(BGC_tracer_cnt, ncol)
        return _put((a if perm is None else a[..., perm]).T, dev)

    forcing = BGCForcing(
        potential_temperature=zeros(1, ncol), salinity=zeros(1, ncol),
        dust_flux_in=zeros(ncol), shortwave_surface=zeros(ncol),
        surface_pressure=col(surfacePressure), ice_fraction=col(iceFraction),
        wind_speed_squared_10m=col(windSpeedSquared10m),
        atm_co2=col(atmCO2), atm_co2_alt=col(atmCO2_ALT_CO2),
        surface_depth=col(surfaceDepth), sst=col(SST), sss=col(SSS),
        fesedflux=zeros(1, ncol), nutr_restore_rtau=zeros(1, ncol),
        no3_clim=zeros(1, ncol), po4_clim=zeros(1, ncol),
        sio3_clim=zeros(1, ncol),
        deposition_flux=flux(depositionFlux), river_flux=flux(riverFlux),
        seaice_flux=flux(seaIceFlux), gas_flux=flux(gasFlux))
    return (_tracer_block(BGC_tracers[:, :1], perm, dev), forcing,
            col(surface_pH), col(surface_pH_alt_co2))


def _bgc_sf_egress(out, inv) -> Dict[str, np.ndarray]:
    net, ph, ph_alt, *diags = _to_host(
        [out.net_flux, out.surface_ph, out.surface_ph_alt,
         *out.diags.values()])
    net = np.ascontiguousarray(net.T)
    return {
        "netFlux": net if inv is None else np.ascontiguousarray(
            net[..., inv]),
        "surface_pH": ph,
        "surface_pH_alt_co2": ph_alt,
        "diags": dict(zip(out.diags, diags)),
    }


def _dms_ss_ingest(dev, perm, *, DMS_tracers, cell_thickness,
                   number_of_active_levels, SST, ShortWaveFlux_surface):
    """The arguments of ``dms_source_sink`` before its parameters."""
    kmax = _put(number_of_active_levels, dev, torch.int32)
    return (_tracer_block(DMS_tracers, perm, dev),
            _level_major(cell_thickness, dev),
            _active(kmax, DMS_tracers.shape[1]), _put(SST, dev),
            _put(ShortWaveFlux_surface, dev))


def _tendency_egress(name: str):
    """The egress of a source-sink ``(tendencies, diags)`` pair whose
    block is returned as ``name``."""
    def egress(out, inv) -> Dict[str, np.ndarray]:
        tend, diags = out
        tend, *vals = _to_host([tend, *diags.values()])
        return {name: _host_tracers(tend, inv),
                "diags": dict(zip(diags, vals))}
    return egress


def _dms_sf_ingest(dev, perm, *, DMS_tracers, SST, SSS, iceFraction,
                   windSpeedSquared10m, surfacePressure):
    """The arguments of ``dms_surface_fluxes`` before its parameters (the
    surface DMS only)."""
    dms_pos = int(perm[0]) if perm is not None else 0  # canonical 0 = DMS
    return tuple(_put(a, dev) for a in (
        DMS_tracers[:, 0, dms_pos], SST, SSS, iceFraction,
        windSpeedSquared10m, surfacePressure))


def _dms_sf_egress(out, inv) -> Dict[str, np.ndarray]:
    dms, dmsp, *vals = _to_host([out.dms_flux, out.dmsp_flux,
                                 *out.diags.values()])
    return {"netFlux_dms": dms, "netFlux_dmsp": dmsp,
            "diags": dict(zip(out.diags, vals))}


def _macros_ss_ingest(dev, perm, *, MACROS_tracers, number_of_active_levels):
    """The arguments of ``macros_source_sink`` before its parameters."""
    kmax = _put(number_of_active_levels, dev, torch.int32)
    return (_tracer_block(MACROS_tracers, perm, dev),
            _active(kmax, MACROS_tracers.shape[1]))


class Parts(NamedTuple):
    """An entry point's three parts: ``ingest(device, perm, **host
    arrays)`` -> tensors on the device; ``compute(tensors, params,
    **options)`` -> its results there; ``egress(results, inverse perm)``
    -> the returned dict.  ``names``: the canonical tracer names its
    ``indices`` map covers."""
    ingest: Callable
    compute: Callable
    egress: Callable
    names: Tuple[str, ...]


PARTS: Dict[str, Parts] = {
    "BGC_SourceSink": Parts(_bgc_ss_ingest, _bgc_ss_compute, _bgc_ss_egress,
                            BGC_TRACER_NAMES),
    "BGC_SurfaceFluxes": Parts(
        _bgc_sf_ingest, lambda ins, p: bgc_surface_fluxes(*ins, p),
        _bgc_sf_egress, BGC_TRACER_NAMES),
    "DMS_SourceSink": Parts(
        _dms_ss_ingest, lambda ins, p: dms_source_sink(*ins, p),
        _tendency_egress("DMS_tendencies"), DMS_TRACER_NAMES),
    "DMS_SurfaceFluxes": Parts(
        _dms_sf_ingest, lambda ins, p: dms_surface_fluxes(*ins, p),
        _dms_sf_egress, DMS_TRACER_NAMES),
    "MACROS_SourceSink": Parts(
        _macros_ss_ingest, lambda ins, p: macros_source_sink(*ins, p),
        _tendency_egress("MACROS_tendencies"), MACROS_TRACER_NAMES),
}


def _run(name, host, params, indices, device, **options):
    """Entry point ``name`` on the ``host`` arrays: ingest, compute,
    egress."""
    parts = PARTS[name]
    perm, inv = _ingest_perm(indices, parts.names)
    ins = parts.ingest(resolve_device(device), perm, **host)
    return parts.egress(parts.compute(ins, params, **options), inv)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def BGC_SourceSink(
    *,
    BGC_tracers: np.ndarray,            # (ncol, nlev, 30) host layout
    PotentialTemperature: np.ndarray,   # (ncol, nlev)
    Salinity: np.ndarray,               # (ncol, nlev)
    cell_center_depth: np.ndarray,      # (ncol, nlev) cm
    cell_thickness: np.ndarray,         # (ncol, nlev) cm
    cell_bottom_depth: np.ndarray,      # (ncol, nlev) cm
    cell_latitude: np.ndarray,          # (ncol,)
    number_of_active_levels: np.ndarray,  # (ncol,)
    dust_FLUX_IN: np.ndarray,           # (ncol,)
    ShortWaveFlux_surface: np.ndarray,  # (ncol,)
    FESEDFLUX: Optional[np.ndarray] = None,        # (ncol, nlev)
    NUTR_RESTORE_RTAU: Optional[np.ndarray] = None,
    NO3_CLIM: Optional[np.ndarray] = None,
    PO4_CLIM: Optional[np.ndarray] = None,
    SiO3_CLIM: Optional[np.ndarray] = None,
    PH_PREV_3D: Optional[np.ndarray] = None,       # (ncol, nlev)
    PH_PREV_ALT_CO2_3D: Optional[np.ndarray] = None,
    params: Optional[BGCParams] = None,
    indices: Optional[Dict[str, int]] = None,
    diag_names: Optional[Tuple[str, ...]] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Ecosystem tendencies (BGC_SourceSink, BGC_mod.F90:340-1998).

    Returns {"BGC_tendencies": (ncol, nlev, 30), "PH_PREV_3D": (ncol,
    nlev), "PH_PREV_ALT_CO2_3D": ..., "diags": {name: (nlev, ncol) or
    (ncol,)}}.  ``indices``: optional host tracer-order map (see the
    module's docstring); tendencies come back in the host's order.
    Without ``PH_PREV_*`` every cell solves its pH from the cold window.

    ``diag_names``: return only these diagnostics (KeyError for a name
    the step does not emit).  The step computes every diagnostic and then
    drops the rest: eager PyTorch has no dead-code elimination, so the
    kept values are bitwise the full run's and the filter saves only the
    copies back to the host.
    """
    host = dict(
        BGC_tracers=BGC_tracers, PotentialTemperature=PotentialTemperature,
        Salinity=Salinity, cell_center_depth=cell_center_depth,
        cell_thickness=cell_thickness, cell_bottom_depth=cell_bottom_depth,
        cell_latitude=cell_latitude,
        number_of_active_levels=number_of_active_levels,
        dust_FLUX_IN=dust_FLUX_IN,
        ShortWaveFlux_surface=ShortWaveFlux_surface, FESEDFLUX=FESEDFLUX,
        NUTR_RESTORE_RTAU=NUTR_RESTORE_RTAU, NO3_CLIM=NO3_CLIM,
        PO4_CLIM=PO4_CLIM, SiO3_CLIM=SiO3_CLIM, PH_PREV_3D=PH_PREV_3D,
        PH_PREV_ALT_CO2_3D=PH_PREV_ALT_CO2_3D)
    return _run("BGC_SourceSink", host, params or BGCParams(), indices,
                device, diag_names=(tuple(diag_names)
                                    if diag_names is not None else None))


def BGC_SurfaceFluxes(
    *,
    BGC_tracers: np.ndarray,            # (ncol, nlev, 30)
    SST: np.ndarray, SSS: np.ndarray,
    surfacePressure: np.ndarray, iceFraction: np.ndarray,
    windSpeedSquared10m: np.ndarray,
    atmCO2: np.ndarray, atmCO2_ALT_CO2: np.ndarray,
    surfaceDepth: np.ndarray,
    surface_pH: Optional[np.ndarray] = None,
    surface_pH_alt_co2: Optional[np.ndarray] = None,
    depositionFlux: Optional[np.ndarray] = None,   # (ncol, 30)
    riverFlux: Optional[np.ndarray] = None,
    gasFlux: Optional[np.ndarray] = None,
    seaIceFlux: Optional[np.ndarray] = None,
    params: Optional[BGCParams] = None,
    indices: Optional[Dict[str, int]] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Air-sea fluxes (BGC_SurfaceFluxes, BGC_mod.F90:2706-2957).
    Returns {"netFlux": (ncol, 30), "surface_pH": (ncol,),
    "surface_pH_alt_co2": ..., "diags": ...}; per-tracer inputs and
    netFlux follow ``indices`` when given.  Without ``surface_pH*`` the
    surface pair solves from the cold window."""
    host = dict(
        BGC_tracers=BGC_tracers, SST=SST, SSS=SSS,
        surfacePressure=surfacePressure, iceFraction=iceFraction,
        windSpeedSquared10m=windSpeedSquared10m, atmCO2=atmCO2,
        atmCO2_ALT_CO2=atmCO2_ALT_CO2, surfaceDepth=surfaceDepth,
        surface_pH=surface_pH, surface_pH_alt_co2=surface_pH_alt_co2,
        depositionFlux=depositionFlux, riverFlux=riverFlux, gasFlux=gasFlux,
        seaIceFlux=seaIceFlux)
    return _run("BGC_SurfaceFluxes", host, params or BGCParams(), indices,
                device)


def DMS_SourceSink(
    *,
    DMS_tracers: np.ndarray,          # (ncol, nlev, 14)
    cell_thickness: np.ndarray,       # (ncol, nlev) cm
    number_of_active_levels: np.ndarray,
    SST: np.ndarray,
    ShortWaveFlux_surface: np.ndarray,
    params: Optional[DMSParams] = None,
    indices: Optional[Dict[str, int]] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Sulfur-cycle tendencies (DMS_SourceSink, DMS_mod.F90:156-770).
    Returns {"DMS_tendencies": (ncol, nlev, 14), "diags": ...}."""
    host = dict(DMS_tracers=DMS_tracers, cell_thickness=cell_thickness,
                number_of_active_levels=number_of_active_levels, SST=SST,
                ShortWaveFlux_surface=ShortWaveFlux_surface)
    return _run("DMS_SourceSink", host, params or DMSParams(), indices,
                device)


def DMS_SurfaceFluxes(
    *,
    DMS_tracers: np.ndarray,          # (ncol, nlev, 14)
    SST: np.ndarray, SSS: np.ndarray,
    iceFraction: np.ndarray, windSpeedSquared10m: np.ndarray,
    surfacePressure: np.ndarray,
    params: Optional[DMSParams] = None,
    indices: Optional[Dict[str, int]] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """DMS gas flux (DMS_SurfaceFluxes, DMS_mod.F90:778-908).  Returns
    the netFlux rows of DMS and DMSP, (ncol,) each, and the 8 flux
    diagnostics."""
    host = dict(DMS_tracers=DMS_tracers, SST=SST, SSS=SSS,
                iceFraction=iceFraction,
                windSpeedSquared10m=windSpeedSquared10m,
                surfacePressure=surfacePressure)
    return _run("DMS_SurfaceFluxes", host, params or DMSParams(), indices,
                device)


def MACROS_SourceSink(
    *,
    MACROS_tracers: np.ndarray,       # (ncol, nlev, 8)
    number_of_active_levels: np.ndarray,
    params: Optional[MACROSParams] = None,
    indices: Optional[Dict[str, int]] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Macromolecule tendencies (MACROS_SourceSink,
    MACROS_mod.F90:137-411).  Returns {"MACROS_tendencies": (ncol, nlev,
    8), "diags": ...}."""
    host = dict(MACROS_tracers=MACROS_tracers,
                number_of_active_levels=number_of_active_levels)
    return _run("MACROS_SourceSink", host, params or MACROSParams(), indices,
                device)
