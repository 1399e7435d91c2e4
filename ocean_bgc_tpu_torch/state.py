"""Tracer index maps, metadata, and the model's data containers.

The index classes and name tables are a copy of ``ocean_bgc_tpu/state.py``
(the canonical tracer ordering, BGC_parms.F90:81-125, DMS_parms.F90:62-83,
MACROS_parms.F90:62-77).  The containers are frozen dataclasses of torch
tensors with the JAX package's layout:

* per-level fields:   ``(nlev, ncol)``
* tracer blocks:      ``(nlev, ntracer, ncol)``
* per-column fields:  ``(ncol,)``

Columns are the last (fastest) axis, so the 32 threads of a warp that
handle 32 neighbouring columns read 32 neighbouring addresses.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


class BGCTracers:
    """Canonical indices for the 30 BGC tracers (BGC_mod.F90:117-118).

    Slots 0-15 are the non-autotroph pool; 16-29 are the four autotroph
    blocks (Chl, C, Fe[, Si][, CaCO3] per group, BGC_mod.F90:271-321).
    """

    PO4 = 0
    NO3 = 1
    SIO3 = 2
    NH4 = 3
    FE = 4
    O2 = 5
    DIC = 6
    DIC_ALT_CO2 = 7
    ALK = 8
    DOC = 9
    DON = 10
    DOFE = 11
    DOP = 12
    DOPR = 13
    DONR = 14
    ZOOC = 15
    SPCHL = 16
    SPC = 17
    SPFE = 18
    SPCACO3 = 19
    DIATCHL = 20
    DIATC = 21
    DIATFE = 22
    DIATSI = 23
    DIAZCHL = 24
    DIAZC = 25
    DIAZFE = 26
    PHAEOCHL = 27
    PHAEOC = 28
    PHAEOFE = 29

    CNT = 30

    # per-autotroph tracer slots, ordered (sp, diat, diaz, phaeo);
    # None mirrors the reference's Si_ind/CaCO3_ind == 0 sentinel
    CHL_IND = (16, 20, 24, 27)
    C_IND = (17, 21, 25, 28)
    FE_IND = (18, 22, 26, 29)
    SI_IND = (None, 23, None, None)
    CACO3_IND = (19, None, None, None)


class DMSTracers:
    """Canonical indices for the 14 DMS-module tracers (DMS_parms.F90:62-77).

    Only DMS and DMSP are prognostic here; the rest are read-only views of
    ecosystem fields the host (our coupled model) provides.
    """

    DMS = 0
    DMSP = 1
    NO3 = 2
    DOC = 3
    ZOOC = 4
    SPC = 5
    SPCACO3 = 6
    DIATC = 7
    DIAZC = 8
    PHAEOC = 9
    SPCHL = 10
    DIATCHL = 11
    DIAZCHL = 12
    PHAEOCHL = 13

    CNT = 14


class MACROSTracers:
    """Canonical indices for the 8 MACROS-module tracers (MACROS_parms.F90:62-71)."""

    PROT = 0
    POLY = 1
    LIP = 2
    ZOOC = 3
    SPC = 4
    DIATC = 5
    DIAZC = 6
    PHAEOC = 7

    CNT = 8


# ---------------------------------------------------------------------------
# tracer metadata (short name, long name, units) — the registry the
# reference builds in BGC_init/DMS_init/MACROS_init
# ---------------------------------------------------------------------------

BGC_TRACER_NAMES: Tuple[str, ...] = (
    "PO4", "NO3", "SiO3", "NH4", "Fe", "O2", "DIC", "DIC_ALT_CO2", "ALK",
    "DOC", "DON", "DOFe", "DOP", "DOPr", "DONr", "zooC",
    "spChl", "spC", "spFe", "spCaCO3",
    "diatChl", "diatC", "diatFe", "diatSi",
    "diazChl", "diazC", "diazFe",
    "phaeoChl", "phaeoC", "phaeoFe",
)

BGC_TRACER_LONG_NAMES: Tuple[str, ...] = (
    "Dissolved Inorganic Phosphate", "Dissolved Inorganic Nitrate",
    "Dissolved Inorganic Silicate", "Dissolved Ammonia",
    "Dissolved Inorganic Iron", "Dissolved Oxygen",
    "Dissolved Inorganic Carbon",
    "Dissolved Inorganic Carbon, Alternative CO2", "Alkalinity",
    "Dissolved Organic Carbon", "Dissolved Organic Nitrogen",
    "Dissolved Organic Iron", "Dissolved Organic Phosphorus",
    "Refractory DOP", "Refractory DON", "Zooplankton Carbon",
    "Small Phyto Chlorophyll", "Small Phyto Carbon", "Small Phyto Iron",
    "Small Phyto CaCO3",
    "Diatom Chlorophyll", "Diatom Carbon", "Diatom Iron", "Diatom Silicon",
    "Diazotroph Chlorophyll", "Diazotroph Carbon", "Diazotroph Iron",
    "Phaeocystis Chlorophyll", "Phaeocystis Carbon", "Phaeocystis Iron",
)


def bgc_tracer_units() -> Tuple[str, ...]:
    """Units per tracer (BGC_mod.F90:323-328)."""
    units = ["mmol/m^3"] * BGCTracers.CNT
    units[BGCTracers.ALK] = "meq/m^3"
    for chl in BGCTracers.CHL_IND:
        units[chl] = "mg/m^3"
    return tuple(units)


DMS_TRACER_NAMES: Tuple[str, ...] = (
    "DMS", "DMSP", "NO3", "DOC", "zooC", "spC", "spCaCO3", "diatC", "diazC",
    "phaeoC", "spChl", "diatChl", "diazChl", "phaeoChl",
)

# Long names exactly as DMS_init registers them (DMS_mod.F90:101-142),
# including the reference's leading spaces on the phytoplankton-class
# entries — reproduced verbatim so a host diffing metadata against the
# reference sees zero differences.
DMS_TRACER_LONG_NAMES: Tuple[str, ...] = (
    "DiMethyl Sulfide", "Dimethylsulfoniopropionate",
    "Dissolved Inorganic Nitrate", "Dissolved Organic Carbon",
    "Zooplankton Carbon", " Small Phytoplankton Carbon",
    " Small Phytoplankton Calcium Carbonate", " Diatom Carbon",
    " Diazotroph Carbon", "Phaeocystis Carbon",
    " Small Phytoplankton Chlorophyll", " Diatom Chlorophyll",
    " Diazotroph Chlorophyll", "Phaeocystis Chlorophyll",
)

MACROS_TRACER_NAMES: Tuple[str, ...] = (
    "PROT", "POLY", "LIP", "zooC", "spC", "diatC", "diazC", "phaeoC",
)

# MACROS_init long names (MACROS_mod.F90:100-124), same verbatim rule
MACROS_TRACER_LONG_NAMES: Tuple[str, ...] = (
    "Proteins", "Polysaccharides", "Lipids", "Zooplankton Carbon",
    " Small Phytoplankton Carbon", " Diatom Carbon", " Diazotroph Carbon",
    "Phaeocystis Carbon",
)


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ColumnGrid:
    """Static column geometry (BGC_parms.F90:130-136), depths in cm.

    ``kmax`` is the per-column count of active levels (int32);
    contract ``0 <= kmax <= nlev``."""

    cell_center_depth: torch.Tensor   # (nlev, ncol) cm
    cell_thickness: torch.Tensor      # (nlev, ncol) cm
    cell_bottom_depth: torch.Tensor   # (nlev, ncol) cm
    latitude: torch.Tensor            # (ncol,) degrees
    kmax: torch.Tensor                # (ncol,) int32

    @property
    def nlev(self) -> int:
        return self.cell_center_depth.shape[0]

    @property
    def ncol(self) -> int:
        return self.cell_center_depth.shape[-1]

    def active_mask(self) -> torch.Tensor:
        """(nlev, ncol) bool: level k active iff k < kmax(col)."""
        k = torch.arange(self.nlev, dtype=self.kmax.dtype,
                         device=self.kmax.device)[:, None]
        return k < self.kmax[None, :]


@dataclasses.dataclass(frozen=True)
class BGCForcing:
    """Surface and climatological forcing plus hydrography
    (BGC_forcing_type, BGC_parms.F90:139-165).  Flux component arrays are
    (ntracer, ncol)."""

    potential_temperature: torch.Tensor   # (nlev, ncol) C
    salinity: torch.Tensor                # (nlev, ncol) psu
    dust_flux_in: torch.Tensor            # (ncol,)
    shortwave_surface: torch.Tensor       # (ncol,) W/m^2
    surface_pressure: torch.Tensor        # (ncol,) atm
    ice_fraction: torch.Tensor            # (ncol,)
    wind_speed_squared_10m: torch.Tensor  # (ncol,) cm^2/s^2
    atm_co2: torch.Tensor                 # (ncol,) ppmv
    atm_co2_alt: torch.Tensor             # (ncol,) ppmv
    surface_depth: torch.Tensor           # (ncol,) m
    sst: torch.Tensor                     # (ncol,) C
    sss: torch.Tensor                     # (ncol,) psu
    fesedflux: torch.Tensor               # (nlev, ncol)
    nutr_restore_rtau: torch.Tensor       # (nlev, ncol)
    no3_clim: torch.Tensor                # (nlev, ncol)
    po4_clim: torch.Tensor                # (nlev, ncol)
    sio3_clim: torch.Tensor               # (nlev, ncol)
    deposition_flux: torch.Tensor         # (ntracer, ncol)
    river_flux: torch.Tensor              # (ntracer, ncol)
    seaice_flux: torch.Tensor             # (ntracer, ncol)
    gas_flux: torch.Tensor                # (ntracer, ncol)


@dataclasses.dataclass(frozen=True)
class BGCState:
    """Prognostic state: tracers plus the pH warm-start fields carried
    across timesteps (BGC_parms.F90:151-152, 171); pH 0 means "no
    previous solution"."""

    tracers: torch.Tensor          # (nlev, BGCTracers.CNT, ncol)
    ph_prev_3d: torch.Tensor       # (nlev, ncol)
    ph_prev_alt_3d: torch.Tensor   # (nlev, ncol)
    surface_ph: torch.Tensor       # (ncol,)
    surface_ph_alt: torch.Tensor   # (ncol,)

    @property
    def ncol(self) -> int:
        return self.tracers.shape[-1]

    @property
    def nlev(self) -> int:
        return self.tracers.shape[0]


def zeros_state(nlev: int, ncol: int, dtype=torch.float64,
                device=None) -> BGCState:
    """A BGC state of zeros (every pH field the "no previous solution"
    sentinel) on ``device``, CUDA unless the caller passes another."""
    from ocean_bgc_tpu_torch.utils.bridge import resolve_device
    dev = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return BGCState(tracers=z(nlev, BGCTracers.CNT, ncol),
                    ph_prev_3d=z(nlev, ncol), ph_prev_alt_3d=z(nlev, ncol),
                    surface_ph=z(ncol), surface_ph_alt=z(ncol))


def pack_tracers(named: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Stack a {tracer-name: (nlev, ncol)} dict into (nlev, 30, ncol)."""
    return torch.stack([named[n] for n in BGC_TRACER_NAMES], dim=1)


def unpack_tracers(tracers: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Split a (nlev, 30, ncol) block into a {name: (nlev, ncol)} dict."""
    return {n: tracers[:, i] for i, n in enumerate(BGC_TRACER_NAMES)}
