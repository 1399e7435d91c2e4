"""The coupled column model: BGC + DMS + MACROS over one shared tracer state.

Counterpart of ``ocean_bgc_tpu/models/coupled.py``.  ``step(state, grid,
forcing, params, dt, ...)``

1. computes air-sea fluxes (BGC O2/CO2 + DMS), threading the surface-pH
   warm-start state (BGC_mod.F90:2872-2914),
2. evaluates the three source-sink steps — DMS and MACROS read their
   ecosystem driver fields as views of the shared BGC tracer block
   (DMS_parms.F90:63-77, MACROS_parms.F90:62-71),
3. advances tracers forward-Euler, depositing surface fluxes into the top
   active cell.

The port runs the production configuration: ``compute_diags=False``,
with or without the env cache, through ``bgc_source_sink`` (the default
interior, with K1) or, with ``interior_impl="fused"``, through K2, the
whole-interior kernel.  Diagnostics, the health counters, the diagnostic
filter and dtype, and ``run`` (the integration loop with time averaging)
are not ported yet (ROADMAP queue 1 items 9-10) and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ocean_bgc_tpu_torch.ops.bgc import EnvCache, bgc_source_sink
from ocean_bgc_tpu_torch.ops.cuda_step import fused_interior_step
from ocean_bgc_tpu_torch.ops.dms import dms_source_sink
from ocean_bgc_tpu_torch.ops.macros import macros_source_sink
from ocean_bgc_tpu_torch.ops.surface import (
    bgc_surface_fluxes,
    dms_surface_fluxes,
)
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.state import (
    BGCForcing,
    BGCState,
    BGCTracers as BT,
    ColumnGrid,
    DMSTracers as DT,
    MACROSTracers as MT,
)


@dataclasses.dataclass(frozen=True)
class CoupledState:
    """Prognostic state of the coupled model: the 30 BGC tracers with their
    pH warm-start fields, plus DMS/DMSP and PROT/POLY/LIP."""

    bgc: BGCState
    dms: torch.Tensor        # (nlev, 2, ncol): DMS, DMSP
    macros: torch.Tensor     # (nlev, 3, ncol): PROT, POLY, LIP


def dms_tracer_block(state: CoupledState) -> torch.Tensor:
    """Assemble the 14-tracer DMS input block: 2 prognostic sulfur tracers
    + 12 read-only views of the ecosystem state."""
    b = state.bgc.tracers
    rows = [
        state.dms[:, 0], state.dms[:, 1],
        b[:, BT.NO3], b[:, BT.DOC], b[:, BT.ZOOC], b[:, BT.SPC],
        b[:, BT.SPCACO3], b[:, BT.DIATC], b[:, BT.DIAZC], b[:, BT.PHAEOC],
        b[:, BT.SPCHL], b[:, BT.DIATCHL], b[:, BT.DIAZCHL],
        b[:, BT.PHAEOCHL],
    ]
    return torch.stack(rows, dim=1)


def macros_tracer_block(state: CoupledState) -> torch.Tensor:
    """Assemble the 8-tracer MACROS input block."""
    b = state.bgc.tracers
    rows = [
        state.macros[:, 0], state.macros[:, 1], state.macros[:, 2],
        b[:, BT.ZOOC], b[:, BT.SPC], b[:, BT.DIATC], b[:, BT.DIAZC],
        b[:, BT.PHAEOC],
    ]
    return torch.stack(rows, dim=1)


@dataclasses.dataclass(frozen=True)
class CoupledTendencies:
    """Time derivatives of the prognostic fields (surface fluxes already
    deposited into the top active cell), plus the pH warm-start fields
    that the solve updated as a side effect."""

    bgc: torch.Tensor        # (nlev, 30, ncol)
    dms: torch.Tensor        # (nlev, 2, ncol)
    macros: torch.Tensor     # (nlev, 3, ncol)
    ph_prev_3d: torch.Tensor
    ph_prev_alt_3d: torch.Tensor
    surface_ph: torch.Tensor
    surface_ph_alt: torch.Tensor


def _resolve_interior_impl(interior_impl, compute_diags, health):
    """"auto" -> "xla" (``bgc_source_sink``, with K1 on CUDA tensors);
    "fused" takes K2 (``ops/cuda_step.py``) at f64 and f32, with
    diagnostics off and no health counters, as the JAX package's
    ``resolve_interior_impl`` allows it."""
    if interior_impl == "auto":
        return "xla"
    if interior_impl not in ("xla", "fused"):
        raise ValueError(f"unknown interior_impl {interior_impl!r}")
    if interior_impl == "fused" and compute_diags:
        raise ValueError("interior_impl='fused' supports only the "
                         "production configuration (compute_diags=False)")
    if interior_impl == "fused" and health:
        raise ValueError("health=True is not supported with "
                         "interior_impl='fused' (the whole-interior kernel "
                         "does not expose solver residuals)")
    return interior_impl


def _not_ported(compute_diags, diag_dtype, health, diag_filter):
    if compute_diags:
        raise NotImplementedError(
            "compute_diags=True is not ported yet (ROADMAP queue 1 item 9);"
            " pass compute_diags=False")
    if health:
        raise NotImplementedError(
            "health=True is not ported yet (ROADMAP queue 1 item 9)")
    if diag_filter is not None or diag_dtype is not None:
        raise NotImplementedError(
            "diag_filter and diag_dtype are not ported yet (ROADMAP "
            "queue 1 item 9)")


def evaluate_tendencies(
    state: CoupledState,
    grid: ColumnGrid,
    forcing: BGCForcing,
    params: ModelParams,
    *,
    compute_diags: bool = True,
    carbonate_impl: str = "auto",
    interior_impl: str = "auto",
    diag_dtype=None,
    env: EnvCache = None,
    health: bool = False,
    diag_filter=None,
) -> Tuple[CoupledTendencies, Dict[str, torch.Tensor]]:
    """The coupled model's right-hand side: surface fluxes + all three
    source-sink steps.  Returns (tendencies, diagnostics); with
    diagnostics off the dict is empty.  ``carbonate_impl``: "auto" |
    "kernel" | "torch" (see ``ops/cuda_carbonate.py``), for the surface
    pair's pH solve and the default interior's.  ``interior_impl``:
    "auto" | "xla" | "fused" (see :func:`_resolve_interior_impl`); the env
    cache reaches either interior."""
    impl = _resolve_interior_impl(interior_impl, compute_diags, health)
    _not_ported(compute_diags, diag_dtype, health, diag_filter)

    active = grid.active_mask()                       # (nlev, ncol)
    has_ocean = grid.kmax > 0                         # (ncol,)
    top_dzr = 1.0 / grid.cell_thickness[0]            # (ncol,)

    # ---- 1. surface fluxes ----
    sflux = bgc_surface_fluxes(
        state.bgc.tracers, forcing,
        state.bgc.surface_ph, state.bgc.surface_ph_alt, params.bgc,
        carbonate_impl=carbonate_impl)
    dflux = dms_surface_fluxes(
        state.dms[0, 0], forcing.sst, forcing.sss, forcing.ice_fraction,
        forcing.wind_speed_squared_10m, forcing.surface_pressure,
        params.dms)

    # ---- 2. interior tendencies ----
    if impl == "fused":
        bgc_out = fused_interior_step(
            state.bgc.tracers, grid, forcing,
            state.bgc.ph_prev_3d, state.bgc.ph_prev_alt_3d, params.bgc,
            env=env)
    else:
        bgc_out = bgc_source_sink(
            state.bgc.tracers, grid, forcing,
            state.bgc.ph_prev_3d, state.bgc.ph_prev_alt_3d, params.bgc,
            compute_diags=False, carbonate_impl=carbonate_impl, env=env)
    dms_tend, _ = dms_source_sink(
        dms_tracer_block(state), grid.cell_thickness, active,
        forcing.sst, forcing.shortwave_surface, params.dms)
    mac_tend, _ = macros_source_sink(
        macros_tracer_block(state), active, params.macros)

    # ---- 3. deposit surface fluxes into the top active cell ----
    surf_src = torch.where(has_ocean, top_dzr, 0.0)   # (ncol,) 1/cm
    bgc_t = bgc_out.tendencies
    bgc_t[0] += surf_src[None, :] * sflux.net_flux
    dms_t = dms_tend[:, [DT.DMS, DT.DMSP]]
    dms_t[0, 0] += surf_src * dflux.dms_flux
    dms_t[0, 1] += surf_src * dflux.dmsp_flux
    mac_t = mac_tend[:, [MT.PROT, MT.POLY, MT.LIP]]

    tend = CoupledTendencies(
        bgc=bgc_t, dms=dms_t, macros=mac_t,
        ph_prev_3d=bgc_out.ph_prev_3d,
        ph_prev_alt_3d=bgc_out.ph_prev_alt_3d,
        surface_ph=torch.where(has_ocean, sflux.surface_ph,
                               state.bgc.surface_ph),
        surface_ph_alt=torch.where(has_ocean, sflux.surface_ph_alt,
                                   state.bgc.surface_ph_alt),
    )
    return tend, {}


def apply_update(state: CoupledState, tend: CoupledTendencies,
                 dt) -> CoupledState:
    """state + dt * tendency (forward Euler), carrying the pH warm-start
    fields from the given tendency evaluation."""
    return CoupledState(
        bgc=BGCState(
            tracers=state.bgc.tracers + dt * tend.bgc,
            ph_prev_3d=tend.ph_prev_3d,
            ph_prev_alt_3d=tend.ph_prev_alt_3d,
            surface_ph=tend.surface_ph,
            surface_ph_alt=tend.surface_ph_alt,
        ),
        dms=state.dms + dt * tend.dms,
        macros=state.macros + dt * tend.macros,
    )


def step(
    state: CoupledState,
    grid: ColumnGrid,
    forcing: BGCForcing,
    params: ModelParams,
    dt: float,
    *,
    compute_diags: bool = True,
    carbonate_impl: str = "auto",
    interior_impl: str = "auto",
    diag_dtype=None,
    env: EnvCache = None,
    health: bool = False,
    diag_filter=None,
) -> Tuple[CoupledState, Dict[str, torch.Tensor]]:
    """One coupled forward-Euler timestep. Returns (state', diagnostics).

    The production call is ``step(..., compute_diags=False,
    env=precompute_env(grid, forcing, params.bgc))``; the env cache holds
    while the forcing snapshot does.  ``carbonate_impl``: "auto" |
    "kernel" | "torch"; ``interior_impl``: "auto" | "xla" | "fused" (K2,
    one kernel launch for the whole interior)."""
    tend, diags = evaluate_tendencies(state, grid, forcing, params,
                                      compute_diags=compute_diags,
                                      carbonate_impl=carbonate_impl,
                                      interior_impl=interior_impl,
                                      diag_dtype=diag_dtype, env=env,
                                      health=health,
                                      diag_filter=diag_filter)
    return apply_update(state, tend, dt), diags
