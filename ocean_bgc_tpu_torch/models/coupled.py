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

The default call ``step(state, grid, forcing, params, dt)`` computes the
diagnostics (``compute_diags=True``) without an env cache; the production
call is ``step(..., compute_diags=False, env=precompute_env(...))``.  The
interior is ``bgc_source_sink`` (K1 on CUDA tensors) or, with
``interior_impl="fused"`` and diagnostics off, K2, the whole-interior
kernel.  :func:`run` integrates with time-averaged diagnostics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ocean_bgc_tpu_torch.ops.bgc import (
    EnvCache,
    bgc_source_sink,
    precompute_env,
)
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


# the health counters' names in the diagnostics dict, in StepHealth order
HEALTH_NAMES = ("health_solver_nonconverged_cells", "health_poc_error_cells")


def _resolve_interior_impl(interior_impl, compute_diags, health):
    """"auto" -> "xla" (``bgc_source_sink``, with K1 on CUDA tensors);
    "fused" takes K2 (``ops/cuda_step.py``) at f64 and f32, with
    diagnostics off and no health counters, as the JAX package's
    ``resolve_interior_impl`` allows it; forward-only, as there (K2 raises
    on inputs that require grad)."""
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
    diagnostics off the dict is empty (but for the health counters).

    ``carbonate_impl``: "auto" | "kernel" | "torch" (see
    ``ops/cuda_carbonate.py``), for the surface pair's pH solve and the
    default interior's.  ``interior_impl``: "auto" | "xla" | "fused" (see
    :func:`_resolve_interior_impl`); the env cache reaches either
    interior.

    ``diag_filter``: return exactly these diagnostic names (a KeyError
    names any unknown one; a ValueError without ``compute_diags``).
    ``health``: add ``health_solver_nonconverged_cells`` and
    ``health_poc_error_cells`` (``ops/bgc.py::StepHealth``), also with
    diagnostics off and through any filter.  ``diag_dtype``: the dtype
    the diagnostics are cast to (their arithmetic stays in the state's).
    """
    impl = _resolve_interior_impl(interior_impl, compute_diags, health)
    if diag_filter is not None and not compute_diags:
        # a filter with nothing to filter is a caller's mistake, not a
        # no-op (the JAX package refuses it too)
        raise ValueError(
            "diag_filter requires compute_diags=True (with "
            "compute_diags=False there are no diagnostics to select; "
            "health counters are emitted regardless)")

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
            compute_diags=compute_diags, carbonate_impl=carbonate_impl,
            env=env, health=health)
    dms_tend, dms_diags = dms_source_sink(
        dms_tracer_block(state), grid.cell_thickness, active,
        forcing.sst, forcing.shortwave_surface, params.dms,
        compute_diags=compute_diags)
    mac_tend, mac_diags = macros_source_sink(
        macros_tracer_block(state), active, params.macros,
        compute_diags=compute_diags)

    # ---- 3. deposit surface fluxes into the top active cell ----
    surf_src = torch.where(has_ocean, top_dzr, 0.0)   # (ncol,) 1/cm
    bgc_t = bgc_out.tendencies
    bgc_t[0] += surf_src[None, :] * sflux.net_flux
    # the prognostic tracers' tendencies, gathered by stacking (an index
    # list would be copied from the host, a synchronisation)
    dms_t = torch.stack([dms_tend[:, i] for i in (DT.DMS, DT.DMSP)], dim=1)
    dms_t[0, 0] += surf_src * dflux.dms_flux
    dms_t[0, 1] += surf_src * dflux.dmsp_flux
    mac_t = torch.stack([mac_tend[:, i] for i in (MT.PROT, MT.POLY, MT.LIP)],
                        dim=1)

    tend = CoupledTendencies(
        bgc=bgc_t, dms=dms_t, macros=mac_t,
        ph_prev_3d=bgc_out.ph_prev_3d,
        ph_prev_alt_3d=bgc_out.ph_prev_alt_3d,
        surface_ph=torch.where(has_ocean, sflux.surface_ph,
                               state.bgc.surface_ph),
        surface_ph_alt=torch.where(has_ocean, sflux.surface_ph_alt,
                                   state.bgc.surface_ph_alt),
    )

    diags: Dict[str, torch.Tensor] = {}
    if compute_diags:
        diags.update(bgc_out.diags)
        diags.update({f"DMS_{k}" if not k.startswith("DMS") else k: v
                      for k, v in dms_diags.items()})
        diags.update({f"MACROS_{k}": v for k, v in mac_diags.items()})
        diags.update(sflux.diags)
        diags.update(dflux.diags)
        diags["netFlux"] = sflux.net_flux
        if diag_filter is not None:
            unknown = set(diag_filter) - set(diags) - set(
                HEALTH_NAMES if health else ())
            if unknown:
                raise KeyError(f"unknown diagnostics {sorted(unknown)}; "
                               f"valid names: {sorted(diags)}")
            keep = set(diag_filter)
            diags = {k: v for k, v in diags.items() if k in keep}
        if diag_dtype is not None:
            diags = {k: v.to(diag_dtype) for k, v in diags.items()}
    if health:
        # monitoring, not history: two scalars that survive any filter
        diags.update(zip(HEALTH_NAMES, bgc_out.health))
    return tend, diags


def apply_update(state: CoupledState, tend: CoupledTendencies, dt, *,
                 bgc_incr=None, dms_incr=None,
                 macros_incr=None) -> CoupledState:
    """state + dt * increment, carrying the pH warm-start fields from the
    given tendency evaluation.  The increments default to the tendency
    fields (forward Euler); the integrators (``models/integrators.py``)
    pass combined stage sums."""
    return CoupledState(
        bgc=BGCState(
            tracers=state.bgc.tracers
            + dt * (tend.bgc if bgc_incr is None else bgc_incr),
            ph_prev_3d=tend.ph_prev_3d,
            ph_prev_alt_3d=tend.ph_prev_alt_3d,
            surface_ph=tend.surface_ph,
            surface_ph_alt=tend.surface_ph_alt,
        ),
        dms=state.dms + dt * (tend.dms if dms_incr is None else dms_incr),
        macros=state.macros
        + dt * (tend.macros if macros_incr is None else macros_incr),
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

    The default call computes the diagnostics without an env cache.  The
    production call is ``step(..., compute_diags=False,
    env=precompute_env(grid, forcing, params.bgc))``; the env cache holds
    while the forcing snapshot does.  ``carbonate_impl``: "auto" |
    "kernel" | "torch"; ``interior_impl``: "auto" | "xla" | "fused" (K2);
    ``health``, ``diag_filter``, ``diag_dtype``: see
    :func:`evaluate_tendencies`."""
    tend, diags = evaluate_tendencies(state, grid, forcing, params,
                                      compute_diags=compute_diags,
                                      carbonate_impl=carbonate_impl,
                                      interior_impl=interior_impl,
                                      diag_dtype=diag_dtype, env=env,
                                      health=health,
                                      diag_filter=diag_filter)
    return apply_update(state, tend, dt), diags


def run(
    state: CoupledState,
    grid: ColumnGrid,
    forcing: BGCForcing,
    params: ModelParams,
    dt: float,
    nsteps: int,
    *,
    compute_diags: bool = False,
    tavg_fields=None,
    carbonate_impl: str = "auto",
    interior_impl: str = "auto",
    env_cache: bool = True,
):
    """Integrate ``nsteps`` steps with constant forcing.

    Returns ``(final state, diags)``: the diagnostics of the final step
    (``compute_diags``), from the evaluation that made its update, else an
    empty dict.  ``tavg_fields``: diagnostic names to sum over every step
    (the host model's "tavg" history layer); then returns ``(final state,
    diags, TavgState)``; the steps before the last return only those
    fields (a diagnostics filter).  ``env_cache``: evaluate the
    forcing-invariant tables once (:func:`precompute_env`); False
    re-evaluates them every step.
    """
    from ocean_bgc_tpu_torch.utils.history import TavgState

    track = tuple(tavg_fields) if tavg_fields is not None else ()
    env = precompute_env(grid, forcing, params.bgc) if env_cache else None

    def one_step(s, want_diags, diag_filter=None):
        return step(s, grid, forcing, params, dt, compute_diags=want_diags,
                    carbonate_impl=carbonate_impl,
                    interior_impl=interior_impl, env=env,
                    diag_filter=diag_filter)

    # the final step's diagnostics are kept whole when asked for
    emit_final = compute_diags and nsteps >= 1
    final, tavg = state, None
    diags: Dict[str, torch.Tensor] = {}
    for i in range(nsteps):
        last = emit_final and i == nsteps - 1
        final, d = one_step(final, last or bool(track),
                            None if last or not track else track)
        if track:
            if tavg is None:
                tavg = TavgState.create(d, track)
            tavg = tavg.accumulate(d)
        if last:
            diags = d
    if track:
        if tavg is None:     # no step: zero sums shaped like the fields
            tavg = TavgState.create(one_step(state, True, track)[1], track)
        return final, diags, tavg
    return final, diags
