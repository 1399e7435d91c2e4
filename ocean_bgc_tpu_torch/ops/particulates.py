"""Armstrong-ballast sinking-particle scheme.

Counterpart of ``ocean_bgc_tpu/ops/particulates.py``
(``init_particulate_terms`` / ``compute_particulate_terms``,
BGC_mod.F90:2006-2699).  Five particle classes (POC, CaCO3, SiO2, dust,
Fe) carry soft/hard sinking fluxes downward; remineralization comes from
flux conservation across each cell; the bottom cell computes burial,
sedimentary denitrification and non-oxic remineralization, with the
3300 m lysocline rule for CaCO3.

The downward coupling is a Python loop over levels in
``ops/bgc.py::bgc_source_sink``, threading a :class:`ParticleCarry` of
``(ncol,)`` tensors through :func:`particulate_level_update`; the
bottom-cell branch is a per-lane ``is_bottom`` mask.
:func:`particulate_diags` gives the per-level diagnostics.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ocean_bgc_tpu_torch.constants import (
    DECAY_HARD_DUST_SCALE,
    DECAY_HARD_SCALE,
    DENITRIF_C_N,
    DUST_DISS,
    DUST_GAMMA,
    DUST_MASS,
    DUST_TO_FE,
    FE_SFLUX_REMIN_RATE,
    LYSOCLINE_DEPTH,
    MPERCM,
    P_CACO3_GAMMA,
    P_CACO3_MASS,
    P_SIO2_GAMMA,
    P_SIO2_MASS,
    PARM_RED_FE_C,
    POC_MASS,
    Q,
    QP_ZOO_POM,
    SPD,
    TFUNCS_Q10,
    TREF,
)
from ocean_bgc_tpu_torch.ops.numerics import exp, fill_like, pow, safe_div
from ocean_bgc_tpu_torch.params import BGCParams

# QA mass ratios (rho = 0.05 * mass / POC mass, BGC_mod.F90:2054-2064)
RHO_CACO3 = 0.05 * P_CACO3_MASS / POC_MASS
RHO_SIO2 = 0.05 * P_SIO2_MASS / POC_MASS
RHO_DUST = 0.05 * DUST_MASS / POC_MASS


class ParticleCarry(NamedTuple):
    """Downward-sinking state entering a level: the outgoing fluxes of the
    level above (base units/cm^2/s) plus the QA dust deficit."""

    poc_s: torch.Tensor
    poc_h: torch.Tensor
    caco3_s: torch.Tensor
    caco3_h: torch.Tensor
    sio2_s: torch.Tensor
    sio2_h: torch.Tensor
    dust_s: torch.Tensor
    dust_h: torch.Tensor
    fe_s: torch.Tensor
    fe_h: torch.Tensor
    qa_dust_def: torch.Tensor


class ParticleProdOut(NamedTuple):
    """The per-level particulate results the diags-off tendency assembly
    reads; the recurrence stacks only these over levels."""

    poc_remin: torch.Tensor
    caco3_remin: torch.Tensor
    sio2_remin: torch.Tensor
    fe_remin: torch.Tensor
    sed_denitrif: torch.Tensor
    other_remin: torch.Tensor


class ParticleLevelOut(NamedTuple):
    """Per-level results of one level of the recurrence."""

    poc_remin: torch.Tensor
    caco3_remin: torch.Tensor
    sio2_remin: torch.Tensor
    dust_remin: torch.Tensor
    fe_remin: torch.Tensor
    poc_sed_loss: torch.Tensor
    caco3_sed_loss: torch.Tensor
    sio2_sed_loss: torch.Tensor
    dust_sed_loss: torch.Tensor
    fe_sed_loss: torch.Tensor
    sed_denitrif: torch.Tensor
    other_remin: torch.Tensor


def init_particle_carry(dust_flux_in: torch.Tensor) -> ParticleCarry:
    """Surface initialization (init_particulate_terms,
    BGC_mod.F90:2072-2104): all fluxes zero except the dust flux split
    into soft/hard by gamma, and the initial QA dust deficit."""
    zero = torch.zeros_like(dust_flux_in)
    nz = dust_flux_in != 0.0
    dust_s = torch.where(nz, (1.0 - DUST_GAMMA) * dust_flux_in, 0.0)
    dust_h = torch.where(nz, DUST_GAMMA * dust_flux_in, 0.0)
    return ParticleCarry(
        poc_s=zero, poc_h=zero, caco3_s=zero, caco3_h=zero,
        sio2_s=zero, sio2_h=zero, dust_s=dust_s, dust_h=dust_h,
        fe_s=zero, fe_h=zero,
        qa_dust_def=RHO_DUST * (dust_s + dust_h))


def _scalelength(cell_bottom_depth, params: BGCParams):
    """Piecewise-linear dissolution scale-length profile
    (BGC_mod.F90:2273-2286): clamped linear interpolation on the 4-knot
    (parm_scalelen_z, parm_scalelen_vals) table, in the arithmetic of
    ``jnp.interp``."""
    x = cell_bottom_depth
    n = len(params.parm_scalelen_z)
    values = (*params.parm_scalelen_z, *params.parm_scalelen_vals)
    if any(torch.is_tensor(v) for v in values):
        # a knot under calibration: stacked, so that its gradient flows
        knots = torch.stack([fill_like(x, v) for v in values])
    else:
        # one copy of both tables, from pinned memory on the card: a copy
        # from pageable memory would synchronise with the host
        knots = torch.tensor(values, dtype=x.dtype, pin_memory=x.is_cuda)
        knots = knots.to(x.device, non_blocking=True)
    xp, fp = knots[:n], knots[n:]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    f = fp[i - 1] + (delta / dx) * df
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class DissolutionCache(NamedTuple):
    """The (T, grid)-dependent dissolution factors of the sinking scheme
    (BGC_mod.F90:2288-2338), invariant while the forcing snapshot is
    held; the POC dissolution length depends on O2 and is not here."""

    scalelength: torch.Tensor
    decay_hard: torch.Tensor
    decay_hard_dust: torch.Tensor
    decay_caco3: torch.Tensor
    caco3_diss: torch.Tensor
    decay_sio2: torch.Tensor
    sio2_diss: torch.Tensor
    decay_dust: torch.Tensor


def precompute_dissolution(temp, cell_thickness, cell_bottom_depth,
                           params: BGCParams) -> DissolutionCache:
    """Evaluate the forcing-invariant dissolution factors, with exactly
    the expressions :func:`particulate_level_update` uses in-step."""
    dz = cell_thickness
    scalelength = _scalelength(cell_bottom_depth, params)
    tfuncs = pow(TFUNCS_Q10, (temp - TREF) / 10.0)
    sio2_diss = scalelength * params.parm_SiO2_diss / tfuncs
    caco3_diss = scalelength * params.parm_CaCO3_diss
    dust_diss = scalelength * DUST_DISS
    return DissolutionCache(
        scalelength=scalelength,
        decay_hard=exp(-dz / DECAY_HARD_SCALE),
        decay_hard_dust=exp(-dz / DECAY_HARD_DUST_SCALE),
        decay_caco3=exp(-dz / caco3_diss), caco3_diss=caco3_diss,
        decay_sio2=exp(-dz / sio2_diss), sio2_diss=sio2_diss,
        decay_dust=exp(-dz / dust_diss))


def particulate_level_update(
    carry: ParticleCarry,
    poc_prod, caco3_prod, sio2_prod, fe_prod,   # (ncol,) production terms
    temp, o2_loc, no3_loc,                      # (ncol,) environment
    cell_thickness, cell_bottom_depth,          # (ncol,) cm
    fesedflux,                                  # (ncol,)
    is_bottom,                                  # (ncol,) bool: k == kmax-1
    active,                                     # (ncol,) bool: k < kmax
    params: BGCParams,
    *,
    diss: DissolutionCache = None,
) -> Tuple[ParticleCarry, ParticleLevelOut]:
    """One level of the sinking recurrence (compute_particulate_terms,
    BGC_mod.F90:2116-2699).  Returns the carry for the next level and the
    per-level remineralization/burial terms.  ``diss`` supplies this
    level's precomputed dissolution factors."""
    dz = cell_thickness
    dzr = 1.0 / dz

    # incoming fluxes are the outgoing fluxes of the level above
    poc_s_in, poc_h_in = carry.poc_s, carry.poc_h
    caco3_s_in, caco3_h_in = carry.caco3_s, carry.caco3_h
    sio2_s_in, sio2_h_in = carry.sio2_s, carry.sio2_h
    dust_s_in, dust_h_in = carry.dust_s, carry.dust_h
    fe_s_in, fe_h_in = carry.fe_s, carry.fe_h

    # dissolution length scales (BGC_mod.F90:2288-2338)
    if diss is None:
        scalelength = _scalelength(cell_bottom_depth, params)
        decay_hard = exp(-dz / DECAY_HARD_SCALE)
        decay_hard_dust = exp(-dz / DECAY_HARD_DUST_SCALE)
        tfuncs = pow(TFUNCS_Q10, (temp - TREF) / 10.0)
        sio2_diss = scalelength * params.parm_SiO2_diss / tfuncs
        caco3_diss = scalelength * params.parm_CaCO3_diss
        dust_diss = scalelength * DUST_DISS
        decay_sio2 = exp(-dz / sio2_diss)
        decay_caco3 = exp(-dz / caco3_diss)
        decay_dust = exp(-dz / dust_diss)
    else:
        scalelength = diss.scalelength
        decay_hard = diss.decay_hard
        decay_hard_dust = diss.decay_hard_dust
        decay_caco3, caco3_diss = diss.decay_caco3, diss.caco3_diss
        decay_sio2, sio2_diss = diss.decay_sio2, diss.sio2_diss
        decay_dust = diss.decay_dust

    # O2-dependent POC dissolution lengthening (BGC_mod.F90:2311-2315)
    poc_diss = torch.where(
        (o2_loc >= 5.0) & (o2_loc < 40.0),
        params.parm_POC_diss * (1.0 + (3.3 - 1.0) * (40.0 - o2_loc) / 35.0),
        torch.where(o2_loc < 5.0, fill_like(o2_loc,
                                            params.parm_POC_diss * 3.3),
                    fill_like(o2_loc, params.parm_POC_diss)))

    poc_diss = scalelength * poc_diss
    decay_poc_e = exp(-dz / poc_diss)

    # ballast out-fluxes: analytic solution of constant-source linear-decay
    # ODE across the cell (BGC_mod.F90:2349-2365)
    caco3_s_out = (caco3_s_in * decay_caco3
                   + caco3_prod * ((1.0 - P_CACO3_GAMMA)
                                   * (1.0 - decay_caco3) * caco3_diss))
    caco3_h_out = caco3_h_in * decay_hard + caco3_prod * (P_CACO3_GAMMA * dz)
    sio2_s_out = (sio2_s_in * decay_sio2
                  + sio2_prod * ((1.0 - P_SIO2_GAMMA)
                                 * (1.0 - decay_sio2) * sio2_diss))
    sio2_h_out = sio2_h_in * decay_hard + sio2_prod * (P_SIO2_GAMMA * dz)
    dust_s_out = dust_s_in * decay_dust
    dust_h_out = dust_h_in * decay_hard_dust

    # QA(dust) deficit bookkeeping (BGC_mod.F90:2373-2412)
    poc_prod_avail = (poc_prod - RHO_CACO3 * caco3_prod
                      - RHO_SIO2 * sio2_prod)

    dust_in_tot = dust_s_in + dust_h_in
    qa_ratio = safe_div(dust_s_out + dust_h_out, dust_in_tot)
    new_qa = torch.where(carry.qa_dust_def > 0.0,
                         carry.qa_dust_def * qa_ratio, 0.0)
    reduce_mask = new_qa > 0.0
    qa_reduced = new_qa - poc_prod_avail * dz
    poc_prod_avail = torch.where(reduce_mask,
                                 torch.where(qa_reduced < 0.0,
                                             -qa_reduced * dzr, 0.0),
                                 poc_prod_avail)
    new_qa = torch.where(reduce_mask, torch.clamp_min(qa_reduced, 0.0),
                         new_qa)

    # POC out-fluxes: hard = QA (ballast-associated), soft = excess
    # (BGC_mod.F90:2423-2438)
    poc_h_out = (RHO_CACO3 * (caco3_s_out + caco3_h_out)
                 + RHO_SIO2 * (sio2_s_out + sio2_h_out)
                 + RHO_DUST * (dust_s_out + dust_h_out)
                 - new_qa)
    poc_h_out = torch.where((poc_h_in == 0.0) & (poc_prod == 0.0),
                            0.0, torch.clamp_min(poc_h_out, 0.0))
    poc_s_out = (poc_s_in * decay_poc_e
                 + poc_prod_avail * ((1.0 - decay_poc_e) * poc_diss))

    # remineralization by conservation (BGC_mod.F90:2445-2463)
    caco3_remin = caco3_prod + ((caco3_s_in - caco3_s_out)
                                + (caco3_h_in - caco3_h_out)) * dzr
    sio2_remin = sio2_prod + ((sio2_s_in - sio2_s_out)
                              + (sio2_h_in - sio2_h_out)) * dzr
    poc_remin = poc_prod + ((poc_s_in - poc_s_out)
                            + (poc_h_in - poc_h_out)) * dzr
    dust_remin = ((dust_s_in - dust_s_out)
                  + (dust_h_in - dust_h_out)) * dzr

    # iron: remin proportional to POC remin (BGC_mod.F90:2469-2501)
    poc_in_tot = poc_s_in + poc_h_in
    fe_remin = torch.where(
        poc_in_tot == 0.0,
        poc_remin * PARM_RED_FE_C,
        safe_div(poc_remin * (fe_s_in + fe_h_in), poc_in_tot))
    fe_remin = fe_remin + fe_s_in * FE_SFLUX_REMIN_RATE
    fe_s_out = fe_s_in + dz * (fe_prod - fe_remin)
    fe_remin = torch.where(fe_s_out < 0.0,
                           fe_s_in * dzr + fe_prod, fe_remin)
    fe_s_out = torch.clamp_min(fe_s_out, 0.0)
    fe_remin = fe_remin + dust_remin * DUST_TO_FE + fesedflux * dzr
    fe_h_out = fe_h_in

    # ----- bottom cell: burial, sedimentary denitrification, anoxic remin
    # (BGC_mod.F90:2522-2631) -----
    bot = is_bottom & active

    poc_flux = poc_s_out + poc_h_out
    bot_poc = bot & (poc_flux > 0.0)
    flux_alt_day = poc_flux * MPERCM * SPD            # mmol/m^2/day
    day_den = 7.0 + flux_alt_day
    poc_sed_loss = torch.where(
        bot_poc,
        poc_flux * torch.clamp_max(
            params.parm_POMbury
            * (0.013 + 0.53 * flux_alt_day * flux_alt_day
               / (day_den * day_den)), 0.8),
        0.0)
    sed_denitrif = torch.where(
        bot_poc,
        dzr * poc_flux * (0.06 + 0.19 * pow(0.99, o2_loc - no3_loc)),
        0.0)
    sed_denitrif = torch.where(no3_loc < 5.0, 0.0, sed_denitrif)

    flux_alt_yr = poc_flux * 1.0e-6 * SPD * 365.0     # mmol/cm^2/year
    other_remin = torch.where(
        bot_poc,
        dzr * torch.minimum(
            torch.clamp_max(0.1 + flux_alt_yr, 0.5)
            * (poc_flux - poc_sed_loss),
            poc_flux - poc_sed_loss - sed_denitrif * dz * DENITRIF_C_N),
        0.0)
    # anoxic bottom water: all remaining remin is denitrif + other
    other_remin = torch.where(
        bot_poc & (o2_loc < 1.0),
        dzr * (poc_flux - poc_sed_loss - sed_denitrif * dz * DENITRIF_C_N),
        other_remin)

    sio2_flux = sio2_s_out + sio2_h_out
    sio2_bury_eff = torch.where(sio2_flux * MPERCM * SPD > 2.0,
                                sio2_flux.new_full((), 0.2),
                                sio2_flux.new_full((), 0.04))
    sio2_sed_loss = torch.where(bot, sio2_flux * params.parm_BSIbury
                                * sio2_bury_eff, 0.0)

    caco3_flux = caco3_s_out + caco3_h_out
    caco3_sed_loss = torch.where(
        bot & (cell_bottom_depth < LYSOCLINE_DEPTH), caco3_flux, 0.0)

    # re-inject the unburied bottom flux as remin (BGC_mod.F90:2574-2590)
    caco3_remin = torch.where(
        bot & (caco3_flux > 0.0),
        caco3_remin + (caco3_flux - caco3_sed_loss) * dzr, caco3_remin)
    sio2_remin = torch.where(
        bot & (sio2_flux > 0.0),
        sio2_remin + (sio2_flux - sio2_sed_loss) * dzr, sio2_remin)
    poc_remin = torch.where(
        bot_poc, poc_remin + (poc_flux - poc_sed_loss) * dzr, poc_remin)

    fe_flux = fe_s_out + fe_h_out
    fe_sed_loss = torch.where(bot & (fe_flux > 0.0), fe_flux, 0.0)
    dust_sed_loss = torch.where(bot, dust_s_out + dust_h_out, 0.0)

    # the bottom cell zeroes all outgoing fluxes (BGC_mod.F90:2615-2628),
    # and the carry freezes below the bottom of ragged columns
    def _next(out, old):
        return torch.where(active, torch.where(bot, 0.0, out), old)

    new_carry = ParticleCarry(
        poc_s=_next(poc_s_out, carry.poc_s),
        poc_h=_next(poc_h_out, carry.poc_h),
        caco3_s=_next(caco3_s_out, carry.caco3_s),
        caco3_h=_next(caco3_h_out, carry.caco3_h),
        sio2_s=_next(sio2_s_out, carry.sio2_s),
        sio2_h=_next(sio2_h_out, carry.sio2_h),
        dust_s=_next(dust_s_out, carry.dust_s),
        dust_h=_next(dust_h_out, carry.dust_h),
        fe_s=_next(fe_s_out, carry.fe_s),
        fe_h=_next(fe_h_out, carry.fe_h),
        qa_dust_def=torch.where(active, new_qa, carry.qa_dust_def),
    )

    def _m(x):
        return torch.where(active, x, 0.0)

    out = ParticleLevelOut(
        poc_remin=_m(poc_remin), caco3_remin=_m(caco3_remin),
        sio2_remin=_m(sio2_remin), dust_remin=_m(dust_remin),
        fe_remin=_m(fe_remin),
        poc_sed_loss=_m(poc_sed_loss), caco3_sed_loss=_m(caco3_sed_loss),
        sio2_sed_loss=_m(sio2_sed_loss), dust_sed_loss=_m(dust_sed_loss),
        fe_sed_loss=_m(fe_sed_loss),
        sed_denitrif=_m(sed_denitrif), other_remin=_m(other_remin),
    )
    return new_carry, out


def particulate_diags(carry_in: ParticleCarry, out: ParticleLevelOut,
                      poc_prod, caco3_prod, sio2_prod, fe_prod,
                      cell_thickness, active) -> Dict[str, torch.Tensor]:
    """The per-level particulate diagnostics (BGC_mod.F90:2637-2694) from
    the stacked per-level outputs: FLUX_IN reports the incoming fluxes,
    the carry entering each level."""
    def _m(x):
        return torch.where(active, x, 0.0)

    return {
        "POC_FLUX_IN": _m(carry_in.poc_s + carry_in.poc_h),
        "POC_PROD": _m(poc_prod),
        "POC_REMIN": out.poc_remin,
        # declared but never assigned in the reference (BGC_parms.F90:206),
        # so the host always reads zeros
        "POC_ACCUM": torch.zeros_like(out.poc_remin),
        "CaCO3_FLUX_IN": _m(carry_in.caco3_s + carry_in.caco3_h),
        "CaCO3_PROD": _m(caco3_prod),
        "CaCO3_REMIN": out.caco3_remin,
        "SiO2_FLUX_IN": _m(carry_in.sio2_s + carry_in.sio2_h),
        "SiO2_PROD": _m(sio2_prod),
        "SiO2_REMIN": out.sio2_remin,
        "dust_FLUX_IN": _m(carry_in.dust_s + carry_in.dust_h),
        "dust_REMIN": out.dust_remin,
        "P_iron_FLUX_IN": _m(carry_in.fe_s + carry_in.fe_h),
        "P_iron_PROD": _m(fe_prod),
        "P_iron_REMIN": out.fe_remin,
        "calcToSed": out.caco3_sed_loss,
        "bsiToSed": out.sio2_sed_loss,
        "pocToSed": out.poc_sed_loss,
        "SedDenitrif": out.sed_denitrif * cell_thickness,
        "OtherRemin": out.other_remin * cell_thickness,
        "ponToSed": out.poc_sed_loss * Q,
        "popToSed": out.poc_sed_loss * QP_ZOO_POM,
        "dustToSed": out.dust_sed_loss,
        "pfeToSed": out.fe_sed_loss,
    }
