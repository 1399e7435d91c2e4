"""The multispecies ecosystem source-sink step, its diagnostics and health
counters.

Counterpart of ``ocean_bgc_tpu/ops/bgc.py`` (``BGC_SourceSink``,
BGC_mod.F90:340-1998): the Moore et al. 2002 / Doney et al. 1996
NPZD+Fe+DOM model over 30 tracers and 4 autotroph functional groups,
with two carbonate-chemistry solves per cell (ambient + alternative
CO2), the Armstrong ballast sinking-particle recurrence,
nitrification/denitrification and DOM cycling.

Layout and schedule follow the JAX package: columns on the last axis,
all per-cell algebra batched over ``(nlev, ncol)``, PAR attenuation as a
cumulative product over levels, the dual pH solve over every cell at
once (the CUDA kernel K1, ``ops/cuda_carbonate.py``: its dual instance
on the env cache's constants, or without an env cache on those the
constants kernel evaluates first, with the saturation values), and the
sinking
recurrence — the one sequential level coupling — as a Python loop over
levels.  Autotroph groups are a Python loop over 4 static trait sets.
Everything is masked by the per-column active-level count.  The
diagnostics (``compute_diags``) and the health counters (``health``)
follow the JAX package's ``bgc_source_sink`` field for field.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ocean_bgc_tpu_torch import constants as c
from ocean_bgc_tpu_torch.ops.carbonate import (
    CarbCoeffs,
    _to_mass_units,
    carbonate_coeffs,
    co3_sat_vals,
    solver_xacc,
    talk,
    x0_seed_enabled,
)
from ocean_bgc_tpu_torch.ops.cuda_carbonate import (
    co3_terms_dual_coeffs,
    dual_sat_and_coeffs,
    solve_htotal_brackets,
    subsurface_of,
)
from ocean_bgc_tpu_torch.ops.numerics import (
    exp,
    fill_like,
    log,
    morel_kpar,
    pow,
    safe_div,
    z_sqrt_z,
)
from ocean_bgc_tpu_torch.ops.particulates import (
    RHO_CACO3,
    RHO_SIO2,
    DissolutionCache,
    ParticleCarry,
    ParticleLevelOut,
    ParticleProdOut,
    init_particle_carry,
    particulate_diags,
    particulate_level_update,
    precompute_dissolution,
)
from ocean_bgc_tpu_torch.ops.schmidt import o2sat
from ocean_bgc_tpu_torch.params import BGCParams
from ocean_bgc_tpu_torch.state import BGCForcing, BGCTracers as T, ColumnGrid


def _maximum(a, b):
    """jnp.maximum over any mix of tensors and Python scalars."""
    if not torch.is_tensor(a):
        a, b = b, a
    return torch.maximum(a, b) if torch.is_tensor(b) else torch.clamp_min(a, b)


def _minimum(a, b):
    """jnp.minimum over any mix of tensors and Python scalars."""
    if not torch.is_tensor(a):
        a, b = b, a
    return torch.minimum(a, b) if torch.is_tensor(b) else torch.clamp_max(a, b)


class StepHealth(NamedTuple):
    """Two scalar counts over active cells, cheap enough for every
    production step:

    * ``solver_nonconverged_cells``: cells whose next Newton correction at
      the returned pH still exceeds twice the solver tolerance (the silent
      fall-through of co2calc.F90:993-995 made observable);
    * ``poc_error_cells``: cells violating the QA-ballast production bound
      (the reference's write-only ``poc_error`` flag, BGC_mod.F90:2296-2297,
      2373-2383).
    """

    solver_nonconverged_cells: torch.Tensor   # scalar, state dtype
    poc_error_cells: torch.Tensor             # scalar, state dtype


class BGCSourceSinkOut(NamedTuple):
    """Results of one source-sink evaluation."""

    tendencies: torch.Tensor       # (nlev, 30, ncol)
    ph_prev_3d: torch.Tensor       # (nlev, ncol) updated warm-start state
    ph_prev_alt_3d: torch.Tensor   # (nlev, ncol)
    diags: Dict[str, torch.Tensor]
    health: Optional[StepHealth] = None


def _par_field(par_surf_row, total_chl, dz, active):
    """PAR at the top/average/absorption of every cell, in one shot.

    The reference attenuates PAR sequentially down the column
    (BGC_mod.F90:907-924); each cell's absorption depends only on its own
    chlorophyll, so PAR_in(k) = PAR_surf * prod_{j<k, active} exp(-KPARdz(j))
    is an exclusive cumulative product over levels.  ``par_surf_row`` is
    (1, ncol)."""
    chl = torch.clamp_min(total_chl, 0.02)
    kpar = morel_kpar(chl)
    kpar_dz = kpar * dz
    att = exp(-kpar_dz)
    # inactive cells pass PAR through unchanged
    att_eff = torch.where(active, att, 1.0)
    cum = torch.cumprod(att_eff, dim=0)
    par_in = par_surf_row * torch.cat([torch.ones_like(cum[:1]), cum[:-1]],
                                      dim=0)
    par_out = par_in * att
    par_avg = par_in * (1.0 - att) / kpar_dz
    return par_in, par_out, par_avg, kpar_dz


def _zsat_search(anom, center, prev_center, bottom, active, kmax):
    """Saturation depth per column (BGC_mod.F90:1003-1032) from the CO3
    anomaly of every cell: the reference's downward state machine as a
    first-crossing search over levels.  A column supersaturated at its
    surface records the interpolated depth of its first deeper active
    cell with anom <= 0, or its bottom depth if none (-1 for a
    single-level column, whose surface initialisation comes after the
    bottom-fill check in the reference); an undersaturated surface gives
    0, and so does land."""
    nlev, ncol = anom.shape
    anom_km1 = torch.cat([anom[:1], anom[:-1]], dim=0)
    k_idx = torch.arange(nlev, device=anom.device)[:, None]
    cand = active & (k_idx >= 1) & (anom <= 0.0)
    # argmax takes no bool; on ties it returns the first index
    first_k = torch.argmax(cand.to(torch.int32), dim=0)
    has_cross = cand.any(dim=0)

    # the reference's work4 = depth(k-1) + (depth(k) - depth(k-1))
    interp_depth = prev_center + (center - prev_center)
    den = anom_km1 - anom
    interp_all = interp_depth * anom_km1 / torch.where(den != 0.0, den, 1.0)
    col = torch.arange(ncol, device=anom.device)
    interp_at = interp_all[first_k, col]

    kb = torch.clamp_min(kmax - 1, 0)
    bottom_depth = bottom[kb, col]

    zs = torch.where(
        anom[0] > 0.0,
        torch.where(has_cross, interp_at,
                    torch.where(kmax == 1, -1.0, bottom_depth)),
        0.0)
    return torch.where(kmax > 0, zs, 0.0)


class EnvCache(NamedTuple):
    """Forcing-invariant coefficient tables (the "env cache").

    Everything here depends only on (T, S, grid): the 11 carbonate
    equilibrium constants (co2calc.F90:320-777), the calcite/aragonite
    solubilities (:1096-1238), the Q10 temperature response
    (BGC_mod.F90:1041) and the particulate dissolution decays
    (:2288-2338).  :func:`precompute_env` evaluates them once per forcing
    snapshot; the cache is valid while (T, S, grid) keep those values.

    ``standin_ph`` is the pH of the inactive-cell stand-in problem (DIC
    2000, ALK 2300, T 10, S 35, PO4 = SiO3 = 0), solved once per snapshot
    so that every inactive lane of the interior solve starts warm; their
    results are discarded by ``where(active, ...)``.

    ``fingerprint`` is :func:`env_fingerprint` of the (grid, forcing) the
    cache was built from, which the staleness guard compares
    (:func:`check_env_cache`); last and optional, so that a cache built
    field by field without it still works where the guard is off.
    """

    coeffs: CarbCoeffs         # interior-solve constants ((nlev, ncol))
    co3_sat_calc: torch.Tensor
    co3_sat_arag: torch.Tensor
    tfunc: torch.Tensor        # ecosystem Q10 response
    diss: DissolutionCache     # sinking-scheme decay factors
    standin_ph: torch.Tensor
    fingerprint: Optional[torch.Tensor] = None


def env_fingerprint(grid: ColumnGrid, forcing: BGCForcing) -> torch.Tensor:
    """Cheap order-sensitive checksum of every input the
    :class:`EnvCache` tables depend on: (T, S) and the grid geometry.  Two
    forcing snapshots that differ anywhere give different fingerprints (up
    to rounding).  Shape (5,), the forcing temperature's type and device;
    no host synchronisation."""
    dt = forcing.potential_temperature.dtype

    def chk(a):
        a = a.reshape(-1).to(dt)
        w = torch.arange(a.numel(), dtype=dt, device=a.device) % 97.0 + 1.0
        return torch.dot(a, w) / a.numel()

    return torch.stack([chk(forcing.potential_temperature),
                        chk(forcing.salinity),
                        chk(grid.cell_thickness),
                        chk(grid.cell_bottom_depth),
                        chk(grid.kmax)])


def _env_check_enabled() -> bool:
    """The staleness guard is opt-in (debug mode): OBGC_CHECK_ENV=1.
    Read at every call, so hosts and tests can flip it at run time."""
    return os.environ.get("OBGC_CHECK_ENV", "0") == "1"


def _raise_if_env_stale(rel_err: float, tol: float) -> None:
    if rel_err > tol:
        raise ValueError(
            f"stale EnvCache: the (T, S, grid) fingerprint differs from "
            f"the cache's by {rel_err:.3e} (tol {tol:.1e}).  The forcing "
            f"or grid changed since precompute_env(): rebuild the cache "
            f"(ops/bgc.py::precompute_env) or pass env=None.")


def check_env_cache(env: EnvCache, grid: ColumnGrid,
                    forcing: BGCForcing) -> None:
    """Verify that ``env`` was built from this (grid, forcing) pair;
    raises ValueError if stale.  :func:`bgc_source_sink` calls it under
    ``OBGC_CHECK_ENV=1``; hosts with their own forcing cadence can call it
    at each forcing update.  It reads one scalar back, so on the card it
    synchronises with the host."""
    if env.fingerprint is None:
        raise ValueError("EnvCache has no fingerprint (built without "
                         "precompute_env?): rebuild it.")
    live = env_fingerprint(grid, forcing)
    tol = 1e-5 if live.dtype == torch.float32 else 1e-10
    fp = env.fingerprint.to(live.dtype)
    rel = torch.max(torch.abs(live - fp) / (1.0 + torch.abs(fp)))
    _raise_if_env_stale(rel.item(), tol)


def precompute_env(grid: ColumnGrid, forcing: BGCForcing,
                   params: BGCParams) -> EnvCache:
    """Evaluate the forcing-invariant tables of :class:`EnvCache`, with
    the masked stand-ins and pressure gating the in-step code uses.  The
    stand-in solve is K1's bracket-in instance on CUDA tensors and its
    plain version on CPU tensors
    (``ops/cuda_carbonate.py::solve_htotal_brackets``).

    The cache is valid while (T, S, grid) keep the values passed here; it
    carries their :func:`env_fingerprint`, which ``OBGC_CHECK_ENV=1`` makes
    every consuming :func:`bgc_source_sink` call check."""
    temp = forcing.potential_temperature
    depth_m = grid.cell_center_depth * 0.01
    subsurface = subsurface_of(depth_m)
    temp_s, salt_s = _standin_ts(grid, forcing)
    coeffs = carbonate_coeffs(depth_m, temp_s, salt_s, subsurface,
                              k1_k2_ph_tot=True)
    sat_calc, sat_arag = co3_sat_vals(depth_m, temp_s, salt_s, subsurface)
    tfunc = q10_tfunc(temp)
    diss = precompute_dissolution(temp, grid.cell_thickness,
                                  grid.cell_bottom_depth, params)
    zero = torch.zeros_like(temp_s)
    dic_m, ta_m, pt_m, sit_m = _to_mass_units(
        torch.full_like(temp_s, 2000.0), torch.full_like(temp_s, 2300.0),
        zero, zero)
    h_standin = solve_htotal_brackets(
        coeffs, dic_m, ta_m, pt_m, sit_m,
        torch.full_like(temp_s, 10.0 ** -c.PHHI_3D_INIT),
        torch.full_like(temp_s, 10.0 ** -c.PHLO_3D_INIT))
    return EnvCache(coeffs=coeffs, co3_sat_calc=sat_calc,
                    co3_sat_arag=sat_arag, tfunc=tfunc, diss=diss,
                    standin_ph=-torch.log10(h_standin),
                    fingerprint=env_fingerprint(grid, forcing))


class EcosystemKinetics(NamedTuple):
    """Everything the batched per-cell ecosystem algebra produces that the
    sinking recurrence, the tendency assembly, or the diagnostics consume.

    ``(nlev, ncol)`` arrays, except the per-autotroph tuples (length
    nauto, entries ``None`` where the trait does not apply — mirroring
    the reference's ``Si_ind == 0`` sentinels)."""

    # PAR field (BGC_mod.F90:907-924)
    par_in: torch.Tensor
    par_out: torch.Tensor
    par_avg: torch.Tensor
    kpar_dz: torch.Tensor
    # zooplankton (BGC_mod.F90:1395-1415)
    zoo_loss: torch.Tensor
    zoo_loss_doc: torch.Tensor
    zoo_loss_dic: torch.Tensor
    # DOM production / remineralization (BGC_mod.F90:1421-1461)
    doc_prod: torch.Tensor
    don_prod: torch.Tensor
    dop_prod: torch.Tensor
    dofe_prod: torch.Tensor
    doc_remin: torch.Tensor
    don_remin: torch.Tensor
    dofe_remin: torch.Tensor
    dop_remin: torch.Tensor
    donr_remin: torch.Tensor
    dopr_remin: torch.Tensor
    # particulate sources (BGC_mod.F90:1467-1529)
    poc_prod: torch.Tensor
    caco3_prod: torch.Tensor
    sio2_prod: torch.Tensor
    fe_prod_base: torch.Tensor
    # per-autotroph tuples
    a_chl: tuple
    thetaC: tuple
    qfe: tuple
    qsi: tuple
    qcaco3: tuple
    vno3: tuple
    vnh4: tuple
    vntot: tuple
    no3_v: tuple
    nh4_v: tuple
    po4_v: tuple
    dop_v: tuple
    photoC: tuple
    photoFe: tuple
    photoSi: tuple
    photoacc: tuple
    caco3_prod_g: tuple
    auto_graze: tuple
    auto_loss: tuple
    auto_agg: tuple
    graze_zoo: tuple
    graze_poc: tuple
    graze_doc: tuple
    graze_dic: tuple
    loss_poc_g: tuple
    loss_doc_g: tuple
    loss_dic_g: tuple
    nfix: tuple
    nexcrete: tuple
    rem_p_dop: tuple
    rem_p_dip: tuple
    d_n_lim: tuple
    d_fe_lim: tuple
    d_p_lim: tuple
    d_si_lim: tuple
    d_light: tuple


def ecosystem_kinetics(
    tr: torch.Tensor,             # (nlev, 30, ncol), already clipped >= 0
    temp: torch.Tensor,           # (nlev, ncol)
    dz: torch.Tensor,             # (nlev, ncol) cm
    center: torch.Tensor,         # (nlev, ncol) cm
    active: torch.Tensor,         # (nlev, ncol) bool
    lat: torch.Tensor,            # broadcasts against (nlev, ncol); degrees
    par_surf_row: torch.Tensor,   # (1, ncol)
    params: BGCParams,
    *,
    tfunc: Optional[torch.Tensor] = None,
) -> EcosystemKinetics:
    """The batched per-cell ecosystem algebra (BGC_mod.F90:826-1529):
    quota ratios, PAR, nutrient uptake, photosynthesis, grazing,
    zooplankton, DOM cycling, and the particulate production terms.

    Elementwise/broadcast math over ``(nlev, ncol)`` plus one cumulative
    product over levels (the PAR field).  ``tfunc`` is the env cache's
    Q10 response, computed here when absent.
    """
    autos = params.autotrophs
    nauto = len(autos)
    north = lat >= 0.0
    cdt = temp.dtype

    def _ns(trait_n, trait_s):
        """North/south trait select, in the working dtype (each value
        filled on the device: a copy from the host would synchronise)."""
        return torch.where(north, fill_like(temp, trait_n),
                           fill_like(temp, trait_s))

    no3 = tr[:, T.NO3]
    sio3 = tr[:, T.SIO3]
    nh4 = tr[:, T.NH4]
    fe = tr[:, T.FE]
    doc = tr[:, T.DOC]
    zooC = tr[:, T.ZOOC]
    don = tr[:, T.DON]
    dofe = tr[:, T.DOFE]
    dop = tr[:, T.DOP]
    dopr = tr[:, T.DOPR]
    donr = tr[:, T.DONR]
    po4 = tr[:, T.PO4]

    # ---- zero-mask coupled phyto pools (BGC_mod.F90:826-844) ----
    a_chl, a_c, a_fe, a_si, a_caco3 = [], [], [], [], []
    for g, au in enumerate(autos):
        chl_g = tr[:, T.CHL_IND[g]]
        c_g = tr[:, T.C_IND[g]]
        fe_g = tr[:, T.FE_IND[g]]
        si_g = tr[:, T.SI_IND[g]] if T.SI_IND[g] is not None else None
        ca_g = (tr[:, T.CACO3_IND[g]]
                if T.CACO3_IND[g] is not None else None)
        zero_mask = (chl_g == 0.0) | (c_g == 0.0) | (fe_g == 0.0)
        if si_g is not None:
            zero_mask = zero_mask | (si_g == 0.0)
        keep = ~zero_mask
        a_chl.append(torch.where(keep, chl_g, 0.0))
        a_c.append(torch.where(keep, c_g, 0.0))
        a_fe.append(torch.where(keep, fe_g, 0.0))
        a_si.append(torch.where(keep, si_g, 0.0) if si_g is not None
                    else None)
        a_caco3.append(torch.where(keep, ca_g, 0.0) if ca_g is not None
                       else None)

    # ---- quota ratios (BGC_mod.F90:850-898) ----
    thetaC, qfe, qsi, qcaco3, gqfe, gqsi = [], [], [], [], [], []
    for g, au in enumerate(autos):
        thetaC.append(a_chl[g] / (a_c[g] + c.EPSC))
        qfe.append(a_fe[g] / (a_c[g] + c.EPSC))
        qsi.append(_minimum(a_si[g] / (a_c[g] + c.EPSC), c.GQSI_MAX)
                   if au.has_si else None)
        # growth Fe quota, reduced under low ambient Fe
        gq = torch.where(
            fe < c.CKS * au.kFe,
            _maximum(au.gQfe_0 * fe / (c.CKS * au.kFe), au.gQfe_min),
            au.gQfe_0)
        gqfe.append(gq)
        if au.has_si:
            gs = torch.full_like(fe, c.GQSI_0)
            # the fe == 0 value of the guarded division is discarded
            # by this where and the fe == 0 override below
            gs = torch.where(
                (fe < c.CKSI * au.kFe) & (fe > 0.0)
                & (sio3 > c.CKSI * au.kSiO3),
                _minimum(
                    safe_div(fill_like(fe, c.GQSI_0 * c.CKSI * au.kFe)
                             .expand_as(fe), fe),
                    c.GQSI_MAX),
                gs)
            gs = torch.where(fe == 0.0, c.GQSI_MAX, gs)
            gs = torch.where(
                sio3 < c.CKSI * au.kSiO3,
                _maximum(gs * sio3 / (c.CKSI * au.kSiO3), c.GQSI_MIN),
                gs)
            gqsi.append(gs)
        else:
            gqsi.append(None)
        if au.imp_calcifier or au.exp_calcifier:
            qcaco3.append(_minimum(a_caco3[g] / (a_c[g] + c.EPSC),
                                   c.QCACO3_MAX))
        else:
            qcaco3.append(None)

    # ---- PAR attenuation, whole column at once (BGC_mod.F90:907-924) --
    total_chl = sum(a_chl)
    par_in, par_out, par_avg, kpar_dz = _par_field(
        par_surf_row, total_chl, dz, active)

    # ---- temperature response (BGC_mod.F90:1041); precomputed by the
    # env cache when the forcing snapshot is held constant ----
    if tfunc is None:
        tfunc = q10_tfunc(temp)

    # ---- depth-tapered loss threshold (BGC_mod.F90:1047-1055) ----
    f_loss_thres = torch.where(
        center > c.THRES_Z1,
        torch.where(center < c.THRES_Z2,
                    (c.THRES_Z2 - center) / (c.THRES_Z2 - c.THRES_Z1),
                    0.0),
        1.0)

    # ---- Pprime per autotroph (BGC_mod.F90:1072-1094) ----
    pprime = []
    for g, au in enumerate(autos):
        thres = f_loss_thres * au.loss_thres
        if au.temp_function == c.TFNC_QUASI_MMRT:
            tmax = _ns(au.temp_thresN, au.temp_thresS)
            thres = torch.where(temp > tmax,
                                f_loss_thres * au.loss_thres2, thres)
        else:
            thres = torch.where(temp < au.temp_thres,
                                f_loss_thres * au.loss_thres2, thres)
        pprime.append(_maximum(a_c[g] - thres, 0.0))

    # ---- uptake, photosynthesis, grazing per autotroph
    # (BGC_mod.F90:1107-1388) ----
    vno3, vnh4, vntot = [], [], []
    no3_v, nh4_v, po4_v, dop_v = [], [], [], []
    photoC, photoFe, photoSi, photoacc = [], [], [], []
    caco3_prod_g = [None] * nauto
    auto_graze, auto_loss, auto_agg = [], [], []
    graze_zoo, graze_poc, graze_doc, graze_dic = [], [], [], []
    loss_poc_g, loss_doc_g, loss_dic_g = [], [], []
    nfix, nexcrete = [None] * nauto, [None] * nauto
    rem_p_dop, rem_p_dip = [None] * nauto, [None] * nauto
    d_n_lim, d_fe_lim, d_p_lim, d_si_lim, d_light = [], [], [], [], []

    for g, au in enumerate(autos):
        vn3 = (no3 / au.kNO3) / (1.0 + no3 / au.kNO3 + nh4 / au.kNH4)
        vn4 = (nh4 / au.kNH4) / (1.0 + no3 / au.kNO3 + nh4 / au.kNH4)
        vnt = vn3 + vn4
        if au.nfixer:
            vnt = torch.ones_like(vnt)
        vno3.append(vn3)
        vnh4.append(vn4)
        vntot.append(vnt)
        d_n_lim.append(vnt)

        vfe = fe / (fe + au.kFe)
        d_fe_lim.append(vfe)
        f_nut = _minimum(vnt, vfe)

        vpo4 = (po4 / au.kPO4) / (1.0 + po4 / au.kPO4 + dop / au.kDOP)
        vdop = (dop / au.kDOP) / (1.0 + po4 / au.kPO4 + dop / au.kDOP)
        vptot = vpo4 + vdop
        d_p_lim.append(vptot)
        f_nut = _minimum(f_nut, vptot)

        if au.has_si:
            vsio3 = sio3 / (sio3 + au.kSiO3)
            d_si_lim.append(vsio3)
            f_nut = _minimum(f_nut, vsio3)
        else:
            d_si_lim.append(torch.zeros_like(f_nut))

        # photosynthesis rate (BGC_mod.F90:1146-1177)
        pcmax = au.PCref * f_nut * tfunc
        pcmax = torch.where(temp < au.temp_thres, 0.0, pcmax)
        if au.temp_function == c.TFNC_QUASI_MMRT:
            topt = _ns(au.temp_optN, au.temp_optS)
            tmax = _ns(au.temp_thresN, au.temp_thresS)
            pcmax = pcmax * _minimum(1.0, (tmax - temp) / (tmax - topt))
            pcmax = torch.where(temp > tmax, 0.0, pcmax)

        light_lim = 1.0 - exp(
            (-1.0 * au.alphaPI * thetaC[g] * par_avg)
            / (pcmax + c.EPSTINV))
        pcphoto = pcmax * light_lim
        d_light.append(light_lim)
        pc = pcphoto * a_c[g]
        photoC.append(pc)

        # N/P uptake partition (BGC_mod.F90:1193-1221)
        has_n = vnt > 0.0
        no3_v.append(torch.where(has_n, safe_div(vn3, vnt) * pc * c.Q,
                                 0.0))
        nh4_v.append(torch.where(has_n, safe_div(vn4, vnt) * pc * c.Q,
                                 0.0))
        vnc = torch.where(has_n, pcphoto * c.Q, 0.0)

        has_p = vptot > 0.0
        po4_v.append(torch.where(has_p,
                                 safe_div(vpo4, vptot) * pc * au.Qp, 0.0))
        dop_v.append(torch.where(has_p,
                                 safe_div(vdop, vptot) * pc * au.Qp, 0.0))

        photoFe.append(pc * gqfe[g])
        photoSi.append(pc * gqsi[g] if au.has_si else None)

        # photoadaptation (BGC_mod.F90:1240-1246)
        work1 = au.alphaPI * thetaC[g] * par_avg
        pchl = au.thetaN_max * safe_div(pcphoto, work1)
        # thetaC == 0 lanes give 0 either way, since a_chl = 0 there
        photoacc.append(torch.where(
            work1 > 0.0,
            safe_div(pchl * vnc, thetaC[g]) * a_chl[g],
            0.0))

        # CaCO3 production (BGC_mod.F90:1255-1278)
        if au.imp_calcifier:
            cap = params.parm_f_prod_sp_CaCO3 * pc * f_nut
            cap = torch.where(
                temp < c.CACO3_TEMP_THRES1,
                cap * _maximum(temp - c.CACO3_TEMP_THRES2, 0.0)
                / (c.CACO3_TEMP_THRES1 - c.CACO3_TEMP_THRES2),
                cap)
            cap = torch.where(
                a_c[g] > c.CACO3_SP_THRES,
                _minimum(cap * a_c[g] / c.CACO3_SP_THRES,
                         c.F_PHOTOSP_CACO3 * pc),
                cap)
            caco3_prod_g[g] = cap

        # losses (BGC_mod.F90:1285-1290)
        auto_loss.append(au.mort * pprime[g] * tfunc)
        agg = _minimum((au.agg_rate_max * c.DPS) * pprime[g],
                       au.mort2 * pprime[g] * pprime[g])
        agg = _maximum((au.agg_rate_min * c.DPS) * pprime[g], agg)
        auto_agg.append(agg)

    # grazing needs the full Pprime set (shared grazee classes,
    # BGC_mod.F90:1297-1324)
    for g, au in enumerate(autos):
        grazee_sum = sum(pprime[g2] for g2, au2 in enumerate(autos)
                         if au2.grazee_ind == au.grazee_ind)
        z_umax = au.z_umax_0 * tfunc
        if g == 1:   # diatoms: phaeo-linked grazing relief
            reliefN = _maximum(
                (au.temp_thresN - temp) / (au.temp_thresN - au.temp_optN),
                0.95)
            reliefS = _maximum(
                (au.temp_thresS - temp) / (au.temp_thresS - au.temp_optS),
                0.95)
            z_umax = torch.where(
                north & (temp > au.temp_optN), z_umax * reliefN,
                torch.where((lat <= 0.0) & (temp > au.temp_optS),
                            z_umax * reliefS, z_umax))
        graze = torch.where(
            grazee_sum > 0.0,
            safe_div(pprime[g], grazee_sum) * z_umax * zooC
            * grazee_sum / (grazee_sum + au.z_grz),
            0.0)
        auto_graze.append(graze)

        # N fixation (BGC_mod.F90:1331-1338)
        if au.nfixer:
            wn = photoC[g] * c.Q
            nf = wn * c.R_NFIX_PHOTO - no3_v[g] - nh4_v[g]
            nfix[g] = nf
            nexcrete[g] = nf + no3_v[g] + nh4_v[g] - wn

        # grazing / loss routing (BGC_mod.F90:1354-1372)
        gz = au.graze_zoo * graze
        if au.imp_calcifier:
            gp = graze * _maximum(
                c.CACO3_POC_MIN * qcaco3[g],
                _minimum(c.SPC_POC_FAC * _maximum(1.0, pprime[g]),
                         c.F_GRAZE_SP_POC_LIM))
        else:
            gp = au.graze_poc * graze
        gd = au.graze_doc * graze
        graze_zoo.append(gz)
        graze_poc.append(gp)
        graze_doc.append(gd)
        graze_dic.append(graze - (gz + gp + gd))

        if au.imp_calcifier:
            lp = qcaco3[g] * auto_loss[g]
        else:
            lp = au.loss_poc * auto_loss[g]
        loss_poc_g.append(lp)
        loss_doc_g.append((1.0 - params.parm_labile_ratio)
                          * (auto_loss[g] - lp))
        loss_dic_g.append(params.parm_labile_ratio
                          * (auto_loss[g] - lp))

        # non-Redfield P routing (BGC_mod.F90:1380-1386); the Qp
        # comparison is static (trait value vs fixed constant)
        if au.Qp != c.QP_ZOO_POM:
            rem_p = ((graze + auto_loss[g] + auto_agg[g]) * au.Qp
                     - graze_zoo[g] * c.QP_ZOO_POM
                     - (graze_poc[g] + loss_poc_g[g] + auto_agg[g])
                     * c.QP_ZOO_POM)
            rem_p_dop[g] = (1.0 - params.parm_labile_ratio) * rem_p
            rem_p_dip[g] = params.parm_labile_ratio * rem_p

    # ---- zooplankton (BGC_mod.F90:1395-1415) ----
    w1 = sum(au.f_zoo_detr * (auto_graze[g] + c.EPSC * c.EPSTINV)
             for g, au in enumerate(autos))
    w2 = sum(auto_graze[g] + c.EPSC * c.EPSTINV for g in range(nauto))
    f_zoo_detr = w1 / w2

    zprime = _maximum(zooC - f_loss_thres * c.LOSS_THRES_ZOO, 0.0)
    # Zprime**1.5 (BGC_mod.F90:1397) as z*sqrt(z), as the JAX package
    # writes it, with the derivative 1.5*sqrt(z), 0 at zero biomass
    zoo_loss = (params.parm_z_mort2_0 * z_sqrt_z(zprime)
                + params.parm_z_mort_0 * zprime) * tfunc
    zoo_loss_doc = ((1.0 - params.parm_labile_ratio)
                    * (1.0 - f_zoo_detr) * zoo_loss)
    zoo_loss_dic = (params.parm_labile_ratio
                    * (1.0 - f_zoo_detr) * zoo_loss)

    # ---- DOM production & remineralization (BGC_mod.F90:1421-1461) --
    doc_prod = zoo_loss_doc + sum(loss_doc_g) + sum(graze_doc)
    don_prod = c.Q * doc_prod
    dop_prod = c.QP_ZOO_POM * zoo_loss_doc
    for g, au in enumerate(autos):
        if au.Qp == c.QP_ZOO_POM:
            dop_prod = dop_prod + au.Qp * (loss_doc_g[g] + graze_doc[g])
        else:
            dop_prod = dop_prod + rem_p_dop[g]
    dofe_prod = c.QFE_ZOO * zoo_loss_doc
    for g in range(nauto):
        dofe_prod = dofe_prod + qfe[g] * (loss_doc_g[g] + graze_doc[g])

    lit = par_avg > 1.0    # euphotic-zone photochemistry switch

    def _lit_fac(bright, dark):
        return torch.where(lit, doc.new_full((), bright),
                           doc.new_full((), dark))

    doc_remin = doc * c.DOC_REMINR * _lit_fac(1.0, c.DOC_REMIN_DARK_FAC)
    don_remin = don * c.DON_REMINR * _lit_fac(1.0, c.DON_REMIN_DARK_FAC)
    dofe_remin = (dofe * c.DOFE_REMINR
                  * _lit_fac(1.0, c.DOFE_REMIN_DARK_FAC))
    dop_remin = dop * c.DOP_REMINR * _lit_fac(1.0, c.DOP_REMIN_DARK_FAC)
    donr_remin = donr * _lit_fac(c.DONR_REMINR, c.DONR_REMINR_DARK)
    dopr_remin = dopr * _lit_fac(c.DOPR_REMINR, c.DOPR_REMINR_DARK)

    # ---- particulate production (BGC_mod.F90:1467-1529) ----
    poc_prod = (f_zoo_detr * zoo_loss + sum(graze_poc)
                + sum(auto_agg) + sum(loss_poc_g))
    caco3_prod = torch.zeros_like(poc_prod)
    sio2_prod = torch.zeros_like(poc_prod)
    for g, au in enumerate(autos):
        if au.imp_calcifier or au.exp_calcifier:
            caco3_prod = ((1.0 - c.F_GRAZE_CACO3_REMIN) * auto_graze[g]
                          + auto_loss[g] + auto_agg[g]) * qcaco3[g]
        if au.has_si:
            sio2_prod = qsi[g] * (
                (1.0 - c.F_GRAZE_SI_REMIN) * auto_graze[g]
                + auto_agg[g] + au.loss_poc * auto_loss[g])

    # iron production *except* scavenging, which scales with the sinking
    # mass flux entering each level (BGC_mod.F90:1510-1522) and is
    # therefore evaluated inside the sinking recurrence
    fe_prod_base = zoo_loss * f_zoo_detr * c.QFE_ZOO
    for g in range(nauto):
        fe_prod_base = fe_prod_base + qfe[g] * (auto_agg[g] + graze_poc[g]
                                                + loss_poc_g[g])

    return EcosystemKinetics(
        par_in=par_in, par_out=par_out, par_avg=par_avg, kpar_dz=kpar_dz,
        zoo_loss=zoo_loss, zoo_loss_doc=zoo_loss_doc,
        zoo_loss_dic=zoo_loss_dic,
        doc_prod=doc_prod, don_prod=don_prod, dop_prod=dop_prod,
        dofe_prod=dofe_prod,
        doc_remin=doc_remin, don_remin=don_remin, dofe_remin=dofe_remin,
        dop_remin=dop_remin, donr_remin=donr_remin,
        dopr_remin=dopr_remin,
        poc_prod=poc_prod, caco3_prod=caco3_prod, sio2_prod=sio2_prod,
        fe_prod_base=fe_prod_base,
        a_chl=tuple(a_chl), thetaC=tuple(thetaC), qfe=tuple(qfe),
        qsi=tuple(qsi), qcaco3=tuple(qcaco3),
        vno3=tuple(vno3), vnh4=tuple(vnh4), vntot=tuple(vntot),
        no3_v=tuple(no3_v), nh4_v=tuple(nh4_v), po4_v=tuple(po4_v),
        dop_v=tuple(dop_v),
        photoC=tuple(photoC), photoFe=tuple(photoFe),
        photoSi=tuple(photoSi), photoacc=tuple(photoacc),
        caco3_prod_g=tuple(caco3_prod_g),
        auto_graze=tuple(auto_graze), auto_loss=tuple(auto_loss),
        auto_agg=tuple(auto_agg),
        graze_zoo=tuple(graze_zoo), graze_poc=tuple(graze_poc),
        graze_doc=tuple(graze_doc), graze_dic=tuple(graze_dic),
        loss_poc_g=tuple(loss_poc_g), loss_doc_g=tuple(loss_doc_g),
        loss_dic_g=tuple(loss_dic_g),
        nfix=tuple(nfix), nexcrete=tuple(nexcrete),
        rem_p_dop=tuple(rem_p_dop), rem_p_dip=tuple(rem_p_dip),
        d_n_lim=tuple(d_n_lim), d_fe_lim=tuple(d_fe_lim),
        d_p_lim=tuple(d_p_lim), d_si_lim=tuple(d_si_lim),
        d_light=tuple(d_light),
    )


class AssemblyExtras(NamedTuple):
    """Intermediates of the tendency assembly that the diagnostics also
    report (BGC_mod.F90:1545-1592, 1765-1790)."""

    nitrif: torch.Tensor
    denitrif: torch.Tensor
    o2_production: torch.Tensor
    o2_consumption: torch.Tensor


def assemble_tendencies(
    kin: EcosystemKinetics,
    pt,                           # ParticleProdOut, stacked (nlev, ncol)
    fe_scavenge: torch.Tensor,
    tr: torch.Tensor,             # (nlev, 30, ncol), clipped
    restore_no3: torch.Tensor,
    restore_sio3: torch.Tensor,
    restore_po4: torch.Tensor,
    params: BGCParams,
) -> Tuple[List[torch.Tensor], AssemblyExtras]:
    """The 30 tracer tendency expressions (BGC_mod.F90:1545-1790), from
    the kinetics terms and the stacked particulate outputs.  Returns
    the *unmasked* per-tracer list (callers mask by ``active`` and choose
    the output layout) plus the extras diagnostics report."""
    autos = params.autotrophs
    nauto = len(autos)

    no3 = tr[:, T.NO3]
    nh4 = tr[:, T.NH4]
    o2 = tr[:, T.O2]

    # ---- nitrate & ammonium (BGC_mod.F90:1545-1592) ----
    nitrif = params.parm_kappa_nitrif * nh4
    # The euphotic-zone taper log(PAR_out/lim)/KPARdz (BGC_mod.F90:
    # 1552-1560).  The log sees a benign input on lanes whose taper the
    # select discards, and PAR_out is floored at 1e-37 (reached only
    # when one cell has optical depth > ~85 while its top is lit), so a
    # deep cell's PAR underflowing to 0 never reaches log(0).
    taper_sel = kin.par_in > params.parm_nitrif_par_lim
    par_for_log = torch.where(taper_sel,
                              _maximum(kin.par_out, 1e-37),
                              params.parm_nitrif_par_lim)
    taper = (log(par_for_log / params.parm_nitrif_par_lim)
             / (-kin.kpar_dz))
    nitrif = torch.where(taper_sel, nitrif * taper, nitrif)
    nitrif = torch.where(kin.par_out < params.parm_nitrif_par_lim,
                         nitrif, 0.0)

    denitrif_fac = torch.clamp(
        ((params.parm_o2_min + params.parm_o2_min_delta) - o2)
        / params.parm_o2_min_delta, 0.0, 1.0)
    denitrif_fac = torch.where(no3 == 0.0, 0.0, denitrif_fac)
    denitrif = denitrif_fac * (
        (kin.doc_remin + pt.poc_remin - pt.other_remin) / c.DENITRIF_C_N
        - pt.sed_denitrif)

    tend = [None] * T.CNT
    tend[T.NO3] = (restore_no3 + nitrif - denitrif - pt.sed_denitrif
                   - sum(kin.no3_v))
    tend[T.NH4] = (-sum(kin.nh4_v) - nitrif + kin.don_remin
                   + kin.donr_remin
                   + c.Q * (kin.zoo_loss_dic + sum(kin.loss_dic_g)
                            + sum(kin.graze_dic)
                            + pt.poc_remin * (1.0 - c.DONREFRACT)))
    for g, au in enumerate(autos):
        if au.nfixer:
            tend[T.NH4] = tend[T.NH4] + kin.nexcrete[g]

    # ---- dissolved iron (BGC_mod.F90:1598-1605) ----
    tend[T.FE] = (pt.fe_remin + c.QFE_ZOO * kin.zoo_loss_dic
                  + kin.dofe_remin - sum(kin.photoFe) - fe_scavenge)
    for g in range(nauto):
        tend[T.FE] = (tend[T.FE]
                      + kin.qfe[g] * (kin.loss_dic_g[g]
                                      + kin.graze_dic[g])
                      + kin.graze_zoo[g] * (kin.qfe[g] - c.QFE_ZOO))

    # ---- dissolved SiO3 (BGC_mod.F90:1611-1628) ----
    tend[T.SIO3] = restore_sio3 + pt.sio2_remin
    for g, au in enumerate(autos):
        if au.has_si:
            tend[T.SIO3] = (tend[T.SIO3] - kin.photoSi[g]
                            + kin.qsi[g] * (c.F_GRAZE_SI_REMIN
                                            * kin.auto_graze[g]
                                            + (1.0 - au.loss_poc)
                                            * kin.auto_loss[g]))

    # ---- phosphate (BGC_mod.F90:1634-1661) ----
    tend[T.PO4] = (restore_po4 + kin.dop_remin + kin.dopr_remin
                   - sum(kin.po4_v)
                   + c.QP_ZOO_POM * ((1.0 - c.DOPREFRACT) * pt.poc_remin
                                     + kin.zoo_loss_dic))
    for g, au in enumerate(autos):
        if au.Qp == c.QP_ZOO_POM:
            tend[T.PO4] = tend[T.PO4] + au.Qp * (kin.loss_dic_g[g]
                                                 + kin.graze_dic[g])
        else:
            tend[T.PO4] = tend[T.PO4] + kin.rem_p_dip[g]

    # ---- autotroph pools (BGC_mod.F90:1676-1697) ----
    for g, au in enumerate(autos):
        wloss = kin.auto_graze[g] + kin.auto_loss[g] + kin.auto_agg[g]
        tend[T.C_IND[g]] = kin.photoC[g] - wloss
        tend[T.CHL_IND[g]] = kin.photoacc[g] - kin.thetaC[g] * wloss
        tend[T.FE_IND[g]] = kin.photoFe[g] - kin.qfe[g] * wloss
        if T.SI_IND[g] is not None:
            tend[T.SI_IND[g]] = kin.photoSi[g] - kin.qsi[g] * wloss
        if T.CACO3_IND[g] is not None:
            tend[T.CACO3_IND[g]] = (kin.caco3_prod_g[g]
                                    - kin.qcaco3[g] * wloss)

    # ---- zooC & DOM pools (BGC_mod.F90:1703-1723) ----
    tend[T.ZOOC] = sum(kin.graze_zoo) - kin.zoo_loss
    tend[T.DOC] = kin.doc_prod - kin.doc_remin
    tend[T.DON] = kin.don_prod * (1.0 - c.DONREFRACT) - kin.don_remin
    tend[T.DONR] = (kin.don_prod * c.DONREFRACT - kin.donr_remin
                    + pt.poc_remin * c.DONREFRACT * c.Q)
    tend[T.DOP] = (kin.dop_prod * (1.0 - c.DOPREFRACT) - kin.dop_remin
                   - sum(kin.dop_v))
    tend[T.DOPR] = (kin.dop_prod * c.DOPREFRACT - kin.dopr_remin
                    + pt.poc_remin * c.DOPREFRACT * c.QP_ZOO_POM)
    tend[T.DOFE] = kin.dofe_prod - kin.dofe_remin

    # ---- DIC (BGC_mod.F90:1729-1745) ----
    tend[T.DIC] = (sum(kin.loss_dic_g) + sum(kin.graze_dic)
                   - sum(kin.photoC)
                   + kin.doc_remin + pt.poc_remin + kin.zoo_loss_dic
                   + pt.caco3_remin)
    for g, au in enumerate(autos):
        if T.CACO3_IND[g] is not None:
            tend[T.DIC] = (tend[T.DIC]
                           + c.F_GRAZE_CACO3_REMIN * kin.auto_graze[g]
                           * kin.qcaco3[g] - kin.caco3_prod_g[g])
    if params.alt_co2_use_eco:
        tend[T.DIC_ALT_CO2] = tend[T.DIC]
    else:
        tend[T.DIC_ALT_CO2] = torch.zeros_like(tend[T.DIC])

    # ---- alkalinity (BGC_mod.F90:1751-1759) ----
    tend[T.ALK] = (-tend[T.NO3] + tend[T.NH4]
                   + 2.0 * pt.caco3_remin)
    for g, au in enumerate(autos):
        if T.CACO3_IND[g] is not None:
            tend[T.ALK] = (tend[T.ALK]
                           + 2.0 * (c.F_GRAZE_CACO3_REMIN
                                    * kin.auto_graze[g] * kin.qcaco3[g]
                                    - kin.caco3_prod_g[g]))

    # ---- oxygen (BGC_mod.F90:1765-1790) ----
    o2_production = torch.zeros_like(o2)
    for g, au in enumerate(autos):
        if not au.nfixer:
            denom = kin.no3_v[g] + kin.nh4_v[g]
            contrib = kin.photoC[g] * (
                safe_div(kin.no3_v[g], denom) / c.PARM_RED_D_C_O2
                + safe_div(kin.nh4_v[g], denom) / c.PARM_REMIN_D_C_O2)
        else:
            denom = kin.no3_v[g] + kin.nh4_v[g] + kin.nfix[g]
            contrib = kin.photoC[g] * (
                safe_div(kin.no3_v[g], denom) / c.PARM_RED_D_C_O2
                + safe_div(kin.nh4_v[g], denom) / c.PARM_REMIN_D_C_O2
                + safe_div(kin.nfix[g], denom) / c.PARM_RED_D_C_O2_DIAZ)
        o2_production = o2_production + torch.where(kin.photoC[g] > 0.0,
                                                    contrib, 0.0)

    o2_fac = torch.clamp((o2 - params.parm_o2_min)
                         / params.parm_o2_min_delta, 0.0, 1.0)
    o2_consumption = o2_fac * (
        (pt.poc_remin + kin.doc_remin
         - pt.sed_denitrif * c.DENITRIF_C_N - pt.other_remin
         + kin.zoo_loss_dic + sum(kin.loss_dic_g) + sum(kin.graze_dic))
        / c.PARM_REMIN_D_C_O2 + 2.0 * nitrif)
    tend[T.O2] = o2_production - o2_consumption

    return tend, AssemblyExtras(
        nitrif=nitrif, denitrif=denitrif,
        o2_production=o2_production, o2_consumption=o2_consumption)


def compute_restoring(forcing: BGCForcing, tr: torch.Tensor,
                      params: BGCParams):
    """The optional nutrient-restoring terms (BGC_mod.F90:1545-1547,
    1611-1613, 1634-1636), gated on the static ``lrest_*`` flags."""
    no3 = tr[:, T.NO3]
    sio3 = tr[:, T.SIO3]
    po4 = tr[:, T.PO4]
    if params.lrest_no3:
        restore_no3 = forcing.nutr_restore_rtau * (forcing.no3_clim - no3)
    else:
        restore_no3 = torch.zeros_like(no3)
    if params.lrest_sio3:
        restore_sio3 = forcing.nutr_restore_rtau * (forcing.sio3_clim
                                                    - sio3)
    else:
        restore_sio3 = torch.zeros_like(sio3)
    if params.lrest_po4:
        restore_po4 = forcing.nutr_restore_rtau * (forcing.po4_clim - po4)
    else:
        restore_po4 = torch.zeros_like(po4)
    return restore_no3, restore_sio3, restore_po4


def q10_tfunc(temp):
    """The ecosystem's Q10 temperature response (BGC_mod.F90:1041)."""
    return pow(c.Q_10, (temp - c.TREF) / 10.0)


def _standin_ts(grid: ColumnGrid, forcing: BGCForcing):
    """T and S with the stand-ins (T 10, S 35) below the ocean floor."""
    active = grid.active_mask()
    return (torch.where(active, forcing.potential_temperature, 10.0),
            torch.where(active, forcing.salinity, 35.0))


def coeff_inputs(grid: ColumnGrid, forcing: BGCForcing) -> tuple:
    """The interior's equilibrium constants' inputs without an env cache,
    contiguous, as :func:`carbonate_coeffs_sat` takes them: depth (m), and
    T and S with the stand-ins (T 10, S 35) below the ocean floor."""
    temp_s, salt_s = _standin_ts(grid, forcing)
    return ((grid.cell_center_depth * 0.01).contiguous(),
            temp_s.contiguous(), salt_s.contiguous())


def carbonate_inputs(tracers, grid: ColumnGrid, forcing: BGCForcing,
                     ph_prev_3d, ph_prev_alt_3d,
                     env: Optional[EnvCache] = None) -> tuple:
    """The arguments of the interior dual pH solve as
    :func:`bgc_source_sink` gives them, all contiguous.  With an env cache,
    those of :func:`co3_terms_dual_coeffs`: DIC, ALK, PO4, SiO3 of the
    clipped ``tracers``, the two pH seeds and the cached constants.
    Without one, those of :func:`co3_terms_dual_sat`: :func:`coeff_inputs`,
    the same four tracers and the two previous pH fields.

    Inactive cells get the benign stand-in problem the env cache solved
    (DIC 2000, ALK 2300, PO4 = SiO3 = 0 at T 10, S 35) and, with an env
    cache, start warm from its root, so no lane holds its warp for a cold
    solve; the step discards their results."""
    active = grid.active_mask()

    def field(idx, standin):
        return torch.where(active, torch.clamp_min(tracers[:, idx], 0.0),
                           standin).contiguous()

    tr = (field(T.DIC, 2000.0), field(T.ALK, 2300.0), field(T.PO4, 0.0),
          field(T.SIO3, 0.0))
    if env is None:
        return (*coeff_inputs(grid, forcing), *tr, ph_prev_3d.contiguous(),
                ph_prev_alt_3d.contiguous())
    ph_seed = torch.where(active, ph_prev_3d, env.standin_ph)
    ph_seed_alt = torch.where(active, ph_prev_alt_3d, env.standin_ph)
    return (*tr, ph_seed.contiguous(), ph_seed_alt.contiguous(),
            CarbCoeffs(*(k.contiguous() for k in env.coeffs)))


def _health(tr, ph_3d, coeffs: CarbCoeffs, kin: EcosystemKinetics,
            active) -> StepHealth:
    """The health counters (JAX ops/bgc.py:1284-1304) from the clipped
    tracers ``tr``: one alkalinity residual per cell at the returned pH,
    against the solver's own stopping rule, and the QA-ballast bound."""
    dic_m, ta_m, pt_m, sit_m = _to_mass_units(
        torch.where(active, tr[:, T.DIC], 2000.0),
        torch.where(active, tr[:, T.ALK], 2300.0), tr[:, T.PO4],
        tr[:, T.SIO3])
    h_fin = 10.0 ** (-ph_3d)
    fn_h, df_h = talk(coeffs, dic_m, ta_m, pt_m, sit_m, h_fin)
    nonconv = active & (torch.abs(fn_h / df_h)
                        > 2.0 * solver_xacc(ph_3d.dtype))
    avail = (kin.poc_prod - RHO_CACO3 * kin.caco3_prod
             - RHO_SIO2 * kin.sio2_prod)
    dtype = tr.dtype
    return StepHealth(
        solver_nonconverged_cells=nonconv.sum().to(dtype),
        poc_error_cells=(active & (avail < 0.0)).sum().to(dtype))


def bgc_source_sink(
    tracers: torch.Tensor,        # (nlev, 30, ncol)
    grid: ColumnGrid,
    forcing: BGCForcing,
    ph_prev_3d: torch.Tensor,     # (nlev, ncol)
    ph_prev_alt_3d: torch.Tensor,
    params: BGCParams,
    *,
    compute_diags: bool = True,
    carbonate_impl: str = "auto",
    env: Optional[EnvCache] = None,
    health: bool = False,
    x0_seed: Optional[bool] = None,
) -> BGCSourceSinkOut:
    """Tendencies (1/s units of each tracer), updated pH state, and the
    diagnostics (an empty dict with ``compute_diags=False``).

    ``env``: precomputed forcing-invariant tables (:func:`precompute_env`),
    valid while (T, S, grid) are those the cache was built from; under
    ``OBGC_CHECK_ENV=1`` each call checks that (:func:`check_env_cache`,
    one host synchronisation), raising ValueError on a stale cache.  Without
    one, the step evaluates the equilibrium constants per cell (and, with
    diagnostics, the saturation values) once, for the pH solve and the
    health counters (:func:`carbonate_coeffs_sat`).

    ``carbonate_impl``: "auto" (the CUDA kernel on CUDA tensors, its plain
    version on CPU tensors), "kernel" (CUDA tensors only) or "torch" (the
    plain version anywhere); see ``ops/cuda_carbonate.py``.

    ``health``: also return :class:`StepHealth`, at the cost of one
    alkalinity residual per cell.

    ``x0_seed``: seed the pH solve at the previous root (K1's seeded
    variant); None reads ``OBGC_X0_SEED`` (``ops/carbonate.py::
    x0_seed_enabled``).  Inactive cells are seeded from the stand-in root
    their window is centred on (``env.standin_ph``), as the JAX package
    seeds them (bgc.py:1180-1183, :1242-1247).
    """
    nlev = tracers.shape[0]
    if env is not None and _env_check_enabled():
        check_env_cache(env, grid, forcing)
    active = grid.active_mask()                          # (nlev, ncol)
    lat = grid.latitude                                  # (ncol,)

    # setup loop: clip negative tracers (BGC_mod.F90:747-785)
    tr = torch.clamp_min(tracers, 0.0)

    # surface initializations (BGC_mod.F90:808-814)
    dust_flux_in = torch.clamp_min(forcing.dust_flux_in, 0.0)
    par_surf = torch.clamp_min(forcing.shortwave_surface, 0.0) * c.F_QSW_PAR

    temp = forcing.potential_temperature                 # (nlev, ncol)
    dz = grid.cell_thickness
    center = grid.cell_center_depth
    bottom = grid.cell_bottom_depth

    k_index = torch.arange(nlev, device=tracers.device)
    is_bottom = (k_index[:, None] + 1) == grid.kmax[None, :]

    no3 = tr[:, T.NO3]
    fe = tr[:, T.FE]
    o2 = tr[:, T.O2]

    # Carbonate chemistry for all cells at once (K1), on the env cache's
    # constants or, without one, on constants evaluated once here for the
    # solve and the health counters.  The speciation and the saturation
    # values feed only diagnostics.
    args = carbonate_inputs(tracers, grid, forcing, ph_prev_3d,
                            ph_prev_alt_3d, env)
    seed = x0_seed_enabled() if x0_seed is None else x0_seed
    if env is not None:
        coeffs, sat = args[-1], (env.co3_sat_calc, env.co3_sat_arag)
        amb, alt = co3_terms_dual_coeffs(*args, seed=seed,
                                         impl=carbonate_impl)
    else:
        coeffs, amb, alt, sat = dual_sat_and_coeffs(
            *args, with_sat=compute_diags, seed=seed, impl=carbonate_impl)
    ph_3d, h2co3, hco3, co3 = amb
    ph_3d_alt, h2co3_alt, hco3_alt, co3_alt = alt

    ph_new = torch.where(active, ph_3d, ph_prev_3d)
    ph_alt_new = torch.where(active, ph_3d_alt, ph_prev_alt_3d)

    # ---- the batched ecosystem kinetics (BGC_mod.F90:826-1529) ----
    kin = ecosystem_kinetics(tr, temp, dz, center, active, lat,
                             par_surf[None, :], params,
                             tfunc=env.tfunc if env is not None else None)

    health_out = None
    if health:
        health_out = _health(tr, ph_3d, coeffs, kin, active)

    # ------------------------------------------------------------------
    # Sinking-particle recurrence over levels — the only sequential level
    # coupling (its clamped QA-ballast carry is nonlinear).  Diagnostics
    # read each level's full output, the incoming carry and the
    # scavenging rate; the tendency assembly only ParticleProdOut.
    # ------------------------------------------------------------------
    carry: ParticleCarry = init_particle_carry(dust_flux_in)
    levels, fe_scavenge_levels, rate_levels, carry_levels = [], [], [], []
    for k in range(nlev):
        # iron scavenging scales with the sinking mass flux entering
        # this level, i.e. the carry (BGC_mod.F90:1510-1522)
        fe_k = fe[k]
        fe_scavenge_rate = params.parm_fe_scavenge_rate0 * (
            (carry.poc_s + carry.poc_h) * 120.1
            + (carry.caco3_s + carry.caco3_h) * c.P_CACO3_MASS
            + (carry.sio2_s + carry.sio2_h) * c.P_SIO2_MASS
            + (carry.dust_s + carry.dust_h) * c.DUST_FESCAV_SCALE)
        fe_scavenge_rate = torch.where(
            fe_k > c.FE_SCAVENGE_THRES1,
            fe_scavenge_rate
            + (fe_k - c.FE_SCAVENGE_THRES1) * c.FE_MAX_SCALE2,
            fe_scavenge_rate)
        fe_scavenge = c.YPS * fe_k * fe_scavenge_rate
        fe_prod = kin.fe_prod_base[k] + fe_scavenge

        diss_k = (DissolutionCache(*(v[k] for v in env.diss))
                  if env is not None else None)
        if compute_diags:
            carry_levels.append(carry)
            rate_levels.append(fe_scavenge_rate)
        carry, pt_k = particulate_level_update(
            carry, kin.poc_prod[k], kin.caco3_prod[k], kin.sio2_prod[k],
            fe_prod, temp[k], o2[k], no3[k], dz[k], bottom[k],
            forcing.fesedflux[k], is_bottom[k], active[k], params,
            diss=diss_k)
        levels.append(pt_k)
        fe_scavenge_levels.append(fe_scavenge)

    def stacked(cls, per_level):
        """``cls`` of (nlev, ncol) stacks of the per-level fields."""
        return cls(*(torch.stack([getattr(p, f) for p in per_level])
                     for f in cls._fields))

    # with diagnostics off, stack only what the tendency assembly reads
    pt = stacked(ParticleLevelOut if compute_diags else ParticleProdOut,
                 levels)
    fe_scavenge = torch.stack(fe_scavenge_levels)

    # ---- tendency assembly (BGC_mod.F90:1545-1790) ----
    restore_no3, restore_sio3, restore_po4 = compute_restoring(
        forcing, tr, params)
    tend, ex = assemble_tendencies(kin, pt, fe_scavenge, tr, restore_no3,
                                   restore_sio3, restore_po4, params)

    # mask all tendencies to active cells; tracer axis in the middle
    tend_arr = torch.where(active[:, None, :], torch.stack(tend, dim=1), 0.0)
    diags: Dict[str, torch.Tensor] = {}
    if compute_diags:
        diags = _bgc_diags(
            tr, grid, forcing, params, kin, pt, ex, tend_arr, fe_scavenge,
            torch.stack(rate_levels), stacked(ParticleCarry, carry_levels),
            (restore_no3, restore_sio3, restore_po4),
            (ph_3d, h2co3, hco3, co3), (ph_3d_alt, h2co3_alt, hco3_alt,
                                        co3_alt), sat)
    return BGCSourceSinkOut(tendencies=tend_arr, ph_prev_3d=ph_new,
                            ph_prev_alt_3d=ph_alt_new, diags=diags,
                            health=health_out)


def _bgc_diags(tr, grid: ColumnGrid, forcing: BGCForcing,
               params: BGCParams, kin: EcosystemKinetics, pt, ex, tend_arr,
               fe_scavenge, fe_scavenge_rate, particles_in, restoring,
               carb, carb_alt, sat) -> Dict[str, torch.Tensor]:
    """The BGC diagnostics and conservation integrals
    (BGC_mod.F90:1794-1968; JAX ops/bgc.py:1385-1530, field for field):
    ``tr`` the clipped tracers, ``tend_arr`` the masked tendencies, ``pt``
    the stacked ParticleLevelOut, ``particles_in`` the stacked incoming
    carry."""
    autos = params.autotrophs
    nauto = len(autos)
    active = grid.active_mask()
    dz = grid.cell_thickness
    center = grid.cell_center_depth
    bottom = grid.cell_bottom_depth
    temp = forcing.potential_temperature
    ncol = dz.shape[1]
    tend = tend_arr.unbind(dim=1)
    (ph_3d, h2co3, hco3, co3), (ph_3d_alt, h2co3_alt, hco3_alt,
                                co3_alt) = carb, carb_alt
    co3_sat_calc, co3_sat_arag = sat
    restore_no3, restore_sio3, restore_po4 = restoring

    def _m(v):
        return torch.where(active, v, 0.0)

    zrow = torch.zeros_like(center[:1])
    prev_center = torch.cat([zrow, center[:-1]], dim=0)
    ztop = torch.cat([zrow, bottom[:-1]], dim=0)
    w2 = torch.minimum(100.0e2 - ztop, dz)
    partial_100m = torch.where(w2 > 0.0, w2, 0.0)

    # ---- saturation-depth search (BGC_mod.F90:1003-1032) ----
    zsatcalc = _zsat_search(co3 - co3_sat_calc, center, prev_center, bottom,
                            active, grid.kmax)
    zsatarag = _zsat_search(co3 - co3_sat_arag, center, prev_center, bottom,
                            active, grid.kmax)

    diags = {
        "CO3": _m(co3), "HCO3": _m(hco3), "H2CO3": _m(h2co3),
        "pH_3D": _m(ph_3d),
        "CO3_ALT_CO2": _m(co3_alt), "HCO3_ALT_CO2": _m(hco3_alt),
        "H2CO3_ALT_CO2": _m(h2co3_alt),
        "pH_3D_ALT_CO2": _m(ph_3d_alt),
        "co3_sat_calc": _m(co3_sat_calc),
        "co3_sat_arag": _m(co3_sat_arag),
        "NO3_RESTORE": _m(restore_no3),
        "SiO3_RESTORE": _m(restore_sio3),
        "PO4_RESTORE": _m(restore_po4),
        "NITRIF": _m(ex.nitrif), "DENITRIF": _m(ex.denitrif),
        "O2_PRODUCTION": _m(ex.o2_production),
        "O2_CONSUMPTION": _m(ex.o2_consumption),
        "AOU": _m(o2sat(temp, forcing.salinity) - tr[:, T.O2]),
        "PAR_avg": _m(kin.par_avg),
        "zoo_loss": _m(kin.zoo_loss),
        "auto_graze_TOT": _m(sum(kin.auto_graze)),
        "photoC_TOT": _m(sum(kin.photoC)),
        "DOC_prod": _m(kin.doc_prod), "DOC_remin": _m(kin.doc_remin),
        "DON_prod": _m(kin.don_prod), "DON_remin": _m(kin.don_remin),
        "DOP_prod": _m(kin.dop_prod), "DOP_remin": _m(kin.dop_remin),
        "DOFe_prod": _m(kin.dofe_prod),
        "DOFe_remin": _m(kin.dofe_remin),
        "DONr_remin": _m(kin.donr_remin),
        "DOPr_remin": _m(kin.dopr_remin),
        "Fe_scavenge": _m(fe_scavenge),
        "Fe_scavenge_rate": _m(fe_scavenge_rate),
        "tot_CaCO3_form": _m(sum(
            cp for cp in kin.caco3_prod_g if cp is not None)),
        "tot_Nfix": _m(sum(nf for nf in kin.nfix if nf is not None)),
    }
    diags.update(particulate_diags(
        particles_in, pt, kin.poc_prod, kin.caco3_prod, kin.sio2_prod,
        kin.fe_prod_base + fe_scavenge, dz, active))

    # per-autotroph 3D diagnostics, stacked (nlev, nauto, ncol)
    def _stack(vals):
        return torch.stack([_m(v) if v is not None else torch.zeros_like(dz)
                            for v in vals], dim=1)

    diags["N_lim"] = _stack(kin.d_n_lim)
    diags["Fe_lim"] = _stack(kin.d_fe_lim)
    diags["P_lim"] = _stack(kin.d_p_lim)
    diags["SiO3_lim"] = _stack(kin.d_si_lim)
    diags["light_lim"] = _stack(kin.d_light)
    diags["photoC"] = _stack(kin.photoC)
    diags["photoFe"] = _stack(kin.photoFe)
    diags["photoNO3"] = _stack(kin.no3_v)
    diags["photoNH4"] = _stack(kin.nh4_v)
    diags["PO4_uptake"] = _stack(kin.po4_v)
    diags["DOP_uptake"] = _stack(kin.dop_v)
    diags["auto_graze"] = _stack(kin.auto_graze)
    diags["auto_loss"] = _stack(kin.auto_loss)
    diags["auto_agg"] = _stack(kin.auto_agg)
    diags["bSi_form"] = _stack(kin.photoSi)
    diags["CaCO3_form"] = _stack(kin.caco3_prod_g)
    diags["Nfix"] = _stack(kin.nfix)
    photoc_no3 = [torch.where(kin.vntot[g] > 0.0,
                              safe_div(kin.vno3[g], kin.vntot[g])
                              * kin.photoC[g], 0.0) for g in range(nauto)]
    diags["photoC_NO3"] = _stack(photoc_no3)
    diags["photoC_NO3_TOT"] = _m(sum(photoc_no3))

    # conservation integrals (BGC_mod.F90:1870-1945)
    ctot = (tend[T.DIC] + tend[T.DOC] + tend[T.ZOOC]
            + sum(tend[T.C_IND[g]] for g in range(nauto))
            + sum(tend[T.CACO3_IND[g]] for g in range(nauto)
                  if T.CACO3_IND[g] is not None))
    ntot = (tend[T.NO3] + tend[T.NH4] + tend[T.DON] + tend[T.DONR]
            + c.Q * tend[T.ZOOC]
            + c.Q * sum(tend[T.C_IND[g]] for g in range(nauto))
            + ex.denitrif + pt.sed_denitrif
            - sum(kin.nfix[g] for g, au in enumerate(autos) if au.nfixer))
    ptot = (tend[T.PO4] + tend[T.DOP] + tend[T.DOPR]
            + c.QP_ZOO_POM * tend[T.ZOOC]
            + sum(au.Qp * tend[T.C_IND[g]] for g, au in enumerate(autos)))
    sitot = (tend[T.SIO3]
             + sum(tend[T.SI_IND[g]] for g in range(nauto)
                   if T.SI_IND[g] is not None))
    in100 = bottom <= 100.0e2
    sed_c = pt.poc_sed_loss + pt.caco3_sed_loss

    def _zint(per_level):                  # sum over the level axis
        return per_level.sum(dim=0)

    diags["Jint_Ctot"] = _zint(_m(ctot * dz + sed_c))
    diags["Jint_100m_Ctot"] = _zint(_m(
        ctot * partial_100m + torch.where(in100, sed_c, 0.0)))
    diags["Jint_Ntot"] = _zint(_m(ntot * dz + pt.poc_sed_loss * c.Q))
    diags["Jint_100m_Ntot"] = _zint(_m(
        ntot * partial_100m
        + torch.where(in100, pt.poc_sed_loss * c.Q, 0.0)))
    diags["Jint_Ptot"] = _zint(_m(ptot * dz
                                  + pt.poc_sed_loss * c.QP_ZOO_POM))
    diags["Jint_100m_Ptot"] = _zint(_m(
        ptot * partial_100m
        + torch.where(in100, pt.poc_sed_loss * c.QP_ZOO_POM, 0.0)))
    diags["Jint_Sitot"] = _zint(_m(sitot * dz + pt.sio2_sed_loss))
    diags["Jint_100m_Sitot"] = _zint(_m(
        sitot * partial_100m + torch.where(in100, pt.sio2_sed_loss, 0.0)))
    diags["Chl_TOT_zint_100m"] = _zint(_m(sum(kin.a_chl) * partial_100m))
    diags["tot_bSi_form"] = _zint(_m(sum(ps for ps in kin.photoSi
                                         if ps is not None)))
    diags["photoC_zint"] = _zint(_stack([pc * dz for pc in kin.photoC]))
    diags["photoC_NO3_zint"] = _zint(_stack([pn * dz for pn in photoc_no3]))
    diags["CaCO3_form_zint"] = _zint(_stack(
        [cp * dz if cp is not None else None for cp in kin.caco3_prod_g]))
    diags["photoC_TOT_zint"] = diags["photoC_zint"].sum(dim=0)
    diags["photoC_NO3_TOT_zint"] = diags["photoC_NO3_zint"].sum(dim=0)
    diags["tot_CaCO3_form_zint"] = diags["CaCO3_form_zint"].sum(dim=0)
    diags["zsatcalc"] = zsatcalc
    diags["zsatarag"] = zsatarag

    # O2 minimum search (BGC_mod.F90:1954-1968): on ties argmin returns
    # the first index, the first minimum as in the reference
    o2_masked = torch.where(active, tr[:, T.O2], torch.inf)
    kmin = torch.argmin(o2_masked, dim=0)
    col = torch.arange(ncol, device=dz.device)
    has_ocean = grid.kmax > 0
    diags["O2_ZMIN"] = torch.where(has_ocean, o2_masked[kmin, col], 0.0)
    diags["O2_ZMIN_DEPTH"] = torch.where(has_ocean, center[kmin, col], 0.0)
    return diags
