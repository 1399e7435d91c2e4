"""Scalar reference of the full coupled timestep (forward Euler).

Chains the scalar steps (bgc, trace_gas, surface) exactly the
way the coupled model does: surface fluxes -> interior tendencies -> Euler
update with top-cell flux deposition -> pH warm-start threading.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import bgc as bgc_ref
from portbench.reference import surface as surface_ref
from portbench.reference import trace_gas as trace_gas_ref

# tracer indices duplicated from bgc_ref
O2T, DIC, DIC_ALT, ALK, PO4, SIO3, NO3, NH4 = (
    bgc_ref.O2T, bgc_ref.DIC, bgc_ref.DIC_ALT, bgc_ref.ALK, bgc_ref.PO4,
    bgc_ref.SIO3, bgc_ref.NO3, bgc_ref.NH4)


def coupled_step_ref(state, grid, forcing, params, dt):
    """state: dict(tracers (nlev,30,ncol), ph_prev, ph_prev_alt,
    surface_ph, surface_ph_alt, dms (nlev,2,ncol), macros (nlev,3,ncol)).
    Returns the updated state dict."""
    trc = state["tracers"]
    nlev, _, ncol = trc.shape
    kmax = grid["kmax"]

    # ---- surface fluxes ----
    net = np.zeros((30, ncol))
    dms_flux = np.zeros(ncol)
    new_sph = state["surface_ph"].copy()
    new_spha = state["surface_ph_alt"].copy()
    for col in range(ncol):
        if kmax[col] < 1:
            continue
        s = surface_ref.bgc_surface_column(
            trc[0, DIC, col], trc[0, DIC_ALT, col], trc[0, ALK, col],
            trc[0, PO4, col], trc[0, SIO3, col], trc[0, O2T, col],
            forcing["sst"][col], forcing["sss"][col],
            forcing["surface_pressure"][col],
            forcing["ice_fraction"][col],
            forcing["wind_speed_squared_10m"][col],
            forcing["atm_co2"][col], forcing["atm_co2_alt"][col],
            forcing["surface_depth"][col],
            state["surface_ph"][col], state["surface_ph_alt"][col])
        net[O2T, col] = s["flux_o2"]
        net[DIC, col] = s["flux_co2"]
        net[DIC_ALT, col] = s["flux_co2_alt"]
        net[ALK, col] += net[NH4, col] - net[NO3, col]
        new_sph[col] = s["ph"]
        new_spha[col] = s["ph_alt"]
        dms_flux[col] = surface_ref.dms_surface_column(
            state["dms"][0, 0, col], forcing["sst"][col],
            forcing["sss"][col], forcing["ice_fraction"][col],
            forcing["wind_speed_squared_10m"][col],
            forcing["surface_pressure"][col])

    # ---- interior tendencies ----
    tend, ph_new, ph_alt_new, _ = bgc_ref.bgc_source_sink_ref(
        trc, grid, forcing, state["ph_prev"], state["ph_prev_alt"], params.bgc)

    # assemble the 14-tracer DMS block from the shared ecosystem state
    B = bgc_ref
    dms_block = np.stack([
        state["dms"][:, 0], state["dms"][:, 1],
        trc[:, B.NO3], trc[:, B.DOC], trc[:, B.ZOOC], trc[:, B.C_IND[0]],
        trc[:, B.CA_IND[0]], trc[:, B.C_IND[1]], trc[:, B.C_IND[2]],
        trc[:, B.C_IND[3]], trc[:, B.CHL_IND[0]], trc[:, B.CHL_IND[1]],
        trc[:, B.CHL_IND[2]], trc[:, B.CHL_IND[3]]], axis=1)
    dms_tend, _ = trace_gas_ref.dms_source_sink(
        dms_block, grid["cell_thickness"], kmax, forcing["sst"],
        forcing["shortwave_surface"], params.dms)

    mac_block = np.stack([
        state["macros"][:, 0], state["macros"][:, 1], state["macros"][:, 2],
        trc[:, B.ZOOC], trc[:, B.C_IND[0]], trc[:, B.C_IND[1]],
        trc[:, B.C_IND[2]], trc[:, B.C_IND[3]]], axis=1)
    mac_tend, _ = trace_gas_ref.macros_source_sink(mac_block, kmax,
                                                   params.macros)

    # ---- Euler update ----
    new_trc = trc + dt * tend
    new_dms = state["dms"] + dt * dms_tend[:, :2]
    new_mac = state["macros"] + dt * mac_tend[:, :3]
    for col in range(ncol):
        if kmax[col] < 1:
            continue
        dzr = 1.0 / grid["cell_thickness"][0, col]
        new_trc[0, :, col] += dt * dzr * net[:, col]
        new_dms[0, 0, col] += dt * dzr * dms_flux[col]

    return dict(tracers=new_trc, ph_prev=ph_new, ph_prev_alt=ph_alt_new,
                surface_ph=new_sph, surface_ph_alt=new_spha,
                dms=new_dms, macros=new_mac)
