"""Synthetic ocean-world generator: plausible grids, hydrography, tracers.

The numpy construction of ``ocean_bgc_tpu/utils/synthetic.py``, step for
step, so the two packages build bitwise-identical worlds from one seed: a
deterministic idealized global column set (latitude-dependent
hydrography, exponential biology profiles, ragged shelf/deep bathymetry)
for tests, benchmarks and ``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ocean_bgc_tpu_torch.models.coupled import CoupledState
from ocean_bgc_tpu_torch.state import BGCForcing, BGCTracers as T, ColumnGrid
from ocean_bgc_tpu_torch.utils.bridge import world_from_numpy


def _synthetic_world_numpy(nlev: int = 60, ncol: int = 1024, seed: int = 0,
                          ragged: bool = True):
    """The world as (state, grid, forcing) dicts of float64/int32 numpy
    arrays keyed by the containers' field names."""
    rng = np.random.default_rng(seed)

    # geometry: 60 levels, 10 m cells near surface thickening to ~250 m
    dz1 = np.geomspace(1000.0, 25000.0, nlev)           # cm
    dz = np.tile(dz1[:, None], (1, ncol))
    zbot = np.cumsum(dz, axis=0)
    zcen = zbot - 0.5 * dz

    lat = np.linspace(-75.0, 75.0, ncol)
    kmax = np.full(ncol, nlev, dtype=np.int32)
    if ragged:
        shelf = rng.random(ncol) < 0.15                  # 15% shelf columns
        kmax[shelf] = rng.integers(min(5, nlev), nlev + 1, shelf.sum())
        land = rng.random(ncol) < 0.02                   # 2% land
        kmax[land] = 0

    grid = dict(cell_center_depth=zcen, cell_thickness=dz,
                cell_bottom_depth=zbot, latitude=lat, kmax=kmax)

    # hydrography: warm tropics, cold poles, cooling with depth
    sst = 28.0 * np.cos(np.deg2rad(lat)) ** 2 - 1.0
    temp = (sst[None, :] - (sst[None, :] - 2.0)
            * (1.0 - np.exp(-zcen / 80000.0)))
    salt = 34.0 + 1.5 * np.exp(-zcen / 50000.0) * np.cos(np.deg2rad(lat))

    depth_frac = zcen / zcen.max()
    surf_bio = np.exp(-zcen / 8000.0)                    # e-fold 80 m

    trc = np.zeros((nlev, T.CNT, ncol))
    trc[:, T.PO4] = 0.3 + 2.2 * depth_frac
    trc[:, T.NO3] = 4.0 + 28.0 * depth_frac
    trc[:, T.SIO3] = 3.0 + 120.0 * depth_frac
    trc[:, T.NH4] = 0.1 * surf_bio
    trc[:, T.FE] = 2e-4 + 5e-4 * depth_frac
    trc[:, T.O2] = 320.0 - 150.0 * np.exp(-(depth_frac - 0.15) ** 2 / 0.02)
    trc[:, T.DIC] = 1950.0 + 350.0 * depth_frac
    trc[:, T.DIC_ALT_CO2] = trc[:, T.DIC]
    trc[:, T.ALK] = 2300.0 + 100.0 * depth_frac
    trc[:, T.DOC] = 38.0 * surf_bio + 2.0
    trc[:, T.DON] = 2.5 * surf_bio + 0.2
    trc[:, T.DOFE] = 2e-5 * surf_bio
    trc[:, T.DOP] = 0.15 * surf_bio + 0.02
    trc[:, T.DOPR] = 0.03
    trc[:, T.DONR] = 1.2
    trc[:, T.ZOOC] = 0.6 * surf_bio
    bloom = 0.5 + 0.5 * np.cos(np.deg2rad(lat))[None, :]
    for g, amp in zip(range(4), (1.2, 1.0, 0.15, 0.4)):
        trc[:, T.CHL_IND[g]] = 0.25 * amp * bloom * surf_bio
        trc[:, T.C_IND[g]] = 1.5 * amp * bloom * surf_bio
        trc[:, T.FE_IND[g]] = 6e-6 * amp * bloom * surf_bio
    trc[:, T.DIATSI] = 0.3 * bloom * surf_bio
    trc[:, T.SPCACO3] = 0.08 * bloom * surf_bio

    forcing = dict(
        potential_temperature=temp,
        salinity=salt,
        dust_flux_in=1e-10 * (1.2 + np.sin(np.deg2rad(lat))),
        shortwave_surface=320.0 * np.maximum(np.cos(np.deg2rad(lat)), 0.05),
        surface_pressure=np.full(ncol, 1.0),
        ice_fraction=np.clip((np.abs(lat) - 65.0) / 10.0, 0.0, 0.9),
        wind_speed_squared_10m=(600.0
                                + 700.0 * np.abs(np.sin(np.deg2rad(lat))))
        ** 2,
        atm_co2=np.full(ncol, 415.0),
        atm_co2_alt=np.full(ncol, 284.0),
        surface_depth=np.zeros(ncol),
        sst=temp[0],
        sss=salt[0],
        fesedflux=1e-9 * np.exp(-(zbot - zbot[-1:]) ** 2 / 1e10),
        nutr_restore_rtau=np.zeros((nlev, ncol)),
        no3_clim=trc[:, T.NO3].copy(),
        po4_clim=trc[:, T.PO4].copy(),
        sio3_clim=trc[:, T.SIO3].copy(),
        deposition_flux=np.zeros((T.CNT, ncol)),
        river_flux=np.zeros((T.CNT, ncol)),
        seaice_flux=np.zeros((T.CNT, ncol)),
        gas_flux=np.zeros((T.CNT, ncol)),
    )

    state = dict(
        bgc=dict(tracers=trc,
                 ph_prev_3d=np.zeros((nlev, ncol)),
                 ph_prev_alt_3d=np.zeros((nlev, ncol)),
                 surface_ph=np.zeros(ncol),
                 surface_ph_alt=np.zeros(ncol)),
        dms=np.stack([np.full((nlev, ncol), 3e-3) * surf_bio,
                      np.full((nlev, ncol), 1e-2) * surf_bio], axis=1),
        macros=np.stack([np.full((nlev, ncol), 1.0) * surf_bio,
                         np.full((nlev, ncol), 0.5) * surf_bio,
                         np.full((nlev, ncol), 0.1) * surf_bio], axis=1),
    )
    return state, grid, forcing


def synthetic_world(
    nlev: int = 60,
    ncol: int = 1024,
    seed: int = 0,
    ragged: bool = True,
    dtype=torch.float64,
    device=None,
) -> Tuple[CoupledState, ColumnGrid, BGCForcing]:
    """The synthetic world as torch tensors of ``dtype`` (float64 is the
    reference contract, float32 the fast path) on ``device`` (CUDA unless
    the caller passes another)."""
    return world_from_numpy(
        *_synthetic_world_numpy(nlev=nlev, ncol=ncol, seed=seed,
                               ragged=ragged),
        device=device, dtype=dtype)
