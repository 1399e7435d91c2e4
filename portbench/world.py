"""The benchmark's inputs, made from the seed: the ocean world, the forcing
records a traffic mix cycles, and the columns the check samples.

``synthetic_world`` gives the world of the port's
``ocean_bgc_tpu_torch/utils/synthetic.py::_synthetic_world_numpy`` bitwise
(a CPU test holds it so), but builds it on the device: every field of
that world is a level profile, a column profile, or the product of the
two, so the host works out only those one-dimensional profiles, in the
generator's own NumPy expressions and order, and the device broadcasts
and multiplies them (one IEEE rounding per operation on either side).
Its shelf and land shares are parameters, at the port's values by
default.  Nothing here imports the program: the world leaves as dicts of
tensors keyed by the program's container field names, and the harness
hands them to the program.
"""

from __future__ import annotations

import numpy as np
import torch

# the canonical BGC tracer slots (BGC_parms.F90:81-125)
(PO4, NO3, SIO3, NH4, FE, O2, DIC, DIC_ALT_CO2, ALK, DOC, DON, DOFE, DOP,
 DOPR, DONR, ZOOC) = range(16)
CHL_IND = (16, 20, 24, 27)
C_IND = (17, 21, 25, 28)
FE_IND = (18, 22, 26, 29)
DIATSI, SPCACO3 = 23, 19
NTRACER = 30

# the forcing fields a record replaces; the others are the base world's
RECORD_FIELDS = ("potential_temperature", "salinity", "sst", "sss",
                 "shortwave_surface", "wind_speed_squared_10m")


def synthetic_world(nlev: int = 60, ncol: int = 1024, seed: int = 0,
                    ragged: bool = True, shelf_share: float = 0.15,
                    land_share: float = 0.02, device="cpu"):
    """The world as (state, grid, forcing) dicts of float64 tensors (kmax
    int32) on ``device``: latitude-dependent hydrography, exponential
    biology profiles, 10 m cells at the surface thickening to ~250 m, and
    (``ragged``) a ``shelf_share`` of shelf columns and a ``land_share``
    of land ones."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)

    dz = np.geomspace(1000.0, 25000.0, nlev)             # cm, per level
    zbot = np.cumsum(dz)
    zcen = zbot - 0.5 * dz

    lat = np.linspace(-75.0, 75.0, ncol)
    kmax = np.full(ncol, nlev, dtype=np.int32)
    if ragged:
        shelf = rng.random(ncol) < shelf_share
        kmax[shelf] = rng.integers(min(5, nlev), nlev + 1, shelf.sum())
        land = rng.random(ncol) < land_share
        kmax[land] = 0

    def on(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def levels(profile):
        """A level profile (or a constant) in every column, (nlev, ncol)."""
        p = np.asarray(profile, dtype=np.float64)
        p = on(np.full(nlev, p) if p.ndim == 0 else p)
        return p[:, None].expand(nlev, ncol).contiguous()

    def outer(profile, per_column):
        """profile[k] * per_column[c], (nlev, ncol)."""
        return on(profile)[:, None] * on(per_column)[None, :]

    grid = dict(cell_center_depth=levels(zcen), cell_thickness=levels(dz),
                cell_bottom_depth=levels(zbot), latitude=on(lat),
                kmax=on(kmax))

    coslat = np.cos(np.deg2rad(lat))
    sst = 28.0 * coslat ** 2 - 1.0
    warm = on(sst)[None, :]
    temp = warm - (warm - 2.0) * on(1.0 - np.exp(-zcen / 80000.0))[:, None]
    salt = outer(1.5 * np.exp(-zcen / 50000.0), coslat) + 34.0

    depth_frac = zcen / zcen.max()
    surf_bio = np.exp(-zcen / 8000.0)                    # e-fold 80 m

    profiles = {
        PO4: 0.3 + 2.2 * depth_frac,
        NO3: 4.0 + 28.0 * depth_frac,
        SIO3: 3.0 + 120.0 * depth_frac,
        NH4: 0.1 * surf_bio,
        FE: 2e-4 + 5e-4 * depth_frac,
        O2: 320.0 - 150.0 * np.exp(-(depth_frac - 0.15) ** 2 / 0.02),
        DIC: 1950.0 + 350.0 * depth_frac,
        ALK: 2300.0 + 100.0 * depth_frac,
        DOC: 38.0 * surf_bio + 2.0,
        DON: 2.5 * surf_bio + 0.2,
        DOFE: 2e-5 * surf_bio,
        DOP: 0.15 * surf_bio + 0.02,
        DOPR: 0.03,
        DONR: 1.2,
        ZOOC: 0.6 * surf_bio,
    }
    profiles[DIC_ALT_CO2] = profiles[DIC]
    bloom = 0.5 + 0.5 * coslat
    blooms = {DIATSI: 0.3 * bloom, SPCACO3: 0.08 * bloom}
    for g, amp in zip(range(4), (1.2, 1.0, 0.15, 0.4)):
        blooms[CHL_IND[g]] = 0.25 * amp * bloom
        blooms[C_IND[g]] = 1.5 * amp * bloom
        blooms[FE_IND[g]] = 6e-6 * amp * bloom
    trc = torch.empty((nlev, NTRACER, ncol), dtype=torch.float64, device=dev)
    for i in range(NTRACER):
        trc[:, i] = (levels(profiles[i]) if i in profiles
                     else outer(surf_bio, blooms[i]))

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float64, device=dev)

    forcing = dict(
        potential_temperature=temp,
        salinity=salt,
        dust_flux_in=on(1e-10 * (1.2 + np.sin(np.deg2rad(lat)))),
        shortwave_surface=on(320.0 * np.maximum(coslat, 0.05)),
        surface_pressure=on(np.full(ncol, 1.0)),
        ice_fraction=on(np.clip((np.abs(lat) - 65.0) / 10.0, 0.0, 0.9)),
        wind_speed_squared_10m=on((600.0 + 700.0
                                   * np.abs(np.sin(np.deg2rad(lat)))) ** 2),
        atm_co2=on(np.full(ncol, 415.0)),
        atm_co2_alt=on(np.full(ncol, 284.0)),
        surface_depth=zeros(ncol),
        sst=temp[0].clone(),
        sss=salt[0].clone(),
        fesedflux=levels(1e-9 * np.exp(-(zbot - zbot[-1]) ** 2 / 1e10)),
        nutr_restore_rtau=zeros(nlev, ncol),
        no3_clim=trc[:, NO3].clone(),
        po4_clim=trc[:, PO4].clone(),
        sio3_clim=trc[:, SIO3].clone(),
        deposition_flux=zeros(NTRACER, ncol),
        river_flux=zeros(NTRACER, ncol),
        seaice_flux=zeros(NTRACER, ncol),
        gas_flux=zeros(NTRACER, ncol),
    )

    state = dict(
        bgc=dict(tracers=trc,
                 ph_prev_3d=zeros(nlev, ncol),
                 ph_prev_alt_3d=zeros(nlev, ncol),
                 surface_ph=zeros(ncol),
                 surface_ph_alt=zeros(ncol)),
        dms=torch.stack([levels(3e-3 * surf_bio), levels(1e-2 * surf_bio)],
                        dim=1),
        macros=torch.stack([levels(1.0 * surf_bio), levels(0.5 * surf_bio),
                            levels(0.1 * surf_bio)], dim=1),
    )
    return state, grid, forcing


def columns_numpy(tree, idx: torch.Tensor):
    """Every tensor of a (nested) dict with its last axis cut to the
    columns ``idx``, as float64 (kmax: int32) NumPy arrays on the host."""
    if isinstance(tree, dict):
        return {k: columns_numpy(v, idx) for k, v in tree.items()}
    t = tree.index_select(-1, idx.to(tree.device)).cpu()
    return (t.to(torch.float64) if t.is_floating_point() else t).numpy()


def seed_words(seed: int, stream: int):
    """Entropy for NumPy's SeedSequence: a non-negative seed of any size
    and a stream number, so that each input has a stream of its own."""
    return [int(seed) % (1 << 64), stream]


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` from the run's seed and a
    stream number."""
    return int(np.random.SeedSequence(seed_words(seed, stream))
               .generate_state(1, dtype=np.uint64)[0]) >> 1


def make_records(forcing: dict, cell_center_depth: torch.Tensor,
                 mix: dict, seed: int):
    """The traffic's forcing records on the forcing's device, float64:
    ``mix["records"]`` small seeded perturbations of the base world's
    hydrography and surface forcing (``mix["perturb"]``): per column a
    normal draw scaled by the amplitudes, the hydrography's fading with
    depth over ``efold_cm``, the surface fluxes' relative and floored at
    0.  ``forcing`` maps the record fields to (nlev, ncol) or (ncol,)
    tensors.  Made in a few large calls from a generator on the device."""
    p = mix["perturb"]
    t0 = forcing["potential_temperature"]
    gen = torch.Generator(device=t0.device)
    gen.manual_seed(torch_seed(seed, 1))
    k, ncol = int(mix["records"]), t0.shape[-1]
    draws = torch.randn((k, 4, ncol), generator=gen, dtype=torch.float64,
                        device=t0.device)
    fade = torch.exp(-cell_center_depth.to(torch.float64)
                     / float(p["efold_cm"]))
    records = []
    for d in draws:
        temp = t0 + float(p["temperature_C"]) * d[0] * fade
        salt = (forcing["salinity"]
                + float(p["salinity_psu"]) * d[1] * fade)
        records.append(dict(
            potential_temperature=temp, salinity=salt,
            sst=temp[0].clone(), sss=salt[0].clone(),
            shortwave_surface=(forcing["shortwave_surface"]
                               * (1.0 + float(p["shortwave_rel"]) * d[2])
                               ).clamp_min(0.0),
            wind_speed_squared_10m=(forcing["wind_speed_squared_10m"]
                                    * (1.0 + float(p["wind2_rel"]) * d[3])
                                    ).clamp_min(0.0)))
    return records


def record_of(step: int, mix: dict) -> int:
    """Which record the traffic's step ``step`` (from 0, warm-up steps
    included) reads: each held ``hold_steps`` steps, cycled."""
    return (step // int(mix["hold_steps"])) % int(mix["records"])


def sample_columns(ncol: int, n: int, seed: int) -> np.ndarray:
    """``n`` columns drawn from the seed, one from each of ``n`` equal
    blocks of the column range, so that every part of the range (each
    half of it, say) is sampled."""
    rng = np.random.default_rng(seed_words(seed, 2))
    edges = np.linspace(0, ncol, n + 1).astype(np.int64)
    return np.array([rng.integers(lo, hi) for lo, hi in
                     zip(edges[:-1], edges[1:])], dtype=np.int64)
