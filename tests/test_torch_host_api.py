"""The port's host-coupling API against the JAX package's, on the CPU.

Each of the nine entry points at 6 columns x 8 levels, the same host
arrays (made from a numpy seed) through ``ocean_bgc_tpu.host_api`` and
``ocean_bgc_tpu_torch.host_api(device="cpu")``: one JAX call per entry
point (the cold and the warm ``BGC_SourceSink`` share one jit).  pH is
held to the solver's tolerance (|dH| <= 2 xacc), every other output to
1e-9 of its field's largest magnitude (the conservation residuals to
their top-100 m budget's, as tests/test_torch_diags.py holds them).  The
tracer-order adapter, ``diag_names`` and an f32 host block are held
bitwise to the port's canonical run; the metadata and the parameter
defaults exactly to JAX's.  This file holds the BGC pair;
``tests/test_torch_host_api_dms.py`` runs the same tests on the DMS and
MACROS entry points, ``tests/test_torch_host_api_layout.py`` holds
``tracer_permutation``'s errors and the host-layout copy.  The card runs
the same entry points in tests/test_torch_cuda.py and chip_smoke.py."""

import dataclasses

import numpy as np
import pytest
import torch

import ocean_bgc_tpu  # noqa: F401  (enables x64)
from ocean_bgc_tpu import host_api as japi

from ocean_bgc_tpu_torch import host_api as api
from ocean_bgc_tpu_torch import state as tstate
from ocean_bgc_tpu_torch.constants import XACC
from ocean_bgc_tpu_torch.ops import cuda_carbonate as cc
from ocean_bgc_tpu_torch.state import (
    BGC_TRACER_NAMES,
    DMS_TRACER_NAMES,
    MACROS_TRACER_NAMES,
    BGCTracers as BT,
)

NCOL, NLEV = 6, 8
ENTRY_POINTS = ("BGC_SourceSink", "BGC_SurfaceFluxes", "DMS_SourceSink",
                "DMS_SurfaceFluxes", "MACROS_SourceSink")
# the entry points held here; tests/test_torch_host_api_dms.py holds the
# rest with the same tests
BGC_PAIR = ENTRY_POINTS[:2]
# conservation residuals, zero up to rounding: held on their budget's scale
RESIDUALS = {f"Jint_{x}tot": f"Jint_100m_{x}tot" for x in ("C", "N", "P",
                                                           "Si")}
# the fields holding a pH, held by |dH| <= 2 xacc
PH_FIELDS = ("PH_PREV_3D", "PH_PREV_ALT_CO2_3D", "surface_pH",
             "surface_pH_alt_co2", "pH_3D", "pH_3D_ALT_CO2")


def _host_calls(seed=20260817):
    """Keyword arguments of every entry point in the host's layout:
    ``{entry point: kwargs}``, a ragged world with a land column."""
    rng = np.random.default_rng(seed)
    dz = rng.uniform(500.0, 4000.0, (NCOL, NLEV))
    zbot = np.cumsum(dz, axis=1)
    trc = rng.uniform(0.0, 3.0, (NCOL, NLEV, 30))
    trc[..., BT.DIC] = rng.uniform(1800, 2400, (NCOL, NLEV))
    trc[..., BT.DIC_ALT_CO2] = rng.uniform(1800, 2400, (NCOL, NLEV))
    trc[..., BT.ALK] = rng.uniform(2000, 2500, (NCOL, NLEV))
    trc[..., BT.O2] = rng.uniform(0, 350, (NCOL, NLEV))
    kmax = rng.integers(1, NLEV + 1, NCOL).astype(np.int32)
    kmax[0] = 0
    kmax[1] = NLEV
    sst = rng.uniform(-1, 29, NCOL)
    sw = rng.uniform(0, 300, NCOL)

    def lev(lo, hi):
        return rng.uniform(lo, hi, (NCOL, NLEV))

    def col(lo, hi):
        return rng.uniform(lo, hi, NCOL)

    dms = rng.uniform(0, 1, (NCOL, NLEV, 14))
    return {
        "BGC_SourceSink": dict(
            BGC_tracers=trc, PotentialTemperature=lev(-1, 30),
            Salinity=lev(32, 36), cell_center_depth=zbot - 0.5 * dz,
            cell_thickness=dz, cell_bottom_depth=zbot,
            cell_latitude=col(-70, 70), number_of_active_levels=kmax,
            dust_FLUX_IN=col(0, 1e-9), ShortWaveFlux_surface=sw,
            FESEDFLUX=lev(0, 1e-6), NUTR_RESTORE_RTAU=lev(0, 1e-7),
            NO3_CLIM=lev(0, 30), PO4_CLIM=lev(0, 2), SiO3_CLIM=lev(0, 60)),
        "BGC_SurfaceFluxes": dict(
            BGC_tracers=trc, SST=sst, SSS=col(32, 37),
            surfacePressure=col(0.95, 1.05), iceFraction=col(0, 0.5),
            windSpeedSquared10m=col(0, 2e6), atmCO2=np.full(NCOL, 415.0),
            atmCO2_ALT_CO2=np.full(NCOL, 284.0), surfaceDepth=col(0, 5),
            depositionFlux=rng.uniform(0, 1e-6, (NCOL, 30)),
            riverFlux=rng.uniform(0, 1e-6, (NCOL, 30)),
            gasFlux=rng.uniform(0, 1e-7, (NCOL, 30)),
            seaIceFlux=rng.uniform(0, 1e-7, (NCOL, 30))),
        "DMS_SourceSink": dict(
            DMS_tracers=dms, cell_thickness=dz, number_of_active_levels=kmax,
            SST=sst, ShortWaveFlux_surface=sw),
        "DMS_SurfaceFluxes": dict(
            DMS_tracers=dms, SST=sst, SSS=col(32, 37),
            iceFraction=col(0, 0.5), windSpeedSquared10m=col(0, 2e6),
            surfacePressure=col(0.95, 1.05)),
        "MACROS_SourceSink": dict(
            MACROS_tracers=rng.uniform(0, 2, (NCOL, NLEV, 8)),
            number_of_active_levels=kmax),
    }


def _warm(name, kw, cold):
    """``kw`` with the warm starts of a previous call's results."""
    if name == "BGC_SourceSink":
        return dict(kw, PH_PREV_3D=cold["PH_PREV_3D"],
                    PH_PREV_ALT_CO2_3D=cold["PH_PREV_ALT_CO2_3D"])
    return dict(kw, surface_pH=cold["surface_pH"],
                surface_pH_alt_co2=cold["surface_pH_alt_co2"])


def entry_calls(names):
    """The entry points ``names`` through JAX and the port on the same
    host arrays (``"kw"`` holds every entry point's); the two BGC ones
    cold and warm (the warm call fed its own package's returned pH)."""
    kws = _host_calls()
    out = {"kw": kws, "jax": {}, "port": {}}
    before = (cc.co3_terms_dual_coeffs.launches,
              cc.carbonate_coeffs_sat.launches,
              cc.solve_htotal_brackets.launches)
    for name in names:
        kw = kws[name]
        j = getattr(japi, name)(**kw)
        p = getattr(api, name)(**kw, device="cpu")
        out["jax"][name], out["port"][name] = j, p
        if name in ("BGC_SourceSink", "BGC_SurfaceFluxes"):
            out["jax"][name + " warm"] = getattr(japi, name)(
                **_warm(name, kw, j))
            out["port"][name + " warm"] = getattr(api, name)(
                **_warm(name, kw, p), device="cpu")
    # CPU tensors: every solve took its plain version
    assert (cc.co3_terms_dual_coeffs.launches,
            cc.carbonate_coeffs_sat.launches,
            cc.solve_htotal_brackets.launches) == before
    return out


@pytest.fixture(scope="module")
def calls():
    """:func:`entry_calls` of the BGC pair."""
    return entry_calls(BGC_PAIR)


@pytest.fixture(params=BGC_PAIR)
def name(request):
    """Each entry point of the BGC pair."""
    return request.param


def _assert_close(want, got, label, scale_of=None):
    """``got`` (the port's result dict) against ``want`` (JAX's): the same
    keys, shapes and types; pH by |dH| <= 2 xacc where a pH is set, every
    other array within 1e-9 of its scale (per tracer for a tracer block)."""
    assert set(got) == set(want), label
    for k, a in want.items():
        b = got[k]
        if isinstance(a, dict):
            _assert_close(a, b, f"{label}.{k}", scale_of=a)
            continue
        a = np.asarray(a)
        assert isinstance(b, np.ndarray), (label, k)
        assert b.shape == a.shape and b.dtype == a.dtype, (label, k)
        if k in PH_FIELDS:
            assert np.array_equal(a == 0.0, b == 0.0), (label, k)
            dh = np.abs(10.0 ** -a - 10.0 ** -b)
            assert (dh[a != 0.0] <= 2 * XACC).all(), (label, k)
            continue
        budget = RESIDUALS.get(k)
        ref = np.asarray(scale_of[budget] if budget and scale_of else a)
        if a.ndim == 3 or k == "netFlux":     # per tracer
            scale = np.abs(ref).reshape(-1, a.shape[-1]).max(axis=0)
        else:
            scale = np.abs(ref).max()
        err = np.abs(a - b) / (scale + 1e-300)
        assert (err <= 1e-9).all(), (label, k, err.max())


def test_entry_point_matches_jax(calls, name):
    """Each entry point's results against JAX's: keys, host layouts,
    types and values; the BGC pair cold and warm."""
    for key in (name, name + " warm"):
        if key in calls["jax"]:
            _assert_close(calls["jax"][key], calls["port"][key], key)
    if name == "BGC_SourceSink":
        kmax = calls["kw"][name]["number_of_active_levels"]
        tend = calls["port"][name]["BGC_tendencies"]
        for c in range(NCOL):       # padded levels are zero per column
            assert (tend[c, kmax[c]:] == 0.0).all()


def _permuted(names, rng):
    """A host tracer order: (indices map, perm) with the host keeping
    canonical tracer c at position perm[c]."""
    perm = rng.permutation(len(names))
    return {n: int(perm[c]) for c, n in enumerate(names)}, perm


def _to_host_order(a, perm):
    out = np.empty_like(a)
    out[..., perm] = a
    return out


def test_tracer_order_adapter_bitwise(calls, name):
    """A host keeping its own tracer order (the reference's indices
    structs) gets bitwise the canonical results, in its order."""
    names = {"BGC": BGC_TRACER_NAMES, "DMS": DMS_TRACER_NAMES,
             "MACROS": MACROS_TRACER_NAMES}[name.split("_")[0]]
    indices, perm = _permuted(names, np.random.default_rng(len(name)))
    kw = dict(calls["kw"][name])
    for k in ("BGC_tracers", "DMS_tracers", "MACROS_tracers",
              "depositionFlux", "riverFlux", "gasFlux", "seaIceFlux"):
        if k in kw:
            kw[k] = _to_host_order(kw[k], perm)
    got = getattr(api, name)(**kw, indices=indices, device="cpu")
    want = calls["port"][name]
    for k, v in want.items():
        if k.endswith("tendencies") or k == "netFlux":
            v = _to_host_order(v, perm)
        if k == "diags":
            assert got[k].keys() == v.keys()
            assert all(np.array_equal(got[k][d], v[d]) for d in v), k
        else:
            assert np.array_equal(got[k], v), k


def test_diag_names_keeps_the_full_runs_values(calls):
    """``diag_names`` returns exactly the requested diagnostics, bitwise
    the full run's, and the same tendencies; an unknown name raises."""
    kw = calls["kw"]["BGC_SourceSink"]
    full = calls["port"]["BGC_SourceSink"]
    names = ("NITRIF", "POC_FLUX_IN", "pH_3D", "zsatcalc")
    got = api.BGC_SourceSink(**kw, diag_names=names, device="cpu")
    assert tuple(got["diags"]) == names
    for k in names:
        assert np.array_equal(got["diags"][k], full["diags"][k]), k
    for k in ("BGC_tendencies", "PH_PREV_3D", "PH_PREV_ALT_CO2_3D"):
        assert np.array_equal(got[k], full[k]), k
    with pytest.raises(KeyError, match="unknown diagnostics"):
        api.BGC_SourceSink(**kw, diag_names=("NITRIF", "nope"),
                           device="cpu")


def test_f32_host_blocks_are_widened_exactly(calls):
    """A host passing f32 tracer blocks gets bitwise the results of the
    same values passed as f64 (the API computes in f64)."""
    kw = dict(calls["kw"]["BGC_SourceSink"])
    kw32 = dict(kw, BGC_tracers=kw["BGC_tracers"].astype(np.float32))
    kw64 = dict(kw, BGC_tracers=kw32["BGC_tracers"].astype(np.float64))
    a = api.BGC_SourceSink(**kw32, device="cpu")
    b = api.BGC_SourceSink(**kw64, device="cpu")
    assert a["BGC_tendencies"].dtype == np.float64
    assert np.array_equal(a["BGC_tendencies"], b["BGC_tendencies"])
    assert all(np.array_equal(a["diags"][k], b["diags"][k])
               for k in b["diags"])
    dkw = dict(calls["kw"]["DMS_SourceSink"])
    d32 = dkw["DMS_tracers"].astype(np.float32)
    a = api.DMS_SourceSink(**dict(dkw, DMS_tracers=d32), device="cpu")
    b = api.DMS_SourceSink(**dict(dkw, DMS_tracers=d32.astype(np.float64)),
                           device="cpu")
    assert np.array_equal(a["DMS_tendencies"], b["DMS_tendencies"])


def test_metadata_and_parameter_defaults_match_jax():
    """The init pairs: metadata and defaults exactly JAX's, overrides
    applied."""
    assert (api.BGC_tracer_cnt, api.DMS_tracer_cnt,
            api.MACROS_tracer_cnt) == (30, 14, 8)
    assert (api.BGC_tracer_cnt, api.DMS_tracer_cnt, api.MACROS_tracer_cnt
            ) == (japi.BGC_tracer_cnt, japi.DMS_tracer_cnt,
                  japi.MACROS_tracer_cnt)
    for fn in ("bgc_init", "dms_init", "macros_init"):
        assert tuple(getattr(api, fn)()) == tuple(getattr(japi, fn)()), fn
        assert getattr(api, fn)()._fields == getattr(japi, fn)()._fields
    for fn in ("bgc_parms_init", "dms_parms_init", "macros_parms_init"):
        assert (dataclasses.asdict(getattr(api, fn)())
                == dataclasses.asdict(getattr(japi, fn)())), fn
    assert api.bgc_parms_init(parm_Fe_bioavail=0.5).parm_Fe_bioavail == 0.5
    assert api.dms_parms_init() == api.dms_parms_init()


def test_entry_points_default_to_cuda(calls):
    """Without ``device`` an entry point asks for CUDA, and raises where
    there is none (the card runs it in tests/test_torch_cuda.py)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.MACROS_SourceSink(**calls["kw"]["MACROS_SourceSink"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstate.zeros_state(2, 3)


