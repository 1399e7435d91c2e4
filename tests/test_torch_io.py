"""The port's files against the JAX package's: NetCDF (the writer's bytes),
world files, forcing series, ``.npz`` checkpoints and history, TOML
configs, and the forcing series' interpolation.  Each file written by one
package is read by the other; inputs are made with numpy from a seed."""

import dataclasses

import numpy as np
import pytest
import torch

import ocean_bgc_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp

from ocean_bgc_tpu.io import model_io as jio
from ocean_bgc_tpu.io import netcdf3 as jnc
from ocean_bgc_tpu.models import forcing_series as jfs
from ocean_bgc_tpu.utils import checkpoint as jckpt
from ocean_bgc_tpu.utils import config as jconfig
from ocean_bgc_tpu.utils import history as jhist
from ocean_bgc_tpu.utils.synthetic import synthetic_world as jax_world

from ocean_bgc_tpu_torch.io import model_io as tio
from ocean_bgc_tpu_torch.io import netcdf3 as tnc
from ocean_bgc_tpu_torch.models import forcing_series as tfs
from ocean_bgc_tpu_torch.parallel.distributed import ColumnMesh
from ocean_bgc_tpu_torch.utils import checkpoint as tckpt
from ocean_bgc_tpu_torch.utils import config as tconfig
from ocean_bgc_tpu_torch.utils import history as thist
from ocean_bgc_tpu_torch.utils.bridge import world_from_numpy


def _np(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _assert_same(a, b):
    """Equal nested dicts of arrays, types included."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
        return
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def _world(nlev=4, ncol=8, seed=21):
    js, jg, jf = jax_world(nlev=nlev, ncol=ncol, seed=seed, ragged=True)
    return js, jg, jf, world_from_numpy(_np(js), _np(jg), _np(jf),
                                        device="cpu")


def test_netcdf3_writes_jax_bytes_and_reads_its_files(tmp_path):
    """The copied writer gives byte-identical files for a dataset with a
    record dimension, every classic type and attributes of each kind; each
    reader reads the other's file to the same arrays."""
    rng = np.random.default_rng(5)

    def dataset(mod):
        ds = mod.Dataset()
        ds.dims = {"time": 0, "nlev": 3, "ncol": 5, "name": 7}
        ds.record_dim = "time"
        ds.attrs = {"title": "cross check", "dt": 3600.0,
                    "step": np.int32(12), "levels": np.arange(3.0)}
        ds.variables = {
            "f8": mod.Variable(("nlev", "ncol"), rng.random((3, 5))),
            "f4": mod.Variable(("ncol",), rng.random(5).astype(np.float32),
                               {"units": "m"}),
            "i4": mod.Variable(("ncol",), np.arange(5, dtype=np.int32)),
            "i2": mod.Variable(("nlev",), np.arange(3, dtype=np.int16)),
            "b": mod.Variable(("ncol",), np.array([1, 0, 1, 1, 0], bool)),
            "s": mod.Variable(("name",), np.array(list("tracers"), "S1")),
            "rec": mod.Variable(("time", "ncol"), rng.random((4, 5))),
            "rec3": mod.Variable(("time", "nlev", "ncol"),
                                 rng.random((4, 3, 5)).astype(np.float32)),
        }
        return ds

    jnc.write(tmp_path / "j.nc", dataset(jnc))
    rng = np.random.default_rng(5)
    tnc.write(tmp_path / "t.nc", dataset(tnc))
    assert (tmp_path / "j.nc").read_bytes() == (tmp_path / "t.nc").read_bytes()
    a, b = jnc.read(tmp_path / "t.nc"), tnc.read(tmp_path / "j.nc")
    assert a.dims == b.dims and a.record_dim == b.record_dim == "time"
    for k in a.variables:
        assert a.variables[k].dims == b.variables[k].dims
        _assert_same(a.variables[k].data, b.variables[k].data)


def test_world_files_cross_between_packages(tmp_path):
    """A JAX world file loads into the port bitwise (``kmax`` int32); the
    port writes the same bytes back, and the JAX package reads the port's
    file; ``dtype`` casts the floating fields."""
    js, jg, jf, (ts, tg, tf) = _world()
    jio.save_world(str(tmp_path / "j.nc"), js, jg, jf,
                   attrs={"step": np.int32(3)})
    s, g, f = tio.load_world(str(tmp_path / "j.nc"), device="cpu")
    _assert_same(_np(s), _np(js))
    _assert_same(_np(g), {k: v.astype(np.int32) if k == "kmax" else v
                          for k, v in _np(jg).items()})
    _assert_same(_np(f), _np(jf))
    tio.save_world(str(tmp_path / "t.nc"), s, g, f,
                   attrs={"step": np.int32(3)})
    assert (tmp_path / "j.nc").read_bytes() == (tmp_path / "t.nc").read_bytes()
    back = jio.load_world(str(tmp_path / "t.nc"))
    for x, y in zip(back, (js, jg, jf)):
        for k, v in _np(y).items():
            if k != "kmax":
                _assert_same(_np(x)[k], v)
    s32, g32, _ = tio.load_world(str(tmp_path / "t.nc"),
                                 dtype=torch.float32, device="cpu")
    assert s32.bgc.tracers.dtype == torch.float32
    assert g32.kmax.dtype == torch.int32
    assert torch.equal(s32.bgc.tracers, s.bgc.tracers.float())


def test_checkpoints_cross_between_packages(tmp_path):
    """The ``.npz`` layout: a JAX checkpoint restores into the port bitwise
    with its step and types, and the reverse; an orbax directory raises;
    a JAX checkpoint restores onto two ranks (``mesh``) as their blocks,
    bitwise."""
    js, _, _, (ts, _, _) = _world()
    ts32 = type(ts)(**{
        "bgc": dataclasses.replace(ts.bgc, tracers=ts.bgc.tracers.float()),
        "dms": ts.dms, "macros": ts.macros})
    jpath = jckpt.save(str(tmp_path / "j"), js, step=5, use_orbax=False)
    s, n = tckpt.restore(jpath, device="cpu")
    assert n == 5
    _assert_same(_np(s), _np(js))
    path = tckpt.save(str(tmp_path / "t"), ts32, step=7)
    assert path.endswith(".npz")
    back, n = jckpt.restore(str(tmp_path / "t"))
    assert n == 7
    _assert_same(_np(back), _np(ts32))
    s, n = tckpt.restore(str(tmp_path / "t"), device="cpu")
    assert n == 7
    _assert_same(_np(s), _np(ts32))
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        tckpt.restore(str(tmp_path / "orbax"), device="cpu")
    whole, _ = tckpt.restore(jpath, device="cpu")
    ncol = whole.bgc.ncol
    for rank in range(2):
        mesh = ColumnMesh(rank=rank, world_size=2, device=torch.device("cpu"))
        block, n = tckpt.restore(jpath, mesh=mesh)
        cols = slice(rank * ncol // 2, (rank + 1) * ncol // 2)

        def cut(d):
            return {k: cut(v) if isinstance(v, dict) else v[..., cols]
                    for k, v in d.items()}

        assert n == 5
        _assert_same(_np(block), cut(_np(whole)))


def test_params_from_toml_matches_jax(tmp_path):
    """The same TOML gives the same parameters in both packages (per-day
    fields converted, lists as tuples), ``params_to_dict`` round-trips,
    and an unknown parameter or autotroph raises KeyError."""
    (tmp_path / "run.toml").write_text(
        "[bgc]\nparm_Fe_bioavail = 0.9\nlrest_no3 = true\n"
        "parm_scalelen_vals = [1.0, 3.0, 5.0, 9.0]\n"
        "[autotroph.sp]\nPCref_per_day = 6.0\n"
        "[autotroph.diat]\nkFe = 0.07\n"
        "[dms]\nk_S_B_per_day = 25.0\n")
    got = tconfig.params_from_toml(str(tmp_path / "run.toml"))
    want = jconfig.params_from_toml(str(tmp_path / "run.toml"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tconfig.params_from_dict(tconfig.params_to_dict(got)) == got
    assert tconfig.params_to_dict(got) == jconfig.params_to_dict(want)
    for bad in ({"bgc": {"no_such": 1.0}}, {"macros": {"x_per_day": 1.0}},
                {"autotroph": {"kelp": {"kFe": 1.0}}},
                {"autotroph": {"sp": {"no_such": 1.0}}}):
        with pytest.raises(KeyError):
            tconfig.params_from_dict(bad)
        with pytest.raises(KeyError):
            jconfig.params_from_dict(bad)


def _series(nrec=3, dtype=np.float64):
    """A forcing series whose records differ in every field."""
    records = []
    for r in range(nrec):
        _, _, jf = jax_world(nlev=4, ncol=6, seed=40 + r, ragged=True)
        records.append(jf)
    j = jfs.stack_forcings(records)
    if dtype != np.float64:
        j = type(j)(**{k: jnp.asarray(v, dtype) for k, v in _np(j).items()})
    t = tfs.BGCForcing(**{k: torch.tensor(v) for k, v in _np(j).items()})
    return j, t


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_forcing_at_and_record_match_jax(dtype):
    """``forcing_at`` (blend weight on the host) and ``forcing_record``
    give JAX's fields bitwise, at record points, between them and past
    both ends (clamped); ``stack_forcings`` stacks the records."""
    j, t = _series(dtype=dtype)
    for tf in (0.0, 0.25, 1.0, 1.7, 2.0, -3.0, 99.0):
        _assert_same(_np(tfs.forcing_at(t, tf)), _np(jfs.forcing_at(j, tf)))
    for r in range(3):
        _assert_same(_np(tfs.forcing_record(t, r)),
                     _np(jfs.forcing_record(j, r)))
    again = tfs.stack_forcings([tfs.forcing_record(t, r) for r in range(3)])
    _assert_same(_np(again), _np(t))


def test_forcing_series_files_cross_between_packages(tmp_path):
    """``save_forcing_series`` writes JAX's bytes, and each package loads
    the other's file with its record spacing."""
    j, t = _series()
    jfs.save_forcing_series(str(tmp_path / "j.nc"), j, record_dt=28800.0)
    tfs.save_forcing_series(str(tmp_path / "t.nc"), t, record_dt=28800.0)
    assert (tmp_path / "j.nc").read_bytes() == (tmp_path / "t.nc").read_bytes()
    got, dt = tfs.load_forcing_series(str(tmp_path / "j.nc"), device="cpu")
    assert dt == 28800.0
    _assert_same(_np(got), _np(j))
    got32, _ = tfs.load_forcing_series(str(tmp_path / "j.nc"),
                                       dtype=torch.float32, device="cpu")
    assert got32.sst.dtype == torch.float32


def test_history_files_cross_between_packages(tmp_path):
    """``write_history`` (.npz) and ``save_history_netcdf`` on the port's
    time averages: JAX's ``read_history`` reads the same means, count and
    metadata, and the NetCDF bytes equal JAX's for the same means."""
    rng = np.random.default_rng(9)
    diags = {"pco2surf": torch.tensor(rng.random(8)),
             "Jint_Ctot": torch.tensor(rng.random(8)),
             "photoC_TOT": torch.tensor(rng.random((4, 8))),
             "photoC": torch.tensor(rng.random((4, 4, 8)))}
    tavg = thist.TavgState.create(diags)
    for k in range(3):
        tavg = tavg.accumulate({n: v * (k + 1) for n, v in diags.items()})
    path = thist.write_history(str(tmp_path / "h"), tavg,
                               attrs={"dt": "3600.0", "step": "3"})
    means, count, meta = jhist.read_history(path)
    assert count == 3 and meta == thist.read_history(path)[2]
    assert meta["__attr__step"] == "3" and "__units__pco2surf" in meta
    for n, v in tavg.means().items():
        _assert_same(means[n], v.numpy())
    np.testing.assert_allclose(means["photoC"], 2.0 * diags["photoC"].numpy(),
                               rtol=1e-15)
    tio.save_history_netcdf(str(tmp_path / "t.nc"), tavg.means(), nlev=4,
                            ncol=8, count=3, attrs={"dt": 3600.0})
    jio.save_history_netcdf(str(tmp_path / "j.nc"),
                            {n: v.numpy() for n, v in tavg.means().items()},
                            nlev=4, ncol=8, count=3, attrs={"dt": 3600.0})
    assert (tmp_path / "j.nc").read_bytes() == (tmp_path / "t.nc").read_bytes()
    reset = tavg.reset()
    assert int(reset.count) == 0 and all(
        not v.any() for v in reset.sums.values())
