"""Two real ranks: the port's multi-device layer on a two-rank Gloo group
on the CPU, launched once under ``python -m torch.distributed.run`` with
this file as the rank script (:func:`rank_main`, which imports no JAX).

Each rank steps its block of a 6 x 16 ragged world (f64 and f32) through
``make_sharded_step`` (diagnostics, health and ``local_diags``; the fused
production step) and ``make_sharded_forced_run``, writes its blocks as
history shards, saves and restores checkpoint shards across rank counts,
and runs ``run_model --sharded``, once with shard history and once with
NetCDF history and a world file, which rank 0 alone writes from the
gathered blocks.  The tests hold the stitched results to
the port's unsharded step (which ``tests/test_torch_step.py`` holds to
JAX) within 1e-12 (f64) / 1e-5 (f32) of each field's scale, the global
sums to the sums of JAX's unsharded diagnostics, the health counts
exactly, and the collective counts to one ``all_reduce`` per step with
diagnostics or health and none otherwise.  Torch's CPU kernels may round
a vectorised tail apart from the body, so blocks of another width agree
to tolerance, not bitwise.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:         # run as a script by the launcher
    sys.path.insert(0, REPO)

from ocean_bgc_tpu_torch import run_model  # noqa: E402
from ocean_bgc_tpu_torch.models.coupled import step  # noqa: E402
from ocean_bgc_tpu_torch.models.forcing_series import (  # noqa: E402
    run_forced,
    stack_forcings,
)
from ocean_bgc_tpu_torch.params import ModelParams  # noqa: E402
from ocean_bgc_tpu_torch.parallel import distributed as dist  # noqa: E402
from ocean_bgc_tpu_torch.parallel.sharding import (  # noqa: E402
    GLOBAL_SUM_DIAGS,
    HEALTH_DIAGS,
    all_reduce_sum,
    make_mesh,
    make_sharded_forced_run,
    make_sharded_step,
    shard_columns,
    shard_world,
)
from ocean_bgc_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from ocean_bgc_tpu_torch.utils.history import (  # noqa: E402
    stitch_history_shards,
    write_history_shards,
)
from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world  # noqa: E402
from ocean_bgc_tpu_torch.utils.profiling import counters  # noqa: E402

NLEV, NCOL, RANKS, DT = 6, 16, 2, 3600.0
LOCAL = ("pco2surf", "NITRIF", "POC_FLUX_IN", "health_poc_error_cells")
DTYPES = {"float64": torch.float64, "float32": torch.float32}
TOL = {"float64": 1e-12, "float32": 1e-5}
# run_model's flags, sharded over the ranks and then at one process
RM_ARGS = ("--nlev", str(NLEV), "--ncol", str(NCOL), "--seed", "3",
           "--health", "--history-every", "2", "--history-fields",
           "pco2surf,NITRIF,POC_FLUX_IN", "--checkpoint-every", "2",
           "--device", "cpu", "--quiet")
# the run that writes NetCDF history and the world file
NC_ARGS = ("--steps", "2", "--netcdf-history")


def _world(dtype=torch.float64):
    return synthetic_world(nlev=NLEV, ncol=NCOL, seed=21, dtype=dtype,
                           device="cpu")


def _series(forcing):
    """Three forcing records: T +0, +0.5, -0.5 C."""
    return stack_forcings([dataclasses.replace(
        forcing, potential_temperature=forcing.potential_temperature + d)
        for d in (0.0, 0.5, -0.5)])


def _fields(state):
    b = state.bgc
    return dict(tracers=b.tracers, ph_prev_3d=b.ph_prev_3d,
                ph_prev_alt_3d=b.ph_prev_alt_3d, surface_ph=b.surface_ph,
                surface_ph_alt=b.surface_ph_alt, dms=state.dms,
                macros=state.macros)


def rank_main(out):
    """One rank's scenarios, every one in this launch (Gloo, the
    launcher's environment)."""
    dist.initialize(device="cpu")
    mesh = make_mesh()
    params = ModelParams()
    calls = {}

    def counted(label, fn, *args):
        before = counters()["collectives.all_reduce"]
        result = fn(*args)
        calls[label] = counters()["collectives.all_reduce"] - before
        return result

    for name, dtype in DTYPES.items():
        state, grid, forcing = shard_world(*_world(dtype), mesh)
        fn = make_sharded_step(mesh, params, DT, compute_diags=True,
                               health=True, local_diags=LOCAL)
        new, gsum, local = counted(f"diags_{name}", fn, state, grid, forcing)
        write_history_shards(os.path.join(out, f"step_{name}"), {
            **_fields(new), **local,
            **{f"global_{k}": v for k, v in gsum.items()}}, mesh=mesh)
        if name == "float64":
            ckpt.save(os.path.join(out, "ck2"), new, step=1, mesh=mesh)
        fused = make_sharded_step(mesh, params, DT, nsteps=2,
                                  interior_impl="fused")
        new, gsum = counted(f"fused_{name}", fused, state, grid, forcing)
        assert gsum == {}
        write_history_shards(os.path.join(out, f"fused_{name}"),
                             _fields(new), mesh=mesh)

    state, grid, forcing = _world()
    series = shard_columns(_series(forcing), mesh, NCOL)
    state, grid, forcing = shard_world(state, grid, forcing, mesh)
    forced = make_sharded_forced_run(mesh, params, DT, 3, 2 * DT,
                                     interp="hold")
    new = counted("forced", forced, state, grid, series)
    write_history_shards(os.path.join(out, "forced"), _fields(new),
                         mesh=mesh)

    for src in ("ck4", "whole.npz"):
        got, n = ckpt.restore(os.path.join(out, src), mesh=mesh)
        assert n == 1
        write_history_shards(os.path.join(out, f"restored_{src}"),
                             _fields(got), mesh=mesh)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_model.main(["--sharded", *RM_ARGS, "--steps", "4", "--out",
                        os.path.join(out, "rm")])
    # one file of every column: each rank is given its own directory, so
    # that what each writes shows
    nc_out = os.path.join(out, f"rm_nc_p{mesh.rank}")
    nc_buf = io.StringIO()
    with contextlib.redirect_stdout(nc_buf):
        run_model.main(["--sharded", *RM_ARGS, *NC_ARGS, "--save-world",
                        os.path.join(nc_out, "world.nc"), "--out", nc_out])
    with open(os.path.join(out, f"rank{mesh.rank}.json"), "w") as f:
        json.dump({"calls": calls, "stdout": buf.getvalue(),
                   "stdout_nc": nc_buf.getvalue(),
                   "world_size": mesh.world_size}, f)
    dist.shutdown()


def _unsharded(dtype):
    """The port's unsharded step with diagnostics and health, and two
    fused steps, on the whole world."""
    params = ModelParams()
    state, grid, forcing = _world(dtype)
    new, diags = step(state, grid, forcing, params, DT, health=True)
    fused = state
    for _ in range(2):
        fused, _ = step(fused, grid, forcing, params, DT,
                        compute_diags=False, interior_impl="fused")
    return new, diags, fused


def _close(got, want, tol, label):
    """Each field within ``tol`` of its scale (per tracer for the tracer
    block)."""
    for k, w in want.items():
        w = w.detach().numpy() if isinstance(w, torch.Tensor) else w
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, (label, k)
        axes = (0, 2) if k == "tracers" else None
        scale = np.abs(w.astype(np.float64)).max(axis=axes, keepdims=True)
        err = np.abs(g.astype(np.float64) - w) / (scale + 1e-300)
        assert err.max() <= tol, (label, k, err.max())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Launch the two ranks once; their output directory."""
    out = str(tmp_path_factory.mktemp("ranks"))
    state, _, _ = _unsharded(torch.float64)
    ckpt.save(os.path.join(out, "whole"), state, step=1)
    for r in range(4):
        mesh = dist.ColumnMesh(rank=r, world_size=4,
                               device=torch.device("cpu"))
        ckpt.save(os.path.join(out, "ck4"), shard_world(
            state, *_world()[1:], mesh)[0], step=1, mesh=mesh)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(RANKS), os.path.abspath(__file__), out],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return out


@pytest.mark.parametrize("name", list(DTYPES))
def test_two_ranks_stitch_to_the_unsharded_step(ranks, name):
    """The stitched state, the local diagnostics, the global sums and
    the health totals of the sharded step with diagnostics, and two
    sharded fused steps, against the unsharded step's."""
    tol = TOL[name]
    new, diags, fused = _unsharded(DTYPES[name])
    got = stitch_history_shards(os.path.join(ranks, f"step_{name}"))
    _close(got, _fields(new), tol, "step")
    _close(got, {k: diags[k] for k in LOCAL if k not in HEALTH_DIAGS}, tol,
           "local")
    for k in HEALTH_DIAGS:
        assert got[f"global_{k}"] == diags[k].numpy(), k
    assert got["health_poc_error_cells"] == diags[
        "health_poc_error_cells"].numpy()
    for k in GLOBAL_SUM_DIAGS:
        ref = diags[k.replace("Jint_", "Jint_100m_")].abs().sum()
        err = abs(float(got[f"global_{k}"]) - float(diags[k].sum()))
        assert err <= tol * float(ref), (k, err, float(ref))
    _close(stitch_history_shards(os.path.join(ranks, f"fused_{name}")),
           _fields(fused), tol, "fused")


def test_global_sums_match_jax(ranks):
    """The two ranks' global sums against the sums of JAX's unsharded
    ``step(..., compute_diags=True, health=True)`` diagnostics on the
    same world, within 1e-11 of the summed budget (a conservation
    residual's: its top-100 m budget's); the health totals exactly."""
    import ocean_bgc_tpu  # noqa: F401  (enables x64)
    import jax

    from ocean_bgc_tpu.models.coupled import step as jax_step
    from ocean_bgc_tpu.params import ModelParams as JaxParams
    from ocean_bgc_tpu.utils.synthetic import synthetic_world as jax_world

    js, jg, jf = jax_world(nlev=NLEV, ncol=NCOL, seed=21)
    jp = JaxParams()
    _, jd = jax.jit(lambda s: jax_step(s, jg, jf, jp, DT,
                                       compute_diags=True,
                                       health=True))(js)
    got = stitch_history_shards(os.path.join(ranks, "step_float64"))
    for k in GLOBAL_SUM_DIAGS:
        want = float(np.asarray(jd[k]).sum())
        ref = np.abs(np.asarray(jd[k.replace("Jint_", "Jint_100m_")])).sum()
        err = abs(float(got[f"global_{k}"]) - want)
        assert err <= 1e-11 * ref, (k, err, ref)
    for k in HEALTH_DIAGS:
        assert float(got[f"global_{k}"]) == float(jd[k]), k


def test_collectives_per_configuration(ranks):
    """Per rank: one stacked all_reduce in the step with diagnostics and
    health, none in two fused production steps or in the forced run."""
    for r in range(RANKS):
        with open(os.path.join(ranks, f"rank{r}.json")) as f:
            rec = json.load(f)
        assert rec["world_size"] == RANKS
        assert rec["calls"] == {"diags_float64": 1, "fused_float64": 0,
                                "diags_float32": 1, "fused_float32": 0,
                                "forced": 0}, r


def test_forced_run_and_checkpoints_across_rank_counts(ranks):
    """The forced run of two ranks against the unsharded one; the
    two ranks' checkpoint restored at one process is their stitched
    state bitwise (N -> 1); the ranks' blocks of a 4-rank checkpoint and
    of the single file are the saved state bitwise (N -> M, 1 -> M)."""
    state, grid, forcing = _world()
    want, _ = run_forced(state, grid, _series(forcing), ModelParams(), DT,
                         3, 2 * DT, interp="hold")
    _close(stitch_history_shards(os.path.join(ranks, "forced")),
           _fields(want), TOL["float64"], "forced")

    restored, n = ckpt.restore(os.path.join(ranks, "ck2"), device="cpu")
    stitched = stitch_history_shards(os.path.join(ranks, "step_float64"))
    assert n == 1
    for k, v in _fields(restored).items():
        np.testing.assert_array_equal(v.numpy(), stitched[k], err_msg=k)
    whole, _ = ckpt.restore(os.path.join(ranks, "whole.npz"), device="cpu")
    for src in ("ck4", "whole.npz"):
        got = stitch_history_shards(os.path.join(ranks, f"restored_{src}"))
        for k, v in _fields(whole).items():
            np.testing.assert_array_equal(got[k], v.numpy(),
                                          err_msg=f"{src} {k}")


def test_run_model_sharded_at_two_ranks_and_restored_at_one(ranks, tmp_path,
                                                            capsys):
    """``run_model --sharded`` on two ranks: rank 0 alone prints the
    summary, with the global column count and the health totals summed
    over ranks; its history and checkpoint shards stitch; its final
    checkpoint agrees with the same run at one process, and a run at one
    process resumed from its step-2 shards agrees with it."""
    outs = []
    for r in range(RANKS):
        with open(os.path.join(ranks, f"rank{r}.json")) as f:
            outs.append(json.load(f)["stdout"].strip())
    assert outs[1] == ""
    summary = json.loads(outs[0].splitlines()[-1])
    assert summary["columns"] == NCOL and summary["finite"]
    assert summary["steps"] == 4

    def one_process(*argv):
        assert run_model.main([*RM_ARGS, *argv]) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    single = one_process("--steps", "4", "--out", str(tmp_path / "a"))
    for k in ("health_solver_nonconverged_cells_total",
              "health_poc_error_cells_total"):
        assert summary[k] == single[k], k
    assert abs(summary["max_abs_Jint_Ctot"] - single["max_abs_Jint_Ctot"]) \
        <= 1e-12

    rm = os.path.join(ranks, "rm")
    hist = stitch_history_shards(os.path.join(rm, "hist_000004"))
    assert set(hist) == {"pco2surf", "NITRIF", "POC_FLUX_IN", *HEALTH_DIAGS}
    with np.load(tmp_path / "a" / "hist_000004.npz") as f:
        _close(hist, {k: f[k] for k in hist}, TOL["float64"], "history")
    final, n = ckpt.restore(os.path.join(rm, "ck_final"), device="cpu")
    assert n == 4
    want, _ = ckpt.restore(single["final_checkpoint"], device="cpu")
    _close({k: v.numpy() for k, v in _fields(final).items()},
           _fields(want), TOL["float64"], "ck_final")
    resumed = one_process("--steps", "2", "--restore",
                          os.path.join(rm, "ck_000002"), "--out",
                          str(tmp_path / "b"))
    again, n = ckpt.restore(resumed["final_checkpoint"], device="cpu")
    assert n == 4
    _close({k: v.numpy() for k, v in _fields(again).items()},
           _fields(final), TOL["float64"], "resumed")



def test_run_model_sharded_writes_netcdf_history_and_world_on_rank_0(
        ranks, tmp_path, capsys):
    """``run_model --sharded --netcdf-history --save-world`` on two
    ranks: rank 0 writes the one history file and the one world file of
    every column, each variable within TOL of the same run at one process
    (the blocks are stepped apart, see above) and with its dimensions and
    attributes; rank 1 writes neither and prints nothing."""
    from ocean_bgc_tpu_torch.io import netcdf3 as nc
    names = ("hist_000002.nc", "world.nc")
    with open(os.path.join(ranks, "rank1.json")) as f:
        assert json.load(f)["stdout_nc"] == ""
    assert not any(os.path.exists(os.path.join(ranks, "rm_nc_p1", n))
                   for n in names)
    with open(os.path.join(ranks, "rank0.json")) as f:
        summary = json.loads(json.load(f)["stdout_nc"].splitlines()[-1])
    assert summary["columns"] == NCOL and summary["steps"] == 2
    one = tmp_path / "one"
    assert run_model.main([*RM_ARGS, *NC_ARGS, "--save-world",
                           str(one / "world.nc"), "--out", str(one)]) == 0
    capsys.readouterr()
    for name in names:
        got = nc.read(os.path.join(ranks, "rm_nc_p0", name))
        want = nc.read(str(one / name))
        assert got.dims == want.dims and got.dims["ncol"] == NCOL, name
        assert {k: str(v) for k, v in got.attrs.items()} == {
            k: str(v) for k, v in want.attrs.items()}, name
        assert set(got.variables) == set(want.variables), name
        _close({k: v.data for k, v in got.variables.items()},
               {k: v.data for k, v in want.variables.items()},
               TOL["float64"], name)
        for k, v in got.variables.items():
            assert v.dims == want.variables[k].dims, (name, k)


if __name__ == "__main__":
    rank_main(sys.argv[1])
