"""The port's production driver and what it runs: forced runs under a
forcing series, column-chunked stepping and ``python -m
ocean_bgc_tpu_torch.run_model``, on the CPU at small sizes, held to the
port's own host loops and to the JAX package's files and summary line
(the Runge-Kutta steps: tests/test_torch_integrators.py)."""

import ast
import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import ocean_bgc_tpu  # noqa: F401  (enables x64)

from ocean_bgc_tpu.io import model_io as jio

from ocean_bgc_tpu_torch import run_model
from ocean_bgc_tpu_torch.io.model_io import save_world
from ocean_bgc_tpu_torch.models.chunked import host_world_like, step_chunked
from ocean_bgc_tpu_torch.models.coupled import step
from ocean_bgc_tpu_torch.models.forcing_series import (
    forcing_at,
    forcing_record,
    run_forced,
    save_forcing_series,
    stack_forcings,
)
from ocean_bgc_tpu_torch.ops.bgc import precompute_env
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.state import BGCTracers as T
from ocean_bgc_tpu_torch.utils import checkpoint as ckpt
from ocean_bgc_tpu_torch.utils.history import read_history
from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world

DT = 3600.0
REPO = Path(__file__).resolve().parent.parent


def _equal_states(a, b):
    return all(torch.equal(x, y) for x, y in (
        (a.bgc.tracers, b.bgc.tracers), (a.bgc.ph_prev_3d, b.bgc.ph_prev_3d),
        (a.bgc.ph_prev_alt_3d, b.bgc.ph_prev_alt_3d),
        (a.bgc.surface_ph, b.bgc.surface_ph),
        (a.bgc.surface_ph_alt, b.bgc.surface_ph_alt), (a.dms, b.dms),
        (a.macros, b.macros)))


def _forced_world(nlev=4, ncol=6, nrec=3):
    """A world and a series of ``nrec`` records: the world's forcing with
    T shifted by 0, +0.5, -0.5 degrees C and the wind scaled."""
    state, grid, forcing = synthetic_world(nlev=nlev, ncol=ncol, seed=8,
                                           ragged=True, device="cpu")
    records = [dataclasses.replace(
        forcing,
        potential_temperature=forcing.potential_temperature + dtemp,
        sst=forcing.sst + dtemp,
        wind_speed_squared_10m=forcing.wind_speed_squared_10m * (1 + dtemp))
        for dtemp in (0.0, 0.5, -0.5)[:nrec]]
    return state, grid, stack_forcings(records), records


@pytest.mark.parametrize("interp,env_mode", [
    ("linear", "off"), ("hold", "hold"), ("hold", "off")])
def test_run_forced_matches_host_loop(interp, env_mode):
    """``run_forced`` equals a host loop of ``step`` calls (JAX's
    tests/test_forcing_series.py pattern) bitwise: the forcing of step i
    at t = (i + 1/2) dt / record_dt, interpolated or held, and with
    ``env_mode="hold"`` the env cache rebuilt at each record crossed;
    with diagnostics of the last step and time averages."""
    state, grid, series, records = _forced_world()
    params = ModelParams()
    record_dt, nsteps = 3 * DT, 7
    got, diags, tavg = run_forced(
        state, grid, series, params, DT, nsteps, record_dt, interp=interp,
        env_mode=env_mode, compute_diags=True, tavg_fields=("pco2surf",))
    s, total, cur, env = state, 0.0, None, None
    for i in range(nsteps):
        t = (i + 0.5) * DT / record_dt
        rec = min(int(t), len(records) - 1)
        f = forcing_at(series, t) if interp == "linear" else records[rec]
        if env_mode == "hold" and rec != cur:
            env, cur = precompute_env(grid, f, params.bgc), rec
        s, d = step(s, grid, f, params, DT, env=env)
        total = total + d["pco2surf"]
    assert _equal_states(got, s)
    assert torch.equal(diags["Jint_Ctot"], d["Jint_Ctot"])
    assert int(tavg.count) == nsteps
    torch.testing.assert_close(tavg.means()["pco2surf"], total / nsteps,
                               rtol=1e-15, atol=0)


def test_run_forced_env_interp_and_validation():
    """``env_mode="interp"`` blends the bracketing records' env caches
    (every table, the stand-in pH included) and stays within the JAX
    package's qualification of it against the exact run (2e-3 of each
    tracer's scale, tests/test_forcing_series.py); the invalid
    combinations raise JAX's errors."""
    state, grid, series, _ = _forced_world()
    params = ModelParams()
    record_dt, nsteps = 3 * DT, 7
    a, _ = run_forced(state, grid, series, params, DT, nsteps, record_dt,
                      interp="linear", env_mode="interp")
    b, _ = run_forced(state, grid, series, params, DT, nsteps, record_dt,
                      interp="linear", env_mode="off")
    assert torch.isfinite(a.bgc.tracers).all()
    assert not torch.equal(a.bgc.tracers, b.bgc.tracers)
    for idx in range(T.CNT):
        scale = b.bgc.tracers[:, idx].abs().max() + 1e-30
        err = (a.bgc.tracers[:, idx] - b.bgc.tracers[:, idx]).abs().max()
        assert err / scale < 2e-3, f"tracer {idx}"
    for kw, msg in ((dict(interp="linear", env_mode="hold"),
                     "exact only under"),
                    (dict(interp="hold", env_mode="interp"),
                     "requires interp='linear'"),
                    (dict(interp="cubic"), "unknown interp"),
                    (dict(env_mode="always"), "unknown env_mode")):
        with pytest.raises(ValueError, match=msg):
            run_forced(state, grid, series, params, DT, 1, DT, **kw)


def test_step_chunked_equals_unchunked():
    """Two steps of a 4 x 10 ragged world in chunks of 4 columns (the tail
    chunk padded with 2 land columns) equal two unchunked steps (no env
    cache, diagnostics off) bitwise; the host world is not changed."""
    state, grid, forcing = synthetic_world(nlev=4, ncol=10, seed=12,
                                           ragged=True, device="cpu")
    params = ModelParams()
    hs, hg, hf = host_world_like(state, grid, forcing)
    got = step_chunked(hs, hg, hf, params, DT, chunk=4, nsteps=2,
                       device="cpu")
    want = state
    for _ in range(2):
        want, _ = step(want, grid, forcing, params, DT, compute_diags=False)
    assert _equal_states(got, want)
    assert _equal_states(hs, state)


def _summary_keys():
    """The keys of the JAX driver's summary line, read from its source."""
    tree = ast.parse((REPO / "ocean_bgc_tpu" / "run_model.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "summary"):
            return {k.value for k in node.value.keys}
    raise AssertionError("no summary dict in ocean_bgc_tpu/run_model.py")


def _main(capsys, *argv):
    assert run_model.main([*argv, "--device", "cpu", "--quiet"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_run_model_runs_resumes_and_refuses_sharding(tmp_path, capsys,
                                                     monkeypatch):
    """``run_model.main`` on the CPU: a 6 x 16 world file and a 3-record
    forcing series, held records with the env cache, the solver seed,
    health, a history filter and checkpoints.  Its summary has the JAX
    driver's keys (the health totals besides); the history holds the
    filtered fields; the world it saves loads in the JAX package; a
    resume from the step-2 checkpoint gives the 4-step run's state
    bitwise; the seed flag is the caller's again after the run; RK2 runs;
    ``--sharded`` without a launcher runs as one rank, bitwise the
    unsharded run."""
    monkeypatch.delenv("OBGC_X0_SEED", raising=False)
    state, grid, series, _ = _forced_world(nlev=6, ncol=16)
    save_world(str(tmp_path / "w.nc"), state, grid,
               forcing_record(series, 0))
    save_forcing_series(str(tmp_path / "s.nc"), series, record_dt=2 * DT)
    common = ("--world", str(tmp_path / "w.nc"), "--forcing-series",
              str(tmp_path / "s.nc"), "--interp", "hold", "--solver-seed",
              "--health", "--history-fields", "pco2surf,Jint_Ctot")
    out = tmp_path / "a"
    summary = _main(capsys, *common, "--steps", "4", "--history-every", "2",
                    "--checkpoint-every", "2", "--out", str(out),
                    "--save-world", str(tmp_path / "final.nc"))
    health = {"health_solver_nonconverged_cells_total",
              "health_poc_error_cells_total"}
    assert set(summary) == _summary_keys() | health
    assert summary["finite"] and summary["columns"] == 16
    assert "OBGC_X0_SEED" not in os.environ
    means, count, _ = read_history(str(out / "hist_000004.npz"))
    assert count == 2 and {"pco2surf", "Jint_Ctot"} <= set(means)
    jstate, _, _ = jio.load_world(str(tmp_path / "final.nc"))
    final, n = ckpt.restore(summary["final_checkpoint"], device="cpu")
    assert n == 4
    np.testing.assert_array_equal(np.asarray(jstate.bgc.tracers),
                                  final.bgc.tracers.numpy())

    resumed = _main(capsys, *common, "--steps", "2", "--history-every", "2",
                    "--restore", str(out / "ck_000002"), "--out",
                    str(tmp_path / "b"))
    again, n = ckpt.restore(resumed["final_checkpoint"], device="cpu")
    assert n == 4 and _equal_states(again, final)

    rk2 = _main(capsys, "--nlev", "4", "--ncol", "8", "--steps", "1",
                "--integrator", "rk2", "--out", str(tmp_path / "c"))
    assert rk2["finite"]
    # --sharded without a launcher: one rank of its own group, torn down
    # after the run, the whole world bitwise the unsharded run
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    small = ("--nlev", "4", "--ncol", "8", "--steps", "2")
    sharded = _main(capsys, *small, "--sharded", "--checkpoint-every", "1",
                    "--health", "--out", str(tmp_path / "d"))
    assert not torch.distributed.is_initialized()
    plain = _main(capsys, *small, "--health", "--out", str(tmp_path / "e"))
    assert sharded["columns"] == 8 and sharded["finite"]
    assert os.path.isdir(sharded["final_checkpoint"])
    a, n = ckpt.restore(sharded["final_checkpoint"], device="cpu")
    b, _ = ckpt.restore(plain["final_checkpoint"], device="cpu")
    assert n == 2 and _equal_states(a, b)
    for k in health:
        assert sharded[k] == plain[k], k


@pytest.mark.parametrize("first,then", [((), ("--fp32",)),
                                        (("--fp32",), ())],
                         ids=["f64_into_fp32", "f32_into_f64"])
def test_run_model_refuses_a_checkpoint_of_another_dtype(tmp_path, capsys,
                                                         first, then):
    """A checkpoint restored into a run of the other dtype exits, naming
    both dtypes, instead of running at mixed precision."""
    world = ("--nlev", "3", "--ncol", "4")
    summary = _main(capsys, *world, *first, "--steps", "2", "--out",
                    str(tmp_path / "a"))
    names = ["torch.float64", "torch.float32"]
    with pytest.raises(SystemExit, match="|".join(names)) as exc:
        run_model.main([*world, *then, "--steps", "1", "--restore",
                        summary["final_checkpoint"], "--out",
                        str(tmp_path / "b"), "--device", "cpu", "--quiet"])
    assert all(n in str(exc.value) for n in names)
    assert not (tmp_path / "b" / "ck_final.npz").exists()
