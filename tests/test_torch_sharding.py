"""The port's multi-device layer in one process: ``parallel/`` on a
one-rank Gloo group (built and torn down by a fixture), and the shard
files (history, checkpoints) written for several ranks by one process,
each rank's ``ColumnMesh`` stated by hand.  Two real ranks:
``tests/test_torch_distributed.py``."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from ocean_bgc_tpu_torch.models.coupled import step
from ocean_bgc_tpu_torch.models.forcing_series import (
    run_forced,
    stack_forcings,
)
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.parallel import (
    make_mesh,
    make_sharded_forced_run,
    make_sharded_step,
    shard_world,
)
from ocean_bgc_tpu_torch.parallel import distributed as dist
from ocean_bgc_tpu_torch.parallel.distributed import (
    ColumnMesh,
    host_local_columns,
    host_local_to_global,
)
from ocean_bgc_tpu_torch.parallel.sharding import (
    GLOBAL_SUM_DIAGS,
    HEALTH_DIAGS,
    all_reduce_sum,
    shard_columns,
)
from ocean_bgc_tpu_torch.utils import checkpoint as ckpt
from ocean_bgc_tpu_torch.utils.history import (
    stitch_history_shards,
    write_history_shards,
)
from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world

DT = 3600.0
CPU = torch.device("cpu")


def _mesh(rank, n):
    return ColumnMesh(rank=rank, world_size=n, device=CPU)


def _world(ncol=16, dtype=torch.float64):
    return synthetic_world(nlev=6, ncol=ncol, seed=21, dtype=dtype,
                           device="cpu")


def _series(forcing):
    """Three forcing records: T +0, +0.5, -0.5 C."""
    import dataclasses
    return stack_forcings([dataclasses.replace(
        forcing, potential_temperature=forcing.potential_temperature + d)
        for d in (0.0, 0.5, -0.5)])


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _leaves(state):
    b = state.bgc
    return (b.tracers, b.ph_prev_3d, b.ph_prev_alt_3d, b.surface_ph,
            b.surface_ph_alt, state.dms, state.macros)


@pytest.fixture()
def mesh():
    dist.initialize(device="cpu")
    try:
        yield make_mesh()
    finally:
        dist.shutdown()


def test_one_rank_sharded_step_and_forced_run_are_the_port_s(mesh):
    """On one rank the sharded step is ``step`` bitwise, with each
    configuration's collective pattern (``tests/test_zero_collectives.py``
    for the torch layer): one stacked ``all_reduce`` per step with
    diagnostics or health, none in a production step (either interior,
    any ``nsteps``) or a forced run.  The global sums are the sums of the
    step's diagnostics, the health counters its counts."""
    assert (mesh.rank, mesh.world_size, mesh.device) == (0, 1, CPU)
    params = ModelParams()
    state, grid, forcing = shard_world(*_world(), mesh)

    before = all_reduce_sum.calls
    fn = make_sharded_step(mesh, params, DT, compute_diags=True, health=True,
                           local_diags=("photoC_TOT_zint",
                                        "health_poc_error_cells"))
    got, gsum, local = fn(state, grid, forcing)
    assert all_reduce_sum.calls - before == 1
    want, d = step(state, grid, forcing, params, DT, health=True)
    assert _same(got, want)
    assert set(gsum) == set(GLOBAL_SUM_DIAGS) | set(HEALTH_DIAGS)
    for n in GLOBAL_SUM_DIAGS:
        assert torch.equal(gsum[n], d[n].sum()), n
    for n in HEALTH_DIAGS:
        assert torch.equal(gsum[n], d[n]), n
    assert torch.equal(local["photoC_TOT_zint"], d["photoC_TOT_zint"])
    assert local["health_poc_error_cells"] is gsum["health_poc_error_cells"]

    for kw, nsteps in (({}, 1), ({"interior_impl": "fused"}, 2),
                       ({"health": True}, 2)):
        before = all_reduce_sum.calls
        got, gsum = make_sharded_step(mesh, params, DT, nsteps=nsteps,
                                      **kw)(state, grid, forcing)
        assert all_reduce_sum.calls - before == (1 if kw.get("health")
                                                 else 0), kw
        want = state
        for i in range(nsteps):
            last = i == nsteps - 1
            want, _ = step(want, grid, forcing, params, DT,
                           compute_diags=False,
                           interior_impl=kw.get("interior_impl", "auto"),
                           health=last and kw.get("health", False))
        assert _same(got, want), kw
        assert set(gsum) == (set(HEALTH_DIAGS) if kw.get("health")
                             else set())

    series = shard_columns(_series(_world()[2]), mesh, grid.ncol)
    before = all_reduce_sum.calls
    got = make_sharded_forced_run(mesh, params, DT, 3, 2 * DT,
                                  interp="hold")(state, grid, series)
    assert all_reduce_sum.calls == before
    want, _ = run_forced(state, grid, series, params, DT, 3, 2 * DT,
                         interp="hold")
    assert _same(got, want)


def test_local_diags_without_diagnostics_raises():
    """The JAX package fails here with a bare KeyError at trace time
    (ROADMAP queue 3 #7); the port refuses at construction."""
    with pytest.raises(ValueError, match="local_diags requires "
                                         "compute_diags=True"):
        make_sharded_step(_mesh(0, 1), ModelParams(), DT, health=True,
                          local_diags=("health_poc_error_cells",))


def test_initialize_failures_propagate():
    """Every failure to form the group raises (the JAX package swallows
    them, ROADMAP queue 3 #7), and leaves no group behind; NCCL never
    takes more ranks than cards."""
    assert not tdist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        dist.global_mesh()
    with pytest.raises(ValueError, match="2 ranks on this host, 0 cards"):
        dist.initialize("localhost:1", 2, 0, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="coordinator_address"):
        dist.initialize(None, 2, 0, device="cpu")
    with pytest.raises(ValueError, match="not a rank of 2"):
        dist.initialize("localhost:1", 2, 2, device="cpu")
    with pytest.raises(Exception, match="(?i)backend"):
        dist.initialize(backend="no-such-backend", device="cpu")
    assert not tdist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dist.initialize()
    dist.initialize(device="cpu")
    try:
        with pytest.raises(RuntimeError, match="already initialised"):
            dist.initialize(device="cpu")
    finally:
        dist.shutdown()
    assert not tdist.is_initialized()


def test_host_local_columns_and_placement():
    """Blocks in rank order; a width that does not divide the ranks is a
    ValueError (the JAX package asserts); a leaf of the wrong width is
    named."""
    assert [host_local_columns(12, _mesh(r, 3)) for r in range(3)] == [
        (0, 4), (4, 8), (8, 12)]
    with pytest.raises(ValueError, match="must divide into the 5 ranks"):
        host_local_columns(12, _mesh(0, 5))
    tree = {"a": np.ones((2, 4)), "s": np.float64(3.0),
            "b": [torch.zeros(4, dtype=torch.int32)]}
    out = host_local_to_global(tree, _mesh(1, 3), 12)
    assert out["a"].shape == (2, 4) and out["a"].device == CPU
    assert out["s"].ndim == 0 and out["b"][0].dtype == torch.int32
    with pytest.raises(ValueError, match="b\\[0\\]: 5 columns"):
        host_local_to_global({"b": [torch.zeros(5)]}, _mesh(1, 3), 12)
    state, grid, forcing = _world(ncol=12)
    blocks = [shard_world(state, grid, forcing, _mesh(r, 3))
              for r in range(3)]
    assert torch.equal(torch.cat([b[0].bgc.tracers for b in blocks], -1),
                       state.bgc.tracers)
    assert torch.equal(torch.cat([b[1].kmax for b in blocks]), grid.kmax)


def test_history_shards_round_trip_and_reject_bad_shapes(tmp_path):
    """The shard files of three ranks stitch to the global fields
    bitwise, in the JAX package's layout (its stitcher reads them, and
    the port's reads its files); stale shards of a larger run are
    removed; a replicated field whose shape is not its recorded one is
    refused (the JAX stitcher passes it: ROADMAP queue 3 #7)."""
    from ocean_bgc_tpu.utils import history as jhist

    rng = np.random.default_rng(5)
    fields = {"POC_FLUX_IN": rng.random((6, 12)),
              "photoC_TOT_zint": rng.random(12),
              "kmax": rng.integers(0, 6, 12).astype(np.int32),
              "health_poc_error_cells": np.asarray(2.0)}
    d = tmp_path / "h"
    os.makedirs(d)
    np.savez(d / "hist_p3.npz", x=np.zeros(1))     # a 4-rank run's
    for r in range(3):
        lo, hi = host_local_columns(12, _mesh(r, 3))
        write_history_shards(str(d), {
            k: torch.from_numpy(v[..., lo:hi] if v.ndim else v.copy())
            for k, v in fields.items()}, mesh=_mesh(r, 3))
    assert sorted(os.listdir(d)) == [f"hist_p{r}.npz" for r in range(3)]
    for stitched in (stitch_history_shards(str(d)),
                     jhist.stitch_history_shards(str(d))):
        assert set(stitched) == set(fields)
        for k, v in fields.items():
            assert stitched[k].dtype == v.dtype, k
            np.testing.assert_array_equal(stitched[k], v, err_msg=k)

    import jax.numpy as jnp
    jdir = tmp_path / "j"
    jhist.write_history_shards(str(jdir), {k: jnp.asarray(v)
                                           for k, v in fields.items()},
                               process_index=0)
    for k, v in stitch_history_shards(str(jdir)).items():
        np.testing.assert_array_equal(v, fields[k], err_msg=k)

    bad = tmp_path / "bad"
    os.makedirs(bad)
    np.savez(bad / "hist_p0.npz", **{"__shape__g": np.asarray([3]),
                                     "g@r": np.zeros(2)})
    assert jhist.stitch_history_shards(str(bad))["g"].shape == (2,)
    with pytest.raises(ValueError, match="replicated 'g' has shape"):
        stitch_history_shards(str(bad))
    with pytest.raises(ValueError, match="key syntax"):
        write_history_shards(str(bad), {"a@b": torch.zeros(2)})


def test_checkpoints_reshard_bitwise(tmp_path):
    """A checkpoint of N ranks' shards restores onto M ranks and onto one
    process, and the single file onto M ranks, each rank's block bitwise
    its slice of the whole state; its step comes back; an incomplete
    shard set and a directory without shards are refused."""
    state, _, _ = _world(ncol=12, dtype=torch.float32)
    state, _ = step(state, *_world(ncol=12, dtype=torch.float32)[1:],
                    ModelParams(), DT, compute_diags=False)
    whole = ckpt.save(str(tmp_path / "whole"), state, step=7)

    def shards(n):
        path = str(tmp_path / f"ck{n}")
        for r in range(n):
            lo, hi = host_local_columns(12, _mesh(r, n))
            block = _slice(state, lo, hi)
            assert ckpt.save(path, block, step=7, mesh=_mesh(r, n)) == path
        return path

    def check(path, m):
        for r in range(m):
            got, n = ckpt.restore(path, mesh=_mesh(r, m))
            lo, hi = host_local_columns(12, _mesh(r, m))
            assert n == 7 and _same(got, _slice(state, lo, hi)), (path, m)
            assert got.bgc.tracers.dtype == torch.float32

    for n, m in ((2, 4), (4, 2), (3, 1), (2, 3)):
        check(shards(n), m)
    check(whole, 2)
    for path in (shards(2), whole):
        got, n = ckpt.restore(path, device="cpu")
        assert n == 7 and _same(got, state)
    os.remove(tmp_path / "ck4" / "ck_p1.npz")
    with pytest.raises(ValueError, match="disagree"):
        ckpt.restore(str(tmp_path / "ck4"), device="cpu")
    os.makedirs(tmp_path / "orbax")
    with pytest.raises(ValueError, match="orbax"):
        ckpt.restore(str(tmp_path / "orbax"), device="cpu")


def _slice(state, lo, hi):
    import dataclasses
    cut = lambda t: t[..., lo:hi]  # noqa: E731
    return dataclasses.replace(
        state, bgc=dataclasses.replace(
            state.bgc, **{f.name: cut(getattr(state.bgc, f.name))
                          for f in dataclasses.fields(state.bgc)}),
        dms=cut(state.dms), macros=cut(state.macros))


def test_entry_and_multichip_dry_run():
    """``entry.entry()``'s step runs (here on the CPU), and
    ``dryrun_multichip`` runs the sharded step with diagnostics and
    health on two spawned Gloo ranks."""
    from ocean_bgc_tpu_torch.entry import dryrun_multichip, entry
    fn, args = entry(device="cpu")
    assert args[0].bgc.tracers.shape == (60, 30, 256)
    assert bool(fn(*args).bgc.tracers.isfinite().all())
    dryrun_multichip(2, device="cpu")


def test_multichip_dry_run_stays_on_the_cards(monkeypatch):
    """``dryrun_multichip`` places its ranks on the cards unless the CPU is
    asked for: NCCL, one card per rank, where there are enough cards, else
    Gloo ranks sharing them; with no card it raises, never falling back
    to the CPU."""
    import torch

    from ocean_bgc_tpu_torch import entry
    assert [entry.rank_placement(r, 4, 4) for r in range(4)] == [
        (f"cuda:{r}", "nccl") for r in range(4)]
    assert [entry.rank_placement(r, 8, 1) for r in range(8)] == [
        ("cuda:0", "gloo")] * 8
    assert [entry.rank_placement(r, 3, 2) for r in range(3)] == [
        ("cuda:0", "gloo"), ("cuda:1", "gloo"), ("cuda:0", "gloo")]
    assert entry.rank_placement(1, 2, 0, "cpu") == ("cpu", "gloo")
    assert entry.rank_placement(1, 2, 4, "cpu") == ("cpu", "gloo")
    with pytest.raises(RuntimeError, match="has none"):
        entry.rank_placement(0, 2, 0)
    with pytest.raises(ValueError, match="device"):
        entry.rank_placement(0, 2, 1, "cuda:1")
    # a host without a card: the dry run raises before it spawns a rank
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="has none"):
        entry.dryrun_multichip(2)
