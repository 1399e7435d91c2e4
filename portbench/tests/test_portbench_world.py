"""The benchmark's inputs: the world made on the device is the port's
generator's bitwise; records, schedules and samples follow the seed."""

import numpy as np
import pytest
import torch

from ocean_bgc_tpu_torch.utils.synthetic import _synthetic_world_numpy
from portbench import world


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix, tree


@pytest.mark.parametrize("nlev,ncol,seed", [(6, 40, 0), (12, 33, 17),
                                            (60, 64, 2**31 + 977)])
def test_generator_copy_is_the_ports_bitwise(nlev, ncol, seed):
    ours = world.synthetic_world(nlev, ncol, seed, device="cpu")
    theirs = _synthetic_world_numpy(nlev, ncol, seed)
    for a, b in zip(ours, theirs):
        la, lb = dict(_leaves(a)), dict(_leaves(b))
        assert la.keys() == lb.keys()
        for k in la:
            assert la[k].is_contiguous(), k
            got, want = la[k].numpy(), np.asarray(lb[k])
            assert got.dtype == want.dtype, k
            assert got.shape == want.shape, k
            assert np.array_equal(got, want), k


def test_land_share_zero_keeps_the_shelf_draws():
    """The configurations' ocean-only world: the same shelf columns as the
    port's world of that seed, and no land."""
    _, g0, _ = world.synthetic_world(8, 500, 5)
    _, g1, _ = world.synthetic_world(8, 500, 5, land_share=0.0)
    k0, k1 = g0["kmax"].numpy(), g1["kmax"].numpy()
    assert (k1 > 0).all()
    land = k0 == 0
    assert land.any()
    assert np.array_equal(k0[~land], k1[~land])


def test_columns_come_back_as_numpy():
    s, g, _ = world.synthetic_world(6, 20, 3)
    idx = torch.tensor([0, 7, 19])
    cut = world.columns_numpy(g, idx)
    assert cut["kmax"].dtype == np.int32
    assert np.array_equal(cut["kmax"], g["kmax"].numpy()[[0, 7, 19]])
    trc = world.columns_numpy(s, idx)["bgc"]["tracers"]
    assert trc.shape == (6, 30, 3) and trc.dtype == np.float64


def _records(seed, k=3):
    _, g, f = world.synthetic_world(8, 50, 1)
    base = {n: f[n] for n in world.RECORD_FIELDS}
    mix = {"records": k, "perturb": {
        "temperature_C": 0.5, "salinity_psu": 0.05, "shortwave_rel": 0.1,
        "wind2_rel": 0.1, "efold_cm": 50000.0}}
    return base, world.make_records(
        base, g["cell_center_depth"], mix, seed)


def test_records_follow_the_seed_and_stay_physical():
    base, a = _records(2**33 + 5)
    _, b = _records(2**33 + 5)
    _, c = _records(2**33 + 6)
    for ra, rb, rc in zip(a, b, c):
        for name in world.RECORD_FIELDS:
            assert torch.equal(ra[name], rb[name])
        assert not torch.equal(ra["potential_temperature"],
                               rc["potential_temperature"])
        assert torch.equal(ra["sst"], ra["potential_temperature"][0])
        assert torch.equal(ra["sss"], ra["salinity"][0])
        assert (ra["shortwave_surface"] >= 0).all()
        assert (ra["wind_speed_squared_10m"] >= 0).all()
        # small perturbations, fading with depth
        d = (ra["potential_temperature"] - base["potential_temperature"]).abs()
        assert d.max() < 5.0 and d[-1].max() < d[0].max()


def test_record_schedule_holds_and_cycles():
    mix = {"records": 3, "hold_steps": 2}
    assert [world.record_of(i, mix) for i in range(8)] == [0, 0, 1, 1, 2, 2,
                                                           0, 0]


def test_sample_is_stratified_and_seeded():
    a = world.sample_columns(1000, 8, 2**40)
    assert np.array_equal(a, world.sample_columns(1000, 8, 2**40))
    assert not np.array_equal(a, world.sample_columns(1000, 8, 2**40 + 1))
    assert ((a >= np.arange(8) * 125) & (a < np.arange(1, 9) * 125)).all()
    assert (a < 500).sum() == 4


def test_seed_streams_take_any_whole_number():
    assert world.torch_seed(2**31 + 11, 1) != world.torch_seed(2**31 + 11, 2)
    assert 0 <= world.torch_seed(2**70, 1) < 2**63
