"""The port's host-coupling API against the JAX package's, on the CPU:
the tests of ``tests/test_torch_host_api.py`` for the DMS and MACROS
entry points (one JAX call each, on the same host arrays), and the state
helpers and the package's top level against JAX's."""

import dataclasses

import numpy as np
import pytest
import torch

import ocean_bgc_tpu
from ocean_bgc_tpu import state as jstate

import ocean_bgc_tpu_torch
from ocean_bgc_tpu_torch import state as tstate
from ocean_bgc_tpu_torch.state import BGC_TRACER_NAMES
from tests.test_torch_host_api import (  # noqa: F401  (collected here)
    ENTRY_POINTS,
    entry_calls,
    test_entry_point_matches_jax,
    test_tracer_order_adapter_bitwise,
)

OTHERS = ENTRY_POINTS[2:]


@pytest.fixture(scope="module")
def calls():
    """:func:`entry_calls` of the DMS and MACROS entry points."""
    return entry_calls(OTHERS)


@pytest.fixture(params=OTHERS)
def name(request):
    """Each DMS and MACROS entry point."""
    return request.param


def test_state_helpers_match_jax():
    """``zeros_state``, ``pack_tracers`` and ``unpack_tracers`` against
    JAX's, on the same values."""
    z, jz = tstate.zeros_state(4, 5, device="cpu"), jstate.zeros_state(4, 5)
    for f in dataclasses.fields(jz):
        a, b = np.asarray(getattr(jz, f.name)), getattr(z, f.name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f.name
        assert not b.any(), f.name
    assert tstate.zeros_state(2, 3, torch.float32, "cpu").tracers.dtype == \
        torch.float32
    rng = np.random.default_rng(5)
    named = {n: rng.standard_normal((4, 5)) for n in BGC_TRACER_NAMES}
    block = tstate.pack_tracers({k: torch.from_numpy(v)
                                 for k, v in named.items()})
    want = np.asarray(jstate.pack_tracers(named))
    assert np.array_equal(block.numpy(), want)
    back = tstate.unpack_tracers(block)
    jback = jstate.unpack_tracers(want)
    assert list(back) == list(jback) == list(BGC_TRACER_NAMES)
    assert all(np.array_equal(back[k].numpy(), np.asarray(jback[k]))
               for k in back)


def test_top_level_conveniences_resolve():
    """The package's top level: the params and state re-exports and the
    lazy model entry points, as JAX's top level has them."""
    from ocean_bgc_tpu_torch.models import coupled
    from ocean_bgc_tpu_torch.ops import bgc
    from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world

    p = ocean_bgc_tpu_torch
    assert p.params.ModelParams is p.ModelParams
    assert p.state.BGCTracers is p.BGCTracers
    for name in ("BGCParams", "DMSParams", "MACROSParams", "ModelParams",
                 "BGCForcing", "BGCState", "BGCTracers", "ColumnGrid",
                 "DMSTracers", "MACROSTracers", "constants", "__version__"):
        assert hasattr(p, name) and hasattr(ocean_bgc_tpu, name), name
    assert (p.step, p.run, p.CoupledState) == (coupled.step, coupled.run,
                                               coupled.CoupledState)
    assert (p.precompute_env, p.EnvCache) == (bgc.precompute_env,
                                              bgc.EnvCache)
    assert p.synthetic_world is synthetic_world
    with pytest.raises(AttributeError):
        p.not_a_name  # noqa: B018
