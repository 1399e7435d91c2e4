"""The port's ``checked_step`` and its profiling helpers on CPU tensors:
a corrupted step raises naming its field, ``step_timer`` times on the
host clock and ``trace`` writes a Chrome trace."""

import json

import pytest
import torch

from ocean_bgc_tpu_torch.models.coupled import CoupledState, step
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.utils import debug, profiling
from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world
from tests.test_torch_debug import DT, _with_bgc


def test_checked_step_raises_on_corruption():
    """A step whose output holds a non-finite tracer raises, naming the
    field; a clean step passes through unchanged."""
    state, grid, forcing = synthetic_world(nlev=6, ncol=8, seed=54,
                                           device="cpu")
    params = ModelParams()

    def bad_step(s):
        new, d = step(s, grid, forcing, params, DT, compute_diags=False)
        poisoned = new.bgc.tracers.clone()
        poisoned[0, 0, 0] = float("inf")
        return _with_bgc(new, tracers=poisoned), d

    with pytest.raises(FloatingPointError, match="'bgc.tracers'"):
        debug.checked_step(bad_step, grid)(state)
    out, _ = debug.checked_step(
        lambda s: step(s, grid, forcing, params, DT, compute_diags=False),
        grid)(state)
    assert isinstance(out, CoupledState)
    assert torch.isfinite(out.bgc.tracers).all()


def test_step_timer_on_cpu():
    """On CPU tensors the host clock times each call: the first call,
    ``warmup - 1`` untimed calls, then ``repeats`` timed ones."""
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2.0

    out = profiling.step_timer(fn, torch.ones(16), warmup=2, repeats=3)
    assert set(out) == {"best", "mean", "compile"}
    assert len(calls) == 1 + 1 + 3
    assert 0.0 < out["best"] <= out["mean"]
    assert out["compile"] > 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as prof:
        torch.ones(8).mul(3.0).sum()
    assert any("mul" in e.key for e in prof.key_averages())
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert events["traceEvents"]
