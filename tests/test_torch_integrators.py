"""The Runge-Kutta steps (``models/integrators.py``): RK4 against the JAX
package's on one small ragged world, RK2 against Heun's formula on the
port's own right-hand side.  Inputs are made with numpy from a seed and go
through both packages."""

import dataclasses

import numpy as np
import torch

import ocean_bgc_tpu  # noqa: F401  (enables x64)
import jax

from ocean_bgc_tpu.models.integrators import step_rk4 as jax_rk4
from ocean_bgc_tpu.params import ModelParams as JaxModelParams
from ocean_bgc_tpu.utils.synthetic import synthetic_world as jax_world

from ocean_bgc_tpu_torch.models.coupled import (
    apply_update,
    evaluate_tendencies,
    step,
)
from ocean_bgc_tpu_torch.models.integrators import step_rk2, step_rk4
from ocean_bgc_tpu_torch.ops.bgc import precompute_env
from ocean_bgc_tpu_torch.state import BGCTracers as T
from ocean_bgc_tpu_torch.utils.bridge import params_from_dict, world_from_numpy

DT = 3600.0


def _np(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return np.asarray(x)


def test_rk4_matches_jax_and_rk2_its_formula():
    """``step_rk4`` (no env cache, diagnostics off) against JAX's at 4 x 8,
    f64, ragged, from a warm state: tracers within 1e-12 of each tracer's
    scale (the 1e-13 of one step in tests/test_torch_step.py, over four
    stage evaluations), the last stage's pH (``_with_ph``) within 2 xacc
    in H.  ``step_rk2`` equals Heun's formula on ``evaluate_tendencies``
    bitwise."""
    js, jg, jf = jax_world(nlev=4, ncol=8, seed=21, ragged=True)
    jp = JaxModelParams()
    tp = params_from_dict(dataclasses.asdict(jp))
    ts, tg, tf = world_from_numpy(_np(js), _np(jg), _np(jf), device="cpu")
    ts, _ = step(ts, tg, tf, tp, DT, compute_diags=False)
    warm = {f.name: getattr(ts, f.name) for f in dataclasses.fields(ts)}
    js = jax.tree.map(np.asarray, type(js)(
        bgc=type(js.bgc)(**{k: v.numpy() for k, v in
                            vars(warm["bgc"]).items()}),
        dms=warm["dms"].numpy(), macros=warm["macros"].numpy()))
    want = _np(jax.jit(lambda s: jax_rk4(s, jg, jf, jp, DT,
                                         compute_diags=False)[0])(js))
    got, _ = step_rk4(ts, tg, tf, tp, DT, compute_diags=False)
    a, b = want["bgc"]["tracers"], got.bgc.tracers.numpy()
    for i in range(T.CNT):
        scale = np.abs(a[:, i]).max() + 1e-30
        np.testing.assert_allclose(b[:, i] / scale, a[:, i] / scale, rtol=0,
                                   atol=1e-12, err_msg=f"tracer {i}")
    for name in ("dms", "macros"):
        scale = np.abs(want[name]).max(axis=(0, 2), keepdims=True) + 1e-30
        np.testing.assert_allclose(getattr(got, name).numpy() / scale,
                                   want[name] / scale, rtol=0, atol=1e-12)
    for name in ("ph_prev_3d", "surface_ph"):
        x, y = want["bgc"][name], getattr(got.bgc, name).numpy()
        hx = np.where(x != 0.0, 10.0 ** -x, 0.0)
        hy = np.where(y != 0.0, 10.0 ** -y, 0.0)
        assert np.abs(hx - hy).max() <= 2e-10, name

    tenv = precompute_env(tg, tf, tp.bgc)
    new, diags = step_rk2(ts, tg, tf, tp, DT, env=tenv)
    k1, d1 = evaluate_tendencies(ts, tg, tf, tp, env=tenv)
    k2, _ = evaluate_tendencies(apply_update(ts, k1, DT), tg, tf, tp,
                                compute_diags=False, env=tenv)
    assert torch.equal(new.bgc.tracers,
                       ts.bgc.tracers + DT / 2.0 * (k1.bgc + k2.bgc))
    assert torch.equal(new.dms, ts.dms + DT / 2.0 * (k1.dms + k2.dms))
    assert torch.equal(new.bgc.ph_prev_3d, k2.ph_prev_3d)
    assert diags.keys() == d1.keys()
