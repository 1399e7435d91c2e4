"""The port's trajectory adjoint (``ocean_bgc_tpu_torch/models/adjoint.py``)
on the CPU at f64: its paths and options, its forward, its gradients.

Trajectory gradients are held to central finite differences of the port's
own forward (which the step tests hold to JAX), and to the JAX package's
gradients of the same functional recorded below; ``OCEAN_BGC_JAX_ADJOINT=1``
recomputes those live with ``ocean_bgc_tpu.models.adjoint`` (a jitted
reverse sweep of five steps, about two and a half minutes on a CPU core).
The gradients' robustness (forced runs, zero biomass, ragged worlds, every
parameter, f32) is in ``tests/test_torch_adjoint_paths.py``, the solve's
backward against JAX's custom VJP in ``tests/test_torch_adjoint_solve.py``.
The JAX package's own adjoint test, ``tests/test_adjoint.py``, is marked
``slow`` by the root ``conftest.py`` and so left out of tier-1; its twin
experiment is repeated here on the port.  Inputs are made with numpy from
a seed."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import ocean_bgc_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp

from ocean_bgc_tpu_torch.models.adjoint import (
    _STRUCTURAL_FIELDS,
    calibrate,
    get_param,
    override_params,
    parameter_sensitivities,
    run_diff,
)
from ocean_bgc_tpu_torch.models.coupled import run, step
from ocean_bgc_tpu_torch.ops import cuda_carbonate as cc
from ocean_bgc_tpu_torch.ops.kernel_params import pack_bgc_params
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.state import BGCTracers as BT
from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world

DT = 3600.0
PATHS = ("bgc.parm_kappa_nitrif", "bgc.autotrophs[0].PCref",
         "bgc.parm_POC_diss")
# JAX's parameter_sensitivities(ModelParams(), PATHS, world(), DT, 5,
# mean(NO3**2) of the final tracers) with ocean_bgc_tpu.models.adjoint,
# f64 on a CPU: dJ/d ln p.  The port's implicit-function backward and
# the JAX package's custom VJP differentiate the same forward (the step
# tests hold the two forwards to each other to 1e-12 and better), so the
# two agree to rounding: rtol 1e-10.
JAX_SENSITIVITIES = {
    "bgc.parm_kappa_nitrif": 0.002602446950325304,
    "bgc.autotrophs[0].PCref": -0.1569448295191709,
    "bgc.parm_POC_diss": -0.003751784022819961,
}
SENS_STEPS = 5


def world(**kw):
    kw.setdefault("nlev", 6)
    kw.setdefault("ncol", 8)
    kw.setdefault("seed", 73)
    kw.setdefault("ragged", False)
    return synthetic_world(device="cpu", **kw)


def no3_functional(final):
    return torch.mean(final.bgc.tracers[:, BT.NO3] ** 2)


def with_tracers(state, tracers):
    return dataclasses.replace(
        state, bgc=dataclasses.replace(state.bgc, tracers=tracers))

def test_override_params_paths():
    p = ModelParams()
    assert get_param(p, "bgc.parm_kappa_nitrif") == p.bgc.parm_kappa_nitrif
    assert get_param(p, "bgc.autotrophs[1].kSiO3") == 0.8

    p2 = override_params(p, {
        "bgc.parm_kappa_nitrif": 1.0e-6,
        "bgc.autotrophs[0].PCref": 2.0e-5,
        "dms.k_conv": 3.0e-6,
    })
    assert get_param(p2, "bgc.parm_kappa_nitrif") == 1.0e-6
    assert get_param(p2, "bgc.autotrophs[0].PCref") == 2.0e-5
    assert get_param(p2, "dms.k_conv") == 3.0e-6
    # untouched fields and sibling tuple entries are preserved
    assert p2.bgc.autotrophs[0].kFe == p.bgc.autotrophs[0].kFe
    assert p2.bgc.autotrophs[1] is p.bgc.autotrophs[1]
    assert p2.macros is p.macros
    # a tensor value is kept as given, for autograd to follow
    t = torch.tensor(1.5e-6, dtype=torch.float64, requires_grad=True)
    assert get_param(override_params(p, {"bgc.parm_kappa_nitrif": t}),
                     "bgc.parm_kappa_nitrif") is t

    with pytest.raises(TypeError, match="structural"):
        override_params(p, {"bgc.autotrophs[0].temp_function": 1})
    with pytest.raises(TypeError, match="structural"):
        override_params(p, {"bgc.lrest_no3": 1.0})
    with pytest.raises(AttributeError):
        get_param(p, "bgc.not_a_field")
    from ocean_bgc_tpu.models.adjoint import _STRUCTURAL_FIELDS as jax_fields
    assert _STRUCTURAL_FIELDS == jax_fields


def test_run_diff_forward_matches_run():
    """run_diff is the production run: bitwise, with and without remat;
    obs_fn's outputs stack along a leading time axis."""
    state, grid, forcing = world()
    params = ModelParams()
    want, _ = run(state, grid, forcing, params, DT, 4)
    for remat in (True, False):
        got, obs = run_diff(state, grid, forcing, params, DT, 4, remat=remat,
                            obs_fn=lambda s: (s.bgc.tracers[0],
                                              {"dms": s.dms[0]}))
        assert torch.equal(got.bgc.tracers, want.bgc.tracers)
        assert torch.equal(got.bgc.ph_prev_3d, want.bgc.ph_prev_3d)
        assert torch.equal(got.dms, want.dms)
        assert obs[0].shape == (4, *state.bgc.tracers[0].shape)
        assert torch.equal(obs[0][-1], want.bgc.tracers[0])
        assert torch.equal(obs[1]["dms"][-1], want.dms[0])


@pytest.fixture(scope="module")
def sensitivities():
    state, grid, forcing = world()
    return parameter_sensitivities(ModelParams(), PATHS, state, grid,
                                   forcing, DT, SENS_STEPS, no3_functional)


def _jax_sensitivities():
    if os.environ.get("OCEAN_BGC_JAX_ADJOINT") != "1":
        return JAX_SENSITIVITIES
    from ocean_bgc_tpu.models.adjoint import (
        parameter_sensitivities as jax_sensitivities)
    from ocean_bgc_tpu.utils.synthetic import synthetic_world as jax_world
    state, grid, forcing = jax_world(nlev=6, ncol=8, seed=73, ragged=False)
    return jax_sensitivities(
        ModelParams(), PATHS, state, grid, forcing, DT, SENS_STEPS,
        lambda f: jnp.mean(f.bgc.tracers[:, BT.NO3] ** 2))


def test_sensitivities_match_jax(sensitivities):
    """One reverse sweep over three parameters against the JAX package's
    (recorded; live under OCEAN_BGC_JAX_ADJOINT=1), rtol 1e-10."""
    want = _jax_sensitivities()
    assert set(sensitivities) == set(PATHS)
    for p in PATHS:
        np.testing.assert_allclose(sensitivities[p], want[p], rtol=1e-10)
    assert sensitivities["bgc.parm_kappa_nitrif"] > 0.0


def test_trajectory_param_grad_matches_finite_difference(sensitivities):
    """d/d kappa of mean(NO3**2) after 5 steps against central finite
    differences of the forward (rtol 2e-3, JAX's bound), and the one-sweep
    sensitivity against this single-parameter gradient times p0 (rtol
    1e-10)."""
    state, grid, forcing = world()
    template = ModelParams()
    path = "bgc.parm_kappa_nitrif"
    p0 = get_param(template, path)

    def loss_of(value):
        final = run_diff(state, grid, forcing,
                         override_params(template, {path: value}), DT,
                         SENS_STEPS)
        return no3_functional(final)

    v = torch.tensor(p0, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(loss_of(v), v)
    with torch.no_grad():
        eps = 1e-2 * p0
        fd = (float(loss_of(p0 + eps)) - float(loss_of(p0 - eps))) / (2 * eps)
    assert np.isfinite(float(g))
    np.testing.assert_allclose(float(g), fd, rtol=2e-3)
    assert float(g) > 0.0   # more nitrification -> more NO3
    np.testing.assert_allclose(sensitivities[path], float(g) * p0,
                               rtol=1e-10)


def test_remat_gradient_matches_no_remat():
    state, grid, forcing = world(nlev=5, ncol=4)
    params = ModelParams()

    def grad(remat):
        tr = state.bgc.tracers.clone().requires_grad_()
        final = run_diff(with_tracers(state, tr), grid, forcing, params, DT,
                         4, remat=remat)
        (g,) = torch.autograd.grad(
            torch.sum(final.bgc.tracers[0, BT.DIC] ** 2), tr)
        return g

    g_remat, g_plain = grad(True), grad(False)
    np.testing.assert_allclose(g_remat.numpy(), g_plain.numpy(), rtol=1e-12,
                               atol=0.0)
    assert float(g_remat.abs().max()) > 0.0


def test_calibrate_takes_steps_and_checks_its_arguments():
    """A few iterations from a 1.4x PCref: the loss falls, ``losses`` has
    iters + 1 entries (the last at the returned parameters), the returned
    params carry the fit; an optimizer factory is used; bad transforms
    and non-positive log-space starts raise."""
    state, grid, forcing = world()
    truth = ModelParams()
    path = "bgc.autotrophs[0].PCref"
    true_val = get_param(truth, path)

    def obs_fn(s):
        return s.bgc.tracers[0][(BT.SPC, BT.SPCHL, BT.DIC), :]

    with torch.no_grad():
        _, observations = run_diff(state, grid, forcing, truth, DT, 3,
                                   obs_fn=obs_fn)
    first_guess = override_params(truth, {path: 1.4 * true_val})
    result = calibrate(first_guess, [path], state, grid, forcing, DT, 3,
                       observations, obs_fn, iters=3, learning_rate=0.1)
    assert len(result.losses) == 4
    assert result.losses[-1] < result.losses[0]
    assert abs(result.values[path] - true_val) < 0.4 * true_val
    assert get_param(result.params, path) == result.values[path]
    assert result.theta.shape == (1,)

    made = []

    def sgd(ps):
        made.append(torch.optim.SGD(ps, lr=1e-3))
        return made[-1]

    res2 = calibrate(first_guess, [path], state, grid, forcing, DT, 2,
                     observations[:2], obs_fn, iters=1, optimizer=sgd,
                     transform="linear")
    assert len(made) == 1 and len(res2.losses) == 2
    with pytest.raises(ValueError, match="unknown transform"):
        calibrate(first_guess, [path], state, grid, forcing, DT, 2,
                  observations, obs_fn, iters=1, transform="exp")
    with pytest.raises(ValueError, match="positive"):
        calibrate(first_guess, [path], state, grid, forcing, DT, 2,
                  observations, obs_fn, iters=1, init={path: 0.0})


def test_calibration_recovers_perturbed_growth_rate():
    """Twin experiment, as the JAX package's: observations from the true
    params, the optimizer started from a 1.4x-perturbed small-phyto PCref,
    the truth recovered from surface-tracer trajectories.  Adam's log-space
    iterate circles the truth with a shrinking swing; at lr 0.05 it stays
    within 2% from iteration 43 on, so 45 iterations over 3 steps (~20 s)."""
    state, grid, forcing = world()
    truth = ModelParams()
    path = "bgc.autotrophs[0].PCref"
    true_val = get_param(truth, path)

    def obs_fn(s):
        return s.bgc.tracers[0][(BT.SPC, BT.SPCHL, BT.DIC), :]

    with torch.no_grad():
        _, observations = run_diff(state, grid, forcing, truth, DT, 3,
                                   obs_fn=obs_fn)
    first_guess = override_params(truth, {path: 1.4 * true_val})
    result = calibrate(first_guess, [path], state, grid, forcing, DT, 3,
                       observations, obs_fn, iters=45, learning_rate=0.05)

    assert result.losses[-1] < 1e-2 * result.losses[0], result.losses
    fitted = result.values[path]
    np.testing.assert_allclose(fitted, true_val, rtol=0.03)
    # the returned params carry the fit
    assert get_param(result.params, path) == fitted


def test_fused_interior_and_kernels_refuse_grad():
    """K2 is forward-only (as JAX's, coupled.py:114): interior_impl=
    "fused" raises ValueError under grad, on any device; the interior
    kernel's packed parameters and a K1 launch outside its autograd
    Function refuse inputs that require grad."""
    state, grid, forcing = world(nlev=4, ncol=4)
    params = ModelParams()
    tr = state.bgc.tracers.clone().requires_grad_()
    with pytest.raises(ValueError, match="forward-only"):
        step(with_tracers(state, tr), grid, forcing, params, DT,
             compute_diags=False, interior_impl="fused")
    kappa = torch.tensor(params.bgc.parm_kappa_nitrif, dtype=torch.float64,
                         requires_grad=True)
    p2 = override_params(params, {"bgc.parm_kappa_nitrif": kappa})
    with pytest.raises(ValueError, match="forward-only"):
        step(state, grid, forcing, p2, DT, compute_diags=False,
             interior_impl="fused")
    with pytest.raises(ValueError, match="requires grad"):
        pack_bgc_params(p2.bgc)
    # without grad mode the fused plain version runs
    with torch.no_grad():
        step(with_tracers(state, tr), grid, forcing, params, DT,
             compute_diags=False, interior_impl="fused")
    x = torch.ones(4, dtype=torch.float64, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        cc._launch((x,) * 21, x.dtype)
    with pytest.raises(RuntimeError, match="no backward"):
        cc._launch_coeffs(x, x, x, True)
