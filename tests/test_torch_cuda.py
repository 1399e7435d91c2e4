"""The kernels on the card against their plain versions: K1 (the dual pH
solve) and the production step with it, K2 (the whole interior) and the
fused step, and P (the probe).  Needs an NVIDIA GPU with the CUDA
toolkit (nvcc); skips without one.  Run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``."""

import dataclasses

import pytest
import torch

from ocean_bgc_tpu_torch import probe

from ocean_bgc_tpu_torch.models.coupled import step
from ocean_bgc_tpu_torch.ops.bgc import carbonate_inputs, precompute_env
from ocean_bgc_tpu_torch.ops.carbonate import solver_xacc
from ocean_bgc_tpu_torch.ops.cuda_carbonate import (
    co3_terms_dual_coeffs,
    co3_terms_dual_coeffs_torch,
)
from ocean_bgc_tpu_torch.ops.cuda_step import (
    fused_interior_step,
    fused_interior_step_torch,
    site_test_hook,
)
from ocean_bgc_tpu_torch.ops.numerics import morel_kpar
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _h_diff(ph_a, ph_b):
    return (10.0 ** -ph_a.double() - 10.0 ** -ph_b.double()).abs().max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_version(cuda, dtype):
    """Same per-lane iteration, same association order, --fmad=false,
    IEEE division and the CUDA math library's exp/log10/sqrt on both
    sides: all 8 outputs (pH, H2CO3, HCO3, CO3 of both scenarios) are
    bitwise equal, on cold inputs (the initial state's 0 pH) and on warm
    ones (the state after one step), as the step gives them."""
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=12, ncol=700, seed=4,
                                           ragged=True, dtype=dtype,
                                           device=cuda)
    env = precompute_env(grid, forcing, params.bgc)
    warm, _ = step(state, grid, forcing, params, 3600.0,
                   compute_diags=False, env=env)
    for st in (state, warm):
        args = carbonate_inputs(st.bgc.tracers, grid, forcing,
                                st.bgc.ph_prev_3d, st.bgc.ph_prev_alt_3d,
                                env)
        before = co3_terms_dual_coeffs.launches
        got = co3_terms_dual_coeffs(*args, impl="kernel")
        torch.cuda.synchronize()
        assert co3_terms_dual_coeffs.launches == before + 1
        want = co3_terms_dual_coeffs_torch(*args)
        for g, w in zip(got, want):
            assert all(torch.isfinite(x).all() for x in g)
            for x, y in zip(g, w):
                assert torch.equal(x, y)


def test_kernel_step_equals_plain_step(cuda):
    """With diagnostics off the interior pH feeds only the warm-start
    carry, so tracers, DMS and MACROS are bitwise equal either way; the
    pH fields agree to the solver's tolerance (|dH| <= 2 xacc)."""
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=10, ncol=300, seed=8,
                                           device=cuda)
    env = precompute_env(grid, forcing, params.bgc)
    a = b = state
    for _ in range(2):
        a, _ = step(a, grid, forcing, params, 3600.0, compute_diags=False,
                    env=env, carbonate_impl="kernel")
        b, _ = step(b, grid, forcing, params, 3600.0, compute_diags=False,
                    env=env, carbonate_impl="torch")
    for name in ("dms", "macros"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert torch.equal(a.bgc.tracers, b.bgc.tracers)
    xacc = solver_xacc(state.bgc.tracers.dtype)
    assert _h_diff(a.bgc.ph_prev_3d, b.bgc.ph_prev_3d) <= 2 * xacc
    assert _h_diff(a.bgc.ph_prev_alt_3d, b.bgc.ph_prev_alt_3d) <= 2 * xacc


def _fused_world(cuda, dtype, rest):
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=12, ncol=700, seed=4,
                                           ragged=True, dtype=dtype,
                                           device=cuda)
    if rest:
        params = dataclasses.replace(params, bgc=dataclasses.replace(
            params.bgc, lrest_no3=True, lrest_po4=True, lrest_sio3=True))
        forcing = dataclasses.replace(
            forcing,
            nutr_restore_rtau=torch.full_like(forcing.nutr_restore_rtau,
                                              1e-7),
            no3_clim=forcing.no3_clim * 1.1)
    return params, state, grid, forcing


@pytest.mark.parametrize("rest", [False, True], ids=["", "lrest"])
@pytest.mark.parametrize("use_env", [True, False], ids=["env", "no_env"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_interior_kernel_matches_plain_version(cuda, dtype, use_env, rest):
    """K2 against its plain version (bgc_source_sink with the plain pH
    solve) on cold and warm inputs: pH bitwise equal (the same device
    solve as K1, on the same inputs), tendencies within 1e-10 (f64) or
    3e-5 (f32) of each tracer's largest magnitude, one launch counted."""
    params, state, grid, forcing = _fused_world(cuda, dtype, rest)
    env = precompute_env(grid, forcing, params.bgc) if use_env else None
    warm, _ = step(state, grid, forcing, params, 3600.0,
                   compute_diags=False, env=env)
    tol = 1e-10 if dtype == torch.float64 else 3e-5
    for st in (state, warm):
        b = st.bgc
        before = fused_interior_step.launches
        got = fused_interior_step(b.tracers, grid, forcing, b.ph_prev_3d,
                                  b.ph_prev_alt_3d, params.bgc, env=env,
                                  impl="kernel")
        torch.cuda.synchronize()
        assert fused_interior_step.launches == before + 1
        want = fused_interior_step_torch(b.tracers, grid, forcing,
                                         b.ph_prev_3d, b.ph_prev_alt_3d,
                                         params.bgc, env=env)
        assert torch.equal(got.ph_prev_3d, want.ph_prev_3d)
        assert torch.equal(got.ph_prev_alt_3d, want.ph_prev_alt_3d)
        assert torch.isfinite(got.tendencies).all()
        scale = want.tendencies.abs().amax(dim=(0, 2), keepdim=True) + 1e-30
        err = ((got.tendencies - want.tendencies).abs() / scale).max()
        assert err <= tol, err.item()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_special_cased_torch_sites_match(cuda, dtype):
    """The kernel's device functions where PyTorch's CUDA ops special-case
    their arguments: 0.99 ** x (torch.pow with a scalar base, the
    sedimentary denitrification) and the Morel PAR attenuation
    (ops/numerics.py::morel_kpar), against the torch ops on the card."""
    gen = torch.Generator().manual_seed(3)
    x = (torch.rand(100_000, generator=gen, dtype=torch.float64) * 700
         - 350).to(dtype=dtype, device=cuda)
    assert torch.equal(site_test_hook(x, "sed_pow"), torch.pow(0.99, x))
    chl = (torch.rand(100_000, generator=gen, dtype=torch.float64) * 5
           + 0.02).to(dtype=dtype, device=cuda)
    assert torch.equal(site_test_hook(chl, "morel_kpar"),
                       morel_kpar(chl))


def test_fused_step_launches_k2_once_per_step_and_never_k1(cuda):
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=10, ncol=300, seed=8,
                                           device=cuda)
    env = precompute_env(grid, forcing, params.bgc)
    k1, k2 = co3_terms_dual_coeffs.launches, fused_interior_step.launches
    for _ in range(3):
        state, _ = step(state, grid, forcing, params, 3600.0,
                        compute_diags=False, env=env, interior_impl="fused")
    torch.cuda.synchronize()
    assert fused_interior_step.launches == k2 + 3
    assert co3_terms_dual_coeffs.launches == k1
    assert torch.isfinite(state.bgc.tracers).all()


def test_probe_kernel_matches_plain_version(cuda):
    tr, temp, kmax = probe.probe_inputs(cuda)
    before = probe.probe_patterns.launches
    got = probe.probe_patterns(tr, temp, kmax)
    torch.cuda.synchronize()
    assert probe.probe_patterns.launches == before + 1
    assert probe.max_rel_err(got, probe.probe_patterns_torch(
        tr, temp, kmax)) <= probe.RTOL
