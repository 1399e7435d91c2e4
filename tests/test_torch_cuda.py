"""K1 on the card against its plain version, and the production step with
the kernel against the step with the plain version.  Needs an NVIDIA GPU
with the CUDA toolkit (nvcc); skips without one.  Run on the card with
``python -m pytest -m cuda tests/test_torch_cuda.py``."""

import pytest
import torch

from ocean_bgc_tpu_torch.models.coupled import step
from ocean_bgc_tpu_torch.ops.bgc import carbonate_inputs, precompute_env
from ocean_bgc_tpu_torch.ops.carbonate import solver_xacc
from ocean_bgc_tpu_torch.ops.cuda_carbonate import (
    co3_terms_dual_coeffs,
    co3_terms_dual_coeffs_torch,
)
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
