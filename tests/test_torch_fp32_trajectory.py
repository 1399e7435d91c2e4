"""The port's float32 path qualified over a long horizon:
``tests/test_fp32_trajectory.py``'s two gates on the torch step, with its
horizon and bounds.

The f32 run's divergence from the port's own f64 run must stay within the
f64 model's response to an f32-epsilon kick of the initial tracers (30
times it) plus 1e-2 of each tracer's scale: f32 rounding behaves like a
tiny initial-condition perturbation, not a bias or an instability.  The
kicked f64 run rides as extra columns of the f64 run (columns never
interact).  ``OCEAN_BGC_TRAJ_STEPS_F32`` steps, 96 by default;
``chip_smoke.py`` runs 720 (a model month) on the card.  No JAX here.
"""

import os

import numpy as np
import torch

from ocean_bgc_tpu_torch.models.coupled import run
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.state import BGCTracers as T
from ocean_bgc_tpu_torch.utils.bridge import world_from_numpy
from ocean_bgc_tpu_torch.utils.synthetic import _synthetic_world_numpy
from tests.test_torch_trajectory import DT, port_run

NSTEPS = int(os.environ.get("OCEAN_BGC_TRAJ_STEPS_F32", "96"))
F32_EPS = 1.1920929e-07


def tracer_envelope(want, kicked, got):
    """Each tracer's f32 mismatch over its envelope: 30 times the
    yardstick (``kicked`` against ``want``, the f64 runs' tracers) plus
    1e-2 of its scale; ``got`` the f32 run's tracers."""
    g = np.asarray(got, np.float64)
    yard = np.abs(kicked - want)
    worst = {}
    for idx in range(T.CNT):
        mismatch = np.abs(g[:, idx] - want[:, idx]).max()
        scale = np.abs(want[:, idx]).max() + 1e-30
        # the amplified single-kick response plus 1% for the rounding
        # f32 injects at every operation of every step
        bound = 30.0 * yard[:, idx].max() + 1e-2 * scale + 1e-12
        worst[f"tracer {idx}"] = float(mismatch / bound)
    return worst


def envelope_gate(want, kicked, got):
    """The f32 envelope on final states (NumPy, the oracle's keys):
    ``want`` the f64 run, ``kicked`` the kicked f64 run's tracers, ``got``
    the f32 run.  Each tracer's mismatch within 30 times the yardstick
    plus 1e-2 of its scale; DMS and MACROS within 1e-2 of their scale.
    Returns the worst mismatch over its bound."""
    assert np.isfinite(np.asarray(got["tracers"])).all()
    worst = tracer_envelope(want["tracers"], kicked, got["tracers"])
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    assert not bad, f"f32 against f64, mismatch / envelope: {bad}"
    for name in ("dms", "macros"):
        a = np.asarray(got[name], np.float64)
        b = want[name]
        assert np.isfinite(a).all()
        scale = np.abs(b).max() + 1e-30
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-2)
        worst[name] = float(np.abs(a - b).max() / scale / 1e-2)
    return max(worst.values())


def f32_envelope(world, nsteps, *, device="cpu"):
    """``nsteps`` steps of the f64 run (with its kicked copy) and of the
    f32 run of ``world`` (NumPy; f32 is its rounding), held by
    :func:`envelope_gate`.  Returns the worst mismatch over its bound."""
    want, kicked = port_run(world, nsteps, kick=F32_EPS, device=device)
    got, _ = port_run(world, nsteps, dtype=torch.float32, device=device)
    return envelope_gate(want, kicked, got)


def drift_gate(nsteps, *, device="cpu"):
    """f32 leaks no mass: the carbon conservation residual of the last
    of ``nsteps`` steps stays at the single-precision noise floor
    (below 1, and below 50 times the fourth step's).  The late residual
    continues the early run.  Returns (early, late)."""
    params = ModelParams()
    state, grid, forcing = world_from_numpy(
        *_synthetic_world_numpy(nlev=6, ncol=8, seed=42, ragged=False),
        device=device, dtype=torch.float32)
    state, d_early = run(state, grid, forcing, params, DT, 4,
                         compute_diags=True)
    _, d_late = run(state, grid, forcing, params, DT, nsteps - 4,
                    compute_diags=True)
    early = float(d_early["Jint_Ctot"].abs().max())
    late = float(d_late["Jint_Ctot"].abs().max())
    assert late < 1.0, f"Jint_Ctot grew to {late}"
    assert late < 50.0 * (early + 1e-6)
    return early, late


def test_fp32_trajectory_within_perturbation_envelope():
    world = _synthetic_world_numpy(nlev=6, ncol=8, seed=41, ragged=False)
    f32_envelope(world, NSTEPS)


def test_fp32_no_systematic_drift():
    drift_gate(NSTEPS)
