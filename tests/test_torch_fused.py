"""The fused interior path of the port (``interior_impl="fused"``, K2 in
``ops/cuda_step.py``) on the CPU: its plain version against the JAX
package's ``bgc_source_sink``, the step through it, and the kernel's
inputs.  The options it refuses and the kernel's argument layout against
the Python side are in ``tests/test_torch_fused_layout.py``; the build's
generated header and hashing, and P's plain version against JAX's probe
kernel, in ``tests/test_torch_kernel_build.py``.  The kernels themselves
run only on the card (tests/test_torch_cuda.py)."""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import ocean_bgc_tpu  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from ocean_bgc_tpu.ops.bgc import bgc_source_sink as jax_bgc_source_sink
from ocean_bgc_tpu.ops.bgc import precompute_env as jax_precompute_env
from ocean_bgc_tpu.params import ModelParams as JaxModelParams
from ocean_bgc_tpu.utils.synthetic import synthetic_world as jax_world

from ocean_bgc_tpu_torch import constants
from ocean_bgc_tpu_torch.models.coupled import step
from ocean_bgc_tpu_torch.ops.bgc import precompute_env
from ocean_bgc_tpu_torch.ops.carbonate import XACC_F32
from ocean_bgc_tpu_torch.ops.cuda_step import (
    KERNEL_FIELDS,
    fused_interior_step,
    kernel_inputs,
)
from ocean_bgc_tpu_torch.params import BGCParams, ModelParams
from ocean_bgc_tpu_torch.state import BGCTracers as T
from ocean_bgc_tpu_torch.utils.bridge import params_from_dict, world_from_numpy
from ocean_bgc_tpu_torch.utils.profiling import counters

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "ocean_bgc_tpu_torch" / "csrc"
NLEV, NCOL, DT = 8, 32, 3600.0


def _np(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return np.asarray(x)


@functools.lru_cache(maxsize=None)
def _jax_reference(dtype):
    """JAX's bgc_source_sink(compute_diags=False, carbonate_impl="xla"),
    the reference JAX's own fused test uses, on the cold initial state
    and on the warm state its pH gives: with the env cache (built
    eagerly, as tests/test_torch_step.py builds it) and, at f64, without
    it, both in one compile (each costs seconds).  Returns the world, the
    parameters and ``{use_env: [(ph, ph_alt, out) cold, ... warm]}``."""
    jdt = None if dtype == "float64" else jnp.float32
    js, jg, jf = jax_world(nlev=NLEV, ncol=NCOL, seed=21, ragged=True,
                           dtype=jdt)
    jp = JaxModelParams()
    envs = {True: jax_precompute_env(jg, jf, jp.bgc)}
    if dtype == "float64":
        envs[False] = None

    @jax.jit
    def run(phs, envs):
        return {k: jax_bgc_source_sink(js.bgc.tracers, jg, jf, *phs[k],
                                       jp.bgc, compute_diags=False,
                                       carbonate_impl="xla", env=envs[k])
                for k in phs}

    phs = {k: (js.bgc.ph_prev_3d, js.bgc.ph_prev_alt_3d) for k in envs}
    runs = {k: [] for k in envs}
    for _ in ("cold", "warm"):
        outs = run(phs, envs)
        for k, out in outs.items():
            runs[k].append((*(np.asarray(x) for x in phs[k]),
                            jax.tree_util.tree_map(np.asarray, out)))
            phs[k] = (out.ph_prev_3d, out.ph_prev_alt_3d)
    return (js, jg, jf), jp, runs


@pytest.mark.parametrize("dtype,use_env", [("float64", True),
                                           ("float64", False),
                                           ("float32", True),
                                           ("float32", False)],
                         ids=["float64-env", "float64-no_env",
                              "float32-env", "float32-no_env"])
def test_plain_route_matches_jax_bgc_source_sink(dtype, use_env):
    """The port's fused_interior_step on CPU tensors (its plain route)
    against JAX's bgc_source_sink(compute_diags=False,
    carbonate_impl="xla") on the cold initial state and on the warm state
    its pH gives.  The tolerances of tests/test_torch_step.py: tendencies
    to 1e-13 (f64) or 1e-5 (f32) of each tracer's scale, pH to |dH| <= 2
    xacc (with two ulps of the f32 pH output added at f32).

    At f32 without the env cache the port evaluates the same tables as
    with it, value for value, while JAX's tables under jit differ from
    its own eager ones by enough to move its pH by more than 2 xacc:
    that case is held to JAX's run with the cache."""
    (js, jg, jf), jp, runs = _jax_reference(dtype)
    ts, tg, tf = world_from_numpy(_np(js), _np(jg), _np(jf), device="cpu",
                                  dtype=getattr(torch, dtype))
    tp = params_from_dict(dataclasses.asdict(jp))
    tenv = precompute_env(tg, tf, tp.bgc) if use_env else None
    xacc = constants.XACC if dtype == "float64" else XACC_F32
    tol = 1e-13 if dtype == "float64" else 1e-5

    ref = runs[use_env if use_env in runs else True]
    for label, (ph, ph_alt, want) in zip(("cold", "warm"), ref):
        got = fused_interior_step(
            ts.bgc.tracers, tg, tf, torch.tensor(ph), torch.tensor(ph_alt),
            tp.bgc, env=tenv)
        a = want.tendencies
        b = got.tendencies.numpy()
        assert b.dtype == a.dtype and np.isfinite(b).all()
        for i in range(T.CNT):
            scale = np.abs(a[:, i]).max() + 1e-30
            np.testing.assert_allclose(b[:, i] / scale, a[:, i] / scale,
                                       rtol=0, atol=tol,
                                       err_msg=f"{label} tracer {i}")
        for w, g in ((want.ph_prev_3d, got.ph_prev_3d),
                     (want.ph_prev_alt_3d, got.ph_prev_alt_3d)):
            g = g.numpy()
            np.testing.assert_array_equal(w == 0.0, g == 0.0)
            w64, g64 = w.astype(np.float64), g.astype(np.float64)
            hw = np.where(w64 != 0.0, 10.0 ** -w64, 0.0)
            hg = np.where(g64 != 0.0, 10.0 ** -g64, 0.0)
            ulp = np.spacing(np.abs(w)).astype(np.float64)
            lim = 2 * xacc + (2 * np.log(10.0) * hw * ulp
                              if dtype == "float32" else 0.0)
            assert (np.abs(hw - hg) <= lim).all(), label


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_step_equals_default_step_on_cpu(dtype):
    """On CPU tensors both interiors run the same plain code, so three
    steps through either are bitwise equal, and no kernel launch is
    counted."""
    s, g, f = world_from_numpy(*_np_world(), device="cpu", dtype=dtype)
    params = ModelParams()
    env = precompute_env(g, f, params.bgc)
    before = (counters()["k2.solve"],
              counters()["k2.bio"])
    a = b = s
    for _ in range(3):
        a, _ = step(a, g, f, params, DT, compute_diags=False, env=env,
                    interior_impl="fused")
        b, _ = step(b, g, f, params, DT, compute_diags=False, env=env)
    assert (counters()["k2.solve"],
            counters()["k2.bio"]) == before
    for x, y in ((a.bgc.tracers, b.bgc.tracers), (a.dms, b.dms),
                 (a.macros, b.macros), (a.bgc.ph_prev_3d, b.bgc.ph_prev_3d),
                 (a.bgc.ph_prev_alt_3d, b.bgc.ph_prev_alt_3d)):
        assert torch.equal(x, y)
    # land columns (kmax = 0) keep their pH and get no interior tendency
    land = g.kmax == 0
    assert land.any()
    assert torch.equal(a.bgc.ph_prev_3d[:, land], s.bgc.ph_prev_3d[:, land])


def _np_world(nlev=NLEV, ncol=NCOL, seed=21):
    js, jg, jf = jax_world(nlev=nlev, ncol=ncol, seed=seed, ragged=True)
    return _np(js), _np(jg), _np(jf)


def test_kernel_impl_on_cpu_tensors_raises():
    s, g, f = world_from_numpy(*_np_world(nlev=2, ncol=4), device="cpu")
    b = s.bgc
    with pytest.raises(ValueError, match="CUDA"):
        fused_interior_step(b.tracers, g, f, b.ph_prev_3d, b.ph_prev_alt_3d,
                            BGCParams(), impl="kernel")
    for bad in ("pallas", "torch"):
        with pytest.raises(ValueError, match="impl"):
            fused_interior_step(b.tracers, g, f, b.ph_prev_3d,
                                b.ph_prev_alt_3d, BGCParams(), impl=bad)


def test_kernel_inputs_follow_the_env_and_the_gates():
    s, g, f = world_from_numpy(*_np_world(nlev=3, ncol=8), device="cpu")
    params = BGCParams()
    b = s.bgc
    env = precompute_env(g, f, params)
    with_env = kernel_inputs(b.tracers, g, f, b.ph_prev_3d,
                             b.ph_prev_alt_3d, params, env)
    without = kernel_inputs(b.tracers, g, f, b.ph_prev_3d,
                            b.ph_prev_alt_3d, params, None)
    assert set(with_env) == set(KERNEL_FIELDS) - {"tend", "ph", "ph_alt"}
    # the tables evaluated here are the env cache's, value for value
    for name in ("tfunc", "k1", "kw", "decay_sio2", "scalelength"):
        assert torch.equal(with_env[name], without[name]), name
    assert all(with_env[k] is None for k in ("rtau", "no3_clim", "po4_clim",
                                              "sio3_clim"))
    gated = kernel_inputs(b.tracers, g, f, b.ph_prev_3d, b.ph_prev_alt_3d,
                          dataclasses.replace(params, lrest_po4=True), env)
    assert gated["rtau"] is not None and gated["po4_clim"] is not None
    assert gated["no3_clim"] is None and gated["sio3_clim"] is None


