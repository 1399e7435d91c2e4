"""The step's options on top of the diags-off call (diagnostics, health
counters, a filter, the diagnostics' dtype) against what the JAX
package's step does with them, on the CPU."""

import dataclasses

import pytest
import torch

import ocean_bgc_tpu  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from ocean_bgc_tpu.models.coupled import step as jax_step
from ocean_bgc_tpu.params import ModelParams as JaxModelParams
from ocean_bgc_tpu.utils.synthetic import synthetic_world as jax_world

from ocean_bgc_tpu_torch.models.coupled import HEALTH_NAMES, step
from ocean_bgc_tpu_torch.utils.bridge import params_from_dict, world_from_numpy
from ocean_bgc_tpu_torch.utils.diag import coupled_registry
from tests.test_torch_step import DT, _np


@pytest.mark.parametrize("kwargs", [
    dict(compute_diags=True), dict(health=True),
    dict(diag_filter=["pH_3D"]), dict(diag_dtype=torch.float32)])
def test_options_not_ported_yet_raise(kwargs):
    """The four options that raised before the diagnostics were ported,
    each on top of ``compute_diags=False``, now do what the JAX package's
    step does with them (ocean_bgc_tpu/models/coupled.py:232-271), read
    from JAX's own step by ``jax.eval_shape`` (traced, not compiled): the
    same diagnostic names, shapes and dtypes (the 155 of the registry;
    the two health counters alone; none, whatever their dtype), or the
    same ValueError for a filter with nothing to filter.  The step itself
    is the diags-off one, bitwise."""
    js, jg, jf = jax_world(nlev=2, ncol=4, seed=21, ragged=True)
    state, grid, forcing = world_from_numpy(_np(js), _np(jg), _np(jf),
                                            device="cpu")
    jp = JaxModelParams()
    params = params_from_dict(dataclasses.asdict(jp))
    kw = {"compute_diags": False, **kwargs}
    jkw = dict(kw)
    if "diag_dtype" in kw:
        jkw["diag_dtype"] = jnp.float32

    def jax_diags():
        return jax.eval_shape(
            lambda s: jax_step(s, jg, jf, jp, DT, **jkw)[1], js)
    if "diag_filter" in kwargs:
        with pytest.raises(ValueError, match="compute_diags=True") as want:
            jax_diags()
        with pytest.raises(ValueError) as got:
            step(state, grid, forcing, params, DT, **kw)
        assert str(got.value) == str(want.value)
        return
    want = jax_diags()
    out, diags = step(state, grid, forcing, params, DT, **kw)
    assert set(diags) == set(want)
    assert len(diags) == {"compute_diags": len(coupled_registry()),
                          "health": len(HEALTH_NAMES),
                          "diag_dtype": 0}[next(iter(kwargs))]
    for k, v in diags.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype) == f"torch.{want[k].dtype}", k
        assert torch.isfinite(v).all(), k
    plain, _ = step(state, grid, forcing, params, DT, compute_diags=False)
    assert torch.equal(out.bgc.tracers, plain.bgc.tracers)
