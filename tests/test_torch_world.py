"""The port's synthetic world and device choice against the JAX
package's: the same world bit for bit at f64 and f32, with land and
shelf columns, and CUDA asked for by default, raising where there is no
card."""

import dataclasses

import numpy as np
import pytest
import torch

import ocean_bgc_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp

from ocean_bgc_tpu.utils.synthetic import synthetic_world as jax_world

from ocean_bgc_tpu_torch.utils.bridge import resolve_device
from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_synthetic_world_bitwise_equal(dtype):
    jdt = None if dtype == "float64" else jnp.float32
    js, jg, jf = jax_world(nlev=7, ncol=40, seed=11, ragged=True, dtype=jdt)
    ts, tg, tf = synthetic_world(nlev=7, ncol=40, seed=11, ragged=True,
                                 dtype=getattr(torch, dtype), device="cpu")
    pairs = [(js.bgc, ts.bgc), (jg, tg), (jf, tf)]
    for jobj, tobj in pairs:
        for f in dataclasses.fields(jobj):
            a = np.asarray(getattr(jobj, f.name))
            b = getattr(tobj, f.name).numpy()
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    np.testing.assert_array_equal(np.asarray(js.dms), ts.dms.numpy())
    np.testing.assert_array_equal(np.asarray(js.macros), ts.macros.numpy())
    # the world exercises land and shelf columns
    kmax = tg.kmax.numpy()
    assert (kmax == 0).any() and ((kmax > 0) & (kmax < 7)).any()


def test_cuda_device_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_world(nlev=2, ncol=4)
