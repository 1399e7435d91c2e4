"""The kernels' build on the CPU: the generated constants header holds
the plain versions' doubles, a library's hash covers the shared headers,
and P's plain version against ``scripts/probe_mosaic.py``'s kernel in
interpret mode.  The kernels themselves run only on the card
(tests/test_torch_cuda.py)."""

import importlib.util
import re

import numpy as np

import ocean_bgc_tpu  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from ocean_bgc_tpu_torch import constants, probe
from ocean_bgc_tpu_torch.ops import _kernels
from ocean_bgc_tpu_torch.utils.profiling import counters
from tests.test_torch_fused import CSRC, REPO


def test_generated_constants_header_holds_the_same_doubles():
    text = _kernels.constants_header()
    values = dict(re.findall(r"constexpr double (\w+) = ([^;]+);", text))
    assert values
    for name in (n for n in dir(constants) if n.isupper()):
        value = getattr(constants, name)
        if isinstance(value, float):
            assert float(values[name]) == value, name
    assert "TR_SI_IND[4] = {-1, 23, -1, -1}" in text


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """Editing csrc/carbonate_solve.cuh must rebuild K1 and K2."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in CSRC.iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    before = {n: _kernels.library_path(n) for n in _kernels.SOURCES}
    header = csrc / "carbonate_solve.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _kernels.library_path(n) for n in _kernels.SOURCES}
    assert all(before[n] != after[n] for n in _kernels.SOURCES)


def test_probe_plain_version_matches_jax_probe_kernel():
    """P's plain version against scripts/probe_mosaic.py's kernel through
    pl.pallas_call(interpret=True) at 12 x 5 x 128 f32; rtol 1e-5, since
    the exclusive cumsum is summed in another order than JAX's 12 x 12
    matmul (each output scaled by its largest magnitude)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    spec = importlib.util.spec_from_file_location(
        "probe_mosaic", REPO / "scripts" / "probe_mosaic.py")
    mosaic = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mosaic)     # defines kernel; main() not run

    tr, temp, kmax = probe.probe_inputs("cpu")
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    call = pl.pallas_call(
        mosaic.kernel,
        out_shape=(jax.ShapeDtypeStruct(temp.shape, jnp.float32),
                   jax.ShapeDtypeStruct(tr.shape, jnp.float32)),
        in_specs=[vmem] * 3, out_specs=(vmem, vmem),
        scratch_shapes=[pltpu.VMEM(tuple(temp.shape), jnp.float32)] * 2,
        interpret=True)
    want = call(tr.numpy(), temp.numpy(), kmax.numpy())
    got = probe.probe_patterns(tr, temp, kmax)
    assert counters()["probe"] == 0
    for g, w in zip(got, want):
        scale = np.abs(np.asarray(w)).max()
        np.testing.assert_allclose(g.numpy() / scale, np.asarray(w) / scale,
                                   rtol=0, atol=1e-5)
