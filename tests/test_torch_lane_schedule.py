"""The seeded K1 kernels' launch schedule on the CPU: the launch shape
of a seeded launch, the parked-tail cap's checks, the C entry points'
signatures against ``csrc/carbonate_dual.cu``, and the kernel route's
refusal of CPU tensors.  No JAX; the kernels themselves are held to
their plain versions on the card (``tests/test_torch_cuda.py``)."""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from ocean_bgc_tpu_torch.constants import MAXIT
from ocean_bgc_tpu_torch.ops import cuda_carbonate as cc
from ocean_bgc_tpu_torch.ops.carbonate import (
    CarbCoeffs,
    _to_mass_units,
    carbonate_coeffs,
)

SOURCE = (Path(cc.__file__).resolve().parent.parent / "csrc"
          / "carbonate_dual.cu")


@pytest.mark.parametrize("sms", [132, 114, 16])
def test_seeded_launch_shape_covers_every_lane(sms):
    """Every lane gets a thread and no block is empty; blocks are whole
    warps up to 256 threads; from 32 lanes per SM on every SM gets a
    block (the surface pair's 16,384 lanes on 132 SMs among them), at
    every block size the sweep tries and at each type's default."""
    for max_warps in (1, 2, 4, 8, *cc.SEEDED_MAX_WARPS.values()):
        for n in (1, 31, 32, 33, 257, 7 * 37, 32 * sms - 1, 32 * sms,
                  16384, 60 * 8192, 60 * 131072):
            blocks, threads = cc.seeded_launch_shape(n, sms, max_warps)
            assert threads % 32 == 0 and 32 <= threads <= 32 * max_warps
            assert threads <= 256, (n, threads)
            assert blocks * threads >= n > (blocks - 1) * threads, (n,
                                                                    blocks)
            if n >= 32 * sms:
                assert blocks >= sms, (n, blocks)
        assert cc.seeded_launch_shape(60 * 8192, sms, max_warps)[1] == (
            32 * max_warps)


def test_parked_tail_cap_is_checked_before_a_launch():
    """A negative cap, and at f64 (which has no parked kernel) any cap
    below MAXIT, is refused before any kernel is loaded; each type's
    default is a cap the kernel takes."""
    for dtype in (torch.float64, torch.float32):
        x = torch.ones(8, dtype=dtype)
        with pytest.raises(ValueError, match="at least 0"):
            cc._launch((x,) * 21, x.dtype, True, cap=-1)
    x = torch.ones(8, dtype=torch.float64)
    for cap in (0, cc.PARK_CAP, MAXIT - 1):
        with pytest.raises(ValueError, match="f32 only"):
            cc._launch((x,) * 21, x.dtype, True, cap=cap)
    assert isinstance(cc.PARK_CAP, int) and 0 <= cc.PARK_CAP < MAXIT
    assert cc.dual_cap(torch.float32) == cc.PARK_CAP
    assert cc.dual_cap(torch.float64) == MAXIT
    assert cc.dual_cap(torch.float64, MAXIT + 1) == MAXIT + 1
    assert all(w in (1, 2, 4, 8) for w in cc.SEEDED_MAX_WARPS.values())


def _c_params(name, source=SOURCE):
    """The parameter types of ``extern "C" int name(...)`` in
    ``source``, as ctypes types."""
    text = source.read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    types = {"int": ctypes.c_int, "unsigned": ctypes.c_uint,
             "long long": ctypes.c_longlong, "void*": ctypes.c_void_p,
             "const void*": ctypes.c_void_p,
             "const void* const*": ctypes.POINTER(ctypes.c_void_p),
             "void* const*": ctypes.POINTER(ctypes.c_void_p)}
    params = [" ".join(p.split()[:-1]) for p in m[1].split(",")]
    return [types[p] for p in params]


@pytest.mark.parametrize("name, argtypes", [
    ("obgc_carbonate_dual", cc.DUAL_ARGTYPES),
    ("obgc_solve_htotal_brackets", cc.BRACKETS_ARGTYPES),
    ("obgc_solve_htotal_brackets_stats", cc.BRACKETS_STATS_ARGTYPES)])
def test_entry_point_signatures_match_the_source(name, argtypes):
    """ctypes passes each argument as the wrapper's signature says: a
    mismatch with the C declaration would shift every argument after
    it without an error."""
    assert _c_params(name) == list(argtypes)


def test_seeded_kernel_route_refuses_cpu_tensors():
    """impl="kernel" raises on CPU tensors for every seeded route: no
    wrapper falls back to its plain version."""
    rng = torch.Generator().manual_seed(5)
    n = 33
    depth = torch.full((1, n), 10.0, dtype=torch.float64)
    temp = 5.0 + 20.0 * torch.rand(1, n, generator=rng, dtype=torch.float64)
    salt = torch.full((1, n), 35.0, dtype=torch.float64)
    tr = [torch.full((1, n), v, dtype=torch.float64)
          for v in (2000.0, 2300.0, 1.0, 10.0)]
    ph = torch.full((1, n), 8.0, dtype=torch.float64)
    coeffs = carbonate_coeffs(depth, temp, salt,
                              torch.zeros(1, 1, dtype=torch.bool))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cc.co3_terms_dual_coeffs(*tr, ph, ph, coeffs, seed=True,
                                 impl="kernel")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cc.co3_terms_dual_sat(depth, temp, salt, *tr, ph, ph, seed=True,
                              impl="kernel")
    m = _to_mass_units(*(t[0] for t in tr))
    x = torch.full((n,), 1e-8, dtype=torch.float64)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cc.solve_htotal_brackets(CarbCoeffs(*(k[0] for k in coeffs)), *m,
                                 x * 0.5, x * 2.0, seed=x, impl="kernel")
