"""P, the probe of the whole-interior kernel's patterns, on the CPU: the C
entry point's signature against ``csrc/probe_patterns.cu``, the launch
shape, and the plain version at any shape against a NumPy transcription
of ``scripts/probe_mosaic.py``'s kernel.  No JAX (the plain version is
held to the Pallas kernel in interpret mode at the probe's shape by
``tests/test_torch_fused.py``); the kernel itself is held to the plain
version on the card (``tests/test_torch_cuda.py``)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from ocean_bgc_tpu_torch import probe
from tests.test_torch_lane_schedule import _c_params

SOURCE = (Path(probe.__file__).resolve().parent / "csrc"
          / "probe_patterns.cu")
NCOLS = (1, 31, 33, 257, 8192)


def mosaic_numpy(tr, temp, kmax):
    """``scripts/probe_mosaic.py::kernel`` (:35-106) in NumPy float32, a
    column's levels in order: the exclusive cumsum as a running sum, the
    Newton sqrt's lanes each frozen on its own convergence."""
    tr, temp, kmax = tr.numpy(), temp.numpy(), kmax.numpy()
    f32 = np.float32
    nlev, ntr, _ = tr.shape
    active = np.arange(nlev, dtype=np.int32)[:, None] < kmax
    tf = np.where(active, f32(2.0) ** ((temp - f32(10.0)) / f32(10.0)),
                  f32(1.0))
    kpar = np.where(active, f32(0.01) * temp, f32(0.0))
    cum = np.zeros_like(kpar)
    for k in range(1, nlev):
        cum[k] = cum[k - 1] + kpar[k - 1]
    par_in = np.exp(-cum)
    x, act = np.ones_like(temp), np.ones(temp.shape, bool)
    for _ in range(20):
        if not act.any():
            break
        xn = f32(0.5) * (x + temp / np.maximum(x, f32(1e-6)))
        conv = np.abs(xn - x) < f32(1e-4)
        x = np.where(act, xn, x)
        act = act & ~conv
    src = par_in * tf
    flux_s = flux_h = np.zeros_like(temp[0])
    remin_all = np.zeros_like(temp)
    for k in range(nlev):
        act_k, is_bot = k < kmax[0], k + 1 == kmax[0]
        o2row = np.maximum(tr[k, 3], f32(0.0))
        dec = np.exp(f32(-0.1) * (f32(1.0) + f32(0.01) * o2row))
        f_s = flux_s * dec + src[k]
        f_h = flux_h * f32(0.99)
        remin = (flux_s - f_s) + (flux_h - f_h)
        f_s = np.where(is_bot, f32(0.0), f_s)
        f_h = np.where(is_bot, f32(0.0), f_h)
        flux_s = np.where(act_k, f_s, flux_s)
        flux_h = np.where(act_k, f_h, flux_h)
        remin_all[k] = np.where(act_k, remin, f32(0.0))
    out = par_in + x + remin_all
    tend = np.stack([remin_all * f32(t + 1) for t in range(ntr)], axis=1)
    return torch.from_numpy(out), torch.from_numpy(tend)


def test_entry_point_signature_matches_the_source():
    """ctypes passes each argument as the wrapper's ARGTYPES say: a
    mismatch with the C declaration would shift every argument after it
    without an error."""
    assert _c_params("obgc_probe_patterns", SOURCE) == list(probe.ARGTYPES)


def test_launch_shape_covers_every_column():
    """Every column gets a block and every cell of a block a thread (the
    threads stride over the cells past 1024), blocks are whole warps,
    the tile's cells fit the kernel's shared memory, and the probe's
    12 x 128 spreads over more than one block."""
    for nlev in (1, 12, 60, 61, probe.TILE_CELLS):
        for ncol in NCOLS:
            for tile in (1, 2, probe.TILE, 32, 256):
                t, blocks, threads = probe.launch_shape(nlev, ncol, tile)
                assert 1 <= t <= min(tile, ncol) and blocks * t >= ncol
                assert (blocks - 1) * t < ncol
                assert threads % 32 == 0 and t <= threads <= 1024
                assert threads >= min(1024, t * nlev)
                assert t * nlev <= probe.TILE_CELLS
    assert probe.launch_shape(probe.NLEV, probe.C)[1] > 1
    with pytest.raises(ValueError, match="levels"):
        probe.launch_shape(probe.TILE_CELLS + 1, 8)


@pytest.mark.parametrize("nlev", [1, 12, 60])
def test_plain_version_matches_numpy_transcription(nlev):
    """The plain version against the NumPy transcription of the Pallas
    kernel at every column count, kmax over 0..nlev with columns at 0 and
    at nlev, within RTOL of each output's scale."""
    for seed, ncol in enumerate(NCOLS):
        args = probe.shaped_inputs(nlev, ncol, seed=seed, device="cpu")
        kmax = args[2]
        assert int(kmax.max()) == nlev or ncol == 1
        assert int(kmax.min()) == 0 or ncol == 1
        got = probe.probe_patterns_torch(*args)
        assert probe.max_rel_err(got, mosaic_numpy(*args)) <= probe.RTOL


def test_cpu_tensors_take_the_plain_route():
    """On CPU tensors the wrapper returns the plain version's outputs and
    launches nothing, at the probe's shape and at a ragged one; the
    probe's own inputs are those of scripts/probe_mosaic.py."""
    before = probe.probe_patterns.launches
    for args in (probe.probe_inputs("cpu"),
                 probe.shaped_inputs(60, 33, ntr=4, device="cpu")):
        got = probe.probe_patterns(*args)
        want = probe.probe_patterns_torch(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert probe.probe_patterns.launches == before
    tr, temp, kmax = probe.probe_inputs("cpu")
    assert tuple(tr.shape) == (probe.NLEV, probe.NTR, probe.C)
    assert int(kmax.min()) >= 1 and int(kmax.max()) <= probe.NLEV
    assert float(temp.min()) >= 0.0 and float(temp.max()) < 20.0
