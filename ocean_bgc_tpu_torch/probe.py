"""P, the probe of the whole-interior kernel's patterns, on the card.

Counterpart of ``scripts/probe_mosaic.py``: one small kernel
(``csrc/probe_patterns.cu``) exercising the patterns K2 needs on
synthetic algebra at 12 levels x 5 tracers x 128 columns in float32 —
masked algebra with selects, an exclusive cumsum over levels, a masked
Newton sqrt whose lanes freeze on their own convergence, a level
recurrence over a two-field carry, int32 kmax masks and stores into a
(nlev, ntr, ncol) block.  :func:`probe_patterns_torch` is its plain
PyTorch version.

    python -m ocean_bgc_tpu_torch.probe

builds the kernel, runs it on the probe's inputs on the card, checks it
against the plain version and prints the checksum.
"""

from __future__ import annotations

import ctypes
import sys
import time

import numpy as np
import torch

from ocean_bgc_tpu_torch.ops import _kernels
from ocean_bgc_tpu_torch.utils.profiling import count, readback, synchronize

NLEV, NTR, C = 12, 5, 128
# kernel vs plain version on the card: the same operations in the same
# order, so the two agree to float32 rounding of the library calls
RTOL = 1e-6


def probe_inputs(device=None):
    """The probe's inputs, as scripts/probe_mosaic.py makes them: tr
    (12, 5, 128) and temp (12, 128) float32, kmax (1, 128) int32."""
    tr = np.random.RandomState(0).rand(NLEV, NTR, C).astype(np.float32)
    temp = (np.random.RandomState(1).rand(NLEV, C) * 20).astype(np.float32)
    kmax = np.random.RandomState(2).randint(1, NLEV + 1, (1, C)).astype(
        np.int32)
    dev = torch.device("cuda" if device is None else device)
    return (torch.tensor(tr, device=dev), torch.tensor(temp, device=dev),
            torch.tensor(kmax, device=dev))


def shaped_inputs(nlev, ncol, ntr=NTR, seed=0, device=None):
    """Inputs of P at any shape, made as :func:`probe_inputs` makes the
    probe's, with kmax drawn over 0..nlev, its first column at 0 and its
    last at nlev (a single column at nlev)."""
    rng = np.random.RandomState(seed)
    tr = rng.rand(nlev, ntr, ncol).astype(np.float32)
    temp = (rng.rand(nlev, ncol) * 20).astype(np.float32)
    kmax = rng.randint(0, nlev + 1, (1, ncol)).astype(np.int32)
    kmax[0, 0] = 0
    kmax[0, -1] = nlev
    dev = torch.device("cuda" if device is None else device)
    return (torch.tensor(tr, device=dev), torch.tensor(temp, device=dev),
            torch.tensor(kmax, device=dev))


def probe_patterns_torch(tr, temp, kmax):
    """The plain PyTorch version of P: ``(out (nlev, C), tend (nlev,
    ntr, C))`` from tr (nlev, ntr, C), temp (nlev, C), kmax (1, C)."""
    nlev, ntr, _ = tr.shape
    k = torch.arange(nlev, dtype=kmax.dtype, device=kmax.device)[:, None]
    active = k < kmax

    tf = torch.where(active, torch.pow(2.0, (temp - 10.0) / 10.0), 1.0)
    kpar = torch.where(active, 0.01 * temp, 0.0)
    cum = torch.cat([torch.zeros_like(kpar[:1]),
                     torch.cumsum(kpar, dim=0)[:-1]], dim=0)
    par_in = torch.exp(-cum)

    x = torch.ones_like(temp)
    act = torch.ones_like(active)
    for _ in range(20):
        if not bool(readback(act.any())):
            break
        xn = 0.5 * (x + temp / torch.clamp_min(x, 1e-6))
        conv = torch.abs(xn - x) < 1e-4
        x = torch.where(act, xn, x)
        act = act & ~conv

    src_all = par_in * tf
    flux_s = flux_h = torch.zeros_like(temp[0])
    remin_all = []
    for lev in range(nlev):
        act_k = active[lev]
        is_bot = (lev + 1) == kmax[0]
        o2row = torch.clamp_min(tr[lev, 3], 0.0)
        dec = torch.exp(-0.1 * (1.0 + 0.01 * o2row))
        f_s = flux_s * dec + src_all[lev]
        f_h = flux_h * 0.99
        remin = (flux_s - f_s) + (flux_h - f_h)
        f_s = torch.where(is_bot, 0.0, f_s)
        f_h = torch.where(is_bot, 0.0, f_h)
        flux_s = torch.where(act_k, f_s, flux_s)
        flux_h = torch.where(act_k, f_h, flux_h)
        remin_all.append(torch.where(act_k, remin, 0.0))
    remin_all = torch.stack(remin_all)
    out = par_in + x + remin_all
    tend = torch.stack([remin_all * float(t + 1) for t in range(ntr)], dim=1)
    return out, tend


# the columns of one block of the kernel (csrc/probe_patterns.cu): at the
# probe's 128 columns, 16 blocks over the card's SMs
TILE = 8
# the kernel's shared memory: 4 floats a cell of a tile, at most 48 KB
TILE_CELLS = 48 * 1024 // 16
# the argument types of csrc/probe_patterns.cu's obgc_probe_patterns
ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def launch_shape(nlev, ncol, tile=TILE):
    """``(tile, blocks, threads)`` of P's launch at ``nlev`` levels and
    ``ncol`` columns: ``tile`` columns a block (fewer where the block's
    cells would not fit its shared memory, or there are fewer columns),
    one thread a cell up to 1024, in whole warps."""
    if nlev > TILE_CELLS:
        raise ValueError(f"probe_patterns takes at most {TILE_CELLS} "
                         f"levels, got {nlev}")
    tile = max(1, min(tile, ncol, TILE_CELLS // nlev))
    threads = min(1024, -(-tile * nlev // 32) * 32)
    return tile, -(-ncol // tile), threads


def _launch(tr, temp, kmax, tile=TILE):
    """One launch of P in blocks of ``tile`` columns (see
    :func:`launch_shape`); adds one to the counter ``probe``."""
    nlev, ntr, ncol = tr.shape
    tile, _, threads = launch_shape(nlev, ncol, tile)
    lib = _kernels.load("probe_patterns")
    fn = lib.obgc_probe_patterns
    fn.argtypes = list(ARGTYPES)
    fn.restype = ctypes.c_int
    out = torch.empty_like(temp)
    tend = torch.empty_like(tr)
    code = fn(tr.data_ptr(), temp.data_ptr(), kmax.data_ptr(),
              out.data_ptr(), tend.data_ptr(), nlev, ntr, ncol, tile,
              threads, torch.cuda.current_stream(tr.device).cuda_stream)
    _kernels.check(lib, code, "probe_patterns launch")
    count("probe")
    return out, tend


def probe_patterns(tr, temp, kmax):
    """P on CUDA tensors, its plain version on CPU tensors.  Each kernel
    launch adds one to the counter ``probe``."""
    if tr.device.type == "cpu":
        return probe_patterns_torch(tr, temp, kmax)
    nlev, ntr, ncol = tr.shape
    for t, dtype, shape in ((tr, torch.float32, (nlev, ntr, ncol)),
                            (temp, torch.float32, (nlev, ncol)),
                            (kmax, torch.int32, (1, ncol))):
        if (t.device.type != "cuda" or t.device != tr.device
                or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"probe_patterns needs contiguous CUDA "
                             f"tensors: tr (nlev, ntr, C) and temp (nlev, "
                             f"C) float32, kmax (1, C) int32; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if ntr < 4:
        raise ValueError(f"probe_patterns reads tracer slot 3: ntr >= 4, "
                         f"got {ntr}")
    return _launch(tr, temp, kmax)


def run(device=None):
    """The probe's path: its inputs through :func:`probe_patterns`.
    Returns ``(out, tend, checksum)``."""
    tr, temp, kmax = probe_inputs(device)
    out, tend = probe_patterns(tr, temp, kmax)
    return out, tend, (float(readback(out.sum()))
                       + float(readback(tend.sum())))


def max_rel_err(got, want):
    """max |got - want| / max |want| over both outputs."""
    return max(readback((g - w).abs().max() / w.abs().max()).item()
               for g, w in zip(got, want))


def main() -> int:
    if not torch.cuda.is_available():
        print("the probe needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    out, tend, checksum = run()
    synchronize()
    err = max_rel_err((out, tend), probe_patterns_torch(*probe_inputs()))
    print(f"OK build+run in {time.perf_counter() - t0:.1f}s, "
          f"checksum={checksum:.6g}, max error / scale vs the plain "
          f"version {err:.3g} (limit {RTOL:g})")
    return 0 if err <= RTOL else 1


if __name__ == "__main__":
    sys.exit(main())
