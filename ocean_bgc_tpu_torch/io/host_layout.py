"""Host-layout <-> device-layout marshaling (ctypes binding of the native
C++ library, with a NumPy path).

A copy of ``ocean_bgc_tpu/io/host_layout.py`` (NumPy and ctypes only; the
port imports nothing of the JAX package), held to it by
tests/test_torch_host_api.py.  Host ocean models store column-major
``(cell, level[, tracer])`` blocks; the port computes on level-major
``(nlev[, ntracer], ncol)`` tensors (``state.py``'s layout).  The
transform sits on the coupling path every step, so it is a cache-blocked,
threaded C++ library (``native/column_pack.cc``) built by
``native/Makefile`` on first use and loaded here through ctypes; where no
toolchain builds it, the NumPy path runs.  Both are exact transposes (and
the f32 widening exact), so every caller gets bitwise the same arrays.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(
    os.path.join(_NATIVE_DIR, "build", "libcolumnpack.so"))

_lib: Optional[ctypes.CDLL] = None
_tried_build = False


def _load() -> Optional[ctypes.CDLL]:
    """Load (building on first use) the native library; None if unavailable."""
    global _lib, _tried_build
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not _tried_build:
        _tried_build = True
        try:
            subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    i64 = ctypes.c_int64
    dp = ctypes.POINTER(ctypes.c_double)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.pack_level_major.argtypes = [dp, dp, i64, i64]
    lib.unpack_level_major.argtypes = [dp, dp, i64, i64]
    lib.pack_tracers.argtypes = [dp, dp, i64, i64, i64]
    lib.pack_tracers_f32.argtypes = [fp, dp, i64, i64, i64]
    lib.unpack_tracers.argtypes = [dp, dp, i64, i64, i64]
    for fn in (lib.pack_level_major, lib.unpack_level_major,
               lib.pack_tracers, lib.pack_tracers_f32, lib.unpack_tracers):
        fn.restype = None
    lib.scrub_nonfinite.argtypes = [dp, i64, ctypes.c_double]
    lib.scrub_nonfinite.restype = i64
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def to_level_major(host: np.ndarray) -> np.ndarray:
    """(ncol, nlev) -> (nlev, ncol) as a contiguous float64 array."""
    host = np.ascontiguousarray(host, dtype=np.float64)
    ncol, nlev = host.shape
    lib = _load()
    if lib is None:
        return np.ascontiguousarray(host.T)
    out = np.empty((nlev, ncol), dtype=np.float64)
    lib.pack_level_major(_dptr(host), _dptr(out), ncol, nlev)
    return out


def from_level_major(dev: np.ndarray) -> np.ndarray:
    """(nlev, ncol) -> (ncol, nlev) as a contiguous float64 array."""
    dev = np.ascontiguousarray(dev, dtype=np.float64)
    nlev, ncol = dev.shape
    lib = _load()
    if lib is None:
        return np.ascontiguousarray(dev.T)
    out = np.empty((ncol, nlev), dtype=np.float64)
    lib.unpack_level_major(_dptr(dev), _dptr(out), nlev, ncol)
    return out


def pack_tracer_block(host: np.ndarray) -> np.ndarray:
    """(ncol, nlev, ntracer) -> (nlev, ntracer, ncol), widening f32."""
    lib = _load()
    if host.dtype == np.float32 and lib is not None:
        host = np.ascontiguousarray(host)
        ncol, nlev, ntr = host.shape
        out = np.empty((nlev, ntr, ncol), dtype=np.float64)
        lib.pack_tracers_f32(
            host.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            _dptr(out), ncol, nlev, ntr)
        return out
    host = np.ascontiguousarray(host, dtype=np.float64)
    ncol, nlev, ntr = host.shape
    if lib is None:
        return np.ascontiguousarray(host.transpose(1, 2, 0))
    out = np.empty((nlev, ntr, ncol), dtype=np.float64)
    lib.pack_tracers(_dptr(host), _dptr(out), ncol, nlev, ntr)
    return out


def unpack_tracer_block(dev: np.ndarray) -> np.ndarray:
    """(nlev, ntracer, ncol) -> (ncol, nlev, ntracer)."""
    dev = np.ascontiguousarray(dev, dtype=np.float64)
    nlev, ntr, ncol = dev.shape
    lib = _load()
    if lib is None:
        return np.ascontiguousarray(dev.transpose(2, 0, 1))
    out = np.empty((ncol, nlev, ntr), dtype=np.float64)
    lib.unpack_tracers(_dptr(dev), _dptr(out), nlev, ntr, ncol)
    return out


def scrub_nonfinite(a: np.ndarray, fill: float = 0.0) -> int:
    """In-place NaN/Inf replacement in a C-contiguous float64 array;
    returns the count replaced."""
    if a.dtype != np.float64 or not a.flags.c_contiguous:
        raise ValueError(f"scrub_nonfinite replaces in place in a "
                         f"C-contiguous float64 array, got {a.dtype}, "
                         f"contiguous={a.flags.c_contiguous}")
    lib = _load()
    if lib is None:
        bad = ~np.isfinite(a)
        a[bad] = fill
        return int(bad.sum())
    return int(lib.scrub_nonfinite(_dptr(a), a.size, fill))
