"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library
with a plain C interface, ``_build/lib<name>-<hash>.so`` inside the
package (git-ignored), and loaded with ``ctypes``.  The hash covers the
source, every shared header ``csrc/*.cuh``, the generated constants
header and the flags, so an edited source or header is rebuilt and an
unchanged one is reused.  :func:`build` compiles every source at once,
one ``nvcc`` process each, all started together.

The kernels' physical constants and tracer indices come from one place:
:func:`constants_header` writes ``_build/include/obgc_constants.h`` from
``constants.py``, ``state.py`` and the few module constants the kernels
share with the plain versions, each float as Python's round-trip
``repr``, so a kernel holds the same doubles as the plain version.

Nothing here touches CUDA at import time: the CPU tests import every
module of the package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
INCLUDE_DIR = BUILD_DIR / "include"
SOURCES = ("carbonate_dual", "carbonate_coeffs", "interior_step",
           "probe_patterns")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit's bin directory on PATH")
    return path


def _shared_constants() -> Dict[str, float]:
    """Module constants of the plain versions that the kernels repeat."""
    from ocean_bgc_tpu_torch.ops import carbonate, numerics, particulates
    return {
        "LN10": carbonate._LN10,
        "LN_001": carbonate._LN_001,
        "XACC_F32": carbonate.XACC_F32,
        "BRACKET_GROW_GUARD": carbonate._BRACKET_GROW_GUARD,
        "MOREL_BREAK": numerics._MOREL_BREAK,
        "LOG_MOREL_A1": numerics._LOG_MOREL_A1,
        "LOG_MOREL_A2": numerics._LOG_MOREL_A2,
        "MOREL_P1": numerics._MOREL_P1,
        "MOREL_P2": numerics._MOREL_P2,
        "RHO_CACO3": particulates.RHO_CACO3,
        "RHO_SIO2": particulates.RHO_SIO2,
        "RHO_DUST": particulates.RHO_DUST,
    }


def _cpp(name: str, value) -> str:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise TypeError(f"constant {name} = {value!r} is not a number")
    if isinstance(value, int):
        return f"constexpr int {name} = {value};"
    return f"constexpr double {name} = {value!r};"


def constants_header() -> str:
    """The text of ``obgc_constants.h``: every upper-case constant of
    ``constants.py`` and of :func:`_shared_constants` in namespace
    ``obgc::cst``, and the BGC tracer indices as ``TR_<NAME>`` (the
    per-autotroph slot tables as device arrays, -1 for a missing slot,
    so that kernels may index them with a loop variable)."""
    from ocean_bgc_tpu_torch import constants
    from ocean_bgc_tpu_torch.state import BGCTracers
    lines = ["// Generated by ocean_bgc_tpu_torch/ops/_kernels.py from "
             "constants.py and state.py;",
             "// do not edit.", "#pragma once", "",
             "namespace obgc {", "namespace cst {"]
    values = {n: getattr(constants, n) for n in dir(constants)
              if n.isupper()}
    values.update(_shared_constants())
    lines += [_cpp(n, v) for n, v in sorted(values.items())]
    for n in sorted(vars(BGCTracers)):
        v = getattr(BGCTracers, n)
        if not n.isupper():
            continue
        if isinstance(v, tuple):
            items = ", ".join(str(-1 if i is None else i) for i in v)
            lines.append(f"__device__ constexpr int TR_{n}[{len(v)}] = "
                         f"{{{items}}};")
        else:
            lines.append(_cpp(f"TR_{n}", v))
    lines += ["}  // namespace cst", "}  // namespace obgc", ""]
    return "\n".join(lines)


def _write_header() -> str:
    text = constants_header()
    INCLUDE_DIR.mkdir(parents=True, exist_ok=True)
    path = INCLUDE_DIR / "obgc_constants.h"
    if not path.exists() or path.read_text() != text:
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        tmp.write_text(text)
        os.replace(tmp, path)
    return text


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(constants_header().encode())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> Dict[str, dict]:
    """Compile every source in ``names`` whose library is missing, all
    in parallel.  Returns ``{name: {"seconds": s, "log": ptxas output}}``
    for the sources it compiled; raises RuntimeError naming the first
    source that failed, with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    _write_header()
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True),
                       tmp, out, time.perf_counter())
    report = {}
    failed = None
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed = failed or (name, log)
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed is not None:
        raise RuntimeError(f"nvcc failed on csrc/{failed[0]}.cu:\n"
                           f"{failed[1]}")
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        lib.obgc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.obgc_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a nonzero cudaError_t."""
    if code != 0:
        msg = lib.obgc_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def requires_grad(obj) -> bool:
    """Whether any tensor in ``obj`` (a tensor, or tensors inside
    dataclasses, named tuples, tuples, lists and dicts, as the port's
    states, worlds, env caches and parameters hold them) requires grad."""
    if isinstance(obj, torch.Tensor):
        return obj.requires_grad
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return any(requires_grad(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return any(requires_grad(v) for v in obj)
    if isinstance(obj, dict):
        return any(requires_grad(v) for v in obj.values())
    return False


def refuse_grad(what: str, *inputs) -> None:
    """Raise where a kernel is about to read, through raw pointers,
    inputs that autograd records: its outputs would leave the graph as
    constants.  A kernel with a backward launches inside its
    ``torch.autograd.Function``'s forward, where recording is off."""
    if torch.is_grad_enabled() and requires_grad(inputs):
        raise RuntimeError(
            f"{what}: the kernel has no backward, and its inputs require "
            f"grad; its outputs would be detached from autograd")
