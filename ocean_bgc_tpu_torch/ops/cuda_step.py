"""K2, the whole diagnostics-off BGC interior: the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of ``ocean_bgc_tpu/ops/pallas_step.py``.  Two launches of
``csrc/interior_step.cu`` compute what
``bgc_source_sink(..., compute_diags=False)`` computes: the solve kernel
the dual pH solve of every cell (pH only), the biology kernel the
ecosystem kinetics with PAR, the sinking recurrence with Fe scavenging,
restoring and the tendency assembly.  The kernel reads
the equilibrium constants, the Q10 response and the dissolution factors
precomputed: from the env cache when one is given, otherwise evaluated
here first, the constants by K1's constants kernel
(``ops/cuda_carbonate.py::carbonate_coeffs_sat``, its plain version on
CPU tensors) and the rest with the plain version's own torch functions.

:func:`fused_interior_step` launches the kernel for CUDA tensors and
takes :func:`fused_interior_step_torch` for CPU tensors.  Both compute
the same function at f64 and f32; a CUDA tensor never falls back to the
plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ocean_bgc_tpu_torch.ops import _kernels
from ocean_bgc_tpu_torch.ops.bgc import (
    EnvCache,
    bgc_source_sink,
    coeff_inputs,
    q10_tfunc,
)
from ocean_bgc_tpu_torch.ops.cuda_carbonate import carbonate_coeffs_sat
from ocean_bgc_tpu_torch.ops.kernel_params import NUM_PARAMS, pack_bgc_params
from ocean_bgc_tpu_torch.ops.particulates import (
    DissolutionCache,
    precompute_dissolution,
)
from ocean_bgc_tpu_torch.ops.carbonate import CarbCoeffs
from ocean_bgc_tpu_torch.params import BGCParams
from ocean_bgc_tpu_torch.state import BGCForcing, BGCTracers as T, ColumnGrid
from ocean_bgc_tpu_torch.utils.profiling import count

IMPLS = ("auto", "kernel")

# The kernel's pointer arguments, in the order of the enum Field in
# csrc/interior_step.cu (tests/test_torch_fused.py holds the two equal).
KERNEL_FIELDS = (
    "tracers", "temp", "dz", "center", "bottom", "fesed", "ph_prev",
    "ph_prev_alt", "kmax", "lat", "dust", "shortwave",
    *CarbCoeffs._fields, "tfunc", *DissolutionCache._fields, "rtau", "no3_clim", "po4_clim", "sio3_clim", "tend", "ph", "ph_alt",
)


class FusedInteriorOut(NamedTuple):
    tendencies: torch.Tensor       # (nlev, 30, ncol)
    ph_prev_3d: torch.Tensor       # (nlev, ncol)
    ph_prev_alt_3d: torch.Tensor   # (nlev, ncol)


def fused_interior_step_torch(tracers, grid: ColumnGrid, forcing: BGCForcing,
                              ph_prev_3d, ph_prev_alt_3d, params: BGCParams,
                              *, env: Optional[EnvCache] = None
                              ) -> FusedInteriorOut:
    """The plain PyTorch version of K2 (the arguments of
    :func:`fused_interior_step` but ``impl``, and its results):
    ``bgc_source_sink`` with diagnostics off and the plain pH solve,
    never seeded (the TPU kernel has no seed, so the fused interior stays
    unseeded under ``OBGC_X0_SEED=1``)."""
    out = bgc_source_sink(tracers, grid, forcing, ph_prev_3d,
                          ph_prev_alt_3d, params, compute_diags=False,
                          carbonate_impl="torch", env=env, x0_seed=False)
    return FusedInteriorOut(out.tendencies, out.ph_prev_3d,
                            out.ph_prev_alt_3d)


def kernel_inputs(tracers, grid: ColumnGrid, forcing: BGCForcing,
                  ph_prev_3d, ph_prev_alt_3d, params: BGCParams,
                  env: Optional[EnvCache] = None) -> dict:
    """The kernel's input tensors by :data:`KERNEL_FIELDS` name (outputs
    excluded), as the kernel reads them; ``None`` for restoring fields
    whose gate is off."""
    if env is not None:
        coeffs, tfunc, diss = env.coeffs, env.tfunc, env.diss
    else:
        coeffs, _ = carbonate_coeffs_sat(*coeff_inputs(grid, forcing),
                                         with_sat=False)
        tfunc = q10_tfunc(forcing.potential_temperature)
        diss = precompute_dissolution(forcing.potential_temperature,
                                      grid.cell_thickness,
                                      grid.cell_bottom_depth, params)
    any_rest = params.lrest_no3 or params.lrest_po4 or params.lrest_sio3
    fields = dict(
        tracers=tracers, temp=forcing.potential_temperature,
        dz=grid.cell_thickness, center=grid.cell_center_depth,
        bottom=grid.cell_bottom_depth, fesed=forcing.fesedflux,
        ph_prev=ph_prev_3d, ph_prev_alt=ph_prev_alt_3d, kmax=grid.kmax,
        lat=grid.latitude, dust=forcing.dust_flux_in,
        shortwave=forcing.shortwave_surface,
        **coeffs._asdict(), tfunc=tfunc, **diss._asdict(),
        rtau=forcing.nutr_restore_rtau if any_rest else None,
        no3_clim=forcing.no3_clim if params.lrest_no3 else None,
        po4_clim=forcing.po4_clim if params.lrest_po4 else None,
        sio3_clim=forcing.sio3_clim if params.lrest_sio3 else None)
    return {k: (None if v is None else v.contiguous())
            for k, v in fields.items()}


@functools.lru_cache(maxsize=16)
def _packed(params: BGCParams):
    values = pack_bgc_params(params)
    return (ctypes.c_double * len(values))(*values)


def _check(fields: dict, nlev: int, ncol: int) -> None:
    ref = fields["tracers"]
    if ref.device.type != "cuda":
        raise ValueError(f"the interior_step kernel needs CUDA tensors, "
                         f"got {ref.device}")
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"interior_step takes float32 or float64, got "
                        f"{ref.dtype}")
    for name, t in fields.items():
        if t is None:
            continue
        if name == "tracers":
            shape, dtype = (nlev, T.CNT, ncol), ref.dtype
        elif name == "kmax":
            shape, dtype = (ncol,), torch.int32
        elif name in ("lat", "dust", "shortwave"):
            shape, dtype = (ncol,), ref.dtype
        else:
            shape, dtype = (nlev, ncol), ref.dtype
        if (t.device != ref.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"interior_step: {name} must be a contiguous {dtype} "
                f"tensor of shape {shape} on {ref.device}; got {t.dtype}, "
                f"{tuple(t.shape)} on {t.device}, "
                f"contiguous={t.is_contiguous()}")


def _pointers(fields: dict, outs: FusedInteriorOut):
    ptrs = {**fields, "tend": outs.tendencies, "ph": outs.ph_prev_3d,
            "ph_alt": outs.ph_prev_alt_3d}
    return (ctypes.c_void_p * len(KERNEL_FIELDS))(
        *(None if ptrs[k] is None else ptrs[k].data_ptr()
          for k in KERNEL_FIELDS))


def _library():
    lib = _kernels.load("interior_step")
    if (lib.obgc_interior_num_params() != NUM_PARAMS
            or lib.obgc_interior_num_fields() != len(KERNEL_FIELDS)):
        raise RuntimeError("csrc/interior_step.cu and ops/cuda_step.py / "
                           "ops/kernel_params.py disagree on the argument "
                           "layout")
    return lib


def _launch_solve(fields: dict, outs: FusedInteriorOut):
    """The solve kernel: both pH fields of every cell into ``outs``.
    Each launch adds one to the counter ``k2.solve``."""
    _kernels.refuse_grad("interior_step solve", fields)
    lib = _library()
    fn = lib.obgc_interior_solve
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ref = fields["tracers"]
    nlev, _, ncol = ref.shape
    code = fn(int(ref.dtype == torch.float64), _pointers(fields, outs), nlev,
              ncol, torch.cuda.current_stream(ref.device).cuda_stream)
    _kernels.check(lib, code, "interior_step solve launch")
    count("k2.solve")


# The biology kernel's threads per block, at most (kBioThreads in
# csrc/interior_step.cu), and the values it stages per cell in shared
# memory (its enum Stage)
BIO_THREADS = 128
STAGED_FIELDS = 8
# Its tile: the whole columns whose staged values fill about this many
# bytes, so that two blocks fit on one SM and one block's per-column
# scans overlap the other's per-cell phases (the card's measurement,
# PERF.md); at least one column
TILE_BYTES = 60 * 1024


def columns_per_block(nlev: int, itemsize: int) -> int:
    """The biology kernel's columns per block for ``nlev`` levels of
    ``itemsize``-byte values: 16 at 60 levels of f64, 32 of f32."""
    return max(1, TILE_BYTES // (STAGED_FIELDS * nlev * itemsize))


def _launch_bio(fields: dict, outs: FusedInteriorOut, params: BGCParams,
                cols=None):
    """The biology kernel: the tendencies of every cell into ``outs``,
    ``cols`` columns per block (:func:`columns_per_block` if None).  Each
    launch adds one to the counter ``k2.bio``."""
    _kernels.refuse_grad("interior_step biology", fields, params)
    lib = _library()
    fn = lib.obgc_interior_bio
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.obgc_interior_bio_smem.restype = ctypes.c_longlong
    lib.obgc_interior_smem_limit.restype = ctypes.c_longlong
    ref = fields["tracers"]
    nlev, _, ncol = ref.shape
    if cols is None:
        cols = columns_per_block(nlev, ref.element_size())
    is_double = int(ref.dtype == torch.float64)
    need = lib.obgc_interior_bio_smem(is_double, nlev, cols)
    limit = lib.obgc_interior_smem_limit()
    if need > limit:
        raise ValueError(f"interior_step: a block of {cols} columns of "
                         f"{nlev} levels needs {need} B of shared memory; "
                         f"the device allows {limit} B")
    code = fn(is_double, _pointers(fields, outs), _packed(params), nlev, ncol,
              cols, torch.cuda.current_stream(ref.device).cuda_stream)
    _kernels.check(lib, code, "interior_step biology launch")
    count("k2.bio")


def fused_interior_step(tracers, grid: ColumnGrid, forcing: BGCForcing,
                        ph_prev_3d, ph_prev_alt_3d, params: BGCParams, *,
                        env: Optional[EnvCache] = None,
                        impl: str = "auto") -> FusedInteriorOut:
    """The diagnostics-off BGC interior in two kernel launches.

    Drop-in for ``bgc_source_sink(..., compute_diags=False)``: returns
    the tendencies ``(nlev, 30, ncol)`` and the updated pH warm-start
    fields.  ``env``: the env cache (:func:`ops.bgc.precompute_env`), or
    None to evaluate its tables here first.  ``impl``: "auto" launches the
    kernel on CUDA tensors and uses the plain version on CPU tensors;
    "kernel" requires CUDA tensors.  A call launches two kernels, the pH
    solve (counted in ``k2.solve``) and the biology (``k2.bio``).
    Forward-only: inputs that require grad (under grad mode) raise
    ValueError, on any device.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown interior kernel impl {impl!r}; "
                         f"expected one of {IMPLS}")
    if torch.is_grad_enabled() and _kernels.requires_grad(
            (tracers, grid, forcing, ph_prev_3d, ph_prev_alt_3d, params,
             env)):
        # K2 is forward-only, as the TPU kernel is (JAX coupled.py:114)
        raise ValueError("interior_impl='fused' is forward-only: its inputs "
                         "require grad; use interior_impl='xla' (the "
                         "default) under autograd")
    if impl == "auto" and tracers.device.type == "cpu":
        return fused_interior_step_torch(tracers, grid, forcing, ph_prev_3d,
                                         ph_prev_alt_3d, params, env=env)
    if tracers.device.type != "cuda":
        raise ValueError(f"the interior_step kernel needs CUDA tensors, "
                         f"got {tracers.device}")
    nlev, _, ncol = tracers.shape
    fields = kernel_inputs(tracers, grid, forcing, ph_prev_3d,
                           ph_prev_alt_3d, params, env)
    _check(fields, nlev, ncol)
    ref = fields["tracers"]
    out = FusedInteriorOut(
        torch.empty_like(ref),
        torch.empty((nlev, ncol), dtype=ref.dtype, device=ref.device),
        torch.empty((nlev, ncol), dtype=ref.dtype, device=ref.device))
    _launch_solve(fields, out)
    _launch_bio(fields, out, params)
    return out


def site_test_hook(x: torch.Tensor, site: str) -> torch.Tensor:
    """Test hook, on no path of the model: the kernel's device function
    at one site where PyTorch's CUDA ops special-case their arguments,
    elementwise on a contiguous CUDA tensor, so that the card tests can
    hold it to the torch op.  ``"sed_pow"`` is 0.99 ** x,
    ``"morel_kpar"`` the PAR attenuation coefficient of chlorophyll x."""
    sites = ("sed_pow", "morel_kpar")
    if x.device.type != "cuda" or not x.is_contiguous() or x.dtype not in (
            torch.float32, torch.float64):
        raise ValueError("site_test_hook takes a contiguous float32 or "
                         "float64 CUDA tensor")
    lib = _kernels.load("interior_step")
    fn = lib.obgc_interior_site_test_hook
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    y = torch.empty_like(x)
    code = fn(int(x.dtype == torch.float64), sites.index(site), x.data_ptr(),
              y.data_ptr(), x.numel(),
              torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(lib, code, "site_test_hook launch")
    return y
