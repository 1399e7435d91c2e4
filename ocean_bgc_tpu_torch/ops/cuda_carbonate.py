"""K1, the dual interior pH solve: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``ocean_bgc_tpu/ops/pallas_carbonate.py`` in the instance
the production step launches (equilibrium constants read from the env
cache, no saturation outputs).  Per cell, for the ambient and the
ALT_CO2 scenario: the pH bracket from the previous pH (+/- DEL_PH, or the
cold [6, 9] window where it is the 0 sentinel), the bracketed
safe-Newton root of the alkalinity residual, and the speciation.

:func:`co3_terms_dual_coeffs` launches ``csrc/carbonate_dual.cu`` for
CUDA tensors and takes :func:`co3_terms_dual_coeffs_torch` for CPU
tensors, or wherever the caller asks for ``impl="torch"``.  Both compute
the same function; a CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ocean_bgc_tpu_torch.constants import (
    DEL_PH,
    MASS_TO_VOL,
    PHHI_3D_INIT,
    PHLO_3D_INIT,
)
from ocean_bgc_tpu_torch.ops import _kernels
from ocean_bgc_tpu_torch.ops.carbonate import (
    _LN10,
    CarbCoeffs,
    _solve_htotal_impl,
    _to_mass_units,
)

IMPLS = ("auto", "kernel", "torch")


def _speciate(h, dic, coeffs):
    h2 = h * h
    k12 = coeffs.k1 * coeffs.k2
    denom = 1.0 / (h2 + coeffs.k1 * h + k12)
    return (-torch.log10(h),
            dic * h2 * denom * MASS_TO_VOL,
            dic * coeffs.k1 * h * denom * MASS_TO_VOL,
            dic * k12 * denom * MASS_TO_VOL)


def _ph_brackets(ph_prev):
    """H-space bracket (x1, x2) of one scenario, as the kernel builds it:
    pH-space ph_prev -/+ DEL_PH (the cold [6, 9] window at the 0
    sentinel), each end converted with one exp."""
    warm = ph_prev != 0.0
    phlo = torch.where(warm, ph_prev - DEL_PH, PHLO_3D_INIT)
    phhi = torch.where(warm, ph_prev + DEL_PH, PHHI_3D_INIT)
    return torch.exp(-_LN10 * phhi), torch.exp(-_LN10 * phlo)


def co3_terms_dual_coeffs_torch(dic, ta, pt, sit, ph_prev_a, ph_prev_b,
                                coeffs: CarbCoeffs, *, with_stats=False):
    """The plain PyTorch version of K1 (same arguments and results as
    :func:`co3_terms_dual_coeffs`).  ``with_stats`` adds the solver's
    per-lane counts of each scenario (``_solve_htotal_impl``)."""
    dic_m, ta_m, pt_m, sit_m = _to_mass_units(dic, ta, pt, sit)
    results, stats = [], []
    for ph_prev in (ph_prev_a, ph_prev_b):
        x1, x2 = _ph_brackets(ph_prev)
        h = _solve_htotal_impl(coeffs, dic_m, ta_m, pt_m, sit_m, x1, x2,
                               with_stats=with_stats)
        if with_stats:
            h, st = h
            stats.append(st)
        results.append(_speciate(h, dic_m, coeffs))
    if with_stats:
        return results[0], results[1], stats
    return results[0], results[1]


def _launch(fields, out_dtype):
    lib = _kernels.load("carbonate_dual")
    fn = lib.obgc_carbonate_dual
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ref = fields[0]
    outs = [torch.empty_like(ref) for _ in range(8)]
    ins_p = (ctypes.c_void_p * len(fields))(*(t.data_ptr() for t in fields))
    outs_p = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in outs))
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    code = fn(int(out_dtype == torch.float64), ins_p, outs_p, ref.numel(),
              stream)
    _kernels.check(lib, code, "carbonate_dual launch")
    return outs


def co3_terms_dual_coeffs(dic, ta, pt, sit, ph_prev_a, ph_prev_b,
                          coeffs: CarbCoeffs, *, impl="auto"):
    """Dual pH solve of every cell from cached equilibrium constants.

    Inputs are same-shape tensors: DIC, ALK, PO4, SiO3 in mmol/m^3, the
    previous pH of each scenario (0 = no previous solution) and the 15
    coefficients.  ``impl``: "auto" launches the kernel on CUDA tensors
    and uses the plain version on CPU tensors; "kernel" requires CUDA
    tensors; "torch" takes the plain version on any device.

    Returns ``((ph, h2co3, hco3, co3) ambient, (...) ALT_CO2)``, the
    concentrations in mmol/m^3.  Each kernel launch adds one to
    ``co3_terms_dual_coeffs.launches``.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown carbonate impl {impl!r}; "
                         f"expected one of {IMPLS}")
    if impl == "torch" or (impl == "auto" and dic.device.type == "cpu"):
        return co3_terms_dual_coeffs_torch(dic, ta, pt, sit, ph_prev_a,
                                           ph_prev_b, coeffs)
    fields = (dic, ta, pt, sit, ph_prev_a, ph_prev_b, *coeffs)
    if dic.device.type != "cuda":
        raise ValueError(f"the carbonate_dual kernel needs CUDA tensors, "
                         f"got {dic.device}")
    if dic.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"carbonate_dual takes float32 or float64, "
                        f"got {dic.dtype}")
    for t in fields:
        if (t.device != dic.device or t.dtype != dic.dtype
                or t.shape != dic.shape or not t.is_contiguous()):
            raise ValueError(
                "carbonate_dual needs contiguous inputs of one device, "
                f"dtype and shape ({dic.device}, {dic.dtype}, "
                f"{tuple(dic.shape)}); got {t.device}, {t.dtype}, "
                f"{tuple(t.shape)}, contiguous={t.is_contiguous()}")
    outs = _launch(fields, dic.dtype)
    co3_terms_dual_coeffs.launches += 1
    return tuple(outs[:4]), tuple(outs[4:])


co3_terms_dual_coeffs.launches = 0
