"""Shared numerical primitives: the ecosystem's transcendental functions,
the Morel PAR attenuation fit, the guarded division and the powers whose
plain derivative is not finite at 0 (counterpart of
``ocean_bgc_tpu/ops/numerics.py``).

Each ``torch.autograd.Function`` here computes its forward with exactly
the expression the forward-only code used (the step's outputs stay
bitwise), and gives a backward that is finite where autograd's own
derivative of that expression is not.
"""

from __future__ import annotations

import math

import torch

# two-band Morel (2001) chlorophyll attenuation fit, shared by the BGC
# and DMS PAR fields (BGC_mod.F90:907-924, DMS_mod.F90:538-551)
_MOREL_BREAK = 0.13224
_LOG_MOREL_A1 = math.log(0.000919)
_LOG_MOREL_A2 = math.log(0.001131)
_MOREL_P1 = 0.3536
_MOREL_P2 = 0.4562


def _f64(v):
    return v.double() if torch.is_tensor(v) else v


def _single(*args) -> bool:
    return any(torch.is_tensor(a) and a.dtype == torch.float32
               for a in args)


# The ecosystem's exp, log and pow (everything but the pH solve and the
# equilibrium constants, which K1's kernels hold): float64 as torch
# evaluates them; float32 evaluated at float64 and rounded once.  The
# card's single-precision exp and pow are not correctly rounded (up to 2
# ulp), and in the deep world's nitrogen-limited surface cells their
# error took kicked f32 runs out of the f64 run's f32-epsilon envelope
# about three times as often on the card as on the CPU (PERF.md).
def exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.double()).float() if _single(x) else torch.exp(x)


def log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.double()).float() if _single(x) else torch.log(x)


def pow(x, y) -> torch.Tensor:
    """``x ** y`` for a tensor and a number or two tensors."""
    if _single(x, y):
        return torch.pow(_f64(x), _f64(y)).float()
    return torch.pow(x, y)


def morel_kpar(chl: torch.Tensor) -> torch.Tensor:
    """PAR attenuation coefficient (1/cm) from total chlorophyll, as
    ``exp(log(a) + p*log(chl))`` with one shared log (callers floor chl
    at 0.02)."""
    log_chl = log(chl)
    return exp(torch.where(chl < _MOREL_BREAK,
                           _LOG_MOREL_A1 + _MOREL_P1 * log_chl,
                           _LOG_MOREL_A2 + _MOREL_P2 * log_chl))


def _to_shape(grad, shape):
    """``grad`` summed down to an input's ``shape`` (the input was
    broadcast in the forward)."""
    return grad.sum_to_size(shape) if grad.shape != shape else grad


class _SafeDiv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, num, den):
        nz = den != 0.0
        den1 = torch.where(nz, den, 1.0)
        q = torch.where(nz, num / den1, 0.0)
        ctx.save_for_backward(nz, den1, q)
        ctx.shapes = (num.shape, den.shape)
        return q

    @staticmethod
    def backward(ctx, g):
        nz, den1, q = ctx.saved_tensors
        num_shape, den_shape = ctx.shapes
        # g / den, not g * (1 / den): at f32 1 / den overflows to inf for a
        # subnormal den, and a zero g would make it NaN
        g_den = g / den1
        d_num = d_den = None
        if ctx.needs_input_grad[0]:
            d_num = _to_shape(torch.where(nz, g_den, 0.0), num_shape)
        if ctx.needs_input_grad[1]:
            d_den = _to_shape(torch.where(nz, -(q * g_den), 0.0), den_shape)
        return d_num, d_den


def safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num/den with den == 0 mapped to 0 (guarded selects, not NaN).

    The backward is the JAX package's den**2-free form
    (ocean_bgc_tpu/ops/numerics.py:53-87): ``d(num/den) = dnum/den -
    (num/den)*(dden/den)`` where den != 0, else 0.  The plain division's
    backward forms ``num/den**2``, and den**2 flushes to 0 at f32 for
    |den| below ~1e-23, which makes the gradient inf.  The incoming
    gradient is divided by den rather than multiplied by 1/den, which
    overflows at f32 for a subnormal den (the photoadaptation ratio's in
    dark cells) and turns a zero gradient into NaN."""
    return _SafeDiv.apply(num, den)


class _ZSqrtZ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z):
        root = torch.sqrt(z)
        ctx.save_for_backward(root)
        return z * root

    @staticmethod
    def backward(ctx, g):
        (root,) = ctx.saved_tensors
        return g * (1.5 * root)


def z_sqrt_z(z: torch.Tensor) -> torch.Tensor:
    """``z * sqrt(z)`` = z**1.5 for z >= 0, with the exact derivative
    ``1.5 * sqrt(z)``, 0 at z = 0 (autograd's own derivative of the
    product is ``sqrt(z) + z * 0.5 / sqrt(z)``, NaN at 0)."""
    return _ZSqrtZ.apply(z)


class _PowFloor0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b):
        out = pow(x, b)
        ctx.save_for_backward(x, out, *((b,) if torch.is_tensor(b) else ()))
        ctx.b = None if torch.is_tensor(b) else b
        return out

    @staticmethod
    def backward(ctx, g):
        x, out, *bt = ctx.saved_tensors
        b = bt[0] if bt else ctx.b
        pos = x > 0.0
        x1 = torch.where(pos, x, 1.0)
        d_x = d_b = None
        if ctx.needs_input_grad[0]:
            d_x = torch.where(pos, g * (b * (out / x1)), 0.0)
        if bt and ctx.needs_input_grad[1]:
            d_b = _to_shape(torch.where(pos, g * (out * torch.log(x1)), 0.0),
                            bt[0].shape)
        return d_x, d_b


def pow_floor0(x: torch.Tensor, b) -> torch.Tensor:
    """``x ** b`` for x >= 0 and 0 < b < 1 (a tensor or a number), with
    the derivative in x taken as 0 at x = 0, where it is infinite: the
    subgradient of a quantity floored at 0.  The derivative in b,
    ``x**b * ln x``, is 0 at x = 0, its limit."""
    return _PowFloor0.apply(x, b)


class _SqrtAbs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = torch.sqrt(torch.abs(x))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        nz = x != 0.0
        return torch.where(nz, g * (0.5 * torch.sign(x))
                           / torch.where(nz, out, 1.0), 0.0)


def sqrt_abs(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(|x|)`` with the derivative taken as 0 at x = 0, where it is
    infinite (the calm-wind speed from a squared wind of 0)."""
    return _SqrtAbs.apply(x)


def fill_like(ref: torch.Tensor, value) -> torch.Tensor:
    """A 0-d tensor of ``ref``'s type and device holding ``value``: a
    number is filled on the device (a copy from the host would
    synchronise), a tensor (a parameter under calibration) is cast, so
    that its gradient flows."""
    if torch.is_tensor(value):
        return value.to(dtype=ref.dtype, device=ref.device)
    return ref.new_full((), value)
