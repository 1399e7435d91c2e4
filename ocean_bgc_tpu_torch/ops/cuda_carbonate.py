"""K1, the pH solve: the CUDA kernels' wrappers and their plain PyTorch
versions.

Counterpart of ``ocean_bgc_tpu/ops/pallas_carbonate.py``.

- :func:`co3_terms_dual_coeffs`, the dual interior instance: per cell,
  for the ambient and the ALT_CO2 scenario, the pH bracket from the
  previous pH (+/- DEL_PH, or the cold [6, 9] window where it is the 0
  sentinel), the bracketed safe-Newton root of the alkalinity residual,
  and the speciation, from given equilibrium constants (the env cache's,
  or :func:`carbonate_coeffs_sat`'s).
- :func:`carbonate_coeffs_sat`, the constants kernel: the 15 constants
  of every cell from depth, T and S, and optionally the calcite and
  aragonite saturation values (``csrc/carbonate_coeffs.cu``).
- :func:`co3_terms_dual_sat`, the TPU kernel's ``coeffs_in=False,
  with_sat=True`` variant, the step without an env cache: the constants
  kernel, then the dual instance on its constants.
- :func:`solve_htotal_brackets`, the bracket-in instance: H of every lane
  from H-space brackets given as input, the function of
  ``ops/carbonate.py::_solve_htotal_impl``.  It solves the surface pair
  (``co2calc_surface_dual``) and the env cache's stand-in problem
  (``ops/bgc.py::precompute_env``).

Each launches its kernel (``csrc/carbonate_dual.cu``, or
``csrc/carbonate_coeffs.cu`` for the constants) for CUDA tensors and
takes its plain version for CPU tensors, or wherever the caller asks for
``impl="torch"``.  A CUDA tensor never falls back to the plain version.
The solves run their lanes (``csrc/carbonate_solve.cuh``) one per
thread, and none makes a host synchronisation.

Every route is differentiable, on the kernel as on the plain version,
through one ``torch.autograd.Function`` per route whose forward (the
kernel, or the plain version unrecorded) is not taped and whose backward
is plain PyTorch: the solves' implicit-function rule
(``ops/carbonate.py::implicit_vjp``) at the returned roots, with the
speciation rebuilt from them by :func:`_speciate`, and the constants'
derivative from :func:`carbonate_coeffs_sat_torch` recomputed.  A kernel
route and its plain route share that backward, so where their forward
outputs are bitwise equal so are their gradients.  Brackets, seeds and
previous pH fields take no gradient (the root does not depend on them).
A kernel reached outside its Function with inputs that require grad
raises (``_kernels.refuse_grad``).

Each solve also has the TPU kernel's seeded variant (``x0_seed``,
``OBGC_X0_SEED=1``; ``ops/carbonate.py::x0_seed_enabled``), selected by
its ``seed`` argument: every problem's iteration starts at the previous
root, clamped into its bracket, instead of the bracket midpoint.  The
dual instance recovers the seed from the pH window
(:func:`_ph_brackets`), the bracket-in instance takes it per lane.  The
launches are counted by instance and variant in ``utils/profiling.py``'s
counters (``k1.dual``, ``k1.dual_seeded``, ``k1.coeffs``,
``k1.brackets``, ``k1.brackets_seeded``, ``k1.brackets_stats``).  The
seeded f32 dual instance runs the parked-tail schedule
(``csrc/carbonate_solve.cuh::solve_lanes_parked``: a problem still
iterating after :data:`PARK_CAP` steps is handed to the block's first
warps, which finish the block's slow problems densely); the other seeded
instances run one lane per thread.  Every seeded launch takes its blocks
from :func:`seeded_launch_shape`.  Neither changes a bit of the
outputs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ocean_bgc_tpu_torch.constants import (
    DEL_PH,
    MASS_TO_VOL,
    MAXIT,
    PHHI_3D_INIT,
    PHLO_3D_INIT,
)
from ocean_bgc_tpu_torch.ops import _kernels
from ocean_bgc_tpu_torch.ops.carbonate import (
    _LN10,
    CarbCoeffs,
    _solve_htotal_impl,
    _to_mass_units,
    carbonate_coeffs,
    co3_sat_vals,
    implicit_root,
    solve_htotal,
)
from ocean_bgc_tpu_torch.utils.profiling import count

IMPLS = ("auto", "kernel", "torch")
# The bracket-in instance's pointer arguments, in the order of the enum
# BracketField in csrc/carbonate_dual.cu (tests/test_torch_carbonate.py
# holds the two equal): per lane, per shared element, then the output.
BRACKET_FIELDS = ("dic", "x1", "x2", "x0", "ta", "pt", "sit",
                  *CarbCoeffs._fields, "h")
# The constants kernel's outputs, in the order of the enum CoeffOut in
# csrc/carbonate_coeffs.cu (tests/test_torch_carbonate.py holds the two
# equal).
COEFF_OUTPUTS = (*CarbCoeffs._fields, "sat_calc", "sat_arag")
# The seeded kernels' schedule.  PARK_CAP: the Newton-or-bisection steps
# a problem of the seeded f32 dual instance takes in its own thread
# before it is parked (MAXIT or more: one lane per thread, start to end);
# the other seeded instances have no parked kernel.  SEEDED_MAX_WARPS:
# per type, the warps of a block at most; SEEDED_BLOCKS_PER_SM: blocks
# are small enough that a grid of many lanes gives each SM at least this
# many (seeded_launch_shape).  Chosen from chip_smoke.py's sweep
# (PERF.md).
PARK_CAP = 2
SEEDED_MAX_WARPS = {torch.float64: 1, torch.float32: 8}
SEEDED_BLOCKS_PER_SM = 2
# The ctypes signatures of csrc/carbonate_dual.cu's two solve entry
# points (tests/test_torch_lane_schedule.py holds them to the source):
# is_double, seed, the dual's cap, blocks, threads, then the pointers and
# sizes.
DUAL_ARGTYPES = (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                 ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                 ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong,
                 ctypes.c_void_p)
BRACKETS_ARGTYPES = (ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                     ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                     ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p)
# the bracket-in instance's statistics variant: its arguments, with the
# per-lane steps and converged flags after the fields
BRACKETS_STATS_ARGTYPES = (*BRACKETS_ARGTYPES[:5], ctypes.c_void_p,
                           ctypes.c_void_p, *BRACKETS_ARGTYPES[5:])


def _speciate(h, dic, coeffs):
    h2 = h * h
    k12 = coeffs.k1 * coeffs.k2
    denom = 1.0 / (h2 + coeffs.k1 * h + k12)
    return (-torch.log10(h),
            dic * h2 * denom * MASS_TO_VOL,
            dic * coeffs.k1 * h * denom * MASS_TO_VOL,
            dic * k12 * denom * MASS_TO_VOL)


def _ph_brackets(ph_prev, seed=False):
    """H-space bracket (x1, x2) of one scenario, as the kernel builds it:
    pH-space ph_prev -/+ DEL_PH (the cold [6, 9] window at the 0
    sentinel), each end converted with one exp.  ``seed``: also the
    iteration seed as the TPU kernel recovers it (``x0_of``,
    pallas_carbonate.py:87-97): H at the window's pH midpoint where the
    window is narrower than 1 (warm), else 0."""
    warm = ph_prev != 0.0
    phlo = torch.where(warm, ph_prev - DEL_PH, PHLO_3D_INIT)
    phhi = torch.where(warm, ph_prev + DEL_PH, PHHI_3D_INIT)
    x1, x2 = torch.exp(-_LN10 * phhi), torch.exp(-_LN10 * phlo)
    if not seed:
        return x1, x2
    mid = 0.5 * (phlo + phhi)
    return x1, x2, torch.where((phhi - phlo) < 1.0, torch.exp(-_LN10 * mid),
                               0.0)


def co3_terms_dual_coeffs_torch(dic, ta, pt, sit, ph_prev_a, ph_prev_b,
                                coeffs: CarbCoeffs, *, with_stats=False,
                                seed=False):
    """The plain PyTorch version of K1 (same arguments and results as
    :func:`co3_terms_dual_coeffs`), differentiable through the solve's
    implicit-function rule (``ops/carbonate.py::solve_htotal``).
    ``with_stats`` adds the solver's per-lane counts of each scenario
    (``_solve_htotal_impl``; not differentiable)."""
    dic_m, ta_m, pt_m, sit_m = _to_mass_units(dic, ta, pt, sit)
    results, stats = [], []
    for ph_prev in (ph_prev_a, ph_prev_b):
        x1, x2, *x0 = _ph_brackets(ph_prev, seed)
        x0 = x0[0] if seed else None
        if with_stats:
            h, st = _solve_htotal_impl(coeffs, dic_m, ta_m, pt_m, sit_m, x1,
                                       x2, with_stats=True, x0=x0)
            stats.append(st)
        else:
            h = solve_htotal(coeffs, dic_m, ta_m, pt_m, sit_m, x1, x2, x0)
        results.append(_speciate(h, dic_m, coeffs))
    if with_stats:
        return results[0], results[1], stats
    return results[0], results[1]


def _check_impl(impl):
    if impl not in IMPLS:
        raise ValueError(f"unknown carbonate impl {impl!r}; "
                         f"expected one of {IMPLS}")


def _check_kernel_inputs(kernel, ref, fields):
    """Raise unless ``ref`` is a float32 or float64 CUDA tensor and every
    ``name: (tensor, shape)`` of ``fields`` a contiguous tensor of its
    device and type with that shape: what ``kernel`` reads through raw
    pointers."""
    if ref.device.type != "cuda":
        raise ValueError(f"the {kernel} kernel needs CUDA tensors, got "
                         f"{ref.device}")
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{kernel} takes float32 or float64, got "
                        f"{ref.dtype}")
    for name, (t, shape) in fields.items():
        if (t.device != ref.device or t.dtype != ref.dtype
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError(
                f"{kernel}: {name} must be a contiguous {ref.dtype} tensor "
                f"of shape {tuple(shape)} on {ref.device}; got {t.dtype}, "
                f"{tuple(t.shape)} on {t.device}, "
                f"contiguous={t.is_contiguous()}")


def seeded_launch_shape(n, sms, max_warps):
    """``(blocks, threads)`` of a seeded launch of ``n`` lanes on a card
    of ``sms`` SMs, one thread per lane: blocks of whole warps, at most
    ``max_warps`` of them, and as few as give :data:`SEEDED_BLOCKS_PER_SM`
    blocks per SM where ``n`` allows (one warp a block below that).  From
    ``32 * sms`` lanes on, every SM gets a block."""
    warps = max(1, min(max_warps, n // (32 * sms * SEEDED_BLOCKS_PER_SM)))
    return _blocks(n, 32 * warps), 32 * warps


def _blocks(n, threads):
    """Blocks of ``threads`` for ``n`` lanes, one thread per lane (the
    kernel strides past a grid of 2**31 - 1 blocks)."""
    return min(max(1, -(-n // threads)), 2**31 - 1)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def dual_cap(dtype, cap=None):
    """The seeded dual instance's parked-tail cap at ``dtype``:
    :data:`PARK_CAP` at f32 and MAXIT (one lane per thread) at f64, or
    ``cap`` where given; a cap below MAXIT is refused at f64, which has
    no parked kernel."""
    if cap is None:
        return PARK_CAP if dtype == torch.float32 else MAXIT
    if cap < 0:
        raise ValueError(f"the parked-tail cap must be at least 0, got "
                         f"{cap}")
    if cap < MAXIT and dtype != torch.float32:
        raise ValueError(f"the parked-tail schedule is built at f32 only; "
                         f"a {dtype} cap must be at least MAXIT, got {cap}")
    return cap


def seeded_schedule(ref, threads=None):
    """``(blocks, threads)`` of a seeded launch on ``ref``'s lanes:
    :func:`seeded_launch_shape` on ``ref``'s card, or blocks of
    ``threads`` where given."""
    n = ref.numel()
    if threads is None:
        return seeded_launch_shape(n, _sm_count(ref.device.index),
                                   SEEDED_MAX_WARPS[ref.dtype])
    return _blocks(n, threads), threads


def _launch(fields, out_dtype, seed=False, cap=None, threads=None):
    """Launch the dual instance on ``fields`` (its 21 inputs); ``cap``
    and ``threads`` override a seeded launch's schedule (:func:`dual_cap`,
    :func:`seeded_schedule`)."""
    _kernels.refuse_grad("carbonate_dual", fields)
    ref = fields[0]
    # an unseeded launch reads no schedule
    sched = ((dual_cap(out_dtype, cap), *seeded_schedule(ref, threads))
             if seed else (MAXIT, 1, 32))
    lib = _kernels.load("carbonate_dual")
    fn = lib.obgc_carbonate_dual
    fn.argtypes = DUAL_ARGTYPES
    fn.restype = ctypes.c_int
    outs = [torch.empty_like(ref) for _ in range(8)]
    ins_p = (ctypes.c_void_p * len(fields))(*(t.data_ptr() for t in fields))
    outs_p = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in outs))
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    code = fn(int(out_dtype == torch.float64), int(seed), *sched, ins_p,
              outs_p, ref.numel(), stream)
    _kernels.check(lib, code, "carbonate_dual launch")
    return outs


def co3_terms_dual_coeffs(dic, ta, pt, sit, ph_prev_a, ph_prev_b,
                          coeffs: CarbCoeffs, *, seed=False, impl="auto"):
    """Dual pH solve of every cell from cached equilibrium constants.

    Inputs are same-shape tensors: DIC, ALK, PO4, SiO3 in mmol/m^3, the
    previous pH of each scenario (0 = no previous solution) and the 15
    coefficients.  ``impl``: "auto" launches the kernel on CUDA tensors
    and uses the plain version on CPU tensors; "kernel" requires CUDA
    tensors; "torch" takes the plain version on any device.  ``seed``:
    the seeded variant (see the module's docstring).

    Returns ``((ph, h2co3, hco3, co3) ambient, (...) ALT_CO2)``, the
    concentrations in mmol/m^3.  Each kernel launch adds one to the
    counter ``k1.dual``, or with ``seed`` to ``k1.dual_seeded``.
    """
    _check_impl(impl)
    if impl == "torch" or (impl == "auto" and dic.device.type == "cpu"):
        def run():
            a, b = co3_terms_dual_coeffs_torch(dic, ta, pt, sit, ph_prev_a,
                                               ph_prev_b, coeffs, seed=seed)
            return (*a, *b)
    else:
        fields = dict(dic=dic, ta=ta, pt=pt, sit=sit, ph_prev_a=ph_prev_a,
                      ph_prev_b=ph_prev_b, **coeffs._asdict())
        _check_kernel_inputs("carbonate_dual", dic,
                             {k: (t, dic.shape) for k, t in fields.items()})

        def run():
            outs = _launch(tuple(fields.values()), dic.dtype, seed)
            count("k1.dual_seeded" if seed else "k1.dual")
            return outs
    outs = _DualSolve.apply(run, dic, ta, pt, sit, ph_prev_a, ph_prev_b,
                            *coeffs)
    return tuple(outs[:4]), tuple(outs[4:])


class _DualSolve(torch.autograd.Function):
    """The dual instance's 8 outputs from ``run()`` (the kernel or the
    plain version), with the implicit-function backward: H of each
    scenario recovered from its pH, the speciation rebuilt from it."""

    @staticmethod
    def forward(ctx, run, dic, ta, pt, sit, ph_prev_a, ph_prev_b, *coeffs):
        outs = tuple(run())
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dic, ta, pt, sit, outs[0], outs[4], *coeffs)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        dic, ta, pt, sit, ph_a, ph_b, *coeffs = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:5] + ctx.needs_input_grad[7:]
        inputs = (dic, ta, pt, sit, *coeffs)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(bool(n))
                      for t, n in zip(inputs, needs)]
            cc = CarbCoeffs(*leaves[4:])
            mass = _to_mass_units(*leaves[:4])
            outs, gs = [], []
            for ph, g4 in ((ph_a, grads[:4]), (ph_b, grads[4:])):
                if all(g is None for g in g4):
                    continue
                h = torch.pow(10.0, -ph)
                h = implicit_root(lambda h=h: h, cc, *mass)
                for o, g in zip(_speciate(h, mass[0], cc), g4):
                    if g is not None:
                        outs.append(o)
                        gs.append(g)
            wanted = [t for t, n in zip(leaves, needs) if n]
            got = iter(torch.autograd.grad(outs, wanted, gs,
                                           allow_unused=True)
                       if outs and wanted else [None] * len(wanted))
        d = [next(got) if n else None for n in needs]
        return (None, *d[:4], None, None, *d[4:])


def subsurface_of(depth_m):
    """The (nlev, 1) pressure gate of an (nlev, ncol) field: the
    reference's ``k > 1``, every level below the first."""
    return (torch.arange(depth_m.shape[0], device=depth_m.device) > 0)[:, None]


def carbonate_coeffs_sat_torch(depth_m, temp, salt, *, with_sat=True):
    """The plain PyTorch version of the constants kernel (same arguments
    and results as :func:`carbonate_coeffs_sat`): ``carbonate_coeffs``
    with the Lueker k1/k2 and ``co3_sat_vals``, pressure corrections
    below the first level."""
    subsurface = subsurface_of(depth_m)
    coeffs = carbonate_coeffs(depth_m, temp, salt, subsurface,
                              k1_k2_ph_tot=True)
    sat = (co3_sat_vals(depth_m, temp, salt, subsurface) if with_sat
           else None)
    return coeffs, sat


def _launch_coeffs(depth_m, temp, salt, with_sat):
    """Launch the constants kernel; returns its :data:`COEFF_OUTPUTS`
    (the constants only, without ``with_sat``) as one
    ``(outputs, nlev, ncol)`` buffer."""
    _kernels.refuse_grad("carbonate_coeffs", depth_m, temp, salt)
    lib = _kernels.load("carbonate_coeffs")
    fn = lib.obgc_carbonate_coeffs
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if lib.obgc_coeffs_num_outputs() != len(COEFF_OUTPUTS):
        raise RuntimeError("csrc/carbonate_coeffs.cu and "
                           "ops/cuda_carbonate.py disagree on the constants "
                           "kernel's outputs")
    n_out = len(COEFF_OUTPUTS) if with_sat else len(CarbCoeffs._fields)
    buf = torch.empty((n_out, *depth_m.shape), dtype=depth_m.dtype,
                      device=depth_m.device)
    outs_p = (ctypes.c_void_p * len(COEFF_OUTPUTS))(
        *(t.data_ptr() for t in buf.unbind(0)))
    stream = torch.cuda.current_stream(depth_m.device).cuda_stream
    code = fn(int(depth_m.dtype == torch.float64), depth_m.data_ptr(),
              temp.data_ptr(), salt.data_ptr(), outs_p, depth_m.numel(),
              depth_m.shape[1], int(with_sat), stream)
    _kernels.check(lib, code, "carbonate_coeffs launch")
    return buf


def carbonate_coeffs_sat(depth_m, temp, salt, *, with_sat=True,
                         impl="auto"):
    """The equilibrium constants of every cell, and the saturation
    values.

    Inputs are (nlev, ncol) tensors: depth (m), temperature and salinity
    (stand-ins applied where the caller wants them); the constants take
    pressure corrections below the first level.  ``with_sat=False`` skips
    the saturation values.  ``impl``: "auto" launches the kernel on CUDA
    tensors and uses the plain version on CPU tensors; "kernel" requires
    CUDA tensors; "torch" takes the plain version on any device.

    Returns ``(CarbCoeffs, (co3_sat_calc, co3_sat_arag) or None)``, the
    saturation values in mmol/m^3.  Each kernel launch adds one to the
    counter ``k1.coeffs``.
    """
    _check_impl(impl)
    if impl == "torch" or (impl == "auto" and depth_m.device.type == "cpu"):
        return carbonate_coeffs_sat_torch(depth_m, temp, salt,
                                          with_sat=with_sat)
    if depth_m.dim() != 2:
        raise ValueError(f"carbonate_coeffs takes (nlev, ncol) fields, got "
                         f"shape {tuple(depth_m.shape)}")
    _check_kernel_inputs("carbonate_coeffs", depth_m, {
        k: (t, depth_m.shape) for k, t in (("depth_m", depth_m),
                                           ("temp", temp), ("salt", salt))})
    outs = _CoeffsKernel.apply(with_sat, depth_m, temp, salt).unbind(0)
    return CarbCoeffs(*outs[:15]), (tuple(outs[15:]) if with_sat else None)


class _CoeffsKernel(torch.autograd.Function):
    """The constants kernel's outputs as one buffer, with the backward of
    its plain version: :func:`carbonate_coeffs_sat_torch` recomputed and
    differentiated with respect to depth, T and S."""

    @staticmethod
    def forward(ctx, with_sat, depth_m, temp, salt):
        buf = _launch_coeffs(depth_m, temp, salt, with_sat)
        count("k1.coeffs")
        ctx.with_sat = with_sat
        ctx.save_for_backward(depth_m, temp, salt)
        return buf

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(bool(n))
                      for t, n in zip(ctx.saved_tensors, needs)]
            coeffs, sat = carbonate_coeffs_sat_torch(*leaves,
                                                     with_sat=ctx.with_sat)
            outs = (*coeffs, *(sat or ()))
            wanted = [t for t, n in zip(leaves, needs) if n]
            got = iter(torch.autograd.grad(outs, wanted, grad.unbind(0),
                                           allow_unused=True))
        return (None, *(next(got) if n else None for n in needs))


def co3_terms_dual_sat_torch(depth_m, temp, salt, dic, ta, pt, sit,
                             ph_prev_a, ph_prev_b, *, with_sat=True,
                             seed=False, with_stats=False):
    """The plain PyTorch version of :func:`co3_terms_dual_sat` (same
    arguments and results): :func:`carbonate_coeffs_sat_torch`, then the
    dual solve of :func:`co3_terms_dual_coeffs_torch`.  ``with_stats``
    adds the solver's per-lane counts of each scenario as a fourth
    element."""
    coeffs, sat = carbonate_coeffs_sat_torch(depth_m, temp, salt,
                                             with_sat=with_sat)
    a, b, *stats = co3_terms_dual_coeffs_torch(
        dic, ta, pt, sit, ph_prev_a, ph_prev_b, coeffs, seed=seed,
        with_stats=with_stats)
    return (a, b, sat, *stats)


def co3_terms_dual_sat(depth_m, temp, salt, dic, ta, pt, sit, ph_prev_a,
                       ph_prev_b, *, with_sat=True, seed=False, impl="auto"):
    """Dual pH solve of every cell with the equilibrium constants
    evaluated per cell, and the saturation values: the TPU kernel's
    ``coeffs_in=False, with_sat=True`` variant, as two launches on CUDA
    tensors, :func:`carbonate_coeffs_sat` and then
    :func:`co3_terms_dual_coeffs` on its constants (each counted by its
    own wrapper).

    Inputs are (nlev, ncol) tensors: the three of
    :func:`carbonate_coeffs_sat`, then DIC, ALK, PO4, SiO3 in mmol/m^3 and
    the previous pH of each scenario (0 = no previous solution).
    ``with_sat``, ``seed`` and ``impl`` as those wrappers take them.

    Returns ``((ph, h2co3, hco3, co3) ambient, (...) ALT_CO2,
    (co3_sat_calc, co3_sat_arag) or None)``, concentrations in mmol/m^3.
    """
    _, a, b, sat = dual_sat_and_coeffs(
        depth_m, temp, salt, dic, ta, pt, sit, ph_prev_a, ph_prev_b,
        with_sat=with_sat, seed=seed, impl=impl)
    return a, b, sat


def dual_sat_and_coeffs(depth_m, temp, salt, dic, ta, pt, sit, ph_prev_a,
                        ph_prev_b, *, with_sat, seed, impl):
    """:func:`co3_terms_dual_sat`'s two launches, returning the constants
    too, ``(CarbCoeffs, ambient, ALT_CO2, sat)``: the step without an env
    cache hands them on to its health counters."""
    coeffs, sat = carbonate_coeffs_sat(depth_m, temp, salt,
                                       with_sat=with_sat, impl=impl)
    a, b = co3_terms_dual_coeffs(dic, ta, pt, sit, ph_prev_a, ph_prev_b,
                                 coeffs, seed=seed, impl=impl)
    return coeffs, a, b, sat


def _launch_brackets(fields, threads=None, with_stats=False):
    """Launch the bracket-in instance on ``fields`` (by
    :data:`BRACKET_FIELDS` name, inputs only; the seeded variant where
    ``fields`` holds ``x0``); returns H per lane.  ``threads`` overrides
    a seeded launch's block size (:func:`seeded_schedule`).
    ``with_stats``: the statistics variant, returning ``(H, iters,
    converged)``, the steps per lane (int32) and whether each converged
    (bool)."""
    _kernels.refuse_grad("solve_htotal_brackets", fields)
    dic = fields["dic"]
    seed = "x0" in fields
    sched = seeded_schedule(dic, threads) if seed else (1, 32)
    lib = _kernels.load("carbonate_dual")
    if lib.obgc_brackets_num_fields() != len(BRACKET_FIELDS):
        raise RuntimeError("csrc/carbonate_dual.cu and ops/cuda_carbonate.py "
                           "disagree on the bracket-in argument layout")
    h = torch.empty_like(dic)
    ptrs = {**fields, "h": h}
    arr = (ctypes.c_void_p * len(BRACKET_FIELDS))(
        *(ptrs[k].data_ptr() if k in ptrs else None for k in BRACKET_FIELDS))
    stream = torch.cuda.current_stream(dic.device).cuda_stream
    sizes = (dic.numel(), fields["ta"].numel(), stream)
    if with_stats:
        fn = lib.obgc_solve_htotal_brackets_stats
        fn.argtypes = BRACKETS_STATS_ARGTYPES
        iters = torch.empty(dic.shape, dtype=torch.int32, device=dic.device)
        converged = torch.empty(dic.shape, dtype=torch.bool,
                                device=dic.device)
        outs = (iters.data_ptr(), converged.data_ptr())
    else:
        fn = lib.obgc_solve_htotal_brackets
        fn.argtypes = BRACKETS_ARGTYPES
        outs = ()
    fn.restype = ctypes.c_int
    code = fn(int(dic.dtype == torch.float64), int(seed), *sched, arr, *outs,
              *sizes)
    _kernels.check(lib, code, "solve_htotal_brackets launch")
    return (h, iters, converged) if with_stats else h


def solve_htotal_brackets(coeffs: CarbCoeffs, dic, ta, pt, sit, x1, x2, *,
                          seed=None, impl="auto", with_stats=False):
    """H (mol/kg) of every lane from the H-space bracket [x1, x2]: the
    function of :func:`ops.carbonate._solve_htotal_impl`, its plain
    version.

    ``dic``, ``x1`` and ``x2`` (mol/kg) hold one value per lane; ``ta``,
    ``pt``, ``sit`` (mol/kg) and the 15 coefficients are shared by lanes
    whose trailing indices agree: their shape is a trailing part of the
    lanes' shape (the surface pair: lanes ``(2, ncol)``, shared
    ``(ncol,)``), and the kernel reads them in place.  ``seed``: the
    seeded variant, with the iteration seed (mol/kg, 0 = none) per lane,
    ``_solve_htotal_impl``'s ``x0``.  ``impl``: "auto" launches the
    kernel on CUDA tensors and uses the plain version on CPU tensors;
    "kernel" requires CUDA tensors; "torch" takes the plain version on any
    device.  Each kernel launch adds one to the counter ``k1.brackets``,
    or with a ``seed`` to ``k1.brackets_seeded``.

    ``with_stats``: the statistics variant, ``(H, iters, converged)``
    with the steps each lane took (int32, the step that converges
    counted) and whether it converged or stalled before MAXIT (bool), as
    the plain version counts them; not differentiable (inputs that
    require grad raise).  Its kernel launches add one to
    ``k1.brackets_stats``, seeded or not.
    """
    _check_impl(impl)
    plain = impl == "torch" or (impl == "auto" and dic.device.type == "cpu")
    if with_stats:
        _kernels.refuse_grad("solve_htotal_stats", coeffs, dic, ta, pt, sit,
                             x1, x2, seed)
        if plain:
            h, st = _solve_htotal_impl(coeffs, dic, ta, pt, sit, x1, x2,
                                       with_stats=True, x0=seed)
            return h, st["iters"], st["converged"]
    elif plain:
        return solve_htotal(coeffs, dic, ta, pt, sit, x1, x2, seed)
    lanes, shared = tuple(dic.shape), tuple(ta.shape)
    if len(shared) > len(lanes) or lanes[len(lanes) - len(shared):] != shared:
        raise ValueError(f"solve_htotal_brackets: the shared fields' shape "
                         f"{shared} is not a trailing part of the lanes' "
                         f"shape {lanes}")
    fields = dict(dic=dic, x1=x1, x2=x2, ta=ta, pt=pt, sit=sit,
                  **coeffs._asdict())
    if seed is not None:
        fields["x0"] = seed
    _check_kernel_inputs("solve_htotal_brackets", dic, {
        k: (t, lanes if k in ("dic", "x1", "x2", "x0") else shared)
        for k, t in fields.items()})
    if with_stats:
        out = _launch_brackets(fields, with_stats=True)
        count("k1.brackets_stats")
        return out

    def run():
        h = _launch_brackets(fields)
        count("k1.brackets" if seed is None else "k1.brackets_seeded")
        return h
    return implicit_root(run, coeffs, dic, ta, pt, sit)

