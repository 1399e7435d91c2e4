"""Numerical-health checks: the port's sanitizer layer.

Counterpart of ``ocean_bgc_tpu/utils/debug.py``.  The reference's failure
philosophy is "never abort" (SURVEY.md §5): solver non-convergence falls
through silently, negative tracers are clipped.  Those saturating guards
are part of the model and stay in the kernels; this module adds the
observability the Fortran lacks:

* :func:`validate_state`: finite and sign counts over the state, as a
  structured report instead of a crash mid-run.
* :func:`solver_health`: the pH residual at the stored warm starts, i.e.
  the convergence mask the reference never exposes (co2calc.F90:993-995).
* :func:`poc_bounds_report`: the reference's ``poc_error`` flag as an
  observable.
* :func:`checked_step`: a step wrapped with validation that raises,
  naming the corrupted field.

Each reads its results back to the host (one synchronisation on the
card): these are debugging tools, not part of a step.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from ocean_bgc_tpu_torch.constants import ALK_MIN, DIC_MIN, VOL_TO_MASS
from ocean_bgc_tpu_torch.models.coupled import CoupledState
from ocean_bgc_tpu_torch.ops.carbonate import talk
from ocean_bgc_tpu_torch.ops.cuda_carbonate import carbonate_coeffs_sat
from ocean_bgc_tpu_torch.ops.particulates import RHO_CACO3, RHO_SIO2
from ocean_bgc_tpu_torch.state import BGCForcing, BGCTracers as T, ColumnGrid


class StateReport(NamedTuple):
    ok: bool
    n_nonfinite: int
    n_negative: int
    worst_field: str
    detail: Dict[str, Tuple[int, int]]   # field -> (nonfinite, negative)


def validate_state(state: CoupledState, grid: ColumnGrid) -> StateReport:
    """Count non-finite and negative entries per prognostic field on
    active cells.  (Small transient negatives are legal, the kernels clip
    them, but a growing count flags an unstable dt.)"""
    mask = grid.active_mask()[:, None, :]
    fields = {"bgc.tracers": state.bgc.tracers, "dms": state.dms,
              "macros": state.macros}
    counts = []
    for arr in fields.values():
        vals = torch.where(mask, arr, 0.0)
        counts += [(~torch.isfinite(vals)).sum(), (vals < 0.0).sum()]
    counts = torch.stack(counts).tolist()
    detail = {name: (counts[2 * i], counts[2 * i + 1])
              for i, name in enumerate(fields)}
    n_bad = sum(v[0] for v in detail.values())
    n_neg = sum(v[1] for v in detail.values())
    worst = max(detail, key=lambda k: detail[k][0] * 10**9 + detail[k][1])
    return StateReport(ok=(n_bad == 0), n_nonfinite=n_bad,
                       n_negative=n_neg, worst_field=worst, detail=detail)


def solver_health(state: CoupledState, grid: ColumnGrid,
                  forcing: BGCForcing) -> Dict[str, float]:
    """Evaluate the total-alkalinity residual at the stored warm-start pH
    of every active cell: |residual|/|dTA/dH| is the Newton step the next
    solve would take, and large values flag stale or failed warm starts.

    The equilibrium constants are :func:`carbonate_coeffs_sat`'s (K1's
    constants kernel on CUDA tensors, its plain version on CPU tensors),
    pressure-corrected below the first level, at the forcing's (T, S)."""
    trc = torch.clamp_min(state.bgc.tracers, 0.0)
    coeffs, _ = carbonate_coeffs_sat(
        (grid.cell_center_depth * 0.01).contiguous(),
        forcing.potential_temperature.contiguous(),
        forcing.salinity.contiguous(), with_sat=False)
    dic = torch.clamp_min(trc[:, T.DIC], DIC_MIN) * VOL_TO_MASS
    ta = torch.clamp_min(trc[:, T.ALK], ALK_MIN) * VOL_TO_MASS
    pt = trc[:, T.PO4] * VOL_TO_MASS
    sit = trc[:, T.SIO3] * VOL_TO_MASS
    ph = state.bgc.ph_prev_3d
    h = 10.0 ** (-torch.where(ph != 0.0, ph, 8.0))
    fn, df = talk(coeffs, dic, ta, pt, sit, h)
    active = grid.active_mask() & (ph != 0.0)
    newton_step = torch.where(active, torch.abs(fn / df), 0.0)
    big, mean, n = torch.stack([newton_step.max().double(),
                                newton_step.mean().double(),
                                active.sum().double()]).tolist()
    return {"max_newton_step_h": big, "mean_newton_step_h": mean,
            "cells_checked": int(n)}


def poc_bounds_report(diags: Dict) -> Dict[str, float]:
    """The reference's ``poc_error`` flag as an observable.

    ``compute_particulate_terms`` sets ``poc_error = .true.`` when the
    POC production available for QA ballast goes negative,
    ``POC_PROD - rho_CaCO3*CaCO3_PROD - rho_SiO2*SiO2_PROD < 0``
    (BGC_mod.F90:2296-2297, 2373-2383), and then never reads the flag.
    This reports the same condition from the production diagnostics
    (tensors or NumPy arrays): violation count, worst deficit, and the
    flag itself.
    """
    avail = (torch.as_tensor(diags["POC_PROD"])
             - RHO_CACO3 * torch.as_tensor(diags["CaCO3_PROD"])
             - RHO_SIO2 * torch.as_tensor(diags["SiO2_PROD"]))
    if avail.numel() == 0:
        return {"poc_error": False, "n_violating_cells": 0,
                "min_poc_prod_avail": 0.0}
    n = int((avail < 0.0).sum())
    return {"poc_error": n > 0, "n_violating_cells": n,
            "min_poc_prod_avail": float(avail.min())}


def checked_step(step_fn: Callable, grid: ColumnGrid) -> Callable:
    """Wrap a step callable; raises FloatingPointError naming the first
    corrupted field if the output state contains non-finite values."""

    def wrapped(state, *args, **kwargs):
        out = step_fn(state, *args, **kwargs)
        new_state = out[0] if isinstance(out, tuple) else out
        report = validate_state(new_state, grid)
        if not report.ok:
            raise FloatingPointError(
                f"non-finite state after step: {report.n_nonfinite} "
                f"entries, worst field {report.worst_field!r} "
                f"(detail: {report.detail})")
        return out

    return wrapped
