"""Differentiable trajectories: exact adjoints and variational calibration.

Counterpart of ``ocean_bgc_tpu/models/adjoint.py`` on autograd.  The
reference is a Fortran tendency library with no adjoint: parameter
sensitivity there means a finite-difference re-run of the whole model per
parameter, and its parameters are set once by ``BGC_parms_init``
(BGC_parms.F90:497-699) and tuned by hand.  Here reverse-mode autograd
through the coupled integration gives the exact adjoint: through the
air-sea fluxes, the three source-sink steps, the carbonate root-finds
(implicit-function backward, ``ops/carbonate.py::implicit_vjp``, on K1's
kernels as on their plain versions, ``ops/cuda_carbonate.py``) and the
time steps.

Two backward-pass memory regimes, as in the JAX package:

- ``remat=True`` (default): each step runs under
  ``torch.utils.checkpoint`` (non-reentrant), so the backward pass keeps
  only the per-step states and recomputes each step's interior once.
- ``remat=False``: autograd keeps every intermediate of every step.

Parameters are frozen dataclasses of Python floats.  :func:`override_params`
rebuilds a ``ModelParams`` with selected numeric fields replaced, by
numbers or by tensors (0-d, on the state's device) that autograd follows.
Structural fields (bools, ``temp_function``, ``grazee_ind``, names) steer
Python-level code paths and are rejected.  Paths are dotted field names
with optional tuple indexing, e.g. ``"bgc.parm_kappa_nitrif"``,
``"bgc.autotrophs[0].PCref"``, ``"dms.k_conv"``.

The entry points run where the caller's state lives: on the card for CUDA
tensors (K1's kernels), on the CPU for CPU tensors (their plain versions).
The interior kernel K2 (``interior_impl="fused"``) is forward-only and
raises under autograd, as the JAX package's is; these entry points take
the default interior.

K1's launches on CUDA, per ``run_diff`` of ``nsteps`` with the env cache:
the bracket-in instance once for the cache's stand-in and once per step
for the surface pair, the dual instance once per step; a backward sweep
with ``remat=True`` recomputes every step once, which launches the two
per-step instances once more each (the stand-in is not recomputed), so a
sweep counts the bracket-in instance ``1 + 2 * nsteps`` times and the dual
instance ``2 * nsteps`` times (``nsteps + 1`` and ``nsteps`` without
remat).  Without the env cache the constants kernel launches as often as
the dual instance, and there is no stand-in.  The backward passes launch
no kernel: they are plain PyTorch.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ocean_bgc_tpu_torch.models.coupled import CoupledState, step
from ocean_bgc_tpu_torch.ops.bgc import precompute_env
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.state import BGCForcing, BGCState, ColumnGrid

_INDEXED = re.compile(r"^([A-Za-z_][A-Za-z_0-9]*)\[(\d+)\]$")

# Fields that steer Python-level code paths; a tensor there could not
# change which path runs and would silently mis-calibrate, so they are
# rejected up front (the JAX package's list).
_STRUCTURAL_FIELDS = frozenset({
    "temp_function", "grazee_ind", "has_si", "nfixer", "imp_calcifier",
    "exp_calcifier", "sname", "lname",
})


def get_param(params: Any, path: str):
    """Read the value at a dotted/indexed parameter ``path``."""
    obj = params
    for part in path.split("."):
        m = _INDEXED.match(part)
        if m:
            obj = getattr(obj, m.group(1))[int(m.group(2))]
        else:
            obj = getattr(obj, part)
    return obj


def _set(obj: Any, parts: Sequence[str], value: Any):
    part, rest = parts[0], parts[1:]
    m = _INDEXED.match(part)
    if m:
        name, idx = m.group(1), int(m.group(2))
        seq = getattr(obj, name)
        elem = _set(seq[idx], rest, value) if rest else value
        new_seq = tuple(elem if i == idx else e for i, e in enumerate(seq))
        return dataclasses.replace(obj, **{name: new_seq})
    if rest:
        return dataclasses.replace(
            obj, **{part: _set(getattr(obj, part), rest, value)})
    if part in _STRUCTURAL_FIELDS or isinstance(getattr(obj, part), bool):
        raise TypeError(
            f"{part!r} is a structural (trace-time) field; it selects "
            "compiled code paths and cannot be overridden with a traced "
            "value")
    return dataclasses.replace(obj, **{part: value})


def override_params(params: ModelParams,
                    overrides: Mapping[str, Any]) -> ModelParams:
    """Rebuild ``params`` with the numeric fields named by ``overrides``
    replaced — values may be Python floats (a new configuration) or 0-d
    tensors (differentiable calibration inputs)."""
    out = params
    for path, value in overrides.items():
        out = _set(out, path.split("."), value)
    return out


def _flatten(s: CoupledState) -> tuple:
    b = s.bgc
    return (b.tracers, b.ph_prev_3d, b.ph_prev_alt_3d, b.surface_ph,
            b.surface_ph_alt, s.dms, s.macros)


def _unflatten(flat) -> CoupledState:
    tracers, ph3, ph3_alt, sph, sph_alt, dms, macros = flat
    return CoupledState(bgc=BGCState(tracers=tracers, ph_prev_3d=ph3,
                                     ph_prev_alt_3d=ph3_alt, surface_ph=sph,
                                     surface_ph_alt=sph_alt),
                        dms=dms, macros=macros)


def _stack(items: List[Any]):
    """Stack a list of like-structured observations (tensors inside
    tuples, lists, named tuples and dicts) along a new leading axis."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in items]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack(list(x)) for x in zip(*items)))
    if isinstance(first, (tuple, list)):
        return type(first)(_stack(list(x)) for x in zip(*items))
    raise TypeError(f"obs_fn returned a {type(first).__name__}; expected "
                    f"tensors in tuples, lists or dicts")


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [x for v in tree for x in _leaves(v)]


def run_diff(
    state: CoupledState,
    grid: ColumnGrid,
    forcing: BGCForcing,
    params: ModelParams,
    dt: float,
    nsteps: int,
    *,
    remat: bool = True,
    env_cache: bool = True,
    carbonate_impl: str = "auto",
    obs_fn: Optional[Callable[[CoupledState], Any]] = None,
):
    """Integrate ``nsteps`` (diags off), differentiably.

    Functionally the production ``run(...)`` path (constant forcing, the
    env cache built once), restructured for the adjoint: each step runs
    under ``torch.utils.checkpoint`` with ``remat`` (the state flattened
    to its seven tensors; early stop off, so that a recompute is always
    the whole step), and ``obs_fn(state)`` — an observation operator
    returning tensors, or tuples, lists and dicts of them — is evaluated
    on the post-step state each step and stacked along a leading time
    axis (the "H(x)" of variational assimilation).

    Returns ``final_state``, or ``(final_state, observations)`` when
    ``obs_fn`` is given.  ``params`` may carry tensors from
    :func:`override_params`; the env cache is built from them here, so
    gradients flow through it.  ``carbonate_impl`` as ``step`` takes it.
    """
    env = precompute_env(grid, forcing, params.bgc) if env_cache else None

    def one_step(*flat):
        s2, _ = step(_unflatten(flat), grid, forcing, params, dt,
                     compute_diags=False, carbonate_impl=carbonate_impl,
                     env=env)
        return _flatten(s2)

    flat, obs = _flatten(state), []
    for _ in range(nsteps):
        if remat:
            with set_checkpoint_early_stop(False):
                flat = checkpoint(one_step, *flat, use_reentrant=False)
        else:
            flat = one_step(*flat)
        if obs_fn is not None:
            obs.append(obs_fn(_unflatten(flat)))
    final = _unflatten(flat)
    if obs_fn is not None:
        return final, _stack(obs)
    return final


def _default_loss(sim, observed):
    """Scale-free mean-squared misfit, averaged over the observations'
    leaves (each leaf normalized by its observed magnitude so that
    multi-field observations with different units weigh comparably)."""
    leaves = [torch.mean(((a - b) / (torch.mean(torch.abs(b)) + 1e-30))
                         ** 2)
              for a, b in zip(_leaves(sim), _leaves(observed))]
    return sum(leaves) / len(leaves)


def _theta(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float64,
                        device=device).requires_grad_()


def parameter_sensitivities(
    template: ModelParams,
    paths: Sequence[str],
    state0: CoupledState,
    grid: ColumnGrid,
    forcing: BGCForcing,
    dt: float,
    nsteps: int,
    functional: Callable[[CoupledState], torch.Tensor],
    *,
    relative: bool = True,
    remat: bool = True,
    env_cache: bool = True,
    carbonate_impl: str = "auto",
) -> Dict[str, float]:
    """All parameter sensitivities of a scalar trajectory functional in
    ONE reverse sweep.

    ``functional(final_state) -> scalar`` is the quantity of interest
    (e.g. integrated surface CO2 flux, total NPP).  Returns
    ``{path: dJ/d ln p}`` by default (``relative=True`` — the scale-free
    "1% parameter change moves J by this much / 100" form a tuning study
    wants), or raw ``dJ/dp`` with ``relative=False``.

    The cost is one forward and one backward integration whatever
    ``len(paths)`` — the adjoint's advantage over a finite-difference
    re-run per parameter.  ``carbonate_impl`` as ``step`` takes it (the
    plain route, ``"torch"``, holds the kernels' sweep to it).
    """
    paths = tuple(paths)
    base = [float(get_param(template, p)) for p in paths]
    if relative and not all(b != 0 for b in base):
        raise ValueError("relative=True requires nonzero base values")
    theta = _theta([1.0] * len(paths) if relative else base,
                   state0.bgc.tracers.device)
    vals = [base[i] * theta[i] if relative else theta[i]
            for i in range(len(paths))]
    params = override_params(template, dict(zip(paths, vals)))
    final = run_diff(state0, grid, forcing, params, dt, nsteps,
                     remat=remat, env_cache=env_cache,
                     carbonate_impl=carbonate_impl)
    (g,) = torch.autograd.grad(functional(final), theta)
    return {p: float(g[i]) for i, p in enumerate(paths)}


@dataclasses.dataclass
class CalibrationResult:
    """Outcome of :func:`calibrate`."""

    params: ModelParams            # template with the fitted values
    values: Dict[str, float]       # fitted value per path
    losses: List[float]            # losses[0] = initial; losses[-1] = at
                                   # the RETURNED params (iters+1 entries)
    theta: np.ndarray              # raw optimizer variables at exit


def calibrate(
    template: ModelParams,
    paths: Sequence[str],
    state0: CoupledState,
    grid: ColumnGrid,
    forcing: BGCForcing,
    dt: float,
    nsteps: int,
    observations: Any,
    obs_fn: Callable[[CoupledState], Any],
    *,
    init: Optional[Mapping[str, float]] = None,
    iters: int = 100,
    learning_rate: float = 0.05,
    transform: str = "log",
    optimizer: Optional[Callable[[List[torch.Tensor]],
                                 torch.optim.Optimizer]] = None,
    loss_fn: Optional[Callable[[Any, Any], torch.Tensor]] = None,
    remat: bool = True,
    env_cache: bool = True,
) -> CalibrationResult:
    """Variational parameter estimation against observed trajectories.

    Fits the parameters named by ``paths`` so that the model trajectory's
    ``obs_fn`` outputs match ``observations`` (stacked along a leading
    time axis, exactly what :func:`run_diff` returns) — gradient descent
    through the full adjoint of the coupled model, which the Fortran
    reference lacks (its parameters are hand-tuned constants,
    BGC_parms.F90:346-365).

    ``transform="log"`` (default) optimizes positive rates in log space
    (value = init * exp(theta)) — sign-safe and naturally relative;
    ``"linear"`` optimizes the raw offset (value = init + theta).
    ``init`` defaults to the template's current values.  ``optimizer``:
    a callable taking the list of optimized tensors and returning a
    ``torch.optim.Optimizer`` (the counterpart of the JAX package's optax
    transform); default ``torch.optim.Adam(params, lr=learning_rate)``.
    """
    if transform not in ("log", "linear"):
        raise ValueError(f"unknown transform {transform!r}")
    paths = tuple(paths)
    init_vals = [float((init or {}).get(p, get_param(template, p)))
                 for p in paths]
    if transform == "log" and not all(v > 0 for v in init_vals):
        raise ValueError("transform='log' requires positive initial values")
    loss_fn = loss_fn or _default_loss

    def to_values(theta):
        if transform == "log":
            return [init_vals[i] * torch.exp(theta[i])
                    for i in range(len(paths))]
        return [init_vals[i] + theta[i] for i in range(len(paths))]

    def objective(theta):
        params = override_params(
            template, dict(zip(paths, to_values(theta))))
        _, sim = run_diff(state0, grid, forcing, params, dt, nsteps,
                          remat=remat, env_cache=env_cache, obs_fn=obs_fn)
        return loss_fn(sim, observations)

    theta = _theta([0.0] * len(paths), state0.bgc.tracers.device)
    opt = (optimizer([theta]) if optimizer is not None
           else torch.optim.Adam([theta], lr=learning_rate))
    losses: List[float] = []
    for _ in range(iters):
        opt.zero_grad()
        loss = objective(theta)
        losses.append(float(loss.detach()))
        loss.backward()
        opt.step()
    # one final evaluation so that losses[-1] is the loss AT the returned
    # parameters (the loop records the loss before each update)
    if iters > 0:
        with torch.no_grad():
            losses.append(float(objective(theta)))

    values = {p: float(v) for p, v in zip(paths, to_values(theta.detach()))}
    return CalibrationResult(
        params=override_params(template, values),
        values=values,
        losses=losses,
        theta=theta.detach().cpu().numpy(),
    )
