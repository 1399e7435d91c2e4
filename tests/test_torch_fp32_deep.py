"""Deep-water qualification of the port's float32 path:
``tests/test_fp32_deep.py``'s three gates on the torch step, with its
horizon and bounds, on the same branch-firing 60-level world as the f64
deep gate (``tests/test_torch_deep_world.py::deep_ragged_world_numpy``).

1. Every particulate bottom-cell branch fires under f32 at t=0, with the
   f64 branch signatures.
2. The f32 trajectory stays inside the f64 model's f32-epsilon envelope
   (``tests/test_torch_fp32_trajectory.py``), over deep ragged bathymetry
   with a shelf and a land column.
3. The range audit of the decaying particulate flux chains against
   IEEE f32's ~1.2e-38 normal floor: every nonzero deep flux of the f64
   run sits at least 12 decades above it, and f32 flushes no flux that
   f64 keeps materially nonzero.

``OCEAN_BGC_DEEP_STEPS_F32`` steps, 24 by default; ``chip_smoke.py``
runs 96 on the card.  The f64 run, its kicked copy (extra columns) and
the f32 run are taken to the step before the last once; the envelope
finishes them with the production step, the audit with a step with
diagnostics and no env cache.  No JAX here.
"""

import os

import numpy as np
import pytest
import torch

from ocean_bgc_tpu_torch.constants import LYSOCLINE_DEPTH
from ocean_bgc_tpu_torch.models.coupled import run, step
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.utils.bridge import world_from_numpy
from tests.test_torch_deep_world import (
    deep_ragged_world_numpy,
    source_sink_both,
)
from tests.test_torch_fp32_trajectory import (
    F32_EPS,
    envelope_gate,
    tracer_envelope,
)
from tests.test_torch_trajectory import DT, port_run, widen

NSTEPS = int(os.environ.get("OCEAN_BGC_DEEP_STEPS_F32", "24"))
F32_TINY = 1.1754944e-38          # smallest normal float32
FLUX_DIAGS = ("POC_FLUX_IN", "CaCO3_FLUX_IN", "SiO2_FLUX_IN",
              "dust_FLUX_IN", "P_iron_FLUX_IN")


def f32_branches(*, device="cpu"):
    """Gate 1: the bottom branches under f32 (the port's f32 world is the
    f64 world's rounding).  Returns the bSi burial fractions' ratio."""
    world = deep_ragged_world_numpy()
    out, _ = source_sink_both(world, dtype=torch.float32, device=device)
    kb = world[1]["kmax"] - 1
    zbot = world[1]["cell_bottom_depth"].astype(np.float32)
    got = {k: out.diags[k].cpu().numpy() for k in
           ("calcToSed", "SedDenitrif", "OtherRemin", "bsiToSed",
            "SiO2_FLUX_IN")}
    assert torch.isfinite(out.tendencies).all()
    assert zbot[kb[0], 0] > np.float32(LYSOCLINE_DEPTH)
    assert got["calcToSed"][kb[0], 0] == 0.0          # lysocline
    assert got["calcToSed"][kb[1], 1] > 0.0           # burial branch
    assert got["SedDenitrif"][kb[2], 2] > 0.0         # denitrif on
    assert got["SedDenitrif"][kb[3], 3] == 0.0        # NO3 gate closed
    assert got["OtherRemin"][kb[2], 2] > 0.0          # anoxic branch
    # both bSi burial efficiencies discriminate under f32: the burial
    # fraction of the bottom incoming flux in the high-flux column (eff
    # 0.2) exceeds the low-flux column's (eff 0.04) by ~5x
    sio2_in = got["SiO2_FLUX_IN"]
    frac4 = got["bsiToSed"][kb[4], 4] / sio2_in[kb[4], 4]
    frac5 = got["bsiToSed"][kb[5], 5] / sio2_in[kb[5], 5]
    assert frac4 > 0.0 and frac5 > 0.0
    assert frac4 / frac5 > 3.0, (frac4, frac5)
    return float(frac4 / frac5)


def deep_runs(nsteps, *, device="cpu"):
    """The deep world's f64 run beside its f32-epsilon-kicked copy (one
    run of twice the width) and its f32 run, ``nsteps - 1`` steps each:
    ``(world, (wide f64 state, grid, forcing), (f32 state, grid,
    forcing))``."""
    params = ModelParams()
    world = deep_ragged_world_numpy()
    runs = []
    for w, dtype in ((widen(world, F32_EPS), torch.float64),
                     (world, torch.float32)):
        s, g, f = world_from_numpy(*w, device=device, dtype=dtype)
        s, _ = run(s, g, f, params, DT, nsteps - 1)
        runs.append((s, g, f))
    return world, runs[0], runs[1]


def _numpy_final(state, cols):
    b = state.bgc
    return {k: v[..., cols].cpu().numpy() for k, v in dict(
        tracers=b.tracers, dms=state.dms, macros=state.macros).items()}


def deep_envelope(runs):
    """Gate 2 on :func:`deep_runs`: the last step of each run (the
    production step), then the f32 envelope.  Returns the worst mismatch
    over its bound."""
    world, wide, narrow = runs
    ncol = world[1]["kmax"].size
    params = ModelParams()
    fin64, _ = run(*wide, params, DT, 1)
    fin32, _ = run(*narrow, params, DT, 1)
    want = _numpy_final(fin64, slice(0, ncol))
    kicked = _numpy_final(fin64, slice(ncol, None))["tracers"]
    return envelope_gate(want, kicked, _numpy_final(fin32, slice(None)))


def range_audit(runs):
    """Gate 3 on :func:`deep_runs`: the last step with diagnostics (no
    env cache) at f64 and f32, then the flux chains against the f32
    flush threshold.  Returns the smallest nonzero f64 flux over the
    threshold."""
    world, wide, narrow = runs
    ncol = world[1]["kmax"].size
    params = ModelParams()
    _, d64 = step(*wide, params, DT, compute_diags=True)
    _, d32 = step(*narrow, params, DT, compute_diags=True)
    active = narrow[1].active_mask().cpu().numpy()
    least = np.inf
    for name in FLUX_DIAGS:
        a64 = d64[name][..., :ncol].cpu().numpy()[active]
        a32 = d32[name].cpu().numpy().astype(np.float64)[active]
        assert np.isfinite(a32).all(), name
        nz = a64 > 0.0
        if nz.any():
            floor = a64[nz].min()
            least = min(least, floor / F32_TINY)
            assert floor > 1e12 * F32_TINY, (
                f"{name}: smallest nonzero f64 flux {floor:.3e} is "
                f"within 12 decades of the f32 flush threshold")
        material = a64 > 1e-12 * (a64.max() + 1e-300)
        flushed = material & (a32 == 0.0)
        assert not flushed.any(), (
            f"{name}: {flushed.sum()} cells flushed to zero under f32 "
            f"where f64 keeps a material flux")
    return float(least)


def side_by_side(world, members):
    """``members`` copies of a NumPy world in one world, copy k's initial
    tracers multiplied by 1 + k 2^-24 (copy 0 is the world)."""
    state, grid, forcing = world

    def rep(a):
        return np.concatenate([a] * members, axis=-1)

    trc = state["bgc"]["tracers"]
    bgc = {k: rep(v) for k, v in state["bgc"].items()}
    bgc["tracers"] = np.concatenate(
        [trc * (1.0 + k * 2.0 ** -24) for k in range(members)], axis=-1)
    return ({"bgc": bgc, "dms": rep(state["dms"]),
             "macros": rep(state["macros"])},
            {k: rep(v) for k, v in grid.items()},
            {k: rep(v) for k, v in forcing.items()})


def kicked_ensemble(nsteps, members, *, device="cpu"):
    """How robust the deep envelope is: the worst tracer's mismatch over
    its envelope for each of ``members`` f32 runs of the deep world whose
    initial tracers differ by k 2^-24 (k = 0 is the gate's run), each
    against the one f64 run and yardstick of the gate.  A list, one ratio
    per member."""
    world = deep_ragged_world_numpy()
    ncol = world[1]["kmax"].size
    want, kicked = port_run(world, nsteps, kick=F32_EPS, device=device)
    got, _ = port_run(side_by_side(world, members), nsteps,
                      dtype=torch.float32, device=device)
    return [max(tracer_envelope(
        want["tracers"], kicked,
        got["tracers"][..., m * ncol:(m + 1) * ncol]).values())
        for m in range(members)]


def jax_kicked_ensemble(nsteps, members):
    """:func:`kicked_ensemble` for the JAX package on the CPU
    (``tests/test_fp32_deep.py``'s runs, each f32 run from kicked
    initial tracers), for comparison:
    ``python -c "from tests.test_torch_fp32_deep import *;
    print(jax_kicked_ensemble(96, 8))"``."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from ocean_bgc_tpu.models.coupled import run as jax_run
    from ocean_bgc_tpu.params import ModelParams as JaxParams
    from tests.test_fp32_deep import _cast32, _deep_worlds

    (s64, g64, f64), _ = _deep_worlds()
    params = JaxParams()

    def final(s, g, f):
        out, _ = jax.jit(lambda s: jax_run(s, g, f, params, DT, nsteps))(s)
        return np.asarray(out.bgc.tracers, np.float64)

    want = final(s64, g64, f64)
    kicked = final(dataclasses.replace(s64, bgc=dataclasses.replace(
        s64.bgc, tracers=s64.bgc.tracers * (1.0 + F32_EPS))), g64, f64)
    wide = side_by_side(({"bgc": {f.name: np.asarray(getattr(s64.bgc,
                                                             f.name))
                                  for f in dataclasses.fields(s64.bgc)},
                         "dms": np.asarray(s64.dms),
                         "macros": np.asarray(s64.macros)},
                        {f.name: np.asarray(getattr(g64, f.name))
                         for f in dataclasses.fields(g64)},
                        {f.name: np.asarray(getattr(f64, f.name))
                         for f in dataclasses.fields(f64)}), members)
    rebuilt = (dataclasses.replace(
        s64, bgc=dataclasses.replace(s64.bgc, **wide[0]["bgc"]),
        dms=wide[0]["dms"], macros=wide[0]["macros"]),
        dataclasses.replace(g64, **wide[1]),
        dataclasses.replace(f64, **wide[2]))
    got = final(*_cast32(jax.tree.map(jnp.asarray, rebuilt)))
    ncol = want.shape[-1]
    return [max(tracer_envelope(
        want, kicked, got[..., m * ncol:(m + 1) * ncol]).values())
        for m in range(members)]


@pytest.fixture(scope="module")
def runs():
    return deep_runs(NSTEPS)


def test_fp32_deep_bottom_branches_fire():
    f32_branches()


def test_fp32_deep_trajectory_within_perturbation_envelope(runs):
    deep_envelope(runs)


def test_fp32_deep_flux_range_audit(runs):
    range_audit(runs)


def test_f32_ecosystem_transcendentals_are_rounded_once():
    """The ecosystem's exp, log and pow (``ops/numerics.py``) evaluate a
    float32 argument at float64 and round once, and leave float64 to
    torch's own functions; the ecosystem modules call no other exp, log
    or pow (the pH solve and the equilibrium constants keep theirs, which
    K1's kernels hold).  The card's single-precision exp and pow are not
    correctly rounded, and they took the deep world's f32 runs out of the
    envelope three times as often as the CPU's did (``PERF.md``)."""
    import ast
    from pathlib import Path

    from ocean_bgc_tpu_torch.ops import numerics

    gen = torch.Generator().manual_seed(5)
    x = torch.rand(4096, generator=gen, dtype=torch.float64) * 80 - 40
    for dtype in (torch.float32, torch.float64):
        a = x.to(dtype)
        pos = a.abs() + 1e-3
        for got, want in (
                (numerics.exp(a), torch.exp(a.double())),
                (numerics.log(pos), torch.log(pos.double())),
                (numerics.pow(0.99, a), torch.pow(0.99, a.double())),
                (numerics.pow(pos, 0.667), torch.pow(pos.double(), 0.667)),
                (numerics.pow(pos, a / 40), torch.pow(pos.double(),
                                                      (a / 40).double()))):
            assert got.dtype == dtype
            assert torch.equal(got, want.to(dtype))
    ops = Path(numerics.__file__).parent
    calls = {}
    for name in ("particulates", "dms", "schmidt", "surface", "bgc"):
        tree = ast.parse((ops / f"{name}.py").read_text())
        calls[name] = sorted(
            node.func.attr for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "torch"
            and node.func.attr in ("exp", "log", "log10", "pow"))
    # bgc.py's one log10 is the env cache's stand-in pH (K1's instance)
    assert calls == {"particulates": [], "dms": [], "schmidt": [],
                     "surface": [], "bgc": ["log10"]}


def test_fp32_deep_envelope_holds_for_kicked_realizations():
    """The envelope is a statement about f32 rounding, so it must hold
    for f32 runs whose initial tracers differ in their last bits, not
    for one run only: four of them at the default horizon (at 96 steps,
    where the deep world's nitrogen-limited surface cells have started
    to flip photosynthesis on and off from step to step, it is no longer
    so for every run, in either package: ``PERF.md``)."""
    ratios = kicked_ensemble(NSTEPS, 4)
    assert max(ratios) <= 1.0, ratios
