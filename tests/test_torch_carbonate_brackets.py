"""K1's bracket-in instance on the CPU: the surface pair and the env
cache's stand-in take its plain route (no launch counted), the kernel
route refuses CPU tensors, and the bracket-in and
coefficient-and-saturation instances' argument layouts against
``csrc/carbonate_dual.cu`` and ``csrc/carbonate_coeffs.cu``."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ocean_bgc_tpu_torch import constants
from ocean_bgc_tpu_torch.constants import DEL_PH
from ocean_bgc_tpu_torch.ops import carbonate as tcarb
from ocean_bgc_tpu_torch.ops.bgc import carbonate_inputs, precompute_env
from ocean_bgc_tpu_torch.ops.cuda_carbonate import (
    BRACKET_FIELDS,
    COEFF_OUTPUTS,
    solve_htotal_brackets,
)
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world
from ocean_bgc_tpu_torch.utils.profiling import counters
from tests.test_torch_carbonate import _surface_inputs, _t


def _bracket_args(seed, n):
    """Surface-pair lanes as co2calc_surface_dual builds them: DIC and
    brackets (2, n), the rest (n,)."""
    w = _surface_inputs(seed, n)
    cf = tcarb.carbonate_coeffs(_t(w["depth"]), _t(w["temp"]),
                                _t(w["salt"]), False)
    da, ta, pt, sit = tcarb._to_mass_units(*(_t(w[k]) for k in
                                             ("dic", "ta", "pt", "sit")))
    db = tcarb._to_mass_units(_t(w["dic_b"]), _t(w["ta"]), _t(w["pt"]),
                              _t(w["sit"]))[0]
    ph0 = np.random.default_rng(seed).uniform(7.4, 8.6, n)
    x1, x2 = tcarb.warm_brackets_h(_t(ph0), 7.0, 9.0, DEL_PH)
    return (cf, torch.stack([da, db]), ta, pt, sit, torch.stack([x1, x1]),
            torch.stack([x2, x2]))


def test_surface_pair_and_stand_in_take_the_plain_route_on_cpu():
    """On CPU tensors the surface pair and the env cache's stand-in solve
    run _solve_htotal_impl (bitwise its results) and count no launch of
    the bracket-in kernel; "torch" gives the same results."""
    before = counters()["k1.brackets"]
    args = _bracket_args(11, 50)
    want = tcarb._solve_htotal_impl(*args)
    for impl in ("auto", "torch"):
        assert torch.equal(solve_htotal_brackets(*args, impl=impl), want)
    w = _surface_inputs(12, 40)
    keys = ("depth", "temp", "salt", "dic", "dic_b", "ta", "pt", "sit")
    lo, hi = _t(np.full(40, 7.0)), _t(np.full(40, 9.0))
    pair = [tcarb.co2calc_surface_dual(
        *(_t(w[k]) for k in keys), lo, hi, lo, hi, _t(w["xco2_a"]),
        _t(w["xco2_b"]), _t(w["atm"]), impl=impl)
        for impl in ("auto", "torch")]
    for a, b in zip(pair[0], pair[1]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    _, grid, forcing = synthetic_world(nlev=4, ncol=6, seed=3, device="cpu")
    env = precompute_env(grid, forcing, ModelParams().bgc)
    assert torch.isfinite(env.standin_ph).all()
    assert counters()["k1.brackets"] == before


def test_bracket_instance_kernel_on_cpu_tensors_raises():
    args = _bracket_args(13, 8)
    with pytest.raises(ValueError, match="CUDA"):
        solve_htotal_brackets(*args, impl="kernel")
    with pytest.raises(ValueError, match="unknown"):
        solve_htotal_brackets(*args, impl="pallas")


def test_bracket_instance_argument_layout_matches_the_source():
    """A silent mismatch between BRACKET_FIELDS and the kernel's enum
    would solve with one field read as another."""
    src = (Path(__file__).resolve().parent.parent / "ocean_bgc_tpu_torch"
           / "csrc" / "carbonate_dual.cu").read_text()
    body = re.search(r"enum BracketField : int \{(.*?)\};", src, re.S)[1]
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names == ["B_" + f for f in BRACKET_FIELDS] + ["B_COUNT"]
    # the lanes' fields come first, then the shared ones
    assert BRACKET_FIELDS[:3] == ("dic", "x1", "x2")
    assert BRACKET_FIELDS[-1] == "h"
    assert constants.XACC == tcarb.solver_xacc(torch.float64)


def test_sat_instance_argument_layout_matches_the_source():
    """The same for the coefficient-and-saturation route: COEFF_OUTPUTS
    against the constants kernel's CoeffOut enum (the constants in
    CarbCoeffs order, then the saturation values), and the order in which
    ops/bgc.py::carbonate_inputs gives the fields without an env cache:
    the constants' three, then the dual solve's six."""
    src = (Path(__file__).resolve().parent.parent / "ocean_bgc_tpu_torch"
           / "csrc" / "carbonate_coeffs.cu").read_text()
    body = re.search(r"enum CoeffOut : int \{(.*?)\};", src, re.S)[1]
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names == ["O_" + f for f in COEFF_OUTPUTS] + ["O_COUNT"]
    assert COEFF_OUTPUTS[:15] == tcarb.CarbCoeffs._fields
    state, grid, forcing = synthetic_world(nlev=3, ncol=5, seed=2,
                                           device="cpu")
    b = state.bgc
    args = carbonate_inputs(b.tracers, grid, forcing, b.ph_prev_3d,
                            b.ph_prev_alt_3d)
    assert len(args) == 9
    assert torch.equal(args[0], grid.cell_center_depth * 0.01)
    assert torch.equal(args[-1], b.ph_prev_alt_3d)
