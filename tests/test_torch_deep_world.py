"""Deep-ocean acceptance gates on the port's step:
``tests/test_deep_world.py``'s two gates with its tolerances and bounds.

The 60-level world whose bottom cells fire every particulate bottom-cell
branch (the >3300 m lysocline no-burial rule, CaCO3 burial, anoxic
``OtherRemin``, the NO3<5 sedimentary-denitrification gate, both bSi
burial efficiencies) is built here in NumPy (:func:`deep_world_numpy`),
bitwise the JAX test's ``_deep_world``, so that ``chip_smoke.py`` runs
the trajectory gate on the card, where there is no JAX, at its full
horizon of 1000 steps (``OCEAN_BGC_DEEP_STEPS`` here, 24 by default).
Only the test that holds the two builders together imports JAX, inside
the test.
"""

import os

import numpy as np
import torch

from ocean_bgc_tpu_torch.constants import LYSOCLINE_DEPTH, SPD
from ocean_bgc_tpu_torch.ops.bgc import bgc_source_sink
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.state import BGCTracers as T
from ocean_bgc_tpu_torch.utils.bridge import world_from_numpy
from ocean_bgc_tpu_torch.utils.synthetic import _synthetic_world_numpy
from tests.oracle import bgc_ref
from tests.test_torch_trajectory import (
    ULP_KICK,
    oracle_gate,
    oracle_run,
    port_run,
)

DEEP_STEPS = int(os.environ.get("OCEAN_BGC_DEEP_STEPS", "24"))
MPERCM = 0.01
BRANCH_DIAGS = ("calcToSed", "bsiToSed", "SedDenitrif", "OtherRemin",
                "pocToSed")


def deep_world_numpy(ncol=6):
    """A 60-level world (bottom 4530 m), as NumPy dicts, with per-column
    bottom conditions chosen to fire one particulate bottom-cell branch
    each (``tests/test_deep_world.py::_deep_world``, step for step):

    col 0: full depth (4530 m > 3300 m)  -> lysocline: CaCO3 NOT buried
    col 1: kmax=40 (1403 m < 3300 m)     -> CaCO3 burial branch
    col 2: full depth, bottom O2 < 1     -> anoxic other_remin branch
    col 3: full depth, bottom NO3 < 5    -> sed-denitrif gate closes
    col 4: full depth, huge diatom load  -> bSi burial eff = 0.2 branch
    col 5: full depth, modest biology    -> bSi burial eff = 0.04 branch
    """
    state, grid, forcing = _synthetic_world_numpy(nlev=60, ncol=ncol,
                                                  seed=11, ragged=False)
    kmax = np.full(ncol, 60, dtype=np.int32)
    kmax[1] = 40
    grid = dict(grid, kmax=kmax)

    trc = state["bgc"]["tracers"].copy()
    trc[50:, T.O2, 2] = 0.4
    trc[50:, T.NO3, 2] = 20.0
    trc[55:, T.NO3, 3] = 1.0
    trc[:, T.DIATC, 4] = 400.0
    trc[:, T.DIATCHL, 4] = 80.0
    trc[:, T.DIATFE, 4] = 2e-3
    trc[:, T.DIATSI, 4] = 400.0
    trc[:, T.ZOOC, 4] = 50.0
    trc[:, T.SIO3, 4] = 150.0
    trc[:, T.FE, 4] = 1e-3
    state = dict(state, bgc=dict(state["bgc"], tracers=trc))
    return state, grid, forcing


def deep_ragged_world_numpy():
    """The trajectory gate's world: :func:`deep_world_numpy` at 8
    columns, column 6 a 12-level shelf and column 7 land."""
    state, grid, forcing = deep_world_numpy(ncol=8)
    kmax = grid["kmax"].copy()
    kmax[6] = 12
    kmax[7] = 0
    return state, dict(grid, kmax=kmax), forcing


def source_sink_both(world, *, dtype=torch.float64, device="cpu"):
    """``bgc_source_sink`` with diagnostics on the port's world, and the
    oracle's on the NumPy one: ``(port output, (tend, ph, ph_alt,
    diags))``."""
    params = ModelParams()
    state, grid, forcing = world_from_numpy(*world, device=device,
                                            dtype=dtype)
    out = bgc_source_sink(state.bgc.tracers, grid, forcing,
                          state.bgc.ph_prev_3d, state.bgc.ph_prev_alt_3d,
                          params.bgc)
    b = world[0]["bgc"]
    want = bgc_ref.bgc_source_sink_ref(
        b["tracers"], world[1], world[2], b["ph_prev_3d"],
        b["ph_prev_alt_3d"], params.bgc)
    return out, want


def bsi_efficiency(want_diags, kb, cols):
    """The bSi burial efficiency the oracle applied at each column's
    bottom: bsiToSed / (parm_BSIbury * the bottom's outgoing flux)."""
    bury = ModelParams().bgc.parm_BSIbury
    return (want_diags["bsiToSed"][kb, cols]
            / (bury * np.maximum(want_diags["_sio2_flux_out_bot"][cols],
                                 1e-300)))


def branches_fire(world, got, want_diags):
    """The t=0 assertions of the ragged trajectory gate: each branch
    fires in both implementations (``got``: the port's diagnostics as
    NumPy arrays)."""
    kb = world[1]["kmax"] - 1
    zbot = world[1]["cell_bottom_depth"]
    assert zbot[kb[0], 0] > LYSOCLINE_DEPTH
    assert want_diags["_caco3_flux_out_bot"][0] > 0.0
    assert got["calcToSed"][kb[0], 0] == 0.0          # lysocline
    assert got["calcToSed"][kb[1], 1] > 0.0           # burial branch
    assert got["SedDenitrif"][kb[2], 2] > 0.0         # denitrif on
    assert got["SedDenitrif"][kb[3], 3] == 0.0        # NO3 gate closed
    assert got["OtherRemin"][kb[2], 2] > 0.0          # anoxic branch
    eff = bsi_efficiency(want_diags, kb[:6], np.arange(6))
    np.testing.assert_allclose(eff[4], 0.2, rtol=1e-12)   # high-flux
    np.testing.assert_allclose(eff[5], 0.04, rtol=1e-12)  # low-flux


def bottom_branches_gate(*, device="cpu"):
    """``tests/test_deep_world.py::test_deep_bottom_branches_match_oracle``
    on the port: every branch fires (asserted from the oracle's captured
    bottom fluxes and the constructed inputs), its signature holds in
    both implementations, and the tendencies, the branch diagnostics and
    H match the oracle.  Returns the worst mismatch over its tolerance."""
    world = deep_world_numpy()
    out, (want_tend, want_ph, _, want_diags) = source_sink_both(
        world, device=device)
    grid = world[1]
    kmax = grid["kmax"]
    zbot = grid["cell_bottom_depth"]
    cols = np.arange(kmax.size)
    kb = kmax - 1

    assert zbot[kb[0], 0] > LYSOCLINE_DEPTH
    assert want_diags["_caco3_flux_out_bot"][0] > 0.0, \
        "no CaCO3 flux reaches the deep bottom; world not representative"
    assert zbot[kb[1], 1] < LYSOCLINE_DEPTH
    assert want_diags["_caco3_flux_out_bot"][1] > 0.0
    trc = world[0]["bgc"]["tracers"]
    assert trc[kb[2], T.O2, 2] < 1.0 and trc[kb[2], T.NO3, 2] >= 5.0
    assert trc[kb[3], T.NO3, 3] < 5.0
    assert want_diags["_poc_flux_out_bot"][3] > 0.0
    sio2_alt_day = want_diags["_sio2_flux_out_bot"] * MPERCM * SPD
    assert sio2_alt_day[4] > 2.0, \
        f"bSi flux {sio2_alt_day[4]:.3f} below the 0.2-eff threshold"
    assert 0.0 < sio2_alt_day[5] < 2.0

    got = {k: out.diags[k].cpu().numpy() for k in BRANCH_DIAGS}
    assert got["calcToSed"][kb[0], 0] == 0.0
    assert want_diags["calcToSed"][kb[0], 0] == 0.0
    assert got["calcToSed"][kb[1], 1] > 0.0
    assert got["SedDenitrif"][kb[3], 3] == 0.0
    assert got["SedDenitrif"][kb[2], 2] > 0.0
    # anoxic bottom: other_remin takes the full-residual branch, which
    # exceeds the oxic formula's cap
    pf = want_diags["_poc_flux_out_bot"][2]
    fa2 = pf * 1e-6 * SPD * 365.0
    oxic_cap = min(0.1 + fa2, 0.5) * (pf - want_diags["pocToSed"][kb[2], 2])
    assert got["OtherRemin"][kb[2], 2] > oxic_cap * (1 + 1e-9), \
        "anoxic branch did not lift other_remin above the oxic cap"
    eff = bsi_efficiency(want_diags, kb, cols)
    np.testing.assert_allclose(eff[4], 0.2, rtol=1e-12)
    np.testing.assert_allclose(eff[5], 0.04, rtol=1e-12)

    worst = {}
    pairs = [("tendencies", out.tendencies.cpu().numpy(), want_tend,
              1e-9, 1e-22)]
    pairs += [(n, got[n], want_diags[n], 1e-9, 1e-22) for n in BRANCH_DIAGS]
    pairs += [("H", 10.0 ** (-out.ph_prev_3d.cpu().numpy()),
               10.0 ** (-want_ph), 2e-5, 3e-10)]
    for name, a, b, rtol, atol in pairs:
        worst[name] = float(np.max(np.abs(a - b) / (atol + rtol * np.abs(b))))
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    assert not bad, f"deep bottom branches against the oracle: {bad}"
    return max(worst.values())


def deep_branches_at_start(*, device="cpu"):
    """The ragged trajectory gate's t=0 check, on the port's step on
    ``device``."""
    world = deep_ragged_world_numpy()
    out0, (_, _, _, want_diags) = source_sink_both(world, device=device)
    branches_fire(world, {k: out0.diags[k].cpu().numpy()
                          for k in BRANCH_DIAGS}, want_diags)


def test_numpy_deep_world_is_the_jax_one():
    """:func:`deep_world_numpy` builds ``tests/test_deep_world.py``'s
    ``_deep_world`` bitwise, field by field, at both widths the gates
    use."""
    import dataclasses

    from tests.test_deep_world import _deep_world

    for ncol in (6, 8):
        js, jg, jf = _deep_world(ncol=ncol)
        ns, ng, nf = deep_world_numpy(ncol=ncol)
        pairs = [(f"bgc.{k}", getattr(js.bgc, k), v)
                 for k, v in ns["bgc"].items()]
        pairs += [("dms", js.dms, ns["dms"]),
                  ("macros", js.macros, ns["macros"])]
        pairs += [(k, getattr(jg, k), v) for k, v in ng.items()]
        pairs += [(k, getattr(jf, k), v) for k, v in nf.items()]
        names = {f.name for f in dataclasses.fields(jf)}
        assert {k for k in nf} == names
        for name, a, b in pairs:
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_deep_bottom_branches_match_oracle():
    bottom_branches_gate()


def test_deep_ragged_trajectory_matches_oracle():
    """The flagship acceptance gate on the port: the f64 trajectory
    against the scalar oracle on the 60-level ragged world whose bottom
    cells fire every particulate bottom-cell branch, plus a 12-level
    shelf and a land column.  Branch firing is asserted at t=0 in both
    implementations.  ``OCEAN_BGC_DEEP_STEPS`` steps (24 here; 1000 on the
    card in ``chip_smoke.py``); past 120 the chaos yardstick's kicked run
    rides as extra columns."""
    deep_branches_at_start()
    world = deep_ragged_world_numpy()
    got, kicked = port_run(world, DEEP_STEPS,
                           kick=ULP_KICK if DEEP_STEPS > 120 else None)
    oracle_gate(got, oracle_run(world, DEEP_STEPS), DEEP_STEPS, kicked)
