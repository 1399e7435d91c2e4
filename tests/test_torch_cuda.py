"""The kernels on the card against their plain versions: K1 (the dual pH
solve, on the constants kernel's constants in the step without an env
cache, and its bracket-in instance for the surface pair and the
stand-in, each also seeded) and the production and default steps with
it, K2 (the whole interior) and the fused step, P (the probe), the
host-coupling API, the env staleness guard and ``solver_health`` on the
kernels, K1's routes under autograd with the adjoint's sweep, and the
seeded K1 kernels at every parked-tail cap and block size.  Needs an NVIDIA GPU with the CUDA
toolkit (nvcc); skips without one.  Run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``."""

import dataclasses

import pytest
import torch

from ocean_bgc_tpu_torch import probe

from ocean_bgc_tpu_torch.models.coupled import step
from ocean_bgc_tpu_torch.ops.bgc import (
    bgc_source_sink,
    carbonate_inputs,
    precompute_env,
)
from ocean_bgc_tpu_torch.ops import carbonate as tcarb
from ocean_bgc_tpu_torch.ops import cuda_step as cs
from ocean_bgc_tpu_torch.ops import numerics
from ocean_bgc_tpu_torch.ops.carbonate import solver_xacc
from ocean_bgc_tpu_torch.ops.cuda_carbonate import (
    _ph_brackets,
    carbonate_coeffs_sat,
    carbonate_coeffs_sat_torch,
    co3_terms_dual_coeffs,
    co3_terms_dual_coeffs_torch,
    co3_terms_dual_sat,
    co3_terms_dual_sat_torch,
    dual_sat_and_coeffs,
    solve_htotal_brackets,
)
from ocean_bgc_tpu_torch.ops.cuda_step import (
    fused_interior_step,
    fused_interior_step_torch,
    site_test_hook,
)
from ocean_bgc_tpu_torch.ops.numerics import morel_kpar
from ocean_bgc_tpu_torch.ops.surface import bgc_surface_fluxes
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.utils.diag import coupled_registry
from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _h_diff(ph_a, ph_b):
    return (10.0 ** -ph_a.double() - 10.0 ** -ph_b.double()).abs().max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_version(cuda, dtype):
    """Same per-lane iteration, same association order, --fmad=false,
    IEEE division and the CUDA math library's exp/log10/sqrt on both
    sides: all 8 outputs (pH, H2CO3, HCO3, CO3 of both scenarios) are
    bitwise equal, on cold inputs (the initial state's 0 pH) and on warm
    ones (the state after one step), as the step gives them."""
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=12, ncol=700, seed=4,
                                           ragged=True, dtype=dtype,
                                           device=cuda)
    env = precompute_env(grid, forcing, params.bgc)
    warm, _ = step(state, grid, forcing, params, 3600.0,
                   compute_diags=False, env=env)
    for st in (state, warm):
        args = carbonate_inputs(st.bgc.tracers, grid, forcing,
                                st.bgc.ph_prev_3d, st.bgc.ph_prev_alt_3d,
                                env)
        before = co3_terms_dual_coeffs.launches
        got = co3_terms_dual_coeffs(*args, impl="kernel")
        torch.cuda.synchronize()
        assert co3_terms_dual_coeffs.launches == before + 1
        want = co3_terms_dual_coeffs_torch(*args)
        for g, w in zip(got, want):
            assert all(torch.isfinite(x).all() for x in g)
            for x, y in zip(g, w):
                assert torch.equal(x, y)


def test_kernel_step_equals_plain_step(cuda):
    """With diagnostics off the interior pH feeds only the warm-start
    carry, so tracers, DMS and MACROS are bitwise equal either way; the
    pH fields agree to the solver's tolerance (|dH| <= 2 xacc)."""
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=10, ncol=300, seed=8,
                                           device=cuda)
    env = precompute_env(grid, forcing, params.bgc)
    a = b = state
    for _ in range(2):
        a, _ = step(a, grid, forcing, params, 3600.0, compute_diags=False,
                    env=env, carbonate_impl="kernel")
        b, _ = step(b, grid, forcing, params, 3600.0, compute_diags=False,
                    env=env, carbonate_impl="torch")
    for name in ("dms", "macros"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert torch.equal(a.bgc.tracers, b.bgc.tracers)
    xacc = solver_xacc(state.bgc.tracers.dtype)
    assert _h_diff(a.bgc.ph_prev_3d, b.bgc.ph_prev_3d) <= 2 * xacc
    assert _h_diff(a.bgc.ph_prev_alt_3d, b.bgc.ph_prev_alt_3d) <= 2 * xacc


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_constants_kernel_matches_plain_version(cuda, dtype):
    """The constants kernel against its plain version (``carbonate_coeffs``
    and ``co3_sat_vals`` in torch) on the inputs of the step without an
    env cache: the 15 constants and the 2 saturation values bitwise
    equal, with and without the saturation values; one launch counted per
    call.  The constants repeat the plain version's expressions in its
    order with PyTorch's CUDA semantics (a tensor over a scalar is a
    product with the scalar's reciprocal), --fmad=false, IEEE division
    and the CUDA math library's exp, log and sqrt."""
    state, grid, forcing = synthetic_world(nlev=12, ncol=700, seed=4,
                                           ragged=True, dtype=dtype,
                                           device=cuda)
    b = state.bgc
    args = carbonate_inputs(b.tracers, grid, forcing, b.ph_prev_3d,
                            b.ph_prev_alt_3d)[:3]
    want, want_sat = carbonate_coeffs_sat_torch(*args)
    before = carbonate_coeffs_sat.launches
    for with_sat in (True, False):
        got, sat = carbonate_coeffs_sat(*args, with_sat=with_sat,
                                        impl="kernel")
        torch.cuda.synchronize()
        assert (sat is None) != with_sat
        for x, y in zip((*got, *(sat or ())), (*want, *want_sat)):
            assert x.dtype == dtype and torch.isfinite(x).all()
            assert torch.equal(x, y)
    assert carbonate_coeffs_sat.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sat_instance_matches_plain_version(cuda, dtype):
    """K1's coefficient-and-saturation route (the constants kernel, then
    the dual instance on its constants) against its plain version
    (``carbonate_coeffs``, the dual solve and ``co3_sat_vals`` in torch)
    on cold, warm and off-window inputs as the step without an env cache
    gives them: all 10 outputs bitwise equal.  ``with_sat=False`` gives
    the same 8 outputs and no saturation values; each call launches the
    constants kernel once and the dual instance once."""
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=12, ncol=700, seed=4,
                                           ragged=True, dtype=dtype,
                                           device=cuda)
    warm, _ = step(state, grid, forcing, params, 3600.0,
                   compute_diags=False)
    off = dataclasses.replace(warm, bgc=dataclasses.replace(
        warm.bgc, ph_prev_3d=_off_window(warm.bgc.ph_prev_3d),
        ph_prev_alt_3d=_off_window(warm.bgc.ph_prev_alt_3d)))
    for st in (state, warm, off):
        args = carbonate_inputs(st.bgc.tracers, grid, forcing,
                                st.bgc.ph_prev_3d, st.bgc.ph_prev_alt_3d)
        before = (carbonate_coeffs_sat.launches,
                  co3_terms_dual_coeffs.launches)
        got = co3_terms_dual_sat(*args, impl="kernel")
        nosat = co3_terms_dual_sat(*args, with_sat=False, impl="kernel")
        torch.cuda.synchronize()
        assert (carbonate_coeffs_sat.launches,
                co3_terms_dual_coeffs.launches) == (before[0] + 2,
                                                    before[1] + 2)
        want = co3_terms_dual_sat_torch(*args)
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                assert torch.isfinite(x).all()
                assert torch.equal(x, y)
        assert nosat[2] is None
        for x, y in zip(nosat[0] + nosat[1], got[0] + got[1]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_default_call_on_the_card(cuda, dtype):
    """The default call (diagnostics on, no env cache) launches the
    constants kernel, the dual instance on its constants and the surface
    pair's bracket-in instance once a step, never K2; with an env cache
    the dual instance runs on the cache's constants and the constants
    kernel not at all.  Tracers are bitwise equal between
    ``carbonate_impl="kernel"`` and ``"torch"`` and between diagnostics
    on and off; the diagnostics are the registry's and finite."""
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=10, ncol=300, seed=8,
                                           ragged=True, dtype=dtype,
                                           device=cuda)
    env = precompute_env(grid, forcing, params.bgc)
    counts = (carbonate_coeffs_sat.launches, co3_terms_dual_coeffs.launches,
              solve_htotal_brackets.launches, _k2_counts())
    a = b = c = state
    for _ in range(2):
        a, d = step(a, grid, forcing, params, 3600.0)
        b, _ = step(b, grid, forcing, params, 3600.0, carbonate_impl="torch")
        c, _ = step(c, grid, forcing, params, 3600.0, compute_diags=False)
    torch.cuda.synchronize()
    # a and c on the kernels, b on the plain versions
    assert (carbonate_coeffs_sat.launches, co3_terms_dual_coeffs.launches,
            solve_htotal_brackets.launches, _k2_counts()) == (
        counts[0] + 4, counts[1] + 4, counts[2] + 4, counts[3])
    for x, y in ((a, b), (a, c)):
        assert torch.equal(x.bgc.tracers, y.bgc.tracers)
        assert torch.equal(x.dms, y.dms)
        assert torch.equal(x.macros, y.macros)
    assert set(d) == set(coupled_registry())
    assert all(torch.isfinite(v).all() for v in d.values())
    before = (carbonate_coeffs_sat.launches, co3_terms_dual_coeffs.launches)
    _, de = step(state, grid, forcing, params, 3600.0, env=env)
    assert (carbonate_coeffs_sat.launches,
            co3_terms_dual_coeffs.launches) == (before[0], before[1] + 1)
    assert set(de) == set(d)


def test_health_call_evaluates_the_constants_once_without_a_sync(
        cuda, monkeypatch):
    """The default call with health counters evaluates the interior's
    constants once a step, on the constants kernel (no eager
    ``carbonate_coeffs`` on the interior), for the solve and the health
    residual alike, and makes no host synchronisation; its tracers,
    diagnostics and counters are bitwise those of the plain route."""
    from ocean_bgc_tpu_torch.ops import bgc, cuda_carbonate
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=10, ncol=300, seed=8,
                                           ragged=True, device=cuda)
    want, wd = step(state, grid, forcing, params, 3600.0, health=True,
                    carbonate_impl="torch")
    step(state, grid, forcing, params, 3600.0, health=True)  # loads the libs
    torch.cuda.synchronize()
    eager = []

    def counted(*args, **kwargs):
        eager.append(args[0].shape)
        raise AssertionError("eager constants on the kernel route")
    monkeypatch.setattr(cuda_carbonate, "carbonate_coeffs", counted)
    monkeypatch.setattr(bgc, "carbonate_coeffs", counted)
    before = carbonate_coeffs_sat.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, gd = step(state, grid, forcing, params, 3600.0, health=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert carbonate_coeffs_sat.launches == before + 1 and not eager
    assert torch.equal(got.bgc.tracers, want.bgc.tracers)
    assert set(gd) == set(wd)
    for k, v in gd.items():
        assert torch.equal(v, wd[k]), k


def _k2_counts():
    """K2's launch counts: (solve kernel, biology kernel)."""
    return cs._launch_solve.launches, cs._launch_bio.launches


def _fused_world(cuda, dtype, rest):
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=12, ncol=700, seed=4,
                                           ragged=True, dtype=dtype,
                                           device=cuda)
    if rest:
        params = dataclasses.replace(params, bgc=dataclasses.replace(
            params.bgc, lrest_no3=True, lrest_po4=True, lrest_sio3=True))
        forcing = dataclasses.replace(
            forcing,
            nutr_restore_rtau=torch.full_like(forcing.nutr_restore_rtau,
                                              1e-7),
            no3_clim=forcing.no3_clim * 1.1)
    return params, state, grid, forcing


@pytest.mark.parametrize("rest", [False, True], ids=["", "lrest"])
@pytest.mark.parametrize("use_env", [True, False], ids=["env", "no_env"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_interior_kernel_matches_plain_version(cuda, dtype, use_env, rest):
    """K2 against its plain version (bgc_source_sink with the plain pH
    solve) on cold and warm inputs: pH bitwise equal (the same device
    solve as K1, on the same inputs), tendencies within 1e-10 (f64) or
    3e-5 (f32) of each tracer's largest magnitude, each of its two
    kernels' launches counted."""
    params, state, grid, forcing = _fused_world(cuda, dtype, rest)
    env = precompute_env(grid, forcing, params.bgc) if use_env else None
    warm, _ = step(state, grid, forcing, params, 3600.0,
                   compute_diags=False, env=env)
    tol = 1e-10 if dtype == torch.float64 else 3e-5
    for st in (state, warm):
        b = st.bgc
        before = _k2_counts()
        got = fused_interior_step(b.tracers, grid, forcing, b.ph_prev_3d,
                                  b.ph_prev_alt_3d, params.bgc, env=env,
                                  impl="kernel")
        torch.cuda.synchronize()
        assert _k2_counts() == (before[0] + 1, before[1] + 1)
        want = fused_interior_step_torch(b.tracers, grid, forcing,
                                         b.ph_prev_3d, b.ph_prev_alt_3d,
                                         params.bgc, env=env)
        assert torch.equal(got.ph_prev_3d, want.ph_prev_3d)
        assert torch.equal(got.ph_prev_alt_3d, want.ph_prev_alt_3d)
        assert torch.isfinite(got.tendencies).all()
        scale = want.tendencies.abs().amax(dim=(0, 2), keepdim=True) + 1e-30
        err = ((got.tendencies - want.tendencies).abs() / scale).max()
        assert err <= tol, err.item()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_special_cased_torch_sites_match(cuda, dtype):
    """The kernel's device functions where PyTorch's CUDA ops special-case
    their arguments: 0.99 ** x (ops/numerics.py::pow with a scalar base,
    the sedimentary denitrification) and the Morel PAR attenuation
    (ops/numerics.py::morel_kpar), against the port's functions on the
    card (at f32 both evaluated at f64 and rounded once)."""
    gen = torch.Generator().manual_seed(3)
    x = (torch.rand(100_000, generator=gen, dtype=torch.float64) * 700
         - 350).to(dtype=dtype, device=cuda)
    assert torch.equal(site_test_hook(x, "sed_pow"), numerics.pow(0.99, x))
    chl = (torch.rand(100_000, generator=gen, dtype=torch.float64) * 5
           + 0.02).to(dtype=dtype, device=cuda)
    assert torch.equal(site_test_hook(chl, "morel_kpar"),
                       morel_kpar(chl))


def test_fused_step_launches_k2_once_per_step_and_never_k1(cuda):
    """A fused step launches each of K2's two kernels (the pH solve and
    the biology) once and the surface pair's bracket-in K1, never the
    dual K1."""
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=10, ncol=300, seed=8,
                                           device=cuda)
    env = precompute_env(grid, forcing, params.bgc)
    k1, k2 = co3_terms_dual_coeffs.launches, _k2_counts()
    kb = solve_htotal_brackets.launches
    for _ in range(3):
        state, _ = step(state, grid, forcing, params, 3600.0,
                        compute_diags=False, env=env, interior_impl="fused")
    torch.cuda.synchronize()
    assert _k2_counts() == (k2[0] + 3, k2[1] + 3)
    assert solve_htotal_brackets.launches == kb + 3
    assert co3_terms_dual_coeffs.launches == k1
    assert torch.isfinite(state.bgc.tracers).all()


def test_default_step_launches_k1_and_the_surface_instance(cuda):
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=10, ncol=300, seed=8,
                                           device=cuda)
    kb = solve_htotal_brackets.launches
    env = precompute_env(grid, forcing, params.bgc)
    assert solve_htotal_brackets.launches == kb + 1      # the stand-in
    k1, k2 = co3_terms_dual_coeffs.launches, _k2_counts()
    for _ in range(3):
        state, _ = step(state, grid, forcing, params, 3600.0,
                        compute_diags=False, env=env)
    torch.cuda.synchronize()
    assert co3_terms_dual_coeffs.launches == k1 + 3
    assert solve_htotal_brackets.launches == kb + 4
    assert _k2_counts() == k2


def _bracket_lanes(cuda, dtype):
    """Interior cells of a ragged world with four kinds of bracket, each
    a quarter of the lanes: cold (the wide window), warm (the pH after
    one step -/+ DEL_PH), off-window (that pH shifted by 0.5, so the
    bracket must grow) and the step's own warm seeds of the ALT_CO2
    scenario after two steps (at f32 over a third of warm problems take
    14-24 steps, chip_smoke.py's step distribution)."""
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=12, ncol=700, seed=4,
                                           ragged=True, dtype=dtype,
                                           device=cuda)
    env = precompute_env(grid, forcing, params.bgc)
    s1, _ = step(state, grid, forcing, params, 3600.0, compute_diags=False,
                 env=env)
    s2, _ = step(s1, grid, forcing, params, 3600.0, compute_diags=False,
                 env=env)
    dic, ta, pt, sit, _, _, coeffs = carbonate_inputs(
        s2.bgc.tracers, grid, forcing, s2.bgc.ph_prev_3d,
        s2.bgc.ph_prev_alt_3d, env)
    m = tcarb._to_mass_units(dic, ta, pt, sit)
    ph1 = s1.bgc.ph_prev_3d
    seeds = [torch.zeros_like(ph1), ph1,
             torch.where(torch.arange(ph1.numel(), device=cuda).view(
                 ph1.shape) % 2 == 0, ph1 + 0.5, ph1 - 0.5),
             s2.bgc.ph_prev_alt_3d]
    quarter = ph1.shape[1] // 4
    ph = torch.cat([sd[:, i * quarter:(i + 1) * quarter]
                    for i, sd in enumerate(seeds)], dim=1)
    cut = slice(0, 4 * quarter)
    m = [x[:, cut].contiguous() for x in m]
    coeffs = tcarb.CarbCoeffs(*(k[:, cut].contiguous() for k in coeffs))
    x1, x2 = _ph_brackets(ph.contiguous())
    return coeffs, m, x1, x2


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bracket_instance_matches_plain_solve(cuda, dtype):
    """K1's bracket-in instance against _solve_htotal_impl, bitwise, on
    cold, warm, off-window (bracket growth) and the step's own warm lanes;
    one launch counted.  Then the surface layout: two scenarios of lanes
    reading one shared set of tracers and constants in place."""
    coeffs, m, x1, x2 = _bracket_lanes(cuda, dtype)
    before = solve_htotal_brackets.launches
    got = solve_htotal_brackets(coeffs, *m, x1, x2, impl="kernel")
    torch.cuda.synchronize()
    assert solve_htotal_brackets.launches == before + 1
    want, stats = tcarb._solve_htotal_impl(coeffs, *m, x1, x2,
                                           with_stats=True)
    assert (stats["grows"] > 0).any()
    assert torch.equal(got, want)

    row = [x[3].contiguous() for x in m]
    ccol = tcarb.CarbCoeffs(*(k[3].contiguous() for k in coeffs))
    dic2 = torch.stack([row[0], row[0] * 0.97])
    xs1 = torch.stack([x1[3], x1[5]])
    xs2 = torch.stack([x2[3], x2[5]])
    got = solve_htotal_brackets(ccol, dic2, *row[1:], xs1, xs2,
                                impl="kernel")
    want = tcarb._solve_htotal_impl(ccol, dic2, *row[1:], xs1, xs2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("seeded", [False, True], ids=["", "seeded"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stats_variant_matches_plain_version(cuda, dtype, seeded):
    """The bracket-in instance's statistics variant (``solve_htotal_stats``
    on CUDA tensors, one launch counted in ``.stats_launches``) on the
    lanes above and in the surface layout: H bitwise the launch without
    statistics and the plain version, the steps and converged flags equal
    to ``_solve_htotal_impl``'s lane for lane, unseeded and seeded near
    the windows' midpoints (clamped into the grown brackets where the
    window is off); inputs that require grad raise."""
    coeffs, m, x1, x2 = _bracket_lanes(cuda, dtype)
    x0 = None
    if seeded:
        x0 = torch.where(torch.arange(x1.numel(), device=cuda).view(
            x1.shape) % 3 == 0, 0.0, (x1 * x2).sqrt() * 1.01)
    before = (solve_htotal_brackets.launches,
              solve_htotal_brackets.seeded_launches,
              solve_htotal_brackets.stats_launches)
    h, iters, conv = tcarb.solve_htotal_stats(coeffs, *m, x1, x2, x0=x0)
    torch.cuda.synchronize()
    assert (solve_htotal_brackets.launches,
            solve_htotal_brackets.seeded_launches,
            solve_htotal_brackets.stats_launches) == (before[0], before[1],
                                                      before[2] + 1)
    assert iters.dtype == torch.int32 and conv.dtype == torch.bool
    want, st = tcarb._solve_htotal_impl(coeffs, *m, x1, x2, with_stats=True,
                                        x0=x0)
    assert torch.equal(h, want)
    assert torch.equal(h, solve_htotal_brackets(coeffs, *m, x1, x2, seed=x0,
                                                impl="kernel"))
    assert torch.equal(iters, st["iters"])
    assert torch.equal(conv, st["converged"])
    # some f32 lanes end at MAXIT: the flags say which, as the plain
    # version's do
    assert (st["grows"] > 0).any() and conv.any()

    row = [x[3].contiguous() for x in m]
    ccol = tcarb.CarbCoeffs(*(k[3].contiguous() for k in coeffs))
    dic2 = torch.stack([row[0], row[0] * 0.97])
    xs1, xs2 = torch.stack([x1[3], x1[5]]), torch.stack([x2[3], x2[5]])
    xs0 = None if x0 is None else torch.stack([x0[3], x0[5]])
    got = solve_htotal_brackets(ccol, dic2, *row[1:], xs1, xs2, seed=xs0,
                                impl="kernel", with_stats=True)
    want, st = tcarb._solve_htotal_impl(ccol, dic2, *row[1:], xs1, xs2,
                                        with_stats=True, x0=xs0)
    for g, w in zip(got, (want, st["iters"], st["converged"])):
        assert torch.equal(g, w)
    with pytest.raises(RuntimeError, match="require grad"):
        tcarb.solve_htotal_stats(coeffs, m[0].clone().requires_grad_(),
                                 *m[1:], x1, x2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_single_point_api_is_one_launch_bitwise(cuda, dtype):
    """``co3_terms`` (pressure as a mask), ``co2calc_surface`` and
    ``comp_htotal`` on CUDA tensors: one launch of the bracket-in
    instance each, every output bitwise ``impl="torch"`` on the same
    tensors; the cold and a +/-0.2 window; gradients through the kernel
    route equal the plain route's."""
    state, grid, forcing = synthetic_world(nlev=12, ncol=700, seed=4,
                                           ragged=True, dtype=dtype,
                                           device=cuda)
    trc = state.bgc.tracers.clamp_min(0.0)
    from ocean_bgc_tpu_torch.state import BGCTracers as T
    tracers = [trc[:, i] for i in (T.DIC, T.ALK, T.PO4, T.SIO3)]
    depth = grid.cell_center_depth * 0.01
    env = (depth, forcing.potential_temperature, forcing.salinity)
    press = (torch.arange(12, device=cuda) > 0)[:, None].expand(depth.shape)
    lo, hi = torch.full_like(depth, 6.0), torch.full_like(depth, 9.0)

    def run(fn, *args, **kw):
        before = solve_htotal_brackets.launches
        got = fn(*args, impl="kernel", **kw)
        torch.cuda.synchronize()
        assert solve_htotal_brackets.launches == before + 1, fn.__name__
        want = fn(*args, impl="torch", **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w), fn.__name__
        return got
    ph = run(tcarb.co3_terms, *env, *tracers, lo, hi, press)[0]
    run(tcarb.co3_terms, *env, *tracers, ph - 0.2, ph + 0.2, press)
    surf = [x[0] for x in tracers]
    run(tcarb.co2calc_surface, forcing.surface_depth, forcing.sst,
        forcing.sss, *surf, 7.0, 9.0, forcing.atm_co2,
        forcing.surface_pressure)
    coeffs = tcarb.carbonate_coeffs(*env, press)
    run(tcarb.comp_htotal, coeffs, *tracers, lo, hi)

    dic = tracers[0].clone().requires_grad_()
    grads = [torch.autograd.grad(tcarb.co3_terms(
        *env, dic, *tracers[1:], lo, hi, press, impl=impl)[3].sum(), dic)[0]
        for impl in ("kernel", "torch")]
    assert torch.equal(*grads)


def test_surface_fluxes_make_no_host_sync(cuda):
    """The surface pair on the bracket-in kernel: bgc_surface_fluxes on
    CUDA tensors runs without one host synchronisation, and equals its
    plain route bitwise."""
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=10, ncol=300, seed=8,
                                           device=cuda)
    b = state.bgc
    args = (b.tracers, forcing, b.surface_ph, b.surface_ph_alt, params.bgc)
    want = bgc_surface_fluxes(*args, carbonate_impl="torch")
    bgc_surface_fluxes(*args)           # loads the library
    torch.cuda.synchronize()
    kb = solve_htotal_brackets.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = bgc_surface_fluxes(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert solve_htotal_brackets.launches == kb + 1
    for x, y in zip(got[:3], want[:3]):
        assert torch.equal(x, y)


def _hold_k2_to_plain(got, want, dtype):
    assert torch.equal(got.ph_prev_3d, want.ph_prev_3d)
    assert torch.equal(got.ph_prev_alt_3d, want.ph_prev_alt_3d)
    assert torch.isfinite(got.tendencies).all()
    tol = 1e-10 if dtype == torch.float64 else 3e-5
    scale = want.tendencies.abs().amax(dim=(0, 2), keepdim=True) + 1e-30
    err = ((got.tendencies - want.tendencies).abs() / scale).max()
    assert err <= tol, err.item()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_interior_kernel_on_irregular_worlds(cuda, dtype):
    """K2 against its plain version where its tiles are ragged: 7 levels
    over 37 columns (fewer than one block's tile), with columns of kmax 0,
    1 and nlev, at the default tile and at 3 columns per block; cold and
    warm."""
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=7, ncol=37, seed=5,
                                           ragged=True, dtype=dtype,
                                           device=cuda)
    kmax = grid.kmax.clone()
    kmax[:3] = torch.tensor([0, 1, 7], dtype=kmax.dtype)
    grid = dataclasses.replace(grid, kmax=kmax)
    env = precompute_env(grid, forcing, params.bgc)
    warm, _ = step(state, grid, forcing, params, 3600.0,
                   compute_diags=False, env=env)
    for st in (state, warm):
        b = st.bgc
        a = (b.tracers, grid, forcing, b.ph_prev_3d, b.ph_prev_alt_3d,
             params.bgc)
        got = fused_interior_step(*a, env=env, impl="kernel")
        torch.cuda.synchronize()
        want = fused_interior_step_torch(*a, env=env)
        _hold_k2_to_plain(got, want, dtype)
        fields = cs.kernel_inputs(*a, env)
        narrow = cs.FusedInteriorOut(*(torch.empty_like(t) for t in got))
        cs._launch_solve(fields, narrow)
        cs._launch_bio(fields, narrow, params.bgc, cols=3)
        torch.cuda.synchronize()
        _hold_k2_to_plain(narrow, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_interior_kernel_at_the_flagship_size(cuda, dtype):
    """K2 against its plain version at 60 x 8192 (ragged), warm."""
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=60, ncol=8192, seed=17,
                                           ragged=True, dtype=dtype,
                                           device=cuda)
    env = precompute_env(grid, forcing, params.bgc)
    warm, _ = step(state, grid, forcing, params, 3600.0,
                   compute_diags=False, env=env)
    b = warm.bgc
    a = (b.tracers, grid, forcing, b.ph_prev_3d, b.ph_prev_alt_3d,
         params.bgc)
    got = fused_interior_step(*a, env=env, impl="kernel")
    torch.cuda.synchronize()
    _hold_k2_to_plain(got, fused_interior_step_torch(*a, env=env), dtype)


def test_probe_kernel_matches_plain_version(cuda):
    tr, temp, kmax = probe.probe_inputs(cuda)
    before = probe.probe_patterns.launches
    got = probe.probe_patterns(tr, temp, kmax)
    torch.cuda.synchronize()
    assert probe.probe_patterns.launches == before + 1
    assert probe.max_rel_err(got, probe.probe_patterns_torch(
        tr, temp, kmax)) <= probe.RTOL
    assert probe.launch_shape(probe.NLEV, probe.C)[1] > 1


@pytest.mark.parametrize("nlev", [1, 12, 60])
def test_probe_kernel_at_every_shape(cuda, nlev):
    """P at nlev levels and 1, 31, 33, 257 and 8192 columns, kmax over
    0..nlev with columns at 0 and at nlev: one launch a call, within
    RTOL of the plain version, and the same bits in blocks of 1, 2 and
    32 columns as in the default tile."""
    for seed, ncol in enumerate((1, 31, 33, 257, 8192)):
        args = probe.shaped_inputs(nlev, ncol, seed=seed, device=cuda)
        before = probe.probe_patterns.launches
        got = probe.probe_patterns(*args)
        torch.cuda.synchronize()
        assert probe.probe_patterns.launches == before + 1
        assert probe.max_rel_err(
            got, probe.probe_patterns_torch(*args)) <= probe.RTOL, ncol
        for tile in (1, 2, 32):
            other = probe._launch(*args, tile=tile)
            assert all(torch.equal(a, b) for a, b in zip(got, other)), tile


def test_probe_cpu_tensors_take_the_plain_route(cuda):
    """With a card present, CPU tensors still take the plain version and
    launch nothing; the kernel refuses fewer than 4 tracer slots."""
    args = probe.probe_inputs("cpu")
    before = probe.probe_patterns.launches
    got = probe.probe_patterns(*args)
    assert probe.probe_patterns.launches == before
    assert all(torch.equal(g, w) for g, w in
               zip(got, probe.probe_patterns_torch(*args)))
    with pytest.raises(ValueError, match="slot 3"):
        probe.probe_patterns(*probe.shaped_inputs(12, 33, ntr=3,
                                                  device=cuda))


def _off_window(ph):
    """``ph`` moved off its warm window by +/-0.5 on alternate cells."""
    idx = torch.arange(ph.numel(), device=ph.device).view(ph.shape)
    step_ = torch.where(idx % 2 == 0, 0.5, -0.5).to(ph.dtype)
    return torch.where(ph != 0.0, ph + step_, ph).contiguous()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_seeded_variants_match_plain_versions(cuda, dtype):
    """K1's seeded variants against their seeded plain versions, bitwise
    on every output, on cold, warm and off-window inputs (the bracket
    grows before the seed is clamped into it): the dual instance on the
    env cache's constants and on the constants kernel's (the
    coefficient-and-saturation route), and the bracket-in instance; each
    solve's launch is counted as seeded and not as unseeded."""
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=12, ncol=700, seed=4,
                                           ragged=True, dtype=dtype,
                                           device=cuda)
    env = precompute_env(grid, forcing, params.bgc)
    warm, _ = step(state, grid, forcing, params, 3600.0,
                   compute_diags=False, env=env)
    off = dataclasses.replace(warm, bgc=dataclasses.replace(
        warm.bgc, ph_prev_3d=_off_window(warm.bgc.ph_prev_3d),
        ph_prev_alt_3d=_off_window(warm.bgc.ph_prev_alt_3d),
        surface_ph=_off_window(warm.bgc.surface_ph),
        surface_ph_alt=_off_window(warm.bgc.surface_ph_alt)))
    counts = (co3_terms_dual_coeffs.launches, carbonate_coeffs_sat.launches,
              solve_htotal_brackets.launches)
    seeded = (co3_terms_dual_coeffs.seeded_launches,
              solve_htotal_brackets.seeded_launches)
    for st in (state, warm, off):
        b = st.bgc
        args = carbonate_inputs(b.tracers, grid, forcing, b.ph_prev_3d,
                                b.ph_prev_alt_3d, env)
        got = co3_terms_dual_coeffs(*args, seed=True, impl="kernel")
        want = co3_terms_dual_coeffs_torch(*args, seed=True)
        for x, y in zip(got[0] + got[1], want[0] + want[1]):
            assert torch.isfinite(x).all() and torch.equal(x, y)
        sargs = carbonate_inputs(b.tracers, grid, forcing, b.ph_prev_3d,
                                 b.ph_prev_alt_3d)
        got = co3_terms_dual_sat(*sargs, seed=True, impl="kernel")
        want = co3_terms_dual_sat_torch(*sargs, seed=True)
        for x, y in zip(got[0] + got[1] + got[2], want[0] + want[1]
                        + want[2]):
            assert torch.isfinite(x).all() and torch.equal(x, y)
        surf = st.bgc.tracers[0].clamp_min(0.0)
        coeffs = tcarb.carbonate_coeffs(forcing.surface_depth, forcing.sst,
                                        forcing.sss, False)
        m = tcarb._to_mass_units(surf[6], surf[8], surf[0], surf[2])
        x1, x2, x0 = tcarb.warm_brackets_h(st.bgc.surface_ph, 7.0, 9.0, 0.2,
                                           with_seed=True)
        got = solve_htotal_brackets(coeffs, *m, x1, x2, seed=x0,
                                    impl="kernel")
        torch.cuda.synchronize()
        want = tcarb._solve_htotal_impl(coeffs, *m, x1, x2, x0=x0)
        assert torch.equal(got, want)
    # per case: the dual instance seeded twice (on the cached and on the
    # kernel's constants), the constants kernel (which has no seed) once
    assert (co3_terms_dual_coeffs.launches, carbonate_coeffs_sat.launches,
            solve_htotal_brackets.launches) == (counts[0], counts[1] + 3,
                                                counts[2])
    assert (co3_terms_dual_coeffs.seeded_launches,
            solve_htotal_brackets.seeded_launches) == (seeded[0] + 6,
                                                       seeded[1] + 3)


def _parking_inputs(cuda, dtype, nlev, ncol, n=None):
    """Seeded K1 inputs whose problems park at every stage of the
    parked-tail schedule, from a ragged world one step warm (its first
    ``n`` cells of the top level as a (1, n) world where given): by cell
    index mod 6, cold lanes (the 0 pH sentinel, no seed), warm lanes,
    off-window lanes (both brackets grow), lanes whose ambient problem is
    warm and whose ALT_CO2 one is off its window (it parks after the
    lane's ambient one is done), acidic lanes (alkalinity 300 mmol/m^3,
    pH ~5.2: at f32 they end on stalls, and some run to MAXIT) and lanes
    with a NaN alkalinity (their residual is NaN, so they run to MAXIT
    with finite outputs); from 512 cells on the first 256 are cold, so
    that a block parks every lane.  Returns the nine inputs of
    co3_terms_dual_sat and the env cache's constants of the same cells."""
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=nlev, ncol=ncol, seed=4,
                                           ragged=True, dtype=dtype,
                                           device=cuda)
    env = precompute_env(grid, forcing, params.bgc)
    warm, _ = step(state, grid, forcing, params, 3600.0,
                   compute_diags=False, env=env)
    b = warm.bgc
    sargs = list(carbonate_inputs(b.tracers, grid, forcing, b.ph_prev_3d,
                                  b.ph_prev_alt_3d))
    coeffs = list(carbonate_inputs(b.tracers, grid, forcing, b.ph_prev_3d,
                                   b.ph_prev_alt_3d, env)[6])
    if n is not None:
        sargs = [x[:1, :n] for x in sargs]
        coeffs = [x[:1, :n] for x in coeffs]
    sargs = [x.contiguous() for x in sargs]
    ph = sargs[7]
    kind = torch.arange(ph.numel(), device=cuda).view(ph.shape) % 6
    off = _off_window(ph)
    zero = torch.zeros_like(ph)
    pa = torch.where(kind == 0, zero, torch.where(kind == 2, off, ph))
    pb = torch.where(kind == 0, zero, torch.where((kind == 2) | (kind == 3),
                                                  off, ph))
    if ph.numel() >= 512:
        pa.view(-1)[:256] = 0.0
        pb.view(-1)[:256] = 0.0
    ta = torch.where(kind == 4, 300.0, sargs[4])
    ta = torch.where(kind == 5, float("nan"), ta)
    sargs[4], sargs[7], sargs[8] = ta, pa.contiguous(), pb.contiguous()
    return sargs, tcarb.CarbCoeffs(*(k.contiguous() for k in coeffs))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("size", [(60, 8192), (7, 37), (2, 257, 1),
                                  (2, 257, 31), (2, 257, 33),
                                  (2, 257, 257)])
def test_parked_schedule_matches_plain_versions(cuda, dtype, size):
    """K1's seeded kernels against their seeded plain versions, bitwise
    on every output: the dual instance at f32 on the parked-tail schedule
    at the caps 0 to 3 and the default, and at both types at MAXIT (one
    lane per thread), on the env cache's constants and on the constants
    kernel's (the env-off route, co3_terms_dual_sat); the dual instance
    and the bracket-in instance (on the same cells as lanes) in the
    default blocks and in 256-thread blocks; inputs from
    :func:`_parking_inputs`.  Each public call is one seeded launch; the
    unseeded instances' outputs stay their plain versions'; the C entry
    point refuses a parked launch short of a thread per lane, and a
    parked cap at f64."""
    from ocean_bgc_tpu_torch.constants import MAXIT
    from ocean_bgc_tpu_torch.ops import cuda_carbonate as cc
    sargs, coeffs = _parking_inputs(cuda, dtype, *size)
    n = sargs[3].numel()
    dual_args = (*sargs[3:], coeffs)
    fields = (*sargs[3:], *coeffs)
    want = cc.co3_terms_dual_coeffs_torch(*dual_args, seed=True)
    want = want[0] + want[1]
    want_sat = cc.co3_terms_dual_sat_torch(*sargs, seed=True)
    want_sat = want_sat[0] + want_sat[1] + want_sat[2]
    m = [x.reshape(-1) for x in tcarb._to_mass_units(*sargs[3:7])]
    x1, x2, x0 = (x.reshape(-1) for x in _ph_brackets(sargs[7], seed=True))
    flat = tcarb.CarbCoeffs(*(k.reshape(-1) for k in coeffs))
    want_h, stats = tcarb._solve_htotal_impl(flat, *m, x1, x2, x0=x0,
                                             with_stats=True)
    bfields = dict(dic=m[0], x1=x1, x2=x2, x0=x0, ta=m[1], pt=m[2],
                   sit=m[3], **flat._asdict())
    if n >= 33:
        # the inputs reach every stage: ALT_CO2 problems that park after
        # their lane's ambient one, bracket growth, lanes at MAXIT and (at
        # 512 cells or more) a block of cold lanes
        _, _, dstats = cc.co3_terms_dual_coeffs_torch(*dual_args, seed=True,
                                                      with_stats=True)
        ia, ib = (st["iters"].reshape(-1) for st in dstats)
        assert any(((ia <= c) & (ib > c)).any() for c in (1, 2, 3))
        assert (stats["grows"] > 0).any() and (stats["iters"] == MAXIT).any()
        if n >= 512:
            assert (ia[:256] > 1).all() and (ib[:256] > 1).all()
    caps = ({0, 1, 2, 3, cc.PARK_CAP} if dtype == torch.float32 else set())
    for cap in sorted({*caps, MAXIT}):
        got = cc._launch(fields, dtype, True, cap=cap)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), cap
        k, sat = cc.carbonate_coeffs_sat(*sargs[:3], impl="kernel")
        got = (*cc._launch((*sargs[3:], *k), dtype, True, cap=cap), *sat)
        assert all(torch.equal(x, y) for x, y in zip(got, want_sat)), cap
    for threads in (None, 256):
        got = cc._launch(fields, dtype, True, threads=threads)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), threads
        got = cc._launch_brackets(bfields, threads=threads)
        assert torch.equal(got, want_h), threads
    assert all(torch.isfinite(x).all() for x in want)
    counts = _k1_counts()
    got = cc.co3_terms_dual_coeffs(*dual_args, seed=True, impl="kernel")
    assert all(torch.equal(x, y) for x, y in zip(got[0] + got[1], want))
    got = cc.co3_terms_dual_sat(*sargs, seed=True, impl="kernel")
    assert all(torch.equal(x, y) for x, y in zip(got[0] + got[1] + got[2],
                                                 want_sat))
    got = cc.solve_htotal_brackets(flat, *m, x1, x2, seed=x0,
                                   impl="kernel")
    assert torch.equal(got, want_h)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(counts, _k1_counts())) == (
        0, 1, 0, 2, 1)
    got = cc.co3_terms_dual_coeffs(*dual_args, impl="kernel")
    plain = cc.co3_terms_dual_coeffs_torch(*dual_args)
    assert all(torch.equal(x, y) for x, y in zip(got[0] + got[1],
                                                 plain[0] + plain[1]))
    got = cc.solve_htotal_brackets(flat, *m, x1, x2, impl="kernel")
    assert torch.equal(got, tcarb._solve_htotal_impl(flat, *m, x1, x2))
    if dtype == torch.float32 and n > 256:
        # the parked kernel does not stride: a grid short of a thread per
        # lane is refused, as is a parked cap at f64
        import ctypes

        from ocean_bgc_tpu_torch.ops import _kernels
        lib = _kernels.load("carbonate_dual")
        fn = lib.obgc_carbonate_dual
        fn.argtypes, fn.restype = cc.DUAL_ARGTYPES, ctypes.c_int
        outs = [torch.empty_like(fields[0]) for _ in range(8)]
        ins_p = (ctypes.c_void_p * 21)(*(t.data_ptr() for t in fields))
        outs_p = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in outs))
        stream = torch.cuda.current_stream().cuda_stream
        for is_double, cap, blocks in ((0, 0, 1), (1, 0, -(-n // 256))):
            assert fn(is_double, 1, cap, blocks, 256, ins_p, outs_p, n,
                      stream) != 0, (is_double, cap, blocks)
        assert fn(0, 1, 0, -(-n // 256), 256, ins_p, outs_p, n, stream) == 0
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(outs, want))


def test_seeded_step_launches_the_seeded_variants(cuda, monkeypatch):
    """With ``OBGC_X0_SEED=1`` the production step launches the seeded
    dual instance and the seeded surface pair, the default call the
    constants kernel and the seeded dual instance on its constants, and
    the fused step's K2 and precompute_env's stand-in stay unseeded."""
    monkeypatch.setenv("OBGC_X0_SEED", "1")
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=10, ncol=300, seed=8,
                                           device=cuda)

    def counts():
        return (co3_terms_dual_coeffs.launches,
                co3_terms_dual_coeffs.seeded_launches,
                carbonate_coeffs_sat.launches,
                solve_htotal_brackets.launches,
                solve_htotal_brackets.seeded_launches,
                cs._launch_solve.launches)

    c0 = counts()
    env = precompute_env(grid, forcing, params.bgc)
    s, _ = step(state, grid, forcing, params, 3600.0, compute_diags=False,
                env=env)
    s, _ = step(s, grid, forcing, params, 3600.0)
    s, _ = step(s, grid, forcing, params, 3600.0, compute_diags=False,
                env=env, interior_impl="fused")
    torch.cuda.synchronize()
    assert torch.isfinite(s.bgc.tracers).all()
    assert tuple(b - a for a, b in zip(c0, counts())) == (0, 2, 1, 1, 3, 1)


def _k1_counts():
    """K1's launch counts: the dual instance, the constants kernel, the
    bracket-in instance, then the seeded dual and bracket-in instances."""
    return (co3_terms_dual_coeffs.launches, carbonate_coeffs_sat.launches,
            solve_htotal_brackets.launches,
            co3_terms_dual_coeffs.seeded_launches,
            solve_htotal_brackets.seeded_launches)


def test_host_api_on_the_card(cuda):
    """The host API's entry points run on the card by default:
    BGC_SourceSink launches the constants kernel and the dual K1 once
    each, BGC_SurfaceFluxes the bracket-in instance once, DMS and MACROS
    no kernel; the BGC pair's results, cold and warm, are bitwise those of
    ``bgc_source_sink`` and ``bgc_surface_fluxes`` on the same world on
    the card (the API adds only exact transposes)."""
    import numpy as np

    from ocean_bgc_tpu_torch import host_api
    from ocean_bgc_tpu_torch.utils.bridge import host_arguments

    p = ModelParams().bgc
    state, grid, forcing = synthetic_world(nlev=10, ncol=300, seed=8,
                                           ragged=True, device=cuda)
    kw = host_arguments(state, grid, forcing)
    b = state.bgc
    ph, ph_alt, sph, sph_alt = (b.ph_prev_3d, b.ph_prev_alt_3d,
                                b.surface_ph, b.surface_ph_alt)
    warm, swarm = {}, {}
    for _ in range(2):        # cold, then warm from the returned pH
        c0 = _k1_counts()
        got = host_api.BGC_SourceSink(**kw["BGC_SourceSink"], **warm)
        c1 = _k1_counts()
        sf = host_api.BGC_SurfaceFluxes(**kw["BGC_SurfaceFluxes"], **swarm)
        c2 = _k1_counts()
        assert [y - x for x, y in zip(c0, c1)] == [1, 1, 0, 0, 0]
        assert [y - x for x, y in zip(c1, c2)] == [0, 0, 1, 0, 0]
        want = bgc_source_sink(b.tracers, grid, forcing, ph, ph_alt, p,
                               compute_diags=True)
        assert np.array_equal(got["BGC_tendencies"],
                              want.tendencies.cpu().numpy().transpose(2, 0, 1))
        assert np.array_equal(got["PH_PREV_3D"], want.ph_prev_3d.cpu().T)
        assert np.array_equal(got["PH_PREV_ALT_CO2_3D"],
                              want.ph_prev_alt_3d.cpu().T)
        assert got["diags"].keys() == want.diags.keys()
        for k, v in want.diags.items():
            assert np.array_equal(got["diags"][k], v.cpu().numpy()), k
        swant = bgc_surface_fluxes(b.tracers, forcing, sph, sph_alt, p)
        assert np.array_equal(sf["netFlux"], swant.net_flux.cpu().numpy().T)
        assert np.array_equal(sf["surface_pH"], swant.surface_ph.cpu())
        for k, v in swant.diags.items():
            assert np.array_equal(sf["diags"][k], v.cpu().numpy()), k
        warm = dict(PH_PREV_3D=got["PH_PREV_3D"],
                    PH_PREV_ALT_CO2_3D=got["PH_PREV_ALT_CO2_3D"])
        ph, ph_alt = want.ph_prev_3d, want.ph_prev_alt_3d
        sph, sph_alt = swant.surface_ph, swant.surface_ph_alt
        swarm = dict(surface_pH=sf["surface_pH"],
                     surface_pH_alt_co2=sf["surface_pH_alt_co2"])
    c0 = _k1_counts()
    for name in ("DMS_SourceSink", "DMS_SurfaceFluxes", "MACROS_SourceSink"):
        out = getattr(host_api, name)(**kw[name])
        assert all(np.isfinite(v).all() for v in out.values()
                   if isinstance(v, np.ndarray)), name
    assert _k1_counts() == c0


def test_env_guard_on_the_card(cuda, monkeypatch):
    """With the guard off a production step on the env cache makes no
    host synchronisation; with ``OBGC_CHECK_ENV=1`` a fresh cache passes
    and a stale one raises."""
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=10, ncol=300, seed=8,
                                           ragged=True, device=cuda)
    env = precompute_env(grid, forcing, params.bgc)
    monkeypatch.delenv("OBGC_CHECK_ENV", raising=False)
    step(state, grid, forcing, params, 3600.0, compute_diags=False, env=env)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state, grid, forcing, params, 3600.0, compute_diags=False,
             env=env)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    monkeypatch.setenv("OBGC_CHECK_ENV", "1")
    s, _ = step(state, grid, forcing, params, 3600.0, compute_diags=False,
                env=env)
    assert torch.isfinite(s.bgc.tracers).all()
    stale = dataclasses.replace(
        forcing, salinity=forcing.salinity + 0.1)
    with pytest.raises(ValueError, match="stale EnvCache"):
        step(state, grid, stale, params, 3600.0, compute_diags=False,
             env=env)


def test_solver_health_on_the_constants_kernel(cuda):
    """``solver_health`` on CUDA tensors takes its constants from the
    constants kernel (one launch) and agrees with the same call on the
    CPU; converged warm starts give steps below the solver's tolerance."""
    from ocean_bgc_tpu_torch.utils.debug import solver_health

    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=10, ncol=300, seed=8,
                                           ragged=True, device=cuda)
    s, _ = step(state, grid, forcing, params, 3600.0, compute_diags=False)
    n = carbonate_coeffs_sat.launches
    got = solver_health(s, grid, forcing)
    assert carbonate_coeffs_sat.launches == n + 1
    cpu = [dataclasses.replace(x, **{
        f.name: getattr(x, f.name).cpu() for f in dataclasses.fields(x)
        if isinstance(getattr(x, f.name), torch.Tensor)})
        for x in (s.bgc, grid, forcing)]
    want = solver_health(dataclasses.replace(s, bgc=cpu[0]), *cpu[1:])
    assert got["cells_checked"] == want["cells_checked"] > 0
    assert got["max_newton_step_h"] < 1e-9
    assert abs(got["mean_newton_step_h"] - want["mean_newton_step_h"]) <= 1e-12


def _k1_route_grads(cuda, dtype, impl):
    """Gradients through every K1 route a backward sweep passes, on the
    world after one step (warm pH): the dual instance on the env cache's
    constants, the constants route (constants kernel, then the dual
    instance), the surface pair (bracket-in instance) and the env cache's
    stand-in, each from leaves; and whether every output has a grad_fn."""
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=12, ncol=700, seed=4,
                                           ragged=True, dtype=dtype,
                                           device=cuda)
    env = precompute_env(grid, forcing, params.bgc)
    warm, _ = step(state, grid, forcing, params, 3600.0,
                   compute_diags=False, env=env)
    b = warm.bgc
    out, attached = {}, True
    args = carbonate_inputs(b.tracers, grid, forcing, b.ph_prev_3d,
                            b.ph_prev_alt_3d, env)
    lv = [t.clone().requires_grad_() for t in (*args[:4], *args[-1])]
    a, alt = co3_terms_dual_coeffs(*lv[:4], *args[4:6],
                                   tcarb.CarbCoeffs(*lv[4:]), impl=impl)
    attached &= all(o.grad_fn is not None for o in (*a, *alt))
    out["dual"] = torch.autograd.grad(sum(o.sum() for o in (*a, *alt)), lv,
                                      allow_unused=True)
    args = carbonate_inputs(b.tracers, grid, forcing, b.ph_prev_3d,
                            b.ph_prev_alt_3d)
    lv = [t.clone().requires_grad_() for t in args[:7]]
    coeffs, a, alt, sat = dual_sat_and_coeffs(*lv, *args[7:], with_sat=True,
                                              seed=False, impl=impl)
    attached &= all(o.grad_fn is not None
                    for o in (*coeffs, *a, *alt, *sat))
    out["constants"] = torch.autograd.grad(
        sum(o.sum() for o in (*a, *alt, *sat)), lv, allow_unused=True)
    tr = b.tracers.clone().requires_grad_()
    sf = bgc_surface_fluxes(tr, forcing, b.surface_ph, b.surface_ph_alt,
                            params.bgc, carbonate_impl=impl)
    attached &= sf.net_flux.grad_fn is not None
    out["surface"] = torch.autograd.grad(sf.net_flux.sum(), tr)
    temp = forcing.potential_temperature.clone().requires_grad_()
    from ocean_bgc_tpu_torch.ops.carbonate import carbonate_coeffs
    cf = carbonate_coeffs(grid.cell_center_depth * 0.01, temp,
                          forcing.salinity, True)
    n = cf.k1.shape
    h = solve_htotal_brackets(
        cf, torch.full(n, 2000.0 * 1e-3 / 1.026, dtype=dtype, device=cuda),
        torch.full(n, 2300.0 * 1e-3 / 1.026, dtype=dtype, device=cuda),
        torch.zeros(n, dtype=dtype, device=cuda),
        torch.zeros(n, dtype=dtype, device=cuda),
        torch.full(n, 1e-9, dtype=dtype, device=cuda),
        torch.full(n, 1e-6, dtype=dtype, device=cuda), impl=impl)
    attached &= h.grad_fn is not None
    out["stand-in"] = torch.autograd.grad(h.sum(), temp)
    return out, attached


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k1_routes_backward_on_the_kernel_match_plain_routes(cuda, dtype):
    """Every K1 route is differentiable on the card: no kernel output is
    detached while its inputs require grad, and each route's gradient on
    the kernel equals its plain route's (the forwards are bitwise equal
    and the routes share their backward) within 1e-12 of the largest."""
    c0 = _k1_counts()
    got, attached = _k1_route_grads(cuda, dtype, "kernel")
    c1 = _k1_counts()
    want, attached_plain = _k1_route_grads(cuda, dtype, "torch")
    assert attached and attached_plain
    assert c1[0] > c0[0] and c1[1] > c0[1] and c1[2] > c0[2]
    for route in got:
        for g, w in zip(got[route], want[route]):
            if w is None:
                assert g is None, route
                continue
            assert torch.isfinite(g).all(), route
            scale = w.abs().max()
            assert (g - w).abs().max() <= 1e-12 * scale, route


def test_kernels_refuse_grad_without_a_backward(cuda):
    """A K1 launch outside its autograd Function, and K2, refuse inputs
    that require grad instead of detaching them."""
    from ocean_bgc_tpu_torch.ops import cuda_carbonate as cc
    x = torch.ones(64, dtype=torch.float64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        cc._launch((x,) * 21, x.dtype)
    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=6, ncol=64, seed=4,
                                           device=cuda)
    tr = state.bgc.tracers.clone().requires_grad_()
    with pytest.raises(ValueError, match="forward-only"):
        fused_interior_step(tr, grid, forcing, state.bgc.ph_prev_3d,
                            state.bgc.ph_prev_alt_3d, params.bgc)


def test_adjoint_sweep_on_the_card(cuda):
    """parameter_sensitivities on the card: the kernel route equals the
    plain route within 1e-12, and the sweep launches the bracket-in
    instance 1 + 2 * steps times and the dual instance 2 * steps (the
    forward's and remat's recompute)."""
    from ocean_bgc_tpu_torch.models.adjoint import parameter_sensitivities
    from ocean_bgc_tpu_torch.state import BGCTracers as BT

    params = ModelParams()
    state, grid, forcing = synthetic_world(nlev=12, ncol=256, seed=4,
                                           ragged=True, device=cuda)
    paths = ("bgc.parm_kappa_nitrif", "bgc.autotrophs[0].PCref")

    def functional(f):
        return (f.bgc.tracers[:, BT.NO3].square().mean()
                + f.bgc.tracers[0, BT.DIC].mean()
                + f.bgc.ph_prev_3d.mean())

    c0 = _k1_counts()
    got = parameter_sensitivities(params, paths, state, grid, forcing,
                                  3600.0, 3, functional)
    c1 = _k1_counts()
    want = parameter_sensitivities(params, paths, state, grid, forcing,
                                   3600.0, 3, functional,
                                   carbonate_impl="torch")
    assert [y - x for x, y in zip(c0, c1)] == [6, 0, 7, 0, 0]
    for p in paths:
        assert abs(got[p] - want[p]) <= 1e-12 * abs(want[p]), p
