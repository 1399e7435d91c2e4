"""The opt-in pH-solver seed (``OBGC_X0_SEED=1``, K1's seeded variants) in
the port, held against the JAX package: the seeded plain solver, the
seeded interior instances against the Pallas kernel in interpret mode, one
seeded step, and the port's seeded trajectory inside the perturbation
envelope of tests/test_x0_seed_trajectory.py.  Inputs are made with numpy
from a seed and go through both packages."""

import dataclasses

import numpy as np
import torch

import ocean_bgc_tpu  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from ocean_bgc_tpu.models.coupled import step as jax_step
from ocean_bgc_tpu.ops import carbonate as jcarb
from ocean_bgc_tpu.ops.bgc import precompute_env as jax_precompute_env
from ocean_bgc_tpu.ops.pallas_carbonate import co3_terms_dual_sat_pallas
from ocean_bgc_tpu.params import ModelParams as JaxModelParams
from ocean_bgc_tpu.utils.synthetic import synthetic_world as jax_world

from ocean_bgc_tpu_torch import constants as c
from ocean_bgc_tpu_torch.models.coupled import run, step
from ocean_bgc_tpu_torch.ops import carbonate as tcarb
from ocean_bgc_tpu_torch.ops.bgc import precompute_env
from ocean_bgc_tpu_torch.ops.cuda_carbonate import (
    co3_terms_dual_coeffs,
    co3_terms_dual_coeffs_torch,
    co3_terms_dual_sat,
    co3_terms_dual_sat_torch,
)
from ocean_bgc_tpu_torch.params import ModelParams
from ocean_bgc_tpu_torch.state import BGCTracers as T
from ocean_bgc_tpu_torch.utils.bridge import params_from_dict, world_from_numpy
from ocean_bgc_tpu_torch.utils.synthetic import synthetic_world

DT = 3600.0
XACC_F32 = 1e-5 * 1e-8


def _np(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return np.asarray(x)


def _lanes(seed, n):
    """n cells of random chemistry at depth, with the previous pH in three
    groups: cold (the 0 sentinel), warm (the root +/- 0.05) and off the
    warm window (the root +/- 0.5 > DEL_PH, so the bracket must grow
    before the seed is clamped into it)."""
    rng = np.random.default_rng(seed)
    w = dict(depth=rng.uniform(0.0, 5000.0, n), temp=rng.uniform(-1.8, 31.0, n),
             salt=rng.uniform(30.0, 40.0, n), dic=rng.uniform(1800.0, 2400.0, n),
             ta=rng.uniform(2000.0, 2500.0, n), pt=rng.uniform(0.0, 3.5, n),
             sit=rng.uniform(0.0, 150.0, n))
    cf = tcarb.carbonate_coeffs(*(torch.tensor(w[k]) for k in
                                  ("depth", "temp", "salt")), True)
    mass = tcarb._to_mass_units(*(torch.tensor(w[k]) for k in
                                  ("dic", "ta", "pt", "sit")))
    h = tcarb._solve_htotal_impl(cf, *mass, torch.full((n,), 1e-9),
                                 torch.full((n,), 1e-6))
    ph = -np.log10(h.numpy())
    third = n // 3
    ph[:third] = 0.0
    ph[third:2 * third] += rng.uniform(-0.05, 0.05, third)
    ph[2 * third:] += np.where(np.arange(n - 2 * third) % 2, 0.5, -0.5)
    return w, cf, mass, ph


def test_seeded_plain_solver_matches_jax_f64():
    """The seeded plain solver against JAX's ``_solve_htotal_impl(x0=...)``
    on the same H-space brackets and seeds (JAX's ``warm_brackets_h(
    with_seed=True)``, which the port's reproduces to an ulp of the pow):
    roots within 2 xacc, the same iteration counts.  The seed takes fewer
    iterations on warm lanes, the same on cold ones, and still converges
    on every lane whose bracket had to grow."""
    n = 300
    _, cf, mass, ph = _lanes(3, n)
    jx1, jx2, jx0 = jcarb.warm_brackets_h(jnp.asarray(ph), 6.0, 9.0,
                                          c.DEL_PH, with_seed=True)
    tx1, tx2, tx0 = tcarb.warm_brackets_h(torch.tensor(ph), 6.0, 9.0,
                                          c.DEL_PH, with_seed=True)
    for j, t in ((jx1, tx1), (jx2, tx2), (jx0, tx0)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=4e-16,
                                   atol=0)
    tx1, tx2, tx0 = (torch.tensor(np.asarray(x)) for x in (jx1, jx2, jx0))
    jcf = jcarb.CarbCoeffs(*(jnp.asarray(k.numpy()) for k in cf))
    jh, jit_, jconv = jcarb._solve_htotal_impl(
        jcf, *(jnp.asarray(m.numpy()) for m in mass), jx1, jx2, x0=jx0,
        with_stats=True)
    th, st = tcarb._solve_htotal_impl(cf, *mass, tx1, tx2, x0=tx0,
                                      with_stats=True)
    _, st0 = tcarb._solve_htotal_impl(cf, *mass, tx1, tx2, with_stats=True)
    assert np.abs(th.numpy() - np.asarray(jh)).max() <= 2 * c.XACC
    np.testing.assert_array_equal(st["iters"].numpy(), np.asarray(jit_))
    assert st["converged"].all() and np.asarray(jconv).all()
    third = n // 3
    assert torch.equal(st["iters"][:third], st0["iters"][:third])
    assert (st["iters"][third:2 * third].double().mean()
            < st0["iters"][third:2 * third].double().mean())
    assert (st["grows"][2 * third:] > 0).all()


def _pallas_cells(seed, nlev, ncol):
    """(nlev, ncol) cells for the interior instances, with the previous pH
    of each scenario in the three groups of :func:`_lanes` by column."""
    w, _, _, ph = _lanes(seed, nlev * ncol)
    w = {k: v.reshape(nlev, ncol) for k, v in w.items()}
    w["depth"] = np.sort(w["depth"], axis=0)
    ph = ph.reshape(ncol, nlev).T.copy()      # groups by column
    return w, ph, np.roll(ph, ncol // 3, axis=1)


def _h_close_f32(j_ph, t_ph):
    """|dH| <= 2 xacc_f32, plus the f32 pH output's own rounding (two
    ulps of pH, in H), as tests/test_torch_carbonate.py holds the
    unseeded instance."""
    hj = 10.0 ** -np.asarray(j_ph, np.float64)
    ht = 10.0 ** -t_ph.numpy().astype(np.float64)
    ulp = np.spacing(np.abs(np.asarray(j_ph))).astype(np.float64)
    return np.abs(hj - ht) <= 2 * XACC_F32 + 2 * np.log(10.0) * hj * ulp


def test_seeded_interior_instances_match_pallas_f32(monkeypatch):
    """K1's two seeded interior instances' plain versions against the
    Pallas kernel in interpret mode with ``OBGC_X0_SEED=1``, whose
    ``x0_of`` they repeat, on cold, warm and off-window cells.  Cached
    constants (the same constants on both sides): pH within 2 xacc_f32
    plus the f32 output's rounding, speciation within 1e-4 relative (the
    root's tolerance and f32 products).  Constants and saturation
    in-kernel: both sides evaluate the constants in f32 in their own
    order, so roots are held as tests/test_torch_diags.py holds the
    unseeded instance (also within 1e-3 of H; speciation and saturation
    within 1e-3 relative).  The seed reached both sides: each side's
    seeded roots differ from its unseeded ones."""
    nlev, ncol = 4, 96
    w, pa, pb = _pallas_cells(7, nlev, ncol)
    f32 = np.float32
    ins = {k: w[k].astype(f32) for k in w}
    press = np.broadcast_to((np.arange(nlev) > 0)[:, None], (nlev, ncol))

    def brackets(ph):
        ph = jnp.asarray(ph.astype(f32))
        warm = ph != 0.0
        return (jnp.where(warm, ph - c.DEL_PH, 6.0),
                jnp.where(warm, ph + c.DEL_PH, 9.0))

    jargs = (*(jnp.asarray(ins[k]) for k in ("depth", "temp", "salt", "dic",
                                             "ta", "pt", "sit")),
             *brackets(pa), *brackets(pb), jnp.asarray(press))
    tph = (torch.tensor(pa.astype(f32)), torch.tensor(pb.astype(f32)))
    ttr = [torch.tensor(ins[k]) for k in ("dic", "ta", "pt", "sit")]
    tts = [torch.tensor(ins[k]) for k in ("depth", "temp", "salt")]
    coeffs = tcarb.carbonate_coeffs(*tts, torch.tensor(press))
    jcf = jcarb.CarbCoeffs(*(jnp.asarray(k.numpy()) for k in coeffs))

    # the cached-constants instance
    j_plain, _, _ = co3_terms_dual_sat_pallas(*jargs, interpret=True,
                                              coeffs=jcf, with_sat=False)
    monkeypatch.setenv("OBGC_X0_SEED", "1")
    ja, jb, _ = co3_terms_dual_sat_pallas(*jargs, interpret=True,
                                          coeffs=jcf, with_sat=False)
    ta_, tb_ = co3_terms_dual_coeffs(*ttr, *tph, coeffs, seed=True)
    ua, _ = co3_terms_dual_coeffs_torch(*ttr, *tph, coeffs)
    assert not np.array_equal(np.asarray(ja[0]), np.asarray(j_plain[0]))
    assert not torch.equal(ta_[0], ua[0])
    for jo, to in ((ja, ta_), (jb, tb_)):
        assert _h_close_f32(jo[0], to[0]).all()
        for x, y in zip(jo[1:], to[1:]):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-4)

    # the coefficient-and-saturation instance
    ja, jb, jsat = co3_terms_dual_sat_pallas(*jargs, interpret=True,
                                             with_sat=True)
    ta_, tb_, tsat = co3_terms_dual_sat(*tts, *ttr, *tph, seed=True)
    ua, _, _ = co3_terms_dual_sat_torch(*tts, *ttr, *tph)
    assert not torch.equal(ta_[0], ua[0])
    for jo, to in ((ja, ta_), (jb, tb_)):
        hj = 10.0 ** -np.asarray(jo[0], np.float64)
        ht = 10.0 ** -to[0].numpy().astype(np.float64)
        assert (_h_close_f32(jo[0], to[0])
                | (np.abs(hj - ht) <= 1e-3 * hj)).all()
        for x, y in zip(jo[1:], to[1:]):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-3)
    for x, y in zip(jsat, tsat):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-3)


def test_seeded_step_matches_jax_f64(monkeypatch):
    """One seeded production step (env cache, diagnostics off) of a warm
    4 x 8 ragged world against JAX's seeded step (a freshly built
    ``jax.jit``: JAX reads the flag when it traces).  The interior seed
    takes two forms (the port's kernel-form ``x0_of``, JAX's XLA-form
    ``h_prev``), so the interior pH agrees to solver tolerance (2 xacc in
    H); the surface pair is seeded alike in both, so tracers are held to
    the 1e-13 of each tracer's scale of tests/test_torch_step.py.  The
    port's seeded step differs from its unseeded one."""
    js, jg, jf = jax_world(nlev=4, ncol=8, seed=21, ragged=True)
    jp = JaxModelParams()
    tp = params_from_dict(dataclasses.asdict(jp))
    ts, tg, tf = world_from_numpy(_np(js), _np(jg), _np(jf), device="cpu")
    tenv = precompute_env(tg, tf, tp.bgc)
    ts, _ = step(ts, tg, tf, tp, DT, compute_diags=False, env=tenv)
    warm = _np(ts)
    js = jax.tree.map(jnp.asarray, type(js)(
        bgc=type(js.bgc)(**warm["bgc"]), dms=warm["dms"],
        macros=warm["macros"]))

    monkeypatch.setenv("OBGC_X0_SEED", "1")
    jenv = jax_precompute_env(jg, jf, jp.bgc)
    jout = _np(jax.jit(lambda s: jax_step(s, jg, jf, jp, DT,
                                          compute_diags=False,
                                          env=jenv)[0])(js))
    seeded, _ = step(ts, tg, tf, tp, DT, compute_diags=False, env=tenv)
    monkeypatch.setenv("OBGC_X0_SEED", "0")
    plain, _ = step(ts, tg, tf, tp, DT, compute_diags=False, env=tenv)
    assert not torch.equal(seeded.bgc.surface_ph, plain.bgc.surface_ph)

    a, b = jout["bgc"]["tracers"], seeded.bgc.tracers.numpy()
    for i in range(T.CNT):
        scale = np.abs(a[:, i]).max() + 1e-30
        np.testing.assert_allclose(b[:, i] / scale, a[:, i] / scale, rtol=0,
                                   atol=1e-13, err_msg=f"tracer {i}")
    for name in ("ph_prev_3d", "ph_prev_alt_3d", "surface_ph",
                 "surface_ph_alt"):
        x, y = jout["bgc"][name], getattr(seeded.bgc, name).numpy()
        np.testing.assert_array_equal(x == 0.0, y == 0.0, err_msg=name)
        hx = np.where(x != 0.0, 10.0 ** -x, 0.0)
        hy = np.where(y != 0.0, 10.0 ** -y, 0.0)
        assert np.abs(hx - hy).max() <= 2 * c.XACC, name


def test_seeded_trajectory_within_perturbation_envelope(monkeypatch):
    """48 seeded steps against 48 unseeded ones of the port (12 x 16,
    ragged, seed 23), inside tests/test_x0_seed_trajectory.py's envelope:
    per tracer, 30 x the response to a 1e-11 relative kick of the initial
    tracers plus 1e-3 of the tracer's scale.  The seed changed the
    result (the flag reached the solves)."""
    state, grid, forcing = synthetic_world(nlev=12, ncol=16, seed=23,
                                           ragged=True, device="cpu")
    params = ModelParams()
    nsteps = 48

    def final(s, flag):
        monkeypatch.setenv("OBGC_X0_SEED", flag)
        return run(s, grid, forcing, params, DT, nsteps)[0].bgc.tracers

    want = final(state, "0")
    got = final(state, "1")
    pert = dataclasses.replace(state, bgc=dataclasses.replace(
        state.bgc, tracers=state.bgc.tracers * (1.0 + 1e-11)))
    yard = (final(pert, "0") - want).abs()
    assert torch.isfinite(got).all()
    assert not torch.equal(got, want), "the seed flag had no effect"
    for idx in range(T.CNT):
        mismatch = (got[:, idx] - want[:, idx]).abs().max().item()
        scale = want[:, idx].abs().max().item() + 1e-30
        bound = 30.0 * yard[:, idx].max().item() + 1e-3 * scale + 1e-12
        assert mismatch <= bound, (
            f"tracer {idx}: seeded mismatch {mismatch:.3e} exceeds the "
            f"envelope {bound:.3e}")
