"""HMC sampler: statistical correctness on known targets + machinery tests."""

import numpy as np
import jax
import jax.numpy as jnp

from hmcmt2d.sampler import hmc as H


def gaussian_potential_vg(mu, var):
    """Batched potential for independent Gaussians: U = 0.5 sum (m-mu)^2/var."""
    mu = jnp.asarray(mu)
    var = jnp.asarray(var)

    def single(m, m_ref):
        u = 0.5 * jnp.sum((m - mu) ** 2 / var)
        pred = jnp.zeros((1,))
        return u, (u, jnp.zeros(()), pred)

    def vg(m, m_ref):
        (U, aux), g = jax.vmap(jax.value_and_grad(single, has_aux=True))(m, m_ref)
        return (U, aux), g

    return vg


def test_gaussian_target_moments():
    """Sample a 4-D Gaussian with 8 chains; mean/std must match within MC error."""
    mu = np.array([1.0, -2.0, 0.5, 3.0])
    sd = np.array([0.5, 1.0, 2.0, 0.25])
    vg = gaussian_potential_vg(mu, sd**2)
    opts = H.HMCOptions(dt=0.25, steps_lo=6, steps_hi=10,
                        log_sig_lo=-50.0, log_sig_hi=50.0, reg_param=0.0)
    C, P, S = 8, 4, 1500
    mass = H.identity_mass(P)
    m0 = jnp.zeros((C, P))
    res = jax.jit(lambda k: H.run_hmc(vg, opts, mass, m0, m0, S, k))(
        jax.random.PRNGKey(0))
    accept_rate = float(jnp.mean(res.accepts))
    assert 0.3 < accept_rate < 1.0, accept_rate
    samples = np.asarray(res.models[300:]).reshape(-1, P)  # burn-in 300
    n_eff_floor = 200  # conservative
    tol = 4.0 / np.sqrt(n_eff_floor)
    z = np.abs(samples.mean(0) - mu) / sd
    assert np.all(z < tol), (samples.mean(0), mu, z)
    np.testing.assert_allclose(samples.std(0), sd, rtol=0.25)


def test_reflection_keeps_samples_in_bounds():
    mu = np.zeros(3)
    vg = gaussian_potential_vg(mu, np.ones(3))
    lo, hi = -0.5, 0.8
    opts = H.HMCOptions(dt=0.3, steps_lo=4, steps_hi=6,
                        log_sig_lo=lo, log_sig_hi=hi, reg_param=0.0)
    mass = H.identity_mass(3)
    m0 = jnp.zeros((4, 3))
    res = H.run_hmc(vg, opts, mass, m0, m0, 200, jax.random.PRNGKey(1))
    s = np.asarray(res.models)
    assert s.min() >= lo - 1e-6 and s.max() <= hi + 1e-6
    # truncated distribution still explores the full interval
    assert s.max() > 0.6 * hi and s.min() < 0.6 * lo


def test_reflect_bounds_matches_iterative():
    """Closed-form fold == the reference's loop (checkParameterBound!)."""
    rng = np.random.default_rng(0)
    lo, hi = -2.0, 1.0
    m = rng.uniform(-12, 12, size=200)
    p = rng.standard_normal(200)

    def iterative(mk, pk):
        it = 0
        while not (lo <= mk <= hi):
            if mk < lo:
                mk = 2 * lo - mk
                pk = -pk
            if mk > hi:
                mk = 2 * hi - mk
                pk = -pk
            it += 1
            assert it < 1000
        return mk, pk

    want = np.array([iterative(mk, pk) for mk, pk in zip(m, p)])
    got_m, got_p = H.reflect_bounds(jnp.asarray(m), jnp.asarray(p), lo, hi)
    np.testing.assert_allclose(np.asarray(got_m), want[:, 0], atol=1e-12)
    np.testing.assert_allclose(np.asarray(got_p), want[:, 1], atol=1e-12)


def test_dense_mass_matrix():
    """Non-diagonal mass: momentum covariance must equal M = Wm."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((3, 3))
    Wm = A @ A.T + 3 * np.eye(3)
    mass = H.dense_mass(Wm)
    keys = jax.random.split(jax.random.PRNGKey(3), 4000)
    draws = np.asarray(jax.vmap(lambda k: mass.draw(k, (3,)))(keys))
    cov = np.cov(draws.T)
    # clipping at 2.5 shrinks the covariance slightly (~2%)
    np.testing.assert_allclose(cov, Wm, rtol=0.15, atol=0.1 * np.abs(Wm).max())
    # kinetic gradient consistency: d/dp (0.5 p' Minv p) = Minv p
    p = jnp.asarray(rng.standard_normal(3))
    g = jax.grad(lambda pp: mass.kinetic(pp))(p)
    np.testing.assert_allclose(np.asarray(g), np.asarray(mass.apply_inv(p)), rtol=1e-10)


def test_random_homogeneous_start():
    m0_file = np.log(np.full(10, 1.0 / 100.0))  # 100 Ohm.m
    starts = np.asarray(H.random_homogeneous_start(jax.random.PRNGKey(4), m0_file, 64))
    rhos = 1.0 / np.exp(starts[:, 0])
    np.testing.assert_allclose(rhos, np.round(rhos), atol=1e-9)  # integer rho
    assert rhos.min() >= 50 - 1e-9 and rhos.max() <= 150 + 1e-9
    assert len(np.unique(rhos)) > 10
    # each chain's model is homogeneous
    assert np.all(starts == starts[:, :1])


def test_warmup_adaptation_gaussian():
    """Dual-averaging must hit the target accept rate and the mass must learn
    the per-dimension posterior scales on an anisotropic Gaussian."""
    from hmcmt2d.sampler import adapt as A

    sd = np.array([0.1, 1.0, 10.0, 0.5])
    vg = gaussian_potential_vg(np.zeros(4), sd**2)
    # deliberately bad initial dt; identity mass is badly scaled for sd=10
    opts = H.HMCOptions(dt=1.5, steps_lo=4, steps_hi=8,
                        log_sig_lo=-1e6, log_sig_hi=1e6, reg_param=0.0)
    C = 8
    m0 = jnp.zeros((C, 4))
    wopts = A.WarmupOptions(target_accept=0.8)
    wres, state, mass, info = jax.jit(
        lambda k: A.warmup(vg, opts, m0, m0, 400, k, wopts))(jax.random.PRNGKey(0))

    # mass learned: inv_m approximates the marginal variances (ordering must
    # be right even if magnitudes are rough)
    inv_m = np.asarray(info.inv_m)
    assert inv_m.shape == (4,)
    np.testing.assert_allclose(inv_m, sd**2, rtol=0.6)

    # adapted step size produces near-target acceptance in a fixed-kernel run
    opts2 = H.HMCOptions(dt=float(info.dt), steps_lo=4, steps_hi=8,
                         log_sig_lo=-1e6, log_sig_hi=1e6, reg_param=0.0)
    res = jax.jit(lambda k: H.run_hmc(vg, opts2, mass, state.m, m0, 300, k,
                                      init_state=state))(jax.random.PRNGKey(1))
    rate = float(np.asarray(res.accepts).mean())
    assert 0.6 < rate <= 1.0, rate
    # and samples still have the right scales
    s = np.asarray(res.models).reshape(-1, 4)
    np.testing.assert_allclose(s.std(0), sd, rtol=0.35)


def test_warmup_start_stats_is_iteration_zero():
    """Regression: the warmup result's start row
    must report the PRE-warmup state — the reference's "Starting status" is
    the status at iteration 0 (HMCSampler.jl:113-115,810-827) — not the
    post-warmup misfit."""
    from hmcmt2d.sampler import adapt as A

    mu = np.array([3.0, -4.0])
    vg = gaussian_potential_vg(mu, np.ones(2))
    opts = H.HMCOptions(dt=0.2, steps_lo=4, steps_hi=6,
                        log_sig_lo=-1e6, log_sig_hi=1e6, reg_param=0.0)
    m0 = jnp.zeros((3, 2))
    wres, state, mass, info = jax.jit(
        lambda k: A.warmup(vg, opts, m0, m0, 150, k))(jax.random.PRNGKey(0))
    (_, (mis0, _, _)), _ = vg(m0, m0)
    np.testing.assert_allclose(np.asarray(wres.start_stats[:, 0]),
                               np.asarray(mis0), rtol=1e-6)
    # warmup actually moved the chains toward the target, so the bug (start
    # row == post-warmup misfit) would fail the check above by a wide margin
    assert (float(np.asarray(wres.stats)[-1, :, 0].mean())
            < 0.5 * float(np.asarray(mis0).mean()))


def test_window_schedule():
    from hmcmt2d.sampler import adapt as A

    w = A.WarmupOptions()
    ends = A.window_schedule(1000, w)
    idx = np.nonzero(ends)[0]
    assert len(idx) >= 3
    assert idx[0] + 1 >= 75           # after the init buffer
    assert idx[-1] + 1 <= 1000 - 50   # before the term buffer
    # short warmups still produce at least one window end
    ends_s = A.window_schedule(60, w)
    assert ends_s.sum() >= 1


def test_nonfinite_gradient_proposal_never_accepted():
    """A finite-energy proposal with a non-finite gradient must be rejected
    (round-4 COPROD2 warmup collapse: one accepted NaN-grad state poisons
    every later trajectory and dual averaging death-spirals)."""
    import jax

    P = 4

    def vg(m, m_ref, fac=None):
        U = 0.5 * jnp.sum(m * m, axis=-1)
        # gradient goes NaN in the half-space m[...,0] > 0.3 while the
        # potential stays finite
        g = jnp.where((m[..., :1] > 0.3), jnp.nan, m)
        pred = jnp.zeros(m.shape[:-1] + (1,))
        return (U, (U, jnp.zeros_like(U), pred)), g

    opts = H.HMCOptions(dt=0.4, steps_lo=2, steps_hi=3,
                        log_sig_lo=-50.0, log_sig_hi=50.0, reg_param=1.0)
    mass = H.identity_mass(P, jnp.float64)
    m0 = jnp.full((3, P), -1.0, jnp.float64)
    res = jax.jit(lambda k: H.run_hmc(vg, opts, mass, m0, m0, 60, k,
                                      sample_dtype=jnp.float64))(
        jax.random.PRNGKey(0))
    final = res.final
    # the carried state stays finite forever
    assert bool(jnp.isfinite(final.m).all())
    assert bool(jnp.isfinite(final.grad).all())
    models = np.asarray(res.models)
    assert np.isfinite(models).all()
    # chains keep moving (the dt=0.4 kernel accepts plenty in the finite
    # region) and never enter the NaN half-space
    assert float(np.asarray(res.accepts).mean()) > 0.2
    assert models[..., 0].max() <= 0.3 + 2 * 0.4 * 3  # bounded excursions


def test_median_alpha_pool_survives_stuck_chain():
    """Median pooling of the warmup acceptance statistic must keep adapting
    when a minority chain is pinned at alpha=0 (solver-accuracy cliff,
    COPROD2 round 4); mean pooling death-spirals dt instead."""
    import dataclasses

    import jax

    from hmcmt2d.sampler import adapt as A

    P, C = 3, 6
    m0 = jnp.zeros((C, P), jnp.float64)

    def vg(m, m_ref, fac=None):
        U = 0.5 * jnp.sum(m * m, axis=-1)
        # chains 0 and 1 sit on a cliff: ANY move costs +1e6 potential
        # (2 of 6 stuck caps the pooled mean alpha at ~0.67 < target 0.8,
        # which is the death-spiral regime; 1 stuck chain would survive)
        moved = jnp.sum((m - m_ref) ** 2, axis=-1) > 1e-20
        cliff = jnp.where(jnp.arange(m.shape[0]) < 2, 1e6, 0.0)
        U = U + jnp.where(moved, cliff, 0.0)
        g = m
        pred = jnp.zeros(m.shape[:-1] + (1,))
        return (U, (U, jnp.zeros_like(U), pred)), g

    opts = H.HMCOptions(dt=0.5, steps_lo=2, steps_hi=3,
                        log_sig_lo=-50.0, log_sig_hi=50.0, reg_param=1.0)

    def run(pool):
        w = A.WarmupOptions(adapt_mass=False, alpha_pool=pool)
        _res, _st, _mass, info = jax.jit(lambda k: A.warmup(
            vg, opts, m0, m0, 120, k, w))(jax.random.PRNGKey(0))
        return float(info.dt)

    dt_median = run("median")
    dt_mean = run("mean")
    assert dt_median > 0.05, dt_median           # healthy adaptation
    assert dt_mean < dt_median / 50, (dt_mean, dt_median)  # the spiral


def test_fixed_mass_warmup_segmentation_bit_exact():
    """The dense-metric dt re-adaptation must be segmentation-invariant
    (the driver runs it as checkpoint-sized device programs)."""
    import dataclasses

    import jax

    from hmcmt2d.sampler import adapt as A

    P, C = 4, 3
    rng = np.random.default_rng(5)
    Q = np.linalg.qr(rng.standard_normal((P, P)))[0]
    prec = Q @ np.diag([1.0, 3.0, 10.0, 30.0]) @ Q.T

    def vg(m, m_ref, fac=None):
        r = m - m_ref
        g = jnp.einsum("ab,...b->...a", jnp.asarray(prec), r)
        U = 0.5 * jnp.sum(r * g, axis=-1)
        pred = jnp.zeros(m.shape[:-1] + (1,))
        return (U, (U, jnp.zeros_like(U), pred)), g

    mass = H.dense_mass(prec)
    opts = H.HMCOptions(dt=0.3, steps_lo=2, steps_hi=3,
                        log_sig_lo=-50.0, log_sig_hi=50.0, reg_param=1.0)
    w = A.WarmupOptions(adapt_mass=False)
    m0 = jnp.zeros((C, P), jnp.float64)
    key = jax.random.PRNGKey(9)
    n = 12

    def one_scan():
        carry0 = A.warmup_carry_init(vg, opts, m0, m0)
        carry, outs = A.warmup_scan(vg, opts, m0, carry0,
                                    A.warmup_keys(key, 0, n),
                                    jnp.zeros(n, bool), w, fixed_mass=mass)
        return carry, outs

    def segmented(seg):
        carry = A.warmup_carry_init(vg, opts, m0, m0)
        outs = []
        done = 0
        while done < n:
            carry, o = A.warmup_scan(vg, opts, m0, carry,
                                     A.warmup_keys(key, done, seg),
                                     jnp.zeros(seg, bool), w, fixed_mass=mass)
            outs.append(o)
            done += seg
        cat = lambda i: jnp.concatenate([o[i] for o in outs], axis=0)
        return carry, tuple(cat(i) for i in range(5))

    c1, o1 = jax.jit(one_scan)()
    c2, o2 = segmented(4)
    np.testing.assert_array_equal(np.asarray(o1[0]), np.asarray(o2[0]))
    np.testing.assert_array_equal(np.asarray(c1.state.m), np.asarray(c2.state.m))
    np.testing.assert_array_equal(np.asarray(c1.da.log_eps_avg),
                                  np.asarray(c2.da.log_eps_avg))
