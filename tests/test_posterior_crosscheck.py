"""Posterior cross-validation: independent numpy HMC vs the scan sampler.

The "posterior match" bar needs a measurement behind it.  Here the tiny MT
inverse problem (real TE+TM physics,
realistic noisy observations) is sampled by two INDEPENDENT implementations
of the same kernel:

* the production `run_hmc` (lax.scan, batched chains, folded keys,
  closed-form reflection), and
* a plain numpy loop written directly from the reference's algorithm
  (proposeLeapfrog / runHMCSampler semantics: truncated-normal momenta,
  random integer L, position-step clip, iterative boundary reflection,
  `dH>0 or u<exp(dH)` accept), using numpy RNG.

Both target the same potential (the separately-oracle-validated forward
model), so agreement of posterior moments within Monte-Carlo error validates
the sampler machinery end-to-end.
"""

import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp

from hmcmt2d.sampler import diagnostics as D
from hmcmt2d.sampler import hmc as H
from hmcmt2d.sampler.driver import make_potential_vg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_realistic():
    spec = importlib.util.spec_from_file_location(
        "graft", os.path.join(REPO, "__graft_entry__.py"))
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)
    problem, m0 = g._flagship_problem(tiny=True)
    # observations from the start model + 3% noise -> a well-posed posterior
    predict = jax.jit(lambda m: problem.fwd.predict(problem.sigma2d(m)))
    obs = np.asarray(predict(jnp.asarray(m0, jnp.float64)))
    rng = np.random.default_rng(7)
    noise = rng.standard_normal(len(obs)) + 1j * rng.standard_normal(len(obs))
    obs = obs * (1 + 0.03 * noise / np.sqrt(2))
    err = 0.03 * np.abs(obs)
    problem = problem.__class__(fwd=problem.fwd, obs=obs, weights=1.0 / err,
                                active_idx=problem.active_idx,
                                bg_flat=problem.bg_flat)
    return problem, np.asarray(m0)


def _reflect_np(m, p, lo, hi):
    """The reference's iterative reflection loop (checkParameterBound!)."""
    for k in range(len(m)):
        it = 0
        while not (lo <= m[k] <= hi):
            if m[k] < lo:
                m[k] = 2 * lo - m[k]
                p[k] = -p[k]
            if m[k] > hi:
                m[k] = 2 * hi - m[k]
                p[k] = -p[k]
            it += 1
            assert it < 1000
    return m, p


def _numpy_hmc(vg1, m0, n, rng, opts: H.HMCOptions, dt):
    """Plain-loop HMC with the production kernel's exact semantics."""
    m = m0.copy()
    (U, _), g = vg1(m)
    samples = np.empty((n, len(m)))
    n_acc = 0
    for it in range(n):
        p = np.clip(rng.standard_normal(len(m)), -2.5, 2.5)
        h0 = U + 0.5 * p @ p
        L = int(rng.integers(opts.steps_lo, opts.steps_hi + 1))
        mm = m.copy()
        pp = p - 0.5 * dt * g
        gg = g
        for k in range(L):
            dm = dt * pp
            s = min(1.0, opts.max_step_size / np.max(np.abs(dm)))
            mm = mm + dm * s
            mm, pp = _reflect_np(mm, pp, opts.log_sig_lo, opts.log_sig_hi)
            (Un, _), gg = vg1(mm)
            pp = pp - (0.5 * dt if k == L - 1 else dt) * gg
        h1 = Un + 0.5 * pp @ pp
        dh = h0 - h1
        if dh > 0 or rng.random() < np.exp(dh):
            m, U, g = mm, Un, gg
            n_acc += 1
        samples[it] = m
    return samples, n_acc / n


def test_independent_numpy_hmc_matches_scan_sampler():
    problem, m0 = _tiny_realistic()
    vg = make_potential_vg(problem, 1.0)
    opts = H.HMCOptions(dt=0.0, steps_lo=3, steps_hi=5,
                        log_sig_lo=float(np.log(1e-5)),
                        log_sig_hi=float(np.log(10.0)), reg_param=1.0)

    # shared fixed step size from a short identity-mass warmup (the numpy
    # loop runs a unit-mass kernel, so mass adaptation is disabled)
    import dataclasses

    from hmcmt2d.sampler import adapt as A

    C = 6
    m_start = jnp.broadcast_to(jnp.asarray(m0, jnp.float64), (C, len(m0)))
    wres, wstate, wmass, winfo = jax.jit(lambda k: A.warmup(
        vg, dataclasses.replace(opts, dt=0.05), m_start, m_start, 150, k,
        A.WarmupOptions(adapt_mass=False)))(jax.random.PRNGKey(0))
    dt = float(winfo.dt)
    assert 0 < dt < 10

    opts_run = dataclasses.replace(opts, dt=dt)
    mass = H.identity_mass(len(m0), jnp.float64)
    S = 500
    res = jax.jit(lambda k: H.run_hmc(vg, opts_run, mass, wstate.m, m_start,
                                      S, k, sample_dtype=jnp.float64))(
        jax.random.PRNGKey(1))
    jax_samples = np.asarray(res.models[S // 5:]).reshape(-1, len(m0))
    jax_rate = float(np.asarray(res.accepts).mean())

    # independent numpy implementation, started from a warmed-up state
    vg1 = jax.jit(lambda m: vg(m[None], jnp.asarray(m_start[:1])))

    def vg_np(m):
        (U, aux), g = vg1(jnp.asarray(m))
        return (float(U[0]), None), np.asarray(g[0], np.float64)

    # two independent numpy chains, long enough for a per-parameter ESS
    # estimate (round 3 used one 400-draw chain with a crude flat ESS floor,
    # which deterministically inflated the extreme z of 96 comparisons to
    # 8.9; with per-parameter Vehtari ESS over longer chains the same
    # samplers agree at max z ~ 3.9 and sd ratio ~ 1.0 — measured, no bias)
    np_chains, np_rates = [], []
    for i, seed in enumerate((3, 13)):
        rng = np.random.default_rng(seed)
        m_init = np.asarray(wstate.m[i], np.float64)
        s, r = _numpy_hmc(vg_np, m_init, 800, rng, opts, dt)
        np_chains.append(s[160:])
        np_rates.append(r)
    np_stack = np.stack(np_chains, axis=1)            # (640, 2, P)
    np_samples = np_stack.reshape(-1, len(m0))

    assert 0.4 < jax_rate <= 1.0, jax_rate
    assert all(0.4 < r <= 1.0 for r in np_rates), np_rates

    # per-parameter effective sample sizes -> MC standard errors
    ess_j = np.maximum(np.asarray(D.ess(res.models[S // 5:])), 4.0)
    ess_n = np.maximum(np.asarray(D.ess(np_stack)), 4.0)
    mu_j, sd_j = jax_samples.mean(0), jax_samples.std(0)
    mu_n, sd_n = np_samples.mean(0), np_samples.std(0)

    se = np.sqrt(sd_j**2 / ess_j + sd_n**2 / ess_n)
    z = np.abs(mu_j - mu_n) / np.maximum(se, 1e-12)
    # 96 comparisons: expected extreme of 96 standard normals is ~2.8; allow
    # headroom for ESS-estimate noise on short autocorrelated chains
    assert np.median(z) < 2.0, (np.median(z), z.max())
    assert z.max() < 6.0, z.max()
    # posterior scales agree
    ratio = sd_j / np.maximum(sd_n, 1e-12)
    assert 0.5 < np.median(ratio) < 2.0, np.median(ratio)
