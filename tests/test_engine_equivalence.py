"""GPU-default engine vs exact reference engine: POSTERIOR equivalence.

The GPU's default solve configuration (``default_config`` on the 'gpu'
backend: complex128 block Thomas with batched-LU inverses) and the CPU test
reference (complex128 block cyclic reduction) must sample the same
posterior within Monte-Carlo error.  Both engines sample the tiny realistic
posterior from the same warmed-up state and their posterior moments are
compared with per-parameter Vehtari ESS z-scores (the same methodology as
the independent-numpy cross-check).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from hmcmt2d.models import forward as F
from hmcmt2d.models.posterior import build_inverse_problem
from hmcmt2d.sampler import adapt as A
from hmcmt2d.sampler import diagnostics as D
from hmcmt2d.sampler import hmc as H
from hmcmt2d.sampler.driver import make_potential_vg
from tests.test_e2e import tiny_setup


def _problem(mesh, data, obs, err, start_sig, cfg):
    problem, m0 = build_inverse_problem(
        mesh, data, obs, err, np.asarray(start_sig).ravel(), cfg=cfg)
    return problem, np.asarray(m0)


def test_gpu_default_posterior_matches_exact(monkeypatch):
    mesh, start_sig, data, obs, err = tiny_setup()
    exact_cfg = F.SolveConfig(jnp.complex128, 0, "bcr")
    with monkeypatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "gpu")
        gpu_cfg = F.default_config()
    assert (gpu_cfg.solver_method, gpu_cfg.inv_method) == ("thomas", "lu")

    p_exact, m0 = _problem(mesh, data, obs, err, start_sig, exact_cfg)
    p_gpu, _ = _problem(mesh, data, obs, err, start_sig, gpu_cfg)
    vg_e = make_potential_vg(p_exact, 1.0)
    vg_g = make_potential_vg(p_gpu, 1.0)

    # consistency spot-check at the start model: the per-eval bound behind
    # the statistical claim
    C, P = 2, len(m0)
    m_start = jnp.broadcast_to(jnp.asarray(m0, jnp.float64), (C, P))
    (U_e, _), g_e = jax.jit(vg_e)(m_start, m_start)
    (U_g, _), g_g = jax.jit(vg_g)(m_start, m_start)
    np.testing.assert_allclose(np.asarray(U_g), np.asarray(U_e), rtol=1e-10)
    cos = np.sum(np.asarray(g_g) * np.asarray(g_e)) / (
        np.linalg.norm(np.asarray(g_g)) * np.linalg.norm(np.asarray(g_e)))
    assert cos > 1 - 1e-10, cos

    opts = H.HMCOptions(dt=0.05, steps_lo=2, steps_hi=4,
                        log_sig_lo=float(np.log(1e-4)),
                        log_sig_hi=float(np.log(10.0)), reg_param=1.0)

    # shared warmup under the exact engine
    wres, wstate, wmass, winfo = jax.jit(lambda k: A.warmup(
        vg_e, opts, m_start, m_start, 100, k,
        A.WarmupOptions(adapt_mass=False)))(jax.random.PRNGKey(0))
    dt = float(winfo.dt)
    opts_run = dataclasses.replace(opts, dt=dt)
    mass = H.identity_mass(P, jnp.float64)

    S = 260
    run = lambda vg, key: jax.jit(lambda k: H.run_hmc(
        vg, opts_run, mass, wstate.m, m_start, S, k,
        sample_dtype=jnp.float64))(key)
    res_e = run(vg_e, jax.random.PRNGKey(1))
    res_g = run(vg_g, jax.random.PRNGKey(2))     # independent key stream

    acc_e = float(np.asarray(res_e.accepts).mean())
    acc_g = float(np.asarray(res_g.accepts).mean())
    assert acc_e > 0.4, acc_e
    assert acc_g > 0.4, acc_g
    assert abs(acc_g - acc_e) < 0.25, (acc_e, acc_g)

    keep = S // 5
    se_mod, sg_mod = res_e.models[keep:], res_g.models[keep:]
    mu_e = np.asarray(se_mod).reshape(-1, P).mean(0)
    mu_g = np.asarray(sg_mod).reshape(-1, P).mean(0)
    sd_e = np.asarray(se_mod).reshape(-1, P).std(0)
    sd_g = np.asarray(sg_mod).reshape(-1, P).std(0)
    ess_e = np.maximum(np.asarray(D.ess(se_mod)), 4.0)
    ess_g = np.maximum(np.asarray(D.ess(sg_mod)), 4.0)

    se = np.sqrt(sd_e**2 / ess_e + sd_g**2 / ess_g)
    z = np.abs(mu_e - mu_g) / np.maximum(se, 1e-12)
    assert np.median(z) < 2.0, (np.median(z), z.max())
    assert z.max() < 6.0, z.max()
    ratio = sd_g / np.maximum(sd_e, 1e-12)
    assert 0.5 < np.median(ratio) < 2.0, np.median(ratio)
