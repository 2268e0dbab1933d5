"""Dense (Gauss-Newton / Wm) mass matrix: construction, sampling path, and
the driver's dense-metric warmup schedule.

The reference supports M = Wm via dense Cholesky (setMassMatrix,
HMCSampler.jl:478-489) but its examples never exercise it; the Gauss-Newton
metric M = J'W^2J + reg*Wm is this build's extension attacking the mixing
(ESS/sample) bottleneck identified in round 4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from hmcmt2d.io import HMCConfig
from hmcmt2d.models import forward as F
from hmcmt2d.models import jacobian as J
from hmcmt2d.models.posterior import build_inverse_problem
from hmcmt2d.sampler import diagnostics as D
from hmcmt2d.sampler import hmc as H
from hmcmt2d.sampler.driver import (gauss_newton_mass, make_mass,
                                        mass_kind, run_inversion)
from tests.test_e2e import tiny_setup


@pytest.fixture(scope="module")
def tiny_problem():
    mesh, start_sig, data, obs, err = tiny_setup()
    prob, m0 = build_inverse_problem(mesh, data, obs, err, start_sig.ravel(),
                                     cfg=F.SolveConfig(jnp.complex128, 0))
    return prob, np.asarray(m0)


def test_chunked_jacobian_matches_dense(tiny_problem):
    prob, m0 = tiny_problem
    m = jnp.asarray(m0) + 0.05
    Jd = np.asarray(J.full_jacobian(prob, m))
    for chunk in (7, 64):       # tail-padded and single-slab cases
        Jc = np.asarray(J.full_jacobian_chunked(prob, m, chunk=chunk))
        np.testing.assert_allclose(Jc, Jd, rtol=1e-10, atol=1e-12)


def test_gauss_newton_mass_is_spd_and_consistent(tiny_problem):
    prob, m0 = tiny_problem
    mass = gauss_newton_mass(prob, jnp.asarray(m0), reg=1.0)
    P = prob.n_param
    L = np.asarray(mass.sqrt_m, np.float64)
    inv_m = np.asarray(mass.inv_m, np.float64)
    assert not mass.diagonal
    M = L @ L.T
    # SPD with the data term dominating somewhere
    ev = np.linalg.eigvalsh(M)
    assert ev.min() > 0
    np.testing.assert_allclose(inv_m @ M, np.eye(P), atol=5e-6 * ev.max() / ev.min())
    # draw/kinetic consistency: KE of a draw has mean ~ P/2 (truncation at
    # 2.5 sd shaves a few percent)
    keys = jax.random.split(jax.random.PRNGKey(0), 64)
    kes = [float(mass.kinetic(mass.draw(k, (P,)))) for k in keys[:16]]
    assert 0.75 * P / 2 < np.mean(kes) < 1.05 * P / 2


def test_mass_kind_and_make_mass(tiny_problem):
    prob, _ = tiny_problem
    assert mass_kind(HMCConfig(mass_type="diagonal")) == "diagonal"
    assert mass_kind(HMCConfig(mass_type="gaussnewton")) == "gn"
    assert mass_kind(HMCConfig(mass_type="GN")) == "gn"
    assert mass_kind(HMCConfig(mass_type="nondiagonal")) == "wm"
    m = make_mass(prob, HMCConfig(mass_type="wm"))
    assert not m.diagonal
    with pytest.raises(ValueError, match="gaussnewton"):
        make_mass(prob, HMCConfig(mass_type="gaussnewton"))


def test_dense_mass_mixes_ill_conditioned_gaussian():
    """On a stiff correlated Gaussian target, HMC under the exact-precision
    dense mass must dominate identity-mass HMC in ESS/sample — the round-5
    mixing claim in miniature."""
    rng = np.random.default_rng(0)
    P = 24
    Q = np.linalg.qr(rng.standard_normal((P, P)))[0]
    prec = Q @ np.diag(np.logspace(0, 4, P)) @ Q.T      # cond 1e4

    def vg(m, m_ref, fac=None):
        r = m - m_ref
        g = jnp.einsum("ab,...b->...a", jnp.asarray(prec), r)
        U = 0.5 * jnp.sum(r * g, axis=-1)
        pred = jnp.zeros(m.shape[:-1] + (1,))
        return (U, (U, jnp.zeros_like(U), pred)), g

    opts_id = H.HMCOptions(dt=0.015, steps_lo=6, steps_hi=10,
                           log_sig_lo=-50.0, log_sig_hi=50.0, reg_param=1.0)
    opts_gn = H.HMCOptions(dt=0.9, steps_lo=6, steps_hi=10,
                           log_sig_lo=-50.0, log_sig_hi=50.0, reg_param=1.0)
    C, S = 4, 400
    m0 = jnp.zeros((C, P), jnp.float64)
    mass_id = H.identity_mass(P, jnp.float64)
    mass_gn = H.dense_mass(prec)

    def run(opts, mass):
        res = jax.jit(lambda k: H.run_hmc(vg, opts, mass, m0, m0, S, k,
                                          sample_dtype=jnp.float64))(
            jax.random.PRNGKey(1))
        assert float(np.asarray(res.accepts).mean()) > 0.5
        return float(np.median(np.asarray(D.ess(np.asarray(res.models)))))

    ess_id = run(opts_id, mass_id)
    ess_gn = run(opts_gn, mass_gn)
    assert ess_gn > 4 * ess_id, (ess_id, ess_gn)
    assert ess_gn > 0.25 * S * C, ess_gn     # near-independent draws


def test_driver_gn_schedule_end_to_end():
    """masstype gaussnewton: diagonal warmup -> GN mass -> dt re-adaptation
    -> dense-mass main phase, with the sample ledger adding up."""
    mesh, start_sig, data, obs, err = tiny_setup()
    cfg = HMCConfig(burnin=6, total_samples=24, sig_bounds=(1e-4, 10.0),
                    dt=0.05, timestep=(2, 3), reg_param=1.0, seed=0,
                    adapt=True, mass_type="gaussnewton", mass_warmup=6,
                    mass_dt0=0.2)
    run = run_inversion(cfg, mesh, start_sig, data, obs, err, n_chains=2,
                        solve_cfg=F.SolveConfig(jnp.complex128, 0))
    res = run.result
    S, C, P = res.models.shape
    assert (S, C) == (24, 2)
    assert run.n_warm == 12                       # burnin + mass_warmup
    stats = np.asarray(res.stats)
    assert np.isfinite(stats).all()
    accept_main = float(np.asarray(res.accepts)[run.n_warm:].mean())
    assert accept_main > 0.1
    # checkpoint round-trip with the dense mass
    import tempfile, os
    from hmcmt2d.sampler import checkpoint as CK
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "ck.npz")
        mass = gauss_newton_mass(run.problem, jnp.asarray(res.final.m[0]), 1.0)
        CK.save_checkpoint(
            path, n_done=3, state=res.final, key=jax.random.PRNGKey(0),
            dt=0.1, mass=mass, m_ref=run.m_ref, models=np.asarray(res.models),
            stats=stats, accepts=np.asarray(res.accepts),
            pred=np.asarray(res.pred), lf_steps=np.asarray(res.lf_steps),
            start_stats=np.asarray(res.start_stats),
            start_pred=np.asarray(res.start_pred), n_warm=run.n_warm,
            wall_time=1.0)
        ck = CK.load_checkpoint(path)
        assert not ck["mass"].diagonal
        np.testing.assert_allclose(np.asarray(ck["mass"].sqrt_m),
                                   np.asarray(mass.sqrt_m))


def test_driver_gn_hybrid_schedule():
    """GN schedule with the HYBRID engine switch: phase C must run under the
    MAIN engine after the switch, and its final state must carry into the
    main phase (no re-initialisation)."""
    mesh, start_sig, data, obs, err = tiny_setup()
    cfg = HMCConfig(burnin=6, total_samples=20, sig_bounds=(1e-4, 10.0),
                    dt=0.05, timestep=(2, 3), reg_param=1.0, seed=0,
                    adapt=True, mass_type="gaussnewton", mass_warmup=4,
                    mass_dt0=0.2)
    run = run_inversion(cfg, mesh, start_sig, data, obs, err, n_chains=2,
                        solve_cfg=F.SolveConfig(jnp.complex128, 0),
                        warmup_solve_cfg=F.SolveConfig(jnp.complex128, 1))
    res = run.result
    assert run.n_warm == 10
    assert res.models.shape[0] == 20
    assert np.isfinite(np.asarray(res.stats)).all()
