"""Adjoint gradients and Jacobians vs. finite differences.

The gradient is the engine of HMC — these are the most important tests in
the suite (mirrors the reference's sensitivity-test usage of compJacMat).
"""

import numpy as np
import jax
import jax.numpy as jnp

from hmcmt2d import mesh as M
from hmcmt2d.constants import SIGMA_AIR
from hmcmt2d.models import forward as F
from hmcmt2d.models import jacobian as J
from hmcmt2d.models.posterior import build_inverse_problem
from tests.test_forward import make_data


def tiny_problem(comps=("ZXY", "ZYX"), data_type="Impedance", nfreq=2):
    """A small but genuinely 2-D inverse problem."""
    rng = np.random.default_rng(0)
    air = np.array([200.0, 1000.0, 5000.0, 30000.0])
    dz_earth = np.concatenate([np.full(4, 150.0), 150 * 1.8 ** np.arange(1, 8)])
    dy = np.concatenate([[30000, 4000], np.full(8, 700.0), [4000, 30000]])
    mesh = M.make_mesh(dy, np.concatenate([air[::-1], dz_earth]), air_layer=air,
                       origin=[34000 + 4 * 700, air.sum()])
    nz, ny, nair = mesh.nz, mesh.ny, mesh.n_air
    sigma2d = np.full((nz, ny), 0.02)
    sigma2d[:nair] = SIGMA_AIR
    sigma2d[nair + 2:nair + 5, 4:8] = 0.2  # anomaly
    rx_loc = np.stack([np.linspace(500, 4000, 4), np.zeros(4)], axis=1)
    freqs = np.logspace(1, 0, nfreq)
    data = make_data(rx_loc, freqs, comps=comps, data_type=data_type)

    fwd = F.make_forward(mesh, data, F.SolveConfig(jnp.complex128, 0))
    obs = np.asarray(fwd.predict(jnp.asarray(sigma2d)))
    obs = obs + 0.03 * np.abs(obs) * (rng.standard_normal(obs.shape)
                                      + (1j * rng.standard_normal(obs.shape) if np.iscomplexobj(obs) else 0))
    err = 0.03 * np.abs(obs)
    prob, m0 = build_inverse_problem(mesh, data, obs, err, sigma2d.ravel(),
                                     cfg=F.SolveConfig(jnp.complex128, 0))
    return prob, np.asarray(m0)


def test_potential_gradient_vs_fd():
    prob, m0 = tiny_problem()
    m_ref = jnp.asarray(m0)
    reg = 0.7
    m = jnp.asarray(m0 + 0.05 * np.random.default_rng(1).standard_normal(len(m0)))

    (U, aux), g = prob.potential_value_and_grad(m, m_ref, reg)
    g = np.asarray(g)
    assert np.all(np.isfinite(g))

    rng = np.random.default_rng(2)
    # eps large enough that roundoff noise in U (propagated through the PDE
    # solves) stays below the O(eps^2) truncation error; see the eps-sweep in
    # the module docstring history: eps=1e-6 sits in the noise regime
    eps = 1e-4
    pot = jax.jit(lambda mm: prob.potential(mm, m_ref, reg)[0])
    idxs = rng.choice(len(m0), size=8, replace=False)
    for i in idxs:
        dm = np.zeros(len(m0))
        dm[i] = eps
        fd = (float(pot(m + jnp.asarray(dm))) - float(pot(m - jnp.asarray(dm)))) / (2 * eps)
        # central-difference truncation limits agreement to ~1e-4 relative
        np.testing.assert_allclose(g[i], fd, rtol=2e-4, atol=1e-7)


def test_gradient_directional_vs_fd():
    """Full-vector directional derivative (catches errors FD-per-component
    might miss in correlated terms)."""
    prob, m0 = tiny_problem(comps=("RhoXY", "PhsXY"), data_type="Rho_Pha", nfreq=1)
    m_ref = jnp.asarray(m0)
    m = jnp.asarray(m0)
    (U, _), g = prob.potential_value_and_grad(m, m_ref, 0.0)
    rng = np.random.default_rng(3)
    v = rng.standard_normal(len(m0))
    v /= np.linalg.norm(v)
    pot = jax.jit(lambda mm: prob.potential(mm, m_ref, 0.0)[0])
    # eps sweep (4e-4 .. 5e-6) shows PDE-solve roundoff noise of ~1e-5
    # relative dominating the FD below eps=2e-4; at 2e-4 agreement is ~2e-6
    eps = 2e-4
    Up = pot(m + eps * jnp.asarray(v))
    Um = pot(m - eps * jnp.asarray(v))
    fd = (float(Up) - float(Um)) / (2 * eps)
    np.testing.assert_allclose(float(np.asarray(g) @ v), fd, rtol=1e-5)


def test_jacobian_products_consistent():
    prob, m0 = tiny_problem(nfreq=1)
    m = jnp.asarray(m0)
    rng = np.random.default_rng(4)
    n_real = 2 * prob.obs.shape[0]
    v = jnp.asarray(rng.standard_normal(len(m0)))
    w = jnp.asarray(rng.standard_normal(n_real))
    Jv = np.asarray(J.jv(prob, m, v))
    Jtw = np.asarray(J.jtv(prob, m, w))
    assert Jv.shape == (n_real,)
    assert Jtw.shape == (len(m0),)
    # <w, Jv> == <J'w, v>
    np.testing.assert_allclose(float(np.asarray(w) @ Jv), float(Jtw @ np.asarray(v)), rtol=1e-9)


def test_full_jacobian_vs_fd_columns():
    prob, m0 = tiny_problem(nfreq=1)
    m = jnp.asarray(m0)
    Jfull = np.asarray(J.full_jacobian(prob, m))
    pred = jax.jit(lambda mm: J.real_predict(prob, mm))
    rng = np.random.default_rng(5)
    eps = 1e-4  # below this, PDE-solve roundoff noise dominates the FD
    for i in rng.choice(len(m0), size=4, replace=False):
        dm = np.zeros(len(m0))
        dm[i] = eps
        fd = (np.asarray(pred(m + jnp.asarray(dm)))
              - np.asarray(pred(m - jnp.asarray(dm)))) / (2 * eps)
        # entries are checked against the column scale: far-padding-cell
        # sensitivities are ~1e-8 x the column max and pure FD noise there
        np.testing.assert_allclose(Jfull[:, i], fd, rtol=2e-3,
                                   atol=1e-3 * np.abs(fd).max() + 1e-14)


def test_amortized_factor_gradient_matches_fresh():
    """Potential value and gradient with a STALE factorisation (built at a
    drifted model, solved via refinement) must match the fresh-factor path —
    the trajectory-amortised correctness contract."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hmcmt2d.models import forward as F
    from hmcmt2d.models.posterior import build_inverse_problem
    from tests.test_e2e import tiny_setup

    mesh, start_sig, data, obs, err = tiny_setup()
    cfg = F.SolveConfig(jnp.complex128, 0, "thomas", "lu", stale_refine_iters=12)
    prob, m0 = build_inverse_problem(mesh, data, obs, err, start_sig.ravel(),
                                     cfg=cfg)
    rng = np.random.default_rng(2)
    m = jnp.asarray(np.asarray(m0) + 0.05 * rng.standard_normal(len(m0)))
    m_stale = jnp.asarray(np.asarray(m0) - 0.2 * rng.standard_normal(len(m0)))
    mref = jnp.asarray(np.asarray(m0))

    (U0, (mis0, _, pred0)), g0 = jax.value_and_grad(
        lambda mm: prob.potential(mm, mref, 1.0), has_aux=True)(m)
    fac = prob.factor_state(m_stale)
    (U1, (mis1, _, pred1)), g1 = jax.value_and_grad(
        lambda mm: prob.potential(mm, mref, 1.0, fac=fac), has_aux=True)(m)

    # 12 refinement iterations at contraction ~0.2 (0.2-drift stale factor)
    # leave a ~1e-8 relative floor
    np.testing.assert_allclose(float(U1), float(U0), rtol=1e-7)
    np.testing.assert_allclose(np.asarray(pred1), np.asarray(pred0), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g0), rtol=1e-4,
                               atol=1e-7 * float(jnp.abs(g0).max()))


def test_amortized_hmc_matches_fresh_sampler():
    """run_hmc with factor_fn (refactor every 2 steps + refinement) must
    reproduce the fresh-factorisation sampler's trajectories to refinement
    tolerance — same accept decisions and models on a short run."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hmcmt2d.models import forward as F
    from hmcmt2d.models.posterior import build_inverse_problem
    from hmcmt2d.sampler import hmc as H
    from hmcmt2d.sampler.driver import make_factor_fn, make_potential_vg
    from tests.test_e2e import tiny_setup

    mesh, start_sig, data, obs, err = tiny_setup()
    cfg = F.SolveConfig(jnp.complex128, 0, "thomas", "lu", stale_refine_iters=12)
    prob, m0 = build_inverse_problem(mesh, data, obs, err, start_sig.ravel(),
                                     cfg=cfg)
    vg = make_potential_vg(prob, 1.0)
    opts = H.HMCOptions(dt=0.05, steps_lo=2, steps_hi=4,
                        log_sig_lo=float(np.log(1e-4)),
                        log_sig_hi=float(np.log(10.0)), reg_param=1.0,
                        refactor_every=2)
    mass = H.identity_mass(len(m0))
    m_start = jnp.broadcast_to(jnp.asarray(m0), (2, len(m0)))
    key = jax.random.PRNGKey(7)

    res_fresh = H.run_hmc(vg, opts, mass, m_start, m_start, 5, key)
    res_amort = H.run_hmc(vg, opts, mass, m_start, m_start, 5, key,
                          factor_fn=make_factor_fn(prob))
    np.testing.assert_array_equal(np.asarray(res_amort.accepts),
                                  np.asarray(res_fresh.accepts))
    np.testing.assert_allclose(np.asarray(res_amort.models),
                               np.asarray(res_fresh.models), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(res_amort.stats),
                               np.asarray(res_fresh.stats), rtol=1e-5)


def test_native_chain_batching_matches_per_chain():
    """The driver's chains-batched potential value-and-grad (native batching
    through one merged (chains x freq x mode) solve, per-chain gradients via
    the chain-summed potential — NO vmap) must equal independent per-chain
    evaluations exactly.  This is the contract that replaces
    vmap(value_and_grad) on the production path."""
    from hmcmt2d.sampler.driver import make_factor_fn, make_potential_vg

    prob, m0 = tiny_problem()
    C, P = 3, len(m0)
    key = jax.random.PRNGKey(0)
    M = jnp.asarray(m0)[None] + 0.1 * jax.random.normal(key, (C, P))
    Mref = jnp.broadcast_to(jnp.asarray(m0), (C, P))
    reg = 10.0

    vg = make_potential_vg(prob, reg)
    (U, (mis, mn, pred)), g = vg(M, Mref)
    assert U.shape == (C,) and mis.shape == (C,) and mn.shape == (C,)
    assert pred.shape[0] == C and g.shape == (C, P)

    for c in range(C):
        (Uc, (mc, nc, pc)), gc = jax.value_and_grad(
            lambda m: prob.potential(m, Mref[c], reg), has_aux=True)(M[c])
        np.testing.assert_allclose(float(Uc), float(U[c]), rtol=1e-12)
        np.testing.assert_allclose(float(mc), float(mis[c]), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(pc), np.asarray(pred[c]), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(gc), np.asarray(g[c]),
                                   rtol=1e-9, atol=1e-12)

    # trajectory-amortised path: batched stale factors solve to refinement tol
    fac = make_factor_fn(prob)(M)
    (U2, _), g2 = vg(M, Mref, fac)
    np.testing.assert_allclose(np.asarray(U2), np.asarray(U), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(g), rtol=1e-5,
                               atol=1e-9 * float(jnp.abs(g).max()))
