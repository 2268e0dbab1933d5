"""1-D analytic layered-earth fields vs. closed forms and an FD ODE oracle."""

import numpy as np
import jax.numpy as jnp
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from hmcmt2d.constants import EPS0, MU0
from hmcmt2d.ops import mt1d


def test_halfspace_closed_form():
    freq = 1.0
    omega = 2 * np.pi * freq
    sig = 0.01
    n = 12
    dz = np.full(n, 200.0)
    z = np.concatenate([[0.0], np.cumsum(dz)])
    k = np.sqrt(MU0 * EPS0 * omega**2 - 1j * MU0 * sig * omega)

    e, h = mt1d.analytic_field(omega, jnp.full(n, sig), jnp.asarray(dz), with_h=True)
    e, h = np.asarray(e), np.asarray(h)
    # E(z) = exp(-i k z) in a halfspace (downgoing wave only)
    np.testing.assert_allclose(e, np.exp(-1j * k * z), rtol=1e-10)
    # surface impedance E/H = omega*mu0/k, apparent resistivity = 1/sigma
    z0 = e[0] / h[0]
    np.testing.assert_allclose(z0, omega * MU0 / k, rtol=1e-10)
    rho_a = abs(z0) ** 2 / (omega * MU0)
    np.testing.assert_allclose(rho_a, 1.0 / sig, rtol=1e-4)


def test_surface_impedance_matches_field_ratio():
    rng = np.random.default_rng(2)
    n = 10
    sig = 10.0 ** rng.uniform(-3, 0, size=(5, n))  # 5 profiles
    dz = np.exp(rng.uniform(4, 7, size=n))
    omega = 2 * np.pi * 0.1
    z0 = np.asarray(mt1d.surface_impedance(omega, jnp.asarray(sig), jnp.asarray(dz)))
    e, h = mt1d.analytic_field(omega, jnp.asarray(sig), jnp.asarray(dz), with_h=True)
    np.testing.assert_allclose(np.asarray(e)[:, 0] / np.asarray(h)[:, 0], z0, rtol=1e-9)


def test_two_layer_vs_fd_ode():
    """E'' = i*omega*mu0*sigma*E solved by fine FD vs analytic propagation."""
    omega = 2 * np.pi * 0.5
    # two layers: 100 Ohm.m over 1 Ohm.m
    zb = 3000.0  # interface depth
    depth = 60000.0

    def sigma_of(z):
        return np.where(z < zb, 0.01, 1.0)

    nfine = 6000
    h = depth / nfine
    zc = (np.arange(nfine) + 0.5) * h
    sig = sigma_of(zc)
    # FD: (E[i-1] - 2E[i] + E[i+1])/h^2 = i*omega*mu0*sigma_node*E[i]
    signode = 0.5 * (sig[:-1] + sig[1:])
    k_bot = np.sqrt(-1j * MU0 * sig[-1] * omega)
    main = -2.0 / h**2 - 1j * omega * MU0 * signode
    A = sp.diags([np.ones(nfine - 2) / h**2, main, np.ones(nfine - 2) / h**2], [-1, 0, 1],
                 shape=(nfine - 1, nfine - 1), format="lil")
    # bottom BC: radiation E' = -i k E  => eliminate E[n] = E[n-1] * exp(-i k h)
    A[-1, -1] += np.exp(-1j * k_bot * h) / h**2
    rhs = np.zeros(nfine - 1, complex)
    rhs[0] = -1.0 / h**2  # top Dirichlet E(0)=1
    Ein = spla.spsolve(A.tocsr(), rhs)
    Efd = np.concatenate([[1.0], Ein])

    # analytic on a coarse layered grid aligned with interfaces
    dz = np.diff(np.concatenate([np.linspace(0, zb, 7), np.linspace(zb, depth / 2, 12)[1:]]))
    zl = np.concatenate([[0.0], np.cumsum(dz)])
    sigl = sigma_of(zl[:-1] + np.diff(zl) / 2)
    e = np.asarray(mt1d.analytic_field(omega, jnp.asarray(sigl), jnp.asarray(dz)))
    efd_at = np.interp(zl, np.concatenate([[0], (np.arange(1, nfine)) * h]), Efd.real) + \
        1j * np.interp(zl, np.concatenate([[0], (np.arange(1, nfine)) * h]), Efd.imag)
    np.testing.assert_allclose(e, efd_at, rtol=2e-3, atol=2e-4)


def test_overflow_guard_zeroes_deep_layers():
    """At high frequency / deep conductive model, deep interfaces must be
    exactly zero (reference zeroes on overflow, mt1DField.jl:76-82), and the
    result must be NaN-free and differentiable."""
    import jax

    omega = 2 * np.pi * 1e3
    n = 40
    dz = np.full(n, 5000.0)
    sig = np.full(n, 1.0)
    e = np.asarray(mt1d.analytic_field(omega, jnp.asarray(sig), jnp.asarray(dz)))
    assert np.all(np.isfinite(e))
    assert np.all(e[-10:] == 0.0)

    def loss(s):
        e = mt1d.analytic_field(omega, s, jnp.asarray(dz))
        return jnp.sum(jnp.abs(e) ** 2)

    g = np.asarray(jax.grad(loss)(jnp.asarray(sig)))
    assert np.all(np.isfinite(g))


def test_batched_broadcasting():
    """(nfreq, ncol, nlayer) batching matches per-item evaluation."""
    rng = np.random.default_rng(5)
    nfreq, ncol, n = 3, 4, 8
    sig = 10.0 ** rng.uniform(-2, 0, size=(ncol, n))
    dz = np.exp(rng.uniform(4, 6, size=n))
    omegas = 2 * np.pi * np.array([0.01, 1.0, 10.0])
    e_b, h_b = mt1d.analytic_field(
        omegas[:, None, None], jnp.asarray(sig)[None], jnp.asarray(dz)[None, None], with_h=True)
    assert e_b.shape == (nfreq, ncol, n + 1)
    for i, om in enumerate(omegas):
        for c in range(ncol):
            e, h = mt1d.analytic_field(om, jnp.asarray(sig[c]), jnp.asarray(dz), with_h=True)
            np.testing.assert_allclose(np.asarray(e_b)[i, c], np.asarray(e), rtol=1e-12)
            np.testing.assert_allclose(np.asarray(h_b)[i, c], np.asarray(h), rtol=1e-12)
