"""Stencil operators vs. independent scipy sparse assembly."""

import numpy as np
import jax.numpy as jnp

from hmcmt2d import mesh as M
from hmcmt2d.utils import cpu_reference as R
from tests.conftest import small_mesh


def _setup(mode, ny=9, nz=7):
    rng = np.random.default_rng(3)
    dy, dz = small_mesh(ny, nz, rng)
    sigma = 10.0 ** rng.uniform(-3, 0, size=(nz, ny))
    sigma[:2] = 1e-8  # air rows
    msh = M.make_mesh(dy, dz)
    st = M.te_stencil(msh, jnp.asarray(sigma)) if mode == "TE" else M.tm_stencil(msh, jnp.asarray(sigma))
    return dy, dz, sigma, msh, st


def test_stencil_matches_sparse_assembly():
    for mode in ("TE", "TM"):
        dy, dz, sigma, msh, st = _setup(mode)
        ny, nz = len(dy), len(dz)
        omega = 2 * np.pi * 0.3
        A = R.dense_operator(dy, dz, sigma.ravel(), mode, omega).toarray()

        rng = np.random.default_rng(7)
        u = rng.standard_normal((nz + 1, ny + 1)) + 1j * rng.standard_normal((nz + 1, ny + 1))
        got = np.asarray(M.apply_A(st, omega, jnp.asarray(u)))
        want = (A @ u.ravel()).reshape(nz + 1, ny + 1)
        np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-9 * np.abs(want).max())


def test_stencil_is_symmetric():
    """A is complex symmetric: <Au, v> == <u, Av> (unconjugated)."""
    _, _, _, _, st = _setup("TE")
    rng = np.random.default_rng(1)
    nzp, nyp = st.m.shape
    u = rng.standard_normal((nzp, nyp)) + 1j * rng.standard_normal((nzp, nyp))
    v = rng.standard_normal((nzp, nyp)) + 1j * rng.standard_normal((nzp, nyp))
    omega = 2 * np.pi * 1.7
    Au = np.asarray(M.apply_A(st, omega, jnp.asarray(u)))
    Av = np.asarray(M.apply_A(st, omega, jnp.asarray(v)))
    np.testing.assert_allclose(np.sum(Au * v), np.sum(u * Av), rtol=1e-10)


def test_boundary_rhs_matches_Aio():
    for mode in ("TE", "TM"):
        dy, dz, sigma, msh, st = _setup(mode)
        ny, nz = len(dy), len(dz)
        omega = 2 * np.pi * 0.05
        A = R.dense_operator(dy, dz, sigma.ravel(), mode, omega)
        ii, io = R.boundary_index(ny, nz)
        rng = np.random.default_rng(9)
        bc_vals = rng.standard_normal(len(io)) + 1j * rng.standard_normal(len(io))
        bc_full = np.zeros(((nz + 1) * (ny + 1)), complex)
        bc_full[io] = bc_vals
        want = -(A[np.ix_(ii, io)] @ bc_vals)
        got = np.asarray(M.boundary_rhs(st, omega, jnp.asarray(bc_full.reshape(nz + 1, ny + 1)))).ravel()
        np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-9 * np.abs(want).max())


def test_cell_gradient_normal_matches_sparse():
    dy, dz = small_mesh(6, 5)
    ny, nz = len(dy), len(dz)
    Gc = R.cell_gradient(dy, dz)
    rng = np.random.default_rng(4)
    v = rng.standard_normal((nz, ny))
    want = (Gc.T @ (Gc @ v.ravel())).reshape(nz, ny)
    got = np.asarray(M.cell_gradient_normal(jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # quadratic form agrees too
    np.testing.assert_allclose(
        float(M.cell_gradient_sqnorm(jnp.asarray(v))),
        float(v.ravel() @ Gc.T @ Gc @ v.ravel()),
        rtol=1e-12,
    )


def test_interior_embed_roundtrip():
    rng = np.random.default_rng(5)
    u = rng.standard_normal((4, 6))
    full = M.embed_interior(jnp.asarray(u), 5, 7)
    assert full.shape == (6, 8)
    np.testing.assert_array_equal(np.asarray(M.interior(full)), u)
    assert float(np.abs(np.asarray(full)).sum()) == float(np.abs(u).sum())
