"""Native band LDL^T solver: correctness vs scipy and the on-device solver.

The reference's native-layer tests build a synthetic SPD operator and check
residuals to 1e-14 with single and multi RHS plus factor-lifetime behaviour
(MUMPS/test/testDivGrad.jl:17-62, testTwoSystem.jl:1-51) — mirrored here for
the rebuild's native component.
"""

import numpy as np
import pytest

from hmcmt2d import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")


def dense_from_interior(diag, offy, offz):
    nzi, nyi = diag.shape
    n = nzi * nyi
    A = np.zeros((n, n), complex)
    A[np.arange(n), np.arange(n)] = diag.reshape(-1)
    for j in range(nzi):
        for i in range(nyi - 1):
            k = j * nyi + i
            A[k, k + 1] = A[k + 1, k] = -offy[j, i]
    for j in range(nzi - 1):
        for i in range(nyi):
            k = j * nyi + i
            A[k, k + nyi] = A[k + nyi, k] = -offz[j, i]
    return A


def random_interior(rng, nzi=6, nyi=5):
    # diagonally dominant complex-symmetric (equilibrated-operator-like)
    offy = rng.standard_normal((nzi, nyi - 1)) * 0.2
    offz = rng.standard_normal((nzi - 1, nyi)) * 0.2
    diag = (1.0 + 0.3 * rng.standard_normal((nzi, nyi))
            + 1j * (0.5 + 0.1 * rng.standard_normal((nzi, nyi))))
    return diag, offy, offz


def test_single_and_multi_rhs(rng):
    diag, offy, offz = random_interior(rng)
    A = dense_from_interior(diag, offy, offz)
    n = A.shape[0]
    band = native.band_from_interior(diag, offy, offz)

    with native.BandFactorization(band) as f:
        b1 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        x1 = f.solve(b1)
        assert np.linalg.norm(A @ x1 - b1) / np.linalg.norm(b1) < 1e-13

        B = rng.standard_normal((n, 7)) + 1j * rng.standard_normal((n, 7))
        X = f.solve(B)
        assert np.linalg.norm(A @ X - B) / np.linalg.norm(B) < 1e-13

        # complex-symmetric: transpose solve == solve
        xt = f.solve(b1)
        assert np.linalg.norm(A.T @ xt - b1) / np.linalg.norm(b1) < 1e-13


def test_two_simultaneous_factors_and_lifetime(rng):
    """Two live factorisations solved interleaved, then freed
    (testTwoSystem.jl)."""
    live0 = native.live_factor_count()
    d1 = random_interior(rng, 4, 3)
    d2 = random_interior(rng, 5, 4)
    A1, A2 = dense_from_interior(*d1), dense_from_interior(*d2)
    f1 = native.BandFactorization(native.band_from_interior(*d1))
    f2 = native.BandFactorization(native.band_from_interior(*d2))
    assert native.live_factor_count() == live0 + 2
    b1 = rng.standard_normal(A1.shape[0]) + 0j
    b2 = rng.standard_normal(A2.shape[0]) + 0j
    assert np.linalg.norm(A1 @ f1.solve(b1) - b1) < 1e-12
    assert np.linalg.norm(A2 @ f2.solve(b2) - b2) < 1e-12
    f1.destroy()
    f2.destroy()
    assert native.live_factor_count() == live0
    with pytest.raises(RuntimeError):
        f1.solve(b1)


def test_against_device_solver(rng):
    """Native oracle == the batched block-Thomas device solver."""
    import jax.numpy as jnp

    from hmcmt2d.ops import solver as S

    diag, offy, offz = random_interior(rng, 7, 6)
    sys = S.InteriorSystem(jnp.asarray(diag), jnp.asarray(offy), jnp.asarray(offz))
    b = rng.standard_normal(diag.shape) + 1j * rng.standard_normal(diag.shape)
    x_dev = np.asarray(S.direct_solve(sys, jnp.asarray(b)))
    x_nat = native.solve_interior(diag, offy, offz, b.reshape(-1)).reshape(diag.shape)
    np.testing.assert_allclose(x_dev, x_nat, rtol=1e-9, atol=1e-11)


def test_singular_pivot_raises():
    diag = np.zeros((2, 2), complex)
    band = native.band_from_interior(diag, np.zeros((2, 1)), np.zeros((1, 2)))
    with pytest.raises(RuntimeError):
        native.BandFactorization(band)
