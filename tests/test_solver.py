"""Block-tridiagonal direct solver vs. scipy sparse factorisation."""

import numpy as np
import jax
import jax.numpy as jnp
import scipy.sparse.linalg as spla

from hmcmt2d import mesh as M
from hmcmt2d.ops import solver as S
from hmcmt2d.utils import cpu_reference as R
from tests.conftest import small_mesh


def _problem(mode, ny=12, nz=9, freq=1.0, seed=3):
    rng = np.random.default_rng(seed)
    dy, dz = small_mesh(ny, nz, rng)
    sigma = 10.0 ** rng.uniform(-3, 0, size=(nz, ny))
    sigma[:2] = 1e-8
    msh = M.make_mesh(dy, dz)
    st = M.te_stencil(msh, jnp.asarray(sigma)) if mode == "TE" else M.tm_stencil(msh, jnp.asarray(sigma))
    omega = 2 * np.pi * freq
    A = R.dense_operator(dy, dz, sigma.ravel(), mode, omega)
    ii, _ = R.boundary_index(ny, nz)
    Aii = A[np.ix_(ii, ii)].tocsc()
    return msh, st, omega, Aii, (nz - 1, ny - 1)


def test_interior_system_matches_Aii():
    for mode in ("TE", "TM"):
        msh, st, omega, Aii, (nzi, nyi) = _problem(mode)
        sys = S.interior_system(st, omega)
        rng = np.random.default_rng(11)
        x = rng.standard_normal((nzi, nyi)) + 1j * rng.standard_normal((nzi, nyi))
        got = np.asarray(S.apply_interior(sys, jnp.asarray(x))).ravel()
        want = Aii @ x.ravel()
        np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-9 * np.abs(want).max())


def test_direct_solve_matches_scipy():
    for mode in ("TE", "TM"):
        for freq in (0.01, 1.0, 100.0):
            msh, st, omega, Aii, (nzi, nyi) = _problem(mode, freq=freq)
            sys = S.interior_system(st, omega)
            rng = np.random.default_rng(13)
            b = rng.standard_normal((nzi, nyi)) + 1j * rng.standard_normal((nzi, nyi))
            x = np.asarray(S.direct_solve(sys, jnp.asarray(b)))
            want = spla.spsolve(Aii, b.ravel()).reshape(nzi, nyi)
            np.testing.assert_allclose(x, want, rtol=1e-8, atol=1e-10 * np.abs(want).max())


def test_factor_reuse_and_refinement():
    msh, st, omega, Aii, (nzi, nyi) = _problem("TM", freq=0.1)
    sys = S.interior_system(st, omega)
    fac = S.factorize(sys)
    rng = np.random.default_rng(17)
    for _ in range(3):
        b = rng.standard_normal((nzi, nyi)) + 1j * rng.standard_normal((nzi, nyi))
        x = np.asarray(S.factor_solve(fac, jnp.asarray(b)))
        want = spla.spsolve(Aii, b.ravel()).reshape(nzi, nyi)
        np.testing.assert_allclose(x, want, rtol=1e-8, atol=1e-10 * np.abs(want).max())


def test_low_precision_factor_with_refinement():
    """complex64 factor + f64 residual refinement reaches near-f64 accuracy.

    The mixed-precision configuration (``--precision f32 --refine N``).
    """
    msh, st, omega, Aii, (nzi, nyi) = _problem("TM", freq=1.0)
    sys64 = S.interior_system(st, omega)                       # f64 accumulation
    sys32 = S.interior_system(st, omega, dtype=jnp.complex64)  # low-precision factor
    fac32 = S.factorize(sys32, dtype=jnp.complex64)
    rng = np.random.default_rng(19)
    b = rng.standard_normal((nzi, nyi)) + 1j * rng.standard_normal((nzi, nyi))
    want = spla.spsolve(Aii, b.ravel()).reshape(nzi, nyi)

    x0 = np.asarray(S.factor_solve(fac32, jnp.asarray(b, jnp.complex64)))
    err0 = np.abs(x0 - want).max() / np.abs(want).max()

    x2 = np.asarray(S.refined_solve(sys64, fac32, jnp.asarray(b), iters=3))
    err2 = np.abs(x2 - want).max() / np.abs(want).max()
    assert err2 < 1e-10, (err0, err2)
    assert err2 < err0


def test_bcr_matches_thomas_and_scipy():
    """Block cyclic reduction vs block Thomas vs scipy, both modes, wide
    frequency range — the two direct methods must agree to fp accuracy."""
    for mode in ("TE", "TM"):
        for freq in (0.01, 1.0, 100.0):
            msh, st, omega, Aii, (nzi, nyi) = _problem(mode, freq=freq)
            sys = S.interior_system(st, omega)
            rng = np.random.default_rng(29)
            b = rng.standard_normal((nzi, nyi)) + 1j * rng.standard_normal((nzi, nyi))
            want = spla.spsolve(Aii, b.ravel()).reshape(nzi, nyi)
            for method in ("bcr", "thomas"):
                fac = S.factorize(sys, method=method)
                x = np.asarray(S.factor_solve(fac, jnp.asarray(b)))
                np.testing.assert_allclose(
                    x, want, rtol=1e-8, atol=1e-10 * np.abs(want).max(),
                    err_msg=f"{mode} f={freq} {method}")


def test_bcr_odd_block_counts():
    """Padding: nzi not of 2^m - 1 form, including tiny meshes."""
    for ny, nz in ((6, 2), (6, 3), (7, 4), (9, 6), (12, 9), (8, 17)):
        msh, st, omega, Aii, (nzi, nyi) = _problem("TE", ny=ny, nz=nz)
        sys = S.interior_system(st, omega)
        rng = np.random.default_rng(31)
        b = rng.standard_normal((nzi, nyi)) + 1j * rng.standard_normal((nzi, nyi))
        want = spla.spsolve(Aii, b.ravel()).reshape(nzi, nyi)
        fac = S.factorize(sys, method="bcr")
        x = np.asarray(S.factor_solve(fac, jnp.asarray(b)))
        np.testing.assert_allclose(x, want, rtol=1e-8,
                                   atol=1e-10 * np.abs(want).max(),
                                   err_msg=f"nzi={nzi}")


def test_bcr_batched_and_refined():
    """BCR under vmap (the production batch axis) and with low-precision
    factor + refinement (the mixed-precision configuration)."""
    msh, st, omega0, _, (nzi, nyi) = _problem("TM")
    freqs = np.array([0.05, 0.5, 5.0])
    omegas = 2 * np.pi * freqs
    rng = np.random.default_rng(37)
    b = rng.standard_normal((3, nzi, nyi)) + 1j * rng.standard_normal((3, nzi, nyi))
    sys_b = S.interior_system(st, jnp.asarray(omegas)[:, None, None])
    fac_b = S.factorize(sys_b, method="bcr")
    x_b = np.asarray(S.factor_solve(fac_b, jnp.asarray(b)))
    for i, om in enumerate(omegas):
        sys_i = S.interior_system(st, om)
        _, _, _, Aii_i = None, None, None, None
        dy, dz = np.asarray(msh.y_len), np.asarray(msh.z_len)
        x_i = np.asarray(S.direct_solve(sys_i, jnp.asarray(b[i])))
        np.testing.assert_allclose(x_b[i], x_i, rtol=1e-9)

    sys64 = S.interior_system(st, 2 * np.pi * 0.5)
    sys32 = S.interior_system(st, 2 * np.pi * 0.5, dtype=jnp.complex64)
    fac32 = S.factorize(sys32, dtype=jnp.complex64, method="bcr")
    b1 = b[1]
    x_ref = np.asarray(S.direct_solve(sys64, jnp.asarray(b1)))
    x_ref32 = np.asarray(S.factor_solve(fac32, jnp.asarray(b1, jnp.complex64)))
    x_refn = np.asarray(S.refined_solve(sys64, fac32, jnp.asarray(b1), iters=3))
    err32 = np.abs(x_ref32 - x_ref).max() / np.abs(x_ref).max()
    errn = np.abs(x_refn - x_ref).max() / np.abs(x_ref).max()
    assert errn < 1e-10 and errn < err32, (err32, errn)


def test_gj_inverse_matches_lu():
    """Blocked unpivoted Gauss-Jordan (``--inv gj``) vs pivoted LU on the
    real equilibrated operators, both solver structures, f64 and the
    mixed-precision combo (complex64 + refinement)."""
    for mode in ("TE", "TM"):
        for freq in (0.01, 100.0):
            msh, st, omega, Aii, (nzi, nyi) = _problem(mode, freq=freq)
            sys = S.interior_system(st, omega)
            rng = np.random.default_rng(41)
            b = rng.standard_normal((nzi, nyi)) + 1j * rng.standard_normal((nzi, nyi))
            want = spla.spsolve(Aii, b.ravel()).reshape(nzi, nyi)
            for method in ("thomas", "bcr"):
                fac = S.factorize(sys, method=method, inv_method="gj")
                x = np.asarray(S.factor_solve(fac, jnp.asarray(b)))
                np.testing.assert_allclose(
                    x, want, rtol=1e-8, atol=1e-10 * np.abs(want).max(),
                    err_msg=f"{mode} f={freq} {method}+gj")

    # mixed precision: complex64 GJ factor + f64-residual refinement
    msh, st, omega, Aii, (nzi, nyi) = _problem("TM", freq=1.0)
    sys64 = S.interior_system(st, omega)
    sys32 = S.interior_system(st, omega, dtype=jnp.complex64)
    fac32 = S.factorize(sys32, dtype=jnp.complex64, method="thomas",
                        inv_method="gj")
    rng = np.random.default_rng(43)
    b = rng.standard_normal((nzi, nyi)) + 1j * rng.standard_normal((nzi, nyi))
    want = spla.spsolve(Aii, b.ravel()).reshape(nzi, nyi)
    x0 = np.asarray(S.factor_solve(fac32, jnp.asarray(b, jnp.complex64)))
    err0 = np.abs(x0 - want).max() / np.abs(want).max()
    x2 = np.asarray(S.refined_solve(sys64, fac32, jnp.asarray(b), iters=3))
    err2 = np.abs(x2 - want).max() / np.abs(want).max()
    assert err0 < 1e-4, err0          # raw c64 GJ already close
    assert err2 < 1e-10 and err2 < err0, (err0, err2)


def test_batched_over_frequency():
    msh, st, omega0, _, (nzi, nyi) = _problem("TE")
    freqs = np.array([0.05, 0.5, 5.0])
    omegas = 2 * np.pi * freqs
    sys_b = jax.vmap(lambda om: S.interior_system(st, om))(jnp.asarray(omegas))
    rng = np.random.default_rng(23)
    b = rng.standard_normal((3, nzi, nyi)) + 1j * rng.standard_normal((3, nzi, nyi))
    x_b = np.asarray(jax.vmap(S.direct_solve)(sys_b, jnp.asarray(b)))
    for i, om in enumerate(omegas):
        sys_i = S.interior_system(st, om)
        x_i = np.asarray(S.direct_solve(sys_i, jnp.asarray(b[i])))
        np.testing.assert_allclose(x_b[i], x_i, rtol=1e-10)


def test_blocked_thomas_solve_matches_scipy():
    """Grouped (parallel-prefix) Thomas sweeps vs plain Thomas vs scipy,
    including non-multiple-of-group line counts and the refinement combo."""
    for mode in ("TE", "TM"):
        for ny, nz in ((12, 9), (10, 18), (8, 6)):
            msh, st, omega, Aii, (nzi, nyi) = _problem(mode, ny=ny, nz=nz)
            sys = S.interior_system(st, omega)
            rng = np.random.default_rng(47)
            b = rng.standard_normal((nzi, nyi)) + 1j * rng.standard_normal((nzi, nyi))
            want = spla.spsolve(Aii, b.ravel()).reshape(nzi, nyi)
            fac = S.factorize(sys, method="thomas_blocked")
            x = np.asarray(S.factor_solve(fac, jnp.asarray(b)))
            np.testing.assert_allclose(x, want, rtol=1e-8,
                                       atol=1e-10 * np.abs(want).max(),
                                       err_msg=f"{mode} {ny}x{nz}")

    # batched + complex64 + refinement (the mixed-precision combo)
    msh, st, omega, Aii, (nzi, nyi) = _problem("TM", freq=0.5)
    freqs = 2 * np.pi * np.array([0.05, 5.0])
    sys_b = S.interior_system(st, jnp.asarray(freqs)[:, None, None])
    sys32 = S.interior_system(st, jnp.asarray(freqs)[:, None, None],
                              dtype=jnp.complex64)
    fac32 = S.factorize(sys32, dtype=jnp.complex64, method="thomas_blocked")
    rng = np.random.default_rng(53)
    b = rng.standard_normal((2, nzi, nyi)) + 1j * rng.standard_normal((2, nzi, nyi))
    want = np.stack([np.asarray(S.direct_solve(
        S.interior_system(st, om), jnp.asarray(bb))) for om, bb in zip(freqs, b)])
    x = np.asarray(S.refined_solve(sys_b, fac32, jnp.asarray(b), iters=3))
    np.testing.assert_allclose(x, want, rtol=1e-9, atol=1e-11 * np.abs(want).max())
