"""Forward model vs. scipy full-assembly solves and 1-D analytic responses."""

import numpy as np
import jax
import jax.numpy as jnp
import scipy.sparse.linalg as spla

from hmcmt2d import mesh as M
from hmcmt2d.constants import EPS0, MU0, SIGMA_AIR
from hmcmt2d.models import forward as F
from hmcmt2d.models.data import MTData
from hmcmt2d.ops import mt1d
from hmcmt2d.utils import cpu_reference as R


def layered_setup(rho_layers=(100.0,), z_tops=(0.0,), nrx=5):
    """A laterally uniform (1-D) model on a realistic graded mesh."""
    air = np.array([100.0, 300.0, 1000.0, 3000.0, 10000.0, 30000.0, 100000.0])
    dz_earth = np.concatenate([np.full(10, 100.0), 100.0 * 1.45 ** np.arange(1, 18)])
    dy = np.concatenate([[20000, 8000, 3000], np.full(24, 500.0), [3000, 8000, 20000]])
    z_len = np.concatenate([air[::-1], dz_earth])
    origin = np.array([dy[:3].sum() + 6 * 500.0, air.sum()])
    mesh = M.make_mesh(dy, z_len, air_layer=air, origin=origin)

    zc = np.concatenate([[0], np.cumsum(dz_earth)])[:-1] + dz_earth / 2
    sig_earth = np.empty_like(dz_earth)
    for rho, ztop in zip(rho_layers, z_tops):
        sig_earth[zc >= ztop] = 1.0 / rho
    sigma2d = np.concatenate([np.full((len(air), len(dy)), SIGMA_AIR),
                              np.tile(sig_earth[:, None], (1, len(dy)))])

    rx_y = np.linspace(1000.0, 5000.0, nrx)
    rx_loc = np.stack([rx_y, np.zeros(nrx)], axis=1)
    return mesh, sigma2d, rx_loc, dz_earth, sig_earth


def make_data(rx_loc, freqs, comps=("ZXY", "ZYX"), data_type="Impedance"):
    nf, nr, nc = len(freqs), len(rx_loc), len(comps)
    f, r, d = np.meshgrid(np.arange(nf), np.arange(nr), np.arange(nc), indexing="ij")
    return MTData(rx_loc=rx_loc, freqs=np.asarray(freqs), data_type=data_type,
                  data_comp=tuple(comps), freq_id=f.ravel(), rx_id=r.ravel(),
                  dt_id=d.ravel()).validate()


def test_fields_match_scipy_solve():
    mesh, sigma2d, rx_loc, _, _ = layered_setup()
    # add a lateral anomaly so the test is genuinely 2-D
    sigma2d = sigma2d.copy()
    sigma2d[9:13, 8:14] = 0.5
    dy, dz = np.asarray(mesh.y_len), np.asarray(mesh.z_len)
    ny, nz = len(dy), len(dz)
    freqs = np.array([0.1, 10.0])
    omegas = 2 * np.pi * freqs
    cfg = F.SolveConfig(jnp.complex128, 0)

    for mode in ("TE", "TM"):
        st = M.te_stencil(mesh, jnp.asarray(sigma2d)) if mode == "TE" else M.tm_stencil(mesh, jnp.asarray(sigma2d))
        bc = F.boundary_grid(mesh, jnp.asarray(sigma2d), jnp.asarray(omegas), mode, jnp.complex128)
        fields = np.asarray(F.solve_dirichlet(st, jnp.asarray(omegas), bc, cfg))

        ii, io = R.boundary_index(ny, nz)
        for k, om in enumerate(omegas):
            A = R.dense_operator(dy, dz, sigma2d.ravel(), mode, om)
            bck = np.asarray(bc[k]).ravel()
            rhs = -(A[np.ix_(ii, io)] @ bck[io])
            u = spla.spsolve(A[np.ix_(ii, ii)].tocsc(), rhs)
            want = bck.copy()
            want[ii] = u
            np.testing.assert_allclose(fields[k].ravel(), want, rtol=1e-8,
                                       atol=1e-10 * np.abs(want).max())


def test_halfspace_impedance_te_tm():
    rho = 100.0
    mesh, sigma2d, rx_loc, _, _ = layered_setup((rho,))
    freqs = np.array([10.0, 1.0, 0.1])
    data = make_data(rx_loc, freqs)
    fwd = F.make_forward(mesh, data, F.SolveConfig(jnp.complex128, 0))
    z_te = np.asarray(fwd.mode_impedance(jnp.asarray(sigma2d), "TE"))
    z_tm = np.asarray(fwd.mode_impedance(jnp.asarray(sigma2d), "TM"))
    for i, f in enumerate(freqs):
        om = 2 * np.pi * f
        k = np.sqrt(MU0 * EPS0 * om**2 - 1j * MU0 * (1 / rho) * om)
        z0 = om * MU0 / k
        np.testing.assert_allclose(z_te[i], np.full(len(rx_loc), z0), rtol=0.02)
        np.testing.assert_allclose(z_tm[i], np.full(len(rx_loc), -z0), rtol=0.02)
        # apparent resistivity within 4%
        rho_te = np.abs(z_te[i]) ** 2 / (om * MU0)
        np.testing.assert_allclose(rho_te, rho, rtol=0.04)


def test_two_layer_vs_1d_analytic():
    mesh, sigma2d, rx_loc, dz_earth, sig_earth = layered_setup(
        rho_layers=(100.0, 5.0), z_tops=(0.0, 1200.0))
    freqs = np.array([3.0, 0.3])
    data = make_data(rx_loc, freqs)
    fwd = F.make_forward(mesh, data, F.SolveConfig(jnp.complex128, 0))
    z_te = np.asarray(fwd.mode_impedance(jnp.asarray(sigma2d), "TE"))
    z0 = np.asarray(mt1d.surface_impedance(
        2 * np.pi * jnp.asarray(freqs)[:, None], jnp.asarray(sig_earth), jnp.asarray(dz_earth)))
    for i in range(len(freqs)):
        np.testing.assert_allclose(z_te[i], np.full(len(rx_loc), z0[i]), rtol=0.03)


def test_predict_shapes_and_gradient():
    mesh, sigma2d, rx_loc, _, _ = layered_setup()
    freqs = np.array([1.0])
    data = make_data(rx_loc, freqs)
    fwd = F.make_forward(mesh, data, F.SolveConfig(jnp.complex128, 0))
    pred = fwd.predict(jnp.asarray(sigma2d))
    assert pred.shape == (len(freqs) * len(rx_loc) * 2,)
    assert pred.dtype == jnp.complex128

    def loss(s2d):
        p = fwd.predict(s2d)
        return jnp.sum(jnp.abs(p) ** 2)

    g = np.asarray(jax.grad(loss)(jnp.asarray(sigma2d)))
    assert g.shape == sigma2d.shape
    assert np.all(np.isfinite(g))
    assert np.abs(g[mesh.n_air:]).max() > 0


def test_merged_mode_solve_matches_per_mode():
    """The stacked TE+TM factor+solve (one batched system over freq x mode)
    must equal the separate per-mode solves to fp accuracy, including the
    single-propagation boundary construction."""
    mesh, sigma2d, rx_loc, _, _ = layered_setup()
    sigma2d = sigma2d.copy()
    sigma2d[9:13, 8:14] = 0.5
    freqs = np.array([10.0, 0.1])
    data = make_data(rx_loc, freqs)
    fwd = F.make_forward(mesh, data, F.SolveConfig(jnp.complex128, 0))
    s = jnp.asarray(sigma2d)

    f_te, f_tm = fwd.both_mode_solutions(s)
    want_te = fwd.mode_solution(s, "TE")
    want_tm = fwd.mode_solution(s, "TM")
    np.testing.assert_allclose(np.asarray(f_te), np.asarray(want_te), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(f_tm), np.asarray(want_tm), rtol=1e-10)

    # the response cube (which routes through the merged path for TE+TM
    # surveys) stays differentiable
    g = jax.grad(lambda ss: jnp.sum(jnp.abs(fwd.response_cube(ss)) ** 2))(s)
    assert np.all(np.isfinite(np.asarray(g)))


def test_rx_corrections_match_reference_exactly():
    """rx_fields_te/tm and rx_hz_te vs. line-by-line numpy ports of the
    reference's compFieldsAtRxTE/TM (mt2DTE.jl:153-210, mt2DTM.jl:152-210)
    and the tipper Hzr (dataFuncSens.jl:44-46,96), on RANDOM complex fields —
    a one-index or sign slip fails at 1e-12, far below physics tolerances.

    The reference's receiver weights are unnormalised (mt2DTE.jl:200-207);
    ours are normalised, so E and H are compared after dividing by the
    common (dy1+dy2) factor and the impedance Z = E/H is compared directly.
    """
    mesh, sigma2d, rx_loc, _, _ = layered_setup(nrx=7)
    # make the receiver layer laterally heterogeneous
    sigma2d = sigma2d.copy()
    sigma2d[mesh.n_air, ::2] *= 3.0

    rng = np.random.default_rng(42)
    ny = mesh.ny
    rx = F.make_rx_interp(mesh, rx_loc)
    y_node = np.asarray(mesh.y_node())
    z_len1 = float(np.asarray(mesh.z_len)[rx.zid])
    sigma1 = np.asarray(sigma2d)[rx.zid]
    omega = 2 * np.pi * 0.7
    omegas = jnp.asarray([omega])
    ry = rx_loc[:, 0]
    # unnormalised weights scale both fields by (dy1+dy2)
    i_right = np.clip(np.searchsorted(y_node, ry, side="right"), 1, ny)
    wsum = y_node[i_right] - y_node[i_right - 1]

    E0 = rng.standard_normal(ny + 1) + 1j * rng.standard_normal(ny + 1)
    E1 = rng.standard_normal(ny + 1) + 1j * rng.standard_normal(ny + 1)
    fields = jnp.asarray(np.stack([E0, E1]))[None]  # (1 freq, 2 rows, ny+1)

    # build a fake full field grid with the two rows at zid, zid+1
    full = np.zeros((1, mesh.nz + 1, ny + 1), complex)
    full[0, rx.zid] = E0
    full[0, rx.zid + 1] = E1

    Ex, Hy = F.rx_fields_te(omegas, mesh, jnp.asarray(sigma2d), jnp.asarray(full), rx)
    Ex_ref, Hy_ref = R.rx_fields_te_reference(omega, ry, y_node, z_len1, sigma1, E0, E1)
    np.testing.assert_allclose(np.asarray(Ex)[0] * wsum, Ex_ref, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(Hy)[0] * wsum, Hy_ref, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(Ex / Hy)[0], Ex_ref / Hy_ref, rtol=1e-12)

    Hz = F.rx_hz_te(omegas, mesh, jnp.asarray(full), rx)
    Hz_ref = R.rx_hz_te_reference(omega, ry, y_node, E0)
    np.testing.assert_allclose(np.asarray(Hz)[0], Hz_ref, rtol=1e-12)

    Ey, Hx = F.rx_fields_tm(omegas, mesh, jnp.asarray(sigma2d), jnp.asarray(full), rx)
    Ey_ref, Hx_ref = R.rx_fields_tm_reference(omega, ry, y_node, z_len1, sigma1, E0, E1)
    np.testing.assert_allclose(np.asarray(Ey)[0] * wsum, Ey_ref, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(Hx)[0] * wsum, Hx_ref, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(Ey / Hx)[0], Ey_ref / Hx_ref, rtol=1e-12)


def test_rho_pha_data_type():
    mesh, sigma2d, rx_loc, _, _ = layered_setup()
    freqs = np.array([1.0])
    data = make_data(rx_loc, freqs, comps=("RhoXY", "PhsXY", "RhoYX", "PhsYX"),
                     data_type="Rho_Pha")
    fwd = F.make_forward(mesh, data, F.SolveConfig(jnp.complex128, 0))
    pred = np.asarray(fwd.predict(jnp.asarray(sigma2d)))
    pred = pred.reshape(len(rx_loc), 4)
    np.testing.assert_allclose(pred[:, 0], 100.0, rtol=0.05)   # rho_xy
    np.testing.assert_allclose(pred[:, 1], 45.0, atol=1.5)     # phase_xy ~ 45 deg
    np.testing.assert_allclose(pred[:, 2], 100.0, rtol=0.05)   # rho_yx
    np.testing.assert_allclose(np.abs(pred[:, 3]), 135.0, atol=1.5)  # phase of -Z


def test_tipper_and_log10rho():
    """Tipper ~ 0 on a 1-D model, nonzero over a lateral contrast; log10Rho
    component equals log10 of the Rho component."""
    mesh, sigma2d, rx_loc, _, _ = layered_setup((100.0,))
    freqs = np.array([1.0, 0.1])
    cfg = F.SolveConfig(jnp.complex128, 0)

    data_t = make_data(rx_loc, freqs, comps=("ZXY", "TZY"),
                       data_type="Impedance_Tipper")
    fwd_t = F.make_forward(mesh, data_t, cfg)
    cube = np.asarray(fwd_t.response_cube(jnp.asarray(sigma2d)))
    T1d = cube[..., 1]
    Z1d = cube[..., 0]
    # 1-D model: vertical field ~ 0 => |T| << 1 (dimensionless)
    assert np.all(np.abs(T1d) < 2e-3), np.abs(T1d).max()

    # lateral conductor under the receiver line: tipper must respond
    sigma_a = sigma2d.copy()
    sigma_a[9:14, 6:16] = 1.0
    cube_a = np.asarray(fwd_t.response_cube(jnp.asarray(sigma_a)))
    assert np.abs(cube_a[..., 1]).max() > 50 * np.abs(T1d).max()
    # tipper is differentiable
    g = jax.grad(lambda s: jnp.sum(jnp.abs(fwd_t.response_cube(s)[..., 1]) ** 2))(
        jnp.asarray(sigma_a))
    assert np.all(np.isfinite(np.asarray(g)))

    data_r = make_data(rx_loc, freqs, comps=("RhoXY", "log10RhoXY", "PhsXY"),
                       data_type="Rho_Pha")
    fwd_r = F.make_forward(mesh, data_r, cfg)
    cube_r = np.asarray(fwd_r.response_cube(jnp.asarray(sigma2d)))
    np.testing.assert_allclose(cube_r[..., 1], np.log10(cube_r[..., 0]), rtol=1e-12)
    assert np.all(np.abs(cube_r[..., 0] - 100.0) / 100.0 < 0.05)
