"""Batched block-tridiagonal direct solver — the accelerator MUMPS replacement.

The reference factorises each per-(frequency, mode) complex-symmetric sparse
system with MUMPS LDL^T or Julia's sparse LU (mt2DTE.jl:47-55,
MUMPS/src/MUMPSfuncs.jl).  Instead of a sparse direct factorisation we
exploit the tensor-mesh structure: with nodes ordered y-fastest the interior
operator is block tridiagonal over z-lines, the diagonal blocks are
*tridiagonal* (y-coupling) and the off-diagonal blocks are *diagonal*
(z-coupling).  Block-Thomas elimination then reduces to a short ``lax.scan``
over z-lines of batched dense (ny-1)x(ny-1) inverses and matmuls, trivially
batched over (chain x frequency x mode); XLA hands the batched inverses to
the vendor batched-LU libraries.

The factorisation (the per-line inverse Schur complements) is computed once
and reused for the forward solve and the adjoint solve of the gradient,
mirroring the reference's factorisation reuse (compJacTMatVec.jl:224,295);
with a complex-symmetric operator the transpose solve *is* the forward solve.

Precision strategy: the factor/solve path runs in ``complex64`` (GPU
default) or ``complex128`` (CPU tests); symmetric diagonal equilibration plus
iterative refinement against the matrix-free operator recovers the accuracy
the sampler needs at complex64 speed.  Every matrix product passes
``precision=HIGHEST`` so float32/complex64 products never drop to TF32 on
GPUs that would otherwise allow it.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .. import mesh as M
from ..utils.host import real_dtype
from .blockinv import inv_nopivot

_HI = lax.Precision.HIGHEST


class InteriorSystem(NamedTuple):
    """Interior (Dirichlet-eliminated) operator in block-tridiagonal form.

    Shapes (leading batch dims allowed, broadcast together):
      diag : (..., nzi, nyi) complex — main diagonal (includes i*omega*m)
      offy : (..., nzi, nyi-1) real  — y-coupling  A[(j,i),(j,i+1)] = -offy? (sign: stored as the positive edge coefficient; the matrix entry is ``-offy``)
      offz : (..., nzi-1, nyi) real  — z-coupling (matrix entry is ``-offz``)
    """

    diag: jax.Array
    offy: jax.Array
    offz: jax.Array


def interior_system(st: M.Stencil, omega, dtype=None) -> InteriorSystem:
    """Extract the interior block-tridiagonal system from stencil coefficients.

    Interior nodes are full-grid nodes (j=1..nz-1, i=1..ny-1); entries follow
    directly from the 5-point stencil of :func:`hmcmt2d.mesh.apply_A`.
    """
    cy, cz, m = st.cy, st.cz, st.m
    d_real = (
        cy[..., 1:-1, :-1] + cy[..., 1:-1, 1:]      # left + right y-edges
        + cz[..., :-1, 1:-1] + cz[..., 1:, 1:-1]    # up + down z-edges
    )
    d_imag = omega * m[..., 1:-1, 1:-1]
    if dtype is None:
        rdt = d_real.dtype
    else:
        rdt = real_dtype(dtype)
    # build the complex diagonal from real/imag parts directly so no
    # complex128 intermediate is created for a complex64 solve
    d_real, d_imag = jnp.broadcast_arrays(d_real.astype(rdt), d_imag.astype(rdt))
    diag = lax.complex(d_real, d_imag)
    offy = cy[..., 1:-1, 1:-1].astype(rdt)  # edge between interior i and i+1
    offz = cz[..., 1:-1, 1:-1].astype(rdt)  # edge between interior j and j+1
    return InteriorSystem(diag, offy, offz)


def apply_interior(sys: InteriorSystem, x: jax.Array) -> jax.Array:
    """Matrix-free application of the interior operator to x (..., nzi, nyi)."""
    diag, offy, offz = sys
    out = diag * x
    zy = jnp.zeros_like(x[..., :, :1])
    left = jnp.concatenate([zy, offy * x[..., :, :-1]], axis=-1)
    right = jnp.concatenate([offy * x[..., :, 1:], zy], axis=-1)
    zz = jnp.zeros_like(x[..., :1, :])
    up = jnp.concatenate([zz, offz * x[..., :-1, :]], axis=-2)
    down = jnp.concatenate([offz * x[..., 1:, :], zz], axis=-2)
    return out - left - right - up - down


class BTFactor(NamedTuple):
    """Block-Thomas factorisation: per-line inverse Schur complements."""

    G: jax.Array     # (..., nzi, nyi, nyi) inverse Schur complements
    offz: jax.Array  # (..., nzi-1, nyi) retained z-coupling


def _dense_blocks(diag: jax.Array, offy: jax.Array) -> jax.Array:
    """Assemble dense tridiagonal blocks T_j: (..., nzi, nyi, nyi)."""
    nyi = diag.shape[-1]
    eye = jnp.eye(nyi, dtype=diag.dtype)
    up = jnp.eye(nyi, k=1, dtype=diag.dtype)
    lo = jnp.eye(nyi, k=-1, dtype=diag.dtype)
    pad = jnp.zeros_like(offy[..., :1])
    offy_p = jnp.concatenate([offy, pad], axis=-1).astype(diag.dtype)
    T = diag[..., :, None] * eye - offy_p[..., :, None] * up - offy_p[..., None, :] * lo
    return T


def bt_factor(sys: InteriorSystem, inv_fn=jnp.linalg.inv) -> BTFactor:
    """Factorise: scan over z-lines computing G_j = inv(T_j - C G_{j-1} C).

    ``inv_fn`` selects the batched-inverse engine: XLA's pivoted LU
    (``jnp.linalg.inv``) or the matmul-only blocked Gauss-Jordan
    (:func:`hmcmt2d.ops.blockinv.inv_nopivot`).
    """
    diag, offy, offz = sys
    T = _dense_blocks(diag, offy)                      # (..., nzi, nyi, nyi)
    nzi = T.shape[-3]
    T_m = jnp.moveaxis(T, -3, 0)                       # (nzi, ..., nyi, nyi)
    offz_m = jnp.moveaxis(offz.astype(diag.dtype), -2, 0)  # (nzi-1, ..., nyi)

    def inv_c(A):
        # one flat batch axis for the batched-inverse library call
        shape = A.shape
        return inv_fn(A.reshape((-1,) + shape[-2:])).reshape(shape)

    G0 = inv_c(T_m[0])

    def step(G_prev, inputs):
        T_j, c_prev = inputs
        S = T_j - c_prev[..., :, None] * G_prev * c_prev[..., None, :]
        G = inv_c(S)
        return G, G

    _, Gs = lax.scan(step, G0, (T_m[1:], offz_m))
    G = jnp.concatenate([G0[None], Gs], axis=0)        # (nzi, ..., nyi, nyi)
    return BTFactor(jnp.moveaxis(G, 0, -3), offz)


def bt_solve(fac: BTFactor, b: jax.Array) -> jax.Array:
    """Solve A x = b given the factorisation; b is (..., nzi, nyi).

    Because A is complex *symmetric*, this routine also solves the transposed
    system — the property the adjoint gradient relies on.
    """
    G, offz = fac
    dtype = G.dtype
    b = b.astype(dtype)
    G_m = jnp.moveaxis(G, -3, 0)                       # (nzi, ..., nyi, nyi)
    c_m = jnp.moveaxis(offz.astype(dtype), -2, 0)      # (nzi-1, ..., nyi)
    b_m = jnp.moveaxis(b, -2, 0)                       # (nzi, ..., nyi)

    y0 = _mv(G_m[0], b_m[0])

    def fwd(y_prev, inputs):
        Gj, cj, bj = inputs
        y = _mv(Gj, bj + cj * y_prev)                   # matrix entry is -offz
        return y, y

    _, ys = lax.scan(fwd, y0, (G_m[1:], c_m, b_m[1:]))
    y = jnp.concatenate([y0[None], ys], axis=0)        # (nzi, ..., nyi)

    xN = y[-1]

    def bwd(x_next, inputs):
        Gj, cj, yj = inputs
        x = yj + _mv(Gj, cj * x_next)
        return x, x

    _, xs = lax.scan(bwd, xN, (G_m[:-1][::-1], c_m[::-1], y[:-1][::-1]))
    x = jnp.concatenate([xN[None], xs], axis=0)[::-1]
    return jnp.moveaxis(x, 0, -2)


class BTFactorBlocked(NamedTuple):
    """Block-Thomas factorisation augmented for the grouped (parallel-prefix)
    solve: z-lines are grouped in blocks of ``g``; within-group prefix
    products of the recurrence matrices are precomputed at factor time so
    each triangular sweep needs ~(g + nzi/g) sequential steps instead of nzi.

    The forward sweep is the affine recurrence  y_j = u_j + H_j y_{j-1}
    (u_j = G_j b_j, H_j = G_j diag(c_{j-1})); the backward sweep is its
    mirror with H~_j = G_j diag(c_j).  Grouped evaluation: (A) scan the g
    in-group steps with zero incoming carry, all groups batched; (B) scan
    the carries across the nzi/g groups using the full-group products; (C)
    one batched fix-up y = z + Q @ carry.
    """

    G: jax.Array      # (..., N, q, q) padded inverse Schur complements
    offz: jax.Array   # (..., nzi-1, q) original couplings (refinement apply)
    cf: jax.Array     # (..., N, q) forward coupling c_{j-1} (0 at j=0 / pad)
    cb: jax.Array     # (..., N, q) backward coupling c_j (0 at j=N-1 / pad)
    Qf: jax.Array     # (..., N, q, q) forward prefix products Q_{k,i}
    Qb: jax.Array     # (..., N, q, q) backward prefix products (reversed order)


_BT_GROUP = 8


def _group_prefix(H: jax.Array, g: int) -> jax.Array:
    """Within-group inclusive prefix products Q_{k,i} = H_{kg+i} ... H_{kg}.

    H is (..., N, q, q) with N divisible by g; sequential over the g
    in-group positions (g-1 batched matmuls), batched over groups.
    """
    shape = H.shape
    N, q = shape[-3], shape[-1]
    K = N // g
    Hk = H.reshape(shape[:-3] + (K, g, q, q))
    Qs = [Hk[..., 0, :, :]]
    for i in range(1, g):
        Qs.append(jnp.matmul(Hk[..., i, :, :], Qs[-1], precision=_HI))
    Q = jnp.stack(Qs, axis=-3)
    return Q.reshape(shape)


def bt_factor_blocked(sys: InteriorSystem, inv_fn=jnp.linalg.inv,
                      g: int = _BT_GROUP) -> BTFactorBlocked:
    """Thomas factorisation + grouped-solve prefix products."""
    base = bt_factor(sys, inv_fn=inv_fn)
    G, offz = base.G, base.offz
    q = G.shape[-1]
    nzi = G.shape[-3]
    N = -(-nzi // g) * g
    batch = G.shape[:-3]
    c = offz.astype(G.dtype)
    zline = jnp.zeros(batch + (1, q), G.dtype)
    # c_prev aligned to lines: c_{-1} = 0; pad the tail with zeros
    cf = jnp.concatenate([zline, c] + [jnp.zeros(batch + (N - nzi, q), G.dtype)]
                         * (1 if N > nzi else 0), axis=-2)
    cb = jnp.concatenate([c, zline] + [jnp.zeros(batch + (N - nzi, q), G.dtype)]
                         * (1 if N > nzi else 0), axis=-2)
    if N > nzi:
        G = jnp.concatenate(
            [G, jnp.zeros(batch + (N - nzi, q, q), G.dtype)], axis=-3)
    Hf = G * cf[..., None, :]
    Hb = G * cb[..., None, :]
    Qf = _group_prefix(Hf, g)
    Qb = _group_prefix(Hb[..., ::-1, :, :], g)
    return BTFactorBlocked(G=G, offz=offz, cf=cf, cb=cb, Qf=Qf, Qb=Qb)


def _blocked_affine_scan(u: jax.Array, G: jax.Array, c: jax.Array,
                         Q: jax.Array, g: int) -> jax.Array:
    """Solve y_j = u_j + (G_j diag(c_j)) y_{j-1}, j = 0..N-1 (y_{-1} = 0),
    in ~(g + N/g) sequential steps.  All inputs padded to N = K*g.
    """
    q = u.shape[-1]
    N = u.shape[-2]
    K = N // g
    batch = u.shape[:-2]
    uk = u.reshape(batch + (K, g, q))
    Gk = G.reshape(batch + (K, g, q, q))
    ck = c.reshape(batch + (K, g, q))
    Qk = Q.reshape(batch + (K, g, q, q))

    # (A) in-group scan with zero incoming carry, groups batched
    def stepA(z_prev, i):
        z = uk[..., i, :] + _mv(Gk[..., i, :, :], ck[..., i, :] * z_prev)
        return z, z

    z0 = uk[..., 0, :]
    _, zs = lax.scan(stepA, z0, jnp.arange(1, g))
    z = jnp.concatenate([z0[None], zs], axis=0)       # (g, ..., K, q)
    z = jnp.moveaxis(z, 0, -2)                        # (..., K, g, q)

    # (B) carry scan across groups: carry_k = z_{k,g-1} + P_k carry_{k-1}
    P = Qk[..., g - 1, :, :]                          # full-group products
    zlast = z[..., g - 1, :]
    P_m = jnp.moveaxis(P, -3, 0)                      # (K, ..., q, q)
    zl_m = jnp.moveaxis(zlast, -2, 0)

    def stepB(carry, inp):
        Pk, zk = inp
        cy = zk + _mv(Pk, carry)
        return cy, cy

    zero = jnp.zeros(batch + (q,), u.dtype)
    _, carries = lax.scan(stepB, zero, (P_m, zl_m))   # carries[k] = y at group end
    # incoming carry per group: 0 for k=0, carries[k-1] otherwise
    cin = jnp.concatenate([zero[None], carries[:-1]], axis=0)
    cin = jnp.moveaxis(cin, 0, -2)                    # (..., K, q)

    # (C) fix-up: y_{k,i} = z_{k,i} + Q_{k,i} cin_k   (one batched matvec)
    y = z + jnp.einsum("...kiab,...kb->...kia", Qk, cin, precision=_HI)
    return y.reshape(batch + (N, q))


def bt_solve_blocked(fac: BTFactorBlocked, b: jax.Array,
                     g: int = _BT_GROUP) -> jax.Array:
    """Grouped triangular sweeps; same result as :func:`bt_solve`."""
    G, cf, cb, Qf, Qb = fac.G, fac.cf, fac.cb, fac.Qf, fac.Qb
    q = G.shape[-1]
    N = G.shape[-3]
    nzi = b.shape[-2]
    b = b.astype(G.dtype)
    if N > nzi:
        b = jnp.concatenate(
            [b, jnp.zeros(b.shape[:-2] + (N - nzi, q), G.dtype)], axis=-2)

    # forward: y_j = G_j b_j + H_j y_{j-1}; fold G_j b_j into the scan's u
    u = _mv(G, b)
    y = _blocked_affine_scan(u, G, cf, Qf, g)

    # backward: x_j = y_j + H~_j x_{j+1} — the same affine recurrence on the
    # reversed line order with additive term y (no extra G application)
    yr = y[..., ::-1, :]
    Gr = G[..., ::-1, :, :]
    cr = cb[..., ::-1, :]
    xr = _blocked_affine_scan(yr, Gr, cr, Qb, g)
    x = xr[..., ::-1, :]
    return x[..., :nzi, :]


def equilibrate(sys: InteriorSystem) -> tuple[InteriorSystem, jax.Array]:
    """Symmetric diagonal scaling s A s with s = 1/sqrt(|diag|).

    Compresses the enormous dynamic range of the TM operator (1/sigma spans
    ~10 decades with air at 1e-8 S/m) so a complex64 factorisation stays
    accurate; exact for the solution after unscaling.
    """
    s = lax.rsqrt(jnp.abs(sys.diag))
    diag = sys.diag * (s * s)
    sy = s[..., :, 1:] * s[..., :, :-1]
    sz = s[..., 1:, :] * s[..., :-1, :]
    return InteriorSystem(diag, sys.offy * sy, sys.offz * sz), s


def direct_solve(sys: InteriorSystem, b: jax.Array, dtype=None) -> jax.Array:
    """One-shot equilibrated factor+solve (no reuse); b is (..., nzi, nyi)."""
    ssys, s = equilibrate(sys)
    if dtype is not None:
        ssys = InteriorSystem(ssys.diag.astype(dtype), ssys.offy, ssys.offz)
    fac = bt_factor(ssys)
    return s * bt_solve(fac, s * b)


class BCRLevel(NamedTuple):
    """One block-cyclic-reduction level: inverses of the eliminated (0-based
    even) diagonal blocks plus their left/right couplings.

    Level 0 keeps the couplings in their natural *diagonal* form (the z-edge
    coupling of the 5-point stencil is diagonal): ``L``/``R`` are (..., ne, q)
    vectors there, dense (..., ne, q, q) blocks at deeper levels.  The final
    level holds the single remaining block inverse with ``L = R = None``.
    """

    Dinv: jax.Array
    L: jax.Array | None
    R: jax.Array | None


class BCRFactor(NamedTuple):
    """Block cyclic reduction factorisation (log2-depth MUMPS replacement).

    Same mathematical object as :class:`BTFactor` (a reusable direct
    factorisation of the block-tridiagonal interior operator), but built in
    ceil(log2(nzi)) sequential rounds of *batched* inverses and matmuls
    instead of nzi sequential Schur steps.  Being
    complex-symmetric throughout, it also solves the transposed system.
    """

    levels: tuple


def _T(x):
    return jnp.swapaxes(x, -1, -2)


def _mm(A, B):
    return jnp.matmul(A, B, precision=_HI)


def _mv(Mat, v):
    return jnp.einsum("...ab,...b->...a", Mat, v, precision=_HI)


def _mtv(Mat, v):
    """M^T v without materialising the transpose."""
    return jnp.einsum("...ba,...b->...a", Mat, v, precision=_HI)


def _inv3(A):
    """Batched inverse with all batch dims collapsed to one."""
    shape = A.shape
    return jnp.linalg.inv(A.reshape((-1,) + shape[-2:])).reshape(shape)


def bcr_factor(sys: InteriorSystem, inv_fn=None) -> BCRFactor:
    """Cyclic reduction of the interior block-tridiagonal system.

    Pads the nzi z-lines to N = 2^m - 1 with identity blocks / zero couplings
    (decoupled), then eliminates the 0-based-even blocks level by level:
    for kept (odd) j,
        D'_j = D_j - C_{j-1}^T Dinv_{j-1} C_{j-1} - C_j Dinv_{j+1} C_j^T
        C'_(j-1)/2 = C_j Dinv_{j+1} C_{j+1}
    (matrix blocks (j, j+1) are -C_j; complex symmetry is preserved).
    """
    diag, offy, offz = sys
    T = _dense_blocks(diag, offy)                      # (..., nzi, q, q)
    nzi, q = T.shape[-3], T.shape[-1]
    if inv_fn is None:
        inv_fn = _inv3
    m = nzi.bit_length()                               # smallest m: 2^m-1 >= nzi
    N = 2 ** m - 1
    batch = T.shape[:-3]
    if N == 1:
        return BCRFactor((BCRLevel(inv_fn(T), None, None),))

    if N > nzi:
        eyep = jnp.broadcast_to(jnp.eye(q, dtype=T.dtype),
                                batch + (N - nzi, q, q))
        T = jnp.concatenate([T, eyep], axis=-3)
    c = offz.astype(T.dtype)                           # (..., nzi-1, q) diagonal couplings
    if N - 1 > nzi - 1:
        zpad = jnp.zeros(batch + (N - nzi, q), T.dtype)
        c = jnp.concatenate([c, zpad], axis=-2)

    levels = []

    # ---- level 0: diagonal couplings ----------------------------------
    Dl, cl = T, c
    nl = N
    ev_D = Dl[..., 0::2, :, :]
    Dinv = inv_fn(ev_D)                                # (..., ne, q, q)
    zv = jnp.zeros_like(cl[..., :1, :])
    L = jnp.concatenate([zv, cl[..., 1::2, :]], axis=-2)   # C_{i-1} for even i
    R = jnp.concatenate([cl[..., 0::2, :], zv], axis=-2)   # C_i for even i
    levels.append(BCRLevel(Dinv, L, R))

    cL = cl[..., 0::2, :]                              # C_{j-1}, kept j odd
    cR = cl[..., 1::2, :]                              # C_j
    k0 = Dinv[..., : (nl - 1) // 2, :, :]              # Dinv_{j-1}
    k1 = Dinv[..., 1:, :, :]                           # Dinv_{j+1}
    Dn = (Dl[..., 1::2, :, :]
          - cL[..., :, None] * k0 * cL[..., None, :]
          - cR[..., :, None] * k1 * cR[..., None, :])
    # C'_k = diag(c_j) Dinv_{j+1} diag(c_{j+1}):  c index of j = odd -> cR,
    # of j+1 = even (next pair's left) -> cL shifted by one kept block
    Cn = cR[..., :-1, :, None] * k1[..., :-1, :, :] * cL[..., 1:, None, :]

    # ---- dense levels ---------------------------------------------------
    Dl, Cl = Dn, Cn
    while Dl.shape[-3] > 1:
        nl = Dl.shape[-3]
        Dinv = inv_fn(Dl[..., 0::2, :, :])
        zb = jnp.zeros_like(Cl[..., :1, :, :])
        L = jnp.concatenate([zb, Cl[..., 1::2, :, :]], axis=-3)
        R = jnp.concatenate([Cl[..., 0::2, :, :], zb], axis=-3)
        levels.append(BCRLevel(Dinv, L, R))

        CL = Cl[..., 0::2, :, :]
        CR = Cl[..., 1::2, :, :]
        k0 = Dinv[..., : (nl - 1) // 2, :, :]
        k1 = Dinv[..., 1:, :, :]
        Dn = (Dl[..., 1::2, :, :]
              - _mm(_T(CL), _mm(k0, CL))
              - _mm(CR, _mm(k1, _T(CR))))
        if nl > 3:   # at nl == 3 a single block remains: no couplings left
            Cn = _mm(CR[..., :-1, :, :], _mm(k1[..., :-1, :, :], Cl[..., 2::2, :, :]))
        else:
            Cn = Cl[..., :0, :, :]
        Dl, Cl = Dn, Cn

    levels.append(BCRLevel(inv_fn(Dl), None, None))
    return BCRFactor(tuple(levels))


def bcr_solve(fac: BCRFactor, b: jax.Array) -> jax.Array:
    """Solve given a :func:`bcr_factor` result; b is (..., nzi, q).

    Forward rhs reduction, single-block solve, then log2-depth back
    substitution.  Solves the transposed system too (complex symmetry).
    """
    levels = fac.levels
    dtype = levels[0].Dinv.dtype
    nzi, q = b.shape[-2], b.shape[-1]
    N = 2 * levels[0].Dinv.shape[-3] - 1
    b = b.astype(dtype)
    if N > nzi:
        b = jnp.concatenate(
            [b, jnp.zeros(b.shape[:-2] + (N - nzi, q), dtype)], axis=-2)

    ys = []
    bl = b
    for lev in levels[:-1]:
        Dinv, L, R = lev
        y = _mv(Dinv, bl[..., 0::2, :])
        ys.append((bl, y))
        if L.ndim == y.ndim:           # level 0: diagonal couplings
            # b'_j = b_j + C_{j-1}^T y_{j-1} + C_j y_{j+1};  C_{j-1} = R of
            # eliminated j-1, C_j = L of eliminated j+1; diagonal -> elementwise
            bl = (bl[..., 1::2, :]
                  + R[..., :-1, :] * y[..., :-1, :]
                  + L[..., 1:, :] * y[..., 1:, :])
        else:
            bl = (bl[..., 1::2, :]
                  + _mtv(R[..., :-1, :, :], y[..., :-1, :])
                  + _mv(L[..., 1:, :, :], y[..., 1:, :]))

    x = _mv(levels[-1].Dinv, bl)

    for lev, (bl_full, y) in zip(levels[-2::-1], ys[::-1]):
        Dinv, L, R = lev
        ne = Dinv.shape[-3]
        zx = jnp.zeros_like(x[..., :1, :])
        xl = jnp.concatenate([zx, x], axis=-2)         # x_{i-1} for even i
        xr = jnp.concatenate([x, zx], axis=-2)         # x_{i+1}
        if L.ndim == y.ndim:           # diagonal couplings
            rhs = L * xl + R * xr
        else:
            rhs = _mtv(L, xl) + _mv(R, xr)
        xe = y + _mv(Dinv, rhs)
        # interleave eliminated (even) and kept (odd) blocks
        nl = 2 * ne - 1
        out = jnp.zeros(xe.shape[:-2] + (nl, q), dtype)
        out = out.at[..., 0::2, :].set(xe)
        out = out.at[..., 1::2, :].set(x)
        x = out

    return x[..., :nzi, :]


class Factorization(NamedTuple):
    """Equilibrated factorisation bundle reusable across multiple solves.

    ``fac`` is a :class:`BTFactor` (block Thomas, nzi-sequential; the GPU
    default), a :class:`BTFactorBlocked` (block Thomas with grouped sweeps) or
    a :class:`BCRFactor` (cyclic reduction, log2(nzi)-sequential: 6 batched-
    inverse rounds instead of 55 on the flagship mesh).
    """

    fac: BTFactor | BTFactorBlocked | BCRFactor
    s: jax.Array  # equilibration scaling


def factorize(sys: InteriorSystem, dtype=None, method: str = "bcr",
              inv_method: str = "lu") -> Factorization:
    ssys, s = equilibrate(sys)
    if dtype is not None:
        rdt = real_dtype(dtype)
        ssys = InteriorSystem(ssys.diag.astype(dtype), ssys.offy.astype(rdt),
                              ssys.offz.astype(rdt))
    inv_fn = inv_nopivot if inv_method == "gj" else jnp.linalg.inv
    if method == "bcr":
        fac = bcr_factor(ssys, inv_fn=inv_fn)
    elif method == "thomas_blocked":
        fac = bt_factor_blocked(ssys, inv_fn=inv_fn)
    elif method == "thomas":
        fac = bt_factor(ssys, inv_fn=inv_fn)
    else:
        raise ValueError(f"unknown solver method {method!r}")
    return Factorization(fac, s)


def factor_solve(f: Factorization, b: jax.Array) -> jax.Array:
    if isinstance(f.fac, BCRFactor):
        return f.s * bcr_solve(f.fac, f.s * b)
    if isinstance(f.fac, BTFactorBlocked):
        return f.s * bt_solve_blocked(f.fac, f.s * b)
    return f.s * bt_solve(f.fac, f.s * b)


def refined_solve(sys: InteriorSystem, f: Factorization, b: jax.Array, iters: int = 2) -> jax.Array:
    """Iterative refinement: factor in low precision, residual via the exact
    (higher-precision) matrix-free operator ``apply_interior``.

    ``sys`` is the unscaled system in the accumulation dtype; ``f`` a
    (possibly lower-precision or stale) factorisation.
    """
    x = factor_solve(f, b).astype(b.dtype)

    def step(x, _):
        r = b - apply_interior(sys, x)
        dx = factor_solve(f, r)
        return x + dx.astype(b.dtype), None

    x, _ = lax.scan(step, x, None, length=iters)
    return x
