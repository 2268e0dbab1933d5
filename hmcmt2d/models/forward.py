"""2-D MT forward modelling: TE/TM Dirichlet solves and receiver responses.

Accelerator redesign of the reference forward driver
(HMCMT/src/MTFwdSolver/MT2DFwdSolver.jl, mt2DTE.jl, mt2DTM.jl):

* boundary conditions from the vectorised 1-D analytic propagator — all
  (ny+1) boundary columns and all frequencies in one batched call (the
  reference loops, getBoundaryMT2DTE, mt2DTE.jl:100-134);
* the interior Dirichlet solve runs through ``lax.custom_linear_solve`` with
  a block-Thomas factorisation that is computed once and reused by the
  forward *and* the adjoint (gradient) solve — the implicit-function-theorem
  equivalent of the reference's factorisation reuse in ``compJacTMatVec``
  (compJacTMatVec.jl:224,295);
* surface-field reconstruction (the quarter/half-point Ampere/Faraday
  corrections of compFieldsAtRxTE/TM, mt2DTE.jl:153-210, mt2DTM.jl:152-210)
  and response mapping (compMTRespTE/TM) as pure vectorised functions, so
  their derivatives — the reference's entire hand-rolled receiver
  sensitivity layer (dataFuncSens.jl, MT1DSensitivity.jl) — come from
  autodiff.

Everything is differentiable w.r.t. the cell conductivity ``sigma2d``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..constants import MU0
from .. import mesh as M
from ..ops import mt1d
from ..ops import solver as S
from ..utils.host import real_dtype as _host_real_dtype
from .data import MTData


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Precision and engine policy for the PDE solves.

    ``solve_dtype`` is the factor/solve dtype; ``refine_iters`` steps of
    iterative refinement against the matrix-free operator recover the
    accuracy a complex64 factorisation loses.  CPU tests run complex128
    directly; :func:`default_config` gives each backend's production policy.
    """

    solve_dtype: type = jnp.complex128
    refine_iters: int = 0
    # "thomas" (block Thomas, nzi-sequential, least memory: the GPU
    # default), "thomas_blocked" (block Thomas with grouped sweeps) or "bcr"
    # (block cyclic reduction, log2(nzi)-sequential: the CPU test default)
    solver_method: str = "bcr"
    # batched-inverse engine inside the factorisation: "lu" (XLA pivoted
    # LU, the default) or "gj" (blocked unpivoted Gauss-Jordan, pure
    # matmuls; stable here because the equilibrated operator has
    # positive-definite real part, see ops/blockinv.py)
    inv_method: str = "lu"
    # refinement iterations when solving with a STALE trajectory-amortised
    # factorisation (see solve_dirichlet's ``fac``); sized so the worst
    # measured contraction (~0.45/iter at 8-step drift) still reaches
    # ~1e-4 relative and refactoring every ~4 steps reaches ~1e-7
    stale_refine_iters: int = 10

    @property
    def real_dtype(self):
        return _host_real_dtype(self.solve_dtype)


def default_config() -> SolveConfig:
    """The production solve policy of the current JAX backend.

    * ``cpu``: complex128 block cyclic reduction when x64 is enabled (the
      exact reference the tests use), else complex64 block Thomas with one
      refinement step.
    * ``gpu``: complex128 block Thomas with batched-LU inverses (XLA hands
      them to cuBLAS/cuSOLVER), no refinement; needs x64
      (:func:`enable_x64_for_backend`).  complex64 with 1-3 refinement
      steps missed the 1e-4 relative potential bar against this reference
      at the flagship size on an H100, and complex128 costs about as much
      as complex64 with three steps there.

    Any other backend raises: there is no silent default.
    """
    backend = jax.default_backend()
    if backend == "cpu":
        if jax.config.jax_enable_x64:
            return SolveConfig(jnp.complex128, 0)
        return SolveConfig(jnp.complex64, 1, "thomas")
    if backend == "gpu":
        if not jax.config.jax_enable_x64:
            raise RuntimeError("the GPU solve policy is complex128 and needs "
                               "jax_enable_x64 (enable_x64_for_backend)")
        return SolveConfig(jnp.complex128, 0, "thomas", "lu")
    raise RuntimeError(f"no solve configuration for JAX backend {backend!r}; "
                       "supported backends are 'cpu' and 'gpu'")


def enable_x64_for_backend() -> None:
    """Enable ``jax_enable_x64`` on the GPU, whose :func:`default_config`
    solves in complex128.  x64 is global to the process: call this before
    creating arrays."""
    if jax.default_backend() == "gpu":
        jax.config.update("jax_enable_x64", True)


class RxInterp(NamedTuple):
    """Static receiver-layer info and linear interpolation weights.

    Mirrors the receiver-layer discovery of mt2DTE.jl:64-71 and the linear
    interpolation of mt2DTE.jl:195-207 (weights normalised here; the
    reference's unnormalised weights cancel in the E/H ratio).
    """

    zid: int            # z-node index of the receiver level
    idx: np.ndarray     # (nrx,) left node index in y
    w0: np.ndarray      # (nrx,) weight of node idx
    w1: np.ndarray      # (nrx,) weight of node idx+1
    cidx: np.ndarray    # (nrx,) left cell-centre index (tipper Hz interp)
    c0: np.ndarray      # (nrx,) weight of centre cidx
    c1: np.ndarray      # (nrx,) weight of centre cidx+1


def _interp1d(x_grid: np.ndarray, x: np.ndarray):
    idx = np.searchsorted(x_grid, x, side="right") - 1
    idx = np.clip(idx, 0, len(x_grid) - 2)
    d1 = x - x_grid[idx]
    d2 = x_grid[idx + 1] - x
    w = d1 + d2
    return idx, d2 / w, d1 / w


def make_rx_interp(mesh: M.TensorMesh2D, rx_loc: np.ndarray) -> RxInterp:
    y_node = np.asarray(mesh.y_node())
    z_node = np.asarray(mesh.z_node())
    z_rx = float(rx_loc[0, 1])
    hits = np.nonzero(np.abs(z_node - z_rx) < 0.1)[0]
    if len(hits) == 0:
        raise ValueError("receivers must sit on a z-node level (no topography)")
    zid = int(hits[0])
    ry = np.asarray(rx_loc[:, 0], float)
    idx, w0, w1 = _interp1d(y_node, ry)
    y_center = 0.5 * (y_node[:-1] + y_node[1:])
    cidx, c0, c1 = _interp1d(y_center, np.clip(ry, y_center[0], y_center[-1]))
    return RxInterp(zid=zid, idx=idx, w0=w0, w1=w1, cidx=cidx, c0=c0, c1=c1)


def boundary_profiles(mesh: M.TensorMesh2D, sigma2d: jax.Array) -> jax.Array:
    """1-D conductivity profiles for all boundary columns: (..., ny+1, nz).

    Row 0 = left column, row ny = right column, rows 1..ny-1 = the
    y-width-weighted averages used for the bottom boundary
    (mt2DTE.jl:115-131).  ``sigma2d`` may carry leading batch (chain) axes."""
    dy = mesh.y_len
    left = sigma2d[..., :, :1]
    right = sigma2d[..., :, -1:]
    mid = (sigma2d[..., :, :-1] * dy[:-1] + sigma2d[..., :, 1:] * dy[1:]) / (dy[:-1] + dy[1:])
    # columns: [left, mid_1..mid_{ny-1}, right] -> swap to (..., ny+1, nz)
    cols = jnp.concatenate([left, mid, right], axis=-1)
    return jnp.swapaxes(cols, -1, -2)


def _bc_from_profile_field(mesh, f, dtype):
    """Scatter normalised 1-D profile fields (..., ny+1, nz+1) onto the
    Dirichlet boundary ring of the node grid -> (..., nz+1, ny+1)."""
    ny, nz = mesh.ny, mesh.nz
    f = f / f[..., :1]                                     # normalise to 1 at top
    bc = jnp.zeros(f.shape[:-2] + (nz + 1, ny + 1), dtype)
    one = jnp.ones((), dtype)
    bc = bc.at[..., 0, :].set(one)                         # top (mt2DTE.jl:112)
    bc = bc.at[..., 1:, 0].set(f[..., 0, 1:])              # left
    bc = bc.at[..., 1:, ny].set(f[..., ny, 1:])            # right
    bc = bc.at[..., nz, 1:ny].set(f[..., 1:ny, nz])        # bottom interior
    return bc


def boundary_grids_both(mesh: M.TensorMesh2D, sigma2d: jax.Array,
                        omegas: jax.Array, dtype) -> jax.Array:
    """TE and TM Dirichlet boundary grids from ONE 1-D propagation.

    ``analytic_field(with_h=True)`` yields both E (TE boundary) and H (TM
    boundary) per column profile, so the merged-mode solve needs a single
    batched propagator call (the reference runs getBoundaryMT2DTE and
    getBoundaryMT2DTM separately).  Returns (nfreq, ..., 2, nz+1, ny+1) with
    mode axis [TE, TM]; ``...`` = any leading batch (chain) axes of sigma2d.
    """
    profiles = boundary_profiles(mesh, sigma2d)            # (..., ny+1, nz)
    om = omegas.reshape((-1,) + (1,) * profiles.ndim)
    e, h = mt1d.analytic_field(om, profiles[None], mesh.z_len,
                               with_h=True, dtype=dtype)   # (nfreq, ..., ny+1, nz+1)
    bc_te = _bc_from_profile_field(mesh, e, dtype)
    bc_tm = _bc_from_profile_field(mesh, h, dtype)
    return jnp.stack([bc_te, bc_tm], axis=-3)


def boundary_grid(mesh: M.TensorMesh2D, sigma2d: jax.Array, omegas: jax.Array,
                  mode: str, dtype) -> jax.Array:
    """Dirichlet boundary values on the full node grid: (nfreq, ..., nz+1, ny+1).

    Top boundary is 1, left/right columns carry the normalised 1-D analytic
    field at every depth node, and the bottom row carries the normalised
    bottom value of each column profile (getBoundaryMT2DTE/TM)."""
    profiles = boundary_profiles(mesh, sigma2d)            # (..., ny+1, nz)
    om = omegas.reshape((-1,) + (1,) * profiles.ndim)
    if mode == "TE":
        f = mt1d.analytic_field(om, profiles[None], mesh.z_len, dtype=dtype)
    else:
        _, f = mt1d.analytic_field(om, profiles[None], mesh.z_len, with_h=True, dtype=dtype)
    return _bc_from_profile_field(mesh, f, dtype)


def _cast_stencil(st: M.Stencil, rdt) -> M.Stencil:
    return M.Stencil(st.cy.astype(rdt), st.cz.astype(rdt), st.m.astype(rdt))


def solve_dirichlet(st: M.Stencil, omegas: jax.Array, bc: jax.Array,
                    cfg: SolveConfig, fac=None) -> jax.Array:
    """Solve A(omega) u = 0 with Dirichlet boundary bc for every frequency.

    ``bc`` is (nfreq, ..., nz+1, ny+1) with optional extra batch axes between
    frequency and the grid (the merged-mode path passes (nfreq, 2, nz+1,
    ny+1) with the TE/TM stencils stacked on the matching ``st`` axis — one
    batched factorisation covers every (freq, mode) system, halving the
    latency-bound sequential solve depth vs per-mode solves).

    ``fac`` (optional) supplies a STALE :class:`Factorization` built at a
    nearby model (the trajectory-amortised fast path): the solve then runs
    ``cfg.stale_refine_iters`` preconditioned-refinement iterations against
    the exact current operator instead of factorising afresh — factorisation
    is the dominant cost, so leapfrog trajectories that refactor every few
    steps get a several-fold speedup at unchanged solution accuracy.

    Returns full node fields shaped like ``bc``.  Differentiable w.r.t. the
    stencil coefficients and bc via implicit differentiation; the adjoint
    solve reuses the (possibly stale) factorisation (complex-symmetric
    operator, so its transpose solve is itself).
    """
    rdt = cfg.real_dtype
    st_c = _cast_stencil(st, rdt)
    n_extra = bc.ndim - 3          # batch axes between frequency and grid
    om = omegas.astype(rdt).reshape(omegas.shape[:1] + (1,) * (n_extra + 2))
    bc = bc.astype(cfg.solve_dtype)

    # interior system, batched over frequency (and any extra axes)
    sys = S.interior_system(st_c, om, dtype=cfg.solve_dtype)
    # rhs = -A_io * bc (mt2DTE.jl:44) via the full-grid apply: the interior of
    # bc is zero, so the interior rows of A@bc are exactly A_io @ bc_boundary
    rhs = -M.interior(M.apply_A(st_c, om, bc))

    if fac is None:
        # factorise the gradient-stopped system: the factorisation only ever
        # acts as a (re)usable preconditioner/solver inside
        # custom_linear_solve — implicit differentiation never needs its
        # derivative — and ops without input tangents skip JVP tracing
        # entirely
        sys_ng = jax.tree_util.tree_map(lax.stop_gradient, sys)
        fac = S.factorize(sys_ng, dtype=cfg.solve_dtype,
                          method=cfg.solver_method,
                          inv_method=cfg.inv_method)
        iters = cfg.refine_iters
    else:
        # stale (trajectory-amortised) factorisation: more refinement
        # iterations recover the exact solution of the CURRENT operator —
        # contraction per iteration is ||fac^-1 (A - A_stale)||, measured
        # <= ~0.45 at an 8-leapfrog-step model drift on the flagship problem
        iters = cfg.stale_refine_iters
    fac = jax.tree_util.tree_map(lax.stop_gradient, fac)

    def matvec(x):
        return S.apply_interior(sys, x)

    if iters > 0:
        sys_sg = jax.tree_util.tree_map(lax.stop_gradient, sys)

        def solve_fn(_mv, b):
            return S.refined_solve(sys_sg, fac, b, iters=iters)
    else:

        def solve_fn(_mv, b):
            return S.factor_solve(fac, b)

    x = lax.custom_linear_solve(matvec, rhs, solve_fn, transpose_solve=solve_fn,
                                symmetric=True)
    full = bc + M.embed_interior(x, st.m.shape[-2] - 1, st.m.shape[-1] - 1)
    return full


def _pair_mean(x, w):
    """(x[i]*w[i] + x[i+1]*w[i+1]) / (w[i] + w[i+1]) — the reference's
    width-weighted vertical-edge average (mt2DTE.jl:183)."""
    return (x[..., :-1] * w[:-1] + x[..., 1:] * w[1:]) / (w[:-1] + w[1:])


def _om_col(omegas, fields, dtype):
    """Frequency column broadcastable against row fields extracted from
    ``fields``: (nfreq,) + as many singleton axes as fields has batch+space
    axes after dropping z (i.e. fields.ndim - 2)."""
    return omegas.astype(dtype).reshape((-1,) + (1,) * (fields.ndim - 2))


def rx_fields_te(omegas, mesh: M.TensorMesh2D, sigma2d, fields, rx: RxInterp):
    """Surface Ex, Hy at receivers from the two node rows bracketing them.

    Vectorised equivalent of compFieldsAtRxTE (mt2DTE.jl:153-210): Hy at the
    receiver level is recovered from a discrete Ampere's-law correction using
    quarter-point Hz and Ex fields.  ``fields`` is (nfreq, ..., nz+1, ny+1)
    and ``sigma2d`` (..., nz, ny) with matching batch (chain) axes.
    """
    dy = mesh.y_len.astype(jnp.real(fields).dtype)
    dz1 = mesh.z_len[rx.zid].astype(dy.dtype)
    sigma1 = sigma2d[..., rx.zid, :].astype(dy.dtype)      # (..., ny) rx-layer cells
    om = _om_col(omegas, fields, dy.dtype)

    E0 = fields[..., rx.zid, :]                            # (nfreq, ..., ny+1)
    E1 = fields[..., rx.zid + 1, :]

    iom = lax.complex(jnp.zeros_like(om), om)
    Bz0 = (E0[..., 1:] - E0[..., :-1]) / dy / iom
    Bz1 = (E1[..., 1:] - E1[..., :-1]) / dy / iom
    HzQ = (0.75 * Bz0 + 0.25 * Bz1) / MU0                  # (nfreq, ..., ny)
    HyH = -(E1[..., 1:-1] - E0[..., 1:-1]) / dz1 / (iom * MU0)  # (nfreq, ..., ny-1)
    ExQ = 0.75 * E0[..., 1:-1] + 0.25 * E1[..., 1:-1]
    sigma1v = _pair_mean(sigma1, dy)                       # (..., ny-1)
    dHzQ = (HzQ[..., 1:] - HzQ[..., :-1]) / (0.5 * (dy[:-1] + dy[1:]))
    Hy_in = HyH - (dHzQ - sigma1v * ExQ) * (0.5 * dz1)
    Hy0 = jnp.concatenate([Hy_in[..., :1], Hy_in, Hy_in[..., -1:]], axis=-1)

    Ex_r = rx.w0 * E0[..., rx.idx] + rx.w1 * E0[..., rx.idx + 1]
    Hy_r = rx.w0 * Hy0[..., rx.idx] + rx.w1 * Hy0[..., rx.idx + 1]
    return Ex_r, Hy_r


def rx_fields_tm(omegas, mesh: M.TensorMesh2D, sigma2d, fields, rx: RxInterp):
    """Surface Ey, Hx at receivers: the Faraday-law dual (mt2DTM.jl:152-210)."""
    dy = mesh.y_len.astype(jnp.real(fields).dtype)
    dz1 = mesh.z_len[rx.zid].astype(dy.dtype)
    sigma1 = sigma2d[..., rx.zid, :].astype(dy.dtype)
    om = _om_col(omegas, fields, dy.dtype)

    H0 = fields[..., rx.zid, :]
    H1 = fields[..., rx.zid + 1, :]

    Jz0 = -(H0[..., 1:] - H0[..., :-1]) / dy
    Jz1 = -(H1[..., 1:] - H1[..., :-1]) / dy
    EzQ = (0.75 * Jz0 + 0.25 * Jz1) / sigma1               # (nfreq, ..., ny)
    JyH = (H1[..., 1:-1] - H0[..., 1:-1]) / dz1
    rho1v = _pair_mean(1.0 / sigma1, dy)
    EyH = JyH * rho1v
    HxQ = 0.75 * H0[..., 1:-1] + 0.25 * H1[..., 1:-1]
    dEzQ = (EzQ[..., 1:] - EzQ[..., :-1]) / (0.5 * (dy[:-1] + dy[1:]))
    iom_mu = lax.complex(jnp.zeros_like(om), om * MU0)
    Ey_in = EyH - (dEzQ + iom_mu * HxQ) * (0.5 * dz1)
    Ey0 = jnp.concatenate([Ey_in[..., :1], Ey_in, Ey_in[..., -1:]], axis=-1)

    Ey_r = rx.w0 * Ey0[..., rx.idx] + rx.w1 * Ey0[..., rx.idx + 1]
    Hx_r = rx.w0 * H0[..., rx.idx] + rx.w1 * H0[..., rx.idx + 1]
    return Ey_r, Hx_r


def rx_hz_te(omegas, mesh: M.TensorMesh2D, fields, rx: RxInterp):
    """Vertical magnetic field Hz at the receivers (TE mode), for the tipper
    TZY = Hz/Hy.  The reference interpolates the *surface-row* Bz0/mu on cell
    centres (dataFuncSens.jl:44-46, Hzr at :96 — `linRxMap2' * (Bz0 ./ mu)`,
    not the quarter-point HzQ)."""
    dy = mesh.y_len.astype(jnp.real(fields).dtype)
    om = _om_col(omegas, fields, dy.dtype)
    E0 = fields[..., rx.zid, :]
    iom = lax.complex(jnp.zeros_like(om), om)
    Hz0 = (E0[..., 1:] - E0[..., :-1]) / dy / iom / MU0    # (nfreq, ..., ny) centres
    return rx.c0 * Hz0[..., rx.cidx] + rx.c1 * Hz0[..., rx.cidx + 1]


def impedance_to_rho_phase(omegas, Z):
    """Apparent resistivity & phase (deg) from impedance (compMTRespTE,
    mt2DTE.jl:253-255)."""
    om = omegas.astype(jnp.real(Z).dtype).reshape((-1,) + (1,) * (Z.ndim - 1))
    rho = jnp.abs(Z) ** 2 / (om * MU0)
    phs = jnp.arctan2(jnp.imag(Z), jnp.real(Z)) * (180.0 / jnp.pi)
    return rho, phs


@dataclasses.dataclass(frozen=True)
class ForwardOperator:
    """Bound forward model: mesh + survey -> differentiable predict(sigma2d).

    Plays the role of ``MT2DFwdSolver`` (MT2DFwdSolver.jl:74-216) with all
    static survey structure (receiver interpolation, component layout, data
    mask) resolved at build time so ``predict`` is a clean jittable function
    of the conductivity image.
    """

    mesh: M.TensorMesh2D
    data: MTData
    rx: RxInterp
    cfg: SolveConfig

    def mode_solution(self, sigma2d: jax.Array, mode: str, freqs=None) -> jax.Array:
        """Full node fields (nfreq, nz+1, ny+1) for one polarisation mode.

        ``freqs`` may override the survey frequencies with a traced array —
        used by the frequency-sharded SPMD path where each device solves its
        own frequency shard.
        """
        freqs = self.data.freqs if freqs is None else freqs
        omegas = 2.0 * jnp.pi * jnp.asarray(freqs, sigma2d.dtype)
        if mode == "TE":
            st = M.te_stencil(self.mesh, sigma2d)
        else:
            st = M.tm_stencil(self.mesh, sigma2d)
        bc = boundary_grid(self.mesh, sigma2d, omegas, mode, self.cfg.solve_dtype)
        return solve_dirichlet(st, omegas, bc, self.cfg)

    def merged_stencil(self, sigma2d: jax.Array) -> M.Stencil:
        """TE and TM stencils stacked on a mode axis just before the grid
        axes: (..., 2, grid) — batch (chain) axes of sigma2d lead."""
        st_te = M.te_stencil(self.mesh, sigma2d)
        st_tm = M.tm_stencil(self.mesh, sigma2d)
        return M.Stencil(*(jnp.stack([a, b], axis=-3) for a, b in zip(st_te, st_tm)))

    def factor_at(self, sigma2d: jax.Array, freqs=None) -> S.Factorization:
        """Factorise the merged (freq x mode) interior systems at this model
        — the reusable trajectory-amortised factorisation handed back to
        :meth:`both_mode_solutions`/:meth:`response_cube` as ``fac``.  The
        reference's analogue is holding MUMPS factors across the forward and
        adjoint of one gradient (compJacTMatVec.jl:224,295); here the same
        factor additionally serves several leapfrog steps via refinement."""
        freqs = self.data.freqs if freqs is None else freqs
        omegas = 2.0 * jnp.pi * jnp.asarray(freqs, sigma2d.dtype)
        st = self.merged_stencil(sigma2d)
        rdt = self.cfg.real_dtype
        om = omegas.astype(rdt).reshape((-1,) + (1,) * st.m.ndim)
        sys = S.interior_system(_cast_stencil(st, rdt), om,
                                dtype=self.cfg.solve_dtype)
        return S.factorize(sys, dtype=self.cfg.solve_dtype,
                           method=self.cfg.solver_method,
                           inv_method=self.cfg.inv_method)

    def both_mode_solutions(self, sigma2d: jax.Array, freqs=None, fac=None):
        """(fields_te, fields_tm), each (nfreq, ..., nz+1, ny+1) with ``...``
        the leading chain axes of ``sigma2d``, from ONE batched
        factor+solve over the stacked (freq x mode) systems — the merged-mode
        fast path: half the sequential solve depth of two per-mode calls and
        a single 1-D boundary propagation (the reference loops frequencies
        within each mode separately, MT2DFwdSolver.jl:140-171).

        ``fac``: optional stale factorisation from :meth:`factor_at` (the
        trajectory-amortised path)."""
        freqs = self.data.freqs if freqs is None else freqs
        omegas = 2.0 * jnp.pi * jnp.asarray(freqs, sigma2d.dtype)
        st = self.merged_stencil(sigma2d)
        bc = boundary_grids_both(self.mesh, sigma2d, omegas,
                                 self.cfg.solve_dtype)     # (nfreq, ..., 2, grid)
        fields = solve_dirichlet(st, omegas, bc, self.cfg, fac=fac)
        return fields[..., 0, :, :], fields[..., 1, :, :]

    def mode_rx_fields(self, sigma2d, mode: str, freqs=None):
        """(E, H, fields) at receivers for one mode."""
        freqs = self.data.freqs if freqs is None else freqs
        omegas = 2.0 * jnp.pi * jnp.asarray(freqs, sigma2d.dtype)
        fields = self.mode_solution(sigma2d, mode, freqs)
        if mode == "TE":
            E, H = rx_fields_te(omegas, self.mesh, sigma2d, fields, self.rx)
        else:
            E, H = rx_fields_tm(omegas, self.mesh, sigma2d, fields, self.rx)
        return E, H, fields

    def mode_impedance(self, sigma2d: jax.Array, mode: str, freqs=None) -> jax.Array:
        """Impedance Zxy (TE) or Zyx (TM) at (nfreq, nrx)."""
        E, H, _ = self.mode_rx_fields(sigma2d, mode, freqs)
        return E / H

    def response_cube(self, sigma2d: jax.Array, freqs=None, fac=None) -> jax.Array:
        """(..., nfreq, nrx, ncomp) response cube in data_comp order, where
        ``...`` are the leading batch (chain) axes of ``sigma2d``.  Chains are
        batched NATIVELY through the one merged factor+solve — no vmap — so a
        C-chain gradient is a single (C x nfreq x 2)-system batched solve."""
        freqs = self.data.freqs if freqs is None else freqs
        omegas = 2.0 * jnp.pi * jnp.asarray(freqs, sigma2d.dtype)
        Z, T = {}, None
        want_tipper = any(c == "TZY" for c in self.data.data_comp)
        if self.data.comp_te and self.data.comp_tm:
            fields_te, fields_tm = self.both_mode_solutions(sigma2d, freqs, fac)
            E, H = rx_fields_te(omegas, self.mesh, sigma2d, fields_te, self.rx)
            Z["XY"] = E / H
            if want_tipper:
                T = rx_hz_te(omegas, self.mesh, fields_te, self.rx) / H
            Ey, Hx = rx_fields_tm(omegas, self.mesh, sigma2d, fields_tm, self.rx)
            Z["YX"] = Ey / Hx
        elif self.data.comp_te:
            E, H, fields = self.mode_rx_fields(sigma2d, "TE", freqs)
            Z["XY"] = E / H
            if want_tipper:
                T = rx_hz_te(omegas, self.mesh, fields, self.rx) / H
        elif self.data.comp_tm:
            Z["YX"] = self.mode_impedance(sigma2d, "TM", freqs)
        comps = []
        for name in self.data.data_comp:
            pol = "XY" if name.endswith("XY") else "YX"
            if name == "TZY":
                comps.append(T)
            elif name.startswith("Z"):
                comps.append(Z[pol])
            elif name.startswith("log10Rho"):
                rho = impedance_to_rho_phase(omegas, Z[pol])[0]
                comps.append(jnp.log10(rho))
            elif name.startswith("Rho"):
                comps.append(impedance_to_rho_phase(omegas, Z[pol])[0])
            elif name.startswith("Phs"):
                comps.append(impedance_to_rho_phase(omegas, Z[pol])[1])
            else:
                raise ValueError(name)
        cube = jnp.stack(comps, axis=-1)          # (nfreq, ..., nrx, ncomp)
        return jnp.moveaxis(cube, 0, -3)          # (..., nfreq, nrx, ncomp)

    def predict(self, sigma2d: jax.Array, fac=None) -> jax.Array:
        """Predicted data at the observed (freq, rx, comp) triples — the
        masked predData vector of MT2DFwdSolver.jl:209-210.  Batch (chain)
        axes of ``sigma2d`` lead the returned (..., ndata)."""
        cube = self.response_cube(sigma2d, fac=fac)
        flat = cube.reshape(cube.shape[:-3] + (-1,))
        return jnp.take(flat, jnp.asarray(self.data.flat_index), axis=-1)


def make_forward(mesh: M.TensorMesh2D, data: MTData, cfg: SolveConfig | None = None) -> ForwardOperator:
    cfg = cfg or default_config()
    return ForwardOperator(mesh=mesh, data=data, rx=make_rx_interp(mesh, data.rx_loc), cfg=cfg)
