"""Tensor-mesh geometry and matrix-free 5-point stencil operators.

Accelerator redesign of the reference's sparse-operator layer
(HMCMT/src/MTFwdSolver/MT2DOperators.jl).  The reference materialises sparse
Kronecker-product matrices ``Grad' * M_F * Grad + i*omega*M_CN``
(MT2DFwdSolver.jl:124-135 for TE, :150-161 for TM).  On a tensor mesh that
operator is exactly a 5-point finite-volume stencil with spatially varying
coefficients, so we never build a matrix: we store three small coefficient
arrays (y-edge, z-edge, node-mass) and apply the operator with shifted
adds — fully fusible by XLA and trivially batchable over (chain, freq, mode).

Array layout conventions (all 2-D arrays are z-major, matching the
reference's ``E2d``/``sigma2D`` orientation, mt2DTE.jl:57-62,106):

* cell fields   : shape ``(nz, ny)``   — ``sigma2d[j, i]`` is cell (z=j, y=i)
* node fields   : shape ``(nz+1, ny+1)``
* y-edge fields : shape ``(nz+1, ny)`` — edges parallel to y at node z-levels
* z-edge fields : shape ``(nz,  ny+1)`` — edges parallel to z at node y-lines

The flattened cell vector (C-order ravel of ``(nz, ny)``) matches the
reference's y-fastest cell ordering (readEMModel2D.jl:102-110), and the
flattened node vector matches the y-fastest node ordering used by
``getBoundaryIndex`` (MT2DFwdSolver.jl:232).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .constants import MU0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TensorMesh2D:
    """Static tensor-mesh geometry (air layers already prepended to z).

    Unlike the reference's mutable ``TensorMesh2D`` (HMCFileIO.jl:45-60) the
    conductivity is NOT stored on the mesh: it is the differentiated variable
    and flows through function arguments instead.
    """

    y_len: jax.Array      # (ny,) cell widths in y [m]
    z_len: jax.Array      # (nz,) cell heights in z [m], air rows first
    air_layer: jax.Array  # (nair,) air thicknesses, bottom-up file order
    origin: jax.Array     # (2,) coordinates of node (z=0, y=0) offset

    @property
    def ny(self) -> int:
        return self.y_len.shape[0]

    @property
    def nz(self) -> int:
        return self.z_len.shape[0]

    @property
    def n_air(self) -> int:
        return self.air_layer.shape[0]

    @property
    def n_node(self) -> int:
        return (self.ny + 1) * (self.nz + 1)

    @property
    def n_cell(self) -> int:
        return self.ny * self.nz

    def y_node(self) -> jax.Array:
        """Node y-coordinates, origin-shifted (mt2DTE.jl:31)."""
        zero = jnp.zeros((1,), self.y_len.dtype)
        return jnp.concatenate([zero, jnp.cumsum(self.y_len)]) - self.origin[0]

    def z_node(self) -> jax.Array:
        """Node z-coordinates, origin-shifted (mt2DTE.jl:32); z grows down."""
        zero = jnp.zeros((1,), self.z_len.dtype)
        return jnp.concatenate([zero, jnp.cumsum(self.z_len)]) - self.origin[1]


def make_mesh(y_len, z_len, air_layer=None, origin=None, dtype=None) -> TensorMesh2D:
    """Build a mesh from plain arrays; ``z_len`` must already include air rows."""
    dtype = dtype or jnp.result_type(float)
    air = np.zeros(0) if air_layer is None else np.asarray(air_layer)
    org = np.zeros(2) if origin is None else np.asarray(origin)
    return TensorMesh2D(
        y_len=jnp.asarray(y_len, dtype),
        z_len=jnp.asarray(z_len, dtype),
        air_layer=jnp.asarray(air, dtype),
        origin=jnp.asarray(org, dtype),
    )


class Stencil(NamedTuple):
    """Coefficients of ``A(omega) = L + i*omega*diag(m)`` on the full node grid.

    ``L`` is the real symmetric 5-point operator ``Grad' * diag(w_face) * Grad``
    and ``m`` the real node mass.  TE: faces carry ``1/mu``, mass carries
    ``sigma`` (MT2DFwdSolver.jl:124-128); TM is the dual with ``1/sigma`` on
    faces and ``mu`` in the mass (MT2DFwdSolver.jl:150-154).
    """

    cy: jax.Array  # (nz+1, ny)   y-edge coefficient  w_y / dy^2
    cz: jax.Array  # (nz,  ny+1)  z-edge coefficient  w_z / dz^2
    m: jax.Array   # (nz+1, ny+1) node mass (multiplies i*omega)


def _ave_cn(x: jax.Array, axis: int) -> jax.Array:
    """Cell-to-node averaging along ``axis``: half-weights in the interior and
    weight 1.0 on the two boundary nodes (``avcn``, MT2DOperators.jl:183-190).

    Input length n along ``axis`` -> output length n+1.  ``axis`` should be
    negative so leading batch dimensions (e.g. chains) pass through.
    """
    n = x.shape[axis]
    lo = jax.lax.slice_in_dim(x, 0, 1, axis=axis)
    hi = jax.lax.slice_in_dim(x, n - 1, n, axis=axis)
    a = jax.lax.slice_in_dim(x, 0, n - 1, axis=axis)
    b = jax.lax.slice_in_dim(x, 1, n, axis=axis)
    return jnp.concatenate([lo, 0.5 * (a + b), hi], axis=axis)


def _edge_and_mass(mesh: TensorMesh2D, face_cell: jax.Array, mass_cell: jax.Array) -> Stencil:
    """Shared TE/TM coefficient assembly.

    ``face_cell``/``mass_cell`` are cell fields (..., nz, ny) — optional
    leading batch dimensions (chains) broadcast straight through: the
    material carried by the gradient term and the i*omega mass term
    respectively.
    """
    dy = mesh.y_len[None, :]   # (1, ny)
    dz = mesh.z_len[:, None]   # (nz, 1)
    area = dy * dz             # (nz, ny) cell areas (meshGeoFace2D, MT2DOperators.jl:84-88)

    fa = area * face_cell
    # y-edges: average the cell quantity in z (aveCell2Face2D block A2,
    # MT2DOperators.jl:126-129), then scale by the squared inverse edge length
    # coming from the two length-scaled gradients (meshGeoEdgeInv2D, :104-115).
    cy = _ave_cn(fa, axis=-2) / (dy * dy)
    # z-edges: average in y (block A1).
    cz = _ave_cn(fa, axis=-1) / (dz * dz)

    # node mass: kron(avcn(nz), avcn(ny)) applied to area*mass
    # (aveCell2Node2D, MT2DOperators.jl:118-122).
    m = _ave_cn(_ave_cn(area * mass_cell, axis=-1), axis=-2)
    return Stencil(cy=cy, cz=cz, m=m)


def te_stencil(mesh: TensorMesh2D, sigma2d: jax.Array) -> Stencil:
    """TE-mode operator coefficients: ``Grad'*(1/mu)_F*Grad + i*omega*(sigma)_CN``
    (MT2DFwdSolver.jl:124-135)."""
    inv_mu = jnp.full_like(sigma2d, 1.0 / MU0)
    return _edge_and_mass(mesh, inv_mu, sigma2d)


def tm_stencil(mesh: TensorMesh2D, sigma2d: jax.Array) -> Stencil:
    """TM-mode operator coefficients: ``Grad'*(1/sigma)_F*Grad + i*omega*(mu)_CN``
    (MT2DFwdSolver.jl:150-161)."""
    mu = jnp.full_like(sigma2d, MU0)
    return _edge_and_mass(mesh, 1.0 / sigma2d, mu)


def _div_adjoint_y(fy: jax.Array) -> jax.Array:
    """out[j, i] = fy[j, i-1] - fy[j, i] with zero padding: adjoint of the
    y-difference, i.e. the Grad' accumulation for y-edges."""
    z = jnp.zeros_like(fy[..., :, :1])
    return jnp.concatenate([z, fy], axis=-1) - jnp.concatenate([fy, z], axis=-1)


def _div_adjoint_z(fz: jax.Array) -> jax.Array:
    z = jnp.zeros_like(fz[..., :1, :])
    return jnp.concatenate([z, fz], axis=-2) - jnp.concatenate([fz, z], axis=-2)


def apply_L(st: Stencil, u: jax.Array) -> jax.Array:
    """Apply the real part ``L = Grad'*W_F*Grad`` to a full node grid ``u``.

    ``u`` may be real or complex, and may carry leading batch dimensions.
    Matches the sparse product ``dGrad * u`` of the reference.
    """
    fy = st.cy * (u[..., :, 1:] - u[..., :, :-1])
    fz = st.cz * (u[..., 1:, :] - u[..., :-1, :])
    return _div_adjoint_y(fy) + _div_adjoint_z(fz)


def apply_A(st: Stencil, omega, u: jax.Array) -> jax.Array:
    """Apply ``A(omega) = L + i*omega*diag(m)`` to a full node grid."""
    return apply_L(st, u) + (1j * omega) * (st.m * u)


def embed_interior(u_int: jax.Array, nz: int, ny: int) -> jax.Array:
    """Zero-pad an interior node field (nz-1, ny-1) to the full grid."""
    return jnp.pad(u_int, [(0, 0)] * (u_int.ndim - 2) + [(1, 1), (1, 1)])


def interior(u: jax.Array) -> jax.Array:
    """Extract the interior (nz-1, ny-1) of a full node grid."""
    return u[..., 1:-1, 1:-1]


def boundary_rhs(st: Stencil, omega, bc_full: jax.Array) -> jax.Array:
    """Interior right-hand side ``-A_io * bc`` (mt2DTE.jl:44).

    ``bc_full`` is a full node grid holding the Dirichlet values on the
    boundary ring and zeros inside.
    """
    return -interior(apply_A(st, omega, bc_full))


def cell_gradient_sqnorm(v2d: jax.Array) -> jax.Array:
    """``v' * Gc' * Gc * v`` for the *unscaled* cell-gradient smoothness
    operator (getCellGradient2D, MT2DOperators.jl:52-63): plain first
    differences between adjacent cells in y and z, no length weighting.

    ``v2d`` is a full cell grid (nz, ny) (inactive cells must be zero, as the
    reference multiplies by activeCell first, HMCStruct.jl:119-120).
    """
    dy = v2d[..., :, 1:] - v2d[..., :, :-1]
    dz = v2d[..., 1:, :] - v2d[..., :-1, :]
    return jnp.sum(dy * dy, axis=(-2, -1)) + jnp.sum(dz * dz, axis=(-2, -1))


def cell_gradient_normal(v2d: jax.Array) -> jax.Array:
    """``Gc' * Gc * v`` on the full cell grid — the smoothness matrix ``Wm``
    product used by the prior gradient (HMCSampler.jl:223)."""
    dy = v2d[..., :, 1:] - v2d[..., :, :-1]
    dz = v2d[..., 1:, :] - v2d[..., :-1, :]
    return _div_adjoint_y(dy) + _div_adjoint_z(dz)
