"""Batched matrix inversion as pure matmuls (no LU library call).

``jnp.linalg.inv`` lowers to a row-pivoted LU whose inner loop executes ~n
sequential small vector ops per matrix.  This module implements **blocked
Gauss-Jordan inversion without pivoting**: an augmented [A | I] sweep over
n/b block columns, each step being one small unrolled base inversion plus
two batched matmuls.  It is kept as the alternative inverse engine
(``--inv gj``); the LU engine is the default.

No pivoting is safe here by structure: the equilibrated MT interior operator
``L + i omega M`` has symmetric positive-definite real part (L is the SPD
Dirichlet stencil, M >= 0), every diagonal block inherits it, and Schur
complements of matrices with positive-definite Hermitian/real part keep that
property — the classic sufficient condition for stable unpivoted elimination.
The solver's iterative refinement mops up the last bits.

Replaces the MUMPS pivoting engine of the reference
(MUMPS/src/MUMPSfuncs.jl factor_mumps_cmplx_).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_HI = lax.Precision.HIGHEST


def _inv_base_gj(P):
    """Unrolled scalar Gauss-Jordan inverse of (..., b, b), b small & static."""
    b = P.shape[-1]
    X = jnp.concatenate([P, jnp.broadcast_to(jnp.eye(b, dtype=P.dtype),
                                             P.shape)], axis=-1)
    for k in range(b):
        piv = X[..., k:k + 1, :] / X[..., k:k + 1, k:k + 1]
        X = X - X[..., :, k:k + 1] * piv
        # row k was zeroed by the update above; restore the scaled pivot row
        X = jnp.concatenate([X[..., :k, :], piv, X[..., k + 1:, :]], axis=-2)
    return X[..., :, b:]


def inv_nopivot(A, block: int = 16):
    """Blocked unpivoted Gauss-Jordan inverse of (..., n, n) batched matrices.

    Pads n up to a multiple of ``block`` with an identity tail (decoupled),
    then sweeps the augmented system with static (unrolled) block steps:

        P   = X[k, k];  R = inv(P) @ X[k, :]
        X  -= X[:, k] @ R;  X[k, :] = R

    Every step is one base inverse of (batch, b, b) plus two batched
    matmuls.  FLOPs ~2x a one-sided LU inverse, all of them matmul-shaped.
    """
    n = A.shape[-1]
    b = min(block, n)
    n_pad = (-n) % b
    N = n + n_pad
    batch = A.shape[:-2]
    if n_pad:
        A = jnp.concatenate([
            jnp.concatenate([A, jnp.zeros(batch + (n, n_pad), A.dtype)], axis=-1),
            jnp.concatenate([jnp.zeros(batch + (n_pad, n), A.dtype),
                             jnp.broadcast_to(jnp.eye(n_pad, dtype=A.dtype),
                                              batch + (n_pad, n_pad))], axis=-1),
        ], axis=-2)

    X = jnp.concatenate([A, jnp.broadcast_to(jnp.eye(N, dtype=A.dtype),
                                             batch + (N, N))], axis=-1)
    for k0 in range(0, N, b):
        P = X[..., k0:k0 + b, k0:k0 + b]
        R = jnp.matmul(_inv_base_gj(P), X[..., k0:k0 + b, :], precision=_HI)
        U = jnp.matmul(X[..., :, k0:k0 + b], R, precision=_HI)
        X = X - U
        X = jnp.concatenate([X[..., :k0, :], R, X[..., k0 + b:, :]], axis=-2)
    out = X[..., :, N:]
    if n_pad:
        out = out[..., :n, :n]
    return out
