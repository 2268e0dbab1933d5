"""Jacobian products and full Jacobians of the predicted data.

Parity surface for the reference's MTSensitivity layer: ``jtv`` replaces
``compJacTMatVec`` (compJacTMatVec.jl:8-329), ``jv`` the forward product, and
``full_jacobian`` replaces ``compJacMat``/``compJacTMat``
(compJacMat.jl:7-381, compJacTMat.jl:9-406).  All are thin autodiff wrappers
around the differentiable forward model — the receiver-side chain rule
(dataFuncSens.jl), the boundary-condition sensitivity (MT1DSensitivity.jl)
and the pseudo-forward adjoint solves all fall out of ``jax.vjp``/``jvp``
with the factorisation reuse provided by ``lax.custom_linear_solve``.

Complex data are handled as stacked real/imaginary parts, matching the
reference's real view of the misfit (0.5*re(r^H r)): J has shape
(2*ndata_complex, n_param) for impedance data and (ndata, n_param) for
rho/phase data.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _real_stack(pred):
    if jnp.iscomplexobj(pred):
        return jnp.concatenate([jnp.real(pred), jnp.imag(pred)])
    return pred


def real_predict(problem, m):
    """Predicted data as a real vector (re parts then im parts)."""
    return _real_stack(problem.predict(m))


def jv(problem, m, v):
    """J @ v — directional derivative of the real data vector."""
    _, out = jax.jvp(lambda mm: real_predict(problem, mm), (m,), (v,))
    return out


def jtv(problem, m, w):
    """J' @ w — the adjoint product (one extra solve per (freq, mode)
    reusing the forward factorisation, as compJacTMatVec.jl:224,295)."""
    _, pull = jax.vjp(lambda mm: real_predict(problem, mm), m)
    return pull(w)[0]


def full_jacobian(problem, m):
    """Dense J (n_real_data x n_param) via reverse-mode rows — the
    sensitivity-test entry point (compJacMat.jl)."""
    return jax.jacrev(lambda mm: real_predict(problem, mm))(m)


def full_jacobian_chunked(problem, m, chunk: int = 128):
    """Dense J (n_real_data x n_param) as a sequence of short device
    programs: ONE linearisation (forward sweep + stored factorisation), then
    the pullback vmapped over ``chunk``-row slabs of the identity — each slab
    is one batched multi-RHS adjoint sweep reusing the shared factors, the
    batched analogue of the reference's nAC-column pseudo-forward solves
    (compJacMat.jl:210-222).  Chunking bounds the transient solve batch.

    Returns a host numpy array; used by the Gauss-Newton mass matrix.
    """
    import numpy as np

    f = lambda mm: real_predict(problem, mm)
    n = int(jax.eval_shape(f, m).shape[0])

    # the vjp linearisation happens inside the jitted slab program, so each
    # chunk is one compiled program; recomputing it per slab costs one extra
    # factorisation per chunk — noise next to the chunk's multi-RHS solves.
    @jax.jit
    def jac_slab(mm, i0):
        y, pull = jax.vjp(f, mm)
        # fixed-size slab (tail rows clamp to the last basis vector and are
        # sliced off on host) so one compiled program serves all chunks
        idx = jnp.minimum(i0 + jnp.arange(chunk), n - 1)
        slab = jnp.zeros((chunk, n), y.dtype).at[
            jnp.arange(chunk), idx].set(1.0)
        return jax.vmap(lambda e: pull(e)[0])(slab)

    rows = []
    for i in range(0, n, chunk):
        out = np.asarray(jac_slab(m, jnp.asarray(i)))
        rows.append(out[: min(chunk, n - i)])
    return np.concatenate(rows, axis=0)
