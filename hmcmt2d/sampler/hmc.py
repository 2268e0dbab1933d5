"""Hamiltonian Monte Carlo sampler — fully jitted, chains batched.

Accelerator redesign of the reference sampler (HMCMT/src/HMCSampler/
HMCSampler.jl).  The whole chain — leapfrog proposals with the reference's
quirks (random integer trajectory length, position-step clipping, reflective
bounds, truncated-normal momentum, full momentum refresh each iteration,
MH accept) — is one ``lax.scan`` over samples with all chains advanced
simultaneously as a batch dimension (the reference runs one chain per Julia
process, parallelHMC.jl).

Differences from the reference, chosen deliberately:

* the trajectory length L is drawn once per iteration and *shared by all
  chains* (a ``lax.switch`` then executes exactly L leapfrog steps; a
  per-chain L would force every chain to pad to the maximum).  Each chain
  still sees L ~ U{lo..hi} i.i.d. across iterations, so the per-chain kernel
  is the reference's; only the across-chain correlation of L differs.
* the gradient at the current state is carried across iterations (the
  accepted state's last in-trajectory gradient is exactly the gradient at
  the new current state), saving one gradient evaluation per proposal
  (L per iteration instead of the reference's L+1, HMCSampler.jl:216,251).
* reflective bound handling is a closed-form triangle-wave fold instead of
  the reference's per-component loop (checkParameterBound!,
  HMCSampler.jl:515-559) — identical result, no data-dependent loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


class MassMatrix(NamedTuple):
    """Diagonal or dense-Cholesky mass matrix (setMassMatrix,
    HMCSampler.jl:463-489).

    ``sqrt_m`` is the factor applied to the raw momentum draw, ``inv_m`` the
    inverse mass applied in the kinetic energy/gradient.  Diagonal case:
    1-D arrays; dense case: (P, P) lower Cholesky of M=Wm and full inverse.
    """

    sqrt_m: jax.Array
    inv_m: jax.Array
    diagonal: bool = True

    def draw(self, key, shape):
        """p = sqrtM @ clip(randn, +-2.5) (getMomentumVector,
        HMCSampler.jl:441-453)."""
        raw = jnp.clip(jax.random.normal(key, shape), -2.5, 2.5)
        if self.diagonal:
            return self.sqrt_m * raw
        return jnp.einsum("ab,...b->...a", self.sqrt_m, raw,
                          precision=lax.Precision.HIGHEST)

    def apply_inv(self, p):
        if self.diagonal:
            return self.inv_m * p
        return jnp.einsum("ab,...b->...a", self.inv_m, p,
                          precision=lax.Precision.HIGHEST)

    def kinetic(self, p):
        """0.5 p' M^-1 p (getKineticEnergy, HMCSampler.jl:407-415)."""
        return 0.5 * jnp.sum(p * self.apply_inv(p), axis=-1)


def identity_mass(n_param: int, dtype=jnp.float64) -> MassMatrix:
    one = jnp.ones((n_param,), dtype)
    return MassMatrix(sqrt_m=one, inv_m=one, diagonal=True)


def dense_mass(Wm: np.ndarray) -> MassMatrix:
    """Non-diagonal mass M = Wm via dense Cholesky (HMCSampler.jl:478-489)."""
    L = np.linalg.cholesky(np.asarray(Wm))
    Linv = np.linalg.inv(L)
    return MassMatrix(sqrt_m=jnp.asarray(L), inv_m=jnp.asarray(Linv.T @ Linv),
                      diagonal=False)


def reflect_bounds(m, p, lo, hi):
    """Reflect positions into [lo, hi] flipping momentum per reflection —
    closed form of the reference's loop (HMCSampler.jl:515-559): the
    position folds as a triangle wave; the momentum flips sign when the
    unfolded position lies in a descending segment."""
    width = hi - lo
    t = jnp.mod(m - lo, 2.0 * width)
    m_new = lo + width - jnp.abs(t - width)
    flip = t > width
    p_new = jnp.where(flip, -p, p)
    return m_new, p_new


class ChainState(NamedTuple):
    """Per-chain carried state (all leading dim = n_chains)."""

    m: jax.Array         # (C, P) current log-sigma model
    grad: jax.Array      # (C, P) gradient of the potential at m
    misfit: jax.Array    # (C,)
    mnorm: jax.Array     # (C,)
    pred: jax.Array      # (C, D) predicted data at m


class HMCResult(NamedTuple):
    models: jax.Array    # (S, C, P) float32 samples (current model per iter)
    stats: jax.Array     # (S, C, 4) [misfit, mnorm, kinetic, hamiltonian]
    accepts: jax.Array   # (S, C) bool
    pred: jax.Array      # (S, C, D) predicted data of the current model
    final: ChainState
    start_stats: jax.Array  # (C, 4) initial [misfit, mnorm, ke, h]
    start_pred: jax.Array   # (C, D) predicted data of the start model (the
                            # reference's extra first row, HMCSampler.jl:801-808)
    lf_steps: jax.Array     # (S, C) leapfrog steps per iteration — the
                            # gradient-eval counter (nfevals, HMCStruct.jl:34)


@dataclasses.dataclass(frozen=True)
class HMCOptions:
    """Sampler controls (reference semantics; see HMCConfig for file keys)."""

    dt: float
    steps_lo: int
    steps_hi: int
    log_sig_lo: float
    log_sig_hi: float
    reg_param: float
    max_step_size: float = 3.0  # position-step clip (HMCSampler.jl:234-243)
    # refactorise the PDE systems every this many leapfrog steps when the
    # sampler runs with a factor_fn (trajectory-amortised factorisation);
    # in-between steps solve with the stale factor + refinement
    refactor_every: int = 4


def _leapfrog(potential_vg: Callable, opts: HMCOptions, mass: MassMatrix,
              state: ChainState, p0, m_ref, n_steps, dt,
              factor_fn: Callable | None = None):
    """Leapfrog trajectory of (traced) length n_steps (proposeLeapfrog,
    HMCSampler.jl:206-269).

    One potential gradient per executed step; the initial half-kick reuses
    the carried gradient at the current state.  The scan is compiled for the
    static maximum ``opts.steps_hi`` steps with a scalar ``lax.cond`` skipping
    the tail, so the expensive body (a full forward+adjoint PDE sweep) is
    compiled exactly once and only n_steps of it execute at runtime.

    ``dt`` may be a traced scalar (the warmup adapter tunes it on the fly);
    the fixed-kernel sampler passes ``opts.dt``.

    ``factor_fn`` enables the trajectory-amortised factorisation: the PDE
    factorisation (the dominant cost) is computed at the trajectory start
    and every ``opts.refactor_every`` steps, and the in-between potential
    evaluations solve with the stale factor via preconditioned refinement —
    exact solutions, several-fold fewer factorisations.  The refactor
    predicate is a scalar function of the step index, so ``lax.cond``
    executes only the taken branch.
    """
    p = p0 - 0.5 * dt * state.grad
    m = state.m
    fac0 = factor_fn(m) if factor_fn is not None else None

    def real_step(carry, k):
        m, p, _aux, fac = carry
        gk = mass.apply_inv(p)
        dm = dt * gk
        dm_max = jnp.max(jnp.abs(dm), axis=-1, keepdims=True)
        scale = jnp.minimum(1.0, opts.max_step_size / dm_max)
        m = m + dm * scale
        m, p = reflect_bounds(m, p, opts.log_sig_lo, opts.log_sig_hi)
        if factor_fn is not None:
            refac = (k > 0) & (k % opts.refactor_every == 0)
            fac = lax.cond(refac, factor_fn, lambda _m: fac, m)
            (U, aux), g = potential_vg(m, m_ref, fac)
        else:
            (U, aux), g = potential_vg(m, m_ref)
        coeff = jnp.where(k == n_steps - 1, 0.5 * dt, dt)
        p = p - coeff * g
        return (m, p, (aux, g), fac)

    def step(carry, k):
        carry = lax.cond(k < n_steps, real_step, lambda c, _k: c, carry, k)
        return carry, None

    # aux placeholder with correct shapes from the current state
    aux0 = ((state.misfit, state.mnorm, state.pred), state.grad)
    (m, p, (aux, g), _), _ = lax.scan(step, (m, p, aux0, fac0),
                                      jnp.arange(opts.steps_hi))
    misfit, mnorm, pred = aux
    return ChainState(m=m, grad=g, misfit=misfit, mnorm=mnorm, pred=pred), p


def make_sample_step(potential_vg: Callable, opts: HMCOptions,
                     factor_fn: Callable | None = None):
    """Build the per-iteration kernel (one MH-corrected HMC proposal).

    The returned ``sample_step(state, key, m_ref, dt, mass)`` takes the step
    size and mass matrix as (possibly traced) arguments so the warmup adapter
    can tune them between iterations without retracing.

    With ``factor_fn`` (batched model -> Factorization), leapfrog runs the
    trajectory-amortised factorisation path: ``potential_vg`` must then take
    ``(m, m_ref, fac)``.
    """

    def sample_step(state: ChainState, key, m_ref, dt, mass: MassMatrix):
        c = state.m.shape[0]
        key_L, key_p, key_u = jax.random.split(key, 3)

        p0 = mass.draw(key_p, state.m.shape)
        ke0 = mass.kinetic(p0)
        h0 = state.misfit + state.mnorm + ke0

        # random integer trajectory length, shared across chains
        L = jax.random.randint(key_L, (), opts.steps_lo, opts.steps_hi + 1)
        prop, p1 = _leapfrog(potential_vg, opts, mass, state, p0, m_ref, L,
                             dt, factor_fn=factor_fn)

        ke1 = mass.kinetic(p1)
        h1 = prop.misfit + prop.mnorm + ke1

        # MH: accept if dH > 0 or u < exp(dH) (HMCSampler.jl:149-151)
        dh = h0 - h1
        u = jax.random.uniform(key_u, (c,))
        # a proposal with ANY non-finite component must never be accepted.
        # A NaN h1 already rejects through the IEEE comparisons below — but a
        # FINITE-energy proposal carrying a non-finite gradient (a float32
        # overflow in one frequency's adjoint can do this while the misfit
        # stays finite) would poison the carried state: every subsequent
        # trajectory starts from a NaN gradient, every proposal is NaN,
        # alpha is pinned to 0 at ANY step size, and warmup dual averaging
        # death-spirals (the COPROD2 dt -> 1e-14 collapse, round 4).
        finite = (jnp.isfinite(h1)
                  & jnp.isfinite(prop.grad).all(axis=-1)
                  & jnp.isfinite(prop.m).all(axis=-1))
        accept = finite & ((dh > 0) | (u < jnp.exp(dh)))
        # acceptance probability, used by dual-averaging step-size adaptation.
        # A force-rejected non-finite proposal must report alpha=0 too: dh
        # alone can look optimistic (finite h1, NaN gradient) and warmup
        # adaptation would then see phantom acceptance exactly in the
        # pathological regime the guard targets.
        alpha = jnp.where(finite,
                          jnp.minimum(1.0, jnp.exp(jnp.minimum(dh, 0.0))), 0.0)

        def pick(a, b):
            return jnp.where(accept.reshape((c,) + (1,) * (a.ndim - 1)), a, b)

        new = ChainState(*(pick(a, b) for a, b in zip(prop, state)))
        stats = jnp.stack([new.misfit, new.mnorm, ke0,
                           new.misfit + new.mnorm + ke0], axis=-1)
        return new, accept, stats, alpha, L

    return sample_step


def sample_chain_init(potential_vg: Callable, m0: jax.Array, m_ref: jax.Array):
    """Evaluate potential+gradient at the start model -> initial ChainState."""
    (U, (misfit, mnorm, pred)), g = potential_vg(m0, m_ref)
    return ChainState(m=m0, grad=g, misfit=misfit, mnorm=mnorm, pred=pred)


def run_hmc(potential_vg: Callable, opts: HMCOptions, mass: MassMatrix,
            m0: jax.Array, m_ref: jax.Array, n_samples: int, key,
            sample_dtype=jnp.float32, init_state: ChainState | None = None,
            key_offset=0, factor_fn: Callable | None = None) -> HMCResult:
    """Run ``n_samples`` HMC iterations for a batch of chains.

    potential_vg(m (C,P), m_ref (C,P)) -> ((U, (misfit, mnorm, pred)), grad)
    must be the *batched* potential value-and-grad (chains leading).

    The loop is a single ``lax.scan`` (jit-compiled once); outputs mirror the
    reference's per-iteration records (runHMCSampler, HMCSampler.jl:118-192).
    ``init_state`` (e.g. the warmup adapter's final state) skips the initial
    potential evaluation at ``m0``.

    Per-iteration PRNG keys are ``fold_in(fold_in(key, 1), key_offset + i)``,
    i.e. a pure function of the *global* sample index — so a run segmented at
    arbitrary checkpoint boundaries (the driver passes ``key_offset`` = samples
    already drawn) produces a sample stream identical to an unsegmented run.
    """
    state = init_state if init_state is not None else sample_chain_init(
        potential_vg, m0, m_ref)
    step = make_sample_step(potential_vg, opts, factor_fn=factor_fn)

    ke_init = mass.kinetic(mass.draw(jax.random.fold_in(key, 0), m0.shape))
    start_stats = jnp.stack([state.misfit, state.mnorm, ke_init,
                             state.misfit + state.mnorm + ke_init], axis=-1)

    base = jax.random.fold_in(key, 1)
    keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
        key_offset + jnp.arange(n_samples))

    def _pred_cast(p):
        return p.astype(jnp.complex64 if jnp.iscomplexobj(p) else jnp.float32)

    n_chains = m0.shape[0]

    def body(state, k):
        new, accept, stats, _alpha, L = step(state, k, m_ref, opts.dt, mass)
        out = (new.m.astype(sample_dtype), stats, accept, _pred_cast(new.pred),
               jnp.broadcast_to(L.astype(jnp.int32), (n_chains,)))
        return new, out

    final, (models, stats, accepts, pred, lf) = lax.scan(body, state, keys)
    return HMCResult(models=models, stats=stats, accepts=accepts, pred=pred,
                     final=final, start_stats=start_stats,
                     start_pred=_pred_cast(state.pred), lf_steps=lf)


def random_homogeneous_start(key, m0_file: np.ndarray, n_chains: int):
    """Per-chain randomised homogeneous start model: rho_ref ~ round(U(0.5,
    1.5)*rho0) with rho0 from the file's start model (HMCSampler.jl:99-110).

    Returns (C, P) start models (= reference models, HMCSampler.jl:108-109).
    """
    rho0 = 1.0 / np.exp(float(np.asarray(m0_file)[0]))
    u = jax.random.uniform(key, (n_chains,), minval=0.5 * rho0, maxval=1.5 * rho0)
    rho_ref = jnp.round(u)
    m = jnp.log(1.0 / rho_ref)
    return jnp.broadcast_to(m[:, None], (n_chains, len(m0_file)))
