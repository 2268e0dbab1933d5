"""Warmup adaptation: dual-averaging step size + diagonal mass estimation.

The reference runs HMC with a fixed user-chosen step size and an identity (or
``Wm``-Cholesky) mass matrix (HMCSampler.jl:81-91, setMassMatrix,
HMCSampler.jl:463-489) — tuning ``timeinterval`` is left to the user.  This
module adds the modern warmup the reference lacks: Nesterov
dual-averaging of log step size toward a target acceptance (Hoffman & Gelman
2014, Algorithm 5) and windowed diagonal mass-matrix estimation from the
warmup draws (Stan's expanding slow windows with Welford-style accumulation
and shrinkage toward unit mass).

Everything is one ``lax.scan`` over warmup iterations — step size, mass and
window bookkeeping are carried arrays, the boolean window-end schedule is a
precomputed constant — so the adapter compiles exactly one leapfrog body and
runs entirely on device.  All chains in the batch are pooled for both the
acceptance statistic and the variance estimate; pass ``pool_axis`` to also
pool across a sharded chains mesh axis with ``lax.pmean``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .hmc import ChainState, HMCOptions, HMCResult, MassMatrix, make_sample_step, sample_chain_init


@dataclasses.dataclass(frozen=True)
class WarmupOptions:
    """Dual-averaging and window-schedule controls (Stan defaults)."""

    target_accept: float = 0.8
    gamma: float = 0.05
    t0: float = 10.0
    kappa: float = 0.75
    init_buffer: int = 75    # iterations before the first mass window
    term_buffer: int = 50    # step-size-only iterations at the end
    base_window: int = 25    # first mass window length (doubles each window)
    adapt_mass: bool = True
    # cross-chain pooling of the dual-averaging acceptance statistic:
    # "mean" (Stan's choice) or "median".  Median is robust to a MINORITY of
    # stuck chains: at extreme high-misfit states the inexact potential can
    # pin single chains at alpha=0 (a solver-accuracy cliff, COPROD2 round
    # 4); with mean pooling two stuck chains of 8 drag alpha_mean below the
    # target forever and dt death-spirals to ~1e-14, freezing ALL chains.
    # On the sharded path the chains axis is all_gather'd (it is small) and
    # the median taken over the global chain set on every shard.
    alpha_pool: str = "mean"


def window_schedule(n_warmup: int, w: WarmupOptions) -> np.ndarray:
    """Boolean array marking the last iteration of each mass window.

    Stan's schedule: ``init_buffer`` fast iterations, then doubling slow
    windows, then ``term_buffer`` fast iterations.  For short warmups the
    buffers are shrunk proportionally (as Stan does).
    """
    ends = np.zeros(n_warmup, bool)
    init_b, term_b, base = w.init_buffer, w.term_buffer, w.base_window
    if n_warmup < init_b + term_b + base:
        scale = n_warmup / (init_b + term_b + base)
        init_b = max(1, int(init_b * scale))
        term_b = max(1, int(term_b * scale))
        base = max(2, n_warmup - init_b - term_b)
    pos = init_b
    size = base
    last = n_warmup - term_b
    while pos < last:
        end = pos + size
        # if the next (doubled) window would not fit, absorb the remainder
        if end + 2 * size > last:
            end = last
        ends[min(end, last) - 1] = True
        pos = end
        size *= 2
    return ends


class _DualAvg(NamedTuple):
    log_eps: jax.Array
    log_eps_avg: jax.Array
    h_avg: jax.Array
    t: jax.Array
    mu: jax.Array


def _da_init(dt0) -> _DualAvg:
    log_eps = jnp.log(dt0)
    return _DualAvg(log_eps=log_eps, log_eps_avg=log_eps,
                    h_avg=jnp.zeros_like(log_eps), t=jnp.zeros_like(log_eps),
                    mu=jnp.log(10.0) + log_eps)


def _da_update(da: _DualAvg, alpha_mean, w: WarmupOptions) -> _DualAvg:
    t = da.t + 1.0
    eta = 1.0 / (t + w.t0)
    h_avg = (1.0 - eta) * da.h_avg + eta * (w.target_accept - alpha_mean)
    log_eps = da.mu - jnp.sqrt(t) / w.gamma * h_avg
    wk = t ** (-w.kappa)
    log_eps_avg = wk * log_eps + (1.0 - wk) * da.log_eps_avg
    return _DualAvg(log_eps=log_eps, log_eps_avg=log_eps_avg, h_avg=h_avg,
                    t=t, mu=da.mu)


class WarmupInfo(NamedTuple):
    dt: jax.Array          # adapted step size (dual-averaged)
    inv_m: jax.Array       # (P,) adapted diagonal inverse mass (posterior var)
    alpha_mean: jax.Array  # running mean acceptance probability


class WarmupCarry(NamedTuple):
    """Full adapter state carried across warmup segments — segmenting the
    warmup into multiple short device programs (one progress line and one
    checkpoint opportunity each) is bit-exact with running the
    whole warmup as one scan: the per-iteration keys are a pure function of
    the global iteration index and the window schedule is precomputed."""

    state: ChainState
    da: _DualAvg
    inv_m: jax.Array
    acc: tuple
    alpha_acc: tuple


def warmup_carry_init(potential_vg, opts: HMCOptions, m0, m_ref) -> WarmupCarry:
    P = m0.shape[-1]
    state = sample_chain_init(potential_vg, m0, m_ref)
    da0 = _da_init(jnp.asarray(opts.dt, m0.dtype))
    inv_m0 = jnp.ones((P,), m0.dtype)
    acc0 = (jnp.zeros((), m0.dtype), jnp.zeros((P,), m0.dtype),
            jnp.zeros((P,), m0.dtype))
    alpha_acc0 = (jnp.zeros(()), jnp.zeros(()))
    return WarmupCarry(state, da0, inv_m0, acc0, alpha_acc0)


def warmup_keys(key, it_offset: int, n: int):
    """Keys for warmup iterations [it_offset, it_offset + n) — a pure
    function of the global iteration index (segmentation-invariant)."""
    base = jax.random.fold_in(key, 2)
    return jax.vmap(lambda i: jax.random.fold_in(base, i))(
        jnp.arange(n) + it_offset)


def warmup_scan(potential_vg: Callable, opts: HMCOptions, m_ref,
                carry: WarmupCarry, keys, ends, w: WarmupOptions,
                pool_axis: str | None = None, sample_dtype=jnp.float32,
                factor_fn: Callable | None = None,
                fixed_mass: MassMatrix | None = None):
    """One warmup segment: scan over ``len(keys)`` adaptation iterations.

    With ``fixed_mass`` the kernel samples under that (possibly dense) mass
    matrix and only the step size adapts — the metric-readaptation phase of
    the Gauss-Newton / Wm mass schedule (pass ``ends`` all-False, the
    diagonal variance windows are meaningless under a fixed dense metric).

    Returns the advanced :class:`WarmupCarry` and the per-iteration output
    stack (models, stats, accepts, pred, lf_steps)."""
    C = m_ref.shape[0]
    step = make_sample_step(potential_vg, opts, factor_fn=factor_fn)

    def pool_mean(x):
        x = jnp.mean(x, axis=0)
        if pool_axis is not None:
            x = lax.pmean(x, pool_axis)
        return x

    def pool_alpha(x):
        if w.alpha_pool == "median":
            # robust to a stuck minority (see WarmupOptions.alpha_pool).
            # Sharded: there is no pmedian collective, but the chains axis
            # is small — all_gather the per-chain alphas and take the
            # median over the GLOBAL chain set (identical on every shard).
            if pool_axis is not None:
                x = lax.all_gather(x, pool_axis).reshape(-1)
            return jnp.median(x, axis=0)
        return pool_mean(x)

    n_chains = C

    def body(carry, inputs):
        state, da, inv_m, acc, alpha_acc = carry
        k, is_end = inputs
        mass = fixed_mass if fixed_mass is not None else MassMatrix(
            sqrt_m=lax.rsqrt(inv_m), inv_m=inv_m, diagonal=True)
        new, accept, stats, alpha, L = step(state, k, m_ref, jnp.exp(da.log_eps), mass)

        # a diverged trajectory (non-finite dH, e.g. float32 field overflow at
        # a too-large trial step) is a rejection with acceptance probability 0
        # — without this guard one NaN poisons the dual averaging forever
        alpha = jnp.where(jnp.isfinite(alpha), alpha, 0.0)
        alpha_mean = pool_alpha(alpha)
        da = _da_update(da, alpha_mean, w)

        n, s1, s2 = acc
        n = n + 1.0
        s1 = s1 + pool_mean(new.m)
        s2 = s2 + pool_mean(new.m * new.m)

        def close_window(args):
            n, s1, s2, inv_m, da = args
            # pooled variance over the window draws of all chains
            mean = s1 / n
            var = jnp.maximum(s2 / n - mean * mean, 1e-12)
            cnt = n * C
            var_reg = (cnt / (cnt + 5.0)) * var + 1e-3 * (5.0 / (cnt + 5.0))
            # restart dual averaging around the current step size
            da2 = _da_init(jnp.exp(da.log_eps))
            return (jnp.zeros_like(n), jnp.zeros_like(s1), jnp.zeros_like(s2),
                    var_reg, da2)

        n, s1, s2, inv_m, da = lax.cond(
            is_end, close_window, lambda a: a, (n, s1, s2, inv_m, da))

        an, asum = alpha_acc
        alpha_acc = (an + 1.0, asum + alpha_mean)

        out = (new.m.astype(sample_dtype), stats, accept,
               new.pred.astype(jnp.complex64 if jnp.iscomplexobj(new.pred)
                               else jnp.float32),
               jnp.broadcast_to(L.astype(jnp.int32), (n_chains,)))
        return WarmupCarry(new, da, inv_m, (n, s1, s2), alpha_acc), out

    return lax.scan(body, carry, (keys, ends))


def warmup_finalize(carry: WarmupCarry) -> tuple[MassMatrix, WarmupInfo]:
    """Adapted mass matrix and step-size/acceptance info from a carry."""
    da, inv_m = carry.da, carry.inv_m
    an, asum = carry.alpha_acc
    mass = MassMatrix(sqrt_m=lax.rsqrt(inv_m), inv_m=inv_m, diagonal=True)
    info = WarmupInfo(dt=jnp.exp(da.log_eps_avg), inv_m=inv_m,
                      alpha_mean=asum / jnp.maximum(an, 1.0))
    return mass, info


def start_row(state0: ChainState, key, shape, dtype=jnp.float32):
    """The reference's "Starting status" row: the PRE-warmup state with KE
    drawn under the initial identity mass (HMCSampler.jl:113-115,810-827),
    not the post-warmup misfit."""
    inv_m0 = jnp.ones(shape[-1:], dtype)
    mass0 = MassMatrix(sqrt_m=lax.rsqrt(inv_m0), inv_m=inv_m0, diagonal=True)
    ke = mass0.kinetic(mass0.draw(jax.random.fold_in(key, 3), shape))
    start_stats = jnp.stack([state0.misfit, state0.mnorm, ke,
                             state0.misfit + state0.mnorm + ke], axis=-1)
    start_pred = state0.pred.astype(
        jnp.complex64 if jnp.iscomplexobj(state0.pred) else jnp.float32)
    return start_stats, start_pred


def warmup(potential_vg: Callable, opts: HMCOptions, m0: jax.Array,
           m_ref: jax.Array, n_warmup: int, key, w: WarmupOptions | None = None,
           pool_axis: str | None = None, sample_dtype=jnp.float32,
           init_state: ChainState | None = None,
           factor_fn: Callable | None = None,
           fixed_mass: MassMatrix | None = None):
    """Adaptive warmup phase (single scan; see ``warmup_scan`` for the
    segmented building blocks the driver uses).

    Returns ``(result, state, mass, info)``: per-iteration records (an
    :class:`HMCResult`, so warmup draws appear in the output files like the
    reference's burn-in), the final chain state, the adapted
    :class:`MassMatrix` and a :class:`WarmupInfo` with the adapted step size.
    """
    w = w or WarmupOptions()
    carry0 = warmup_carry_init(potential_vg, opts, m0, m_ref)
    if init_state is not None:
        carry0 = carry0._replace(state=init_state)
    state0 = carry0.state
    ends = jnp.asarray(window_schedule(n_warmup, w)) \
        if (w.adapt_mass and fixed_mass is None) else jnp.zeros(n_warmup, bool)
    keys = warmup_keys(key, 0, n_warmup)
    carry, (models, stats, accepts, pred, lf) = warmup_scan(
        potential_vg, opts, m_ref, carry0, keys, ends, w,
        pool_axis=pool_axis, sample_dtype=sample_dtype, factor_fn=factor_fn,
        fixed_mass=fixed_mass)
    mass, info = warmup_finalize(carry)
    if fixed_mass is not None:
        mass = fixed_mass
    start_stats, start_pred = start_row(state0, key, m0.shape, m0.dtype)
    result = HMCResult(models=models, stats=stats, accepts=accepts, pred=pred,
                       final=carry.state, start_stats=start_stats,
                       start_pred=start_pred, lf_steps=lf)
    return result, carry.state, mass, info
