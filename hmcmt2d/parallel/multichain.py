"""Multi-device / multi-host parallel sampling over a (chains, freq) mesh.

Device-mesh replacement for the reference's process-level multi-chain
parallelism (parallelHMC.jl: one Julia worker per chain via
``remotecall_fetch``, zero communication).  Here:

* the **chains** mesh axis is pure data parallelism — each device advances
  its chain shard inside one jitted SPMD program (no collectives in the
  sampling loop, exactly like the reference's embarrassingly parallel
  design);
* the **freq** mesh axis is model parallelism over the PDE solves: each
  device solves its frequency shard of the (freq x mode) systems and the
  data misfit/gradient are ``psum``-reduced over the axis — the axis the
  reference iterates sequentially (MT2DFwdSolver.jl:140-171);
* warmup adaptation pools acceptance/variance statistics across the chains
  axis with ``lax.pmean`` so the sharded run adapts exactly like the
  single-device batched run pooling all its chains;
* cross-chain diagnostics (R-hat/ESS) and posterior pooling run on the
  gathered samples.

Multi-host: initialise with :func:`distributed_init` (jax.distributed), the
same code then spans hosts with chains across hosts and freq within one.

:class:`ShardedSampler` exposes ``warmup``/``run`` with the same signatures
and semantics as :func:`hmcmt2d.sampler.adapt.warmup` and
:func:`hmcmt2d.sampler.hmc.run_hmc`, so the driver can run its full
warmup -> segmented/checkpointed main phase unchanged on a device mesh.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..models.posterior import InverseProblem
from ..sampler import adapt as A
from ..sampler import hmc as H


def distributed_init(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None):
    """Initialise multi-host JAX (jax.distributed.initialize); no-op when no
    coordinator is given (single host)."""
    if coordinator is None:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def make_device_mesh(n_chain_dev: int | None = None, n_freq_dev: int = 1,
                     devices=None) -> Mesh:
    """Device mesh with named axes ('chains', 'freq').

    Defaults to all devices on the chains axis.  The freq axis should stay
    within a host (NVLink); chains may span hosts as the sampling loop has
    no cross-chain communication.
    """
    devices = devices if devices is not None else jax.devices()
    n_chain_dev = n_chain_dev or (len(devices) // n_freq_dev)
    dev = np.asarray(devices[: n_chain_dev * n_freq_dev]).reshape(
        n_chain_dev, n_freq_dev)
    return Mesh(dev, ("chains", "freq"))


def _pred_spec():
    return P("chains", "freq")


_STATE_SPEC = H.ChainState(m=P("chains"), grad=P("chains"), misfit=P("chains"),
                           mnorm=P("chains"), pred=P("chains", "freq"))

_RESULT_SPEC = H.HMCResult(
    models=P(None, "chains"), stats=P(None, "chains"),
    accepts=P(None, "chains"), pred=P(None, "chains", "freq"),
    final=_STATE_SPEC, start_stats=P("chains"),
    start_pred=P("chains", "freq"), lf_steps=P(None, "chains"))


class ShardedSampler:
    """Shard-mapped warmup + sampling over a (chains, freq) device mesh.

    The interior carried :class:`ChainState` keeps its ``pred`` leaf as the
    *local dense response cube* reshaped to (local chains, local freq, rest);
    the returned :class:`HMCResult` has ``pred``/``start_pred`` masked onto
    the observed data triples so callers see exactly what the single-device
    sampler returns, while ``final`` keeps the cube form so it can feed the
    next segment or a checkpoint/resume cycle.
    """

    def __init__(self, problem: InverseProblem, reg: float, mesh: Mesh,
                 amortize: bool = True):
        self.problem = problem
        self.reg = reg
        self.mesh = mesh
        self.amortize = amortize
        data = problem.fwd.data
        self.n_freq_dev = mesh.shape["freq"]
        self.n_chain_dev = mesh.shape["chains"]
        if data.n_freq % self.n_freq_dev:
            raise ValueError(
                f"frequencies ({data.n_freq}) must divide the freq mesh axis "
                f"({self.n_freq_dev})")
        obs_cube, w_cube = problem.cube_arrays()
        self.freqs = jnp.asarray(data.freqs)
        self.obs_cube = jnp.asarray(obs_cube)
        self.w_cube = jnp.asarray(w_cube)
        self.flat_index = jnp.asarray(data.flat_index)
        self._jitted = {}

    # -- potential ---------------------------------------------------------
    def _potential_vg(self, freqs_l, obs_l, w_l):
        """Batched over local chains, psum-reduced over the freq mesh axis.

        The local potential carries this shard's misfit plus 1/k of the
        (replicated) prior; psum of both the value and the gradient over
        'freq' reconstructs the exact global potential and its gradient on
        every shard.  (Inside shard_map, grad-of-psum alone would yield only
        the local contribution — the transpose of psum is identity on a
        replicated cotangent — so the gradient must be psum'd explicitly.)
        """
        problem, reg = self.problem, self.reg
        prior_scale = 1.0 / self.n_freq_dev

        def total(m, m_ref_, fac=None):
            # chains batched NATIVELY (no vmap — see driver.make_potential_vg):
            # per-chain grads = grad of the chain-summed local potential
            U, aux = problem.potential_cube(m, m_ref_, reg, freqs_l, obs_l,
                                            w_l, prior_scale=prior_scale,
                                            fac=fac)
            return jnp.sum(U), (U, aux)

        vg_total = jax.value_and_grad(total, has_aux=True)

        def vg(m, m_ref_, fac=None):
            (_, (U, (mis, mn, pred))), g = vg_total(m, m_ref_, fac)
            U, mis, mn, g = lax.psum((U, mis, mn, g), "freq")
            return (U, (mis, mn, pred)), g

        return vg

    def _factor_fn(self, freqs_l):
        """Batched local-frequency-shard factorisation (amortised path)."""
        if not self.amortize:
            return None
        return lambda m: self.problem.factor_state_cube(m, freqs_l)

    def _chain_key(self, key):
        # distinct RNG per chains-shard, identical across the freq axis so
        # every freq-shard of a chain sees the same momenta/accept draws
        return jax.random.fold_in(key, lax.axis_index("chains"))

    def _split_cube(self, res: H.HMCResult, nf_l: int) -> H.HMCResult:
        def split(p):
            return p.reshape(p.shape[:-1] + (nf_l, -1))
        return res._replace(pred=split(res.pred),
                            start_pred=split(res.start_pred),
                            final=res.final._replace(pred=split(res.final.pred)))

    def _mask(self, res: H.HMCResult) -> H.HMCResult:
        """Mask the gathered dense cubes onto the observed (freq, rx, comp)
        triples — global postprocessing outside shard_map."""
        idx = self.flat_index

        def mask(p):
            return p.reshape(p.shape[:-2] + (-1,))[..., idx]

        return res._replace(pred=mask(res.pred), start_pred=mask(res.start_pred))

    def potential_value_and_grad(self, m, m_ref):
        """(U (C,), grad (C, P), pred (C, D)) of the sharded potential at
        (C, P) models: what the sharded leapfrog sees, for checks against
        the single-device :func:`hmcmt2d.sampler.driver.make_potential_vg`."""
        if "vg" not in self._jitted:
            @partial(jax.shard_map, mesh=self.mesh,
                     in_specs=(P("chains"), P("chains"), P("freq"), P("freq"),
                               P("freq")),
                     out_specs=(P("chains"), P("chains"), P("chains", "freq")),
                     check_vma=False)
            def sharded_vg(m_l, mref_l, freqs_l, obs_l, w_l):
                vg = self._potential_vg(freqs_l, obs_l, w_l)
                (U, (_mis, _mn, pred)), g = vg(m_l, mref_l)
                return U, g, pred.reshape(pred.shape[:-1]
                                          + (freqs_l.shape[0], -1))

            self._jitted["vg"] = jax.jit(sharded_vg)
        U, g, pred = self._jitted["vg"](m, m_ref, self.freqs, self.obs_cube,
                                        self.w_cube)
        return U, g, pred.reshape(pred.shape[:-2] + (-1,))[..., self.flat_index]

    # -- sampling ----------------------------------------------------------
    def run(self, opts: H.HMCOptions, mass: H.MassMatrix, m_start, m_ref,
            n_samples: int, key, init_state: H.ChainState | None = None,
            key_offset: int = 0) -> H.HMCResult:
        """Sharded equivalent of :func:`hmc.run_hmc` (same per-chain-shard key
        schedule; ``key_offset`` is a pure function of the global sample index
        so segmented/resumed runs are bit-exact, as in the driver).

        ``opts`` (incl. the possibly warmup-adapted ``dt``) is static: a new
        value retraces, which happens once per run.  ``key_offset`` is traced.
        """
        C = m_start.shape[0]
        if C % self.n_chain_dev:
            raise ValueError(f"chains ({C}) must divide the chains mesh axis "
                             f"({self.n_chain_dev})")
        cache_key = ("run", n_samples, init_state is not None,
                     bool(mass.diagonal), opts)
        if cache_key not in self._jitted:
            diag = bool(mass.diagonal)
            has_init = init_state is not None

            in_specs = (P("chains"), P("chains"), P("freq"), P("freq"), P("freq"),
                        P(), (P(), P()), P()) + ((_STATE_SPEC,) if has_init else ())

            @partial(jax.shard_map, mesh=self.mesh, in_specs=in_specs,
                     out_specs=_RESULT_SPEC, check_vma=False)
            def sharded_run(m0_l, mref_l, freqs_l, obs_l, w_l, key, mass_arrs,
                            key_off, *maybe_state):
                vg = self._potential_vg(freqs_l, obs_l, w_l)
                key_l = self._chain_key(key)
                mass_l = H.MassMatrix(mass_arrs[0], mass_arrs[1], diag)
                st = None
                if maybe_state:
                    st = maybe_state[0]
                    st = st._replace(pred=st.pred.reshape(st.pred.shape[:-2] + (-1,)))
                res = H.run_hmc(vg, opts, mass_l, m0_l, mref_l, n_samples,
                                key_l, init_state=st, key_offset=key_off,
                                factor_fn=self._factor_fn(freqs_l))
                return self._split_cube(res, freqs_l.shape[0])

            self._jitted[cache_key] = jax.jit(sharded_run)

        args = (m_start, m_ref, self.freqs, self.obs_cube, self.w_cube, key,
                (mass.sqrt_m, mass.inv_m), jnp.asarray(key_offset))
        if init_state is not None:
            args = args + (init_state,)
        res = self._jitted[cache_key](*args)
        return self._mask(res)

    # -- warmup ------------------------------------------------------------
    def warmup(self, opts: H.HMCOptions, m0, m_ref, n_warm: int, key,
               wopts: A.WarmupOptions | None = None, seg: int = 0):
        """Sharded equivalent of :func:`adapt.warmup`: dual-averaging step
        size + windowed diagonal mass, statistics pooled across the local
        chain batch AND the chains mesh axis (``pool_axis='chains'``).

        ``seg`` > 0 runs the warmup as a sequence of ``seg``-iteration
        device programs carrying the full adapter state across segments —
        bit-exact with the single-program path (same per-global-iteration
        key schedule and precomputed window schedule), with one progress
        line per segment."""
        C = m0.shape[0]
        if C % self.n_chain_dev:
            raise ValueError(f"chains ({C}) must divide the chains mesh axis "
                             f"({self.n_chain_dev})")
        wopts = wopts or A.WarmupOptions()
        if seg and seg < n_warm:
            return self._warmup_segmented(opts, m0, m_ref, n_warm, key,
                                          wopts, seg)
        cache_key = ("warmup", n_warm, opts, wopts)
        if cache_key not in self._jitted:
            out_specs = (_RESULT_SPEC, _STATE_SPEC, (P(), P()),
                         A.WarmupInfo(dt=P(), inv_m=P(), alpha_mean=P()))

            @partial(jax.shard_map, mesh=self.mesh,
                     in_specs=(P("chains"), P("chains"), P("freq"), P("freq"),
                               P("freq"), P()),
                     out_specs=out_specs, check_vma=False)
            def sharded_warmup(m0_l, mref_l, freqs_l, obs_l, w_l, key):
                vg = self._potential_vg(freqs_l, obs_l, w_l)
                key_l = self._chain_key(key)
                result, state, mass, info = A.warmup(
                    vg, opts, m0_l, mref_l, n_warm, key_l, wopts,
                    pool_axis="chains",
                    factor_fn=self._factor_fn(freqs_l))
                result = self._split_cube(result, freqs_l.shape[0])
                state = state._replace(
                    pred=state.pred.reshape(state.pred.shape[:-1]
                                            + (freqs_l.shape[0], -1)))
                return result, state, (mass.sqrt_m, mass.inv_m), info

            self._jitted[cache_key] = jax.jit(sharded_warmup)

        result, state, (sq, im), info = self._jitted[cache_key](
            m0, m_ref, self.freqs, self.obs_cube, self.w_cube, key)
        mass = H.MassMatrix(sqrt_m=sq, inv_m=im, diagonal=True)
        return self._mask(result), state, mass, info

    def _carry_spec(self):
        return A.WarmupCarry(
            state=_STATE_SPEC,
            da=A._DualAvg(P(), P(), P(), P(), P()),
            inv_m=P(), acc=(P(), P(), P()), alpha_acc=(P(), P()))

    # -- dense-metric step-size re-adaptation -------------------------------
    def readapt(self, opts: H.HMCOptions, state: H.ChainState, m_ref,
                n_iters: int, key, wopts: A.WarmupOptions,
                mass: H.MassMatrix, seg: int = 0, it_offset: int = 0):
        """dt-only dual-averaging under a FIXED (typically dense
        Gauss-Newton/Wm) mass, continuing from ``state`` — the sharded
        equivalent of the driver's dense-metric warmup phase.  ``opts.dt``
        is the dual-averaging restart step size; ``it_offset`` continues
        the global warmup key schedule.  Returns (result, state, info)."""
        import numpy as _np

        carry_spec = self._carry_spec()
        P_ = m_ref.shape[-1]
        dt0 = jnp.asarray(opts.dt, jnp.result_type(float))
        zero = jnp.zeros(())
        carry = A.WarmupCarry(
            state=state, da=A._da_init(dt0),
            inv_m=jnp.ones((P_,)),
            acc=(zero, jnp.zeros((P_,)), jnp.zeros((P_,))),
            alpha_acc=(jnp.zeros(()), jnp.zeros(())))
        wopts = dataclasses.replace(wopts, adapt_mass=False)

        parts = []
        done = 0
        seg = seg or n_iters
        while done < n_iters:
            n_seg = min(seg, n_iters - done)
            ck = ("readapt", n_seg, opts, wopts, bool(mass.diagonal))
            if ck not in self._jitted:
                diag = bool(mass.diagonal)
                out_res = (P(None, "chains"), P(None, "chains"),
                           P(None, "chains"), P(None, "chains", "freq"),
                           P(None, "chains"))

                @partial(jax.shard_map, mesh=self.mesh,
                         in_specs=(carry_spec, P("chains"), P("freq"),
                                   P("freq"), P("freq"), P(), P(),
                                   (P(), P())),
                         out_specs=(carry_spec, out_res), check_vma=False)
                def sharded_readapt(c, mref_l, freqs_l, obs_l, w_l, key, off,
                                    mass_arrs, n=n_seg):
                    vg = self._potential_vg(freqs_l, obs_l, w_l)
                    key_l = self._chain_key(key)
                    nf_l = freqs_l.shape[0]
                    mass_l = H.MassMatrix(mass_arrs[0], mass_arrs[1], diag)
                    c = c._replace(state=c.state._replace(
                        pred=c.state.pred.reshape(c.state.pred.shape[:-2] + (-1,))))
                    c, (wm, ws, wa, wp, wl) = A.warmup_scan(
                        vg, opts, mref_l, c, A.warmup_keys(key_l, off, n),
                        jnp.zeros(n, bool), wopts, pool_axis="chains",
                        factor_fn=self._factor_fn(freqs_l),
                        fixed_mass=mass_l)
                    split = lambda p: p.reshape(p.shape[:-1] + (nf_l, -1))
                    c = c._replace(state=c.state._replace(
                        pred=split(c.state.pred)))
                    return c, (wm, ws, wa, split(wp), wl)

                self._jitted[ck] = jax.jit(sharded_readapt)
            carry, out = self._jitted[ck](
                carry, m_ref, self.freqs, self.obs_cube, self.w_cube, key,
                jnp.asarray(it_offset + done), (mass.sqrt_m, mass.inv_m))
            parts.append(out)
            done += n_seg

        _mass_d, info = jax.jit(A.warmup_finalize)(carry)
        cat = lambda i: jnp.concatenate([p[i] for p in parts], axis=0)
        result = H.HMCResult(
            models=cat(0), stats=cat(1), accepts=cat(2), pred=cat(3),
            final=carry.state, start_stats=jnp.zeros_like(cat(1)[0]),
            start_pred=cat(3)[0], lf_steps=cat(4))
        return self._mask(result), carry.state, info

    def _warmup_segmented(self, opts, m0, m_ref, n_warm, key, wopts, seg):
        import numpy as _np

        carry_spec = self._carry_spec()
        ends_full = _np.asarray(A.window_schedule(n_warm, wopts)) \
            if wopts.adapt_mass else _np.zeros(n_warm, bool)

        ck = ("winit", opts)
        if ck not in self._jitted:
            @partial(jax.shard_map, mesh=self.mesh,
                     in_specs=(P("chains"), P("chains"), P("freq"), P("freq"),
                               P("freq"), P()),
                     out_specs=(carry_spec, P("chains"), P("chains", "freq")),
                     check_vma=False)
            def sharded_init(m0_l, mref_l, freqs_l, obs_l, w_l, key):
                vg = self._potential_vg(freqs_l, obs_l, w_l)
                c = A.warmup_carry_init(vg, opts, m0_l, mref_l)
                ss, sp = A.start_row(c.state, self._chain_key(key), m0_l.shape)
                nf_l = freqs_l.shape[0]
                split = lambda p: p.reshape(p.shape[:-1] + (nf_l, -1))
                c = c._replace(state=c.state._replace(pred=split(c.state.pred)))
                return c, ss, split(sp)

            self._jitted[ck] = jax.jit(sharded_init)

        carry, start_stats, start_pred = self._jitted[ck](
            m0, m_ref, self.freqs, self.obs_cube, self.w_cube, key)

        parts = []
        done = 0
        while done < n_warm:
            n_seg = min(seg, n_warm - done)
            ck2 = ("wseg", n_seg, opts, wopts)
            if ck2 not in self._jitted:
                out_res = (P(None, "chains"), P(None, "chains"),
                           P(None, "chains"), P(None, "chains", "freq"),
                           P(None, "chains"))

                @partial(jax.shard_map, mesh=self.mesh,
                         in_specs=(carry_spec, P("chains"), P("freq"),
                                   P("freq"), P("freq"), P(), P(), P(None)),
                         out_specs=(carry_spec, out_res), check_vma=False)
                def sharded_seg(c, mref_l, freqs_l, obs_l, w_l, key, off,
                                ends_seg):
                    n = ends_seg.shape[0]
                    vg = self._potential_vg(freqs_l, obs_l, w_l)
                    key_l = self._chain_key(key)
                    nf_l = freqs_l.shape[0]
                    c = c._replace(state=c.state._replace(
                        pred=c.state.pred.reshape(c.state.pred.shape[:-2] + (-1,))))
                    c, (wm, ws, wa, wp, wl) = A.warmup_scan(
                        vg, opts, mref_l, c, A.warmup_keys(key_l, off, n),
                        ends_seg, wopts, pool_axis="chains",
                        factor_fn=self._factor_fn(freqs_l))
                    split = lambda p: p.reshape(p.shape[:-1] + (nf_l, -1))
                    c = c._replace(state=c.state._replace(
                        pred=split(c.state.pred)))
                    return c, (wm, ws, wa, split(wp), wl)

                self._jitted[ck2] = jax.jit(sharded_seg)
            carry, out = self._jitted[ck2](
                carry, m_ref, self.freqs, self.obs_cube, self.w_cube, key,
                jnp.asarray(done), jnp.asarray(ends_full[done: done + n_seg]))
            parts.append(out)
            done += n_seg

        mass, info = jax.jit(A.warmup_finalize)(carry)
        mass = H.MassMatrix(sqrt_m=mass.sqrt_m, inv_m=mass.inv_m, diagonal=True)
        cat = lambda i: jnp.concatenate([p[i] for p in parts], axis=0)
        result = H.HMCResult(
            models=cat(0), stats=cat(1), accepts=cat(2), pred=cat(3),
            final=carry.state, start_stats=start_stats,
            start_pred=start_pred, lf_steps=cat(4))
        return self._mask(result), carry.state, mass, info


def run_sharded_hmc(problem: InverseProblem, opts: H.HMCOptions,
                    mass: H.MassMatrix, m_start: jax.Array, m_ref: jax.Array,
                    n_samples: int, key, mesh: Mesh,
                    sample_dtype=jnp.float32) -> H.HMCResult:
    """One-shot sharded run (no warmup/segments): thin wrapper over
    :class:`ShardedSampler` kept for API compatibility."""
    return ShardedSampler(problem, opts.reg_param, mesh).run(
        opts, mass, m_start, m_ref, n_samples, key)
