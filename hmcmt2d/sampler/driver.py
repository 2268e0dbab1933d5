"""High-level inversion driver: config + files -> chains -> posterior.

Equivalent of the reference's runHMCscript.jl / runHMCSampler wiring
(HMCSampler.jl:72-196, examples/*/runHMCscript.jl) with chains batched in
one jitted program instead of one chain per process.
"""

from __future__ import annotations

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..io.startup import HMCConfig
from ..utils.host import to_host, tree_to_host
from ..models.forward import SolveConfig
from ..models.posterior import InverseProblem, build_inverse_problem
from . import adapt as A
from . import hmc as H


@dataclasses.dataclass
class InversionRun:
    problem: InverseProblem
    result: H.HMCResult
    config: HMCConfig
    m_ref: np.ndarray       # (C, P) per-chain reference/start models
    wall_time: float
    n_warm: int = 0         # warmup iterations included at the head of result
    # (samples, seconds) of each main-phase segment this call ran; the first
    # of each compiled segment shape includes its compile
    segment_times: list = dataclasses.field(default_factory=list)
    dt: float = 0.0         # step size of the main phase

    def summary(self) -> dict:
        """Run metrics for ``run_summary.json``.  The main-phase rate is taken
        over the segments after the first (which includes its compile) when
        there are several; set-up is the rest of the wall time."""
        seg = self.segment_times
        steady = seg[1:] if len(seg) > 1 else seg
        n_steady = sum(n for n, _ in steady)
        t_steady = sum(t for _, t in steady)
        stats = np.asarray(self.result.stats)
        C = stats.shape[1]
        acc = np.asarray(self.result.accepts)[self.n_warm:]
        return {
            "chains": C,
            "warmup_samples": self.n_warm,
            "main_samples": int(stats.shape[0] - self.n_warm),
            "wall_time_s": self.wall_time,
            "setup_time_s": self.wall_time - t_steady,
            "main_samples_per_sec": (C * n_steady / t_steady if t_steady > 0
                                     else None),
            "dt": self.dt,
            "accept_rate_main": float(acc.mean()) if acc.size else None,
            "misfit_start": float(np.asarray(self.result.start_stats)[:, 0].mean()),
            "misfit_end": float(stats[-1, :, 0].mean()),
            "stats_finite": bool(np.isfinite(stats).all()),
            "nfevals": self.nfevals,
        }

    @property
    def nfevals(self) -> int:
        """Total gradient (forward+adjoint PDE sweep) evaluations across all
        chains — the reference's nfevals counter (HMCStruct.jl:34,
        HMCSampler.jl:217,252), plus one init evaluation per chain."""
        lf = np.asarray(self.result.lf_steps)
        return int(lf.sum()) + lf.shape[1]


def make_potential_vg(problem: InverseProblem, reg: float):
    """Batched (chains-leading) potential value-and-grad — NATIVE batching.

    Chains are an ordinary batch axis of the forward model (one merged
    (chains x freq x mode) factor+solve), and per-chain gradients come from a
    single ``value_and_grad`` of the chain-summed potential: chains are
    independent, so d(sum_c U_c)/dM stacks the per-chain gradients exactly.
    No ``jax.vmap`` on the gradient path: the native batch gives the
    solver one C-fold larger batched factorisation instead of C replayed
    programs.

    The returned callable accepts an optional batched ``fac`` third argument
    (per-chain stale factorisations from :func:`make_factor_fn`) for the
    trajectory-amortised path; gradients are w.r.t. the model only.
    """

    def total(m, m_ref, fac=None):
        U, aux = problem.potential(m, m_ref, reg, fac=fac)
        return jnp.sum(U), (U, aux)

    vg_total = jax.value_and_grad(total, has_aux=True)

    def vg(m, m_ref, fac=None):
        (_, (U, aux)), g = vg_total(m, m_ref, fac)
        return (U, aux), g

    return vg


def make_factor_fn(problem: InverseProblem):
    """Batched model -> merged-mode Factorization (trajectory amortisation).
    ``factor_state`` batches natively over leading chain axes."""
    return problem.factor_state


def mass_kind(cfg: HMCConfig) -> str:
    """'diagonal' | 'gn' | 'wm' — the reference treats any non-"diagonal"
    masstype as M=Wm (setMassMatrix, HMCSampler.jl:478-489); 'gaussnewton'
    is this build's extension."""
    mt = cfg.mass_type.lower()
    if mt == "diagonal":
        return "diagonal"
    if mt in ("gaussnewton", "gn"):
        return "gn"
    return "wm"


def make_mass(problem: InverseProblem, cfg: HMCConfig) -> H.MassMatrix:
    kind = mass_kind(cfg)
    if kind == "diagonal":
        # reference uses identity scaling 1.0 (HMCSampler.jl:81-84)
        return H.identity_mass(problem.n_param)
    if kind == "gn":
        raise ValueError("masstype gaussnewton requires adapt: on (the "
                         "Jacobian is evaluated at the warmed-up model)")
    return H.dense_mass(problem.wm_dense() + 1e-8 * np.eye(problem.n_param))


def gauss_newton_mass(problem: InverseProblem, m_repr, reg: float,
                      jac_problem: InverseProblem | None = None,
                      chunk: int = 128, jitter: float = 1e-6) -> H.MassMatrix:
    """Dense HMC mass M = J'W^2J + reg*Wm + jitter*mu*I — the Gauss-Newton
    approximation of the posterior precision at ``m_repr``.

    The reference exposes only the prior metric M = Wm (HMCSampler.jl:
    478-489); the GN metric additionally whitens the data-informed
    directions, so the leapfrog step is O(1) in the standardized posterior
    instead of being throttled by the stiffest data mode — the mixing lever
    (ESS/sample) the identity-mass rounds left on the table.  J is one
    linearisation + chunked batched multi-RHS adjoint solves
    (models/jacobian.full_jacobian_chunked); the Cholesky runs on host in
    float64.  ``jac_problem`` lets the hybrid driver evaluate J under the
    warmup engine while the returned mass serves the main engine.
    """
    from ..models import jacobian as JJ

    pj = jac_problem if jac_problem is not None else problem
    J = np.asarray(JJ.full_jacobian_chunked(pj, jnp.asarray(m_repr),
                                            chunk=chunk), np.float64)
    w = np.asarray(problem.weights, np.float64)
    if np.iscomplexobj(np.asarray(problem.obs)):
        w = np.concatenate([w, w])      # re/im rows share the datum weight
    Jw = J * w[:, None]
    M = Jw.T @ Jw + reg * np.asarray(problem.wm_dense(), np.float64)
    mu = np.trace(M) / M.shape[0]
    M += jitter * mu * np.eye(M.shape[0])
    return H.dense_mass(M)


def hmc_options(cfg: HMCConfig) -> H.HMCOptions:
    return H.HMCOptions(
        dt=cfg.dt,
        steps_lo=int(cfg.timestep[0]),
        steps_hi=int(cfg.timestep[1]),
        log_sig_lo=float(np.log(cfg.sig_bounds[0])),
        log_sig_hi=float(np.log(cfg.sig_bounds[1])),
        reg_param=cfg.reg_param,
    )


def _segment_plan(n_main: int, every: int) -> list[int]:
    """Segment lengths: full ``every``-sized segments plus a tail."""
    if every <= 0 or every >= n_main:
        return [n_main] if n_main > 0 else []
    segs = [every] * (n_main // every)
    if n_main % every:
        segs.append(n_main % every)
    return segs


def run_inversion(cfg: HMCConfig, mesh, sigma2d, data, obs, err,
                  n_chains: int | None = None, key=None,
                  solve_cfg: SolveConfig | None = None,
                  n_samples: int | None = None,
                  checkpoint_path: str | None = None,
                  checkpoint_every: int = 0,
                  checkpoint_stride: int = 1,
                  resume: bool = False,
                  device_mesh=None,
                  verbose: bool = False,
                  progress_every: int = 0,
                  warmup_solve_cfg: SolveConfig | None = None) -> InversionRun:
    """End-to-end inversion: all chains advance in one jitted scan, batched
    through the PDE solves.

    With ``device_mesh`` (a jax Mesh with axes 'chains', 'freq') the whole
    pipeline — warmup adaptation, segmented sampling, checkpoint/resume —
    runs SPMD via :class:`hmcmt2d.parallel.multichain.ShardedSampler`
    with identical semantics (statistics pooled across the chains axis,
    misfit/gradient psum'd over the freq axis).

    With ``checkpoint_path`` set, the post-warmup phase runs in
    ``checkpoint_every``-sample segments and dumps the full sampler state
    after each; ``resume=True`` continues from that file bit-exactly (the
    per-sample PRNG keys are a pure function of the global sample index, so
    the sample stream matches an uninterrupted run).  A checkpoint must be
    resumed on the same path kind it was written from (sharded vs single
    device) — the carried predicted-data layout differs.

    ``verbose`` prints per-phase progress lines (the reference prints
    per-iteration misfit/accept lines, HMCSampler.jl:145-166; one line per
    jitted segment is the batched equivalent — set ``progress_every`` to
    force shorter segments for more frequent lines).

    ``warmup_solve_cfg`` enables the HYBRID engine schedule: warmup
    adaptation runs with this (typically exact, e.g. thomas+complex64
    refine) solver configuration, and the post-warmup main phase re-
    initialises the chain state under the primary ``solve_cfg`` engine.
    Rationale: at a high-misfit random start an inexact engine's residual
    potential noise can defeat dual-averaging (dt collapse), while near the
    posterior the noise is negligible.  The main phase starts fresh at the
    warmed-up model (no cross-engine gradient carry-over), so the sample
    stream is exactly what the main engine alone would produce from that
    state.
    """
    from . import checkpoint as C

    n_chains = n_chains or cfg.n_chains
    key = key if key is not None else jax.random.PRNGKey(cfg.seed)
    n_samples = n_samples or cfg.total_samples

    problem, m0_file = build_inverse_problem(
        mesh, data, obs, err, np.asarray(sigma2d).ravel(),
        sigma_fixed=cfg.sig_fix, cfg=solve_cfg)

    key_start, key_run = jax.random.split(key)
    vg = make_potential_vg(problem, cfg.reg_param)
    opts = hmc_options(cfg)
    factor_fn = make_factor_fn(problem) if cfg.amortize else None

    # hybrid engine schedule: a second problem bound to the warmup engine
    hybrid = (warmup_solve_cfg is not None and cfg.adapt and not resume
              and warmup_solve_cfg != problem.fwd.cfg)
    if hybrid:
        problem_w = dataclasses.replace(
            problem, fwd=dataclasses.replace(problem.fwd, cfg=warmup_solve_cfg))
        vg_w = make_potential_vg(problem_w, cfg.reg_param)
        factor_fn_w = make_factor_fn(problem_w) if cfg.amortize else None
    else:
        problem_w, vg_w, factor_fn_w = problem, vg, factor_fn

    sharded = sharded_w = None
    if device_mesh is not None:
        from ..parallel.multichain import ShardedSampler
        sharded = ShardedSampler(problem, cfg.reg_param, device_mesh,
                                 amortize=cfg.amortize)
        sharded_w = sharded if not hybrid else ShardedSampler(
            problem_w, cfg.reg_param, device_mesh, amortize=cfg.amortize)

    def log(msg):
        if verbose:
            print(f"[hmcmt2d] {msg}", flush=True)

    t0 = time.time()
    wall_prev = 0.0
    acc_models, acc_stats, acc_accepts, acc_pred, acc_lf = [], [], [], [], []
    start_stats = start_pred = None

    if resume:
        if not (checkpoint_path and os.path.exists(checkpoint_path)):
            raise FileNotFoundError(f"no checkpoint to resume: {checkpoint_path}")
        ck = C.load_checkpoint(checkpoint_path)
        n_warm = ck["n_warm"]
        n_done = ck["n_done"]
        state, mass = ck["state"], ck["mass"]
        key_main = ck["key"]
        opts = dataclasses.replace(opts, dt=ck["dt"])
        m_ref = jnp.asarray(ck["m_ref"])
        m_start = m_ref
        start_stats = jnp.asarray(ck["start_stats"])
        start_pred = ck["start_pred"]          # host-side (complex) is fine
        wall_prev = ck["wall_time"]
        acc_models.append(ck["models"])
        acc_stats.append(ck["stats"])
        acc_accepts.append(ck["accepts"])
        acc_pred.append(ck["pred"])
        acc_lf.append(ck["lf_steps"])
        log(f"resumed {checkpoint_path}: {n_done}/{n_samples - n_warm} main "
            f"samples done, dt={opts.dt:.4g}")
    else:
        n_done = 0
        m_start = H.random_homogeneous_start(key_start, m0_file, n_chains)
        m_ref = m_start  # refModel = strModel (HMCSampler.jl:108-109)
        # with adaptation on, the warmup (and the dense-metric phase for
        # non-diagonal masstypes) replaces this initial mass entirely
        mass = (H.identity_mass(problem.n_param) if cfg.adapt
                else make_mass(problem, cfg))
        if cfg.adapt:
            # warmup over the burn-in iterations: dual-averaging step size +
            # diagonal mass adaptation, then a fixed-kernel main phase
            n_warm = min(cfg.burnin, n_samples)
            wopts = A.WarmupOptions(target_accept=cfg.target_accept,
                                    alpha_pool=getattr(cfg, "warmup_pool",
                                                       "mean"))
            key_warm, key_main = jax.random.split(key_run)
            if sharded_w is not None:
                wres, state, mass, info = sharded_w.warmup(
                    opts, m_start, m_ref, n_warm, key_warm, wopts,
                    seg=checkpoint_every or progress_every or 0)
                jax.block_until_ready(wres.models)
                start_stats = wres.start_stats
                start_pred = to_host(wres.start_pred)
                acc_models.append(np.asarray(wres.models))
                acc_stats.append(np.asarray(wres.stats))
                acc_accepts.append(np.asarray(wres.accepts))
                acc_pred.append(to_host(wres.pred))
                acc_lf.append(np.asarray(wres.lf_steps))
            else:
                # segmented warmup (one progress line per segment),
                # bit-exact with the single-scan A.warmup
                seg_w = checkpoint_every or progress_every or n_warm
                ends_full = np.asarray(
                    A.window_schedule(n_warm, wopts)) if wopts.adapt_mass \
                    else np.zeros(n_warm, bool)
                carry = jax.jit(lambda m0, mref: A.warmup_carry_init(
                    vg_w, opts, m0, mref))(m_start, m_ref)
                state0 = carry.state
                wseg = {}
                done_w = 0
                for n_sw in _segment_plan(n_warm, seg_w):
                    t_seg = time.time()
                    if n_sw not in wseg:
                        wseg[n_sw] = jax.jit(
                            lambda c, mref, k, off, e, n=n_sw: A.warmup_scan(
                                vg_w, opts, mref, c, A.warmup_keys(k, off, n),
                                e, wopts, factor_fn=factor_fn_w))
                    carry, (wm, ws, wa, wp, wl) = wseg[n_sw](
                        carry, m_ref, key_warm, done_w,
                        jnp.asarray(ends_full[done_w: done_w + n_sw]))
                    jax.block_until_ready(wm)
                    done_w += n_sw
                    acc_models.append(np.asarray(wm))
                    acc_stats.append(np.asarray(ws))
                    acc_accepts.append(np.asarray(wa))
                    acc_pred.append(to_host(wp))
                    acc_lf.append(np.asarray(wl))
                    log(f"warmup {done_w}/{n_warm}: "
                        f"misfit={float(np.asarray(ws)[-1, :, 0].mean()):.4g} "
                        f"dt={float(jnp.exp(carry.da.log_eps)):.4g} "
                        f"({n_sw * wm.shape[1] / (time.time() - t_seg):.2f} "
                        f"samples/s)")
                mass, info = jax.jit(A.warmup_finalize)(carry)
                state = carry.state
                ss, sp = jax.jit(lambda s0, shape=m_start.shape: A.start_row(
                    s0, key_warm, shape))(state0)
                start_stats = ss
                start_pred = to_host(sp)
            opts = dataclasses.replace(opts, dt=float(info.dt))
            # ---- dense-metric phase: build M (Gauss-Newton or Wm) at the
            # warmed-up model, then re-adapt the step size under the fixed
            # dense mass (the identity/diagonal dt is meaningless under a
            # new metric).  Runs under the warmup engine like phase A.
            mkind = mass_kind(cfg)

            def _build_dense_mass(m_repr):
                t_m = time.time()
                if mkind == "gn":
                    ms = gauss_newton_mass(problem, m_repr, cfg.reg_param,
                                           jac_problem=problem_w)
                else:
                    ms = H.dense_mass(problem.wm_dense()
                                      + 1e-8 * np.eye(problem.n_param))
                log(f"dense mass ({mkind}) built in {time.time() - t_m:.1f}s")
                return ms

            if mkind != "diagonal" and sharded_w is not None:
                # sharded dense phase runs under the warmup sampler (pre-
                # switch); the main phase then re-initialises as usual
                mass = _build_dense_mass(jnp.mean(state.m, axis=0))
                n_c = min(int(cfg.mass_warmup), max(0, n_samples - n_warm))
                if n_c > 0:
                    opts_c = dataclasses.replace(opts, dt=float(cfg.mass_dt0))
                    rres, state, info_c = sharded_w.readapt(
                        opts_c, state, m_ref, n_c, key_warm, wopts, mass,
                        seg=checkpoint_every or progress_every or 0,
                        it_offset=n_warm)
                    jax.block_until_ready(rres.models)
                    acc_models.append(np.asarray(rres.models))
                    acc_stats.append(np.asarray(rres.stats))
                    acc_accepts.append(np.asarray(rres.accepts))
                    acc_pred.append(to_host(rres.pred))
                    acc_lf.append(np.asarray(rres.lf_steps))
                    opts = dataclasses.replace(opts, dt=float(info_c.dt))
                    n_warm += n_c
                    log(f"mass-warmup (sharded) done: dt={opts.dt:.4g}, "
                        f"accept~{float(info_c.alpha_mean):.2f}")
            if hybrid:
                # engine switch BEFORE the dense-metric phase: the step-size
                # re-adaptation then tunes dt against the actual main-engine
                # potential near the posterior (where residual noise is
                # negligible) and its final state carries straight
                # into the main phase — no re-initialisation, and the dense
                # phase runs at main-engine speed
                m_start = state.m
                state = None
                log(f"hybrid: warmup engine "
                    f"{warmup_solve_cfg.solver_method} -> main engine "
                    f"{problem.fwd.cfg.solver_method}")
            if mkind != "diagonal" and sharded_w is None:
                mass = _build_dense_mass(
                    jnp.mean(m_start if state is None else state.m, axis=0))
                n_c = min(int(cfg.mass_warmup), max(0, n_samples - n_warm))
                if n_c > 0:
                    opts_c = dataclasses.replace(opts, dt=float(cfg.mass_dt0))
                    wopts_c = dataclasses.replace(wopts, adapt_mass=False)
                    if state is None:
                        # fresh main-engine evaluation at the warmed-up model
                        carry = jax.jit(lambda m0, mref: A.warmup_carry_init(
                            vg, opts_c, m0, mref))(m_start, m_ref)
                        carry = carry._replace(
                            da=A._da_init(jnp.asarray(opts_c.dt,
                                                      m_start.dtype)))
                    else:
                        P = state.m.shape[-1]
                        zero = jnp.zeros((), state.m.dtype)
                        carry = A.WarmupCarry(
                            state=state,
                            da=A._da_init(jnp.asarray(opts_c.dt,
                                                      state.m.dtype)),
                            inv_m=jnp.ones((P,), state.m.dtype),
                            acc=(zero, jnp.zeros((P,), state.m.dtype),
                                 jnp.zeros((P,), state.m.dtype)),
                            alpha_acc=(jnp.zeros(()), jnp.zeros(())))
                    seg_c = checkpoint_every or progress_every or n_c
                    cseg = {}
                    done_c = 0
                    for n_sc in _segment_plan(n_c, seg_c):
                        t_seg = time.time()
                        if n_sc not in cseg:
                            cseg[n_sc] = jax.jit(
                                lambda c, mref, k, off, sq, im, n=n_sc:
                                A.warmup_scan(
                                    vg, opts_c, mref, c,
                                    A.warmup_keys(k, off, n),
                                    jnp.zeros(n, bool), wopts_c,
                                    factor_fn=factor_fn,
                                    fixed_mass=H.MassMatrix(sq, im, False)))
                        carry, (wm, ws, wa, wp, wl) = cseg[n_sc](
                            carry, m_ref, key_warm, n_warm + done_c,
                            mass.sqrt_m, mass.inv_m)
                        jax.block_until_ready(wm)
                        done_c += n_sc
                        acc_models.append(np.asarray(wm))
                        acc_stats.append(np.asarray(ws))
                        acc_accepts.append(np.asarray(wa))
                        acc_pred.append(to_host(wp))
                        acc_lf.append(np.asarray(wl))
                        log(f"mass-warmup {done_c}/{n_c}: "
                            f"misfit={float(np.asarray(ws)[-1, :, 0].mean()):.4g} "
                            f"dt={float(jnp.exp(carry.da.log_eps)):.4g} "
                            f"({n_sc * wm.shape[1] / (time.time() - t_seg):.2f} "
                            f"samples/s)")
                    _m_unused, info_c = jax.jit(A.warmup_finalize)(carry)
                    state = carry.state     # main-engine state: flows on
                    opts = dataclasses.replace(opts, dt=float(info_c.dt))
                    n_warm += n_c
                    log(f"mass-warmup done: dt={opts.dt:.4g}, "
                        f"accept~{float(info_c.alpha_mean):.2f}")
            log(f"warmup {n_warm} iters in {time.time() - t0:.1f}s: adapted "
                f"dt={opts.dt:.4g}, accept~{float(info.alpha_mean):.2f}, "
                f"misfit {float(np.asarray(start_stats)[:, 0].mean()):.4g} -> "
                f"{float(np.asarray(acc_stats[-1])[-1, :, 0].mean()):.4g}")
        else:
            n_warm = 0
            key_main = key_run
            state = None   # first segment initialises itself (same key stream)

    n_main = n_samples - n_warm
    # per-sample keys are a pure function of the global sample index (run_hmc's
    # key_offset), so ANY segmentation — including a resume from a checkpoint
    # written under a different total-sample count — yields the same stream
    every = checkpoint_every if checkpoint_every else progress_every
    segs = _segment_plan(n_main - n_done, every)
    runs = {}
    segment_times = []
    for i_seg, n_seg in enumerate(segs):
        t_seg = time.time()
        if sharded is not None:
            res = sharded.run(opts, mass,
                              state.m if state is not None else m_start,
                              m_ref, n_seg, key_main,
                              init_state=state, key_offset=n_done)
        else:
            rkey = (n_seg, state is None)
            if rkey not in runs:
                # the mass is an argument, not a closure: a dense metric
                # baked in as constants makes a huge executable
                runs[rkey] = jax.jit(
                    lambda st, m0, mref, k, off, sq, im, n=n_seg: H.run_hmc(
                        vg, opts, H.MassMatrix(sq, im, mass.diagonal),
                        st.m if st is not None else m0, mref, n, k,
                        init_state=st, key_offset=off, factor_fn=factor_fn))
            res = runs[rkey](state, m_start, m_ref, key_main, n_done,
                             mass.sqrt_m, mass.inv_m)
        jax.block_until_ready(res.models)
        segment_times.append((n_seg, time.time() - t_seg))
        state = res.final
        n_done += n_seg
        if start_stats is None:
            start_stats = res.start_stats
            start_pred = to_host(res.start_pred)
        acc_models.append(np.asarray(res.models))
        acc_stats.append(np.asarray(res.stats))
        acc_accepts.append(np.asarray(res.accepts))
        acc_pred.append(to_host(res.pred))
        acc_lf.append(np.asarray(res.lf_steps))
        log(f"samples {n_done - n_seg + 1}..{n_done}/{n_main}: "
            f"misfit={float(np.asarray(res.stats)[-1, :, 0].mean()):.4g} "
            f"accept={float(np.asarray(res.accepts).mean()):.2f} "
            f"dt={opts.dt:.4g} "
            f"({n_seg * res.models.shape[1] / (time.time() - t_seg):.2f} samples/s)")
        # checkpoint every `checkpoint_stride` segments (and on the last):
        # rewriting the full sample history after every short segment would
        # dominate late in a long run
        if checkpoint_path and (
                (i_seg + 1) % max(checkpoint_stride, 1) == 0
                or i_seg == len(segs) - 1):
            C.save_checkpoint(
                checkpoint_path, n_done=n_done, state=tree_to_host(state),
                key=key_main,
                dt=opts.dt, mass=mass, m_ref=m_ref,
                models=np.concatenate(acc_models),
                stats=np.concatenate(acc_stats),
                accepts=np.concatenate(acc_accepts),
                pred=np.concatenate(acc_pred),
                lf_steps=np.concatenate(acc_lf),
                start_stats=np.asarray(start_stats),
                start_pred=to_host(start_pred),
                n_warm=n_warm, wall_time=wall_prev + time.time() - t0)

    result = H.HMCResult(
        models=jnp.asarray(np.concatenate(acc_models)),
        stats=jnp.asarray(np.concatenate(acc_stats)),
        accepts=jnp.asarray(np.concatenate(acc_accepts)),
        pred=np.concatenate(acc_pred),
        final=state, start_stats=jnp.asarray(start_stats),
        start_pred=np.asarray(to_host(start_pred)),
        lf_steps=jnp.asarray(np.concatenate(acc_lf)))
    wall = wall_prev + time.time() - t0

    return InversionRun(problem=problem, result=result, config=cfg,
                        m_ref=np.asarray(m_ref), wall_time=wall, n_warm=n_warm,
                        segment_times=segment_times, dt=float(opts.dt))
