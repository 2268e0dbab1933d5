"""Benchmark: HMC sampling throughput on the dprism-scale flagship workload.

    python bench.py            # on an NVIDIA GPU; refuses any other backend
    python bench.py --smoke    # CPU rehearsal of the pipeline on a tiny problem

Prints ONE JSON line whose required fields are {"metric", "value", "unit",
"vs_baseline"}; it also names the device (``platform``, ``device_kind``,
``device_count``, ``card`` = nvidia-smi name and power limit), and extra
fields carry the BASELINE.json metric set:

value               = HMC samples/sec/chip at the best measured chain count
                      (each sample = L~U[6,10] leapfrog steps; each step = one
                      forward + one adjoint PDE sweep over 11 freqs x 2 modes
                      solved as ONE batched system).  Measured on the ADAPTED
                      production kernel: a segmented warmup (dual-averaging dt
                      + diagonal mass, sampler/adapt.py) runs first so the MH
                      acceptance lands in the production band — the samples/s
                      figure doubles as the engine rate (leapfrog work per
                      sample is independent of dt and the MH outcome).
ess_per_sec_per_chip= effective samples/sec (rank-normalized bulk ESS,
                      Vehtari et al. 2021, median over params, >=200-sample
                      window at the adapted kernel).
solves_per_sec      = (freq x mode) forward+adjoint linear-system pairs/sec.
nfevals             = gradient evaluations in the ESS run (the reference's
                      counter, HMCStruct.jl:34).
flops_per_sec_est   = analytic FLOP estimate / wall: the factorisation is
                      nzi sequential batched complex 95x95 inverses (an
                      estimate, not a roofline share).
vs_baseline         = ratio vs. a measured CPU reference: SINGLE-THREADED
                      scipy sparse-LU factorisations + solves for the same
                      per-sample solve counts (the reference's Julia
                      lu/MUMPS pipeline runs 48 MKL threads; the reference
                      publishes no numbers).

Any failed phase fails the run: there is no fallback measurement.
"""

import json
import sys
import time

import numpy as np


def _realistic(problem_factory):
    """Flagship problem with observations generated from its own start model
    plus 3% noise, so the sampler has a sane posterior (the raw factory uses
    placeholder obs, which makes acceptance statistics meaningless)."""
    import jax
    import jax.numpy as jnp

    from hmcmt2d.utils.host import to_host

    problem, m0 = problem_factory()
    predict = jax.jit(lambda m: problem.fwd.predict(problem.sigma2d(m)))
    obs = to_host(predict(jnp.asarray(m0, jnp.float32)))
    rng = np.random.default_rng(0)
    noise = (rng.standard_normal(len(obs)) + 1j * rng.standard_normal(len(obs)))
    obs = obs * (1 + 0.03 * noise / np.sqrt(2))
    err = 0.03 * np.abs(obs)
    problem = problem.__class__(fwd=problem.fwd, obs=obs, weights=1.0 / err,
                                active_idx=problem.active_idx,
                                bg_flat=problem.bg_flat)
    return problem, m0


def _build(problem_factory, n_chains, amortize=True, seg=8, n_warm=0,
           gn_mass=False, n_readapt=56):
    """Segmented runner: each device program advances ``seg`` samples and
    returns the carried ChainState, like the production driver's checkpoint
    segments.

    With ``n_warm`` > 0, a segmented dual-averaging + diagonal-mass warmup
    (the PRODUCTION kernel adaptation, sampler/adapt.py) runs first and the
    returned runner samples with the adapted (dt, mass), so the acceptance
    lands in the production band and ESS/s describes a working sampler."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from hmcmt2d.sampler import adapt as A
    from hmcmt2d.sampler import hmc as H
    from hmcmt2d.sampler.driver import make_factor_fn, make_potential_vg

    problem, m0 = _realistic(problem_factory)
    vg = make_potential_vg(problem, 1.0)
    factor_fn = make_factor_fn(problem) if amortize else None
    opts = H.HMCOptions(dt=0.03, steps_lo=6, steps_hi=10,
                        log_sig_lo=float(np.log(1e-4)),
                        log_sig_hi=float(np.log(1.0)), reg_param=1.0)
    mass = H.identity_mass(len(m0), jnp.float32)
    m_start = jnp.broadcast_to(jnp.asarray(m0, jnp.float32),
                               (n_chains, len(m0)))
    init_state = None

    if n_warm > 0:
        wopts = A.WarmupOptions()
        ends = np.asarray(A.window_schedule(n_warm, wopts))
        wkey = jax.random.PRNGKey(7)
        carry = jax.jit(lambda m, mref: A.warmup_carry_init(
            vg, opts, m, mref))(m_start, m_start)
        wsegs = {}          # per-length jit cache: n_warm need not divide seg
        done = 0
        while done < n_warm:
            n_sw = min(seg, n_warm - done)
            if n_sw not in wsegs:
                wsegs[n_sw] = jax.jit(lambda c, k, off, e, n=n_sw: A.warmup_scan(
                    vg, opts, m_start, c, A.warmup_keys(k, off, n), e, wopts,
                    factor_fn=factor_fn))
            carry, _ = wsegs[n_sw](carry, wkey, done,
                                   jnp.asarray(ends[done: done + n_sw]))
            jax.block_until_ready(carry.state.m)
            done += n_sw
        mass, info = jax.jit(A.warmup_finalize)(carry)
        opts = dataclasses.replace(opts, dt=float(info.dt))
        init_state = carry.state

        if gn_mass:
            # PRODUCTION dense metric: Gauss-Newton mass at the warmed-up
            # model, then a segmented dt re-adaptation under the fixed dense
            # mass, mirroring the driver's masstype: gaussnewton schedule.
            from hmcmt2d.sampler.driver import gauss_newton_mass

            m_repr = jnp.mean(carry.state.m, axis=0)
            mass = gauss_newton_mass(problem, m_repr, 1.0, chunk=128)
            wopts2 = dataclasses.replace(wopts, adapt_mass=False)
            P = carry.state.m.shape[-1]
            dt32 = jnp.asarray(0.2, jnp.float32)
            zero = jnp.zeros((), jnp.float32)
            carry = A.WarmupCarry(
                state=carry.state, da=A._da_init(dt32),
                inv_m=jnp.ones((P,), jnp.float32),
                acc=(zero, jnp.zeros((P,), jnp.float32),
                     jnp.zeros((P,), jnp.float32)),
                alpha_acc=(jnp.zeros(()), jnp.zeros(())))
            opts2 = dataclasses.replace(opts, dt=0.2)
            rsegs = {}
            done2 = 0
            while done2 < n_readapt:
                n_sw = min(seg, n_readapt - done2)
                if n_sw not in rsegs:
                    rsegs[n_sw] = jax.jit(
                        lambda c, k, off, sq, im, n=n_sw: A.warmup_scan(
                            vg, opts2, m_start, c, A.warmup_keys(k, off, n),
                            jnp.zeros(n, bool), wopts2, factor_fn=factor_fn,
                            fixed_mass=H.MassMatrix(sq, im, False)))
                carry, _ = rsegs[n_sw](carry, wkey, n_warm + done2,
                                       mass.sqrt_m, mass.inv_m)
                jax.block_until_ready(carry.state.m)
                done2 += n_sw
            _m2, info2 = jax.jit(A.warmup_finalize)(carry)
            opts = dataclasses.replace(opts, dt=float(info2.dt))
            init_state = carry.state

    first = jax.jit(lambda k, off, n=seg: H.run_hmc(
        vg, opts, mass, m_start, m_start, n, k, key_offset=off,
        factor_fn=factor_fn))
    cont = jax.jit(lambda st, k, off, n=seg: H.run_hmc(
        vg, opts, mass, st.m, m_start, n, k, init_state=st, key_offset=off,
        factor_fn=factor_fn))

    def run(n_samples, key, state=init_state):
        # exact segment accounting: no trailing partial segment
        assert n_samples % seg == 0, (n_samples, seg)
        parts, done = [], 0
        while done < n_samples:
            res = (first(key, 0) if state is None
                   else cont(state, key, done))
            jax.block_until_ready(res.models)
            state, done = res.final, done + seg
            parts.append(res)
        cat = lambda xs: jnp.concatenate(xs, axis=0)
        r0 = parts[0]
        return H.HMCResult(
            models=cat([p.models for p in parts]),
            stats=cat([p.stats for p in parts]),
            accepts=cat([p.accepts for p in parts]),
            pred=r0.pred, final=state, start_stats=r0.start_stats,
            start_pred=r0.start_pred,
            lf_steps=cat([p.lf_steps for p in parts]))

    return problem, run, opts


def _measure(problem_factory, n_chains, n_samples, seg=8, n_warm=0,
             gn_mass=False):
    import jax
    import jax.numpy as jnp

    seg = min(seg, n_samples)
    problem, run, opts = _build(problem_factory, n_chains, seg=seg,
                                n_warm=n_warm, gn_mass=gn_mass)
    # prime both program shapes (first/cont) outside the timed window
    jax.block_until_ready(run(2 * seg, jax.random.PRNGKey(0)).models)
    t0 = time.time()
    res = run(n_samples, jax.random.PRNGKey(1))
    jax.block_until_ready(res.models)
    dt = time.time() - t0
    assert bool(jnp.all(jnp.isfinite(res.stats))), "non-finite sampler stats"
    return problem, res, dt, opts


def measure_ess(problem_factory, n_chains, n_samples=40, n_warm=0,
                gn_mass=False):
    """Throughput + effective-sample-size + solve-rate accounting.

    With ``n_warm`` the sampler runs the adapted production kernel, so
    ``accept_rate`` lands in the working band and the ESS fields measure a
    functioning sampler; ``samples_per_sec`` is simultaneously the engine
    rate (leapfrog work per sample is L~U[6,10] regardless of dt or the MH
    outcome).  ``gn_mass`` additionally runs the Gauss-Newton dense-metric
    schedule (the production kernel), whose ESS/sample is the north-star
    lever; the ESS window should then be >=1000 samples so the integrated
    autocorrelation time is resolved rather than truncated."""
    from hmcmt2d.sampler import diagnostics as D

    problem, res, dt, opts = _measure(problem_factory, n_chains, n_samples,
                                      n_warm=n_warm, gn_mass=gn_mass)
    lf = np.asarray(res.lf_steps)
    nfev = int(lf.sum()) + n_chains          # + init evaluation per chain
    n_freq = problem.fwd.data.n_freq
    # each gradient eval: one forward + one adjoint solve per (freq, mode)
    solves = nfev * n_freq * 2
    window = res.models if n_warm else res.models[n_samples // 2:]
    ess = float(np.median(np.asarray(D.ess(window))))
    ess_200 = (float(np.median(np.asarray(D.ess(window[:200]))))
               if window.shape[0] >= 400 else None)   # legacy quick field
    # analytic factorisation FLOPs: ceil(L/4)+init factors per iteration,
    # nzi x batched complex inverse (~4 * (8/3) q^3 real mult-adds) each
    q, nzi = problem.mesh.ny - 1, problem.mesh.nz - 1
    n_fac = int(np.ceil(lf / 4.0).sum()) + n_chains
    flops = n_fac * n_freq * 2 * nzi * (8.0 / 3.0) * 4 * q ** 3
    return {
        "samples_per_sec": round(n_chains * n_samples / dt, 4),
        "ess_per_sec_per_chip": round(ess / dt, 4),
        "ess_median": round(ess, 2),
        "ess_median_first200": round(ess_200, 2) if ess_200 else None,
        "ess_window_samples": int(window.shape[0]),
        "kernel_mass": "gauss-newton" if gn_mass else "adapted-diagonal",
        "solves_per_sec": round(solves / dt, 1),
        "nfevals": nfev,
        "accept_rate": round(float(np.asarray(res.accepts).mean()), 3),
        "kernel_dt": round(float(opts.dt), 5),
        "kernel_adapted": bool(n_warm),
        "flops_per_sec_est": round(flops / dt / 1e9, 1),
    }


def measure_cpu_baseline(problem, n_freq=11, leapfrog_avg=8.0):
    """Time the reference-equivalent CPU linear-algebra per HMC sample:
    (L+2) forward factorisation sweeps (nfreq x 2 modes sparse LU) plus
    (L+1) adjoint solve sweeps reusing the factors (HMCSampler.jl:136-141,
    216-263, MT2DFwdSolver.jl:140-171).  Single-threaded scipy splu."""
    import scipy.sparse.linalg as spla

    from hmcmt2d.utils import cpu_reference as R

    mesh = problem.mesh
    dy = np.asarray(mesh.y_len, float)
    dz = np.asarray(mesh.z_len, float)
    sigma = np.zeros(mesh.n_cell)
    sigma[problem.active_idx] = 0.01
    sigma += problem.bg_flat
    ii, _ = R.boundary_index(len(dy), len(dz))
    freqs = np.asarray(problem.fwd.data.freqs)[:n_freq]

    rng = np.random.default_rng(0)
    n = len(ii)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)

    t0 = time.time()
    for mode in ("TE", "TM"):
        for f in freqs:
            A = R.dense_operator(dy, dz, sigma, mode, 2 * np.pi * f)
            lu = spla.splu(A[np.ix_(ii, ii)].tocsc())
            lu.solve(b)           # forward solve
            lu.solve(b)           # adjoint solve (factor reuse)
    t_sweep = time.time() - t0   # one forward+adjoint sweep incl. assembly

    per_sample = (leapfrog_avg + 1.0) * t_sweep
    return 1.0 / per_sample


def measure_cpu_baseline_native(problem, n_freq=11, leapfrog_avg=8.0,
                                threads=None):
    """Honest THREADED CPU baseline: the native band LDL^T engine
    (native/band_solver.cc — this repo's MUMPS-equivalent) run across the
    (freq x mode) sweep with a thread pool (ctypes releases the GIL during
    factor/solve), mirroring the reference's 48-MKL-thread MUMPS pipeline
    (runHMCscript.jl:17-18).  Frequency-independent matrix parts are
    assembled once, as the reference does (MT2DFwdSolver.jl:124-135)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from hmcmt2d import native as N
    from hmcmt2d.utils import cpu_reference as R

    if not N.available():
        return None

    mesh = problem.mesh
    dy = np.asarray(mesh.y_len, float)
    dz = np.asarray(mesh.z_len, float)
    sigma = np.zeros(mesh.n_cell)
    sigma[problem.active_idx] = 0.01
    sigma += problem.bg_flat
    ny, nz = len(dy), len(dz)
    nyi = ny - 1
    ii, _ = R.boundary_index(ny, nz)
    freqs = np.asarray(problem.fwd.data.freqs)[:n_freq]
    rng = np.random.default_rng(0)
    b = rng.standard_normal(len(ii)) + 1j * rng.standard_normal(len(ii))

    # freq-independent parts once per mode (the reference's CoeffMat)
    parts = {mode: R.assemble_mode_matrices(dy, dz, sigma, mode)
             for mode in ("TE", "TM")}

    def one_system(args):
        mode, f = args
        dGrad, Mnode = parts[mode]
        A = (dGrad + 1j * (2 * np.pi * f) * Mnode).tocsr()[np.ix_(ii, ii)]
        n = A.shape[0]
        band = np.zeros((n, nyi + 1), np.complex128)
        band[:, 0] = A.diagonal(0)
        band[: n - 1, 1] = A.diagonal(-1)
        band[: n - nyi, nyi] = A.diagonal(-nyi)
        with N.BandFactorization(band) as fac:
            fac.solve(b)   # forward
            fac.solve(b)   # adjoint (factor reuse)

    tasks = [(mode, f) for mode in ("TE", "TM") for f in freqs]
    threads = threads or min(len(tasks), os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(one_system, tasks))  # warm (thread spin-up, page-in)
        t0 = time.time()
        list(pool.map(one_system, tasks))
        t_sweep = time.time() - t0

    per_sample = (leapfrog_avg + 1.0) * t_sweep
    return 1.0 / per_sample


def device_info() -> dict:
    """The device every result line names: JAX's platform, device kind and
    device count, and the nvidia-smi name and power limit of a GPU."""
    import subprocess

    import jax

    d = jax.devices()
    card = None
    if d[0].platform == "gpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    return {"platform": d[0].platform, "device_kind": d[0].device_kind,
            "device_count": len(d), "card": card}


def main(smoke: bool = False):
    import jax

    if smoke:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", False)
    elif jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench.py: JAX backend is {jax.default_backend()!r}; the "
            "benchmark runs on an NVIDIA GPU (--smoke is the CPU rehearsal)")
    else:
        from hmcmt2d.models.forward import enable_x64_for_backend
        from hmcmt2d.utils.host import enable_compilation_cache

        enable_x64_for_backend()
        enable_compilation_cache()

    import importlib.util
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "graft", os.path.join(here, "__graft_entry__.py"))
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)

    # --smoke: the full measurement pipeline on the tiny problem
    factory = (lambda: g._flagship_problem(tiny=True)) if smoke \
        else g._flagship_problem
    if smoke:
        base_chains, counts = 1, ()
        stats = measure_ess(factory, base_chains, n_samples=4, n_warm=4)
    else:
        # the production kernel: 104-iteration segmented warmup, the
        # Gauss-Newton dense metric with dt re-adaptation, then a
        # >=1000-sample ESS window at 8 native-batched chains
        base_chains, counts = 8, (12, 16)
        stats = measure_ess(factory, base_chains, n_samples=1008,
                            n_warm=104, gn_mass=True)
    sweep = {str(base_chains): stats["samples_per_sec"]}

    problem, _ = factory()
    nf = problem.fwd.data.n_freq
    cpu_sps = measure_cpu_baseline(problem, n_freq=nf)
    cpu_native_sps = measure_cpu_baseline_native(problem, n_freq=nf)

    for c in counts:
        _, res, dt, _o = _measure(factory, c, 16)
        sweep[str(c)] = round(c * 16 / dt, 4)

    best = max(sweep.values())
    base = cpu_native_sps or cpu_sps
    out = {
        "metric": "hmc_samples_per_sec_per_chip",
        "value": best,
        "unit": ("samples/s (smoke: tiny problem, CPU)" if smoke else
                 "samples/s (dprism-scale: 96x56 mesh, 11 freqs, TE+TM "
                 "merged solve)"),
        "vs_baseline": round(best / base, 2),
        "baseline_note": ("threaded native band-LDLT CPU pipeline (this "
                          "repo's MUMPS-equivalent engine; ref runs MUMPS "
                          "with 48 MKL threads)" if cpu_native_sps else
                          "single-threaded scipy splu"),
        "cpu_samples_per_sec_scipy_1t": round(cpu_sps, 4),
        "cpu_samples_per_sec_native_mt": (round(cpu_native_sps, 4)
                                          if cpu_native_sps else None),
        "chains_sweep": sweep,
    }
    out.update(device_info())
    out.update(stats)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(smoke="--smoke" in sys.argv[1:]))
