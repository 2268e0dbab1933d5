"""Command-line driver: run inversions / forward models from a startup file.

Replaces the reference's user-edited REPL scripts
(examples/*/runHMCscript.jl, paraHMCscript.jl) with a proper CLI:

    hmcmt2d run startupfile [--chains N] [--freq-devices K] [--samples S]
    hmcmt2d forward startupfile -o pred.dat

Startup files are the reference's key/value format (readstartupFile.jl) with
optional extensions ``chains:`` and ``seed:``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _setup_jax(args):
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    from .models.forward import enable_x64_for_backend

    enable_x64_for_backend()
    if jax.default_backend() != "cpu" and not getattr(args, "no_cache", False):
        # persistent compile cache; CPU excluded: AOT entries there can
        # reload with mismatched machine features
        from .utils.host import enable_compilation_cache

        enable_compilation_cache()
    return jax


def _solve_cfg(args):
    import dataclasses

    import jax.numpy as jnp

    from .models.forward import SolveConfig, default_config

    if args.precision == "auto":
        cfg = default_config()
    elif args.precision == "f64":
        cfg = SolveConfig(jnp.complex128, 0)
    else:
        cfg = SolveConfig(jnp.complex64, args.refine)
    if getattr(args, "solver", "auto") != "auto":
        cfg = dataclasses.replace(cfg, solver_method=args.solver)
    if getattr(args, "inv", "auto") != "auto":
        cfg = dataclasses.replace(cfg, inv_method=args.inv)
    return cfg


def _warmup_cfg(args, solve_cfg):
    """Resolve --warmup-solver into a hybrid warmup SolveConfig (or None).

    'auto' and 'same' warm up on the main engine (no hybrid schedule); an
    explicit engine name warms up under that engine instead.
    """
    import dataclasses

    ws = getattr(args, "warmup_solver", "auto")
    if ws in ("auto", "same") or ws == solve_cfg.solver_method:
        return None
    # refine_iters=3 for the exact warmup engine: at extreme high-misfit
    # states (COPROD2 descent, round 4) the refine-1 potential has
    # O(1e-4)-relative cliffs that inexact HMC seeks out and then sticks to
    # (alpha pinned at 0 at any dt -> dual-averaging collapse); two extra
    # refinement passes cost ~nothing in a warmup-only engine
    return dataclasses.replace(solve_cfg, solver_method=ws, refine_iters=3)


def cmd_run(args):
    jax = _setup_jax(args)
    import jax.numpy as jnp  # noqa: F401

    from .io.startup import read_startup
    from .parallel.multichain import distributed_init, make_device_mesh
    from .sampler import diagnostics as D
    from .sampler import outputs as O
    from .sampler.driver import run_inversion

    # multi-host initialisation (the reference's `julia -p N` equivalent,
    # README.md:140-165 / parallelHMC.jl) — no-op without --coordinator
    distributed_init(args.coordinator or None, args.num_processes,
                     args.process_id)

    cfg, mesh, sigma2d, data, obs, err = read_startup(args.startupfile)
    os.makedirs(args.outdir, exist_ok=True)
    if args.chains:
        cfg.n_chains = args.chains
    if args.samples:
        cfg.total_samples = args.samples
    if args.seed is not None:
        cfg.seed = args.seed
    solve_cfg = _solve_cfg(args)

    n_dev = len(jax.devices())
    print(f"[hmcmt2d] devices={n_dev} chains={cfg.n_chains} "
          f"samples={cfg.total_samples} solve_dtype={solve_cfg.solve_dtype.__name__}")

    # device mesh: explicit opt-out via --no-shard; warn instead of silently
    # changing behaviour when the configuration cannot be sharded
    dev_mesh = None
    if not args.no_shard and (n_dev > 1 or args.freq_devices > 1):
        kf = args.freq_devices
        if n_dev % kf or data.n_freq % kf or cfg.n_chains % (n_dev // kf):
            print(f"[hmcmt2d] WARNING: cannot shard chains={cfg.n_chains} "
                  f"freqs={data.n_freq} over {n_dev} devices "
                  f"(freq_devices={kf}); running single-device batched. "
                  f"Adjust --chains/--freq-devices or pass --no-shard.")
        else:
            dev_mesh = make_device_mesh(n_dev // kf, kf)
            print(f"[hmcmt2d] device mesh: chains={n_dev // kf} x freq={kf} "
                  f"(warmup + checkpointing run SPMD)")

    profiler = None
    if args.profile:
        jax.profiler.start_trace(args.profile)
        profiler = args.profile

    run = run_inversion(cfg, mesh, sigma2d, data, obs, err,
                        solve_cfg=solve_cfg, device_mesh=dev_mesh,
                        checkpoint_path=args.checkpoint or None,
                        checkpoint_every=args.checkpoint_every,
                        checkpoint_stride=args.checkpoint_stride,
                        resume=args.resume, verbose=not args.quiet,
                        progress_every=args.progress_every,
                        warmup_solve_cfg=_warmup_cfg(args, solve_cfg))
    if profiler:
        jax.profiler.stop_trace()
        print(f"[hmcmt2d] profiler trace written to {profiler}")
    problem, result, wall = run.problem, run.result, run.wall_time

    S, C, P = result.models.shape
    rate = float(np.asarray(result.accepts).mean())
    print(f"[hmcmt2d] done in {wall:.1f}s  ({S * C / wall:.2f} samples/s total, "
          f"accept rate {rate:.2f}, nfevals {run.nfevals})")

    O.write_posterior_models(problem, result.models, run.n_warm or cfg.burnin,
                             args.outdir)
    for c in range(C):
        O.write_chain_outputs(result.models, result.stats, result.accepts,
                              result.pred, result.start_stats, chain=c,
                              ichain=c + 1, cputime=wall, outdir=args.outdir,
                              start_pred=result.start_pred,
                              thin=max(args.out_thin, 1))
    if C >= 2:
        rhat = np.asarray(D.split_rhat(result.models))
        print(f"[hmcmt2d] split-R-hat: max={rhat.max():.3f} "
              f"median={np.median(rhat):.3f}")
    print(D.misfit_summary(result.stats))
    summary = dict(run.summary(), platform=jax.devices()[0].platform,
                   device_kind=jax.devices()[0].device_kind, devices=n_dev)
    path = os.path.join(args.outdir, "run_summary.json")
    with open(path, "w") as fh:
        json.dump(summary, fh, indent=1)
    print(f"[hmcmt2d] set-up {summary['setup_time_s']:.1f}s, main phase "
          f"{summary['main_samples_per_sec']} samples/s; wrote {path}")
    return 0


def cmd_forward(args):
    jax = _setup_jax(args)
    import jax.numpy as jnp

    from .io.startup import read_startup
    from .io.data_io import write_data
    from .models.forward import make_forward

    from .utils.host import to_host

    cfg, mesh, sigma2d, data, obs, err = read_startup(args.startupfile)
    fwd = make_forward(mesh, data, _solve_cfg(args))
    t0 = time.time()
    pred = to_host(jax.jit(fwd.predict)(jnp.asarray(np.asarray(sigma2d))))
    wall = time.time() - t0
    res = pred - obs
    nrms = float(np.sqrt(np.mean(np.abs(res / np.maximum(np.abs(err), 1e-300)) ** 2)))
    print(f"[hmcmt2d] forward: {len(pred)} data in {wall:.2f}s, "
          f"normalised RMS vs observed = {nrms:.3f}")
    write_data(args.output, data, pred, err)
    print(f"[hmcmt2d] wrote {args.output}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="hmcmt2d",
                                 description="2D MT Bayesian (HMC) inversion")
    ap.add_argument("--platform", default="", help="jax platform override (cpu/gpu)")
    ap.add_argument("--x64", action="store_true", help="enable float64 (always on with a GPU)")
    ap.add_argument("--precision", choices=["auto", "f32", "f64"], default="auto")
    ap.add_argument("--refine", type=int, default=1,
                    help="iterative-refinement steps for f32 solves")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the persistent compilation cache")
    ap.add_argument("--solver", default="auto",
                    choices=["auto", "thomas", "thomas_blocked", "bcr"],
                    help="factorisation engine (auto = the backend default)")
    ap.add_argument("--inv", default="auto", choices=["auto", "lu", "gj"],
                    help="batched-inverse engine inside the factorisation")
    sub = ap.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run the HMC inversion")
    runp.add_argument("startupfile")
    runp.add_argument("--chains", type=int, default=0)
    runp.add_argument("--samples", type=int, default=0)
    runp.add_argument("--seed", type=int, default=None)
    runp.add_argument("--freq-devices", type=int, default=1,
                      help="devices on the frequency mesh axis")
    runp.add_argument("--no-shard", action="store_true",
                      help="force single-device batched sampling")
    runp.add_argument("--outdir", default=".")
    runp.add_argument("--checkpoint", default="",
                      help="checkpoint file path (enables periodic dumps)")
    runp.add_argument("--checkpoint-every", type=int, default=0,
                      help="samples per device-program segment")
    runp.add_argument("--checkpoint-stride", type=int, default=1,
                      help="write the checkpoint every this many segments")
    runp.add_argument("--resume", action="store_true",
                      help="resume from --checkpoint (bit-exact)")
    runp.add_argument("--quiet", action="store_true",
                      help="suppress per-segment progress lines")
    runp.add_argument("--progress-every", type=int, default=0,
                      help="segment length for progress lines (no checkpoint)")
    runp.add_argument("--out-thin", type=int, default=1,
                      help="write every Nth sample row of the per-chain "
                           "model/data dumps (stats log stays full)")
    runp.add_argument("--warmup-solver", default="auto",
                      choices=["auto", "same", "thomas", "thomas_blocked",
                               "bcr"],
                      help="hybrid schedule: engine for the warmup phase "
                           "(auto/same = the main engine, no hybrid)")
    runp.add_argument("--profile", default="",
                      help="write a jax.profiler trace to this directory")
    # multi-host (jax.distributed) flags
    runp.add_argument("--coordinator", default="",
                      help="coordinator address host:port for multi-host runs")
    runp.add_argument("--num-processes", type=int, default=None)
    runp.add_argument("--process-id", type=int, default=None)
    runp.set_defaults(func=cmd_run)

    fwdp = sub.add_parser("forward", help="forward-model the startup model")
    fwdp.add_argument("startupfile")
    fwdp.add_argument("-o", "--output", default="predicted.dat")
    fwdp.set_defaults(func=cmd_forward)

    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
