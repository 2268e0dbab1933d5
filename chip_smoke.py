#!/usr/bin/env python3
"""Run the HMC inversion end to end on one NVIDIA GPU and check the result.

    python chip_smoke.py           # one GPU: phases 1-4 below
    python chip_smoke.py --four    # four GPUs: the sharded paths only

One process opens the card once.  Phases:

1. card check: JAX must find a GPU (there is no CPU fallback); prints the
   card's name and power limit as ``nvidia-smi`` reports them.
2. compile only: lowers and compiles ``__graft_entry__.entry()``'s
   value-and-grad step at flagship size; prints the compile time and
   ``memory_analysis()``.
3. reference check: potential, gradient and predicted data of the GPU
   default solve configuration at 8 perturbed chain states of the seeded
   flagship deployment, against the complex128 reference on the CPU device
   of this process (``hmcmt2d.utils.refcheck``).
4. the normal entry point: ``hmcmt2d run`` (``hmcmt2d.cli.main``) on the
   seeded flagship with 8 chains through warmup, the Gauss-Newton metric,
   step-size re-adaptation and a main phase of several checkpoint segments;
   requires finite statistics, a falling misfit, an adapted step size > 0
   and a main-phase acceptance rate in (0, 1].

``--four`` runs instead, on four GPUs, ``hmcmt2d run`` of the same flagship
on a 4 x 1 (chains x freq) mesh and the sharded potential and gradient on
4 x 1 and 2 x 2 meshes, each compared with the one-card values at the same
states.  The 2 x 2 mesh needs a frequency count divisible by 2, so it uses
the flagship band at 12 frequencies instead of 11.

The last line of standard output is ``{"ok": true, "device": {...}}``; any
failed phase exits non-zero without printing it.  Work files go to
``chiprun_out/chip_smoke/`` under the repository root.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "chiprun_out", "chip_smoke")
SEED = 0
N_STATES = 8
CHAINS = 8
# depth cuts of the flagship schedule: 32 warmup + 16 metric re-adaptation
# iterations, then 32 main samples in two checkpoint segments of 16
SMOKE_STARTUP = {"burninsamples": 32, "masswarmup": 16, "totalsamples": 80}
SEGMENT = 16
# --four: half of that schedule (four cards cost four times as much)
FOUR_STARTUP = {"burninsamples": 16, "masswarmup": 8, "totalsamples": 40,
                "warmuppool": "mean"}
FOUR_SEGMENT = 8


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def card_check(n_cards: int):
    """The GPU check of phase 1; returns (jax, card description)."""
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"chip_smoke: JAX backend is {jax.default_backend()!r}, "
                         "not 'gpu'; this check runs only on an NVIDIA GPU")
    if len(jax.devices()) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, JAX sees "
                         f"{len(jax.devices())}")
    cpu = jax.devices("cpu")[0]    # the reference check's device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(smi.stdout.strip(), flush=True)
    log(f"backend gpu, {len(jax.devices())} device(s): "
        f"{jax.devices()[0].device_kind}; reference device {cpu}")
    from hmcmt2d.models.forward import enable_x64_for_backend
    from hmcmt2d.utils.host import enable_compilation_cache

    enable_x64_for_backend()      # x64 as in `hmcmt2d run` on the GPU
    log(f"x64 {jax.config.jax_enable_x64}; compile cache "
        f"{enable_compilation_cache()}")
    return jax, card


def compile_entry():
    """Phase 2: compile the flagship value-and-grad step only."""
    import importlib.util

    import jax

    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)
    step, args = g.entry()
    t0 = time.time()
    compiled = jax.jit(step).lower(*args).compile()
    log(f"compiled entry() value-and-grad in {time.time() - t0:.1f}s")
    ma = compiled.memory_analysis()
    log("memory_analysis: " + ", ".join(
        f"{k}={getattr(ma, k)}" for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(ma, k)))


def report_check(name, metrics, cfg):
    from hmcmt2d.utils import refcheck as R

    log(f"{name}: data {metrics['data']:.3e} (bar {R.BAR['data']:g}), "
        f"potential {metrics['potential']:.3e} (bar {R.BAR['potential']:g}), "
        f"grad cos {metrics['grad_cos']:.7f} (bar {R.BAR['grad_cos']:g}), "
        f"grad rel L2 {metrics['grad_rel_l2']:.3e} "
        f"(bar {R.BAR['grad_rel_l2']:g}); solve dtype "
        f"{cfg.solve_dtype.__name__}, refine_iters {cfg.refine_iters}, "
        f"engine {cfg.solver_method}/{cfg.inv_method}, matmul precision HIGHEST")
    if not R.passes(metrics):
        raise SystemExit(f"chip_smoke: {name} outside the bar")


def run_cli(startupfile, outdir, card, segment=SEGMENT):
    """Phase 4: ``hmcmt2d run`` through its CLI entry point, then checks."""
    from hmcmt2d import cli

    ck = os.path.join(outdir, "run.ckpt.npz")
    if os.path.exists(ck):
        os.remove(ck)
    t0 = time.time()
    rc = cli.main(["run", startupfile, "--chains", str(CHAINS), "--outdir",
                   outdir, "--checkpoint", ck, "--checkpoint-every",
                   str(segment)])
    wall = time.time() - t0
    if rc != 0:
        raise SystemExit(f"chip_smoke: hmcmt2d run returned {rc}")
    with open(os.path.join(outdir, "run_summary.json")) as fh:
        s = json.load(fh)
    log(f"hmcmt2d run on {card}: wall {wall:.1f}s, set-up "
        f"{s['setup_time_s']:.1f}s, main phase {s['main_samples']} samples x "
        f"{s['chains']} chains at {s['main_samples_per_sec']} samples/s, "
        f"dt {s['dt']:.4g}, accept {s['accept_rate_main']}, misfit "
        f"{s['misfit_start']:.4g} -> {s['misfit_end']:.4g}")
    checks = {
        "finite stats": s["stats_finite"],
        "misfit falls": s["misfit_end"] < s["misfit_start"],
        "adapted dt > 0": s["dt"] > 0,
        "accept rate in (0, 1]": (s["accept_rate_main"] is not None
                                  and 0 < s["accept_rate_main"] <= 1),
        "main phase ran": s["main_samples"] >= 2 * segment,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"chip_smoke: run checks failed: {failed}")
    return s


def peak_bytes(jax):
    for d in jax.devices():
        stats = d.memory_stats() or {}
        log(f"{d}: peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


def one_card():
    jax, card = card_check(1)
    from hmcmt2d.io import synthetic as syn
    from hmcmt2d.utils import refcheck as R

    os.makedirs(WORK, exist_ok=True)
    t0 = time.time()
    files = syn.write_flagship(WORK, seed=SEED, **SMOKE_STARTUP)
    log(f"wrote the seeded flagship deployment in {time.time() - t0:.1f}s: "
        f"{files['startupfile']}")
    compile_entry()
    t0 = time.time()
    metrics, cfg = R.check(files["startupfile"], N_STATES, SEED)
    log(f"reference check at {N_STATES} states in {time.time() - t0:.1f}s "
        "(GPU and CPU, compiles included)")
    report_check("reference check", metrics, cfg)
    run_cli(files["startupfile"], os.path.join(WORK, "run"), card)
    peak_bytes(jax)
    return jax


def four_cards():
    jax, card = card_check(4)
    import numpy as np

    from hmcmt2d.io import synthetic as syn
    from hmcmt2d.models.posterior import build_inverse_problem
    from hmcmt2d.parallel.multichain import ShardedSampler, make_device_mesh
    from hmcmt2d.utils import refcheck as R
    from hmcmt2d.utils.host import to_host

    work = os.path.join(WORK, "four")
    files = syn.write_flagship(work, seed=SEED, **FOUR_STARTUP)

    def sharded_check(name, problem, m_ref, reg, n_chain_dev, n_freq_dev):
        states = R.perturbed_states(m_ref, N_STATES, SEED)
        one = R.evaluate(problem, states, m_ref, reg)
        ss = ShardedSampler(problem, reg, make_device_mesh(n_chain_dev, n_freq_dev))
        m = jax.numpy.asarray(states)
        mref = jax.numpy.broadcast_to(jax.numpy.asarray(m_ref), m.shape)
        U, g, pred = ss.potential_value_and_grad(m, mref)
        sharded = {"U": np.asarray(U, np.float64), "grad": np.asarray(g, np.float64),
                   "pred": to_host(pred).astype(np.complex128)}
        report_check(name, R.compare(sharded, one), problem.fwd.cfg)

    problem, m_ref, reg = R.load_problem(files["startupfile"])
    sharded_check("4 x 1 (chains x freq) vs one card", problem, m_ref, reg, 4, 1)

    mesh = syn.flagship_mesh()
    survey12 = syn.flagship_survey(mesh, n_freq=12)
    obs, err = syn.synthetic_observations(mesh, survey12,
                                          syn.prism_model(mesh, SEED), SEED)
    problem12, m_ref12 = build_inverse_problem(mesh, survey12, obs, err,
                                               syn.start_model(mesh).ravel())
    sharded_check("2 x 2 (chains x freq, 12 frequencies) vs one card",
                  problem12, m_ref12, reg, 2, 2)

    run_cli(files["startupfile"], os.path.join(work, "run"), card,
            FOUR_SEGMENT)
    peak_bytes(jax)
    return jax


def main(argv=None):
    ap = argparse.ArgumentParser(description="end-to-end GPU check")
    ap.add_argument("--four", action="store_true",
                    help="run the four-GPU sharded paths instead")
    a = ap.parse_args(argv)
    jax = four_cards() if a.four else one_card()
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
