"""MAP / misfit-floor diagnosis: what chi^2/datum can a workload reach?

Optimizes the potential (data misfit + reg * smoothness prior) with Adam
over the active-cell log-conductivity for one or more reg values and
reports the attainable misfit floor plus a per-datum residual breakdown.
Diagnoses whether a stalled HMC fit is a *mixing* problem (floor ~ 1: the
chains just have not reached it) or a *model/error-treatment* floor
(floor >> 1: no 2-D conductivity within bounds fits the data to its quoted
errors — e.g. field-data static shift / undersized errors, cf. the
reference's commented-out error-floor logic, HMCUtility.jl:168-190).

Usage:
    python scripts/map_fit.py <startupfile> [--iters N] [--regs 1.0,0.01]
        [--lr 0.03] [--chains 4] [--solver thomas|bcr] [--out out.json]

Runs C >= 2 parallel Adam instances from the same randomized homogeneous
starts the sampler uses, in segments of ``--seg`` iterations (one progress
line each).
"""

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("startupfile")
    ap.add_argument("--iters", type=int, default=1200)
    ap.add_argument("--seg", type=int, default=25)
    ap.add_argument("--regs", default="1.0,0.01")
    ap.add_argument("--lr", type=float, default=0.03)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--solver", default="auto")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import jax

    from hmcmt2d.models.forward import enable_x64_for_backend

    enable_x64_for_backend()
    if jax.default_backend() != "cpu":
        from hmcmt2d.utils.host import enable_compilation_cache
        enable_compilation_cache()

    import jax.numpy as jnp
    import optax

    from hmcmt2d.io.startup import read_startup
    from hmcmt2d.models.forward import SolveConfig, default_config
    from hmcmt2d.models.posterior import build_inverse_problem
    from hmcmt2d.sampler import hmc as H
    from hmcmt2d.sampler.driver import make_potential_vg

    cfg, mesh, sigma2d, data, obs, err = read_startup(args.startupfile)
    scfg = default_config()
    if args.solver != "auto":
        scfg = dataclasses.replace(scfg, solver_method=args.solver)
    problem, m0 = build_inverse_problem(mesh, data, obs, err,
                                        np.asarray(sigma2d).ravel(),
                                        sigma_fixed=cfg.sig_fix, cfg=scfg)
    n_data = len(problem.obs)
    # chi^2 normalisation: complex data count re+im as 2 residuals in the
    # misfit 0.5*|r|^2 -> chi2/datum = 2*misfit/(2*ndata) = misfit/ndata
    print(f"[map_fit] {args.startupfile}: {n_data} data, "
          f"{problem.n_param} params, engine={scfg.solver_method}")

    C = max(2, args.chains)
    key = jax.random.PRNGKey(cfg.seed)
    m_start = H.random_homogeneous_start(key, m0, C)
    lo, hi = float(np.log(cfg.sig_bounds[0])), float(np.log(cfg.sig_bounds[1]))

    report = {"startupfile": args.startupfile, "n_data": n_data,
              "engine": scfg.solver_method, "regs": {}}
    for reg in [float(r) for r in args.regs.split(",")]:
        vg = make_potential_vg(problem, reg if reg > 0 else 1e-6)
        # cosine-decayed Adam: the last ~20% of iterations polish at ~lr/10
        sched = optax.cosine_decay_schedule(args.lr, args.iters, alpha=0.05)
        opt = optax.adam(sched)

        def seg_run(m, opt_state, mref, n=args.seg):
            def body(carry, _):
                m, s = carry
                (U, (mis, mn, _pred)), g = vg(m, mref)
                g = jnp.where(jnp.isfinite(g), g, 0.0)
                upd, s = opt.update(g, s, m)
                m = jnp.clip(m + upd, lo, hi)
                return (m, s), (jnp.mean(mis), jnp.mean(U))
            (m, opt_state), (mis_tr, _) = jax.lax.scan(
                body, (m, opt_state), None, length=n)
            return m, opt_state, mis_tr

        seg_j = jax.jit(seg_run)
        m = jnp.asarray(m_start, jnp.float32)
        opt_state = opt.init(m)
        t0 = time.time()
        done = 0
        best = np.inf
        while done < args.iters:
            m, opt_state, mis_tr = seg_j(m, opt_state,
                                         jnp.asarray(m_start, jnp.float32))
            jax.block_until_ready(m)
            done += args.seg
            cur = float(np.asarray(mis_tr)[-1]) / n_data
            best = min(best, cur)
            if done % (args.seg * 4) == 0 or done >= args.iters:
                print(f"[map_fit] reg={reg}: iter {done}/{args.iters} "
                      f"chi2/datum={cur:.3f} "
                      f"({done / (time.time() - t0):.1f} it/s)", flush=True)

        # final per-chain misfits + residual breakdown at the best chain
        from hmcmt2d.utils.host import to_host
        (U, (mis, mn, pred)), _g = jax.jit(vg)(m, jnp.asarray(m_start, jnp.float32))
        mis = np.asarray(mis)
        chain_chi2 = mis / n_data
        b = int(np.argmin(chain_chi2))
        pred_b = np.asarray(to_host(pred))[b]
        r = np.asarray(problem.weights) * (pred_b - np.asarray(problem.obs))
        r2 = np.abs(r) ** 2                      # per-datum chi2 contribution
        fid = np.asarray(data.freq_id)
        by_freq = {float(np.asarray(data.freqs)[f]):
                   float(r2[fid == f].mean()) for f in np.unique(fid)}
        report["regs"][str(reg)] = {
            "chi2_per_datum_per_chain": [round(float(c), 4) for c in chain_chi2],
            "chi2_best": round(float(chain_chi2[b]), 4),
            # the artifact summaries use sum|r|^2/N = 2*misfit/N ("chi2
            # per complex datum"); chi2_* fields above are misfit/N
            "chi2_artifact_convention_best": round(2 * float(chain_chi2[b]), 4),
            "chi2_quantiles_per_datum": {
                q: round(float(np.quantile(r2, float(q))), 3)
                for q in ("0.5", "0.9", "0.99", "1.0")},
            "chi2_by_freq_mean": {f"{k:.4g}": round(v, 3)
                                  for k, v in sorted(by_freq.items())},
            "iters": args.iters,
        }
        print(f"[map_fit] reg={reg}: floor chi2/datum per chain = "
              f"{np.round(chain_chi2, 3).tolist()}", flush=True)

    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
