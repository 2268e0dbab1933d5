"""Resume a checkpointed run with a REFRESHED Gauss-Newton mass matrix.

The GN metric is built at the warmed-up model; on workloads with a long
post-warmup descent (COPROD2: chi2 17 -> 5.6) the curvature at the plateau
is much larger than at the warmup point, the stale metric under-estimates
it, and the adapted dt stays tiny — fast misfit descent but slow
per-parameter mixing.  This tool loads the checkpoint, rebuilds
M = J'W^2J + reg*Wm at the CURRENT pooled model (where J is finally
accurate), re-adapts dt under the fresh metric, and samples an extension
segment with the refreshed kernel, writing a new self-contained checkpoint
(models = re-adaptation rows + extension samples, n_warm = re-adaptation
count) that scripts/summarize_checkpoint.py can turn into an artifact whose
diagnostics cover exactly the refreshed-kernel window.

Usage:
  python scripts/refresh_extend.py <startupfile> <checkpoint.npz>
      <out_checkpoint.npz> [--samples 3000] [--readapt 104] [--seg 8]
      [--dt0 0.05] [--stride 25]
"""

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("startupfile")
    ap.add_argument("checkpoint")
    ap.add_argument("out_checkpoint")
    ap.add_argument("--samples", type=int, default=3000)
    ap.add_argument("--readapt", type=int, default=104)
    ap.add_argument("--seg", type=int, default=8)
    ap.add_argument("--stride", type=int, default=25)
    ap.add_argument("--dt0", type=float, default=0.05)
    ap.add_argument("--jac-chunk", type=int, default=128)
    args = ap.parse_args()

    import jax

    from hmcmt2d.models.forward import enable_x64_for_backend

    enable_x64_for_backend()
    if jax.default_backend() != "cpu":
        from hmcmt2d.utils.host import enable_compilation_cache
        enable_compilation_cache()

    import jax.numpy as jnp

    from hmcmt2d.io.startup import read_startup
    from hmcmt2d.models.forward import default_config
    from hmcmt2d.models.posterior import build_inverse_problem
    from hmcmt2d.sampler import adapt as A
    from hmcmt2d.sampler import checkpoint as CKP
    from hmcmt2d.sampler import hmc as H
    from hmcmt2d.sampler.driver import (_segment_plan, gauss_newton_mass,
                                            hmc_options, make_factor_fn,
                                            make_potential_vg)
    from hmcmt2d.utils.host import to_host, tree_to_host

    cfg, mesh, sigma2d, data, obs, err = read_startup(args.startupfile)
    scfg = default_config()
    problem, _m0 = build_inverse_problem(mesh, data, obs, err,
                                         np.asarray(sigma2d).ravel(),
                                         sigma_fixed=cfg.sig_fix, cfg=scfg)
    ck = CKP.load_checkpoint(args.checkpoint)
    state, m_ref = ck["state"], jnp.asarray(ck["m_ref"])
    print(f"[refresh] loaded {args.checkpoint}: {ck['n_done']} samples done, "
          f"old dt={ck['dt']:.4g}", flush=True)

    vg = make_potential_vg(problem, cfg.reg_param)
    factor_fn = make_factor_fn(problem) if cfg.amortize else None
    opts = dataclasses.replace(hmc_options(cfg), dt=args.dt0)

    t0 = time.time()
    mass = gauss_newton_mass(problem, jnp.mean(state.m, axis=0),
                             cfg.reg_param, chunk=args.jac_chunk)
    print(f"[refresh] GN mass rebuilt at the current model in "
          f"{time.time() - t0:.1f}s", flush=True)

    # dt re-adaptation under the fresh metric, continuing from the state
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 777)
    wopts = A.WarmupOptions(adapt_mass=False, target_accept=cfg.target_accept,
                            alpha_pool=cfg.warmup_pool)
    P = state.m.shape[-1]
    zero = jnp.zeros((), state.m.dtype)
    carry = A.WarmupCarry(
        state=state, da=A._da_init(jnp.asarray(args.dt0, state.m.dtype)),
        inv_m=jnp.ones((P,), state.m.dtype),
        acc=(zero, jnp.zeros((P,), state.m.dtype),
             jnp.zeros((P,), state.m.dtype)),
        alpha_acc=(jnp.zeros(()), jnp.zeros(())))
    acc = {k: [] for k in ("models", "stats", "accepts", "pred", "lf")}
    cseg = {}
    done = 0
    for n_sc in _segment_plan(args.readapt, args.seg):
        t_seg = time.time()
        if n_sc not in cseg:
            cseg[n_sc] = jax.jit(
                lambda c, mref, k, off, sq, im, n=n_sc: A.warmup_scan(
                    vg, opts, mref, c, A.warmup_keys(k, off, n),
                    jnp.zeros(n, bool), wopts, factor_fn=factor_fn,
                    fixed_mass=H.MassMatrix(sq, im, False)))
        carry, (wm, ws, wa, wp, wl) = cseg[n_sc](
            carry, m_ref, key, done, mass.sqrt_m, mass.inv_m)
        jax.block_until_ready(wm)
        done += n_sc
        for k, v in zip(("models", "stats", "accepts", "pred", "lf"),
                        (wm, ws, wa, to_host(wp), wl)):
            acc[k].append(np.asarray(v) if k != "pred" else v)
        print(f"[refresh] readapt {done}/{args.readapt}: "
              f"misfit={float(np.asarray(ws)[-1, :, 0].mean()):.4g} "
              f"dt={float(jnp.exp(carry.da.log_eps)):.4g} "
              f"({n_sc * wm.shape[1] / (time.time() - t_seg):.2f} samples/s)",
              flush=True)
    _m, info = jax.jit(A.warmup_finalize)(carry)
    state = carry.state
    opts = dataclasses.replace(opts, dt=float(info.dt))
    print(f"[refresh] refreshed kernel: dt={opts.dt:.4g} "
          f"accept~{float(info.alpha_mean):.2f}", flush=True)

    # extension sampling with the refreshed kernel
    runs = {}
    n_done = 0
    key_main = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 778)
    segs = _segment_plan(args.samples, args.seg)
    for i_seg, n_seg in enumerate(segs):
        t_seg = time.time()
        rkey = n_seg
        if rkey not in runs:
            runs[rkey] = jax.jit(
                lambda st, mref, k, off, n=n_seg: H.run_hmc(
                    vg, opts, mass, st.m, mref, n, k, init_state=st,
                    key_offset=off, factor_fn=factor_fn))
        res = runs[rkey](state, m_ref, key_main, n_done)
        jax.block_until_ready(res.models)
        state = res.final
        n_done += n_seg
        for k, v in zip(("models", "stats", "accepts", "pred", "lf"),
                        (res.models, res.stats, res.accepts,
                         to_host(res.pred), res.lf_steps)):
            acc[k].append(np.asarray(v) if k != "pred" else v)
        if (i_seg + 1) % args.stride == 0 or i_seg == len(segs) - 1:
            CKP.save_checkpoint(
                args.out_checkpoint, n_done=n_done,
                state=tree_to_host(state), key=key_main, dt=opts.dt,
                mass=mass, m_ref=np.asarray(m_ref),
                models=np.concatenate(acc["models"]),
                stats=np.concatenate(acc["stats"]),
                accepts=np.concatenate(acc["accepts"]),
                pred=np.concatenate(acc["pred"]),
                lf_steps=np.concatenate(acc["lf"]),
                start_stats=np.asarray(ck["start_stats"]),
                start_pred=np.asarray(ck["start_pred"]),
                n_warm=args.readapt,
                wall_time=ck["wall_time"] + time.time() - t0)
        if (i_seg + 1) % 5 == 0 or i_seg == len(segs) - 1:
            print(f"[refresh] samples {n_done}/{args.samples}: "
                  f"misfit={float(np.asarray(res.stats)[-1, :, 0].mean()):.4g} "
                  f"accept={float(np.asarray(res.accepts).mean()):.2f} "
                  f"({n_seg * res.models.shape[1] / (time.time() - t_seg):.2f} "
                  f"samples/s)", flush=True)
    print(f"[refresh] done: {n_done} extension samples in "
          f"{time.time() - t0:.1f}s -> {args.out_checkpoint}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
