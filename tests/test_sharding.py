"""Multi-device sharded sampling on a virtual 8-device CPU mesh.

Validates the SPMD design the driver dry-runs for multi-chip: chains as
data parallelism, frequencies as model parallelism with psum-reduced
misfit/gradient.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from hmcmt2d.io import HMCConfig
from hmcmt2d.models import forward as F
from hmcmt2d.models.posterior import build_inverse_problem
from hmcmt2d.parallel import make_device_mesh, run_sharded_hmc
from hmcmt2d.sampler import hmc as H
from hmcmt2d.sampler.driver import hmc_options, make_potential_vg
from tests.test_e2e import tiny_setup


@pytest.fixture(scope="module")
def tiny_problem_shardable():
    mesh, start_sig, data, obs, err = tiny_setup()
    prob, m0 = build_inverse_problem(mesh, data, obs, err, start_sig.ravel(),
                                     cfg=F.SolveConfig(jnp.complex128, 0))
    return prob, np.asarray(m0)


def test_requires_divisibility(tiny_problem_shardable):
    prob, m0 = tiny_problem_shardable
    mesh = make_device_mesh(4, 2)
    opts = hmc_options(HMCConfig(dt=0.05, timestep=(2, 2)))
    mass = H.identity_mass(len(m0))
    m = jnp.broadcast_to(jnp.asarray(m0), (6, len(m0)))  # 6 chains on 4 devs
    with pytest.raises(ValueError, match="must divide"):
        run_sharded_hmc(prob, opts, mass, m, m, 2, jax.random.PRNGKey(0), mesh)


def test_cube_potential_matches_masked(tiny_problem_shardable):
    """Dense weighted-cube misfit == masked-vector misfit."""
    prob, m0 = tiny_problem_shardable
    m = jnp.asarray(m0) + 0.1
    obs_cube, w_cube = prob.cube_arrays()
    U_cube, (mis_c, mn_c, _) = prob.potential_cube(
        m, jnp.asarray(m0), 1.0, jnp.asarray(prob.fwd.data.freqs),
        jnp.asarray(obs_cube), jnp.asarray(w_cube))
    U_vec, (mis_v, mn_v, _) = prob.potential(m, jnp.asarray(m0), 1.0)
    np.testing.assert_allclose(float(mis_c), float(mis_v), rtol=1e-12)
    np.testing.assert_allclose(float(U_cube), float(U_vec), rtol=1e-12)


@pytest.mark.parametrize("n_chain_dev, n_freq_dev", [(4, 1), (2, 2)])
def test_sharded_potential_value_and_grad_matches_single(
        tiny_problem_shardable, n_chain_dev, n_freq_dev):
    """ShardedSampler.potential_value_and_grad (what chip_smoke.py --four
    compares on real cards) == the single-device batched potential."""
    from hmcmt2d.parallel.multichain import ShardedSampler

    prob, m0 = tiny_problem_shardable
    rng = np.random.default_rng(3)
    m = jnp.asarray(m0 + 0.2 * rng.standard_normal((4, len(m0))))
    mref = jnp.broadcast_to(jnp.asarray(m0), m.shape)
    (U1, (_a, _b, pred1)), g1 = jax.jit(make_potential_vg(prob, 1.0))(m, mref)
    ss = ShardedSampler(prob, 1.0, make_device_mesh(n_chain_dev, n_freq_dev))
    U, g, pred = ss.potential_value_and_grad(m, mref)
    np.testing.assert_allclose(np.asarray(U), np.asarray(U1), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g1), rtol=1e-8,
                               atol=1e-12 * float(jnp.abs(g1).max()))
    np.testing.assert_allclose(np.asarray(pred), np.asarray(pred1), rtol=1e-10)


def test_sharded_hmc_runs_and_matches_semantics(tiny_problem_shardable):
    """4 chains on a (2 chains x 2 freq) device mesh; same-seed single-device
    run must agree exactly (the SPMD program is a pure re-layout)."""
    prob, m0 = tiny_problem_shardable
    cfg = HMCConfig(dt=0.05, timestep=(2, 3), sig_bounds=(1e-4, 10.0), reg_param=1.0)
    opts = hmc_options(cfg)
    C, S = 4, 4
    mass = H.identity_mass(len(m0))
    rng = np.random.default_rng(0)
    m_start = jnp.asarray(np.log(1 / 80.0) + 0.02 * rng.standard_normal((C, len(m0))))
    m_ref = m_start
    key = jax.random.PRNGKey(3)

    mesh = make_device_mesh(2, 2)
    res = run_sharded_hmc(prob, opts, mass, m_start, m_ref, S, key, mesh)
    models = np.asarray(res.models)
    assert models.shape == (S, C, len(m0))
    assert np.isfinite(np.asarray(res.stats)).all()

    # reference single-device run with the same per-chain-shard RNG layout:
    # device d hosts chains [2d, 2d+1] and uses fold_in(key, d)
    obs_cube, w_cube = prob.cube_arrays()
    freqs = jnp.asarray(prob.fwd.data.freqs)

    def potential_vg(m, mref):
        def single(mm, mr):
            return prob.potential_cube(mm, mr, cfg.reg_param, freqs,
                                       jnp.asarray(obs_cube), jnp.asarray(w_cube))
        return jax.vmap(jax.value_and_grad(single, has_aux=True))(m, mref)

    runner = jax.jit(lambda ms, mr, k: H.run_hmc(potential_vg, opts, mass,
                                                 ms, mr, S, k))
    outs = []
    for d in range(2):
        key_d = jax.random.fold_in(key, d)
        r = runner(m_start[2 * d:2 * d + 2], m_ref[2 * d:2 * d + 2], key_d)
        outs.append(np.asarray(r.models))
    want = np.concatenate(outs, axis=1)
    np.testing.assert_allclose(models, want, rtol=5e-5, atol=1e-6)

    # predicted data comes back masked onto the observed triples (exactly
    # the single-device layout); final keeps the cube for segmenting
    d = prob.fwd.data
    assert res.pred.shape == (S, C, d.n_data)
    assert res.start_pred.shape == (C, d.n_data)
    assert res.final.pred.shape == (C, d.n_freq, d.n_rx * d.n_comp)
    assert res.lf_steps.shape == (S, C)


def test_sharded_driver_warmup_segments_resume(tiny_problem_shardable, tmp_path):
    """The full driver pipeline (warmup adaptation -> segmented checkpointed
    main phase -> resume) on a (2 chains x 2 freq) mesh:

    * sharded warmup pools statistics across the chains mesh axis with pmean
      — must equal a single-device warmup over the same chains when each
      device's local batch sees the same pooled statistics;
    * a segmented sharded run resumed from its checkpoint must be bit-exact
      vs an unsegmented sharded run.
    """
    import os

    from hmcmt2d.parallel.multichain import ShardedSampler
    from hmcmt2d.sampler import adapt as A

    prob, m0 = tiny_problem_shardable
    cfg = HMCConfig(dt=0.05, timestep=(2, 3), sig_bounds=(1e-4, 10.0),
                    reg_param=1.0)
    opts = hmc_options(cfg)
    C = 4
    rng = np.random.default_rng(1)
    m_start = jnp.asarray(np.log(1 / 80.0) + 0.02 * rng.standard_normal((C, len(m0))))
    key = jax.random.PRNGKey(5)

    mesh = make_device_mesh(2, 2)
    ss = ShardedSampler(prob, cfg.reg_param, mesh)

    # --- warmup parity: pmean over 2-chain shards == pooled 4-chain batch
    # only when the pooled statistics agree; with identical chains per shard
    # the pooled mean equals the per-shard mean, so use identical pairs.
    m_pair = jnp.concatenate([m_start[:1], m_start[:1], m_start[2:3], m_start[2:3]])
    n_warm = 8
    wres_s, state_s, mass_s, info_s = ss.warmup(opts, m_pair, m_pair, n_warm, key)
    assert np.isfinite(np.asarray(wres_s.stats)).all()
    assert float(info_s.dt) > 0
    assert np.asarray(mass_s.inv_m).shape == (len(m0),)

    # --- segmented + checkpoint/resume bit-exactness on the sharded path
    from hmcmt2d.sampler import checkpoint as CK

    mass = H.identity_mass(len(m0))
    S = 6
    full = ss.run(opts, mass, m_start, m_start, S, key)

    seg1 = ss.run(opts, mass, m_start, m_start, 3, key)
    ck_path = os.path.join(str(tmp_path), "shard.ckpt.npz")
    CK.save_checkpoint(ck_path, n_done=3, state=seg1.final, key=key,
                       dt=opts.dt, mass=mass, m_ref=np.asarray(m_start),
                       models=np.asarray(seg1.models),
                       stats=np.asarray(seg1.stats),
                       accepts=np.asarray(seg1.accepts),
                       pred=np.asarray(seg1.pred),
                       lf_steps=np.asarray(seg1.lf_steps),
                       start_stats=np.asarray(seg1.start_stats),
                       start_pred=np.asarray(seg1.start_pred),
                       n_warm=0, wall_time=0.0)
    ck = CK.load_checkpoint(ck_path)
    seg2 = ss.run(opts, mass, ck["state"].m, jnp.asarray(ck["m_ref"]), 3,
                  ck["key"], init_state=ck["state"], key_offset=ck["n_done"])
    got = np.concatenate([np.asarray(seg1.models), np.asarray(seg2.models)])
    np.testing.assert_array_equal(got, np.asarray(full.models))
    got_pred = np.concatenate([np.asarray(seg1.pred), np.asarray(seg2.pred)])
    np.testing.assert_array_equal(got_pred, np.asarray(full.pred))


def test_sharded_warmup_segmented_matches_single(tiny_problem_shardable):
    """seg-mented sharded warmup must be bit-exact with the one-scan path
    (same global key schedule + precomputed window schedule)."""
    from hmcmt2d.parallel.multichain import ShardedSampler
    from hmcmt2d.utils.host import to_host

    problem, m0 = tiny_problem_shardable
    mesh = make_device_mesh(2, 2)
    C = 4
    m_start = jnp.broadcast_to(jnp.asarray(m0), (C, len(m0)))
    opts = H.HMCOptions(dt=0.01, steps_lo=2, steps_hi=3,
                        log_sig_lo=float(np.log(1e-4)),
                        log_sig_hi=float(np.log(10.0)), reg_param=1.0)
    ss = ShardedSampler(problem, 1.0, mesh)
    key = jax.random.PRNGKey(7)
    n_warm = 6
    r1, st1, mass1, info1 = ss.warmup(opts, m_start, m_start, n_warm, key)
    ss2 = ShardedSampler(problem, 1.0, mesh)
    r2, st2, mass2, info2 = ss2.warmup(opts, m_start, m_start, n_warm, key,
                                       seg=2)
    np.testing.assert_array_equal(np.asarray(r1.models), np.asarray(r2.models))
    np.testing.assert_array_equal(np.asarray(r1.stats), np.asarray(r2.stats))
    np.testing.assert_array_equal(np.asarray(r1.accepts), np.asarray(r2.accepts))
    np.testing.assert_array_equal(np.asarray(r1.start_stats),
                                  np.asarray(r2.start_stats))
    np.testing.assert_array_equal(np.asarray(to_host(r1.start_pred)),
                                  np.asarray(to_host(r2.start_pred)))
    assert float(info1.dt) == float(info2.dt)
    np.testing.assert_array_equal(np.asarray(mass1.inv_m),
                                  np.asarray(mass2.inv_m))
    np.testing.assert_array_equal(np.asarray(st1.m), np.asarray(st2.m))


def test_sharded_median_alpha_pool_survives_stuck_chain():
    """Sharded warmup with alpha_pool='median' must all_gather the chains
    axis and keep adapting when a minority of GLOBAL chains is pinned at
    alpha=0 — a silent downgrade of median to mean on the SPMD path would
    leave the production recipe exposed to the dt death-spiral it was built
    to prevent."""
    from functools import partial

    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as PS

    from hmcmt2d.sampler import adapt as A

    P, C = 3, 6
    m0 = np.zeros((C, P))
    devs = np.asarray(jax.devices()[:2]).reshape(2, 1)
    dmesh = Mesh(devs, ("chains", "freq"))

    def vg(m, m_ref, fac=None):
        U = 0.5 * jnp.sum(m * m, axis=-1)
        moved = jnp.sum((m - m_ref) ** 2, axis=-1) > 1e-20
        # chains with GLOBAL id 0,1 sit on a cliff: any move costs +1e6
        # potential.  They land on the SAME shard, so the per-shard
        # local-median would also be dragged to 0 for that shard — the
        # pooled statistic must be the median over the gathered global set.
        gid = lax.axis_index("chains") * m.shape[0] + jnp.arange(m.shape[0])
        cliff = jnp.where(gid < 2, 1e6, 0.0)
        U = U + jnp.where(moved, cliff, 0.0)
        pred = jnp.zeros(m.shape[:-1] + (1,))
        return (U, (U, jnp.zeros_like(U), pred)), m

    opts = H.HMCOptions(dt=0.5, steps_lo=2, steps_hi=3,
                        log_sig_lo=-50.0, log_sig_hi=50.0, reg_param=1.0)

    def run(pool):
        w = A.WarmupOptions(adapt_mass=False, alpha_pool=pool)

        @partial(jax.shard_map, mesh=dmesh, in_specs=(PS("chains"),),
                 out_specs=PS(), check_vma=False)
        def shard_warm(m0_l):
            _res, _st, _mass, info = A.warmup(
                vg, opts, m0_l, m0_l, 120, jax.random.PRNGKey(0), w,
                pool_axis="chains")
            return info.dt

        return float(jax.jit(shard_warm)(jnp.asarray(m0)))

    dt_median = run("median")
    dt_mean = run("mean")
    assert dt_median > 0.05, dt_median                     # healthy adaptation
    assert dt_mean < dt_median / 50, (dt_mean, dt_median)  # the spiral


def test_sharded_driver_gn_schedule(tiny_problem_shardable):
    """Full driver path with masstype gaussnewton over a (2 chains x 2 freq)
    device mesh: diagonal warmup (SPMD) -> GN mass -> sharded dt re-adaptation
    under the fixed dense metric -> dense-mass SPMD main phase."""
    from hmcmt2d.sampler.driver import run_inversion
    from tests.test_e2e import tiny_setup

    mesh_, start_sig, data, obs, err = tiny_setup()
    cfg = HMCConfig(burnin=4, total_samples=14, sig_bounds=(1e-4, 10.0),
                    dt=0.05, timestep=(2, 3), reg_param=1.0, seed=0,
                    adapt=True, mass_type="gaussnewton", mass_warmup=4,
                    mass_dt0=0.2)
    dm = make_device_mesh(2, 2)
    run = run_inversion(cfg, mesh_, start_sig, data, obs, err, n_chains=4,
                        solve_cfg=F.SolveConfig(jnp.complex128, 0),
                        device_mesh=dm)
    assert run.n_warm == 8
    res = run.result
    S, C, P = res.models.shape
    assert (S, C) == (14, 4)
    assert np.isfinite(np.asarray(res.stats)).all()
    assert float(np.asarray(res.accepts)[8:].mean()) > 0.0
