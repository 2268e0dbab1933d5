"""Checkpoint/resume: a resumed run reproduces the uninterrupted stream."""

import numpy as np
import jax.numpy as jnp

from hmcmt2d.io import HMCConfig
from hmcmt2d.models import forward as F
from hmcmt2d.sampler.driver import run_inversion, _segment_plan
from tests.test_e2e import tiny_setup


def test_segment_plan():
    assert _segment_plan(10, 0) == [10]
    assert _segment_plan(10, 4) == [4, 4, 2]
    assert _segment_plan(8, 4) == [4, 4]
    assert _segment_plan(3, 10) == [3]
    assert _segment_plan(0, 4) == []


def test_checkpoint_resume_bit_exact(tmp_path):
    mesh, start_sig, data, obs, err = tiny_setup()
    cfg = HMCConfig(burnin=3, total_samples=15, sig_bounds=(1e-4, 10.0),
                    dt=0.05, timestep=(2, 3), reg_param=1.0, seed=0)
    scfg = F.SolveConfig(jnp.complex128, 0)
    ck = str(tmp_path / "run.ckpt.npz")

    # uninterrupted run, segmented + checkpointed
    full = run_inversion(cfg, mesh, start_sig, data, obs, err, n_chains=2,
                         solve_cfg=scfg, checkpoint_path=ck, checkpoint_every=4)
    # simulate a crash after segment 2: rewind the checkpoint by re-running
    # only the first 2 segments (8 of 12 post-warmup samples)
    ck2 = str(tmp_path / "partial.ckpt.npz")
    run_inversion(cfg, mesh, start_sig, data, obs, err, n_chains=2,
                  solve_cfg=scfg, n_samples=3 + 8,
                  checkpoint_path=ck2, checkpoint_every=4)

    resumed = run_inversion(cfg, mesh, start_sig, data, obs, err, n_chains=2,
                            solve_cfg=scfg, checkpoint_path=ck2,
                            checkpoint_every=4, resume=True)

    np.testing.assert_array_equal(np.asarray(full.result.models),
                                  np.asarray(resumed.result.models))
    np.testing.assert_array_equal(np.asarray(full.result.accepts),
                                  np.asarray(resumed.result.accepts))
    np.testing.assert_allclose(np.asarray(full.result.stats),
                               np.asarray(resumed.result.stats), rtol=1e-12)
    assert full.result.models.shape == (15, 2, full.problem.n_param)
