"""Driver-level engine scheduling tests.

* Hybrid warmup (exact engine) -> main (fast engine): the warmup sample
  stream must be bit-identical to a pure exact-engine run (same engine, same
  keys), and the main phase must run to a sane posterior under the fast
  engine (here complex128 warmup -> complex64+refine main).
* Segmented warmup on the PLAIN (non-sharded) path is bit-exact with the
  unsegmented path.
"""

import numpy as np
import jax.numpy as jnp

from hmcmt2d.io import HMCConfig
from hmcmt2d.models import forward as F
from hmcmt2d.sampler.driver import run_inversion
from tests.test_e2e import tiny_setup


def _cfg(**kw):
    base = dict(burnin=6, total_samples=14, sig_bounds=(1e-4, 10.0),
                dt=0.05, timestep=(2, 3), reg_param=1.0, seed=0, adapt=True)
    base.update(kw)
    return HMCConfig(**base)


def test_hybrid_warmup_engine_switch():
    mesh, start_sig, data, obs, err = tiny_setup()
    exact = F.SolveConfig(jnp.complex128, 0)
    fast = F.SolveConfig(jnp.complex64, 1, "thomas")

    hyb = run_inversion(_cfg(), mesh, start_sig, data, obs, err, n_chains=2,
                        solve_cfg=fast, warmup_solve_cfg=exact)
    pure = run_inversion(_cfg(), mesh, start_sig, data, obs, err, n_chains=2,
                         solve_cfg=exact)

    n_warm = hyb.n_warm
    assert n_warm == 6
    # warmup ran under the exact engine with the same key stream
    np.testing.assert_array_equal(np.asarray(hyb.result.models[:n_warm]),
                                  np.asarray(pure.result.models[:n_warm]))
    # main phase is healthy under the fast engine
    stats = np.asarray(hyb.result.stats)
    assert np.isfinite(stats).all()
    acc_main = float(np.asarray(hyb.result.accepts)[n_warm:].mean())
    assert acc_main > 0.2, acc_main
    assert hyb.result.models.shape == pure.result.models.shape


def test_hybrid_equals_manual_two_phase(tmp_path):
    """The hybrid main phase == running the fast engine from the warmed-up
    state: resume a hybrid checkpoint and extend it — streams must agree
    (the main-phase keys are a pure function of the global sample index)."""
    mesh, start_sig, data, obs, err = tiny_setup()
    exact = F.SolveConfig(jnp.complex128, 0)
    fast = F.SolveConfig(jnp.complex64, 1, "thomas")
    ck = str(tmp_path / "hyb.ckpt.npz")

    short = run_inversion(_cfg(total_samples=10), mesh, start_sig, data, obs,
                          err, n_chains=2, solve_cfg=fast,
                          warmup_solve_cfg=exact,
                          checkpoint_path=ck, checkpoint_every=2)
    full = run_inversion(_cfg(), mesh, start_sig, data, obs, err, n_chains=2,
                         solve_cfg=fast, warmup_solve_cfg=exact)
    resumed = run_inversion(_cfg(), mesh, start_sig, data, obs, err,
                            n_chains=2, solve_cfg=fast, warmup_solve_cfg=exact,
                            checkpoint_path=ck, checkpoint_every=2,
                            resume=True)
    np.testing.assert_array_equal(np.asarray(full.result.models),
                                  np.asarray(resumed.result.models))
    assert short.result.models.shape[0] == 10


def test_plain_segmented_warmup_bit_exact():
    """progress_every segments the plain-path warmup loop; the stream must
    match the unsegmented run exactly (models, stats, adapted kernel)."""
    mesh, start_sig, data, obs, err = tiny_setup()
    scfg = F.SolveConfig(jnp.complex128, 0)

    one = run_inversion(_cfg(), mesh, start_sig, data, obs, err, n_chains=2,
                        solve_cfg=scfg)
    seg = run_inversion(_cfg(), mesh, start_sig, data, obs, err, n_chains=2,
                        solve_cfg=scfg, progress_every=2)

    np.testing.assert_array_equal(np.asarray(one.result.models),
                                  np.asarray(seg.result.models))
    np.testing.assert_allclose(np.asarray(one.result.stats),
                               np.asarray(seg.result.stats), rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(one.result.accepts),
                                  np.asarray(seg.result.accepts))
