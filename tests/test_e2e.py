"""End-to-end tiny inversion: driver -> sampler -> outputs -> diagnostics."""

import numpy as np
import jax
import jax.numpy as jnp

from hmcmt2d import mesh as M
from hmcmt2d.constants import SIGMA_AIR
from hmcmt2d.io import HMCConfig, read_data, read_model
from hmcmt2d.models import forward as F
from hmcmt2d.sampler import diagnostics as D
from hmcmt2d.sampler import outputs as O
from hmcmt2d.sampler.driver import run_inversion
from tests.test_forward import make_data


def tiny_setup():
    air = np.array([300.0, 2000.0, 15000.0])
    dz_earth = np.concatenate([np.full(3, 200.0), 200 * 2.0 ** np.arange(1, 6)])
    dy = np.concatenate([[30000, 5000], np.full(6, 800.0), [5000, 30000]])
    mesh = M.make_mesh(dy, np.concatenate([air[::-1], dz_earth]), air_layer=air,
                       origin=[35000 + 3 * 800, air.sum()])
    nair = mesh.n_air
    true_sig = np.full((mesh.nz, mesh.ny), 0.01)
    true_sig[:nair] = SIGMA_AIR
    true_sig[nair + 1:nair + 4, 3:6] = 0.1
    rx_loc = np.stack([np.linspace(400, 4000, 3), np.zeros(3)], axis=1)
    data = make_data(rx_loc, np.array([5.0, 0.5]))
    fwd = F.make_forward(mesh, data, F.SolveConfig(jnp.complex128, 0))
    rng = np.random.default_rng(7)
    clean = np.asarray(fwd.predict(jnp.asarray(true_sig)))
    err = 0.05 * np.abs(clean)
    obs = clean + err * (rng.standard_normal(len(clean))
                         + 1j * rng.standard_normal(len(clean))) / np.sqrt(2)
    # homogeneous 100 Ohm.m start model
    start_sig = np.full((mesh.nz, mesh.ny), 0.01)
    start_sig[:nair] = SIGMA_AIR
    return mesh, start_sig, data, obs, err


def test_end_to_end_inversion(tmp_path):
    mesh, start_sig, data, obs, err = tiny_setup()
    cfg = HMCConfig(burnin=5, total_samples=25, sig_bounds=(1e-4, 10.0),
                    dt=0.05, timestep=(2, 3), reg_param=1.0, seed=0)
    run = run_inversion(cfg, mesh, start_sig, data, obs, err, n_chains=2,
                        solve_cfg=F.SolveConfig(jnp.complex128, 0))
    res = run.result
    S, C, P = res.models.shape
    assert (S, C) == (25, 2)
    assert P == run.problem.n_param

    stats = np.asarray(res.stats)
    start_misfit = float(np.asarray(res.start_stats)[:, 0].mean())
    final_misfit = stats[-5:, :, 0].mean()
    assert np.isfinite(stats).all()
    assert final_misfit < start_misfit, (start_misfit, final_misfit)
    accept_rate = float(np.asarray(res.accepts).mean())
    assert accept_rate > 0.1

    # bounds respected
    smax, smin = np.asarray(res.models).max(), np.asarray(res.models).min()
    assert smin >= np.log(1e-4) - 1e-5 and smax <= np.log(10.0) + 1e-5

    # nfevals counter: each iteration runs L in [timestep] leapfrog steps
    lf = np.asarray(res.lf_steps)
    assert lf.shape == (S, C)
    assert lf.min() >= 2 and lf.max() <= 3
    assert run.nfevals == int(lf.sum()) + C

    # outputs in reference-compatible formats
    O.write_posterior_models(run.problem, res.models, cfg.burnin, str(tmp_path))
    O.write_chain_outputs(res.models, res.stats, res.accepts, res.pred,
                          res.start_stats, chain=0, ichain=1,
                          cputime=run.wall_time, outdir=str(tmp_path),
                          start_pred=res.start_pred)
    mesh2, mean_sig = read_model(tmp_path / "meanModel.model")
    assert mean_sig.shape == (mesh.nz, mesh.ny)
    assert np.all(mean_sig[:mesh.n_air] == SIGMA_AIR)
    log_lines = (tmp_path / "hmcstatistics_id1.log").read_text().splitlines()
    assert log_lines[1].startswith("Totalsamples:     25")
    assert len(log_lines) == 4 + 25

    # .data file carries S+1 rows: the start-model row first
    # (outputHMCSamples, HMCSampler.jl:801-808)
    data_lines = (tmp_path / "hmcsamples_id1.data").read_text().splitlines()
    assert len(data_lines) == S + 1
    row0 = np.array(data_lines[0].split(), float)
    want0 = np.asarray(res.start_pred)[0]
    np.testing.assert_allclose(row0[0::2] + 1j * row0[1::2], want0, rtol=2e-4)

    # diagnostics run
    rhat = np.asarray(D.split_rhat(res.models))
    assert rhat.shape == (P,)
    assert np.isfinite(rhat).all()
    e = np.asarray(D.ess(res.models))
    assert e.shape == (P,) and np.all(e > 0)


def test_chain_outputs_thinning(tmp_path):
    """--out-thin: model/data dumps keep every Nth row, stats log stays full."""
    S, C, P, D_ = 11, 2, 3, 4
    rng = np.random.default_rng(0)
    models = rng.standard_normal((S, C, P))
    stats = rng.standard_normal((S, C, 4))
    accepts = rng.random((S, C)) > 0.5
    pred = rng.standard_normal((S, C, D_))
    start_stats = rng.standard_normal((C, 4))
    start_pred = rng.standard_normal((C, D_))
    O.write_chain_outputs(models, stats, accepts, pred, start_stats,
                          chain=1, ichain=2, outdir=str(tmp_path),
                          start_pred=start_pred, thin=4)
    m_lines = (tmp_path / "hmcsamples_id2.model").read_text().splitlines()
    assert len(m_lines) == len(range(0, S, 4))
    np.testing.assert_allclose(np.array(m_lines[1].split(), float),
                               models[4, 1], rtol=2e-4, atol=1e-7)
    d_lines = (tmp_path / "hmcsamples_id2.data").read_text().splitlines()
    assert len(d_lines) == len(range(0, S, 4)) + 1      # + start row
    log_lines = (tmp_path / "hmcstatistics_id2.log").read_text().splitlines()
    assert len(log_lines) == 4 + S                       # stats NOT thinned
