"""The seeded flagship deployment end to end (reduced samples).

The reference's sole integration test is running its examples through the
sampler (examples/dprism3d/runHMCscript.jl:22-33).  Here the flagship's
generated startup, data and model files (hmcmt2d.io.synthetic, the
``flagship_files`` fixture) are read unchanged and pushed through forward
modelling and a reduced-sample inversion.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from hmcmt2d.constants import MU0
from hmcmt2d.io.model_io import read_model
from hmcmt2d.io.startup import read_startup
from hmcmt2d.models.forward import SolveConfig, make_forward
from hmcmt2d.sampler.driver import run_inversion


def _nrms(pred, obs, err):
    return float(np.sqrt(np.mean(np.abs((pred - obs) / err) ** 2)))


def test_flagship_forward_physics(flagship_files):
    """Forward-model the homogeneous start model against the prism data: the
    misfit is well above the noise, and responses are physical."""
    cfg, mesh, sigma2d, data, obs, err = read_startup(
        flagship_files["startupfile"])
    assert data.n_data == 902 and data.n_freq == 11 and data.n_rx == 41
    assert (mesh.ny, mesh.nz) == (96, 56) and mesh.n_air == 7
    fwd = make_forward(mesh, data, SolveConfig(jnp.complex128, 0))
    pred = np.asarray(jax.jit(fwd.predict)(jnp.asarray(np.asarray(sigma2d))))
    assert _nrms(pred, obs, err) > 2.0
    # apparent resistivity and phase of ZXY at the highest frequency over
    # the 100 Ohm.m half-space: ~100 Ohm.m and ~45 degrees
    cube = pred.reshape(data.n_freq, data.n_rx, data.n_comp)
    om = 2 * np.pi * data.freqs[0]
    rho_a = np.abs(cube[0, :, 0]) ** 2 / (om * MU0)
    assert np.all((rho_a > 80) & (rho_a < 125)), rho_a
    phase = np.degrees(np.arctan2(cube[0, :, 0].imag, cube[0, :, 0].real))
    assert np.all(np.abs(phase - 45) < 5), phase


def test_flagship_true_model_fits_to_noise(flagship_files):
    """The true model's response fits the observations to the 3 % noise:
    normalised RMS ~ 1, so the model, data and their writers agree."""
    _, mesh, _, data, obs, err = read_startup(flagship_files["startupfile"])
    _, true2d = read_model(flagship_files["true_model"])
    fwd = make_forward(mesh, data, SolveConfig(jnp.complex128, 0))
    pred = np.asarray(jax.jit(fwd.predict)(jnp.asarray(true2d)))
    assert 0.8 < _nrms(pred, obs, err) < 1.2


def test_flagship_reduced_inversion(flagship_files, tmp_path):
    """The flagship startupfile through the full driver (reduced samples,
    no adaptation): config honoured, sampler moves, outputs written in
    reference formats."""
    cfg, mesh, sigma2d, data, obs, err = read_startup(
        flagship_files["startupfile"])
    assert cfg.total_samples == 10000 and cfg.burnin == 300
    assert cfg.dt == 0.03 and cfg.timestep == (6, 10)
    assert cfg.sig_bounds == (1e-4, 1.0) and cfg.reg_param == 1.0

    run = run_inversion(dataclasses.replace(cfg, adapt=False,
                                            mass_type="diagonal"),
                        mesh, sigma2d,
                        data, obs, err, n_chains=2,
                        solve_cfg=SolveConfig(jnp.complex128, 0),
                        n_samples=3, key=jax.random.PRNGKey(0))
    res = run.result
    stats = np.asarray(res.stats)
    assert np.isfinite(stats).all()
    assert res.models.shape == (3, 2, run.problem.n_param)
    # bounds from the file are respected by every sample
    assert float(res.models.max()) <= np.log(1.0) + 1e-5
    assert float(res.models.min()) >= np.log(1e-4) - 1e-5

    from hmcmt2d.sampler import outputs as O
    O.write_posterior_models(run.problem, res.models, 0, str(tmp_path))
    O.write_chain_outputs(res.models, res.stats, res.accepts, res.pred,
                          res.start_stats, chain=0, ichain=1,
                          outdir=str(tmp_path), start_pred=res.start_pred)
    mesh2, mean_sig = read_model(tmp_path / "meanModel.model")
    assert mean_sig.shape == (mesh.nz, mesh.ny)
    # air rows written back at exactly 1e-8 (writeEMModel2D strips air, our
    # writer mirrors it)
    assert np.allclose(mean_sig[:mesh.n_air], 1e-8)
    data_rows = (tmp_path / "hmcsamples_id1.data").read_text().splitlines()
    assert len(data_rows) == 3 + 1           # S+1 rows incl. start row
    assert len(data_rows[0].split()) == 2 * data.n_data
