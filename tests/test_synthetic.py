"""The seeded flagship deployment writer (hmcmt2d.io.synthetic) and the
CLI run on it."""

import json

import numpy as np

from hmcmt2d import cli
from hmcmt2d.constants import SIGMA_AIR
from hmcmt2d.io import read_startup
from hmcmt2d.io import synthetic as syn


def test_prism_model_seeded():
    mesh = syn.flagship_mesh()
    a, b = syn.prism_model(mesh, 0), syn.prism_model(mesh, 1)
    np.testing.assert_array_equal(a, syn.prism_model(mesh, 0))
    assert not np.array_equal(a, b)
    for m in (a, b):
        assert np.all(m[:mesh.n_air] == SIGMA_AIR)
        assert set(np.unique(m[mesh.n_air:])) == {syn.SIGMA_BG, syn.SIGMA_PRISM}


def test_flagship_survey_shape():
    mesh = syn.flagship_mesh()
    data = syn.flagship_survey(mesh)
    assert (mesh.ny, mesh.nz, mesh.n_air) == (96, 56, 7)
    assert (data.n_rx, data.n_freq, data.n_data) == (41, 11, 902)
    assert data.data_comp == ("ZXY", "ZYX")
    assert syn.flagship_survey(mesh, n_freq=12).n_freq == 12


def test_cli_run_on_tiny_flagship(tmp_path):
    """`hmcmt2d run` through the GN schedule on the seeded deployment:
    run_summary.json reports a healthy run."""
    files = syn.write_flagship(tmp_path, seed=4, tiny=True, burninsamples=4,
                               masswarmup=4, totalsamples=12, timestep="2 3")
    cfg = read_startup(files["startupfile"])[0]
    assert (cfg.burnin, cfg.mass_warmup, cfg.total_samples, cfg.seed) == (
        4, 4, 12, 4)
    out = tmp_path / "out"
    rc = cli.main(["run", files["startupfile"], "--chains", "2", "--outdir",
                   str(out), "--checkpoint", str(out / "ck.npz"),
                   "--checkpoint-every", "2"])
    assert rc == 0
    s = json.loads((out / "run_summary.json").read_text())
    assert s["chains"] == 2 and s["warmup_samples"] == 8
    assert s["main_samples"] == 4 and s["stats_finite"]
    assert s["misfit_end"] < s["misfit_start"]
    assert s["dt"] > 0 and 0 < s["accept_rate_main"] <= 1
    assert s["main_samples_per_sec"] > 0 and s["platform"] == "cpu"
