"""IO readers/writers: the seeded flagship deployment loads and round-trips."""

import numpy as np
import pytest

from hmcmt2d.constants import SIGMA_AIR
from hmcmt2d.io import read_data, read_model, read_startup, write_data, write_model
from hmcmt2d.io.startup import parse_startup


def test_read_flagship_model(flagship_files):
    mesh, sigma2d = read_model(flagship_files["model"])
    assert mesh.ny == 96
    assert mesh.nz == 49 + 7
    assert mesh.n_air == 7
    assert sigma2d.shape == (56, 96)
    assert np.all(sigma2d[:7] == SIGMA_AIR)
    # origin shifted up by the total air depth; y origin at the mesh centre
    np.testing.assert_allclose(float(mesh.origin[1]), 144400.0)
    np.testing.assert_allclose(float(mesh.origin[0]), 110000.0)
    # the start model is the homogeneous 100 Ohm.m earth
    assert np.all(sigma2d[7:] == 0.01)
    # the true model holds the 10 Ohm.m prism inside the uniform core
    _, true2d = read_model(flagship_files["true_model"])
    prism = np.argwhere(true2d == 0.1)
    assert len(prism) > 0
    assert prism[:, 0].min() > 7 and 8 <= prism[:, 1].min() <= prism[:, 1].max() < 88
    np.testing.assert_array_equal(true2d, flagship_files["sigma_true"])


def test_read_flagship_data(flagship_files):
    data, obs, err = read_data(flagship_files["data"])
    assert data.n_rx == 41
    assert data.n_freq == 11
    assert data.data_type == "Impedance"
    assert data.data_comp == ("ZXY", "ZYX")
    assert data.n_data == 902
    assert data.comp_te and data.comp_tm
    assert obs.dtype.kind == "c"
    # %15.6e round trip of the generated observations and 3 % errors
    np.testing.assert_allclose(obs, flagship_files["obs"], rtol=1e-6)
    np.testing.assert_allclose(err, 0.03 * np.abs(flagship_files["obs"]),
                               rtol=1e-6)
    # flat indices are unique and within the cube
    fi = data.flat_index
    assert len(np.unique(fi)) == len(fi)
    assert fi.max() < data.n_freq * data.n_rx * data.n_comp


def test_read_flagship_startup(flagship_files):
    cfg, mesh, sigma2d, data, obs, err = read_startup(
        flagship_files["startupfile"])
    assert cfg.burnin == 300 and cfg.total_samples == 10000
    np.testing.assert_allclose(cfg.sig_bounds, (1e-4, 1.0))
    assert cfg.dt == 0.03
    assert cfg.timestep == (6, 10)
    assert cfg.reg_param == 1.0
    assert cfg.sig_fix == (SIGMA_AIR,)
    assert cfg.n_chains == 8 and cfg.seed == 0 and cfg.adapt
    assert cfg.mass_type == "gaussnewton" and cfg.mass_warmup == 200
    assert cfg.warmup_pool == "median"
    assert data.n_rx == 41 and data.n_freq == 11
    assert mesh.ny == 96


def test_model_roundtrip(tmp_path, flagship_files):
    mesh, sigma2d = read_model(flagship_files["true_model"])
    p = tmp_path / "out.mod"
    write_model(p, mesh, sigma2d)
    mesh2, sigma2d2 = read_model(p)
    np.testing.assert_allclose(np.asarray(mesh2.y_len), np.asarray(mesh.y_len))
    np.testing.assert_allclose(np.asarray(mesh2.z_len), np.asarray(mesh.z_len))
    np.testing.assert_allclose(np.asarray(mesh2.origin), np.asarray(mesh.origin))
    np.testing.assert_allclose(sigma2d2, sigma2d, rtol=0.005)  # %4.2e format


def test_data_roundtrip(tmp_path, flagship_files):
    data, obs, err = read_data(flagship_files["data"])
    p = tmp_path / "out.dat"
    write_data(p, data, obs, err)
    data2, obs2, err2 = read_data(p)
    np.testing.assert_allclose(obs2, obs, rtol=1e-6)
    np.testing.assert_allclose(err2, err, rtol=1e-6)
    np.testing.assert_array_equal(data2.freq_id, data.freq_id)
    np.testing.assert_array_equal(data2.rx_id, data.rx_id)
    np.testing.assert_array_equal(data2.dt_id, data.dt_id)
    np.testing.assert_allclose(data2.rx_loc, data.rx_loc)
    np.testing.assert_allclose(data2.freqs, data.freqs, rtol=1e-4)


def test_default_error_floor(tmp_path, flagship_files):
    data, obs, err = read_data(flagship_files["data"])
    p = tmp_path / "out.dat"
    write_data(p, data, obs)  # no errors given -> 3% amplitude
    _, _, err2 = read_data(p)
    np.testing.assert_allclose(err2, 0.03 * np.abs(obs), rtol=1e-6)


def test_missing_startup_fields(tmp_path):
    p = tmp_path / "startupfile"
    p.write_text("burninsamples: 10\n")
    with pytest.raises(ValueError, match="datafile"):
        parse_startup(p)


def test_truncated_inputs_raise_located_errors(tmp_path):
    """A file ending mid-block raises a ValueError naming the file, not a
    raw StopIteration (failure-detection hygiene)."""
    import pytest

    from hmcmt2d.io.data_io import read_data
    from hmcmt2d.io.model_io import read_model

    bad_data = tmp_path / "trunc.dat"
    bad_data.write_text(
        "Receiver Location (m):  3\n  0.0 0.0\n  10.0 0.0\n")
    with pytest.raises(ValueError, match="trunc.dat.*mid-block"):
        read_data(bad_data)

    bad_model = tmp_path / "trunc.mod"
    bad_model.write_text("NY:  4\n 100.0 100.0\n")
    with pytest.raises(ValueError, match="trunc.mod.*mid-block"):
        read_model(bad_model)
