"""Seeded flagship deployment: model, data and startup files from a seed.

The flagship is a dprism-scale synthetic survey: a graded 96 x 56 mesh
(7 air layers over 49 earth layers), 41 stations on the surface, 11
frequencies from 100 Hz to 0.01 Hz and ZXY + ZYX impedances.  The true
earth is a 100 Ohm.m half-space holding a seeded conductive prism; the
observations are its forward response with 3 % complex noise and 3 %
amplitude errors.  The start model written beside them is the homogeneous
100 Ohm.m half-space, as in the reference's dprism example.

    python -m hmcmt2d.io.synthetic OUTDIR [--seed N]

writes ``flagship.mod``, ``flagship_true.mod``, ``flagship.dat`` and
``startupfile`` into OUTDIR.
"""

from __future__ import annotations

import os

import numpy as np

from ..constants import SIGMA_AIR
from ..mesh import TensorMesh2D, make_mesh
from ..models.data import MTData
from .data_io import write_data
from .model_io import write_model

SIGMA_BG = 0.01      # 100 Ohm.m background
SIGMA_PRISM = 0.1    # 10 Ohm.m conductive prism
NOISE = 0.03         # relative complex noise and error level

# startup keys of the flagship deployment (dprism3d example settings with
# the Gauss-Newton metric schedule)
FLAGSHIP_STARTUP = {
    "burninsamples": 300,
    "totalsamples": 10000,
    "resistivity": "1.0 1e4 0.05",
    "timeinterval": 0.03,
    "timestep": "6 10",
    "smoothparameter": 1.0,
    "chains": 8,
    "adapt": "on",
    "warmuppool": "median",
    "masstype": "gaussnewton",
    "masswarmup": 200,
    "massdt0": 0.2,
}


def flagship_mesh(tiny=False) -> TensorMesh2D:
    """dprism-like graded mesh (examples/dprism3d/dprism2d_G96x49.mod);
    ``tiny``: 12 x 11 cells for CPU tests."""
    ny, nz_earth = (12, 8) if tiny else (96, 49)
    n_pad = min(8, (ny - 4) // 2)
    pad = 200.0 * 2.0 ** np.arange(1, n_pad + 1)
    dy = np.concatenate([pad[::-1], np.full(ny - 2 * n_pad, 200.0), pad])
    air = np.array([100.0, 300, 1000, 3000, 10000, 30000, 100000])[:max(3, 7 - 4 * tiny)]
    n_fine = min(40, nz_earth - 5)
    dz_earth = np.concatenate([np.full(n_fine, 100.0),
                               100.0 * 2.0 ** np.arange(1, nz_earth - n_fine + 1)])
    z_len = np.concatenate([air[::-1], dz_earth])
    origin = np.array([dy.sum() / 2, air.sum()])
    return make_mesh(dy, z_len, air_layer=air, origin=origin)


def flagship_survey(mesh: TensorMesh2D, n_freq=11, tiny=False) -> MTData:
    """Stations evenly over the uniform core, ``n_freq`` log-spaced
    frequencies from 100 Hz to 0.01 Hz, ZXY + ZYX impedances at every
    (frequency, station); ``tiny``: 4 stations and 4 frequencies."""
    n_rx = 41
    if tiny:
        n_rx, n_freq = 4, 4
    dy = np.asarray(mesh.y_len)
    n_pad = min(8, (len(dy) - 4) // 2)
    span = dy[n_pad:-n_pad].sum()
    rx_y = np.linspace(-span / 2 + 400, span / 2 - 400, n_rx)
    rx_loc = np.stack([rx_y, np.zeros(n_rx)], axis=1)
    freqs = np.logspace(2, -2, n_freq)
    f, r, d = np.meshgrid(np.arange(n_freq), np.arange(n_rx), np.arange(2),
                          indexing="ij")
    return MTData(rx_loc=rx_loc, freqs=freqs, data_type="Impedance",
                  data_comp=("ZXY", "ZYX"), freq_id=f.ravel(), rx_id=r.ravel(),
                  dt_id=d.ravel()).validate()


def start_model(mesh: TensorMesh2D) -> np.ndarray:
    """Homogeneous 100 Ohm.m earth under 1e-8 S/m air: (nz, ny)."""
    sigma2d = np.full((mesh.nz, mesh.ny), SIGMA_BG)
    sigma2d[:mesh.n_air] = SIGMA_AIR
    return sigma2d


def prism_model(mesh: TensorMesh2D, seed: int) -> np.ndarray:
    """The start model with a seeded 10 Ohm.m prism inside the uniform
    core: 20-40 % of the core wide, its top in the upper half of the fine
    earth layers, 15-30 % of them thick."""
    rng = np.random.default_rng(seed)
    sigma2d = start_model(mesh)
    ny, n_air = mesh.ny, mesh.n_air
    n_pad = min(8, (ny - 4) // 2)
    core = ny - 2 * n_pad
    n_earth = mesh.nz - n_air
    width = max(1, int(core * rng.uniform(0.2, 0.4)))
    y0 = n_pad + int(rng.integers(0, core - width + 1))
    height = max(1, int(n_earth * rng.uniform(0.15, 0.3)))
    z0 = n_air + 1 + int(rng.integers(0, max(1, n_earth // 2 - height)))
    sigma2d[z0:z0 + height, y0:y0 + width] = SIGMA_PRISM
    return sigma2d


def synthetic_observations(mesh: TensorMesh2D, data: MTData, sigma2d,
                           seed: int):
    """(obs, err): the forward response of ``sigma2d`` under the backend's
    default solve configuration with NOISE relative complex Gaussian noise,
    and errors of NOISE x |obs|."""
    import jax
    import jax.numpy as jnp

    from ..models.forward import make_forward
    from ..utils.host import to_host

    fwd = make_forward(mesh, data)
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    clean = to_host(jax.jit(fwd.predict)(jnp.asarray(sigma2d, dtype)))
    rng = np.random.default_rng(seed + 1)
    noise = rng.standard_normal(len(clean)) + 1j * rng.standard_normal(len(clean))
    obs = clean * (1 + NOISE * noise / np.sqrt(2))
    return obs, NOISE * np.abs(obs)


def write_startup(path, datafile: str, modelfile: str, **keys) -> None:
    """Startup file naming the data and model files (relative to its own
    directory) with ``keys`` as ``key: value`` lines."""
    with open(path, "w") as f:
        f.write(f"{'datafile:':<17}{datafile}\n{'modelfile:':<17}{modelfile}\n")
        for k, v in keys.items():
            f.write(f"{k + ':':<17}{v}\n")


def write_flagship(outdir, seed: int = 0, tiny: bool = False,
                   **startup) -> dict:
    """Write the seeded flagship deployment into ``outdir``.

    ``startup`` overrides :data:`FLAGSHIP_STARTUP` keys.  Returns the paths
    and the in-memory arrays: ``startupfile``, ``model``, ``true_model``,
    ``data``, ``mesh``, ``survey``, ``sigma_start``, ``sigma_true``, ``obs``
    and ``err``.
    """
    os.makedirs(outdir, exist_ok=True)
    mesh = flagship_mesh(tiny=tiny)
    survey = flagship_survey(mesh, tiny=tiny)
    sigma_start = start_model(mesh)
    sigma_true = prism_model(mesh, seed)
    obs, err = synthetic_observations(mesh, survey, sigma_true, seed)

    out = {k: os.path.join(outdir, f) for k, f in (
        ("model", "flagship.mod"), ("true_model", "flagship_true.mod"),
        ("data", "flagship.dat"), ("startupfile", "startupfile"))}
    write_model(out["model"], mesh, sigma_start)
    write_model(out["true_model"], mesh, sigma_true)
    write_data(out["data"], survey, obs, err)
    write_startup(out["startupfile"], "flagship.dat", "flagship.mod",
                  **{**FLAGSHIP_STARTUP, "seed": seed, **startup})
    out.update(mesh=mesh, survey=survey, sigma_start=sigma_start,
               sigma_true=sigma_true, obs=obs, err=err)
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true")
    a = ap.parse_args()
    print(write_flagship(a.outdir, a.seed, a.tiny)["startupfile"])
