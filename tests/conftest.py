"""Test configuration: force CPU with 8 virtual devices and 64-bit mode.

Multi-chip sharding paths are exercised on a virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count), the same strategy the
driver uses for its multi-chip dry-run.  ``HMCMT2D_GPU_TESTS=1`` leaves the
platform unpinned so that the ``gpu``-marked tests can find a card:

    HMCMT2D_GPU_TESTS=1 python -m pytest -m gpu tests/
"""

import os

# jax.config (not only env vars) pins the platform: it still works when jax
# was imported earlier, as long as the backend has not been initialised.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("HMCMT2D_GPU_TESTS") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# NOTE: no persistent compilation cache for CPU tests — CPU AOT cache
# entries can reload with mismatched machine features.

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def small_mesh(ny=9, nz=7, rng=None, graded=True):
    """A small graded tensor mesh with 2 'air' rows for operator tests."""
    rng = rng or np.random.default_rng(42)
    if graded:
        dy = 100.0 * 2.0 ** rng.integers(0, 3, size=ny)
        dz = 80.0 * 2.0 ** rng.integers(0, 3, size=nz)
    else:
        dy = 100.0 * np.ones(ny)
        dz = 80.0 * np.ones(nz)
    return dy.astype(float), dz.astype(float)


@pytest.fixture(scope="session")
def flagship_files(tmp_path_factory):
    """The seeded flagship deployment (hmcmt2d.io.synthetic) written once
    per test session: paths and in-memory arrays."""
    from hmcmt2d.io import synthetic

    return synthetic.write_flagship(tmp_path_factory.mktemp("flagship"), seed=0)


@pytest.fixture
def gpu_device():
    """The first GPU JAX sees; skips where there is none (the suite pins
    JAX to the CPU unless HMCMT2D_GPU_TESTS=1)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")
