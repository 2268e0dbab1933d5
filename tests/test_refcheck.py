"""The reference check behind chip_smoke.py's phase 3 (hmcmt2d.utils.refcheck)."""

import numpy as np
import jax.numpy as jnp
import pytest

from hmcmt2d.io import synthetic
from hmcmt2d.models.forward import SolveConfig
from hmcmt2d.utils import refcheck as R


def _values(rng, C=3, P=5, D=4):
    return {"U": rng.uniform(10, 20, C), "grad": rng.standard_normal((C, P)),
            "pred": rng.standard_normal((C, D)) + 1j * rng.standard_normal((C, D))}


def test_compare_identical_passes(rng):
    v = _values(rng)
    m = R.compare(v, v)
    assert m["data"] == 0 and m["potential"] == 0 and m["grad_rel_l2"] == 0
    assert m["grad_cos"] == pytest.approx(1.0)
    assert R.passes(m)


@pytest.mark.parametrize("field, scale, metric", [
    ("pred", 1e-3, "data"), ("U", 1e-3, "potential"),
    ("grad", 0.05, "grad_rel_l2"), ("grad", np.nan, "grad_cos")])
def test_compare_detects_each_error(rng, field, scale, metric):
    ref = _values(rng)
    test = {k: v.copy() for k, v in ref.items()}
    test[field] = test[field] * (1 + scale)
    m = R.compare(test, ref)
    assert not R.passes(m), (metric, m)


def test_perturbed_states_seeded():
    m_ref = np.linspace(-5, -4, 7)
    a = R.perturbed_states(m_ref, 3, seed=1)
    assert a.shape == (3, 7)
    np.testing.assert_array_equal(a, R.perturbed_states(m_ref, 3, seed=1))
    assert not np.allclose(a, R.perturbed_states(m_ref, 3, seed=2))
    assert 0.1 < np.std(a - m_ref) < 0.3


def test_check_gpu_policy_on_cpu(tmp_path):
    """The check runs on the CPU too: the GPU's complex128 block-Thomas
    policy agrees with the BCR reference far inside the bar."""
    files = synthetic.write_flagship(tmp_path, seed=2, tiny=True)
    metrics, cfg = R.check(files["startupfile"], n=2, seed=0,
                           cfg=SolveConfig(jnp.complex128, 0, "thomas", "lu"))
    assert cfg.solver_method == "thomas"
    assert R.passes(metrics)
    assert metrics["potential"] < 1e-10 and metrics["grad_rel_l2"] < 1e-8


@pytest.mark.gpu
def test_reference_check_on_gpu(gpu_device, tmp_path):
    """The GPU default configuration against the CPU complex128 reference
    (what chip_smoke.py phase 3 runs at flagship size)."""
    files = synthetic.write_flagship(tmp_path, seed=0, tiny=True)
    metrics, cfg = R.check(files["startupfile"], n=8, seed=0)
    assert R.passes(metrics), metrics
