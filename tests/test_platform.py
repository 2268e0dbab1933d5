"""Backend policy and device checks: what runs where, and what refuses."""

import argparse
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from hmcmt2d import cli
from hmcmt2d.models import forward as F
from hmcmt2d.ops import solver as S
from hmcmt2d.utils import host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.parametrize("backend, expect", [
    ("cpu", (jnp.complex128, 0, "bcr", "lu")),
    ("gpu", (jnp.complex128, 0, "thomas", "lu")),
])
def test_default_config_per_backend(monkeypatch, backend, expect):
    """x64 on (as in these tests): the exact CPU reference engine, and the
    GPU's complex128 block Thomas with batched LU."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    cfg = F.default_config()
    assert (cfg.solve_dtype, cfg.refine_iters, cfg.solver_method,
            cfg.inv_method) == expect


@pytest.mark.parametrize("backend", ["metal", "neuron"])
def test_default_config_unknown_backend_raises(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match="no solve configuration"):
        F.default_config()


def test_gpu_default_needs_x64():
    """Without x64 the GPU policy refuses instead of silently solving in
    complex64; enable_x64_for_backend turns it on for the GPU only."""
    code = ("import jax\n"
            "from hmcmt2d.models import forward as F\n"
            "F.enable_x64_for_backend()\n"
            "assert not jax.config.jax_enable_x64\n"
            "jax.default_backend = lambda: 'gpu'\n"
            "try:\n"
            "    F.default_config()\n"
            "except RuntimeError as e:\n"
            "    assert 'jax_enable_x64' in str(e)\n"
            "else:\n"
            "    raise SystemExit('no error')\n"
            "F.enable_x64_for_backend()\n"
            "assert jax.config.jax_enable_x64\n"
            "assert F.default_config().solve_dtype == jax.numpy.complex128\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_cpu_env(),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]


def test_compilation_cache_from_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is used as is: nothing is set in code."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert host.compilation_cache_dir() == str(tmp_path)
    assert host.enable_compilation_cache() == str(tmp_path)
    assert calls == []


def test_compilation_cache_default(monkeypatch):
    """Without the variable the cache is the fixed <repo>/.jax_cache."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    path = host.enable_compilation_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in calls


def test_bench_refuses_cpu():
    import bench

    with pytest.raises(SystemExit, match="NVIDIA GPU"):
        bench.main(smoke=False)


def test_chip_smoke_refuses_cpu():
    import chip_smoke

    with pytest.raises(SystemExit, match="only on an NVIDIA GPU"):
        chip_smoke.main([])


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """chip_smoke.py without the rest of the repo fails and prints no
    result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_cli_rejects_fused_solver(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--solver", "fused", "run", "startupfile"])
    assert e.value.code == 2
    assert "invalid choice: 'fused'" in capsys.readouterr().err


@pytest.mark.parametrize("ws", ["auto", "same", "thomas"])
def test_warmup_solver_without_hybrid(ws):
    """auto and same (and the main engine's own name) warm up on the main
    engine: no hybrid schedule."""
    cfg = F.SolveConfig(jnp.complex128, 0, "thomas")
    assert cli._warmup_cfg(argparse.Namespace(warmup_solver=ws), cfg) is None


def test_warmup_solver_explicit_engine():
    cfg = F.SolveConfig(jnp.complex64, 1, "thomas")
    w = cli._warmup_cfg(argparse.Namespace(warmup_solver="bcr"), cfg)
    assert (w.solver_method, w.refine_iters, w.solve_dtype) == (
        "bcr", 3, jnp.complex64)


def test_factorize_rejects_unknown_method():
    sys_ = S.InteriorSystem(jnp.ones((3, 4), jnp.complex128),
                            jnp.ones((3, 3)), jnp.ones((2, 4)))
    with pytest.raises(ValueError, match="unknown solver method"):
        S.factorize(sys_, method="fused")
