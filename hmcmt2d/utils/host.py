"""Host-side helpers: compile-cache location and device-to-host transfers.

:func:`to_host` fetches a complex device array as two real arrays (a tiny
jitted split) and recombines them on the host; :func:`from_host` is the
reverse.  Both are plain transfers for real arrays.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def compilation_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO, ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on the persistent XLA compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it, so
    nothing is set here; otherwise the cache goes to the fixed
    ``<repo>/.jax_cache``.  Call before the first jit execution.
    """
    path = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def real_dtype(dtype) -> np.dtype:
    """Real counterpart of a (possibly complex) dtype, computed on the host
    without issuing a device op."""
    return np.zeros(0, np.dtype(dtype)).real.dtype


@jax.jit
def _split(x):
    return jnp.real(x), jnp.imag(x)


def to_host(x) -> np.ndarray:
    """numpy copy of ``x``; complex device arrays go via an f32/f64 split."""
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "dtype") and jnp.iscomplexobj(x):
        re, im = _split(x)
        return np.asarray(re) + 1j * np.asarray(im)
    return np.asarray(x)


def tree_to_host(tree):
    """``to_host`` over every leaf of a pytree."""
    return jax.tree_util.tree_map(to_host, tree)


@jax.jit
def _join(re, im):
    from jax import lax

    return lax.complex(re, im)


def from_host(x):
    """Device array from numpy; complex arrays go via two real transfers +
    an in-jit ``lax.complex`` (the reverse of :func:`to_host`)."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        rdt = real_dtype(x.dtype)
        return _join(jnp.asarray(x.real.astype(rdt)),
                     jnp.asarray(x.imag.astype(rdt)))
    return jnp.asarray(x)


def tree_from_host(tree):
    """``from_host`` over every leaf of a pytree."""
    return jax.tree_util.tree_map(from_host, tree)
