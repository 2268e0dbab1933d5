"""Check the potential, its gradient and the predicted data of a solve
configuration against the complex128 CPU reference.

The reference is ``jax.value_and_grad`` of the same potential under the
exact engine (complex128 block cyclic reduction, no refinement) on the CPU
device of the same process, which therefore needs ``jax_enable_x64``.  Both
sides evaluate the same chain states: the startup file's model plus seeded
Gaussian perturbations of the active (earth) cells.
"""

from __future__ import annotations

import numpy as np

# bar on (max |d pred| / max |pred|, max relative potential error, min
# per-chain gradient cosine, max per-chain relative gradient L2 error)
BAR = {"data": 1e-4, "potential": 1e-4, "grad_cos": 0.9999, "grad_rel_l2": 1e-2}


def load_problem(startupfile, cfg=None):
    """(problem, m_ref, reg) of a startup file under solve config ``cfg``."""
    from ..io.startup import read_startup
    from ..models.posterior import build_inverse_problem

    hcfg, mesh, sigma2d, data, obs, err = read_startup(startupfile)
    problem, m0 = build_inverse_problem(mesh, data, obs, err,
                                        np.asarray(sigma2d).ravel(),
                                        sigma_fixed=hcfg.sig_fix, cfg=cfg)
    return problem, np.asarray(m0, np.float64), hcfg.reg_param


def perturbed_states(m_ref: np.ndarray, n: int, seed: int,
                     scale: float = 0.2) -> np.ndarray:
    """(n, P) states ``m_ref + scale * N(0, 1)``."""
    rng = np.random.default_rng(seed)
    return m_ref[None] + scale * rng.standard_normal((n, len(m_ref)))


def evaluate(problem, states, m_ref, reg) -> dict:
    """Potential ``U`` (C,), gradient ``grad`` (C, P) and predicted data
    ``pred`` (C, D) of the batched potential on the default device, as
    float64/complex128 numpy."""
    import jax
    import jax.numpy as jnp

    from ..sampler.driver import make_potential_vg
    from .host import to_host

    m = jnp.asarray(states, jnp.result_type(float))
    mref = jnp.broadcast_to(jnp.asarray(m_ref, m.dtype), m.shape)
    (U, (_mis, _mn, pred)), g = jax.jit(make_potential_vg(problem, reg))(m, mref)
    return {"U": np.asarray(U, np.float64), "grad": np.asarray(g, np.float64),
            "pred": to_host(pred).astype(np.complex128)}


def compare(test: dict, ref: dict) -> dict:
    """Error metrics of ``test`` against ``ref`` (outputs of :func:`evaluate`)."""
    dp = np.abs(test["pred"] - ref["pred"]).max() / np.abs(ref["pred"]).max()
    du = np.max(np.abs(test["U"] - ref["U"]) / np.abs(ref["U"]))
    gt, gr = test["grad"], ref["grad"]
    cos = np.sum(gt * gr, -1) / (np.linalg.norm(gt, axis=-1)
                                 * np.linalg.norm(gr, axis=-1))
    rel = np.linalg.norm(gt - gr, axis=-1) / np.linalg.norm(gr, axis=-1)
    return {"data": float(dp), "potential": float(du),
            "grad_cos": float(cos.min()), "grad_rel_l2": float(rel.max())}


def passes(metrics: dict) -> bool:
    """True when every metric is within :data:`BAR` (NaN fails)."""
    return (metrics["data"] <= BAR["data"]
            and metrics["potential"] <= BAR["potential"]
            and metrics["grad_cos"] >= BAR["grad_cos"]
            and metrics["grad_rel_l2"] <= BAR["grad_rel_l2"])


def check(startupfile, n: int = 8, seed: int = 0, cfg=None):
    """Evaluate ``cfg`` (the backend default when None) on the default
    device and the exact complex128 engine on the CPU device at ``n`` seeded
    states; returns (metrics, cfg) — see :func:`compare` and :func:`passes`."""
    import jax

    from ..models.forward import SolveConfig

    if not jax.config.jax_enable_x64:
        raise RuntimeError("the complex128 reference needs jax_enable_x64")
    problem, m_ref, reg = load_problem(startupfile, cfg)
    states = perturbed_states(m_ref, n, seed)
    test = evaluate(problem, states, m_ref, reg)
    with jax.default_device(jax.devices("cpu")[0]):
        ref_problem, _, _ = load_problem(startupfile, SolveConfig())
        ref = evaluate(ref_problem, states, m_ref, reg)
    return compare(test, ref), problem.fwd.cfg
