"""Periodic checkpoint / resume of a running HMC inversion.

Capability gap in the reference (SURVEY.md §5): the reference holds all
samples in memory for the whole chain and writes only at the end
(HMCSampler.jl:120-127,785-828) — a lost process loses the run.  Here the
driver samples in fixed-size segments and after each segment dumps the full
sampler state — current per-chain model/gradient/energies, the PRNG key
schedule position, adapted step size, mass matrix, and all accumulated
outputs — to a single ``.npz``.  ``resume=True`` continues bit-exactly: the
per-sample keys are a pure function of the global sample index, so a
resumed run produces the identical sample stream as an uninterrupted one.
"""

from __future__ import annotations

import os

import numpy as np

from . import hmc as H
from ..utils.host import to_host


FORMAT_VERSION = 3


def save_checkpoint(path: str, *, n_done: int, state: H.ChainState, key,
                    dt: float, mass: H.MassMatrix, m_ref,
                    models, stats, accepts, pred, lf_steps, start_stats,
                    start_pred, n_warm: int, wall_time: float) -> None:
    """Atomic (write-then-rename) checkpoint dump."""
    tmp = path + ".tmp"
    np.savez(
        tmp,
        version=FORMAT_VERSION,
        n_done=n_done,
        n_warm=n_warm,
        wall_time=wall_time,
        dt=dt,
        key=np.asarray(key),
        state_m=np.asarray(state.m),
        state_grad=np.asarray(state.grad),
        state_misfit=np.asarray(state.misfit),
        state_mnorm=np.asarray(state.mnorm),
        state_pred=to_host(state.pred),
        mass_sqrt=np.asarray(mass.sqrt_m),
        mass_inv=np.asarray(mass.inv_m),
        mass_diagonal=bool(mass.diagonal),
        m_ref=np.asarray(m_ref),
        models=np.asarray(models),
        stats=np.asarray(stats),
        accepts=np.asarray(accepts),
        pred=to_host(pred),
        lf_steps=np.asarray(lf_steps),
        start_stats=np.asarray(start_stats),
        start_pred=np.asarray(start_pred),
    )
    # numpy appends .npz to the temp name
    os.replace(tmp if os.path.exists(tmp) else tmp + ".npz", path)


def load_checkpoint(path: str) -> dict:
    """Load a checkpoint; returns a dict with ChainState/MassMatrix rebuilt."""
    import jax.numpy as jnp

    from ..utils.host import from_host

    with np.load(path) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {z['version']}")
        state = H.ChainState(
            m=jnp.asarray(z["state_m"]),
            grad=jnp.asarray(z["state_grad"]),
            misfit=jnp.asarray(z["state_misfit"]),
            mnorm=jnp.asarray(z["state_mnorm"]),
            # complex leaf: two real transfers (utils.host.from_host)
            pred=from_host(z["state_pred"]),
        )
        mass = H.MassMatrix(sqrt_m=jnp.asarray(z["mass_sqrt"]),
                            inv_m=jnp.asarray(z["mass_inv"]),
                            diagonal=bool(z["mass_diagonal"]))
        return dict(
            n_done=int(z["n_done"]),
            n_warm=int(z["n_warm"]),
            wall_time=float(z["wall_time"]),
            dt=float(z["dt"]),
            key=jnp.asarray(z["key"]),
            state=state,
            mass=mass,
            m_ref=np.asarray(z["m_ref"]),
            models=np.asarray(z["models"]),
            stats=np.asarray(z["stats"]),
            accepts=np.asarray(z["accepts"]),
            pred=np.asarray(z["pred"]),
            lf_steps=np.asarray(z["lf_steps"]),
            start_stats=np.asarray(z["start_stats"]),
            start_pred=np.asarray(z["start_pred"]),
        )
