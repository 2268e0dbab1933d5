"""Worker process for the true multi-process jax.distributed test.

Launched (2x) by tests/test_multiprocess.py.  Each process owns 2 local CPU
devices; together they form the 4-device (chains=2, freq=2) global mesh the
sharded sampler runs on — the real DCN code path (cross-process gloo
collectives) that a single-process virtual mesh cannot exercise.  The
reference package tests its distributed path the same way, with local worker
processes (MUMPS/test/testDestroyMUMPS.jl:33-36, README.md:143-153).

Usage: python mp_worker.py <process_id> <port> <out.npz>
       python mp_worker.py single - <out.npz>    (single-process reference:
       the identical program on a 4-local-device virtual mesh, same config)
"""

import os
import sys


def main():
    pid, port, out = sys.argv[1], sys.argv[2], sys.argv[3]
    single = pid == "single"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4 if single else 2)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)

    from hmcmt2d.parallel.multichain import distributed_init

    if not single:
        distributed_init(f"localhost:{port}", num_processes=2,
                         process_id=int(pid))
        assert len(jax.local_devices()) == 2
    assert jax.device_count() == 4, jax.devices()

    import importlib.util

    import jax.numpy as jnp
    import numpy as np

    spec = importlib.util.spec_from_file_location(
        "graft", os.path.join(repo, "__graft_entry__.py"))
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)

    from jax.experimental import multihost_utils as mu

    from hmcmt2d.parallel.multichain import ShardedSampler, make_device_mesh
    from hmcmt2d.sampler import hmc as H

    problem, m0 = g._flagship_problem(tiny=True)
    mesh = make_device_mesh(2, 2)      # chains x freq over the 4 global devices
    C = 4
    m_start = jnp.broadcast_to(jnp.asarray(m0, jnp.float32), (C, len(m0)))
    opts = H.HMCOptions(dt=0.02, steps_lo=2, steps_hi=3,
                        log_sig_lo=float(np.log(1e-4)),
                        log_sig_hi=float(np.log(10.0)), reg_param=1.0)
    ss = ShardedSampler(problem, 1.0, mesh)
    wres, state, mass, info = ss.warmup(opts, m_start, m_start, 2,
                                        jax.random.PRNGKey(0))
    res = ss.run(opts, mass, state.m, m_start, 2, jax.random.PRNGKey(0),
                 init_state=state, key_offset=0)

    if single:
        models, stats, wmodels = (np.asarray(res.models),
                                  np.asarray(res.stats),
                                  np.asarray(wres.models))
    else:
        models = np.asarray(mu.process_allgather(res.models, tiled=True))
        stats = np.asarray(mu.process_allgather(res.stats, tiled=True))
        wmodels = np.asarray(mu.process_allgather(wres.models, tiled=True))
    if single or int(pid) == 0:
        np.savez(out, models=models, stats=stats, wmodels=wmodels,
                 dt=float(info.dt), inv_m=np.asarray(info.inv_m))
    if not single:
        jax.distributed.shutdown()


if __name__ == "__main__":
    main()
