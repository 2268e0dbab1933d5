"""True multi-process jax.distributed execution (the multi-host code path).

``distributed_init`` must execute with more than one real process — the
other tests and dryruns use one process with 8 virtual
devices, which exercises the SPMD program but not cross-process collectives.
Here two real worker processes (2 local CPU devices each) form the 4-device
(chains=2, freq=2) mesh, run the sharded warmup + sampler with gloo
collectives across the process boundary, and the result must match the
single-process run of the identical program on a virtual 4-device mesh
(same interpreter config, run as a third subprocess).

Reference analogue: local worker processes exercising the Distributed path
(MUMPS/test/testDestroyMUMPS.jl:33-36, README.md:143-153).
"""

import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(args, env):
    return subprocess.Popen([sys.executable, WORKER, *args], env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def test_two_process_distributed_matches_single_process(tmp_path):
    port = _free_port()
    out_mp = str(tmp_path / "mp.npz")
    out_sp = str(tmp_path / "sp.npz")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)   # workers manage their own device counts

    procs = [_run([str(i), str(port), out_mp], env) for i in range(2)]
    procs.append(_run(["single", "-", out_sp], env))
    logs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=600)
        logs.append(stdout)
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(logs)
    assert os.path.exists(out_mp) and os.path.exists(out_sp), logs

    got = np.load(out_mp)
    want = np.load(out_sp)

    np.testing.assert_allclose(got["dt"], want["dt"], rtol=1e-6)
    np.testing.assert_allclose(got["inv_m"], want["inv_m"], rtol=1e-6)
    np.testing.assert_allclose(got["wmodels"], want["wmodels"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["models"], want["models"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["stats"], want["stats"],
                               rtol=1e-4, atol=1e-6)
