"""One wire protocol: the port's native transport against the JAX
package's, both ways.

A ``NativeProcessBackend(spawn=False)`` coordinator of either package
serves worker processes of the other (``python -m <package>.worker``,
jax-free in both), and one coordinator serves a worker of each at once,
through a kmap2-style echo run (reference test/kmap2.jl:32-54: workers
return ``[rank + 1, payload, epoch]``, one worker slowed so the
fastest-k return and stale re-tasking both happen). Every echo is
checked exactly; tolerance: none. The workers' ``--work`` callables live
in this module, which imports neither torch nor jax.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from mpistragglers_jl_tpu.backends.native import (
    NativeProcessBackend as JaxNativeBackend,
)
from mpistragglers_jl_tpu_torch.backends.native import NativeProcessBackend
from mpistragglers_jl_tpu_torch.pool import AsyncPool, asyncmap, waitall

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
PORT, JAX = "mpistragglers_jl_tpu_torch", "mpistragglers_jl_tpu"
N, EPOCHS, SECRET = 3, 25, "interop-secret"


def echo(i, payload, epoch):
    return np.array([float(i + 1), float(payload[0]), float(epoch)])


def identity(i, payload, epoch):
    return payload


def stall(i, epoch):
    return 0.03 if i == 0 else 0.0


def _worker(package, address, ranks, tmp_path, work="echo",
            delay="stall"):
    auth = tmp_path / f"auth-{package}-{ranks}"
    auth.write_text(SECRET)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, TESTS, env.get("PYTHONPATH", "")])
    return subprocess.Popen(
        [sys.executable, "-m", f"{package}.worker", "--address", address,
         "--ranks", ranks, "--work", f"test_torch_interop:{work}",
         "--delay", f"test_torch_interop:{delay}",
         "--auth-file", str(auth)],
        cwd=TESTS, env=env)


def _kmap2(backend, pool_cls, amap, wall):
    """Fastest-1-of-n epochs with worker 0 slowed, then a full gather;
    every fresh echo is exact and names its worker and epoch."""
    pool = pool_cls(N)
    seen = set()
    for epoch in range(1, EPOCHS + 1):
        payload = np.array([np.pi * epoch])
        repochs = amap(pool, payload, backend, nwait=1, epoch=epoch)
        fresh = np.flatnonzero(repochs == epoch)
        assert fresh.size >= 1
        for i in fresh:
            r = np.asarray(pool.results[i])
            assert r.tolist() == [i + 1.0, np.pi * epoch, float(epoch)]
            seen.add(int(i))
    wall(pool, backend)
    recvbuf = np.zeros(3 * N)
    amap(pool, np.array([2.5]), backend, recvbuf, nwait=N,
         epoch=EPOCHS + 1)
    wall(pool, backend, recvbuf)
    assert recvbuf.reshape(N, 3).tolist() == [
        [i + 1.0, 2.5, EPOCHS + 1.0] for i in range(N)]
    return seen


def _serve(coordinator_cls, worker_packages, pool_cls, amap, wall,
           tmp_path):
    backend = coordinator_cls(None, N, spawn=False, accept=False,
                              address="tcp://127.0.0.1:0", auth=SECRET)
    procs = [_worker(pkg, backend.address, ranks, tmp_path)
             for pkg, ranks in worker_packages]
    try:
        backend.accept(timeout=60)
        return _kmap2(backend, pool_cls, amap, wall)
    finally:
        backend.shutdown()
        for p in procs:
            assert p.wait(timeout=30) == 0


def test_port_coordinator_serves_jax_workers(tmp_path):
    seen = _serve(NativeProcessBackend, [(JAX, "0-2")],
                  AsyncPool, asyncmap, waitall, tmp_path)
    assert seen  # at least one worker answered first somewhere


def test_jax_coordinator_serves_port_workers(tmp_path):
    from mpistragglers_jl_tpu import AsyncPool as JaxPool
    from mpistragglers_jl_tpu import asyncmap as jasyncmap
    from mpistragglers_jl_tpu import waitall as jwaitall

    seen = _serve(JaxNativeBackend, [(PORT, "0-2")],
                  JaxPool, jasyncmap, jwaitall, tmp_path)
    assert seen


def test_one_coordinator_serves_workers_of_both_packages(tmp_path):
    seen = _serve(NativeProcessBackend, [(PORT, "0"), (JAX, "1-2")],
                  AsyncPool, asyncmap, waitall, tmp_path)
    assert seen


@pytest.mark.parametrize("size", [8, 1 << 21])
@pytest.mark.parametrize("coordinator,worker", [
    (JaxNativeBackend, PORT), (NativeProcessBackend, JAX)],
    ids=["jax-coordinator", "port-coordinator"])
def test_payloads_round_trip_byte_exact_across_packages(
        tmp_path, coordinator, worker, size):
    """Raw array frames both ways over a Unix socket: socket frames,
    and at 2 MiB the coordinator's broadcast arena and the worker's
    result ring (shared memory). The worker returns its payload, and
    the coordinator harvests it byte for byte."""
    backend = coordinator(None, 1, spawn=False, accept=False,
                          auth=SECRET)
    proc = _worker(worker, backend.address, "0", tmp_path,
                   work="identity")
    try:
        backend.accept(timeout=60)
        payload = np.random.default_rng(size).integers(
            0, 256, size, dtype=np.uint8)
        for epoch in (1, 2):
            backend.begin_epoch(epoch)
            backend.dispatch(0, payload, epoch)
            got = backend.wait(0, timeout=60)
            backend.end_epoch()
            assert got.dtype == np.uint8
            assert got.tobytes() == payload.tobytes()
            del got
    finally:
        backend.shutdown()
        assert proc.wait(timeout=30) == 0
