"""Core pool on the OS-process backend — the reference's execution model.

The reference only ever runs as real OS processes under mpiexec
(test/runtests.jl:17); ProcessBackend reproduces that process isolation
(spawned workers, pickled payloads over pipes) while keeping assertions
coordinator-side instead of losing them inside subprocesses (SURVEY §4).
Everything here must be module-level picklable for spawn. The port's
copy of ``tests/test_pool_process.py``, with the process case of
``tests/test_reference_parity.py`` (kmap1 under real processes).
"""

import os

import numpy as np
import pytest

from mpistragglers_jl_tpu_torch import (
    AsyncPool,
    ProcessBackend,
    WorkerFailure,
    asyncmap,
    waitall,
)
from mpistragglers_jl_tpu_torch.backends.process import (
    RemoteWorkerError,
    WorkerProcessDied,
)


def _echo(i, payload, epoch):
    # the reference's result message layout [rank, t, epoch]
    # (test/kmap2.jl:92-94)
    return np.array([float(i + 1), float(payload[0]), float(epoch)])


def _fail_worker1_epoch2(i, payload, epoch):
    if i == 1 and epoch == 2:
        raise ValueError("boom from worker process")
    return np.array([float(i + 1), float(payload[0]), float(epoch)])


def _exit_worker2(i, payload, epoch):
    if i == 2:
        os._exit(3)  # simulate a crashed rank, not a Python exception
    return np.array([float(i + 1), float(payload[0]), float(epoch)])


class StragglerDelay:
    """Picklable deterministic delay: one slow worker, the rest fast."""

    def __init__(self, straggler: int, slow: float = 0.25, fast: float = 0.001):
        self.straggler = straggler
        self.slow = slow
        self.fast = fast

    def __call__(self, i: int, epoch: int) -> float:
        return self.slow if i == self.straggler else self.fast


@pytest.mark.slow
def test_full_gather_and_epoch_echo():
    n = 3
    backend = ProcessBackend(_echo, n)
    try:
        pool = AsyncPool(n)
        sendbuf = np.array([3.14])
        recvbuf = np.zeros(3 * n)
        for epoch in range(1, 4):
            sendbuf[0] = epoch
            repochs = asyncmap(pool, sendbuf, backend, recvbuf, nwait=n)
            chunks = recvbuf.reshape(n, 3)
            assert list(repochs) == [epoch] * n
            for i in range(n):
                assert chunks[i][0] == i + 1  # chunk j <- worker j
                assert chunks[i][1] == float(epoch)  # payload crossed intact
                assert chunks[i][2] == epoch  # epoch echo
    finally:
        backend.shutdown()
    # shutdown() joins and close()s EVERY Process handle; a closed
    # handle raising on inspection IS the deterministic-release signal
    for proc in backend._procs:
        with pytest.raises(ValueError):
            proc.is_alive()


@pytest.mark.slow
def test_fastest_k_skips_straggler_process():
    n = 3
    backend = ProcessBackend(_echo, n, delay_fn=StragglerDelay(2))
    try:
        pool = AsyncPool(n)
        sendbuf = np.zeros(1)
        for epoch in range(1, 5):
            sendbuf[0] = epoch
            repochs = asyncmap(pool, sendbuf, backend, nwait=2)
            fresh = int((repochs == epoch).sum())
            assert fresh >= 2
            assert repochs[0] == epoch and repochs[1] == epoch
        # straggler never made an epoch deadline but stays tasked
        assert pool.active[2]
        waitall(pool, backend)
        assert not pool.active.any()
    finally:
        backend.shutdown()


@pytest.mark.slow
def test_remote_exception_carries_traceback():
    n = 3
    backend = ProcessBackend(_fail_worker1_epoch2, n)
    try:
        pool = AsyncPool(n)
        payload = np.array([1.0])
        asyncmap(pool, payload, backend, nwait=n)  # epoch 1 fine
        with pytest.raises(WorkerFailure) as excinfo:
            asyncmap(pool, payload, backend, nwait=n)
            waitall(pool, backend)
        err = excinfo.value.error
        assert isinstance(err, RemoteWorkerError)
        assert err.exc_type == "ValueError"
        assert "boom from worker process" in str(err)
        assert "Traceback" in err.remote_traceback
        # pool stays recoverable: failed worker marked idle, others drain
        waitall(pool, backend)
    finally:
        backend.shutdown()


def _exit_on_negative(i, payload, epoch):
    if i == 1 and payload[0] < 0:
        os._exit(5)
    return np.array([float(i + 1), float(payload[0]), float(epoch)])


@pytest.mark.slow
def test_respawn_recovers_crashed_rank():
    """Elastic recovery on the pipe backend: dead rank replaced in place
    (the reference's dead ranks are permanent — SURVEY §5)."""
    n = 3
    backend = ProcessBackend(_exit_on_negative, n)
    try:
        pool = AsyncPool(n)
        with pytest.raises(WorkerFailure):
            asyncmap(pool, np.array([-1.0]), backend, nwait=n)
            waitall(pool, backend)
        waitall(pool, backend)
        assert backend._dead[1]
        with pytest.raises(RuntimeError):
            backend.respawn(0)  # alive rank: refuse
        backend.respawn(1)
        assert not backend._dead[1]
        for epoch in (10, 11):
            repochs = asyncmap(
                pool, np.array([float(epoch)]), backend,
                nwait=n, epoch=epoch,
            )
            assert list(repochs) == [epoch] * n
    finally:
        backend.shutdown()


@pytest.mark.slow
def test_dead_worker_process_fails_fast_not_hangs():
    # a crashed rank hangs the reference's Waitall! forever (SURVEY §5);
    # here the EOF on its pipe surfaces as WorkerFailure at harvest
    n = 3
    backend = ProcessBackend(_exit_worker2, n)
    try:
        pool = AsyncPool(n)
        with pytest.raises(WorkerFailure) as excinfo:
            asyncmap(pool, np.array([1.0]), backend, nwait=n)
            waitall(pool, backend)
        assert isinstance(excinfo.value.error, WorkerProcessDied)
        assert excinfo.value.error.worker == 2
    finally:
        backend.shutdown()


ROOT_PAYLOAD = 3.14


def _kmap1_worker(i, payload, epoch):
    # reference worker asserts it received 3.14 then sends its rank
    # (test/kmap1.jl:27-32); here a bad payload raises -> WorkerFailure
    assert payload[0] == pytest.approx(ROOT_PAYLOAD)
    return np.array([float(i + 1)])


@pytest.mark.slow
def test_kmap1_under_real_processes():
    """test/kmap1.jl:20-22 executed as the reference actually runs it —
    real OS processes (runtests.jl:17 spawns ranks via mpiexec)."""
    n = 3
    backend = ProcessBackend(_kmap1_worker, n)
    try:
        pool = AsyncPool(n)
        recvbuf = np.zeros(n)
        asyncmap(pool, np.array([ROOT_PAYLOAD]), backend, recvbuf, nwait=n)
        np.testing.assert_allclose(recvbuf, np.arange(1, n + 1))
    finally:
        backend.shutdown()
