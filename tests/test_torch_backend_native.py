"""Core pool on the native C++ transport backend.

Same behavioral checklist as the ProcessBackend suite (the reference's
mpiexec execution model, test/runtests.jl:17), but all coordinator-side
I/O runs in the native runtime: framed Unix-socket messaging, epoll
progress thread, native waitany (native/transport.cpp — the libmpi role,
SURVEY component C8). Also covers the raw transport layer directly.
Everything must be module-level picklable for spawn.
"""

import os

import numpy as np
import pytest

from mpistragglers_jl_tpu_torch import AsyncPool, WorkerFailure, asyncmap, waitall
from mpistragglers_jl_tpu_torch.backends.process import (
    RemoteWorkerError,
    WorkerProcessDied,
)
from mpistragglers_jl_tpu_torch.native import NativeBuildError

try:
    from mpistragglers_jl_tpu_torch.backends.native import NativeProcessBackend
    from mpistragglers_jl_tpu_torch.native import transport as T

    T.load_lib()
    _SKIP = None
except NativeBuildError as e:  # pragma: no cover - no compiler in env
    _SKIP = str(e)

pytestmark = pytest.mark.skipif(
    _SKIP is not None, reason=f"native transport unavailable: {_SKIP}"
)


def _echo(i, payload, epoch):
    # the reference's result message layout [rank, t, epoch]
    # (test/kmap2.jl:92-94)
    return np.array([float(i + 1), float(payload[0]), float(epoch)])


def _fail_worker1_epoch2(i, payload, epoch):
    if i == 1 and epoch == 2:
        raise ValueError("boom from native worker")
    return np.array([float(i + 1), float(payload[0]), float(epoch)])


def _exit_worker2(i, payload, epoch):
    if i == 2:
        os._exit(3)  # crashed rank, not a Python exception
    return np.array([float(i + 1), float(payload[0]), float(epoch)])


def _exit_on_negative(i, payload, epoch):
    if i == 1 and payload[0] < 0:
        os._exit(5)
    return np.array([float(i + 1), float(payload[0]), float(epoch)])


class StragglerDelay:
    def __init__(self, straggler: int, slow: float = 0.25, fast: float = 0.001):
        self.straggler = straggler
        self.slow = slow
        self.fast = fast

    def __call__(self, i: int, epoch: int) -> float:
        return self.slow if i == self.straggler else self.fast


# ---------------------------------------------------------------- transport


def _transport_pair(n):
    import tempfile
    import uuid

    path = os.path.join(
        tempfile.gettempdir(), f"msgt-test-{uuid.uuid4().hex[:8]}.sock"
    )
    return T.Coordinator(path, n), path


def test_transport_roundtrip_and_waitany():
    """Raw frames: isend -> worker recv -> worker send -> coord waitany."""
    import threading

    coord, path = _transport_pair(2)
    results = {}

    def worker(rank):
        w = T.Worker(path, rank)
        while True:
            msg = w.recv()
            if msg is None or msg.kind == T.KIND_CONTROL:
                break
            w.send(
                msg.payload + bytes([rank]), seq=msg.seq, epoch=msg.epoch
            )
        w.close()

    threads = [
        __import__("threading").Thread(target=worker, args=(r,), daemon=True)
        for r in range(2)
    ]
    for t in threads:
        t.start()
    try:
        coord.accept(timeout=10)
        assert coord.poll(0) is None  # nothing in flight yet
        coord.isend(0, b"abc", seq=7, epoch=3)
        coord.isend(1, b"xy", seq=8, epoch=3)
        for _ in range(2):
            rank, msg = coord.waitany([0, 1], timeout=10)
            results[rank] = msg
        assert results[0].payload == b"abc\x00"
        assert results[0].seq == 7 and results[0].epoch == 3
        assert results[1].payload == b"xy\x01"
        # waitany over an already-drained set times out rather than hangs
        assert coord.waitany([0, 1], timeout=0.05) is None
        for r in range(2):
            coord.isend(r, b"", kind=T.KIND_CONTROL)
        for t in threads:
            t.join(timeout=5)
    finally:
        coord.close()


def test_transport_large_payload():
    """Multi-MB frames exercise the partial-read/write state machine
    (payloads far exceed socket buffers)."""
    import threading

    coord, path = _transport_pair(1)

    def worker():
        w = T.Worker(path, 0)
        msg = w.recv()
        w.send(msg.payload[::-1], seq=msg.seq)
        w.recv()  # control
        w.close()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        coord.accept(timeout=10)
        blob = np.random.default_rng(0).bytes(8 * 1024 * 1024)
        coord.isend(0, blob, seq=1)
        rank, msg = coord.waitany([0], timeout=30)
        assert rank == 0 and msg.payload == blob[::-1]
        coord.isend(0, b"", kind=T.KIND_CONTROL)
        t.join(timeout=5)
    finally:
        coord.close()


def test_shm_region_pinned_by_live_view_survives_keep_window():
    """Regression: a worker that HOLDS a shm
    ``Message.body`` view across more than ``_shm_keep`` newer
    broadcasts must keep that region mapped and readable — eviction
    raises ``BufferError`` on the pinned mmap, defers to a later
    resolve, and catches up the moment the view is released. Before
    the keep-window hardening this was a use-after-unmap segfault
    scenario; the region dict must also stay bounded (keep + pinned),
    never growing with every broadcast."""
    import threading

    coord, path = _transport_pair(2)
    payloads = [
        np.full(1 << 20, i, np.uint8) for i in range(8)
    ]  # >= 1 MiB each: the shm broadcast path
    done = threading.Event()
    state: dict = {}

    def pinned_worker():
        w = T.Worker(path, 0)
        keep = w._shm_keep
        first = w.recv()
        assert first.body is not None, "broadcast did not ride shm"
        pinned = first.body  # LIVE view held across every broadcast
        for i in range(1, len(payloads)):
            msg = w.recv()
            assert msg.body is not None
            assert bytes(msg.body[:4]) == bytes([i] * 4)
            del msg
        # the pinned region is still mapped and byte-correct
        assert bytes(pinned[:4]) == b"\x00" * 4
        assert bytes(pinned[-4:]) == b"\x00" * 4
        # bounded: keep-window regions + the one pinned survivor
        state["n_regions_pinned"] = len(w._shm_regions)
        assert len(w._shm_regions) <= keep + 1
        del pinned, first
        # released: the next resolve sweeps the dict back to the window
        w.recv()
        state["n_regions_released"] = len(w._shm_regions)
        assert len(w._shm_regions) <= keep
        w.recv()  # control: done
        w.close()
        done.set()

    def drain_worker():
        # second rank only exists so the coordinator takes the shm
        # broadcast path (n_workers >= 2); it drains and exits
        w = T.Worker(path, 1)
        while True:
            msg = w.recv()
            if msg is None or msg.kind == T.KIND_CONTROL:
                break
        w.close()

    threads = [
        threading.Thread(target=pinned_worker, daemon=True),
        threading.Thread(target=drain_worker, daemon=True),
    ]
    for t in threads:
        t.start()
    try:
        coord.accept(timeout=10)
        for i, body in enumerate(payloads):
            pl = coord.payload(body)
            assert isinstance(pl, T.ShmPayload), "memfd unavailable?"
            for rank in range(2):
                assert coord.isend_shared(rank, b"hdr", pl, seq=i)
            pl.release()
        extra = coord.payload(payloads[0])
        assert coord.isend_shared(0, b"hdr", extra, seq=len(payloads))
        extra.release()
        for rank in range(2):
            coord.isend(rank, b"", kind=T.KIND_CONTROL)
        assert done.wait(timeout=30), "pinned worker did not finish"
        for t in threads:
            t.join(timeout=10)
        assert state["n_regions_pinned"] > state["n_regions_released"]
    finally:
        coord.close()


def test_transport_dead_peer_is_sticky():
    """A disconnected worker polls ready with a death marker forever —
    the anti-hang property the reference's Waitall! lacks (SURVEY §5).

    The connect runs in a thread: since the hello exchange became a
    round trip (auth ack), ``Worker()`` blocks until the coordinator's
    ``accept`` admits the rank, so constructing it on the accept thread
    would deadlock."""
    import threading

    coord, path = _transport_pair(1)
    connected = []

    def connect():
        connected.append(T.Worker(path, 0))

    t = threading.Thread(target=connect, daemon=True)
    t.start()
    try:
        coord.accept(timeout=10)
        t.join(timeout=10)
        connected[0].close()  # peer vanishes
        rank, msg = coord.waitany([0], timeout=10)
        assert rank == 0 and msg.kind == T.KIND_DEATH
        assert coord.is_dead(0)
        # sticky: polls keep reporting death, sends fail fast
        assert coord.poll(0).kind == T.KIND_DEATH
        assert not coord.isend(0, b"data")
    finally:
        coord.close()


# ------------------------------------------------------------------- pool


@pytest.mark.slow
def test_full_gather_and_epoch_echo():
    n = 3
    backend = NativeProcessBackend(_echo, n)
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
                assert chunks[i][1] == float(epoch)
                assert chunks[i][2] == epoch  # epoch echo
    finally:
        backend.shutdown()
    # shutdown() joins and close()s EVERY Process handle; a closed
    # handle raising on inspection IS the deterministic-release signal
    for proc in backend._procs:
        with pytest.raises(ValueError):
            proc.is_alive()


@pytest.mark.slow
def test_fastest_k_skips_straggler():
    n = 3
    backend = NativeProcessBackend(_echo, n, delay_fn=StragglerDelay(2))
    try:
        pool = AsyncPool(n)
        sendbuf = np.zeros(1)
        for epoch in range(1, 5):
            sendbuf[0] = epoch
            repochs = asyncmap(pool, sendbuf, backend, nwait=2)
            assert int((repochs == epoch).sum()) >= 2
            assert repochs[0] == epoch and repochs[1] == epoch
        assert pool.active[2]  # straggler still tasked
        waitall(pool, backend)
        assert not pool.active.any()
    finally:
        backend.shutdown()


@pytest.mark.slow
def test_remote_exception_carries_traceback():
    n = 3
    backend = NativeProcessBackend(_fail_worker1_epoch2, n)
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
        assert "boom from native worker" in str(err)
        assert "Traceback" in err.remote_traceback
        waitall(pool, backend)  # pool stays recoverable
    finally:
        backend.shutdown()


@pytest.mark.slow
def test_tcp_transport_pool_roundtrip():
    """The multi-host path: same pool, TCP loopback instead of a Unix
    socket (port 0 -> ephemeral, resolved via backend.address)."""
    n = 3
    backend = NativeProcessBackend(
        _echo, n, address="tcp://127.0.0.1:0"
    )
    try:
        assert backend.address.startswith("tcp://127.0.0.1:")
        assert not backend.address.endswith(":0")  # ephemeral resolved
        pool = AsyncPool(n)
        sendbuf = np.array([2.5])
        recvbuf = np.zeros(3 * n)
        repochs = asyncmap(pool, sendbuf, backend, recvbuf, nwait=n)
        assert list(repochs) == [1] * n
        chunks = recvbuf.reshape(n, 3)
        for i in range(n):
            assert chunks[i][0] == i + 1 and chunks[i][1] == 2.5
    finally:
        backend.shutdown()


def _spawn_cli_worker(address, rank):
    """Launch `python -m mpistragglers_jl_tpu_torch.worker` as a real external
    process — exactly what a remote host would run."""
    import subprocess
    import sys

    tests_dir = os.path.dirname(os.path.abspath(__file__))
    repo_root = os.path.dirname(tests_dir)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo_root, tests_dir, env.get("PYTHONPATH", "")]
    )
    return subprocess.Popen(
        [
            sys.executable, "-m", "mpistragglers_jl_tpu_torch.worker",
            "--address", address, "--rank", str(rank),
            "--work", "test_torch_backend_native:_echo",
        ],
        cwd=tests_dir,
        env=env,
    )


@pytest.mark.slow
def test_external_workers_over_cli():
    """spawn=False + `python -m mpistragglers_jl_tpu_torch.worker`: the
    multi-host deployment model (coordinator binds TCP, workers join
    from outside; the reference's analog is mpiexec + a hostfile).
    accept=False defers the handshake so the ephemeral port is known
    before the workers launch — no hard-coded port to collide on."""
    n = 2
    backend = NativeProcessBackend(
        None, n, spawn=False, address="tcp://127.0.0.1:0", accept=False,
    )
    procs = [_spawn_cli_worker(backend.address, r) for r in range(n)]
    backend.accept(timeout=60)
    try:
        pool = AsyncPool(n)
        repochs = asyncmap(pool, np.array([7.0]), backend, nwait=n)
        assert list(repochs) == [1] * n
        for i in range(n):
            out = np.asarray(pool.results[i])
            assert out[0] == i + 1 and out[1] == 7.0 and out[2] == 1
    finally:
        backend.shutdown()
        for p in procs:
            p.wait(timeout=10)


@pytest.mark.slow
def test_direct_dispatch_snapshots_despite_mutation():
    """Direct Backend-API use (no begin_epoch): every dispatch must
    snapshot the payload at call time — in-place mutation between two
    same-epoch dispatches must not leak cached bytes."""
    backend = NativeProcessBackend(_echo, 2)
    try:
        buf = np.array([1.0])
        backend.dispatch(0, buf, 1)
        buf[0] = 2.0  # mutate before the second same-epoch dispatch
        backend.dispatch(1, buf, 1)
        r0 = backend.wait(0, timeout=30)
        r1 = backend.wait(1, timeout=30)
        assert np.asarray(r0)[1] == 1.0  # worker 0 saw pre-mutation value
        assert np.asarray(r1)[1] == 2.0  # worker 1 saw the mutation
    finally:
        backend.shutdown()


@pytest.mark.slow
def test_direct_dispatch_after_asyncmap_snapshots_mutation():
    """The cache armed inside asyncmap must be disarmed when it returns:
    a manual dispatch at the SAME epoch with a mutated buffer sees the
    new bytes (end_epoch hook)."""
    backend = NativeProcessBackend(_echo, 2)
    try:
        pool = AsyncPool(2)
        buf = np.array([1.0])
        asyncmap(pool, buf, backend, nwait=2)
        buf[0] = 99.0
        backend.dispatch(0, buf, pool.epoch)  # manual re-task, same epoch
        r0 = backend.wait(0, timeout=30)
        assert np.asarray(r0)[1] == 99.0
    finally:
        backend.shutdown()


def test_dispatch_before_accept_raises_not_hangs():
    backend = NativeProcessBackend(
        None, 1, spawn=False, address="tcp://127.0.0.1:0", accept=False
    )
    try:
        with pytest.raises(RuntimeError, match="handshake incomplete"):
            backend.dispatch(0, np.zeros(1), 1)
        with pytest.raises(RuntimeError, match="handshake incomplete"):
            backend.wait_any([0])
    finally:
        backend.shutdown()


def test_malformed_tcp_address_fails_at_create():
    # "tcp://host:5O55" (letter O) must be a bind error NOW, not a unix
    # path or a silent ephemeral port + connect timeout later
    for bad in ("tcp://127.0.0.1:5O55", "tcp://127.0.0.1", "tcp://:123"):
        with pytest.raises(T.TransportError, match="could not bind"):
            T.Coordinator(bad, 1)


def _raise_on_unpickle():
    raise RuntimeError("boom on unpickle")


class ExplodingPayload:
    """Pickles fine on the coordinator, raises when the worker loads it
    — the shape of the classic multi-host serialization mismatch."""

    def __reduce__(self):
        return (_raise_on_unpickle, ())


def test_undeserializable_payload_ships_error_not_dead_worker():
    """A payload that cannot unpickle in the worker must come back as a
    WorkerFailure with the real exception, not a dead rank."""
    backend = NativeProcessBackend(_echo, 1)
    try:
        pool = AsyncPool(1)
        with pytest.raises(WorkerFailure) as excinfo:
            asyncmap(pool, ExplodingPayload(), backend, nwait=1)
        err = excinfo.value.error
        assert isinstance(err, RemoteWorkerError)
        assert err.exc_type == "RuntimeError"
        assert "boom on unpickle" in str(err)
        # the rank survived: next epoch with a good payload works
        repochs = asyncmap(pool, np.array([1.0]), backend, nwait=1, epoch=5)
        assert list(repochs) == [5]
    finally:
        backend.shutdown()


@pytest.mark.slow
def test_asyncmap_timeout_over_native_transport():
    from mpistragglers_jl_tpu_torch import DeadWorkerError

    n = 2
    backend = NativeProcessBackend(
        _echo, n, delay_fn=StragglerDelay(1, slow=0.8)
    )
    try:
        pool = AsyncPool(n)
        with pytest.raises(DeadWorkerError) as excinfo:
            asyncmap(pool, np.zeros(1), backend, nwait=n, timeout=0.2)
        # worker 0's first round-trip may also miss the window on a
        # loaded machine; only the straggler is guaranteed outstanding
        assert 1 in excinfo.value.dead
        waitall(pool, backend)  # drains the tardy worker(s); pool reusable
        repochs = asyncmap(pool, np.zeros(1), backend, nwait=1)
        assert int((repochs == pool.epoch).sum()) >= 1
        waitall(pool, backend)
    finally:
        backend.shutdown()


@pytest.mark.slow
def test_rapid_fire_epochs_over_native_transport():
    """100 back-to-back epochs with mixed nwait forms shake out protocol
    races (seq guards, drain/dispatch interleaving) on the C++ path."""
    n = 3
    backend = NativeProcessBackend(_echo, n)
    try:
        pool = AsyncPool(n)
        sendbuf = np.zeros(1)
        for epoch in range(1, 101):
            sendbuf[0] = epoch
            nwait = (epoch % n) + 1  # cycles 1..n
            repochs = asyncmap(pool, sendbuf, backend, nwait=nwait)
            assert int((repochs == epoch).sum()) >= nwait
            for i in range(n):  # echo integrity on every heard worker
                if pool.results[i] is not None:
                    assert np.asarray(pool.results[i])[2] == repochs[i]
        waitall(pool, backend)
        assert not pool.active.any()
    finally:
        backend.shutdown()


@pytest.mark.slow
def test_backend_lifecycle_does_not_leak_fds():
    """Create/drive/shutdown many native backends: the process fd count
    must come back down (sockets, epoll, eventfd all released)."""
    import gc

    def nfds():
        return len(os.listdir("/proc/self/fd"))

    def cycle():
        b = NativeProcessBackend(_echo, 2)
        try:
            pool = AsyncPool(2)
            asyncmap(pool, np.zeros(1), b, nwait=2)
            waitall(pool, b)
        finally:
            b.shutdown()

    cycle()  # warm up one-time module/library fds before sampling
    gc.collect()
    base = nfds()
    for _ in range(10):
        cycle()
    gc.collect()
    assert nfds() <= base + 3, (
        f"fd count grew {base} -> {nfds()}: transport leaking descriptors"
    )


def test_resolve_callable():
    from mpistragglers_jl_tpu_torch.worker import resolve_callable

    fn = resolve_callable("numpy:linalg.norm")
    assert fn is np.linalg.norm
    with pytest.raises(ValueError, match="module:attribute"):
        resolve_callable("numpy.linalg.norm")
    with pytest.raises(TypeError, match="non-callable"):
        resolve_callable("numpy:pi")


def test_parse_ranks():
    from mpistragglers_jl_tpu_torch.worker import parse_ranks

    assert parse_ranks("3") == [3]
    assert parse_ranks("0-3") == [0, 1, 2, 3]
    assert parse_ranks("0,2,5-7") == [0, 2, 5, 6, 7]
    with pytest.raises(ValueError, match="descending"):
        parse_ranks("5-2")
    with pytest.raises(ValueError, match="duplicate"):
        parse_ranks("1,1")


@pytest.mark.slow
def test_cli_serves_multiple_ranks_one_command():
    """One `-m ...worker --ranks 0-1` process serves both ranks (the
    one-command-per-host deployment shape)."""
    import subprocess
    import sys

    tests_dir = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(tests_dir), tests_dir, env.get("PYTHONPATH", "")]
    )
    backend = NativeProcessBackend(
        None, 2, spawn=False, address="tcp://127.0.0.1:0", accept=False
    )
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "mpistragglers_jl_tpu_torch.worker",
            "--address", backend.address, "--ranks", "0-1",
            "--work", "test_torch_backend_native:_echo",
        ],
        cwd=tests_dir, env=env,
    )
    try:
        backend.accept(timeout=60)
        pool = AsyncPool(2)
        repochs = asyncmap(pool, np.array([4.0]), backend, nwait=2)
        assert list(repochs) == [1, 1]
        for i in range(2):
            out = np.asarray(pool.results[i])
            assert out[0] == i + 1 and out[1] == 4.0
    finally:
        backend.shutdown()
        proc.wait(timeout=15)


@pytest.mark.slow
def test_respawn_recovers_crashed_rank():
    """Elastic recovery: a crashed rank is replaced in place and the
    pool keeps the same index space (new capability over the reference,
    whose dead ranks are permanent — SURVEY §5)."""
    n = 3
    backend = NativeProcessBackend(_exit_on_negative, n)
    try:
        pool = AsyncPool(n)
        with pytest.raises(WorkerFailure):
            asyncmap(pool, np.array([-1.0]), backend, nwait=n)
            waitall(pool, backend)
        waitall(pool, backend)  # drain survivors
        # EOF is observed before the child is reapable; join to avoid
        # racing the OS-level process teardown
        backend._procs[1].join(timeout=10)
        assert not backend._procs[1].is_alive()
        with pytest.raises(RuntimeError):
            backend.respawn(0)  # alive rank: refuse
        backend.respawn(1)
        for epoch in (10, 11):
            repochs = asyncmap(
                pool, np.array([float(epoch)]), backend,
                nwait=n, epoch=epoch,
            )
            assert list(repochs) == [epoch] * n
        assert np.asarray(pool.results[1])[0] == 2.0  # new incarnation works
    finally:
        backend.shutdown()


@pytest.mark.slow
def test_use_after_shutdown_raises_not_segfaults():
    backend = NativeProcessBackend(_echo, 2)
    pool = AsyncPool(2)
    asyncmap(pool, np.array([1.0]), backend, nwait=2)
    backend.shutdown()
    with pytest.raises(RuntimeError):
        backend.dispatch(0, np.array([2.0]), 2)
    with pytest.raises(RuntimeError):
        backend.test(0)
    with pytest.raises(RuntimeError):
        backend.wait_any([0, 1])
    backend.shutdown()  # idempotent


@pytest.mark.slow
def test_dead_worker_fails_fast_not_hangs():
    n = 3
    backend = NativeProcessBackend(_exit_worker2, n)
    try:
        pool = AsyncPool(n)
        with pytest.raises(WorkerFailure) as excinfo:
            asyncmap(pool, np.array([1.0]), backend, nwait=n)
            waitall(pool, backend)
        assert isinstance(excinfo.value.error, WorkerProcessDied)
        assert excinfo.value.error.worker == 2
        # re-dispatch to the dead rank fails fast too (synthetic failure)
        with pytest.raises(WorkerFailure):
            asyncmap(pool, np.array([2.0]), backend, nwait=n)
            waitall(pool, backend)
    finally:
        backend.shutdown()


# ------------------------------------------------------------------- auth


def test_hmac_conformance_against_stdlib():
    """The native HMAC-SHA256 the handshake trusts must match RFC 2104
    (checked against the stdlib implementation, including the >64-byte
    key-hashing path)."""
    import hashlib
    import hmac as stdlib_hmac

    for key, msg in [
        (b"key", b"The quick brown fox jumps over the lazy dog"),
        (b"", b""),
        (b"k" * 100, b"m" * 1000),  # key longer than the SHA-256 block
        (b"secret", bytes(range(256)) * 3),
    ]:
        want = stdlib_hmac.new(key, msg, hashlib.sha256).digest()
        assert T.hmac_sha256(key, msg) == want


def test_auth_token_roundtrip():
    """Workers holding the shared secret are admitted and serve."""
    import tempfile
    import threading
    import uuid

    path = os.path.join(
        tempfile.gettempdir(), f"msgt-auth-{uuid.uuid4().hex[:8]}.sock"
    )
    coord = T.Coordinator(path, 2, token=b"s3cret")

    def worker(rank):
        w = T.Worker(path, rank, token=b"s3cret")
        msg = w.recv()
        if msg is not None and msg.kind == T.KIND_DATA:
            w.send(msg.payload + bytes([rank]), seq=msg.seq)
            w.recv()  # control
        w.close()

    threads = [
        __import__("threading").Thread(target=worker, args=(r,), daemon=True)
        for r in range(2)
    ]
    for t in threads:
        t.start()
    try:
        coord.accept(timeout=10)
        coord.isend(0, b"a", seq=1)
        coord.isend(1, b"b", seq=1)
        got = {}
        for _ in range(2):
            rank, msg = coord.waitany([0, 1], timeout=10)
            got[rank] = msg.payload
        assert got == {0: b"a\x00", 1: b"b\x01"}
        for r in range(2):
            coord.isend(r, b"", kind=T.KIND_CONTROL)
        for t in threads:
            t.join(timeout=5)
    finally:
        coord.close()


def test_auth_rejects_wrong_and_missing_token():
    """A connector without the right secret is refused: its connect
    fails, and the coordinator handshake never admits it."""
    import tempfile
    import threading
    import uuid

    path = os.path.join(
        tempfile.gettempdir(), f"msgt-auth-{uuid.uuid4().hex[:8]}.sock"
    )
    coord = T.Coordinator(path, 1, token=b"right")
    outcomes = []

    def bad_worker(token):
        try:
            w = T.Worker(path, 0, token=token)
        except T.TransportError:
            # no token: can't answer the challenge, fails at connect.
            # wrong token: the MUTUAL handshake also fails at
            # connect — the coordinator rejects the worker's proof and
            # closes before sending its own, so the worker never
            # receives the coordinator proof it now requires
            outcomes.append("refused-at-connect")
            return
        outcomes.append("admitted")  # must not happen
        w.close()

    threads = [
        threading.Thread(target=bad_worker, args=(tok,), daemon=True)
        for tok in (b"wrong", b"")
    ]
    for t in threads:
        t.start()
    try:
        with pytest.raises(T.TransportError):
            coord.accept(timeout=1.0)  # no impostor is ever admitted
        for t in threads:
            t.join(timeout=10)
        assert outcomes == ["refused-at-connect", "refused-at-connect"]
    finally:
        coord.close()


def test_worker_rejects_rogue_coordinator():
    """the handshake is mutual. A rogue listener
    that wins the bind race and ISSUES a well-formed challenge — the
    exact scenario one-way auth waved through — must be rejected by
    the worker, because it cannot produce HMAC(token, 0x02||W) for the
    worker's own challenge W. The worker must fail at connect and
    never enter the data phase (where frames get unpickled)."""
    import socket
    import struct
    import tempfile
    import threading
    import uuid

    path = os.path.join(
        tempfile.gettempdir(), f"msgt-rogue-{uuid.uuid4().hex[:8]}.sock"
    )
    HDR = struct.Struct("<5q")  # len, seq, epoch, tag, kind (KIND_HELLO=2)
    saw = {}
    bound = threading.Event()

    def rogue():
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(path)
        srv.listen(1)
        srv.settimeout(10)
        bound.set()
        conn, _ = srv.accept()
        conn.settimeout(10)
        try:
            def recv_exact(n):
                # NOT recv(MSG_WAITALL): under load it has been seen
                # returning short on a socket with a timeout, leaking
                # the response's tail into the post-handshake read and
                # failing the no-data assertion below for the wrong
                # reason
                buf = b""
                while len(buf) < n:
                    chunk = conn.recv(n - len(buf))
                    if not chunk:
                        break
                    buf += chunk
                return buf

            hello = recv_exact(HDR.size)
            saw["hello"] = HDR.unpack(hello)
            # issue a perfectly-formed 16-byte challenge like a real
            # coordinator would
            conn.sendall(HDR.pack(16, 0, 0, 0, 2) + b"C" * 16)
            # the worker answers mac(32) + its challenge W(16)
            resp = recv_exact(HDR.size + 48)
            saw["resp_len"] = HDR.unpack(resp[: HDR.size])[0]
            # ...but we don't know the token: send a garbage proof
            conn.sendall(HDR.pack(32, 0, 0, 0, 2) + b"X" * 32)
            # if the worker were fooled it would proceed to the data
            # phase; give it a beat, then see if it sent anything more
            conn.settimeout(1.0)
            try:
                saw["post"] = conn.recv(4096)
            except socket.timeout:
                saw["post"] = b""
        finally:
            conn.close()
            srv.close()

    t = threading.Thread(target=rogue, daemon=True)
    t.start()
    assert bound.wait(timeout=10)
    with pytest.raises(T.TransportError):
        T.Worker(path, 0, token=b"s3cret")
    t.join(timeout=15)
    assert saw["hello"][4] == 2  # worker sent a hello
    assert saw["resp_len"] == 48  # mac + worker challenge: mutual form
    assert saw.get("post", b"") == b""  # no data ever followed


@pytest.mark.slow
def test_spawned_backend_auto_auth_end_to_end():
    """spawn=True generates a per-backend secret automatically; the
    spawned workers inherit it and the pool works unchanged."""
    backend = NativeProcessBackend(_echo, 2)
    try:
        assert backend._token  # auto-generated, non-empty
        pool = AsyncPool(2)
        asyncmap(pool, np.array([5.0]), backend, nwait=2)
        assert np.asarray(pool.results[0])[1] == 5.0
    finally:
        backend.shutdown()


def test_concurrent_restarts_park_other_ranks_hello():
    """Two external workers restarting at once must both be recoverable:
    rank B's reconnect landing during reaccept(A) is parked, not closed,
    and reaccept(B) adopts the parked socket."""
    import tempfile
    import threading
    import time as time_mod
    import uuid

    path = os.path.join(
        tempfile.gettempdir(), f"msgt-park-{uuid.uuid4().hex[:8]}.sock"
    )
    coord = T.Coordinator(path, 2, token=b"tok")

    class EchoThread(threading.Thread):
        def __init__(self, rank, die_after: int):
            super().__init__(daemon=True)
            self.rank, self.die_after = rank, die_after

        def run(self):
            w = T.Worker(path, self.rank, token=b"tok")
            served = 0
            while True:
                msg = w.recv()
                if msg is None or msg.kind == T.KIND_CONTROL:
                    break
                w.send(msg.payload, seq=msg.seq, epoch=msg.epoch)
                served += 1
                if self.die_after and served >= self.die_after:
                    break  # simulated crash: close without shutdown
            w.close()

    gen1 = [EchoThread(r, die_after=1) for r in range(2)]
    for t in gen1:
        t.start()
    try:
        coord.accept(timeout=10)
        for r in range(2):
            coord.isend(r, b"x", seq=1)
        for _ in range(2):
            coord.waitany([0, 1], timeout=10)
        for t in gen1:
            t.join(timeout=5)
        # both ranks are now dead; wait for the progress engine's marks
        deadline = time_mod.time() + 5
        while not (coord.is_dead(0) and coord.is_dead(1)):
            assert time_mod.time() < deadline, "death marks never arrived"
            time_mod.sleep(0.01)
        # drain the death markers
        while coord.poll(0) and coord.poll(0).kind != T.KIND_DEATH:
            pass
        while coord.poll(1) and coord.poll(1).kind != T.KIND_DEATH:
            pass
        # both restart concurrently; their hellos race into the backlog
        gen2 = [EchoThread(r, die_after=0) for r in range(2)]
        for t in gen2:
            t.start()
        time_mod.sleep(0.2)  # let both connects land before reaccept
        coord.reaccept(0, timeout=10)  # may park rank 1's hello
        coord.reaccept(1, timeout=10)  # adopts the parked socket
        for r in range(2):
            assert not coord.is_dead(r)
            coord.isend(r, bytes([r]), seq=2)
        got = {}
        for _ in range(2):
            rank, msg = coord.waitany([0, 1], timeout=10)
            got[rank] = msg.payload
        assert got == {0: b"\x00", 1: b"\x01"}
        for r in range(2):
            coord.isend(r, b"", kind=T.KIND_CONTROL)
        for t in gen2:
            t.join(timeout=5)
    finally:
        coord.close()


def test_worker_connect_retries_until_coordinator_binds():
    """run_worker's connect loop retries: a worker started before the
    coordinator binds still joins (one dropped/early
    handshake must not permanently lose the rank)."""
    import tempfile
    import threading
    import time as time_mod
    import uuid

    from mpistragglers_jl_tpu_torch.worker import run_worker

    path = os.path.join(
        tempfile.gettempdir(), f"msgt-retry-{uuid.uuid4().hex[:8]}.sock"
    )

    def serve():
        run_worker(path, 0, lambda r, p, e: p + 1, connect_timeout=10)

    t = threading.Thread(target=serve, daemon=True)
    t.start()  # connects BEFORE the coordinator exists
    time_mod.sleep(0.3)
    backend = NativeProcessBackend(
        None, 1, spawn=False, address=path, connect_timeout=10
    )
    try:
        pool = AsyncPool(1)
        asyncmap(pool, 41, backend, nwait=1)
        assert pool.results[0] == 42
    finally:
        backend.shutdown()
        t.join(timeout=5)


def test_shutdown_fast_when_handshake_never_completed():
    """shutdown() with accept=False terminates spawned workers
    immediately instead of burning join_timeout per worker
   ."""
    import time as time_mod

    backend = NativeProcessBackend(
        _echo, 3, accept=False, join_timeout=5.0
    )
    t0 = time_mod.perf_counter()
    backend.shutdown()
    elapsed = time_mod.perf_counter() - t0
    assert elapsed < 4.0, f"shutdown took {elapsed:.1f}s (join-timeout stall)"


def test_token_holding_worker_refuses_open_coordinator():
    """Fail closed against a downgrade: a worker configured with a
    secret must refuse a peer that acks the hello as an *open*
    transport — the connect-retry loop makes the bind race winnable by
    a rogue listener, and unpickling its frames would be code
    execution."""
    import threading

    coord, path = _transport_pair(1)  # open: no token
    outcome = []

    def connect():
        try:
            T.Worker(path, 0, token=b"must-be-authenticated")
        except T.TransportError:
            outcome.append("refused")
        else:  # pragma: no cover - the failure this test exists to catch
            outcome.append("downgraded")

    t = threading.Thread(target=connect, daemon=True)
    t.start()
    try:
        # the open coordinator may briefly admit the rank before the
        # worker walks away (the refusal is worker-side, by design);
        # either way no authenticated session ever exists
        try:
            coord.accept(timeout=1.0)
        except T.TransportError:
            pass
        t.join(timeout=10)
        assert outcome == ["refused"]
    finally:
        coord.close()


def _tagged_sleep_echo(i, payload, epoch):
    import time as time_mod

    time_mod.sleep(float(payload[1]))
    return float(payload[0])


def test_native_wait_any_duplicate_index_two_tags():
    """wait_any([i, i], tags=[a, b]) must honor BOTH channels of one
    worker (SlotBackend does; the native router must too)."""
    backend = NativeProcessBackend(_tagged_sleep_echo, 1)
    try:
        backend.dispatch(0, np.array([10.0, 0.3]), 1, tag=0)
        backend.dispatch(0, np.array([20.0, 0.0]), 1, tag=1)
        got = {}
        for _ in range(2):
            j, result = backend.wait_any([0, 0], timeout=15, tags=[0, 1])
            assert j == 0
            got[float(result)] = True
        assert sorted(got) == [10.0, 20.0]
    finally:
        backend.shutdown()


@pytest.mark.slow
def test_on_dead_straggle_spawned_workers():
    """on_dead="straggle": a crashed spawned worker becomes an infinite
    straggler — fastest-k epochs keep making progress with NO error
    raised, and respawn + pool.reset_worker rejoins the rank."""
    n = 3
    backend = NativeProcessBackend(
        _exit_on_negative, n, on_dead="straggle"
    )
    try:
        pool = AsyncPool(n)
        sendbuf = np.array([1.0])
        asyncmap(pool, sendbuf, backend, nwait=n)
        # worker 1 self-destructs on the negative payload
        sendbuf[0] = -1.0
        asyncmap(pool, sendbuf, backend, nwait=2, epoch=2)
        assert sorted(pool.fresh_indices(2).tolist()) == [0, 2]
        # subsequent epochs: no failures, survivors answer, rank 1 stays
        # an in-flight straggler
        sendbuf[0] = 3.0
        for ep in (3, 4):
            repochs = asyncmap(pool, sendbuf, backend, nwait=2, epoch=ep)
            assert sorted(pool.fresh_indices(ep).tolist()) == [0, 2]
            assert repochs[1] != ep
        assert pool.active[1]
        # a bounded waitall times out naming the dead rank, not hanging
        from mpistragglers_jl_tpu_torch.pool import DeadWorkerError

        with pytest.raises(DeadWorkerError):
            waitall(pool, backend, timeout=1.0)
        # elastic recovery: respawn + reset, the rank rejoins fully
        backend.respawn(1)
        pool.reset_worker(1)  # the lost dispatch can never complete
        asyncmap(pool, sendbuf, backend, nwait=n, epoch=5)
        assert sorted(pool.fresh_indices(5).tolist()) == [0, 1, 2]
        waitall(pool, backend, timeout=10.0)
    finally:
        backend.shutdown()


def test_native_cross_process_telemetry_aggregation():
    """registry= on the native backend: worker.py's loop (run by the
    spawned processes) piggybacks telemetry frames on the reserved OBS
    tag; the coordinator merges them under worker= labels with
    clock-aligned per-task spans, and the frames never disturb the
    pool's completions (every epoch still harvests normally)."""
    from mpistragglers_jl_tpu_torch.obs import MetricsRegistry

    reg = MetricsRegistry()
    backend = NativeProcessBackend(_echo, 2, registry=reg)
    try:
        pool = AsyncPool(2)
        for _ in range(3):
            asyncmap(pool, np.ones(3), backend, nwait=2)
        waitall(pool, backend)
    finally:
        backend.shutdown()
    for r in range(2):
        c = reg.counter("worker_tasks_total", worker=str(r))
        assert c.value == 3
        h = reg.histogram("worker_task_seconds", worker=str(r))
        assert h.count == 3
    recs = backend.aggregator.recorders()
    assert [r.process for r in recs] == ["worker 0", "worker 1"]
    assert all(len(r.spans) == 3 for r in recs)
    # clock offset estimated from the send/recv stamp pairs (same
    # host: perf_counter is system-wide monotonic, so it is tiny)
    off = backend.aggregator.clock_offset(0)
    assert off is not None and abs(off) < 0.5
