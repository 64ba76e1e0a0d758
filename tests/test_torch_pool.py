"""The port's pool (mpistragglers_jl_tpu_torch/pool.py) and its CUDA
stream backend (backends/cuda.py) on the CPU, against the contracts of
the JAX package's tests/test_reference_parity.py (the reference's kmap1
and kmap2 scenarios) and tests/test_backend_xla.py (the device-backend
checklist).

The pool contracts run over the port's ``LocalBackend`` and over
``CUDADeviceBackend(devices=[cpu])``, where work runs synchronously in
the dispatcher threads. Which workers arrive late is decided by gates
(``threading.Event``s the test opens), never by racing sleeps: only the
reference's seeded sleeps remain, in scenarios whose assertions hold in
any arrival order. One schedule runs through both packages' pools and
must give identical ``repochs`` and ``recvbuf`` bytes.
"""

import threading

import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu import AsyncPool as RefPool
from mpistragglers_jl_tpu import LocalBackend as RefLocal
from mpistragglers_jl_tpu import asyncmap as ref_asyncmap
from mpistragglers_jl_tpu import waitall as ref_waitall
from mpistragglers_jl_tpu_torch import (
    AsyncPool,
    CUDADeviceBackend,
    LocalBackend,
    WorkerFailure,
    asyncmap,
    waitall,
)

CPU = torch.device("cpu")
ROOT_PAYLOAD = 3.14
GATE_S = 30.0  # a gate that never opens fails the test, it does not hang


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _local(work, n, **kw):
    return LocalBackend(work, n, **kw)


def _cuda_cpu(work, n, **kw):
    return CUDADeviceBackend(work, n, devices=[CPU], **kw)


BACKENDS = {"local": _local, "cuda_on_cpu": _cuda_cpu}


def _vec(payload, values):
    """A result of the payload's kind: a tensor for a tensor payload (the
    CUDA backend's), an ndarray otherwise."""
    if isinstance(payload, torch.Tensor):
        return torch.tensor(values, dtype=torch.float64)
    return np.array(values, dtype=np.float64)


def _kmap1_worker(i, payload, epoch):
    # reference worker asserts it received 3.14 then sends its rank
    # (test/kmap1.jl:27-32); a bad payload raises -> WorkerFailure
    assert float(payload[0]) == pytest.approx(ROOT_PAYLOAD)
    return _vec(payload, [float(i + 1)])


class _Kmap2Worker:
    """The reference worker loop body (test/kmap2.jl:76-99): echo
    ``[rank, t, epoch]`` where ``t`` counts tasks this worker ran."""

    def __init__(self):
        self.t = {}

    def __call__(self, i, payload, epoch):
        self.t[i] = self.t.get(i, 0) + 1
        return _vec(payload, [float(i + 1), float(self.t[i]),
                              float(payload[0])])


class _SeededSleep:
    """Deterministic stand-in for ``sleep(max(rand()/10, 0.005))``
    (test/kmap2.jl:95), scaled down 10x."""

    def __init__(self, seed=0, lo=0.0005, hi=0.005):
        self.rng = np.random.default_rng(seed)
        self.lo, self.hi = lo, hi

    def __call__(self, i, epoch):
        return max(float(self.rng.uniform(0, self.hi)), self.lo)


class _Gates:
    """Worker ``i`` at epoch ``e`` waits for gate ``(i, e)`` if the test
    closed it: the test decides who is late."""

    def __init__(self, closed=()):
        self.gates = {key: threading.Event() for key in closed}

    def wait(self, i, epoch):
        gate = self.gates.get((i, epoch))
        if gate is not None and not gate.wait(GATE_S):
            raise TimeoutError(f"gate {(i, epoch)} never opened")

    def open(self, i, epoch):
        self.gates[(i, epoch)].set()


class _GatedEcho:
    """Echo ``[i, payload[0]]`` after the worker's gate opens."""

    def __init__(self, gates):
        self.gates = gates

    def __call__(self, i, payload, epoch):
        self.gates.wait(i, epoch)
        return _vec(payload, [float(i), float(payload[0])])


@pytest.mark.parametrize("make", BACKENDS.values(), ids=BACKENDS)
def test_kmap1_full_gather_each_chunk_from_its_worker(make):
    """test/kmap1.jl:20-22 at n=3: nwait=n full gather, recvbuf ==
    [1..n] — chunk j came from worker j."""
    n = 3
    backend = make(_kmap1_worker, n)
    try:
        pool = AsyncPool(n)
        recvbuf = np.zeros(n)
        repochs = asyncmap(pool, np.array([ROOT_PAYLOAD]), backend,
                           recvbuf, nwait=n)
        np.testing.assert_allclose(recvbuf, np.arange(1, n + 1))
        assert list(repochs) == [1] * n
    finally:
        backend.shutdown()


@pytest.mark.parametrize("make", BACKENDS.values(), ids=BACKENDS)
@pytest.mark.parametrize("n", [3, 10])
def test_kmap2_fastest_k_100_epochs_with_echo_integrity(make, n):
    """test/kmap2.jl:32-54: 100 epochs at nwait=2, every epoch yields >= 2
    fresh responses, and every heard-from worker's echoed epoch equals
    repochs[i] (in any arrival order)."""
    backend = make(_Kmap2Worker(), n, delay_fn=_SeededSleep(seed=n))
    try:
        pool = AsyncPool(n)
        sendbuf = np.zeros(1)
        recvbuf = np.zeros(3 * n)
        for epoch in range(1, 101):
            sendbuf[0] = epoch
            repochs = asyncmap(pool, sendbuf, backend, recvbuf, nwait=2)
            chunks = recvbuf.reshape(n, 3)
            fresh = 0
            for i in range(n):
                if repochs[i] == 0:
                    continue  # never heard from worker i (kmap2.jl:42-44)
                fresh += repochs[i] == epoch
                assert chunks[i][2] == repochs[i]  # kmap2.jl:50
            assert fresh >= 2  # kmap2.jl:53
        waitall(pool, backend)
        assert not pool.active.any()
    finally:
        backend.shutdown()


@pytest.mark.parametrize("make", BACKENDS.values(), ids=BACKENDS)
def test_kmap2_waitall_quiesces_100_epochs(make):
    """test/kmap2.jl:57-61: 100 rounds of asyncmap(nwait=1) + waitall;
    all workers inactive after every waitall."""
    n = 3
    backend = make(_Kmap2Worker(), n, delay_fn=_SeededSleep(seed=7))
    try:
        pool = AsyncPool(n)
        sendbuf = np.zeros(1)
        for epoch in range(1, 101):
            sendbuf[0] = epoch
            asyncmap(pool, sendbuf, backend, nwait=1)
            waitall(pool, backend)
            assert not pool.active.any()  # kmap2.jl:60
    finally:
        backend.shutdown()


@pytest.mark.parametrize("make", BACKENDS.values(), ids=BACKENDS)
def test_kmap2_functional_nwait_waits_for_worker_1(make):
    """test/kmap2.jl:63-72: nwait = (epoch, repochs) -> repochs[1] ==
    epoch waits for a SPECIFIC worker, here the slowest one; the call
    never returns before it (in any arrival order)."""
    n = 3
    backend = make(_Kmap2Worker(), n,
                   delay_fn=lambda i, e: 0.004 if i == 0 else 0.0)
    try:
        pool = AsyncPool(n)
        sendbuf = np.zeros(1)
        pred = lambda epoch, repochs: repochs[0] == epoch  # noqa: E731
        for epoch in range(101, 131):  # kmap2.jl:66 numbering
            sendbuf[0] = epoch
            repochs = asyncmap(pool, sendbuf, backend, nwait=pred,
                               epoch=epoch)
            assert repochs[0] == pool.epoch == epoch  # kmap2.jl:70
            assert pool.latency[0] >= 0.004
        waitall(pool, backend)
    finally:
        backend.shutdown()


def test_pool_ranks_default_to_1_to_n_equivalent():
    """test/kmap2.jl:22 asserts pool.ranks == 1:n; 0-based here."""
    assert AsyncPool(4).ranks == [0, 1, 2, 3]
    assert AsyncPool(4).ranks == RefPool(4).ranks


@pytest.mark.parametrize("make", BACKENDS.values(), ids=BACKENDS)
def test_gated_straggler_is_stale_then_retasked(make):
    """Fastest-k with a gated straggler: the epoch returns without it,
    its slot stays active, and once released its stale result is
    harvested and the worker is re-tasked with the current payload."""
    n = 4
    gates = _Gates(closed=[(3, 1)])
    backend = make(_GatedEcho(gates), n)
    try:
        pool = AsyncPool(n)
        sendbuf = np.array([1.0])
        recvbuf = np.zeros(2 * n)
        repochs = asyncmap(pool, sendbuf, backend, recvbuf, nwait=3)
        assert list(repochs) == [1, 1, 1, 0]
        assert pool.active.tolist() == [False, False, False, True]
        # the caller mutates sendbuf right after asyncmap returns: the
        # outstanding worker holds its own copy of the epoch-1 payload
        sendbuf[0] = 2.0
        gates.open(3, 1)
        repochs = asyncmap(pool, sendbuf, backend, recvbuf, nwait=n)
        assert list(repochs) == [2] * n
        # the stale epoch-1 result was harvested and echoed 1.0, then
        # worker 3 was re-tasked at epoch 2 and echoed 2.0
        assert recvbuf.reshape(n, 2)[:, 1].tolist() == [2.0] * n
        assert not pool.active.any()
    finally:
        backend.shutdown()


@pytest.mark.parametrize("make", BACKENDS.values(), ids=BACKENDS)
def test_stale_arrival_echoes_its_own_epoch(make):
    """A released straggler's arrival is stamped with the epoch it was
    dispatched at, and its chunk echoes that epoch's payload even though
    the caller mutated sendbuf right after asyncmap returned."""
    n = 3
    gates = _Gates(closed=[(2, 1)])
    backend = make(_GatedEcho(gates), n)
    try:
        pool = AsyncPool(n)
        recvbuf = np.zeros(2 * n)
        sendbuf = np.array([1.0])
        asyncmap(pool, sendbuf, backend, recvbuf, nwait=2)
        sendbuf[0] = 99.0
        gates.open(2, 1)
        waitall(pool, backend, recvbuf, timeout=GATE_S)
        assert list(pool.repochs) == [1, 1, 1]
        assert recvbuf.reshape(n, 2)[2].tolist() == [2.0, 1.0]
    finally:
        backend.shutdown()


def _scripted_run(pool_cls, backend_cls, asyncmap_fn, waitall_fn):
    """One gated schedule over 4 workers in which every arrival set is
    fixed: worker 2 is late at epoch 1 (released before epoch 3), worker
    3 at epoch 2 (released before the final drain), and each nwait is
    exactly the workers that can answer. Returns the repochs after each
    call and the recvbuf bytes."""
    n = 4
    gates = _Gates(closed=[(2, 1), (3, 2)])
    backend = backend_cls(_GatedEcho(gates), n)
    history = []
    try:
        pool = pool_cls(n)
        recvbuf = np.zeros(2 * n)
        sendbuf = np.zeros(1)
        all_fresh = lambda e, r: bool((r[:3] == e).all())  # noqa: E731
        for epoch, nwait in ((1, 3), (2, 2), (3, all_fresh)):
            sendbuf[0] = 10.0 * epoch
            if epoch == 3:
                gates.open(2, 1)
            asyncmap_fn(pool, sendbuf, backend, recvbuf, nwait=nwait)
            history.append(pool.repochs.tolist())
        gates.open(3, 2)
        waitall_fn(pool, backend, recvbuf, timeout=GATE_S)
        history.append(pool.repochs.tolist())
        return history, recvbuf.tobytes()
    finally:
        backend.shutdown()


def test_gated_schedule_matches_the_jax_package_pool():
    """The same gated schedule through the JAX package's pool and
    LocalBackend and through the port's pool over both its backends:
    identical repochs after every call and identical recvbuf bytes."""
    want = _scripted_run(RefPool, RefLocal, ref_asyncmap, ref_waitall)
    assert want[0] == [[1, 1, 0, 1], [2, 2, 0, 1], [3, 3, 3, 1],
                       [3, 3, 3, 2]]
    for make in BACKENDS.values():
        assert _scripted_run(AsyncPool, make, asyncmap, waitall) == want


# -- the device-backend checklist (tests/test_backend_xla.py) -----------


def _echo_work(i, payload, epoch):
    return torch.cat([payload.double(),
                      torch.tensor([float(epoch)], dtype=torch.float64)])


def test_full_gather_on_cpu_device():
    n = 8
    backend = _cuda_cpu(lambda i, p, e: p * (i + 1), n)
    try:
        pool = AsyncPool(n)
        recvbuf = np.zeros(2 * n)
        asyncmap(pool, np.array([1.0, 2.0]), backend, recvbuf, nwait=n)
        for i in range(n):
            assert np.allclose(recvbuf.reshape(n, 2)[i],
                               [i + 1, 2 * (i + 1)])
        assert all(isinstance(r, torch.Tensor) and r.device == CPU
                   for r in pool.results)
    finally:
        backend.shutdown()


def test_fastest_k_epoch_echo_with_gated_straggler():
    """30 epochs at nwait=3 of 4; worker 3 is gated shut at epochs 1, 11
    and 21 and opened at the next epoch: every heard-from worker echoes
    the epoch it was dispatched at."""
    n = 4
    late = {1, 11, 21}
    gates = _Gates(closed=[(3, e) for e in late])

    def work(i, p, e):
        gates.wait(i, e)
        return _echo_work(i, p, e)

    backend = _cuda_cpu(work, n)
    try:
        pool = AsyncPool(n)
        sendbuf = np.zeros(1)
        recvbuf = np.zeros(2 * n)
        for epoch in range(1, 31):
            if epoch - 1 in late:
                gates.open(3, epoch - 1)
            sendbuf[0] = epoch
            repochs = asyncmap(pool, sendbuf, backend, recvbuf, nwait=3)
            if epoch in late:
                assert repochs[3] != epoch
            fresh = 0
            for i in range(n):
                if repochs[i] == 0:
                    continue
                fresh += repochs[i] == epoch
                assert recvbuf.reshape(n, 2)[i][1] == repochs[i]
            assert fresh >= 3
        waitall(pool, backend, recvbuf, timeout=GATE_S)
        assert not pool.active.any()
    finally:
        backend.shutdown()


def test_functional_nwait_on_cpu_device():
    n = 3
    gates = _Gates(closed=[(0, e) for e in range(1, 11)])

    def work(i, p, e):
        if i == 1:  # worker 0 is released by worker 1's arrival work
            gates.open(0, e)
        gates.wait(i, e)
        return _echo_work(i, p, e)

    backend = _cuda_cpu(work, n)
    try:
        pool = AsyncPool(n)
        pred = lambda epoch, repochs: repochs[0] == epoch  # noqa: E731
        for epoch in range(1, 11):
            repochs = asyncmap(pool, np.array([float(epoch)]), backend,
                               nwait=pred)
            assert repochs[0] == pool.epoch == epoch
        waitall(pool, backend, timeout=GATE_S)
    finally:
        backend.shutdown()


def test_worker_failure_on_cpu_device():
    def bad(i, p, e):
        if i == 1:
            raise ValueError("device boom")
        return p

    backend = _cuda_cpu(bad, 2)
    try:
        pool = AsyncPool(2)
        with pytest.raises(WorkerFailure, match="device boom"):
            asyncmap(pool, np.zeros(1), backend, nwait=2)
    finally:
        backend.shutdown()


def test_more_workers_than_devices():
    n = 16
    backend = _cuda_cpu(lambda i, p, e: p + i, n)
    try:
        assert backend.devices == [CPU] * n
        pool = AsyncPool(n)
        recvbuf = np.zeros(n)
        asyncmap(pool, np.zeros(1), backend, recvbuf, nwait=n)
        assert np.allclose(recvbuf, np.arange(n))
    finally:
        backend.shutdown()


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_direct_dispatch_after_asyncmap_snapshots_mutation(kind):
    """The epoch-keyed payload cache disarms when asyncmap returns: a
    manual same-epoch dispatch of a mutated buffer gets a fresh copy,
    not the cached pre-mutation one (tests/test_backend_xla.py:129)."""
    backend = _cuda_cpu(lambda i, p, e: p * 1.0, 2)
    try:
        pool = AsyncPool(2)
        buf = (np.array([1.0], dtype=np.float32) if kind == "numpy"
               else torch.tensor([1.0]))
        asyncmap(pool, buf, backend, nwait=2)
        buf[0] = 99.0
        backend.dispatch(0, buf, pool.epoch)  # manual re-task, same epoch
        result = backend.wait(0, timeout=GATE_S)
        assert float(result[0]) == 99.0
        assert float(pool.results[0][0]) == 1.0
    finally:
        backend.shutdown()


def test_batch_flush_failure_fails_members_not_strands_them():
    """A batch_fn that raises during flush fails its group's tasks
    (WorkerFailure at harvest) instead of stranding their slots."""
    calls = {"n": 0}

    def batch_fn(ids, payload, epoch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom in fused submit")
        return torch.stack([payload + i for i in ids])

    backend = _cuda_cpu(lambda i, p, e: p, 2, batch_fn=batch_fn)
    try:
        pool = AsyncPool(2)
        with pytest.raises(WorkerFailure, match="boom"):
            asyncmap(pool, torch.zeros(3), backend, nwait=2, timeout=5.0)
        assert int(pool.active.sum()) == 1
        with pytest.raises(WorkerFailure, match="boom"):
            waitall(pool, backend, timeout=5.0)
        assert not pool.active.any()
        asyncmap(pool, torch.zeros(3), backend, nwait=2, epoch=5)
        assert sorted(pool.fresh_indices(5).tolist()) == [0, 1]
        waitall(pool, backend, timeout=5.0)
    finally:
        backend.shutdown()


@pytest.mark.parametrize("arrival", ["ready", "enqueue"])
def test_batch_mode_posts_stacked_slices(arrival):
    """Coalesced dispatch: one batch_fn call per epoch for the device's
    workers; each result is a lazy row of the stack that bit-copies into
    recvbuf."""
    from mpistragglers_jl_tpu_torch.backends.cuda import StackedSlice

    calls = []

    def batch_fn(ids, payload, epoch):
        calls.append(ids)
        return torch.stack([payload * (i + 1) for i in ids])

    n = 4
    backend = _cuda_cpu(lambda i, p, e: p, n, batch_fn=batch_fn,
                        batch_arrival=arrival)
    try:
        pool = AsyncPool(n)
        recvbuf = np.zeros(2 * n, dtype=np.float32)
        for epoch in (1, 2):
            asyncmap(pool, torch.tensor([1.0, float(epoch)]), backend,
                     recvbuf, nwait=n)
            assert all(isinstance(r, StackedSlice) for r in pool.results)
            np.testing.assert_array_equal(
                recvbuf.reshape(n, 2),
                [[i + 1, (i + 1) * epoch] for i in range(n)])
        assert calls == [tuple(range(n))] * 2
    finally:
        backend.shutdown()


def test_bf16_recvbuf_round_trips_bit_exactly():
    """A bf16 result crosses into recvbuf as its bytes (numpy has no
    bf16): the chunk holds exactly the tensor's bit pattern."""
    n = 3

    def work(i, p, e):
        return (p.float() / (i + 3)).to(torch.bfloat16)

    backend = _cuda_cpu(work, n)
    try:
        pool = AsyncPool(n)
        recvbuf = np.zeros(5 * n, dtype=np.uint16)
        payload = torch.linspace(-1.7, 2.3, 5)
        asyncmap(pool, payload, backend, recvbuf, nwait=n)
        for i in range(n):
            want = work(i, payload, 1).view(torch.int16).numpy()
            assert recvbuf.reshape(n, 5)[i].tobytes() == want.tobytes()
    finally:
        backend.shutdown()


def test_recvbuf_width_mismatch_raises_and_keeps_pool_usable():
    backend = _cuda_cpu(lambda i, p, e: p.float(), 2)
    try:
        pool = AsyncPool(2)
        with pytest.raises(ValueError, match="bit-copies"):
            # two f32 results of 8 bytes each against 16-byte chunks
            asyncmap(pool, np.zeros(2), backend, np.zeros(4), nwait=2)
        waitall(pool, backend, timeout=GATE_S)
        assert not pool.active.any()
    finally:
        backend.shutdown()


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CUDADeviceBackend(lambda i, p, e: p, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CUDADeviceBackend(lambda i, p, e: p, 2, devices=["cuda"])


def test_window_submission_and_failure_envelope():
    backend = _cuda_cpu(lambda i, p, e: p, 2)
    try:
        h = backend.submit_window(lambda x: x * 2, torch.ones(3),
                                  epoch0=4, epochs=8)
        assert h.epoch0 == 4 and h.epochs == 8
        assert h.harvest().tolist() == [2.0, 2.0, 2.0]

        def boom(x):
            raise RuntimeError("window boom")

        with pytest.raises(WorkerFailure, match="window boom"):
            backend.submit_window(boom, torch.ones(3), epoch0=0, epochs=1)
    finally:
        backend.shutdown()
