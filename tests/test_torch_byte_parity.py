"""Byte-exact buffer parity (SURVEY C5; reference src/MPIAsyncPools.jl:80-84).

The reference type-erases every caller buffer via ``reinterpret(UInt8, ...)``
so a pool is payload-agnostic: mixed dtypes, structured records — anything
with a fixed byte layout — round-trips bit-exactly through ``recvbuf``.
These tests ship float64 + int64 mixed payloads (and structured records)
through the Local, Process, and Native backends and assert bit identity,
and pin down the no-silent-cast contract: a result whose byte width
doesn't fill its chunk is an error, never an ``astype``.
"""

import numpy as np
import pytest

from mpistragglers_jl_tpu_torch import AsyncPool, asyncmap, waitall
from mpistragglers_jl_tpu_torch.backends.local import LocalBackend

# bit patterns that expose value-casting: NaN payloads survive a bitcopy
# but not a float round-trip through a different width; huge int64s lose
# bits through float64
_F64 = np.array([np.pi, -0.0, np.inf, np.float64.__call__(np.nan)])
_I64 = np.array([2**62 + 3, -1, 2**53 + 1, 7], dtype=np.int64)


def _mixed_work(i, payload, epoch):
    """Even workers ship int64, odd workers float64 — same byte width."""
    if i % 2 == 0:
        return _I64 + i
    return _F64 + i


_REC_DT = np.dtype([("id", np.int32), ("x", np.float64), ("tag", "S4")])


def _record_work(i, payload, epoch):
    out = np.zeros(2, dtype=_REC_DT)
    out["id"] = [i, i + 100]
    out["x"] = [np.pi * i, np.nan]
    out["tag"] = [b"abcd", b"wxyz"]
    return out


def _f32_work(i, payload, epoch):
    return np.ones(4, dtype=np.float32)


def _make_backend(kind, work_fn, n):
    if kind == "local":
        return LocalBackend(work_fn, n)
    if kind == "process":
        from mpistragglers_jl_tpu_torch.backends.process import ProcessBackend

        return ProcessBackend(work_fn, n)
    from mpistragglers_jl_tpu_torch.native import NativeBuildError

    try:
        from mpistragglers_jl_tpu_torch.backends.native import NativeProcessBackend

        return NativeProcessBackend(work_fn, n)
    except NativeBuildError as e:  # pragma: no cover - no compiler
        pytest.skip(f"native transport unavailable: {e}")


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["local", "process", "native"])
def test_mixed_dtype_payloads_bit_identical(kind):
    """float64 + int64 payloads land bit-exactly in one recvbuf; the
    caller reinterprets each chunk with its worker's dtype — the
    reference's byte-view contract, not a value cast."""
    n = 4
    backend = _make_backend(kind, _mixed_work, n)
    try:
        pool = AsyncPool(n)
        recvbuf = np.zeros(4 * n)  # float64 arena; 8-byte elements
        asyncmap(pool, np.zeros(1), backend, recvbuf, nwait=n)
        chunks = recvbuf.reshape(n, 4)
        for i in range(n):
            if i % 2 == 0:
                got = chunks[i].view(np.int64)
                assert np.array_equal(got, _I64 + i), got
            else:
                got = chunks[i]
                want = _F64 + i
                assert got.tobytes() == want.tobytes()  # NaN-safe, bitwise
    finally:
        backend.shutdown()


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["local", "process", "native"])
def test_structured_records_roundtrip(kind):
    """A structured-dtype recvbuf (the reference's 'anything isbits')
    gathers worker records bit-exactly."""
    n = 3
    backend = _make_backend(kind, _record_work, n)
    try:
        pool = AsyncPool(n)
        recvbuf = np.zeros(2 * n, dtype=_REC_DT)
        asyncmap(pool, np.zeros(1), backend, recvbuf, nwait=n)
        recs = recvbuf.reshape(n, 2)
        for i in range(n):
            assert recs[i].tobytes() == _record_work(i, None, 1).tobytes()
    finally:
        backend.shutdown()


def test_width_mismatch_errors_not_casts():
    """A float32 result does not fill a float64 chunk: hard error at
    harvest (previously a silent astype — reference C5)."""
    n = 2
    backend = LocalBackend(_f32_work, n)
    try:
        pool = AsyncPool(n)
        recvbuf = np.zeros(4 * n)  # float64: 2x the bytes of the result
        with pytest.raises(ValueError, match="bit-cop"):
            asyncmap(pool, np.zeros(1), backend, recvbuf, nwait=n)
        waitall(pool, backend)  # pool stays drainable without a recvbuf
        # matching the width works — and is a bitcopy
        pool2 = AsyncPool(n)
        recvbuf32 = np.zeros(4 * n, dtype=np.float32)
        asyncmap(pool2, np.zeros(1), backend, recvbuf32, nwait=n)
        assert np.array_equal(recvbuf32, np.ones(4 * n, dtype=np.float32))
    finally:
        backend.shutdown()


def test_noncontiguous_recvbuf_rejected():
    """Byte views need contiguity; a strided recvbuf would silently
    gather into a throwaway copy, so it is refused up front."""
    backend = LocalBackend(_mixed_work, 2)
    try:
        pool = AsyncPool(2)
        recvbuf = np.zeros(16)[::2]
        with pytest.raises(ValueError, match="contiguous"):
            asyncmap(pool, np.zeros(1), backend, recvbuf, nwait=2)
    finally:
        backend.shutdown()


def test_mis_sized_recvbuf_fails_before_dispatch():
    """Reference parity (src/MPIAsyncPools.jl:72-76): buffer validation
    fires before any communication. With a worker still in flight, an
    asyncmap whose recvbuf chunks can't hold that worker's results
    raises pre-dispatch, not mid-epoch."""

    class Gate:
        """Worker 1 blocks from epoch 2 on, until released."""

        def __init__(self):
            import threading

            self.ev = threading.Event()

        def __call__(self, i, epoch):
            if i == 1 and epoch >= 2 and not self.ev.is_set():
                self.ev.wait(5.0)
            return 0.0

    gate = Gate()
    backend = LocalBackend(
        lambda i, p, e: np.full(4, float(i)), 2, delay_fn=gate
    )
    try:
        pool = AsyncPool(2)
        recvbuf = np.zeros(8)
        asyncmap(pool, np.zeros(1), backend, recvbuf, nwait=2)  # all land
        asyncmap(pool, np.zeros(1), backend, recvbuf, nwait=1)  # 1 stalls
        assert pool.active[1]  # straggler in flight, epoch-1 result known
        bad = np.zeros(4)  # chunks half the known result size
        with pytest.raises(ValueError, match="before dispatching"):
            asyncmap(pool, np.zeros(1), backend, bad, nwait=1)
        gate.ev.set()
        waitall(pool, backend, recvbuf)
        assert not pool.active.any()
    finally:
        backend.shutdown()
