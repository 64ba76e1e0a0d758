"""Zero-copy transport: persistent shm rings.

Three layers under test:

* raw native transport — the persistent broadcast arena (fd passed
  once, slots reused across epochs, pin-count acks) and per-worker
  result rings (native/transport.py + native/rings.py);
* NativeProcessBackend end to end — byte-exact round trips for
  f32/int8/non-contiguous payloads, pipe-pickle vs shm-ring identity,
  held-view lifetime across more epochs than the ring is deep;
* ProcessBackend shm rings — pickle protocol-5 out-of-band buffers
  over ``multiprocessing.shared_memory``, pipes carrying only control
  frames, and the read-only payload contract.
* the migration ring of ``models/disagg.py`` — the three lifetime
  cases of ``tests/test_transport_rings.py:500-610``.

The lifetime claims extend the keep-window eviction regression to
the persistent rings: a held ``Message.body`` (or harvested result)
view must stay readable FOREVER — slot reuse defers (producer falls
back to the copying transport), it never tears.
"""

import os
import threading

import numpy as np
import pytest

from mpistragglers_jl_tpu_torch import AsyncPool, ProcessBackend, asyncmap, waitall
from mpistragglers_jl_tpu_torch.native import NativeBuildError
from mpistragglers_jl_tpu_torch.native import rings as R

try:
    from mpistragglers_jl_tpu_torch.backends.native import NativeProcessBackend
    from mpistragglers_jl_tpu_torch.native import transport as T

    T.load_lib()
    _SKIP = None
except NativeBuildError as e:  # pragma: no cover - no compiler in env
    _SKIP = str(e)

needs_native = pytest.mark.skipif(
    _SKIP is not None, reason=f"native transport unavailable: {_SKIP}"
)

MB = 1 << 20


# ---------------------------------------------------------------- rings.py


def test_ring_alloc_pins_and_generations():
    a = R.RingAlloc(2)
    s0, g0 = a.acquire(("coord",))
    s1, g1 = a.acquire((1, 2))
    assert {s0, s1} == {0, 1} and g1 > g0
    assert a.acquire(("x",)) is None  # full
    a.release(s0, g0, "coord")
    s2, g2 = a.acquire((7,))
    assert s2 == s0 and g2 > g1
    # stale release (old generation) must not free the new occupant
    a.release(s2, g0, 7)
    assert a.acquire(("y",)) is None
    a.release(s2, g2, 7)
    a.release_holder_everywhere(1)
    a.release(s1, g1, 2)
    assert a.pinned == 0


def test_track_release_fires_once_when_last_view_dies():
    """The release hook fires only when every derived buffer is gone.
    The transport serves MEMORYVIEWS of the tracked slice for exactly
    this reason: ``np.frombuffer(ndarray)`` does not keep the ndarray
    object in its base chain, but a memoryview's managed buffer does —
    so any consumer chain built on the served body pins the slot."""
    region = R.MemfdRegion.create(4096)
    if region is None:  # pragma: no cover - no memfd
        pytest.skip("memfd unavailable")
    fired = []
    view = region.view[:128]
    R.track_release(view, fired.append, "released")
    body = memoryview(view)  # what Message.body actually is
    derived = np.frombuffer(body, np.uint8)[10:20]
    sliced = body[5:50]
    del view, body
    assert not fired, "fired while derived buffers were alive"
    del derived
    assert not fired, "fired while a memoryview slice was alive"
    del sliced
    assert fired == ["released"]
    region.close()


# --------------------------------------------------- raw transport: arena


def _pair(n):
    import tempfile
    import uuid

    path = os.path.join(
        tempfile.gettempdir(), f"msgt-ring-{uuid.uuid4().hex[:8]}.sock"
    )
    return T.Coordinator(path, n), path


@needs_native
def test_arena_is_persistent_and_byte_exact():
    """One arena id across every epoch (the per-epoch memfd + mmaps +
    fd-pass setup is gone), one worker-side mapping, byte-exact slot
    views, and ack-driven slot reuse with zero steady-state stalls."""
    coord, path = _pair(2)
    epochs = 10
    state = {}

    def worker(rank):
        w = T.Worker(path, rank)
        n_maps = set()
        while True:
            msg = w.recv()
            if msg is None or msg.kind == T.KIND_CONTROL:
                break
            assert msg.body is not None, "broadcast did not ride the arena"
            n_maps.update(w._arena_regions)
            got = np.frombuffer(msg.body, np.uint8)
            # >= RING_MIN so the echo rides the result ring
            w.send_result(b"p", got[:T.RING_MIN].copy(), seq=msg.seq,
                          epoch=msg.epoch)
            msg = None
            got = None
        state[rank] = n_maps
        w.close()

    ts = [threading.Thread(target=worker, args=(r,), daemon=True)
          for r in range(2)]
    for t in ts:
        t.start()
    try:
        coord.accept(timeout=10)
        aid = None
        for i in range(epochs):
            body = np.full(MB, i, np.uint8)
            pl = coord.arena_payload(body)
            assert pl is not None, (
                f"arena stalled at epoch {i}: {coord.stats}"
            )
            if aid is None:
                aid = pl.arena.id
            assert pl.arena.id == aid, "arena was recreated per epoch"
            for rank in range(2):
                assert coord.isend_shared(rank, b"hdr", pl, seq=i, epoch=i)
            pl.release()
            for _ in range(2):
                r, msg = coord.waitany([0, 1], timeout=10)
                assert msg.kind == T.KIND_DATA
                assert msg.body is not None, "result did not ride a ring"
                got = np.frombuffer(msg.body, np.uint8)
                assert got.shape == (T.RING_MIN,)
                assert got[0] == i and got[-1] == i
                msg = None
                got = None
        for rank in range(2):
            coord.isend(rank, b"", kind=T.KIND_CONTROL)
        for t in ts:
            t.join(timeout=10)
        assert state[0] == {aid} and state[1] == {aid}, (
            "workers mapped more than the one persistent arena"
        )
        assert coord.stats["arena_stalls"] == 0
        assert coord.stats["arena_bytes"] == epochs * 2 * MB
    finally:
        coord.close()


@needs_native
def test_held_arena_view_across_more_epochs_than_slots_stays_readable():
    """The keep-window eviction regression, persistent-ring edition: a worker
    that HOLDS an arena body view forever pins that slot; the
    coordinator keeps broadcasting through the remaining slots (and
    falls back to the one-shot shm path when all are pinned) — the
    held view stays byte-correct through 3x more epochs than the
    arena has slots."""
    coord, path = _pair(2)
    epochs = T.ARENA_SLOTS * 3
    done = threading.Event()

    def pinner():
        w = T.Worker(path, 0)
        held = None
        seen = 0
        while True:
            msg = w.recv()
            if msg is None or msg.kind == T.KIND_CONTROL:
                break
            assert msg.body is not None
            if held is None:
                held = msg.body  # pin epoch 0's slot forever
            seen += 1
            msg = None
            # the held view stays exactly epoch 0's bytes
            assert bytes(memoryview(held)[:4]) == b"\x00" * 4
            assert bytes(memoryview(held)[-4:]) == b"\x00" * 4
            w.send(b"ok", seq=seen)
        assert seen == epochs
        w.close()
        done.set()

    def drain():
        w = T.Worker(path, 1)
        while True:
            msg = w.recv()
            if msg is None or msg.kind == T.KIND_CONTROL:
                break
            msg = None
            w.send(b"ok")
        w.close()

    ts = [threading.Thread(target=pinner, daemon=True),
          threading.Thread(target=drain, daemon=True)]
    for t in ts:
        t.start()
    try:
        coord.accept(timeout=10)
        for i in range(epochs):
            body = np.full(MB, i, np.uint8)
            pl = coord.arena_payload(body) or coord.payload(body)
            for rank in range(2):
                assert coord.isend_shared(rank, b"h", pl, seq=i, epoch=i)
            pl.release()
            for _ in range(2):
                got = coord.waitany([0, 1], timeout=10)
                assert got is not None
        for rank in range(2):
            coord.isend(rank, b"", kind=T.KIND_CONTROL)
        assert done.wait(timeout=30), "pinned worker did not finish"
        for t in ts:
            t.join(timeout=10)
        # the pinned slot forced at most slots-1 live slots per epoch;
        # the coordinator must have kept going regardless (stall +
        # fallback is allowed, tearing is not — asserted in pinner)
        assert coord.pinned_slots() >= 1  # the held slot is still pinned
    finally:
        coord.close()


@needs_native
def test_held_result_ring_view_outlives_ring_depth():
    """Symmetric lifetime claim for the harvest side: the coordinator
    holds one harvested ring view across 3x ring-depth further
    epochs; the worker wraps its ring (falling back to socket sends
    when every slot is pinned — stall-reported, never torn) and the
    held view stays byte-correct."""
    coord, path = _pair(1)
    epochs = T.RING_SLOTS * 3

    def worker():
        w = T.Worker(path, 0)
        while True:
            msg = w.recv()
            if msg is None or msg.kind == T.KIND_CONTROL:
                break
            i = int(msg.epoch)
            w.send_result(
                b"p", np.full(T.RING_MIN, i % 251, np.uint8),
                seq=msg.seq, epoch=msg.epoch,
            )
            msg = None
        w.close()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        coord.accept(timeout=10)
        held = []  # pin EVERY slot: the first ring-depth views, forever
        socket_fallbacks = 0
        for i in range(epochs):
            coord.isend(0, b"go", seq=i, epoch=i)
            r, msg = coord.waitany([0], timeout=10)
            assert msg.kind == T.KIND_DATA
            if msg.body is not None:
                body = np.frombuffer(msg.body, np.uint8)
            else:
                # ring full (all slots pinned below): the worker fell
                # back to the copying socket send — delivery never
                # waits on the coordinator's GC
                socket_fallbacks += 1
                body = np.frombuffer(msg.payload, np.uint8)[1:]  # "p"
            assert body[0] == i % 251 and body[-1] == i % 251
            if len(held) < T.RING_SLOTS and msg.body is not None:
                held.append((i, body))  # keep the view alive
            for j, h in held:
                assert h[0] == j % 251 and h[-1] == j % 251, (
                    f"held ring view of epoch {j} torn at epoch {i}"
                )
            msg = None
            body = None
        coord.isend(0, b"", kind=T.KIND_CONTROL)
        t.join(timeout=10)
        assert len(held) == T.RING_SLOTS
        for j, h in held:
            assert h[0] == j % 251 and h[-1] == j % 251
        # every slot pinned => the later epochs MUST have fallen back,
        # and the worker must have stall-reported it
        assert socket_fallbacks > 0
        assert coord.stats["ring_stalls"] > 0
        assert coord.stats["ring_bytes"] > 0
        assert coord.pinned_slots() >= T.RING_SLOTS
    finally:
        coord.close()


# --------------------------------------------- end-to-end byte exactness


def _identity(i, payload, epoch):
    return payload


def _identity_tree(i, payload, epoch):
    return {"a": payload["a"], "b": payload["b"], "rank": i}


def _mutator(i, payload, epoch):
    payload[0] = 99.0  # must raise on read-only zero-copy views
    return payload


_CASES = {
    # >= 1 MiB so the broadcast rides the arena; results ride rings
    "f32": np.linspace(0, 1, 300_000, dtype=np.float32),
    "int8": np.arange(1_200_000, dtype=np.int64).astype(np.int8),
    "noncontig": np.arange(2_400_000, dtype=np.float32).reshape(
        2, 1_200_000
    )[:, ::2],
}


def _roundtrip(backend_factory, payload, n=2, epochs=3):
    be = backend_factory()
    try:
        pool = AsyncPool(n)
        outs = []
        for _ in range(epochs):
            asyncmap(pool, payload, be, nwait=n)
            outs.append([np.asarray(pool.results[r]) for r in range(n)])
        waitall(pool, be)
        return outs
    finally:
        be.shutdown()


@needs_native
@pytest.mark.parametrize("case", sorted(_CASES))
def test_native_ring_roundtrip_identity_vs_pipe_pickle(case):
    """The acceptance identity: shm-ring results are byte-for-byte the
    pipe-pickle results for f32, int8, and non-contiguous payloads,
    across epochs (slot reuse included)."""
    payload = _CASES[case]
    ring = _roundtrip(lambda: NativeProcessBackend(_identity, 2), payload)
    pipe = _roundtrip(
        lambda: ProcessBackend(_identity, 2, shm_rings=False), payload
    )
    expect = np.ascontiguousarray(payload)
    for epoch_ring, epoch_pipe in zip(ring, pipe):
        for got_r, got_p in zip(epoch_ring, epoch_pipe):
            assert got_r.dtype == got_p.dtype == expect.dtype
            assert got_r.shape == got_p.shape == expect.shape
            assert np.array_equal(got_r, expect)
            assert np.array_equal(got_p, expect)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_process_shm_ring_roundtrip_identity(case):
    """ProcessBackend's shared-memory rings reproduce the classic
    in-band pickling byte-for-byte (pipes carry only control)."""
    payload = _CASES[case]
    ring = _roundtrip(lambda: ProcessBackend(_identity, 2), payload)
    expect = np.ascontiguousarray(payload)
    for epoch in ring:
        for got in epoch:
            assert got.dtype == expect.dtype
            assert got.shape == expect.shape
            assert np.array_equal(got, expect)


def test_process_shm_ring_pytree_payload_roundtrip():
    """Multi-buffer pickling: a dict of arrays crosses as protocol-5
    out-of-band buffers packed into one slot."""
    payload = {
        "a": np.arange(200_000, dtype=np.float32),
        "b": np.arange(100_000, dtype=np.int8),
    }
    be = ProcessBackend(_identity_tree, 2)
    try:
        pool = AsyncPool(2)
        asyncmap(pool, payload, be, nwait=2)
        for r in range(2):
            out = pool.results[r]
            assert np.array_equal(out["a"], payload["a"])
            assert np.array_equal(out["b"], payload["b"])
            assert out["rank"] == r
        waitall(pool, be)
        assert be.ring_stats["bcast_bytes"] > 0
        assert be.ring_stats["result_bytes"] > 0
    finally:
        be.shutdown()


def test_process_ring_payloads_are_readonly_views():
    """The contract change shm_rings makes: bulk payloads arrive as
    read-only views (native-backend discipline), so an in-place
    mutator fails LOUDLY instead of corrupting the shared slot."""
    from mpistragglers_jl_tpu_torch import WorkerFailure

    payload = np.ones(300_000, np.float32)  # >= PROC_RING_MIN
    be = ProcessBackend(_mutator, 1)
    try:
        pool = AsyncPool(1)
        with pytest.raises(WorkerFailure, match="read-only|not writeable"):
            asyncmap(pool, payload, be, nwait=1)
    finally:
        be.shutdown()
    # and the escape hatch restores the classic mutable private copy
    be = ProcessBackend(_mutator, 1, shm_rings=False)
    try:
        pool = AsyncPool(1)
        asyncmap(pool, payload, be, nwait=1)
        assert np.asarray(pool.results[0])[0] == 99.0
        waitall(pool, be)
    finally:
        be.shutdown()


def test_process_small_payloads_stay_in_band():
    """Below PROC_RING_MIN nothing touches shared memory — the classic
    path, byte-identical and mutable."""
    payload = np.arange(64, dtype=np.float32)
    be = ProcessBackend(_identity, 2)
    try:
        pool = AsyncPool(2)
        asyncmap(pool, payload, be, nwait=2)
        for r in range(2):
            assert np.array_equal(np.asarray(pool.results[r]), payload)
        waitall(pool, be)
        assert be.ring_stats["bcast_bytes"] == 0
        assert be.ring_stats["result_bytes"] == 0
    finally:
        be.shutdown()


@needs_native
def test_native_zero_copy_counters_and_harvested_views_pin_slots():
    """Opt-in obs wiring (GC004 contract): zero-copy byte counters,
    stall counters, and the pinned-slot gauge land in the registry;
    harvested results pin ring slots until released."""
    from mpistragglers_jl_tpu_torch.obs import MetricsRegistry

    reg = MetricsRegistry()
    payload = np.ones(MB // 4, np.float32)  # 1 MiB
    be = NativeProcessBackend(_identity, 2, registry=reg)
    try:
        pool = AsyncPool(2)
        for _ in range(4):
            asyncmap(pool, payload, be, nwait=2)
        waitall(pool, be)
        snap = reg.snapshot()
        zc = {
            s["labels"]["path"]: s["value"]
            for s in snap["transport_zero_copy_bytes_total"]["series"]
        }
        assert zc.get("arena", 0) > 0, "arena bytes never counted"
        assert zc.get("ring", 0) > 0, "ring bytes never counted"
        assert snap["transport_pinned_slots_peak"]["series"][0]["value"] > 0
        # pool.results holds the last epoch's views -> slots pinned now
        assert be._coord.pinned_slots() > 0
    finally:
        be.shutdown()


@needs_native
def test_native_zero_copy_false_forces_copying_transport():
    payload = np.ones(MB // 4, np.float32)
    be = NativeProcessBackend(_identity, 2, zero_copy=False)
    try:
        pool = AsyncPool(2)
        for _ in range(3):
            asyncmap(pool, payload, be, nwait=2)
            for r in range(2):
                assert np.array_equal(
                    np.asarray(pool.results[r]), payload
                )
        waitall(pool, be)
        s = be._coord.stats
        assert s["arena_bytes"] == 0 and s["ring_bytes"] == 0
    finally:
        be.shutdown()


# ------------------------------------------------------- migration ring
#
# models/disagg.py's MigrationRing (tests/test_transport_rings.py
# :500-610): slots stay pinned while any consumer view lives, an
# all-pinned ring falls back to copying frames, and a stale generation
# is served as a copy, never a torn view.


def _mig_ring(**kw):
    from mpistragglers_jl_tpu_torch.models.disagg import (
        MigrationRing,
        MigrationRingReader,
    )

    kw.setdefault("slot_bytes", 1 << 12)
    kw.setdefault("slots", 4)
    ring = MigrationRing(**kw)
    if ring.region is None:  # pragma: no cover - no memfd on this box
        pytest.skip("memfd_create unavailable")
    return ring, MigrationRingReader(ring)


def test_migration_ring_frames_byte_exact_and_pins_release():
    """Round trip through the consumer's own mapping of the fd, byte
    exact; a slot's pin drops when the sender releases its frames and
    the last consumer view dies."""
    import gc

    ring, reader = _mig_ring()
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 255, size=3 * (1 << 12) + 17,
                           dtype=np.uint8)
    frames = ring.send_segment(payload)
    assert len(frames) == 4 and ring.stalls == 0
    got = reader.read_segment(frames)  # multi-frame => private copy
    assert np.array_equal(got, payload)
    seg = rng.integers(0, 255, size=100, dtype=np.uint8)
    ring.release_frames(frames)
    gc.collect()
    assert ring.pinned == 0
    f3 = ring.send_segment(seg)
    view = reader.read_segment(f3)
    assert np.array_equal(view, seg)
    assert ring.pinned == 1  # sender pin + live consumer view
    ring.release_frames(f3)
    assert ring.pinned == 1  # the view still pins it
    del view
    gc.collect()
    assert ring.pinned == 0
    ring.close()


def test_migration_ring_all_pinned_falls_back_to_copy():
    """Every slot pinned by held consumer views: further sends become
    copying frames (stall counted), byte exact, and the held views
    never tear."""
    import gc

    from mpistragglers_jl_tpu_torch.models.disagg import CopyFrame

    ring, reader = _mig_ring(slots=2)
    rng = np.random.default_rng(1)
    a = rng.integers(0, 255, size=1 << 12, dtype=np.uint8)
    b = rng.integers(0, 255, size=1 << 12, dtype=np.uint8)
    fa, fb = ring.send_segment(a), ring.send_segment(b)
    va = np.frombuffer(reader.read_segment(fa), np.uint8).copy(), \
        reader.read_segment(fa)
    vb = reader.read_segment(fb)
    ring.release_frames(fa)
    ring.release_frames(fb)
    gc.collect()
    assert ring.pinned == 2  # both held by the live views
    c = rng.integers(0, 255, size=200, dtype=np.uint8)
    fc = ring.send_segment(c)
    assert all(isinstance(f, CopyFrame) for f in fc)
    assert ring.stalls >= 1
    assert np.array_equal(reader.read_segment(fc), c)
    assert np.array_equal(va[1], va[0])
    assert np.array_equal(vb, b)
    del va, vb
    gc.collect()
    assert ring.pinned == 0
    ring.close()


def test_migration_ring_stale_generation_served_as_copy():
    """A frame read after its slot was released and reused comes back
    as a private copy, never a view of the new occupant's bytes, and
    does not pin the reused slot."""
    import gc

    ring, reader = _mig_ring(slots=1)
    a = np.full(64, 7, np.uint8)
    fa = ring.send_segment(a)
    ring.release_frames(fa)
    gc.collect()
    b = np.full(64, 9, np.uint8)
    fb = ring.send_segment(b)  # reuses slot 0, new generation
    stale = reader.read_segment(fa)  # old gen: served as a copy
    assert np.array_equal(stale, a) or np.array_equal(stale, b)
    fresh = reader.read_segment(fb)
    assert np.array_equal(fresh, b)
    ring.release_frames(fb)
    del fresh, stale
    gc.collect()
    assert ring.pinned == 0
    ring.close()
