"""OS-process worker backend: real process isolation, serialized transport.

A copy of the JAX package's ``backends/process.py``. The port's one
change: every pipe frame is pickled by :func:`..native.codec.dumps`, so a
torch tensor (CPU or CUDA, bf16 included, in either direction) crosses
as a copy of its host bytes and never as torch's shared-memory or CUDA
IPC handle. A tensor of a numpy dtype arrives as a numpy array (as the
reference's JAX arrays do), any other as a CPU tensor. A worker that
computes on the card imports torch itself and copies its payload there.

The reference's only execution mode is ``mpiexec`` spawning one OS process
per rank, with every payload crossing a real process boundary
(test/runtests.jl:17; workers speak raw ``MPI.Irecv!``/``Isend`` —
examples/iterative_example.jl:55-82). :class:`LocalBackend` deliberately
replaces that with threads for fast unit tests; :class:`ProcessBackend` is
the faithful counterpart: n spawned worker *processes*, payloads pickled
over OS pipes (serialization is the in-host analog of the network hop),
a per-worker shutdown sentinel standing in for the reference's
control-tag broadcast (test/kmap2.jl:14-18), and — beyond the reference —
dead-worker detection: a worker process dying mid-task surfaces as a
:class:`~.base.WorkerFailure` at harvest instead of hanging the pool the
way a dead rank hangs ``MPI.Waitall!`` (SURVEY §5 'Failure detection').

Because workers are spawned processes, ``work_fn`` and ``delay_fn`` must
be picklable: module-level functions, ``functools.partial`` of them, or
instances of module-level classes defining ``__call__`` (the fault
schedules in :mod:`..utils.faults` qualify).
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import threading
import time
import traceback
import weakref
from typing import Callable

import numpy as np

from ..native import codec as _codec
from ..native import rings as _rings
from .base import DelayFn, SlotBackend, WorkerError

WorkFn = Callable[[int, object, int], object]

__all__ = ["ProcessBackend", "RemoteWorkerError", "WorkerProcessDied"]

# Zero-copy pipe transport: ndarray payloads of at least this
# many bytes ride ``multiprocessing.shared_memory`` rings (pickle
# protocol-5 out-of-band buffers), the pipes carrying only small
# control frames. Below it, classic in-band pickling wins.
PROC_RING_MIN = 1 << 16
PROC_RING_SLOTS = 4

# control-frame markers (first tuple element)
_MARK_BCAST = "__shmb__"   # dispatch body in the shared broadcast ring
_MARK_RESULT = "__shmr__"  # result body in the worker's result ring
_MARK_ACK = "__ack__"      # slot-release records, either direction


def _send(conn, obj) -> None:
    """``conn.send(obj)``, pickled by :func:`..native.codec.dumps`:
    torch tensors cross as copies of their host bytes. ``Connection.
    send`` pickles with ``ForkingPickler``, where ``import torch``
    registers reductions that would hand the peer a shared-memory or
    CUDA IPC handle to the sender's memory instead (no snapshot, and a
    CUDA result would die with its worker)."""
    conn.send_bytes(_codec.dumps(obj))


def _recv(conn):
    return pickle.loads(conn.recv_bytes())


def _attach_shm(name: str):
    """Attach an existing shared-memory segment READ-ONLY, bypassing
    ``SharedMemory`` on the attach side: attaching via the class
    registers the name with the (spawn-shared) resource tracker a
    second time, which corrupts the creator's unlink accounting
    (bpo-38119) and spews tracker KeyErrors; a plain read-only mmap of
    the POSIX segment has no tracker interaction and gives the
    read-only payload contract for free. Returns ``(mmap, base)`` with
    ``base`` a read-only uint8 array over the whole segment."""
    import mmap as _mmap
    import os as _os

    fd = _os.open(f"/dev/shm/{name}", _os.O_RDONLY)
    try:
        size = _os.fstat(fd).st_size
        mm = _mmap.mmap(fd, size, _mmap.MAP_SHARED, _mmap.PROT_READ)
    finally:
        _os.close(fd)
    return mm, np.frombuffer(mm, np.uint8)


def _unlink_shm_quiet(name: str) -> None:
    """Best-effort unlink of a POSIX shared-memory name (the parent's
    crash-path safety net for worker result rings; the creating worker
    unlinks on clean exit)."""
    import os as _os

    try:
        _os.unlink(f"/dev/shm/{name}")
    except OSError:
        pass


def _encode_oob(obj) -> tuple[bytes, list]:
    """Pickle with protocol-5 out-of-band buffers: ``(data, views)``
    where ``views`` are the raw contiguous buffer views (ndarray
    memory) the unpickler must be handed back in order. Empty views =
    nothing eligible (no arrays, or non-contiguous fallbacks pickled
    in-band)."""
    bufs: list = []
    data = _codec.dumps(obj, buffer_callback=bufs.append)
    return data, [b.raw() for b in bufs]


def _serve_slot_views(base, start: int, lens, on_release, *args):
    """Read-only views over one ring slot's packed buffers, with a
    counted release hook: ``on_release(*args)`` fires once, when the
    LAST derived view dies (the unpickled arrays keep these as their
    bases). ``base`` must be a read-only uint8 array over the whole
    segment."""
    views = []
    pos = start
    for n in lens:
        views.append(base[pos:pos + n])
        pos += n
    state = {"left": len(views)}
    lock = threading.Lock()

    def _dec():
        with lock:
            state["left"] -= 1
            done = state["left"] == 0
        if done:
            on_release(*args)

    for v in views:
        weakref.finalize(v, _dec)
    # hand out MEMORYVIEWS of the tracked slices: np.frombuffer (which
    # is how pickle-5 reconstructs arrays) does not keep an ndarray
    # buffer-source object alive, only its root buffer — the finalizer
    # would fire (and the slot recycle) under live arrays. A
    # memoryview's managed buffer holds the slice strongly and every
    # derived buffer shares it.
    return [memoryview(v) for v in views]


class _ShmRing:
    """One SharedMemory segment divided into equal slots (producer
    side). ``create`` returns None when shared memory is unavailable
    (callers fall back to in-band pickling)."""

    __slots__ = ("shm", "name", "slots", "slot_bytes", "view", "alloc")

    def __init__(self, shm, slots: int):
        self.shm = shm
        self.name = shm.name
        self.slots = int(slots)
        self.slot_bytes = shm.size // self.slots
        self.view = np.frombuffer(shm.buf, np.uint8)
        self.alloc = _rings.RingAlloc(self.slots)

    @classmethod
    def create(cls, body_bytes: int, slots: int):
        from multiprocessing import shared_memory

        size = max(_rings.next_pow2(body_bytes), PROC_RING_MIN) * slots
        try:
            shm = shared_memory.SharedMemory(create=True, size=size)
        except (OSError, ValueError):  # pragma: no cover - /dev/shm full
            return None
        return cls(shm, slots)

    def destroy(self) -> None:
        """Creator-side teardown: drop our view, close, unlink. Safe
        against double-unlink (a hard-killed peer may have beaten us)."""
        self.view = None
        try:
            self.shm.close()
        except BufferError:  # pragma: no cover - lingering local view
            pass
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass


class RemoteWorkerError(RuntimeError):
    """A worker process raised during compute; carries the remote traceback
    (the reference loses these entirely — assertions die inside mpiexec
    subprocesses and only garble stdout, SURVEY §4)."""

    def __init__(self, exc_type: str, message: str, remote_traceback: str):
        self.exc_type = exc_type
        self.remote_traceback = remote_traceback
        super().__init__(f"{exc_type}: {message}\n{remote_traceback}")


class WorkerProcessDied(RuntimeError):
    """The worker OS process exited without delivering its result."""

    def __init__(self, worker: int):
        self.worker = worker
        super().__init__(f"worker process {worker} died")


def _child_resolve_bcast(marker, brings, pending_acks):
    """Reconstruct a dispatch payload from the shared broadcast ring:
    attach the segment on first sight (mapped once, reused every
    epoch), unpickle with the slot's read-only views handed back as
    protocol-5 out-of-band buffers (zero copy), and register the
    slot-release ack that fires when the payload's last view dies."""
    _, name, slot_bytes, slots, slot, gen, lens, data = marker
    entry = brings.get(name)
    if entry is None:
        brings[name] = entry = _attach_shm(name)
        for old in [k for k in brings if k != name]:
            del brings[old]  # superseded ring; GC closes once views die
    views = _serve_slot_views(
        entry[1], slot * slot_bytes, lens,
        pending_acks.append, (name, slot, gen),
    )
    return pickle.loads(data, buffers=views)


def _child_ring_result(rring_box, result):
    """Try to stage ``result``'s array buffers in this worker's result
    ring; returns the control marker, or None for in-band pickling
    (small/ineligible result, ring unavailable, or every slot still
    pinned by parent-side views)."""
    try:
        data, views = _encode_oob(result)
    except Exception:
        return None
    if not views:
        return None
    total = sum(v.nbytes for v in views)
    if total < PROC_RING_MIN:
        return None
    ring = rring_box[0]
    if ring is None or ring.slot_bytes < total:
        new = _ShmRing.create(total, PROC_RING_SLOTS)
        if new is None:
            return None
        if ring is not None:
            # parent's mapping (and served views) keep the old pages
            # alive; the parent unlinks it as a safety net at shutdown
            ring.view = None
            try:
                ring.shm.close()
            except BufferError:  # pragma: no cover
                pass
        rring_box[0] = ring = new
    got = ring.alloc.acquire(("parent",))
    if got is None:
        rring_box[1] += 1  # ring-full stall; socket... pipe fallback
        return None
    slot, gen = got
    pos = slot * ring.slot_bytes
    lens = []
    for v in views:
        n = v.nbytes
        ring.view[pos:pos + n] = np.frombuffer(v, np.uint8)
        lens.append(n)
        pos += n
    return (
        _MARK_RESULT, ring.name, ring.slot_bytes, ring.slots, slot,
        gen, tuple(lens), data,
    )


def _worker_main(
    i: int, conn, work_fn: WorkFn, delay_fn: DelayFn | None,
    telemetry: bool = False, shm_rings: bool = True,
) -> None:
    """Worker process entry: the reference's receive -> stall -> compute ->
    send loop (§3.2) over a pipe instead of MPI point-to-point.

    With ``shm_rings`` (the coordinator's default), bulk
    ndarray payloads arrive as read-only views over a shared broadcast
    ring (resolved from a tiny control frame) and bulk results leave
    through this worker's own result ring — the pipe carries only
    control frames and slot-release acks in both directions.

    ``telemetry=True`` (set when the coordinator was constructed with a
    ``registry``) keeps a worker-local
    :class:`~..obs.aggregate.WorkerTelemetry` whose snapshot rides each
    result tuple as a 6th element — tasks/errors counters, compute-wall
    histogram, per-task spans, and the worker-clock stamps the
    coordinator's clock aligner pairs with its own. One final frame is
    sent on the shutdown drain so end-of-run telemetry is not lost."""
    tele = None
    if telemetry:
        from ..obs.aggregate import WorkerTelemetry

        tele = WorkerTelemetry(i)
    brings: dict = {}        # attached broadcast rings, name -> segment
    pending_acks: list = []  # broadcast-slot releases owed to the
    # parent (view finalizers append; NEVER rebind this list — the
    # finalizer callbacks hold it)
    rring_box = [None, 0]    # [result _ShmRing | None, stall count]
    try:
        while True:
            msg = _recv(conn)
            t_recv_w = time.perf_counter() if tele is not None else 0.0
            if msg is None:  # shutdown sentinel (control channel)
                if tele is not None:
                    # drain frame: the last inter-result telemetry
                    _send(conn, (-1, -1, "tele", tele.snapshot(), -1))
                break
            if (
                isinstance(msg, tuple) and len(msg) == 2
                and msg[0] == _MARK_ACK
            ):
                ring = rring_box[0]
                for name, slot, gen in msg[1]:
                    if ring is not None and ring.name == name:
                        ring.alloc.release(slot, gen, "parent")
                continue
            seq, payload, epoch, tag = msg
            stall = 0.0
            if delay_fn is not None:
                d = float(delay_fn(i, epoch))
                if d > 0:
                    stall = d
                    time.sleep(d)
            t0 = time.perf_counter() if tele is not None else 0.0
            try:
                if (
                    isinstance(payload, tuple) and payload
                    and payload[0] == _MARK_BCAST
                ):
                    # resolve INSIDE the capture: a lost segment must
                    # ship back as an error, not kill the worker
                    payload = _child_resolve_bcast(
                        payload, brings, pending_acks
                    )
                result = work_fn(i, payload, epoch)
                payload = None  # release the slot view promptly
                marker = (
                    _child_ring_result(rring_box, result)
                    if shm_rings else None
                )
                if marker is not None:
                    result = marker
                out = (seq, epoch, "ok", result, tag)
                failed = False
            except BaseException as e:
                out = (
                    seq, epoch, "error",
                    (type(e).__name__, str(e), traceback.format_exc()),
                    tag,
                )
                failed = True
            if pending_acks or rring_box[1]:
                recs = pending_acks[:]
                del pending_acks[:len(recs)]
                if rring_box[1]:
                    recs.append(("", -1, rring_box[1]))  # stall report
                    rring_box[1] = 0
                _send(conn, (_MARK_ACK, recs))
            frame = None
            if tele is not None:
                t1 = time.perf_counter()
                tele.task_done(epoch, t0, t1, error=failed, stall=stall)
                # t_send_w stamped by snapshot construction time — the
                # tiny build cost lands in the transport-delay half,
                # where the min-delay offset filter absorbs it
                frame = tele.snapshot(pair=(seq, t_recv_w, t1))
                out = out + (frame,)
            try:
                _send(conn, out)
            except Exception as e:  # result not picklable
                err = (
                    seq, epoch, "error",
                    (type(e).__name__,
                     f"worker result could not be serialized: {e}", ""),
                    tag,
                )
                try:
                    # snapshot() drained the spans destructively;
                    # reattach the SAME frame so the failing task's
                    # span and clock pair survive — the postmortem
                    # case needs them most
                    _send(conn, err if frame is None else err + (frame,))
                except Exception:
                    # the frame itself held the unpicklable value (a
                    # custom span arg): the error result must still
                    # reach the coordinator, not kill the worker
                    _send(conn, err)
    except (EOFError, OSError, KeyboardInterrupt):
        pass
    finally:
        if rring_box[0] is not None:
            rring_box[0].destroy()  # parent holds its own mapping for
            # any still-pinned views; unlink here frees the name (the
            # parent's shutdown unlink is the crash-path safety net)
        conn.close()


class ProcessBackend(SlotBackend):
    """n spawned worker processes computing ``work_fn(i, payload, epoch)``.

    The payload snapshot the reference takes via ``isendbufs[i] .= sendbuf``
    (src/MPIAsyncPools.jl:130) happens here by construction: the payload
    is copied out of the caller's buffer at dispatch time (into the
    shared ring, or by pickling), so in-flight sends survive caller
    mutation. numpy arrays cross zero-conversion; torch tensors cross
    as their host bytes (:func:`..native.codec.dumps`).

    Zero-copy rings (``shm_rings=True``, the default): ndarray payloads and
    results of >= 64 KiB ride ``multiprocessing.shared_memory`` rings
    as pickle protocol-5 out-of-band buffers — ONE memcpy into a ring
    slot per broadcast (shared across all n workers), results
    reconstructed as zero-copy views over the worker's result ring;
    the pipes carry only small control frames and slot-release acks.
    Consequence: bulk arrays now arrive as **read-only views** on both
    sides (the native backend's long-standing contract) — a work_fn
    that mutates its payload in place gets a loud ``ValueError``
    instead of a private copy. Pass ``shm_rings=False`` for the
    classic all-in-band pickling (and its mutable private copies).

    Parameters
    ----------
    work_fn:
        Picklable worker computation ``(worker_index, payload, epoch) ->
        result``.
    n_workers:
        Pool size (= number of spawned processes).
    delay_fn:
        Picklable deterministic latency injection, seconds as a function
        of ``(worker_index, epoch)``, applied *inside* the worker process.
    mp_context:
        ``multiprocessing`` start method; ``"spawn"`` (default) is safe
        with CUDA/threads in the coordinator, ``"fork"`` is faster to boot
        for pure-numpy workers (a forked child of a coordinator that has
        initialised CUDA fails at its first CUDA call).
    registry:
        Opt-in cross-process telemetry (the obs/ contract — None = dark,
        zero cost): worker processes keep a local registry whose
        snapshots piggyback on result frames and merge here under a
        ``worker="<rank>"`` label with counter-delta semantics across
        respawns; worker spans land clock-aligned in
        ``self.aggregator.recorders()`` (one Perfetto pid per worker
        process — :mod:`..obs.aggregate`).
    flight:
        Optional :class:`~..obs.FlightRecorder`: merged worker spans are
        mirrored into the ring so a hang postmortem shows what every
        worker process was doing last.
    exporter:
        Optional :class:`~..obs.ObsServer`: registers the pool's
        worker-deadness health check (``/healthz`` flips when a worker
        dies, recovers after :meth:`respawn`) and the aggregator's
        per-worker trace sources.
    """

    def __init__(
        self,
        work_fn: WorkFn,
        n_workers: int,
        *,
        delay_fn: DelayFn | None = None,
        mp_context: str = "spawn",
        join_timeout: float = 5.0,
        shm_rings: bool = True,
        registry=None,
        flight=None,
        exporter=None,
    ):
        super().__init__(n_workers)
        self.work_fn = work_fn
        self.delay_fn = delay_fn
        self._join_timeout = join_timeout
        self._closed = False
        self._dead = [False] * self.n_workers
        self._send_lock = threading.Lock()
        self._mp_context = mp_context
        ctx = mp.get_context(mp_context)
        self.aggregator = None
        if registry is not None or flight is not None:
            from ..obs.aggregate import TelemetryAggregator

            self.aggregator = TelemetryAggregator(
                registry, flight=flight
            )
        # zero-copy pipe transport state (see class docstring;
        # shm_rings=False restores the classic everything-in-band
        # pickling, including the mutable-payload-copy semantics).
        # Linux-only: the attach side maps segments via /dev/shm (the
        # tracker-safe path), which macOS/Windows shm does not expose —
        # ProcessBackend is the portable fallback backend, so elsewhere
        # it stays the classic pickling transport it always was.
        import sys as _sys

        self._shm_rings = bool(shm_rings) and _sys.platform == "linux"
        self._ring_lock = threading.Lock()  # allocator/ring state is
        # shared between the coordinator thread and reader threads
        self._bring: "_ShmRing | None" = None
        self._bring_retired: list[_ShmRing] = []
        self._pick_epoch = None   # asyncmap epoch cache (begin_epoch)
        self._pick_src = None
        self._pick_marker = None
        # per-worker: result-ack pending lists (finalizers append —
        # cleared in place, never rebound), attached result-ring
        # segments, and every result-ring name ever seen (crash-path
        # unlink safety net)
        self._rack_pending: list[list] = [[] for _ in range(self.n_workers)]
        self._rring_maps: list[dict] = [{} for _ in range(self.n_workers)]
        self._rring_names: list[set] = [set() for _ in range(self.n_workers)]
        self.ring_stats = {
            "bcast_bytes": 0, "result_bytes": 0, "stalls": 0,
        }
        self._registry = registry
        self._rstats_last = dict(self.ring_stats)
        if registry is not None:
            self._m_bcast = registry.counter(
                "transport_zero_copy_bytes_total",
                help="payload bytes served without a userspace copy",
                path="pipe_bcast",
            )
            self._m_result = registry.counter(
                "transport_zero_copy_bytes_total",
                help="payload bytes served without a userspace copy",
                path="pipe_result",
            )
            self._m_stalls = registry.counter(
                "transport_ring_full_stalls_total",
                help="allocations that fell back to in-band pickling "
                "because every slot was pinned",
                side="pipe",
            )
        self._conns = [None] * self.n_workers
        self._procs = [None] * self.n_workers
        self._readers = [None] * self.n_workers
        for i in range(self.n_workers):
            self._spawn_worker(i)
        if exporter is not None:
            exporter.register_backend(self)

    def _spawn_worker(self, i: int) -> None:
        """Start (or restart) worker process i and its reader thread."""
        ctx = mp.get_context(self._mp_context)
        parent, child = ctx.Pipe(duplex=True)
        proc = ctx.Process(
            target=_worker_main,
            args=(i, child, self.work_fn, self.delay_fn,
                  self.aggregator is not None, self._shm_rings),
            daemon=True,
            name=f"pool-proc-worker-{i}",
        )
        proc.start()
        child.close()  # parent keeps only its end; EOF works
        self._conns[i] = parent
        self._procs[i] = proc
        # _dead is written from reader threads too (_on_worker_death);
        # all its writers take the completion lock (GC005)
        with self._cond:
            self._dead[i] = False
        reader = threading.Thread(
            target=self._reader_loop, args=(i,), daemon=True,
            name=f"pool-proc-reader-{i}",
        )
        self._readers[i] = reader
        reader.start()

    def respawn(self, i: int) -> None:
        """Elastic recovery: replace a dead worker process with a fresh
        one on the same rank (the reference has no such capability — a
        dead rank is permanent and hangs ``Waitall!``, SURVEY §5). The
        rank becomes dispatchable again; the old reader thread has
        already exited on its pipe's EOF."""
        if self._closed:
            raise RuntimeError("backend has been shut down")
        if not self._dead[i] and self._procs[i].is_alive():
            raise RuntimeError(f"worker {i} is alive; nothing to respawn")
        if self._procs[i].is_alive():  # pragma: no cover - wedged worker
            self._procs[i].terminate()
        self._procs[i].join(timeout=self._join_timeout)
        old_reader = self._readers[i]
        self._conns[i].close()  # unblock the old reader if still parked
        if old_reader is not None:
            old_reader.join(timeout=self._join_timeout)
        self._spawn_worker(i)

    def reap(self, i: int) -> None:
        """Elastic shrink: deliberately retire worker process ``i`` —
        the pair of :meth:`respawn`, and the verb the fleet
        controller's pool scaler uses (the JAX package's
        ``fleet/failover.py``). The
        worker gets the shutdown sentinel (clean exit, telemetry
        drained), is terminated if it lingers, and the rank reads as
        dead (:meth:`dead_workers`) until a later :meth:`respawn`
        brings a fresh incarnation back. An in-flight dispatch fails
        with ``WorkerProcessDied`` exactly like a crash would — reap
        at an epoch boundary (after ``waitall``) to retire a rank with
        nothing outstanding. Idempotent while already dead."""
        if self._closed:
            raise RuntimeError("backend has been shut down")
        with self._cond:
            if self._dead[i]:
                return
        try:
            with self._send_lock:
                _send(self._conns[i], None)
        except (BrokenPipeError, OSError):
            pass
        proc = self._procs[i]
        proc.join(timeout=self._join_timeout)
        if proc.is_alive():  # pragma: no cover - wedged worker
            proc.terminate()
            proc.join(timeout=self._join_timeout)
        # the reader thread stamps _dead on the pipe's EOF
        # (_on_worker_death) and fails anything outstanding; wait for
        # the stamp so dead_workers() is truthful the moment reap
        # returns (the cond wakes on its own timeout — no notifier
        # needed on the nothing-outstanding path)
        deadline = time.monotonic() + self._join_timeout
        with self._cond:
            while not self._dead[i] and time.monotonic() < deadline:
                self._cond.wait(0.05)
            if not self._dead[i]:  # pragma: no cover - wedged reader
                raise RuntimeError(
                    f"worker {i} terminated but its reader never "
                    "stamped the rank dead — dead_workers() would "
                    "lie, so reap refuses to return"
                )

    # -- coordinator-side completion pump ---------------------------------
    def _reader_loop(self, i: int) -> None:
        conn = self._conns[i]
        agg = self.aggregator
        while True:
            try:
                msg = _recv(conn)
            except (EOFError, OSError):
                self._on_worker_death(i, conn)
                return
            if msg is None:
                return
            if (
                isinstance(msg, tuple) and len(msg) == 2
                and msg[0] == _MARK_ACK
            ):
                # worker released broadcast-ring slots (or reports
                # ring-full stalls: name "", slot -1, count in gen)
                with self._ring_lock:
                    for name, slot, gen in msg[1]:
                        if slot == -1 and name == "":
                            self.ring_stats["stalls"] += int(gen)
                            continue
                        for ring in (
                            [self._bring] if self._bring is not None
                            else []
                        ) + self._bring_retired:
                            if ring.name == name:
                                ring.alloc.release(slot, gen, i)
                    self._gc_retired_locked()
                continue
            t_recv_c = (
                time.perf_counter() if agg is not None else None
            )
            seq, epoch, kind, payload, tag, *tele = msg
            if kind == "tele":  # shutdown-drain telemetry frame
                if agg is not None:
                    agg.merge(i, payload)
                continue
            if agg is not None and tele:
                # merge BEFORE completing: a scrape racing the harvest
                # sees the worker series of every result the pool has
                agg.merge(i, tele[0], t_recv_c=t_recv_c)
            if kind == "error":
                exc_type, message, tb = payload
                payload = WorkerError(
                    i, epoch, RemoteWorkerError(exc_type, message, tb)
                )
            elif (
                isinstance(payload, tuple) and payload
                and payload[0] == _MARK_RESULT
            ):
                payload = self._resolve_result(i, epoch, payload)
            self._complete(i, seq, payload, tag)
            # opportunistic ack flush: result views released since the
            # last dispatch go back now, not an epoch later (finalizers
            # only append to the pending list — no lock hazards)
            self._flush_result_acks(i)

    def _on_worker_death(self, i: int, conn) -> None:
        """Fail the outstanding task (if any) so waits don't hang — the
        capability the reference lacks (dead rank hangs ``Waitall!``)."""
        if self._conns[i] is not conn:
            return  # stale EOF from a pre-respawn incarnation
        # fail the outstanding task on EVERY tag channel: the process is
        # gone, so no channel's completion can ever arrive. The _dead
        # stamp shares the same lock acquisition — this runs on the
        # reader thread while _start/_spawn_worker write the flag from
        # the coordinator (GC005 lock discipline)
        with self._cond:
            self._dead[i] = True
            pending = [
                (tag, slots[i].seq)
                for tag, slots in self._channels.items()
                if slots[i].outstanding and not slots[i].done
            ]
        # a dead worker never acks: reap its broadcast-slot pins so the
        # ring drains (its own result ring died with it). Taken OUTSIDE
        # _cond — lock order is always _ring_lock alone or _cond alone.
        with self._ring_lock:
            if self._bring is not None:
                self._bring.alloc.release_holder_everywhere(i)
            for ring in self._bring_retired:
                ring.alloc.release_holder_everywhere(i)
            self._gc_retired_locked()
        del self._rack_pending[i][:]
        if not self._closed:
            for tag, seq in pending:
                self._complete(
                    i, seq, WorkerError(i, -1, WorkerProcessDied(i)), tag
                )

    def dead_workers(self) -> list[int]:
        """Ranks whose worker process is currently dead (not yet
        respawned) — the ``/healthz`` pool check reads this."""
        with self._cond:
            return [i for i, d in enumerate(self._dead) if d]

    # -- zero-copy ring plumbing ------------------------------------------
    def _resolve_result(self, i: int, epoch: int, marker):
        """Reconstruct a worker's result from its result ring: attach
        the segment on first sight, unpickle over read-only slot views
        (zero copy), register the slot-release ack that fires when the
        harvested arrays die."""
        _, name, slot_bytes, slots, slot, gen, lens, data = marker
        cache = self._rring_maps[i]
        entry = cache.get(name)
        if entry is None:
            try:
                entry = _attach_shm(name)
            except OSError as e:
                return WorkerError(i, epoch, WorkerProcessDied(i)) if (
                    self._dead[i]
                ) else WorkerError(i, epoch, e)
            cache[name] = entry
            with self._ring_lock:
                self._rring_names[i].add(name)
        views = _serve_slot_views(
            entry[1], slot * slot_bytes, lens,
            self._queue_result_ack, i, (name, slot, gen),
        )
        with self._ring_lock:
            self.ring_stats["result_bytes"] += sum(lens)
        return pickle.loads(data, buffers=views)

    def _queue_result_ack(self, i: int, rec) -> None:
        # finalizer callback (any thread): append only — the flush
        # happens at safe points (dispatch / post-complete), never here
        self._rack_pending[i].append(rec)

    def _flush_result_acks(self, i: int) -> None:
        pend = self._rack_pending[i]
        if not pend:
            return
        recs = pend[:]
        del pend[:len(recs)]
        try:
            with self._send_lock:
                _send(self._conns[i], (_MARK_ACK, recs))
        except (BrokenPipeError, OSError, AttributeError):
            pass  # worker gone; its ring died with it

    def _bcast_ctrl(self, i: int, sendbuf, payload, epoch: int):
        """Stage ``payload`` in the shared broadcast ring and return
        the control marker for worker ``i`` (or None = send in-band).
        Inside an asyncmap epoch (begin_epoch) the encode + slot write
        happens ONCE and later dispatches only add their rank as a
        holder — one memcpy per broadcast, like the native arena."""
        cacheable = self._pick_epoch == int(epoch)
        if cacheable and self._pick_src is sendbuf and (
            self._pick_marker is not None
        ):
            marker = self._pick_marker
            with self._ring_lock:
                ring = self._bring
                if ring is not None and ring.name == marker[1]:
                    ring.alloc.add_holder(marker[4], marker[5], i)
                    return marker
            return None  # ring replaced mid-epoch; re-encode
        try:
            data, views = _encode_oob(payload)
        except Exception:
            return None
        if not views:
            return None
        total = sum(v.nbytes for v in views)
        if total < PROC_RING_MIN:
            return None
        with self._ring_lock:
            ring = self._bring
            if ring is None or ring.slot_bytes < total:
                new = _ShmRing.create(total, PROC_RING_SLOTS)
                if new is None:
                    return None
                if ring is not None:
                    self._bring_retired.append(ring)
                self._bring = ring = new
            holders = ("coord", i) if cacheable else (i,)
            got = ring.alloc.acquire(holders)
            if got is None:
                self.ring_stats["stalls"] += 1
                return None
            slot, gen = got
            self.ring_stats["bcast_bytes"] += total
            self._gc_retired_locked()
        pos = slot * ring.slot_bytes  # slot exclusively ours: write
        lens = []                     # outside the lock
        for v in views:
            n = v.nbytes
            ring.view[pos:pos + n] = np.frombuffer(v, np.uint8)
            lens.append(n)
            pos += n
        marker = (
            _MARK_BCAST, ring.name, ring.slot_bytes, ring.slots, slot,
            gen, tuple(lens), data,
        )
        if cacheable:
            with self._ring_lock:
                # a replaced cached marker (direct dispatch of a
                # DIFFERENT buffer at the same epoch) must release its
                # coord pin, or the old slot strands pinned forever
                self._release_pick_locked()
            self._pick_src = sendbuf
            self._pick_marker = marker
        return marker

    def _release_pick_locked(self) -> None:
        """Release the cached marker's ``"coord"`` hold against
        WHICHEVER ring owns it — the current ring, or a retired one
        when the ring grew mid-epoch (caller holds ``_ring_lock``)."""
        marker = self._pick_marker
        if marker is None:
            return
        for ring in (
            [self._bring] if self._bring is not None else []
        ) + self._bring_retired:
            if ring.name == marker[1]:
                ring.alloc.release(marker[4], marker[5], "coord")
                break
        self._gc_retired_locked()

    def _gc_retired_locked(self) -> None:
        """Unlink superseded broadcast rings once drained. The
        ``_locked`` suffix is the contract: EVERY caller already holds
        ``_ring_lock`` (taking it here would self-deadlock), which is
        what the GC005 suppression below records."""
        still = []
        for ring in self._bring_retired:
            if ring.alloc.pinned == 0:
                ring.destroy()
            else:
                still.append(ring)
        self._bring_retired[:] = still  # graftcheck: disable=GC005

    def _publish_ring_stats(self) -> None:
        """Mirror ring stats into the opt-in registry (counter deltas).
        Callers guard on ``self._registry is not None``."""
        with self._ring_lock:
            s = dict(self.ring_stats)
        last = self._rstats_last
        if s["bcast_bytes"] > last["bcast_bytes"]:
            self._m_bcast.inc(s["bcast_bytes"] - last["bcast_bytes"])
        if s["result_bytes"] > last["result_bytes"]:
            self._m_result.inc(s["result_bytes"] - last["result_bytes"])
        if s["stalls"] > last["stalls"]:
            self._m_stalls.inc(s["stalls"] - last["stalls"])
        self._rstats_last = s

    def begin_epoch(self, epoch: int) -> None:
        # arm the one-encode-per-broadcast cache for this asyncmap call
        # (native backend discipline: direct Backend-API dispatches
        # outside an epoch window always re-encode)
        self.end_epoch()
        self._pick_epoch = int(epoch)

    def end_epoch(self) -> None:
        if self._pick_marker is not None:
            with self._ring_lock:
                self._release_pick_locked()
        self._pick_epoch = None
        self._pick_src = None
        self._pick_marker = None

    # -- SlotBackend surface ----------------------------------------------
    def _start(self, i: int, sendbuf, epoch: int, seq: int, tag: int) -> None:
        if self._closed:
            raise RuntimeError("backend has been shut down")
        if self._dead[i]:  # fail fast instead of writing to a broken pipe
            self._complete(
                i, seq, WorkerError(i, epoch, WorkerProcessDied(i)), tag
            )
            return
        payload = sendbuf
        if hasattr(payload, "__array__") and not isinstance(
            payload, (np.ndarray, *_codec.tensor_types())
        ):
            payload = np.asarray(payload)  # device arrays are not picklable
        if self._shm_rings:
            ctrl = self._bcast_ctrl(i, sendbuf, payload, epoch)
            if ctrl is not None:
                payload = ctrl
        if self.aggregator is not None:
            # half of a clock-offset sample; the worker's matching
            # stamps ride back on the result frame
            self.aggregator.note_dispatch(i, seq, time.perf_counter())
        if self._registry is not None:
            self._publish_ring_stats()
        self._flush_result_acks(i)
        try:
            with self._send_lock:
                _send(self._conns[i], (seq, payload, epoch, tag))
        except (BrokenPipeError, OSError):
            with self._cond:  # racing _on_worker_death's stamp (GC005)
                self._dead[i] = True
            self._complete(
                i, seq, WorkerError(i, epoch, WorkerProcessDied(i)), tag
            )

    def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        for i, conn in enumerate(self._conns):
            try:
                with self._send_lock:
                    _send(conn, None)
            except (BrokenPipeError, OSError):
                pass
        for proc in self._procs:
            proc.join(timeout=self._join_timeout)
        for proc in self._procs:
            if proc.is_alive():  # pragma: no cover - stuck worker
                proc.terminate()
                proc.join(timeout=self._join_timeout)  # reap before close
        for proc in self._procs:
            if not proc.is_alive():
                proc.close()  # release the spawn sentinel fds deterministically
        if self.aggregator is not None:
            # the reader threads are the ones merging the workers'
            # shutdown-drain telemetry frames; the workers have exited
            # (pipes at EOF), so the readers finish promptly — join
            # them BEFORE closing the conns, or the final deltas race
            # the close and are lost nondeterministically (the pipe
            # twin of the native backend's _drain_obs)
            for reader in self._readers:
                if reader is not None:
                    reader.join(timeout=self._join_timeout)
        # zero-copy teardown: the coordinator owns the broadcast rings
        # (unlink them); result rings belong to the workers, who unlink
        # on clean exit — unlink any name still present as the
        # crash-path safety net (hard-killed workers skip finally)
        with self._ring_lock:
            if self._bring is not None:
                self._bring.destroy()
                self._bring = None
            for ring in self._bring_retired:
                ring.destroy()
            self._bring_retired = []
        for i in range(self.n_workers):
            for name in list(self._rring_names[i]):
                _unlink_shm_quiet(name)
        for conn in self._conns:
            conn.close()
