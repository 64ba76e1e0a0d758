"""Backend protocol: the transport layer under :mod:`..pool`.

A copy of the JAX package's ``backends/base.py``, which imports no JAX;
the port keeps its own so that it imports nothing of that package.

A backend plays the role the ``comm: MPI.Comm`` argument plays in the
reference (src/MPIAsyncPools.jl:68): it owns the in-flight request state
(the reference's ``sreqs``/``rreqs`` vectors, src/MPIAsyncPools.jl:26-27)
and provides the completion primitives the pool's three phases need:

==============  =========================================================
pool phase       backend primitive        reference analog
==============  =========================================================
phase 1 drain    ``test(i)``              ``MPI.Test!`` (:99)
phase 2 send     ``dispatch(i, ...)``     ``MPI.Isend``/``Irecv!`` (:137-138)
phase 3 wait     ``wait_any(indices)``    ``MPI.Waitany!`` (:161)
waitall          ``wait(i, timeout)``     ``MPI.Waitall!`` (:212)
shutdown         ``shutdown()``           control-channel broadcast
                                          (test/kmap2.jl:14-18)
==============  =========================================================

:class:`SlotBackend` is a shared implementation skeleton: one *slot* per
(worker, tag) holding at most one outstanding task (the pool's ``active``
flag discipline guarantees single occupancy per channel), a completion
event per slot, and a condition variable notified on every completion so
``wait_any`` can sleep instead of spinning. Subclasses only implement how
a task actually runs (thread compute, CUDA stream dispatch, ...).

Tags multiplex independent message channels over one backend, exactly as
MPI tags multiplex one communicator (the reference separates data and
control streams by tag — test/kmap2.jl:11-12 — and two pools can share a
comm on distinct tags). Each tag is an isolated channel: its own slots,
its own completions; a dispatch on tag 1 can be in flight to the same
worker as a dispatch on tag 0, and results never cross channels.
"""

from __future__ import annotations

import queue
import threading
import time
from abc import ABC, abstractmethod
from typing import Callable, Sequence

DelayFn = Callable[[int, int], float]

_SHUTDOWN = object()


class Deadline:
    """Shared remaining-time arithmetic for timeout-capable waits.

    ``Deadline(None)`` never expires and ``remaining()`` stays None
    (block forever); otherwise ``remaining()`` is clamped to >= 0 so it
    can be handed to any wait primitive directly.
    """

    __slots__ = ("_at",)

    def __init__(self, timeout: float | None):
        self._at = (
            None if timeout is None else time.perf_counter() + timeout
        )

    def remaining(self) -> float | None:
        if self._at is None:
            return None
        return max(self._at - time.perf_counter(), 0.0)



class DeadWorkerError(TimeoutError):
    """Raised when workers fail to respond in time: by ``asyncmap``
    (with ``timeout=``) and ``waitall`` at the pool layer, and by
    ``on_dead="straggle"`` backends when an unbounded wait would
    otherwise block forever on only-dead ranks.

    The reference has no failure detection: a dead worker is
    indistinguishable from an infinite straggler and ``waitall!`` hangs
    on it (SURVEY §5). Defined here, beside the Backend contract, so
    backends never import the orchestration layer above them.
    """

    def __init__(self, dead, timeout):
        self.dead = [int(d) for d in dead]  # backend ranks still active
        self.timeout = timeout
        tail = (
            f"within {timeout} s" if timeout is not None
            else "(unbounded wait, all awaited ranks dead)"
        )
        super().__init__(f"workers {self.dead} did not respond {tail}")


class WorkerFailure(RuntimeError):
    """A worker raised during compute; re-raised coordinator-side at
    harvest (the reference loses worker errors entirely — assertions die
    inside mpiexec subprocesses, SURVEY §4)."""

    def __init__(self, worker: int, epoch: int, error: BaseException):
        self.worker = worker
        self.epoch = epoch
        self.error = error
        super().__init__(f"worker {worker} failed at epoch {epoch}: {error!r}")


class WorkerError:
    """Marker carrying a captured worker exception to the coordinator."""

    __slots__ = ("worker", "epoch", "error")

    def __init__(self, worker: int, epoch: int, error: BaseException):
        self.worker = worker
        self.epoch = epoch
        self.error = error

    def raise_(self) -> None:
        raise WorkerFailure(self.worker, self.epoch, self.error)


class Backend(ABC):
    """Minimal transport interface consumed by ``asyncmap``/``waitall``."""

    n_workers: int
    # True for the length of an ``asyncmap`` call whose tracer asks for
    # spans: the backend then opens its ``mp.*`` ranges
    # (``obs.timeline.annotate``) on the coordinator's thread
    spans: bool = False

    @abstractmethod
    def dispatch(self, i: int, sendbuf, epoch: int, *, tag: int = 0) -> None:
        """Start asynchronous work on worker ``i`` with a *snapshot* of
        ``sendbuf`` (the reference's ``isendbufs[i] .= sendbuf`` discipline,
        src/MPIAsyncPools.jl:130 — here the backend owns the snapshot)."""

    @abstractmethod
    def test(self, i: int, *, tag: int = 0):
        """Non-blocking completion probe on channel ``tag``. Returns the
        result exactly once if worker ``i`` has completed, else None
        (``MPI.Test!``)."""

    @abstractmethod
    def wait_any(
        self,
        indices: Sequence[int],
        timeout: float | None = None,
        *,
        tags: Sequence[int] | None = None,
    ) -> tuple[int, object] | None:
        """Block until any worker in ``indices`` completes on its paired
        channel; return ``(i, result)`` (``MPI.Waitany!``), or None if
        ``timeout`` seconds elapse first. ``tags`` aligns with
        ``indices`` (None = all on tag 0) — the in-flight request for
        worker ``indices[j]`` is the one dispatched with ``tags[j]``,
        mirroring MPI requests remembering the tag they were posted
        with."""

    @abstractmethod
    def wait(self, i: int, timeout: float | None = None, *, tag: int = 0):
        """Block until worker ``i`` completes on channel ``tag``; return
        its result, or None on timeout (building block for
        ``MPI.Waitall!``-style drains)."""

    def flush(self) -> None:  # pragma: no cover - default no-op
        """Called by ``asyncmap`` after its dispatch phase (and by
        ``waitall`` before draining): backends that coalesce dispatches
        (e.g. one fused device program for all pool workers sharing a
        card — CUDADeviceBackend's batch mode) submit the coalesced work
        here. The reference analog is a no-op: its Isends are already
        posted individually."""

    def shutdown(self) -> None:  # pragma: no cover - default no-op
        """Release worker resources (the reference's control-channel
        shutdown broadcast, examples/iterative_example.jl:50-52)."""

    def begin_epoch(self, epoch: int) -> None:  # pragma: no cover - no-op
        """Called by ``asyncmap`` once per call, before any dispatch.
        Backends may use it to reset per-epoch state (e.g. the CUDA
        backend's shared-payload snapshot cache)."""

    def end_epoch(self) -> None:  # pragma: no cover - default no-op
        """Called by ``asyncmap`` when the call finishes (including on
        error). Backends disarm any per-epoch fast paths here so direct
        Backend-API dispatches between calls see full snapshot
        semantics."""


class _Slot:
    """One in-flight task slot. At most one outstanding task per worker."""

    __slots__ = ("seq", "done", "result", "outstanding")

    def __init__(self):
        self.seq = 0  # dispatch sequence number, guards late completions
        self.done = False
        self.result = None
        self.outstanding = False


class SlotBackend(Backend):
    """Completion-event machinery shared by concrete backends.

    Slots are per (worker, tag): ``_channels[tag]`` is a full worker-width
    slot vector, created lazily the first time a tag is used. Channel 0
    always exists (the default-tag fast path)."""

    def __init__(self, n_workers: int):
        self.n_workers = int(n_workers)
        self._channels: dict[int, list[_Slot]] = {
            0: [_Slot() for _ in range(self.n_workers)]
        }
        self._cond = threading.Condition()

    def _chan(self, tag: int) -> list[_Slot]:
        """Slot vector for ``tag``; caller must hold ``self._cond``."""
        slots = self._channels.get(tag)
        if slots is None:
            slots = [_Slot() for _ in range(self.n_workers)]
            self._channels[tag] = slots
        return slots

    # -- subclass surface -------------------------------------------------
    @abstractmethod
    def _start(self, i: int, sendbuf, epoch: int, seq: int, tag: int) -> None:
        """Begin asynchronous execution; must eventually call
        ``self._complete(i, seq, result, tag)`` from any thread."""

    # -- completion plumbing ---------------------------------------------
    def _complete(self, i: int, seq: int, result, tag: int = 0) -> None:
        with self._cond:
            slot = self._chan(tag)[i]
            if slot.seq != seq or not slot.outstanding:
                return  # stale completion from a superseded dispatch
            slot.result = result
            slot.done = True
            self._cond.notify_all()

    def _take(self, slot: _Slot):
        result = slot.result
        slot.result = None
        slot.done = False
        slot.outstanding = False
        return result

    # -- Backend interface ------------------------------------------------
    def dispatch(self, i: int, sendbuf, epoch: int, *, tag: int = 0) -> None:
        tag = int(tag)
        with self._cond:
            slot = self._chan(tag)[i]
            if slot.outstanding:
                raise RuntimeError(
                    f"worker {i} already has an outstanding task on tag "
                    f"{tag}; the pool must only dispatch to inactive workers"
                )
            slot.seq += 1
            slot.done = False
            slot.result = None
            slot.outstanding = True
            seq = slot.seq
        try:
            self._start(i, sendbuf, epoch, seq, tag)
        except BaseException:
            # roll the slot back: a task that never started must not leave
            # an outstanding slot that wait/wait_any would block on forever
            with self._cond:
                if slot.seq == seq:
                    slot.outstanding = False
            raise

    def test(self, i: int, *, tag: int = 0):
        with self._cond:
            slot = self._chan(int(tag))[i]
            if slot.outstanding and slot.done:
                return self._take(slot)
            return None

    def wait_any(
        self,
        indices: Sequence[int],
        timeout: float | None = None,
        *,
        tags: Sequence[int] | None = None,
    ) -> tuple[int, object] | None:
        idx = [int(i) for i in indices]
        if not idx:
            raise ValueError("wait_any over an empty index set would hang")
        tgs = [0] * len(idx) if tags is None else [int(t) for t in tags]
        if len(tgs) != len(idx):
            raise ValueError("tags must align one-to-one with indices")
        ready: list[tuple[int, _Slot]] = []

        def scan() -> bool:
            for i, t in zip(idx, tgs):
                slot = self._chan(t)[i]
                if slot.outstanding and slot.done:
                    ready.append((i, slot))
                    return True
            return False

        with self._cond:
            if not self._cond.wait_for(scan, timeout=timeout):
                return None
            i, slot = ready[-1]
            return i, self._take(slot)

    def wait(self, i: int, timeout: float | None = None, *, tag: int = 0):
        with self._cond:
            slot = self._chan(int(tag))[i]
            if not slot.outstanding:
                raise RuntimeError(
                    f"worker {i} has no outstanding task on tag {int(tag)}"
                )
            ok = self._cond.wait_for(lambda: slot.done, timeout=timeout)
            if not ok:
                return None
            return self._take(slot)


class MailboxBackend(SlotBackend):
    """Worker-loop skeleton: one dispatcher thread + depth-1 mailbox each.

    This is the reference's worker-side convention (receive -> optional
    injected stall -> compute -> deliver, with a control channel for
    shutdown; examples/iterative_example.jl:55-82, SURVEY §3.2) made a
    first-class, reusable library component. The depth-1 mailbox models
    an ``MPI.Isend`` whose matching ``Irecv!`` the worker only posts
    after finishing its previous compute; the shutdown sentinel is the
    control-tag broadcast (test/kmap2.jl:14-18).

    Subclasses implement:

    * ``_snapshot(i, sendbuf, epoch)`` — produce the private payload
      snapshot enqueued to the worker (the reference's ``isendbuf``
      discipline, src/MPIAsyncPools.jl:63-66,:130);
    * ``_compute(i, payload, epoch)`` — the worker computation.
    """

    def __init__(
        self,
        n_workers: int,
        *,
        delay_fn: DelayFn | None = None,
        join_timeout: float = 2.0,
        thread_name: str = "pool-worker",
    ):
        super().__init__(n_workers)
        self.delay_fn = delay_fn
        self._closed = False
        self._join_timeout = join_timeout
        # unbounded: occupancy is bounded by the slot discipline at one
        # outstanding task per (worker, tag) channel, so the queue holds
        # at most n_tags-in-use messages — a fixed depth-1 box would
        # deadlock the coordinator when a second channel dispatches while
        # the worker is busy with the first
        self._mailboxes: list[queue.Queue] = [
            queue.Queue() for _ in range(n_workers)
        ]
        self._threads = [
            threading.Thread(
                target=self._worker_loop, args=(i,), daemon=True,
                name=f"{thread_name}-{i}",
            )
            for i in range(n_workers)
        ]
        for t in self._threads:
            t.start()

    @abstractmethod
    def _snapshot(self, i: int, sendbuf, epoch: int):
        ...

    @abstractmethod
    def _compute(self, i: int, payload, epoch: int):
        ...

    def _worker_loop(self, i: int) -> None:
        mbox = self._mailboxes[i]
        while True:
            msg = mbox.get()
            if msg is _SHUTDOWN:
                return
            seq, payload, epoch, tag = msg
            if self.delay_fn is not None:
                d = float(self.delay_fn(i, epoch))
                if d > 0:
                    time.sleep(d)
            try:
                result = self._compute(i, payload, epoch)
            except BaseException as e:  # surfaced on harvest, not lost
                result = WorkerError(i, epoch, e)
            self._complete(i, seq, result, tag)

    def _start(self, i: int, sendbuf, epoch: int, seq: int, tag: int) -> None:
        if self._closed:
            raise RuntimeError("backend has been shut down")
        payload = self._snapshot(i, sendbuf, epoch)
        self._mailboxes[i].put((seq, payload, epoch, tag))

    def shutdown(self) -> None:
        self._closed = True
        for mbox in self._mailboxes:
            mbox.put_nowait(_SHUTDOWN)
        for t in self._threads:
            t.join(timeout=self._join_timeout)
