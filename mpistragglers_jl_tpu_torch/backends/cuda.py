"""CUDA device backend: pool workers are CUDA streams on one or more cards.

The counterpart of the JAX package's ``backends/xla.py``
``XLADeviceBackend``, with the same constructor and behaviour (payload
cache, coalesced ``flush``, lazy stacked slices, multi-epoch windows,
the failure envelope). The mapping (SURVEY §7):

=====================  ==================================================
reference (MPI)         here (PyTorch/CUDA)
=====================  ==================================================
worker process          a CUDA stream on a card; several pool workers
                        share a card when the pool is larger than the
                        device list (round-robin, the single-card case)
``MPI.Isend``           a copy of the payload made on the worker's
                        stream, ordered after the payload's producer,
                        before ``dispatch`` returns
compute on worker       ``work_fn`` enqueued on the worker's stream
``MPI.Waitany!``        per-worker dispatcher threads wait on a CUDA
                        event recorded after the work (a blocking-sync
                        event: the wait releases the GIL, so n workers
                        wait together) and signal the shared completion
                        condition (backends/base.py)
=====================  ==================================================

As in the reference there is no collective in the straggle-exposed
path: each worker's work is independent, so a slow worker delays nobody
else. Results stay on the device. A result is made on its worker's
stream and read on another, so every consumer goes through
:func:`consume`, which orders the read after the result's event and
tells the caching allocator about the reading stream.

``devices=[torch.device("cpu")]`` is the CPU route: work runs
synchronously in the dispatcher threads, like ``LocalBackend``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..obs.timeline import annotate_if
from .base import _SHUTDOWN, DelayFn, MailboxBackend, WorkerError

__all__ = ["CUDADeviceBackend", "StackedSlice", "WindowHandle", "consume"]


class _Payload:
    """A worker's private copy of ``sendbuf`` and the event recorded
    after the copy (None on the CPU)."""

    __slots__ = ("tensor", "ready")

    def __init__(self, tensor: torch.Tensor, ready):
        self.tensor = tensor
        self.ready = ready


class _BatchDone:
    """A fused-dispatch group handed to a dispatcher thread."""

    __slots__ = ("items", "stacked", "ready")

    def __init__(self, items, stacked, ready):
        self.items = items      # [(worker, seq, payload, epoch, tag)]
        self.stacked = stacked  # enqueued fused result, leading = member
        self.ready = ready      # event after the fused work (None: CPU)


class StackedSlice:
    """A pool worker's lazy view into a fused-dispatch result.

    In batch mode one device program computes every member's result
    stacked on the leading axis. Decode paths that consume the whole
    stack (ops/coded_gemm.py) read ``stacked`` + ``index`` through
    :func:`consume_stack` and never pay for slices; anything else
    (``recvbuf`` bit-copies, generic callers) materializes the row
    through :meth:`materialize`. ``ready`` is the event recorded after
    the fused work: in ``"enqueue"`` mode it is the only ordering there
    is."""

    __slots__ = ("stacked", "index", "ready")

    def __init__(self, stacked: torch.Tensor, index: int, ready=None):
        self.stacked = stacked
        self.index = int(index)
        self.ready = ready

    @property
    def nbytes(self) -> int:  # pool pre-dispatch recvbuf validation
        return int(np.prod(self.shape)) * self.stacked.element_size()

    @property
    def shape(self) -> tuple:
        return tuple(self.stacked.shape[1:])

    @property
    def dtype(self):
        return self.stacked.dtype

    def materialize(self) -> torch.Tensor:
        return consume_stack(self)[self.index]


def consume_stack(result: StackedSlice) -> torch.Tensor:
    """The whole fused stack behind ``result``, safe to read on the
    current stream (see :func:`consume`)."""
    t = result.stacked
    if t.is_cuda:
        cur = torch.cuda.current_stream(t.device)
        if result.ready is not None:
            cur.wait_event(result.ready)
        t.record_stream(cur)
    return t


def consume(result) -> torch.Tensor:
    """The tensor of one pool result, safe to read on the current stream.

    A result is made on its worker's stream. The current stream waits on
    the event after a fused stack (in ``"enqueue"`` mode the work may
    still be running; a per-worker result has already completed when it
    arrives), and the tensor is recorded on the current stream so that
    the caching allocator does not hand its block back to a worker
    stream while a read is still queued."""
    if isinstance(result, StackedSlice):
        return result.materialize()
    t = torch.as_tensor(result)
    if t.is_cuda:
        t.record_stream(torch.cuda.current_stream(t.device))
    return t


class WindowHandle:
    """One asynchronously-dispatched fused multi-epoch program.

    ``outputs`` is whatever the window function returned (enqueued
    tensors); :meth:`harvest` is the single consumption fence for the
    whole K-epoch window — device-side failures surface there, not as
    per-worker completions."""

    __slots__ = ("outputs", "ready", "epoch0", "epochs")

    def __init__(self, outputs, ready, epoch0: int, epochs: int):
        self.outputs = outputs
        self.ready = ready
        self.epoch0 = int(epoch0)
        self.epochs = int(epochs)

    def harvest(self):
        if self.ready is not None:
            self.ready.synchronize()
        return self.outputs


# work_fn(worker_index, device_payload, epoch) -> torch.Tensor on the device
CUDAWorkFn = Callable[[int, torch.Tensor, int], torch.Tensor]


def _on(stream):
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


class CUDADeviceBackend(MailboxBackend):
    """n pool workers enqueuing work on CUDA streams.

    Parameters
    ----------
    work_fn:
        ``work_fn(worker_index, payload, epoch) -> torch.Tensor``. Called
        in the worker's dispatcher thread, under the worker's stream,
        with the payload already copied to the worker's device. It may
        close over per-worker device-resident operands (e.g. a matrix
        block placed at setup time).
    n_workers:
        Pool size. May exceed the device count (workers then share
        devices round-robin — the single-card case).
    devices:
        Devices to map workers onto; defaults to ``[resolve_device()]``,
        the card (an error when there is none).
        ``[torch.device("cpu")]`` runs the work synchronously in the
        dispatcher threads.
    delay_fn:
        Deterministic straggler injection, seconds of host-side stall
        before the work is enqueued, as a function of
        ``(worker, epoch)``.
    batch_fn, batch_arrival:
        Coalesced dispatch, as in the reference: ``batch_fn(worker_ids,
        payload, epoch) -> stacked`` runs once per device per
        :meth:`flush` for all of that device's buffered dispatches.
        ``"ready"``: a dispatcher thread waits on the event after the
        fused work, then posts every member's completion (true arrival
        detection). ``"enqueue"``: completions post as soon as the
        fused work is enqueued; successive epochs pipeline on the card,
        and device-side failures surface at the consumer's
        synchronisation, not as a per-worker ``WorkerFailure``.
        Incompatible with ``delay_fn``.
    """

    def __init__(
        self,
        work_fn: CUDAWorkFn,
        n_workers: int,
        *,
        devices: Sequence | None = None,
        delay_fn: DelayFn | None = None,
        batch_fn=None,
        batch_arrival: str = "ready",
    ):
        if batch_fn is not None and delay_fn is not None:
            raise ValueError(
                "batch_fn coalesces a device's workers into one program; "
                "per-worker delay_fn injection cannot apply inside it"
            )
        if batch_arrival not in ("ready", "enqueue"):
            raise ValueError(
                f"batch_arrival must be 'ready'|'enqueue', got {batch_arrival!r}"
            )
        self.batch_arrival = batch_arrival
        self.batch_fn = batch_fn
        self._pending: list = []  # buffered dispatches awaiting flush()
        if devices is None:
            devices = [resolve_device()]
        devices = [resolve_device(d) for d in devices]
        self.devices = [devices[i % len(devices)] for i in range(n_workers)]
        self.work_fn = work_fn
        # one stream per worker, created on first use (never at import
        # or construction)
        self._streams: list = [None] * n_workers
        # (device, epoch) -> payload copy, armed only inside asyncmap
        # (begin_epoch .. end_epoch), where the single-threaded
        # coordinator cannot mutate sendbuf mid-call: workers sharing a
        # device share one copy
        self._payload_cache: dict = {}
        self._cache_armed = False
        super().__init__(
            n_workers, delay_fn=delay_fn, join_timeout=5.0,
            thread_name="cuda-worker",
        )

    def stream(self, i: int):
        """Worker ``i``'s CUDA stream (None for a CPU worker)."""
        dev = self.devices[i]
        if dev.type != "cuda":
            return None
        if self._streams[i] is None:
            self._streams[i] = torch.cuda.Stream(device=dev)
        return self._streams[i]

    # -- payload snapshot -------------------------------------------------
    def _snapshot(self, i: int, sendbuf, epoch: int) -> _Payload:
        if not self._cache_armed:
            return self._copy(i, sendbuf)
        key = (self.devices[i], epoch)
        payload = self._payload_cache.get(key)
        if payload is None:
            with annotate_if(self.spans, "mp.backend.copy"):
                payload = self._payload_cache[key] = self._copy(i, sendbuf)
        return payload

    def _copy(self, i: int, sendbuf) -> _Payload:
        """The worker's private copy of ``sendbuf``, complete or ordered
        before any later write to ``sendbuf`` when this returns.

        A host buffer is copied before return (a blocking H2D copy, or
        a host clone). A CUDA tensor is cloned on the worker's stream
        after its producer (the current stream), and the current stream
        then waits on the copy, so a write the caller enqueues after
        ``asyncmap`` returns cannot reach it."""
        dev = self.devices[i]
        s = self.stream(i)
        if isinstance(sendbuf, torch.Tensor):
            src = sendbuf.detach()
        else:
            src = torch.as_tensor(np.asarray(sendbuf))
        if s is None:
            return _Payload(src.to(dev, copy=True), None)
        producer = torch.cuda.current_stream(src.device) if src.is_cuda else None
        if producer is not None:
            s.wait_stream(producer)
        with torch.cuda.stream(s):
            t = src.to(dev, copy=True)
        ready = torch.cuda.Event()
        ready.record(s)
        if producer is not None:
            producer.wait_event(ready)
            if src.device == dev:
                src.record_stream(s)
        return _Payload(t, ready)

    @staticmethod
    def _enter(s, payload: _Payload):
        """Order work on stream ``s`` after the payload copy (which may
        have been made on another worker's stream) and keep the copy's
        block alive for it."""
        if s is not None:
            s.wait_event(payload.ready)
            payload.tensor.record_stream(s)
        return _on(s)

    def _compute(self, i: int, payload: _Payload, epoch: int):
        s = self.stream(i)
        with self._enter(s, payload):
            result = self.work_fn(i, payload.tensor, epoch)
        if s is not None:
            # this thread is the arrival detector: a blocking-sync
            # event's wait releases the GIL, so n workers wait together
            done = torch.cuda.Event(blocking=True)
            done.record(s)
            done.synchronize()
        return result

    # -- coalesced dispatch (batch_fn mode) -------------------------------
    def _start(self, i: int, sendbuf, epoch: int, seq: int, tag: int) -> None:
        if self.batch_fn is None:
            super()._start(i, sendbuf, epoch, seq, tag)
            return
        if self._closed:
            raise RuntimeError("backend has been shut down")
        payload = self._snapshot(i, sendbuf, epoch)
        self._pending.append((i, seq, payload, epoch, tag))

    def test(self, i: int, *, tag: int = 0):
        self.flush()  # a phase-3 re-task may be sitting in the buffer
        return super().test(i, tag=tag)

    def wait_any(self, indices, timeout=None, *, tags=None):
        self.flush()
        return super().wait_any(indices, timeout, tags=tags)

    def wait(self, i: int, timeout: float | None = None, *, tag: int = 0):
        self.flush()
        return super().wait(i, timeout, tag=tag)

    def flush(self) -> None:
        if self.batch_fn is None or not self._pending:
            return
        pending, self._pending = self._pending, []
        with annotate_if(self.spans, "mp.pool.flush"):
            self._submit(pending)

    def _submit(self, pending: list) -> None:
        # one fused program per (device, payload, epoch): members of a
        # group share the payload copy and the epoch (asyncmap's
        # broadcast shares one copy per device, so an epoch is one
        # group per device)
        groups: dict = {}
        for item in pending:
            key = (self.devices[item[0]], id(item[2]), item[3])
            groups.setdefault(key, []).append(item)
        for dev_items in groups.values():
            ids = tuple(item[0] for item in dev_items)
            _, _, payload, epoch, _ = dev_items[0]
            s = self.stream(ids[0])
            try:
                with self._enter(s, payload):
                    stacked = self.batch_fn(ids, payload.tensor, epoch)
            except Exception as e:
                # a failed submission must not strand the group's slots
                # outstanding (waitall would hang forever) — fail every
                # member the way the worker loop does
                for w, seq, _, _ep, tag in dev_items:
                    self._complete(w, seq, WorkerError(w, epoch, e), tag)
                continue
            ready = None
            if s is not None:
                ready = torch.cuda.Event(blocking=True)
                ready.record(s)
            if self.batch_arrival == "enqueue":
                # enqueued = arrived; the consumer orders its reads
                # after ``ready`` (consume_stack)
                for j, (w, seq, _, _ep, tag) in enumerate(dev_items):
                    self._complete(w, seq, StackedSlice(stacked, j, ready), tag)
                continue
            # the first member's dispatcher thread becomes the arrival
            # detector for the whole group
            self._mailboxes[ids[0]].put(
                (_BatchDone(dev_items, stacked, ready), None, None, None)
            )

    def _worker_loop(self, i: int) -> None:  # overrides MailboxBackend
        if self.batch_fn is None:
            super()._worker_loop(i)
            return
        mbox = self._mailboxes[i]
        while True:
            msg = mbox.get()
            if msg is _SHUTDOWN:
                return
            batch = msg[0]
            try:
                if batch.ready is not None:
                    batch.ready.synchronize()
            except Exception as e:  # surfaced on harvest, not lost
                for w, seq, _, epoch, tag in batch.items:
                    self._complete(w, seq, WorkerError(w, epoch, e), tag)
                continue
            for j, (w, seq, _, _ep, tag) in enumerate(batch.items):
                self._complete(
                    w, seq, StackedSlice(batch.stacked, j, batch.ready), tag
                )

    # -- multi-epoch dispatch (fused K-epoch windows) ---------------------
    def submit_window(self, window_fn, *args, epoch0: int, epochs: int):
        """Multi-epoch dispatch: ONE asynchronous submission covering
        ``epochs`` epochs, with no per-epoch ``_start`` / mailbox
        round-trips and no dispatcher-thread arrival detection. The
        returned :class:`WindowHandle`'s ``harvest()`` is the one fence.
        A submission failure raises through :class:`~.base.WorkerError`
        (worker ``-1``: a fused window has no single owning worker), the
        same :class:`~.base.WorkerFailure` surface as per-epoch
        dispatch."""
        if self._closed:
            raise RuntimeError("backend has been shut down")
        try:
            out = window_fn(*args)  # asynchronous: returns enqueued tensors
        except Exception as e:
            WorkerError(-1, int(epoch0), e).raise_()
        dev = self.devices[0]
        ready = None
        if dev.type == "cuda":
            ready = torch.cuda.Event(blocking=True)
            ready.record(torch.cuda.current_stream(dev))
        return WindowHandle(out, ready, int(epoch0), int(epochs))

    def begin_epoch(self, epoch: int) -> None:
        # arm the shared-payload cache for this asyncmap call
        self._payload_cache = {}
        self._cache_armed = True

    def end_epoch(self) -> None:
        # disarm when asyncmap returns: a later direct dispatch of a
        # mutated buffer gets a fresh copy (base.py end_epoch), and the
        # cached copy is not pinned between calls
        self._payload_cache = {}
        self._cache_armed = False
