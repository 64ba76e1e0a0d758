"""Core pool state machine and async scatter/gather with fastest-k return.

A copy of the JAX package's ``pool.py`` (the reference library's whole
L2 layer, src/MPIAsyncPools.jl:24-224), with one change the card forces:
a ``recvbuf`` arrival that is a torch tensor crosses to the host as its
bytes (``t.contiguous().view(torch.uint8).cpu()``), because
``np.ascontiguousarray`` cannot read a CUDA tensor and numpy has no
bf16. The copy stays bit-exact, never value-cast, for every dtype.
torch is not imported here: an arrival can only be a tensor if the
process imported torch, so a pool over host workers stays torch-free,
as the reference's pool stays jax-free.

The behavioral contract is the reference's — per-worker epoch
bookkeeping, fastest-k or predicate-driven return, stale-result
harvesting with immediate re-tasking, and a quiescence barrier — with
the transport abstracted behind a :class:`Backend` (the analog of the
``comm: MPI.Comm`` argument, reference src/MPIAsyncPools.jl:68), so the
same pool drives thread workers (``backends/local.py``) or CUDA streams
on one or more cards (``backends/cuda.py``).

* **No caller-managed ``isendbuf``/``irecvbuf``.** The backend owns the
  payload snapshot: it copies ``sendbuf`` before ``dispatch`` returns,
  so the caller may mutate it right after ``asyncmap``.
* **Results may stay on device.** ``recvbuf`` is optional; when omitted,
  per-worker results are retained as (possibly device-resident) tensors
  in ``pool.results`` so a decode/combine step can consume them without a
  host round-trip. When provided, ``recvbuf`` is byte-partitioned into
  ``n_workers`` equal chunks exactly like ``MPI.Gather!`` over the
  reference's ``reinterpret(UInt8, ...)`` views (src/MPIAsyncPools.jl:58-61,
  :80-84) and arrivals are *bit-copied* into their chunk.
* **The hot wait loop** (reference ``MPI.Waitany!``, src/MPIAsyncPools.jl:161)
  becomes host-side waiting on per-dispatch completion events — see
  backends.

State-machine invariants preserved exactly (reference §2.1 semantics):

* each ``asyncmap`` call *is* an epoch; default ``epoch = pool.epoch + 1``
  but any value may be passed (src/MPIAsyncPools.jl:68, :87);
* ``repochs[i] == epoch0`` means "never heard from worker i"
  (src/MPIAsyncPools.jl:39; test/kmap2.jl:42-44);
* with integer ``nwait``, only phase-3 arrivals stamped with the *current*
  epoch count toward completion (src/MPIAsyncPools.jl:173-176); stale
  arrivals are written to ``recvbuf``, stamped in ``repochs``, and the
  worker is immediately re-tasked with the current payload and stays
  active (src/MPIAsyncPools.jl:177-184);
* a functional ``nwait`` is evaluated as ``nwait(epoch, repochs)`` before
  the first wait and after every arrival, over the live ``repochs``
  (src/MPIAsyncPools.jl:148-158);
* after ``waitall``, no worker is active (src/MPIAsyncPools.jl:193).
"""

from __future__ import annotations

import time
from typing import Callable, Sequence, Union

import numpy as np

from .backends.base import (  # noqa: F401  (DeadWorkerError re-export)
    Backend,
    Deadline,
    DeadWorkerError,
    WorkerError,
)
from .native.codec import tensor_types
from .obs.timeline import annotate_if

NwaitArg = Union[int, Callable[[int, np.ndarray], bool]]

__all__ = ["AsyncPool", "asyncmap", "asyncmap_fused", "waitall"]


class AsyncPool:
    """Bookkeeping for a pool of potentially-straggling workers.

    Mirrors the reference ``MPIAsyncPool`` struct field-for-field
    (src/MPIAsyncPools.jl:24-46) minus the MPI request handles, which live
    in the backend:

    ``ranks``        worker ids managed by the pool; pool index ``i`` maps
                     to ``ranks[i]`` and ``recvbuf`` chunk order is *pool*
                     order, not rank order.
    ``sepochs[i]``   epoch at which the in-flight dispatch to worker ``i``
                     was initiated.
    ``stags[i]``     tag the in-flight dispatch was posted with — the
                     analog of an MPI request remembering its tag, so
                     harvests probe the right backend channel even when
                     pools multiplex one backend on distinct tags
                     (reference convention: test/kmap2.jl:11-12).
    ``repochs[i]``   epoch of the most recently received result — the
                     freshness oracle returned to callers.
    ``active[i]``    True iff worker ``i`` has an outstanding task.
    ``stimestamps``  perf-counter ns at dispatch.
    ``latency[i]``   last measured round-trip seconds per worker.
    ``nwait``        default wait-count (ctor kwarg, default ``n``).
    ``epoch``        current epoch, starts at ``epoch0``.

    Construction performs no communication; the pool is lazy like the
    reference (first backend activity happens inside the first
    ``asyncmap`` — reference §3.4).
    """

    def __init__(
        self,
        ranks: Union[int, Sequence[int]],
        *,
        epoch0: int = 0,
        nwait: int | None = None,
    ):
        if isinstance(ranks, (int, np.integer)):
            # convenience form, reference src/MPIAsyncPools.jl:46 (ranks 1:n
            # there; 0-based 0:n here, idiomatic for device indices)
            ranks = list(range(int(ranks)))
        self.ranks: list[int] = [int(r) for r in ranks]
        if len(set(self.ranks)) != len(self.ranks):
            raise ValueError(f"ranks must be unique, got {self.ranks}")
        if self.ranks and min(self.ranks) < 0:
            raise ValueError(f"ranks must be >= 0, got {self.ranks}")
        # pool index <-> backend rank: every backend call below routes
        # through ranks[i], so a pool over a rank SUBSET of a shared
        # backend addresses exactly those workers (reference
        # src/MPIAsyncPools.jl:21 `MPIAsyncPool([1,4,5])`, routed at
        # :137-138 — the pool sends to ranks[i], not to i)
        self._idx_of_rank = {r: j for j, r in enumerate(self.ranks)}
        n = len(self.ranks)
        if nwait is None:
            nwait = n
        if not (0 <= int(nwait) <= n):
            raise ValueError(f"default nwait must be in [0, {n}], got {nwait}")
        self.sepochs = np.full(n, epoch0, dtype=np.int64)
        self.stags = np.zeros(n, dtype=np.int64)
        self.repochs = np.full(n, epoch0, dtype=np.int64)
        self.active = np.zeros(n, dtype=bool)
        self.stimestamps = np.zeros(n, dtype=np.int64)
        self.latency = np.zeros(n, dtype=np.float64)
        self.nwait = int(nwait)
        self.epoch = int(epoch0)
        self.epoch0 = int(epoch0)
        # most recently received result object per worker (device tensor
        # or ndarray); None = never received. Lets decode steps consume
        # device-resident shards without a recvbuf copy.
        self.results: list = [None] * n

    @property
    def n_workers(self) -> int:
        return len(self.ranks)

    def fresh_indices(self, epoch: int | None = None) -> np.ndarray:
        """Workers whose latest *stored* result is from ``epoch``
        (default: the current one) — the decode-selection mask.

        ``repochs[i] == epoch`` alone is not sufficient: at
        ``epoch == epoch0`` it also matches workers never heard from
        (``repochs`` initializes to ``epoch0``, reference
        src/MPIAsyncPools.jl:39), whose ``results[i]`` is still None.
        Every coded workload selects shards through this method so that
        invariant lives in one place.
        """
        if epoch is None:
            epoch = self.epoch
        heard = np.array(
            [r is not None for r in self.results], dtype=bool
        )
        return np.flatnonzero((self.repochs == epoch) & heard)

    def reset_worker(self, i: int) -> None:
        """Elastic-recovery hook: forget worker ``i``'s in-flight task.

        Use after a dead rank rejoins (``backend.reaccept``/``respawn``
        under ``on_dead="straggle"``): the old incarnation's dispatch
        can never complete, so the worker must be marked idle to become
        dispatchable next epoch. ``repochs`` keeps its last truthful
        value — the rank is simply stale until it answers again.
        """
        self.active[int(i)] = False

    def carry(self, ranks, *, nwait: int | None = None) -> "AsyncPool":
        """Elastic-resize hook: a NEW pool over ``ranks`` carrying this
        pool's epoch bookkeeping onto the resized rank set (the
        fleet-controller pair of :meth:`reset_worker`).

        Surviving ranks keep their ``sepochs``/``stags``/``repochs``/
        ``active``/``latency``/``results`` — an in-flight dispatch to a
        kept rank stays harvestable by the same backend on the same tag
        channel. Joining ranks initialize never-heard-from (``repochs
        == epoch0``): stale until they answer, exactly like a respawned
        rank under ``reset_worker``. Dropped ranks' state leaves with
        them (their worker processes are being reaped). ``nwait``
        defaults to the old value clamped into the new pool's range —
        pass it explicitly when the resize changes the decodability
        floor (the fleet controller re-derives it via
        ``sweep_hierarchical``).
        """
        if isinstance(ranks, (int, np.integer)):
            ranks = list(range(int(ranks)))
        ranks = [int(r) for r in ranks]
        new = AsyncPool(
            ranks,
            epoch0=self.epoch0,
            nwait=(
                min(self.nwait, len(ranks)) if nwait is None else nwait
            ),
        )
        new.epoch = self.epoch
        for j, r in enumerate(new.ranks):
            i = self._idx_of_rank.get(r)
            if i is None:
                continue
            new.sepochs[j] = self.sepochs[i]
            new.stags[j] = self.stags[i]
            new.repochs[j] = self.repochs[i]
            new.active[j] = self.active[i]
            new.stimestamps[j] = self.stimestamps[i]
            new.latency[j] = self.latency[i]
            new.results[j] = self.results[i]
        return new

    def __repr__(self) -> str:
        return (
            f"AsyncPool(n={self.n_workers}, epoch={self.epoch}, "
            f"nwait={self.nwait}, active={int(self.active.sum())})"
        )


def _recv_chunks(recvbuf: np.ndarray | None, n: int) -> list[np.ndarray] | None:
    """Partition ``recvbuf`` into n equal *byte* chunks, ``MPI.Gather!``
    layout.

    Reference parity: the reference type-erases every caller buffer via
    ``reinterpret(UInt8, ...)`` and slices bytes
    (src/MPIAsyncPools.jl:80-84, :206-209), which makes a pool
    payload-agnostic — mixed dtypes, structured records, anything with a
    fixed byte layout round-trips bit-exactly. Arrivals are **bit-copied**
    into their chunk (never value-cast): a worker result whose byte size
    doesn't fill the chunk is an error, not a silent ``astype``.
    """
    if recvbuf is None:
        return None
    if not isinstance(recvbuf, np.ndarray):
        raise TypeError("recvbuf must be a numpy ndarray (host gather arena)")
    if recvbuf.dtype.hasobject:
        raise TypeError("recvbuf eltype must be a fixed-size dtype")
    if not recvbuf.flags.c_contiguous:
        # a non-contiguous buffer cannot be byte-viewed; silently
        # reshaping would write into a copy the caller never sees
        raise ValueError("recvbuf must be C-contiguous")
    if recvbuf.nbytes % n != 0:
        # reference src/MPIAsyncPools.jl:77 (length % n there; bytes
        # here, since chunks are byte spans)
        raise ValueError(
            f"recvbuf ({recvbuf.nbytes} bytes) must partition evenly "
            f"into {n} worker chunks"
        )
    flat = recvbuf.reshape(-1).view(np.uint8)
    rl = recvbuf.nbytes // n
    return [flat[i * rl : (i + 1) * rl] for i in range(n)]


def _store(
    pool: AsyncPool, i: int, result, recvbufs: list[np.ndarray] | None
) -> None:
    """Harvest one arrival: latency, result store, epoch stamp.

    Reference: the arrival block repeated at src/MPIAsyncPools.jl:104-110,
    :163-168 and :215-218.
    """
    pool.latency[i] = (time.perf_counter_ns() - pool.stimestamps[i]) / 1e9
    if isinstance(result, WorkerError):
        # keep the pool recoverable: the backend slot is already consumed,
        # so mark the worker idle (re-dispatchable next epoch) and leave
        # repochs unstamped (nothing useful arrived) before raising
        pool.active[i] = False
        result.raise_()
    pool.results[i] = result
    pool.repochs[i] = pool.sepochs[i]
    if recvbufs is not None:
        chunk = recvbufs[i]
        arr = _result_bytes(result)
        if arr.nbytes != chunk.nbytes:
            # the arrival is real (results/repochs above reflect it) and
            # the backend slot is consumed — mark the worker idle like the
            # WorkerError path, or a later waitall blocks forever on a
            # completion that was already taken
            pool.active[i] = False
            raise ValueError(
                f"worker {i} returned {arr.nbytes} bytes but recvbuf "
                f"chunks hold {chunk.nbytes} bytes; the pool bit-copies "
                "(reference src/MPIAsyncPools.jl:80-84) — match the "
                "recvbuf dtype width to the worker result, it is never "
                "value-cast"
            )
        chunk[:] = arr


def _result_bytes(result) -> np.ndarray:
    """An arrival's bytes on the host, as a flat uint8 array.

    A torch tensor (CUDA or CPU, any dtype, bf16 included) crosses as
    its bytes; a lazy stacked slice (``backends/cuda.py``) first
    materializes its row, which orders the read after the fused
    product; anything else goes through numpy as in the reference."""
    if hasattr(result, "materialize"):
        result = result.materialize()
    if isinstance(result, tensor_types()):
        import torch

        flat = result.detach().contiguous().reshape(-1)
        return flat.view(torch.uint8).cpu().numpy()
    return np.ascontiguousarray(result).reshape(-1).view(np.uint8)


def _dispatch(pool: AsyncPool, backend: Backend, i: int, sendbuf, tag: int) -> None:
    """Dispatch current payload to worker i and mark it active.

    Reference: dispatch block at src/MPIAsyncPools.jl:126-138 (and the
    re-task copy at :178-183). The payload snapshot the reference does via
    ``isendbufs[i] .= sendbuf`` (:130) is the backend's responsibility here.
    """
    pool.sepochs[i] = pool.epoch
    pool.stags[i] = int(tag)
    pool.stimestamps[i] = time.perf_counter_ns()
    backend.dispatch(pool.ranks[i], sendbuf, pool.epoch, tag=tag)
    # only after the backend accepted the task: a failed dispatch must not
    # leave pool.active[i] pointing at a slot the backend never opened
    # (waitall would then block on a completion that can never come)
    pool.active[i] = True


def asyncmap(
    pool: AsyncPool,
    sendbuf,
    backend: Backend,
    recvbuf: np.ndarray | None = None,
    *,
    nwait: NwaitArg | None = None,
    epoch: int | None = None,
    tag: int = 0,
    timeout: float | None = None,
    tracer=None,
    flight=None,
) -> np.ndarray:
    """Broadcast ``sendbuf`` to all idle workers; wait for the fastest few.

    Dispatches the payload asynchronously to every idle worker, then blocks
    until either ``nwait`` workers have responded with results *from this
    epoch* (integer ``nwait``) or ``nwait(epoch, repochs)`` evaluates True
    (callable ``nwait``). Late results from earlier epochs are harvested
    opportunistically; workers that return stale results are immediately
    re-tasked with the current payload. Returns ``pool.repochs`` — the
    per-worker freshness mask (``repochs[i] == epoch`` iff chunk ``i`` is
    from this epoch), which is exactly the arrival mask an erasure decoder
    needs to select any-k-of-n shards.

    Reference semantics: ``Base.asyncmap!`` at src/MPIAsyncPools.jl:68-188;
    docstring contract :48-67; the returned array aliases ``pool.repochs``
    like the reference (:187) — callers must copy if they retain it across
    epochs (test/kmap2.jl relies on reading it before the next call).

    ``timeout`` (seconds, new capability — the reference's phase-3
    ``Waitany!`` blocks forever when ``nwait`` is unsatisfiable): bounds
    the whole call; on expiry a :class:`DeadWorkerError` names the
    workers still outstanding. The pool stays usable — tardy workers
    remain active and their late results are drained by later calls.

    ``tracer`` and ``flight`` are duck-typed, as in the reference.
    ``flight`` (a flight recorder, opt-in like ``tracer``): the call records one epoch span + fresh/stale arrival
    counter deltas into the bounded postmortem ring, and a wait that
    blows its deadline TRIPS an automatic flight dump before the
    :class:`DeadWorkerError` raises — the artifact for the hang exists
    even though nothing after the raise runs cleanly.

    A tracer made with ``spans=True`` also turns on the call's ``mp.*``
    spans (``obs.timeline.annotate``, on the profiler's clock), all on
    this thread: ``mp.pool.drain``, ``mp.pool.dispatch``, one
    ``mp.pool.wait`` per arrival and ``mp.pool.retask`` here (each named
    ``<span>/e<epoch>``, a re-task ``/w<worker>/e<epoch>``), and the
    backend's own, armed for the call (``Backend.spans``). Otherwise no
    span is opened.
    """
    n = pool.n_workers
    if nwait is None:
        nwait = pool.nwait
    if epoch is None:
        epoch = pool.epoch + 1
    if isinstance(nwait, (int, np.integer)):
        if not (0 <= nwait <= n):
            # reference src/MPIAsyncPools.jl:71
            raise ValueError(f"nwait must be in [0, {n}], got {nwait}")
    elif not callable(nwait):
        # reference src/MPIAsyncPools.jl:157
        raise TypeError(f"nwait must be an int or callable, got {type(nwait)}")
    recvbufs = _recv_chunks(recvbuf, n)
    # ranks must be addressable backend slots — checked up front so a
    # subset pool misconfigured against a narrower backend fails with
    # the mapping spelled out, not an IndexError inside the transport
    bn = getattr(backend, "n_workers", None)
    if bn is not None and n and max(pool.ranks) >= bn:
        raise ValueError(
            f"pool.ranks {pool.ranks} address workers beyond the "
            f"backend's {bn} slots; the pool routes pool index i to "
            "backend worker ranks[i] (reference src/MPIAsyncPools.jl:21)"
        )
    # fail BEFORE any dispatch, like the reference's cross-buffer sizeof
    # checks (src/MPIAsyncPools.jl:72-76): an active worker's in-flight
    # result will be harvested into this recvbuf (stale arrivals are
    # written too, reference :167), so a chunk that can't hold what that
    # worker last produced is caught here, not mid-epoch at harvest.
    if recvbufs is not None:
        for i in np.flatnonzero(pool.active):
            nb = getattr(pool.results[i], "nbytes", None)
            if nb is not None and nb != recvbufs[i].nbytes:
                raise ValueError(
                    f"recvbuf chunks hold {recvbufs[i].nbytes} bytes but "
                    f"in-flight worker {int(i)} last produced {nb} bytes; "
                    "size the recvbuf before dispatching"
                )

    # each call to asyncmap is the start of a new epoch
    # (reference src/MPIAsyncPools.jl:87)
    pool.epoch = int(epoch)
    backend.begin_epoch(pool.epoch)
    spans = getattr(tracer, "spans", False)
    if spans:
        backend.spans = True
    if tracer is not None:
        tracer.begin("asyncmap", pool.epoch, nwait)
    _t_fl = time.perf_counter() if flight is not None else 0.0
    _n_fresh = _n_stale = 0

    # the finally clause flushes the open trace record even when a
    # WorkerFailure or buffer-size error aborts the call — failure traces
    # are the ones worth keeping
    try:
        # PHASE 1 — opportunistic, non-blocking drain of results that
        # arrived since the last call, to keep iterations independent
        # (reference src/MPIAsyncPools.jl:91-114).
        with annotate_if(spans, "mp.pool.drain", epoch=pool.epoch):
            for i in range(n):
                if not pool.active[i]:
                    continue
                result = backend.test(pool.ranks[i], tag=int(pool.stags[i]))
                if result is None:
                    continue
                _store(pool, i, result, recvbufs)
                pool.active[i] = False
                if tracer is not None:
                    tracer.arrival(
                        i, pool.repochs[i],
                        fresh=pool.repochs[i] == pool.epoch, drain=True,
                    )

        # PHASE 2 — dispatch to every idle worker; all workers are active
        # after this loop (reference src/MPIAsyncPools.jl:118-139).
        with annotate_if(spans, "mp.pool.dispatch", epoch=pool.epoch):
            for i in range(n):
                if pool.active[i]:
                    continue
                _dispatch(pool, backend, i, sendbuf, tag)
                if tracer is not None:
                    tracer.dispatch(i, pool.epoch)

            # coalescing backends submit buffered dispatches now, in one
            # program per device (no-op elsewhere)
            backend.flush()

        # PHASE 3 — collect until satisfied: the hot loop
        # (reference src/MPIAsyncPools.jl:145-185). Only arrivals stamped
        # with the current epoch count toward integer-nwait completion;
        # stale arrivals trigger an immediate re-task and the worker
        # stays active.
        deadline = Deadline(timeout)
        nrecv = 0
        while True:
            if callable(nwait):
                if bool(nwait(pool.epoch, pool.repochs)):
                    break
            else:
                if nrecv >= nwait:
                    break
            # one span per arrival: the wait and its bookkeeping, so the
            # epoch's last ends where the loop finds nwait met
            with annotate_if(spans, "mp.pool.wait", epoch=pool.epoch):
                # block until any active worker responds
                # (reference MPI.Waitany! at src/MPIAsyncPools.jl:161)
                act = np.flatnonzero(pool.active)
                got = backend.wait_any(
                    [pool.ranks[j] for j in act],
                    timeout=deadline.remaining(),
                    tags=pool.stags[act],
                )
                if got is None:
                    # Report backend ranks, not pool indices: a subset
                    # pool over ranks [1,4,5] must name the dead worker
                    # as 4, not the misleading pool-local 1 (advisor r3
                    # finding).
                    dead = [
                        int(pool.ranks[j])
                        for j in np.flatnonzero(pool.active)
                    ]
                    if flight is not None:
                        # the hang postmortem: dump the ring NOW —
                        # nothing after this raise is guaranteed to run
                        flight.trip(
                            f"asyncmap epoch {pool.epoch}: wait past "
                            f"deadline ({timeout}s), workers {dead} "
                            "outstanding"
                        )
                    raise DeadWorkerError(dead, timeout)
                rank, result = got
                i = pool._idx_of_rank[rank]
                _store(pool, i, result, recvbufs)
                fresh = pool.repochs[i] == pool.epoch
                if tracer is not None:
                    tracer.arrival(i, pool.repochs[i], fresh=fresh)
                if fresh:
                    nrecv += 1
                    _n_fresh += 1
                    pool.active[i] = False
                else:
                    _n_stale += 1
                    with annotate_if(spans, "mp.pool.retask", rank,
                                     pool.epoch):
                        _dispatch(pool, backend, i, sendbuf, tag)
                    if tracer is not None:
                        tracer.dispatch(i, pool.epoch, retask=True)
    finally:
        backend.end_epoch()
        if spans:
            backend.spans = False
        if tracer is not None:
            tracer.end(pool)
        if flight is not None:
            flight.span(
                f"asyncmap {pool.epoch}", _t_fl,
                time.perf_counter() - _t_fl,
                track="pool", fresh=_n_fresh, stale=_n_stale,
            )
            # cumulative across the pool's life -> the ring stores the
            # per-record delta (how much moved since the last record)
            flight.counter("pool_epochs_total", pool.epoch - pool.epoch0)
    return pool.repochs


def asyncmap_fused(
    pool: AsyncPool,
    sendbuf,
    coordinator,
    *,
    epochs: int,
) -> np.ndarray:
    """K epochs of :func:`asyncmap` as ONE compiled device program —
    the host stages inputs and harvests every ``epochs`` epochs
    instead of re-entering the interpreter per epoch (ROADMAP item 4;
    the numba-mpi frame: no interpreter on the critical path).

    ``coordinator`` is a device coordinator (duck-typed here; see
    :class:`~.parallel.device_coord.DeviceCoordinator`, a CUDA graph
    per window on the card): it owns the fused program, the per-worker
    coded blocks, the ``nwait`` policy, and the injected-delay
    schedule. ``repochs``
    semantics are preserved exactly — the returned ``(epochs, n)``
    HISTORY's row ``j`` is bit-for-bit what the host loop's epoch
    ``pool.epoch + 1 + j`` call would have returned on the same
    schedule, stale workers' shards masked by the on-device arrival
    mask exactly as this file's loop masks them, and the pool leaves
    the window in the host loop's end state (``epoch``, ``repochs``,
    ``sepochs``, ``active``; in-flight workers carry into the next
    window). Unlike :func:`asyncmap` the return value does NOT alias
    ``pool.repochs`` — the history is the caller's to keep.

    Host-loop-only capabilities a compiled window cannot express —
    ``timeout=``/``DeadWorkerError``, ``tracer=``, callable ``nwait``
    beyond the built-in hierarchical rule, a ``recvbuf`` bit-copy per
    epoch — stay with :func:`asyncmap`; decoded products are harvested
    from ``coordinator.last_decoded`` instead.
    """
    return coordinator.run_window(pool, sendbuf, epochs=epochs)


def waitall(
    pool: AsyncPool,
    backend: Backend,
    recvbuf: np.ndarray | None = None,
    *,
    timeout: float | None = None,
    tracer=None,
    flight=None,
) -> np.ndarray:
    """Drain the pool: block until every active worker has responded.

    All workers are inactive on return (reference ``waitall!`` at
    src/MPIAsyncPools.jl:190-224; quiescence asserted in test/kmap2.jl:60).

    ``timeout`` (seconds) is a new capability the reference lacks (its
    ``MPI.Waitall!`` would hang forever on a dead worker — SURVEY §5):
    if the pool does not quiesce in time, a :class:`DeadWorkerError` is
    raised naming the workers that never responded.
    """
    n = pool.n_workers
    recvbufs = _recv_chunks(recvbuf, n)
    backend.flush()  # direct-dispatch users may drain without asyncmap
    if not pool.active.any():
        return pool.repochs
    if tracer is not None:
        # nwait field = number of workers actually being drained
        tracer.begin("waitall", pool.epoch, int(pool.active.sum()))
    _t_fl = time.perf_counter() if flight is not None else 0.0
    try:
        deadline = Deadline(timeout)
        while pool.active.any():
            # harvest in ARRIVAL order, not index order: waiting on worker
            # 0 first would charge its wait time to workers 1..n-1's
            # ``latency`` stamps (the reference shares this flaw — its
            # ``Waitall!`` at src/MPIAsyncPools.jl:212 completes all
            # requests before any timestamping; utils/straggle.py fits
            # latency models to these numbers, so they must be true
            # per-worker round-trip times)
            act = np.flatnonzero(pool.active)
            got = backend.wait_any(
                [pool.ranks[j] for j in act],
                timeout=deadline.remaining(),
                tags=pool.stags[act],
            )
            if got is None:
                # Translated backend ranks, as in asyncmap above.
                dead = [
                    int(pool.ranks[j]) for j in np.flatnonzero(pool.active)
                ]
                if flight is not None:
                    flight.trip(
                        f"waitall at epoch {pool.epoch}: drain past "
                        f"deadline ({timeout}s), workers {dead} "
                        "outstanding"
                    )
                raise DeadWorkerError(dead, timeout)
            rank, result = got
            i = pool._idx_of_rank[rank]
            _store(pool, i, result, recvbufs)
            pool.active[i] = False
            if tracer is not None:
                tracer.arrival(
                    i, pool.repochs[i], fresh=pool.repochs[i] == pool.epoch
                )
    finally:
        if tracer is not None:
            tracer.end(pool)
        if flight is not None:
            flight.span(
                f"waitall {pool.epoch}", _t_fl,
                time.perf_counter() - _t_fl, track="pool",
            )
    return pool.repochs


# DeadWorkerError lives beside the Backend contract (backends/base.py) —
# straggle-mode backends raise it too, and backends must not import the
# orchestration layer above them. Re-exported here (imported at the top)
# because asyncmap/waitall are its primary raisers and callers import it
# from the pool.
