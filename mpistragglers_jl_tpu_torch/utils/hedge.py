"""Hedged requests: first-response-wins replicated dispatch.

A copy of the JAX package's ``utils/hedge.py`` over the port's pool
(``pool.py``, its ``_store`` included) and ``obs/``; on
:class:`~..backends.cuda.CUDADeviceBackend` a replica is a CUDA stream.

The serving-side dual of fastest-k training. The reference's pool
primitive — dispatch to several workers, return at the first
satisfactory arrival (``nwait=1``; src/MPIAsyncPools.jl:148-158 with
the minimal quorum) — is exactly the classic tail-latency hedge
("The Tail at Scale"): send the same request to ``hedge`` replicas and
take whichever answers first, so one stalled replica costs nothing.

:class:`HedgedServer` packages that on top of subset pools
(``AsyncPool(ranks=[...])`` routing, pool.py): each request runs on its
own 2-or-more-replica subset of one shared backend, so independent
requests hedge over disjoint replicas concurrently. The pieces the
pool already provides:

* **first-wins** is ``asyncmap(nwait=1)`` — phase 3 returns at the
  first fresh arrival;
* **losers cost nothing** — the slower replica's result arrives later,
  is harvested by the next phase-1 drain on that pool (stale, stored,
  worker freed), and the server's busy map keeps the rank out of new
  subsets until then;
* **exactly-once bookkeeping** — ``fresh_indices`` distinguishes the
  winner from the drained losers.

The server never blocks on a loser: ``request`` blocks only for its own
winner; ``drain`` (shutdown) is the one full barrier.
"""

from __future__ import annotations

import heapq
from typing import Sequence

import numpy as np

from ..backends.base import Backend, WorkerFailure
from ..pool import AsyncPool, asyncmap, waitall

__all__ = ["HedgedServer", "RequestHedge"]


class RequestHedge:
    """Deadline bookkeeping for REQUEST-level hedging: the serving-tier
    counterpart of :class:`HedgedServer`'s task-level first-wins.

    A ``RequestRouter`` (``models/router.py``) running the ``hedge_p99``
    policy arms one TTFT deadline per routed request; when the deadline
    passes without a first token the router re-dispatches the request
    onto a second scheduler replica, and whichever replica produces the
    first token wins (the loser is cancelled). This class is the
    bookkeeping half of that machinery — which requests are armed, which
    are due, fire-exactly-once — kept here next to ``HedgedServer`` so
    both hedging layers share one home and one semantics doc:

    * **arm(obj, deadline)** — start watching ``obj`` (any hashable-by-
      identity request handle) against an absolute clock time (virtual
      or wall — the caller owns the clock, exactly like the router);
    * **due(now)** — every armed entry whose deadline has passed, in
      (deadline, arm-sequence) order (deterministic — never set-hash
      order: sim replays must be bit-identical), each handed out
      EXACTLY ONCE (firing disarms);
    * **disarm(obj)** — the first token arrived (or the request was
      re-routed) before the deadline: stop watching;
    * **next_deadline()** — the earliest pending deadline, so a
      virtual-time loop can advance straight to the next hedge fire.

    Internally a (deadline, seq) heap over a liveness dict with lazy
    tombstones: ``due``/``next_deadline`` run once per router step of a
    million-event simulated day, and a full scan of the armed set per
    event is O(events x in-flight) — the scaling cliff this class must
    not have. Disarm/re-arm leave stale heap entries that the next
    heap touch discards by seq mismatch; every armed entry is pushed
    exactly once, so total heap work is O(arms log arms) per day.

    Single-threaded by design: the router mutates it only between
    scheduler ticks (the tick loop is the one writer), so unlike
    ``HedgedServer`` there is no cross-thread harvest to guard.
    """

    def __init__(self):
        # id(obj) -> (deadline, seq, obj); the heap holds
        # (deadline, seq, id) and an entry is live iff the dict still
        # maps its id to the SAME (deadline, seq)
        self._armed: dict[int, tuple[float, int, object]] = {}
        self._heap: list[tuple[float, int, int]] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._armed)

    def arm(self, obj, deadline: float) -> None:
        self._seq += 1
        key = id(obj)
        self._armed[key] = (float(deadline), self._seq, obj)
        heapq.heappush(self._heap, (float(deadline), self._seq, key))

    def disarm(self, obj) -> None:
        self._armed.pop(id(obj), None)  # heap entry becomes a tombstone

    def _drop_tombstones(self) -> None:
        heap, armed = self._heap, self._armed
        while heap:
            d, s, k = heap[0]
            live = armed.get(k)
            if live is not None and live[0] == d and live[1] == s:
                return
            heapq.heappop(heap)

    def due(self, now: float) -> list:
        """Armed entries whose deadline has passed, in (deadline,
        arm-sequence) order; each is disarmed as it is returned (fire
        exactly once)."""
        out = []
        while True:
            self._drop_tombstones()
            if not self._heap or self._heap[0][0] > now:
                return out
            _, _, k = heapq.heappop(self._heap)
            out.append(self._armed.pop(k)[2])

    def next_deadline(self) -> float | None:
        self._drop_tombstones()
        return self._heap[0][0] if self._heap else None


class HedgedServer:
    """First-response-wins dispatch over rank subsets of one backend.

    >>> srv = HedgedServer(backend)
    >>> result, rank, latency = srv.request(payload, hedge=2)

    ``request`` picks ``hedge`` idle replicas (round-robin over the
    backend's ranks, skipping any still busy with a previous request's
    losing dispatch), broadcasts the payload to all of them, and
    returns the first arrival. Explicit ``replicas=[...]`` overrides
    the choice (the caller owns disjointness then — a rank busy in
    another subset raises from the backend's slot check).

    ``registry=`` (an :class:`~..obs.MetricsRegistry`, opt-in like the
    pool's ``tracer=``) exports the hedge's behavior as first-class
    series — requests, dispatched widths (fire rate), narrowed hedges,
    winner latency, per-rank wins, loser failures, dead replicas — so
    operators read the state the server already tracks publicly
    (``history``, ``last_hedge_width``, ``failures``) as live metrics
    instead of reaching into attributes. ``exporter=`` (an
    :class:`~..obs.ObsServer`, same opt-in contract) registers the
    replica-health ``/healthz`` check: unhealthy while any rank is
    benched dead (``dead_replicas``), recovering after ``respawn`` +
    :meth:`reset_dead`.
    """

    def __init__(self, backend: Backend, *, registry=None,
                 exporter=None):
        self.backend = backend
        self._pools: dict[tuple[int, ...], AsyncPool] = {}
        self._rr = 0  # round-robin cursor over backend ranks
        # (winner rank, latency s, dispatched hedge width) per request
        self.history: list[tuple[int, float, int]] = []
        self.last_hedge_width: int = 0
        # replicas whose LOSING dispatch failed: their error must not
        # poison later requests (they already lost — nobody is waiting
        # on the result), but the rank is out of rotation until the
        # caller repairs it (backend.respawn + reset_dead)
        self.failures: list[WorkerFailure] = []
        self._dead: set[int] = set()
        # opt-in metrics, instruments resolved once (None = dark)
        self._m = None
        if registry is not None:
            n = backend.n_workers
            self._m = {
                "requests": registry.counter("hedge_requests_total"),
                "dispatches": registry.counter(
                    "hedge_dispatches_total",
                    help="replica dispatches (sum of hedge widths "
                    "actually fired)",
                ),
                "width": registry.histogram(
                    "hedge_width",
                    help="replicas dispatched per request",
                    buckets=tuple(float(b) for b in range(1, n + 1)),
                ),
                "narrowed": registry.counter(
                    "hedge_narrowed_total",
                    help="requests whose hedge narrowed below the "
                    "requested width (losers held ranks)",
                ),
                "latency": registry.histogram(
                    "hedge_winner_latency_seconds",
                    help="first-arrival round trip per request",
                ),
                "wins": [
                    registry.counter(
                        "hedge_wins_total",
                        help="requests this rank answered first",
                        rank=str(r),
                    )
                    for r in range(n)
                ],
                "loser_failures": registry.counter(
                    "hedge_loser_failures_total",
                    help="losing dispatches that died (rank benched)",
                ),
                "dead": registry.gauge(
                    "hedge_dead_replicas",
                    help="ranks benched until repair",
                ),
            }
        if exporter is not None:
            # replica-health /healthz check on the live telemetry plane
            exporter.register_hedge(self)

    @property
    def dead_replicas(self) -> frozenset[int]:
        """Ranks currently benched dead (losers whose process died) —
        read by the ``/healthz`` hedge check (which runs on ObsServer
        scrape threads while request threads mutate the set, hence the
        retry: the copy is GIL-atomic on CPython, but a concurrent
        resize elsewhere must degrade to a re-read, never a raising
        probe that reports a healthy hedge as failing); repair with
        ``backend.respawn`` + :meth:`reset_dead`."""
        while True:
            try:
                return frozenset(self._dead)
            except RuntimeError:  # pragma: no cover - non-atomic copy
                continue

    # -- busy/harvest bookkeeping ---------------------------------------

    def _harvest(self) -> None:
        """Non-blocking drain of every pool's outstanding losers (the
        pool phase-1 discipline, run across pools): frees their ranks
        for new subsets."""
        from ..pool import _store  # package-internal by design

        for pool in self._pools.values():
            for i in np.flatnonzero(pool.active):
                result = self.backend.test(
                    pool.ranks[i], tag=int(pool.stags[i])
                )
                if result is None:
                    continue
                try:
                    _store(pool, int(i), result, None)
                except WorkerFailure as e:
                    # a LOSER died: its request was already served, so
                    # no caller is owed this error — record it, bench
                    # the rank, keep serving
                    self.failures.append(e)
                    self._dead.add(int(pool.ranks[i]))
                    if self._m is not None:
                        self._m["loser_failures"].inc()
                        self._m["dead"].set(len(self._dead))
                pool.active[int(i)] = False

    def _busy_ranks(self) -> set[int]:
        busy: set[int] = set()
        for pool in self._pools.values():
            busy.update(
                int(pool.ranks[j]) for j in np.flatnonzero(pool.active)
            )
        return busy

    def _pick(self, hedge: int, deadline: float | None) -> list[int]:
        """Up to ``hedge`` idle ranks, round-robin. Best-effort width:
        when losers from earlier requests still hold ranks, the hedge
        NARROWS rather than fails (a thinner hedge is a latency risk;
        a refused request is an outage). Zero idle ranks blocks on the
        harvest loop — bounded by ``deadline`` (an absolute
        ``perf_counter`` time: the caller's single request budget, NOT
        a fresh window) when given."""
        import time as _time

        n = self.backend.n_workers
        if not set(range(n)) - self._dead:
            # dead ranks never come back on their own — waiting on the
            # harvest loop would hang forever; name the actual problem
            raise RuntimeError(
                f"all {n} replicas are dead ({sorted(self._dead)}); "
                "repair them (backend.respawn + reset_dead)"
            )
        while True:
            busy = self._busy_ranks() | self._dead
            picked: list[int] = []
            for d in range(n):
                r = (self._rr + d) % n
                if r not in busy:
                    picked.append(r)
                    if len(picked) == hedge:
                        break
            if picked:
                self._rr = (picked[-1] + 1) % n
                return picked
            if deadline is not None and _time.perf_counter() > deadline:
                raise RuntimeError(
                    f"no idle replica within the request budget (all "
                    f"{n} busy with losing dispatches); add replicas "
                    "or drain()"
                )
            _time.sleep(1e-3)
            self._harvest()

    # -- the request path -----------------------------------------------

    def request(
        self,
        payload,
        *,
        hedge: int = 2,
        replicas: Sequence[int] | None = None,
        timeout: float | None = None,
    ):
        """Dispatch ``payload`` to up to ``hedge`` idle replicas (the
        width narrows when losers still hold ranks — see ``_pick``);
        return ``(result, winner_rank, winner_latency_s)`` of the first
        arrival. The losing replicas keep computing and are recycled
        opportunistically — no request ever waits for them.

        ``timeout`` is ONE wall-clock budget for the whole request:
        waiting for an idle replica and waiting for the winner share
        the same deadline (not a fresh window each). The width actually
        dispatched is observable per call as ``last_hedge_width`` and
        in ``history`` — a narrowed hedge is a latency risk the caller
        may want to react to."""
        import time as _time

        if hedge < 1:
            raise ValueError(f"hedge must be >= 1, got {hedge}")
        deadline = (
            None if timeout is None else _time.perf_counter() + timeout
        )
        self._harvest()
        ranks = (
            list(int(r) for r in replicas) if replicas is not None
            else self._pick(hedge, deadline)
        )
        self.last_hedge_width = len(ranks)
        key = tuple(sorted(ranks))
        pool = self._pools.get(key)
        if pool is None:
            pool = AsyncPool(list(key))
            self._pools[key] = pool
        remaining = (
            None if deadline is None
            else max(deadline - _time.perf_counter(), 1e-9)
        )
        asyncmap(pool, payload, self.backend, nwait=1, timeout=remaining)
        fresh = pool.fresh_indices()
        # >1 fresh iff several replicas answered within the same poll
        # tick; the measured-latency argmin is then the honest winner
        i = int(fresh[np.argmin(pool.latency[fresh])])
        winner = (pool.results[i], int(pool.ranks[i]),
                  float(pool.latency[i]))
        self.history.append(winner[1:] + (len(ranks),))
        if self._m is not None:
            m = self._m
            m["requests"].inc()
            m["dispatches"].inc(len(ranks))
            m["width"].observe(len(ranks))
            if replicas is None and len(ranks) < hedge:
                m["narrowed"].inc()
            m["latency"].observe(winner[2])
            m["wins"][winner[1]].inc()
        return winner

    def reset_dead(self, rank: int) -> None:
        """Return a repaired replica (e.g. after ``backend.respawn``)
        to the rotation."""
        self._dead.discard(int(rank))
        if self._m is not None:
            self._m["dead"].set(len(self._dead))
        for pool in self._pools.values():
            if rank in pool.ranks:
                pool.reset_worker(pool._idx_of_rank[int(rank)])

    def drain(self) -> None:
        """Shutdown barrier: wait for every outstanding loser so the
        backend can be closed (or reused) cleanly. A loser dying during
        the drain is recorded like any other loser death, not raised —
        drain is cleanup, not a request."""
        for pool in self._pools.values():
            while pool.active.any():
                try:
                    waitall(pool, self.backend)
                except WorkerFailure as e:
                    # _store already freed the failed slot, so the
                    # retry drains only the remaining workers
                    self.failures.append(e)
                    self._dead.add(int(e.worker))
                    if self._m is not None:
                        self._m["loser_failures"].inc()
                        self._m["dead"].set(len(self._dead))
