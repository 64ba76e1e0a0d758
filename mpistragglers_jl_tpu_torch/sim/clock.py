"""Virtual time: an event-heap clock for discrete-event simulation.

A copy of the JAX package's ``sim/clock.py`` (stdlib and numpy, no
torch and no OS clock): the same trace or schedule gives the same
virtual timeline in either package.

Everything in this package that "waits" waits on a :class:`VirtualClock`
instead of the OS clock: time is a number that jumps straight to the
next interesting event, so a 10k-epoch straggling fleet simulates in
milliseconds of wall clock and two runs of the same scenario read the
exact same timestamps (bit-reproducible — there is no scheduler jitter
to race against, the failure mode of injected-straggler margins in
wall-clock tests).

Two usage modes:

* **single-threaded discrete-event** (what :class:`~.backend.SimBackend`
  uses): the advancing thread schedules events with :meth:`call_at` /
  :meth:`call_later` and advances with :meth:`run_until` /
  :meth:`advance`; ``now()`` is the only clock anybody reads.
* **thread rendezvous** (opt-in): real threads :meth:`register` with
  the clock and block in :meth:`sleep`; the advancing thread's ``run_until``
  stops at every wake-up and refuses to move on until the woken
  thread has run its turn and parked in ``sleep`` again (or
  unregistered) — thread interleavings are replayed deterministically
  instead of raced. Declare the fleet size with :meth:`expect` BEFORE
  starting the threads so the advancing thread cannot advance past a worker's
  first wake-up while the OS is still scheduling the thread.
  Registered threads must only block via :meth:`sleep` (a thread
  parked on a bare ``queue.get`` is invisible to the rendezvous and
  would stall it — the stall surfaces as a :class:`RuntimeError`
  after ``stall_timeout`` real seconds, never as a silent hang).
"""

from __future__ import annotations

import heapq
import threading
from typing import Callable

__all__ = ["VirtualClock"]


class VirtualClock:
    """Event-heap virtual time. ``now()`` starts at ``start`` and only
    moves when the advancing thread advances it; ties fire in schedule order
    (the heap is keyed ``(time, seq)``), so arrival order is a pure
    function of the scenario."""

    def __init__(self, start: float = 0.0, *, stall_timeout: float = 30.0):
        self._now = float(start)
        self._seq = 0
        # scheduled callbacks: (fire_t, seq, callback | None) — None is
        # a bare timestamp the advance loop stops at and discards
        self._heap: list[tuple[float, int, Callable[[], None] | None]] = []
        self._cond = threading.Condition()
        # sleeping threads: seq -> wake time. Deliberately NOT heap
        # entries: a sleeper removes its own entry when it wakes (under
        # the lock), which is the acknowledgment the advancing thread's advance
        # loop waits on — without it the advancing thread could race past a
        # wake-up while the woken thread is still between sleeps.
        self._sleepers: dict[int, float] = {}
        self._threads: set[int] = set()  # registered thread idents
        self._blocked = 0  # registered threads currently in sleep()
        self._pending = 0  # expected registrations not yet arrived
        # real-seconds bound on rendezvous waits: a mis-parked thread
        # becomes a diagnosable error instead of a hung test run
        self.stall_timeout = float(stall_timeout)

    # -- reading ----------------------------------------------------------
    def now(self) -> float:
        """Current virtual time, seconds. Lock-free: attribute reads
        are GIL-atomic, and every ``_now`` write happens under
        ``self._cond``, whose release publishes it — ``now()`` sits on
        the simulator's hottest path (one read per dispatch/wait)."""
        return self._now

    def next_event(self) -> float | None:
        """Virtual time of the earliest pending event or sleeper
        wake-up (or None)."""
        with self._cond:
            return self._next_locked()

    def _next_locked(self) -> float | None:
        candidates = []
        if self._heap:
            candidates.append(self._heap[0][0])
        if self._sleepers:
            candidates.append(min(self._sleepers.values()))
        return min(candidates) if candidates else None

    # -- scheduling -------------------------------------------------------
    def call_at(self, t: float, fn: Callable[[], None] | None = None) -> None:
        """Schedule ``fn`` (may be None: a bare timestamp the advance
        loop will stop at) to fire when virtual time reaches ``t``.
        Times in the past fire at the current time, never backwards."""
        with self._cond:
            self._seq += 1
            heapq.heappush(
                self._heap, (max(float(t), self._now), self._seq, fn)
            )
            self._cond.notify_all()

    def call_later(
        self, delay: float, fn: Callable[[], None] | None = None
    ) -> None:
        with self._cond:
            self._seq += 1
            heapq.heappush(
                self._heap,
                (self._now + max(float(delay), 0.0), self._seq, fn),
            )
            self._cond.notify_all()

    # -- thread rendezvous ------------------------------------------------
    def expect(self, n: int) -> None:
        """Reserve ``n`` registrations: the advancing thread will not advance
        time until that many threads have :meth:`register`-ed (and are
        sleeping). Closes the startup race where the advancing thread advances
        past a worker's first wake-up before the worker thread has
        even been scheduled by the OS."""
        with self._cond:
            self._pending += int(n)
            self._cond.notify_all()

    def register(self) -> None:
        """Join the rendezvous: the calling thread promises to block
        only via :meth:`sleep`; the advancing thread will not advance time while
        it is running between sleeps."""
        with self._cond:
            self._threads.add(threading.get_ident())
            self._pending = max(self._pending - 1, 0)
            self._cond.notify_all()

    def unregister(self) -> None:
        """Leave the rendezvous (call before the thread exits, or the
        advancing thread waits ``stall_timeout`` for a sleep that never comes)."""
        with self._cond:
            self._threads.discard(threading.get_ident())
            self._cond.notify_all()

    def sleep(self, delay: float) -> None:
        """Block the calling thread until virtual time advances by
        ``delay``. From a registered thread this is the rendezvous
        point; the advancing thread's advance loop supplies the wake-up and
        waits for this thread to park again before time moves on."""
        with self._cond:
            if float(delay) <= 0.0:
                return
            wake = self._now + float(delay)
            self._seq += 1
            seq = self._seq
            self._sleepers[seq] = wake
            registered = threading.get_ident() in self._threads
            if registered:
                self._blocked += 1
            self._cond.notify_all()
            try:
                ok = self._cond.wait_for(
                    lambda: self._now >= wake,
                    timeout=self.stall_timeout,
                )
                if not ok:
                    raise RuntimeError(
                        f"virtual sleep until t={wake:.6f} was never "
                        f"advanced past (now={self._now:.6f}); the "
                        "advancing thread must run_until/advance the clock"
                    )
            finally:
                # removal under the SAME lock acquisition the wake-up
                # observed: this is the ack _wait_quiescent requires
                del self._sleepers[seq]
                if registered:
                    self._blocked -= 1
                self._cond.notify_all()

    def _wait_quiescent(self) -> None:
        """Advancing side: wait (real time) until every expected thread
        has registered, every registered thread is parked in
        :meth:`sleep`, and no sleeper's wake time has already passed
        without the sleeper acknowledging. Caller holds ``self._cond``."""

        def quiet() -> bool:
            return (
                self._pending == 0
                and self._blocked >= len(self._threads)
                and not any(w <= self._now for w in self._sleepers.values())
            )

        ok = self._cond.wait_for(quiet, timeout=self.stall_timeout)
        if not ok:
            raise RuntimeError(
                f"rendezvous stalled after {self.stall_timeout}s real "
                f"time: {self._pending} expected registration(s) "
                f"missing, {len(self._threads) - self._blocked} "
                "registered thread(s) neither sleeping nor unregistered"
            )

    # -- advancing --------------------------------------------------------
    def run_until(self, t: float) -> float:
        """Advance virtual time to ``t``, firing every event scheduled
        in between (in time order, schedule order on ties) and waking
        sleepers as their wake times pass. The loop stops at every
        wake-up until the woken thread has run and re-parked, so woken
        threads may schedule new, earlier events before time moves
        again. Returns the new ``now`` (== ``t``)."""
        t = float(t)
        # fast path for the dominant single-threaded discrete-event
        # case (SimBackend advancing to the next arrival): no
        # rendezvous participants and nothing scheduled before t means
        # one lock hold and a float write — the quiescence machinery
        # below exists for woken threads, of which there are none
        with self._cond:
            if (
                not self._threads
                and not self._sleepers
                and not self._pending
                and (not self._heap or self._heap[0][0] > t)
            ):
                self._now = max(self._now, t)
                return self._now
        while True:
            fn = None
            fired = False
            with self._cond:
                self._wait_quiescent()
                nxt = self._next_locked()
                if nxt is None or nxt > t:
                    self._now = max(self._now, t)
                    self._cond.notify_all()
                    return self._now
                if self._heap and self._heap[0][0] <= nxt:
                    when, _, fn = heapq.heappop(self._heap)
                    self._now = max(self._now, when)
                    fired = fn is not None
                else:
                    # a sleeper wake-up: advance to it and notify; the
                    # sleeper's own removal is the ack the next
                    # _wait_quiescent blocks on
                    self._now = max(self._now, nxt)
                self._cond.notify_all()
            if fired:
                fn()  # outside the lock: callbacks may re-schedule

    def advance(self, delay: float) -> float:
        """``run_until(now + delay)``."""
        return self.run_until(self.now() + max(float(delay), 0.0))

    def advance_next(self) -> float | None:
        """Advance to (and fire) the single earliest pending event;
        returns the new ``now``, or None when nothing is pending."""
        nxt = self.next_event()
        if nxt is None:
            return None
        return self.run_until(nxt)

    def run_all(self, *, max_events: int = 1_000_000) -> float:
        """Drain the event heap completely (bounded — a callback that
        perpetually re-schedules itself is a bug, not a simulation)."""
        for _ in range(max_events):
            if self.advance_next() is None:
                return self.now()
        raise RuntimeError(
            f"run_all exceeded {max_events} events; a callback is "
            "re-scheduling itself forever"
        )

    def __repr__(self) -> str:
        with self._cond:
            pending = len(self._heap) + len(self._sleepers)
            return (
                f"VirtualClock(now={self._now:.6f}, "
                f"{pending} pending, "
                f"{len(self._threads)} registered)"
            )
