"""SimBackend: the full Backend protocol on virtual time.

A copy of the JAX package's ``sim/backend.py`` (stdlib and numpy, no
torch and no OS clock): the same trace or schedule gives the same
virtual timeline in either package.

The real ``asyncmap``/``waitall`` (pool.py), ``HedgedServer``, and any
other Backend consumer run UNMODIFIED on top of this: ``dispatch``
computes the worker result immediately (numpy on the coordinator
thread) but schedules its *arrival* at ``clock.now() + delay + service``
on the :class:`~.clock.VirtualClock`; ``wait_any``/``wait`` advance
virtual time straight to the next arrival instead of blocking an OS
thread. A 10k-epoch straggling fleet completes in milliseconds of wall
clock with bit-reproducible arrival orders (the event heap breaks ties
by dispatch order — there is no thread scheduler to race).

Latency sources, in the order a study usually reaches for them:

* ``delay_fn`` — any :data:`~..backends.base.DelayFn` from
  :mod:`..utils.faults` (seeded lognormal fleets, designated
  stragglers, dead-from schedules, recorded-trace replays);
* :func:`model_delay_fn` — deterministic per-(worker, epoch) draws
  from fitted :class:`~..utils.straggle.WorkerStats` /
  :class:`~..utils.straggle.PoolLatencyModel` shifted-exponentials,
  so a latency model fitted on production samples becomes a
  counterfactual testbed.

Protocol-fidelity caveats:

* **Timeouts are virtual seconds.** The pool's ``Deadline`` arithmetic
  runs on the real clock, but a sim coordinator consumes ~no real
  time, so the ``timeout=`` each ``wait_any`` receives is ~the full
  caller budget, which this backend then spends as virtual time. A
  multi-arrival epoch can therefore span more *virtual* time than the
  caller's single budget — per-wait timeout semantics are exact,
  whole-call semantics are conservative.
* **``pool.latency`` stamps are real-clock** (≈0 in sim). Virtual
  round-trips live here instead: ``last_latency`` mirrors the pool
  field on the virtual axis, and :meth:`observe_into` feeds them to a
  :class:`~..utils.straggle.PoolLatencyModel`.
* **Phase-1 drains see only elapsed virtual time.** Between epochs no
  virtual time passes unless the advancing thread advances the clock, so a
  cross-epoch straggler is harvested stale in phase 3 rather than
  drained in phase 1 — same outcome, different phase.
"""

from __future__ import annotations

import copy
from typing import Callable, Sequence

import numpy as np

from ..backends.base import Backend, DelayFn, WorkerError
from .clock import VirtualClock

WorkFn = Callable[[int, object, int], object]

__all__ = ["SimBackend", "SimEvent", "model_delay_fn"]


class SimEvent:
    """One completed simulated task (the backend's own flight log)."""

    __slots__ = ("worker", "epoch", "tag", "t_dispatch", "t_done")

    def __init__(self, worker, epoch, tag, t_dispatch, t_done):
        self.worker = int(worker)
        self.epoch = int(epoch)
        self.tag = int(tag)
        self.t_dispatch = float(t_dispatch)
        self.t_done = float(t_done)

    @property
    def latency(self) -> float:
        return self.t_done - self.t_dispatch

    def __repr__(self) -> str:
        return (
            f"SimEvent(w{self.worker} e{self.epoch} "
            f"{self.t_dispatch:.6f}->{self.t_done:.6f})"
        )


def model_delay_fn(model, *, seed: int = 0) -> DelayFn:
    """A :data:`~..backends.base.DelayFn` sampling each (worker, epoch)
    round-trip from fitted shifted-exponential latency models —
    deterministically (the draw is keyed on ``(seed, worker, epoch)``,
    the same discipline as :mod:`..utils.faults`), so a simulated fleet
    driven by a production fit reproduces bit-for-bit.

    ``model`` is a :class:`~..utils.straggle.PoolLatencyModel` or a
    sequence of :class:`~..utils.straggle.WorkerStats`. Workers with no
    samples draw from the pooled prior of the observed workers (mean
    floor/mean of the fleet — a silent worker must not simulate as
    infinitely fast, mirroring ``PoolLatencyModel.sample_latencies``).
    """
    workers = list(getattr(model, "workers", model))
    fitted = [
        (w.shift, w.rate) for w in workers if w.count > 0
    ]
    if fitted:
        prior_shift = min(s for s, _ in fitted)
        means = [
            s + (0.0 if not np.isfinite(r) else 1.0 / r)
            for s, r in fitted
        ]
        prior_mean = float(np.mean(means))
        tail = prior_mean - prior_shift
        prior = (
            prior_shift, np.inf if tail <= 0 else 1.0 / tail
        )
    else:
        prior = (0.0, np.inf)
    params = [
        (w.shift, w.rate) if w.count > 0 else prior for w in workers
    ]

    def fn(worker: int, epoch: int) -> float:
        shift, rate = params[worker]
        if not np.isfinite(rate):
            return float(shift)
        rng = np.random.default_rng(
            (int(seed) & 0x7FFFFFFF, int(worker), int(epoch) & 0x7FFFFFFF)
        )
        return float(shift + rng.exponential(1.0 / rate))

    return fn


class _SimSlot:
    """One in-flight simulated task per (worker, tag) channel."""

    __slots__ = (
        "seq", "outstanding", "done_at", "t_dispatch", "result", "epoch",
    )

    def __init__(self):
        self.seq = 0
        self.outstanding = False
        self.done_at = 0.0
        self.t_dispatch = 0.0
        self.result = None
        self.epoch = 0


class SimBackend(Backend):
    """n simulated workers computing ``work_fn(worker, payload, epoch)``
    with virtual-time arrivals.

    >>> clock = VirtualClock()
    >>> backend = SimBackend(work, 8, delay_fn=sched, clock=clock)
    >>> repochs = asyncmap(pool, payload, backend, nwait=6)  # real pool
    >>> clock.now()                      # virtual epoch wall, seconds

    ``delay_fn(worker, epoch)`` is the injected round-trip latency;
    ``service_fn`` adds a second, separately-specified term (e.g. a
    compute-time model on top of a network-delay model). The result is
    computed eagerly at dispatch on the calling thread — numerically
    identical to a thread backend, but scheduled to *arrive* at
    ``now + delay + service``.

    ``registry=`` / ``spans=`` follow the package-wide opt-in contract
   : a dark backend pays only ``is None`` checks. With
    ``spans=`` every delivered task becomes one span on the virtual
    axis (track ``worker <i>`` in a ``sim`` Perfetto process), so
    simulated fleets merge into the same
    :func:`~..obs.timeline.dump_merged_chrome_trace` documents as live
    ones.
    """

    def __init__(
        self,
        work_fn: WorkFn,
        n_workers: int,
        *,
        delay_fn: DelayFn | None = None,
        service_fn: DelayFn | None = None,
        clock: VirtualClock | None = None,
        registry=None,
        spans=None,
    ):
        self.work_fn = work_fn
        self.n_workers = int(n_workers)
        self.delay_fn = delay_fn
        self.service_fn = service_fn
        self.clock = clock if clock is not None else VirtualClock()
        self._channels: dict[int, list[_SimSlot]] = {
            0: [_SimSlot() for _ in range(self.n_workers)]
        }
        self._gseq = 0
        self._closed = False
        self.events: list[SimEvent] = []  # delivered tasks, arrival order
        self.n_dispatched = 0
        self.n_delivered = 0
        # virtual round-trip of each worker's most recent delivery —
        # the sim-axis mirror of pool.latency (which stamps ~0 real
        # seconds here); feed a latency model via observe_into()
        self.last_latency = np.zeros(self.n_workers, dtype=np.float64)
        self._spans = spans
        self._m = None
        if registry is not None:
            self._m = {
                "dispatched": registry.counter(
                    "sim_tasks_dispatched_total",
                    help="simulated dispatches",
                ),
                "delivered": registry.counter(
                    "sim_tasks_delivered_total",
                    help="simulated arrivals handed to the pool",
                ),
                "vtime": registry.gauge(
                    "sim_virtual_time_seconds",
                    help="virtual clock at the latest delivery",
                ),
                "latency": registry.histogram(
                    "sim_task_virtual_seconds",
                    help="virtual round-trip per delivered task",
                ),
            }

    @classmethod
    def from_latency_model(
        cls, work_fn: WorkFn, model, *, seed: int = 0, **kw
    ) -> "SimBackend":
        """A backend whose fleet straggles like ``model`` says it does
        (:func:`model_delay_fn` over fitted per-worker distributions)."""
        n = getattr(model, "n_workers", None)
        if n is None:
            n = len(list(model))
        return cls(work_fn, n, delay_fn=model_delay_fn(model, seed=seed),
                   **kw)

    # -- internals --------------------------------------------------------
    def _chan(self, tag: int) -> list[_SimSlot]:
        slots = self._channels.get(tag)
        if slots is None:
            slots = [_SimSlot() for _ in range(self.n_workers)]
            self._channels[tag] = slots
        return slots

    def _deliver(self, i: int, slot: _SimSlot):
        result = slot.result
        slot.result = None
        slot.outstanding = False
        lat = slot.done_at - slot.t_dispatch
        self.last_latency[i] = lat
        self.n_delivered += 1
        self.events.append(
            SimEvent(i, slot.epoch, 0, slot.t_dispatch, slot.done_at)
        )
        if self._spans is not None:
            self._spans.add(
                f"task e{slot.epoch}", slot.t_dispatch, lat,
                track=f"worker {i}", worker=i, epoch=slot.epoch,
            )
        if self._m is not None:
            self._m["delivered"].inc()
            self._m["vtime"].set(slot.done_at)
            self._m["latency"].observe(lat)
        return result

    # -- Backend interface ------------------------------------------------
    def dispatch(self, i: int, sendbuf, epoch: int, *, tag: int = 0) -> None:
        if self._closed:
            raise RuntimeError("backend has been shut down")
        i, tag = int(i), int(tag)
        slot = self._chan(tag)[i]
        if slot.outstanding:
            raise RuntimeError(
                f"worker {i} already has an outstanding task on tag "
                f"{tag}; the pool must only dispatch to inactive workers"
            )
        # private payload snapshot (the reference isendbuf discipline):
        # in-flight simulated sends survive caller mutation too
        try:
            payload = np.array(sendbuf, copy=True)
        except Exception:
            payload = copy.deepcopy(sendbuf)
        # Exception, not BaseException: unlike the thread/process
        # backends, work_fn runs eagerly on the CALLING thread here, so
        # KeyboardInterrupt/SystemExit must abort the simulation, not
        # masquerade as a simulated worker fault at harvest
        try:
            result = self.work_fn(i, payload, epoch)
        except Exception as e:  # surfaced at harvest, never lost
            result = WorkerError(i, epoch, e)
        now = self.clock.now()
        delay = 0.0
        if self.delay_fn is not None:
            delay += max(float(self.delay_fn(i, epoch)), 0.0)
        if self.service_fn is not None:
            delay += max(float(self.service_fn(i, epoch)), 0.0)
        self._gseq += 1
        slot.seq = self._gseq
        slot.outstanding = True
        slot.t_dispatch = now
        slot.done_at = now + delay
        slot.result = result
        slot.epoch = int(epoch)
        self.n_dispatched += 1
        if self._m is not None:
            self._m["dispatched"].inc()

    def test(self, i: int, *, tag: int = 0):
        slots = self._channels.get(int(tag))
        if slots is None:  # channel never dispatched on
            return None
        slot = slots[int(i)]
        if slot.outstanding and slot.done_at <= self.clock.now():
            return self._deliver(int(i), slot)
        return None

    def wait_any(
        self,
        indices: Sequence[int],
        timeout: float | None = None,
        *,
        tags: Sequence[int] | None = None,
    ):
        idx = [int(i) for i in indices]
        if not idx:
            raise ValueError("wait_any over an empty index set would hang")
        tgs = [0] * len(idx) if tags is None else [int(t) for t in tags]
        if len(tgs) != len(idx):
            raise ValueError("tags must align one-to-one with indices")
        channels = self._channels  # hot path: one dict, no lazy create
        best = None  # (done_at, seq, i, slot)
        for i, t in zip(idx, tgs):
            slots = channels.get(t)
            if slots is None:  # channel never dispatched on
                continue
            slot = slots[i]
            if not slot.outstanding:
                continue
            key = (slot.done_at, slot.seq)
            if best is None or key < (best[0], best[1]):
                best = (slot.done_at, slot.seq, i, slot)
        now = self.clock.now()
        if best is None:
            # nothing in flight on the requested channels: an unbounded
            # wait would hang a real backend forever — make that a
            # diagnosable error here; a bounded one times out honestly
            if timeout is None:
                raise RuntimeError(
                    "wait_any on workers with no outstanding task "
                    "would block forever"
                )
            self.clock.advance(timeout)
            return None
        done_at, _, i, slot = best
        if done_at > now:
            if timeout is not None and done_at > now + float(timeout):
                self.clock.run_until(now + float(timeout))
                return None
            self.clock.run_until(done_at)
        return i, self._deliver(i, slot)

    def wait(self, i: int, timeout: float | None = None, *, tag: int = 0):
        i = int(i)
        slot = self._chan(int(tag))[i]
        if not slot.outstanding:
            raise RuntimeError(
                f"worker {i} has no outstanding task on tag {int(tag)}"
            )
        now = self.clock.now()
        if slot.done_at > now:
            if timeout is not None and slot.done_at > now + float(timeout):
                self.clock.run_until(now + float(timeout))
                return None
            self.clock.run_until(slot.done_at)
        return self._deliver(i, slot)

    def shutdown(self) -> None:
        self._closed = True

    # -- sim conveniences -------------------------------------------------
    def quiesce(self) -> float:
        """Advance virtual time past every outstanding arrival (so a
        following non-blocking harvest — ``test`` / a HedgedServer
        ``_harvest`` — finds them all). Returns the new ``now``."""
        latest = self.clock.now()
        for slots in self._channels.values():
            for slot in slots:
                if slot.outstanding:
                    latest = max(latest, slot.done_at)
        return self.clock.run_until(latest)

    def observe_into(self, model, *, workers: Sequence[int] | None = None):
        """Feed each worker's most recent *virtual* round-trip into a
        :class:`~..utils.straggle.PoolLatencyModel` — the sim-side
        replacement for ``model.observe_pool`` (whose real-clock
        ``pool.latency`` samples are ≈0 here)."""
        ws = range(self.n_workers) if workers is None else workers
        for w in ws:
            model.observe(int(w), float(self.last_latency[int(w)]))

    def __repr__(self) -> str:
        return (
            f"SimBackend(n={self.n_workers}, vnow={self.clock.now():.6f}, "
            f"{self.n_delivered}/{self.n_dispatched} delivered)"
        )
