"""Deterministic fault and latency injection.

A copy of the JAX package's ``utils/faults.py`` (numpy only): the
same schedules give the same delays bit for bit, and
:class:`from_trace` replays a JSONL trace written by either
package's :class:`~.trace.EpochTracer` (the two write one format).

The reference induces stragglers with bare randomness — workers
``sleep(rand())`` (reference examples/iterative_example.jl:74) or
``sleep(max(rand()/10, 0.005))`` (reference test/kmap2.jl:95) — which
SURVEY §4/§5 flags as the gap to close: on a real accelerator slice
stragglers are rare and the interconnect is lockstep-fast, so
*injection* must be a first-class, reproducible test subsystem rather
than an un-seeded sleep. They drive the thread and CUDA stream
backends, and the virtual-time ``sim.SimBackend``.

Every factory here returns a ``DelayFn`` — ``(worker, epoch) -> seconds``
— consumable by any backend's ``delay_fn`` kwarg (backends/base.py
``MailboxBackend``). All schedules are pure functions of ``(worker,
epoch)`` (seeded hashing, no global RNG state), so a failing test
reproduces bit-for-bit and schedules compose freely.

Failure (as opposed to latency) injection is expressed by wrapping the
workload: :func:`failing` raises inside the worker at chosen epochs,
exercising the coordinator-side :class:`~..backends.base.WorkerFailure`
surfacing path the reference entirely lacks (its worker assertions die
silently inside mpiexec subprocesses — reference test/runtests.jl:47).
"""

from __future__ import annotations

import hashlib
import struct
from typing import Callable, Mapping, Sequence

import numpy as np

from ..backends.base import DelayFn

__all__ = [
    "no_delay",
    "fixed",
    "per_worker",
    "seeded_uniform",
    "seeded_lognormal",
    "straggler",
    "intermittent",
    "dead_from",
    "kill_group",
    "correlated_kill",
    "partition",
    "from_trace",
    "compose",
    "failing",
    "FaultSchedule",
]


def _unit(seed: int, worker: int, epoch: int) -> float:
    """Deterministic uniform [0, 1) from (seed, worker, epoch).

    Uses blake2b so nearby (worker, epoch) pairs decorrelate — the
    reproducible stand-in for the reference's ``rand()``.
    """
    h = hashlib.blake2b(
        struct.pack("<qqq", seed, worker, epoch), digest_size=8
    ).digest()
    return struct.unpack("<Q", h)[0] / 2.0**64


def no_delay(worker: int, epoch: int) -> float:
    """The null schedule (every worker instant)."""
    return 0.0


def fixed(seconds: float) -> DelayFn:
    """Every worker stalls ``seconds`` every epoch."""
    return lambda worker, epoch: float(seconds)


def per_worker(delays: Sequence[float] | Mapping[int, float]) -> DelayFn:
    """Constant per-worker delay; workers absent from a mapping get 0."""
    if isinstance(delays, Mapping):
        table = dict(delays)
        return lambda worker, epoch: float(table.get(worker, 0.0))
    arr = [float(d) for d in delays]
    return lambda worker, epoch: arr[worker]


def seeded_uniform(lo: float, hi: float, *, seed: int = 0) -> DelayFn:
    """Deterministic analog of the reference's ``sleep(rand())``: uniform
    in [lo, hi), reproducible per (worker, epoch)."""
    span = float(hi) - float(lo)
    return lambda worker, epoch: lo + span * _unit(seed, worker, epoch)


def seeded_lognormal(
    median: float, sigma: float = 1.0, *, seed: int = 0
) -> DelayFn:
    """Heavy-tailed straggler model: lognormal with given median.

    Lognormal tails are the standard empirical model for straggler
    latencies (occasional order-of-magnitude outliers), which uniform
    sleeps cannot produce.
    """

    def fn(worker: int, epoch: int) -> float:
        u1 = _unit(seed, worker, epoch)
        u2 = _unit(seed + 0x9E3779B9, worker, epoch)
        # Box-Muller; clamp u1 away from 0
        z = np.sqrt(-2.0 * np.log(max(u1, 1e-12))) * np.cos(2 * np.pi * u2)
        return float(median * np.exp(sigma * z))

    return fn


def straggler(
    workers: int | Sequence[int], delay: float, *, every: int = 1, offset: int = 0
) -> DelayFn:
    """Designated worker(s) stall ``delay`` seconds on epochs where
    ``epoch % every == offset``; everyone else is instant.

    The workhorse for fastest-k tests: make worker j *the* straggler and
    assert the pool returns without it.
    """
    ws = {workers} if isinstance(workers, (int, np.integer)) else set(workers)
    return (
        lambda worker, epoch: float(delay)
        if worker in ws and epoch % every == offset % every
        else 0.0
    )


def intermittent(p: float, delay: float, *, seed: int = 0) -> DelayFn:
    """Each (worker, epoch) independently stalls ``delay`` with
    probability ``p`` — deterministic given the seed."""
    return (
        lambda worker, epoch: float(delay)
        if _unit(seed, worker, epoch) < p
        else 0.0
    )


def dead_from(workers: int | Sequence[int], epoch: int, *, delay: float = 3600.0) -> DelayFn:
    """Worker(s) become unresponsive from ``epoch`` onward.

    A dead worker is modelled as an arbitrarily long stall (default 1 h)
    — exactly how the reference's design treats death ("a dead worker is
    indistinguishable from an infinite straggler", SURVEY §5). Pair with
    ``waitall(timeout=...)`` to exercise :class:`~..pool.DeadWorkerError`.
    """
    ws = {workers} if isinstance(workers, (int, np.integer)) else set(workers)
    return (
        lambda worker, e: float(delay) if worker in ws and e >= epoch else 0.0
    )


class kill_group:
    """Scheduled whole-host failure: every worker of a group goes
    unresponsive from its kill epoch onward.

    The host-loss analog of :func:`dead_from` — death is an arbitrarily
    long stall (same modelling: "a dead worker is indistinguishable
    from an infinite straggler", SURVEY §5), but the unit is a *host
    group* (one entry of the partition
    :func:`~..ops.outer_code.partition_groups` produces), which is the
    failure mode the hierarchical outer code exists to survive.

    ``groups`` is the worker partition (sequence of worker-index
    sequences); ``kills`` maps group id -> first dead epoch (several
    groups may carry schedules; a group killed twice keeps the earliest
    epoch). Pure in ``(worker, epoch)`` like every schedule here, so a
    simulated host loss replays bit-identically, and a class (not a
    closure) so it pickles into process-backend workers.

    >>> sched = faults.kill_group(partition_groups(32, 4), {2: 10})
    >>> backend = LocalBackend(work, 32, delay_fn=sched)   # host 2 dies
    """

    def __init__(self, groups, kills: Mapping[int, int], *, delay: float = 3600.0):
        table: dict[int, int] = {}
        n_groups = len(list(groups))
        for g, e in dict(kills).items():
            if not 0 <= int(g) < n_groups:
                raise ValueError(
                    f"kill schedule names group {g}, but the partition "
                    f"has {n_groups} groups"
                )
            for w in groups[int(g)]:
                w = int(w)
                table[w] = min(int(e), table.get(w, int(e)))
        self._dead_from = table
        self.delay = float(delay)
        self.killed_groups = sorted(int(g) for g in dict(kills))

    def __call__(self, worker: int, epoch: int) -> float:
        e0 = self._dead_from.get(int(worker))
        return self.delay if e0 is not None and epoch >= e0 else 0.0


class correlated_kill:
    """Correlated whole-host failure: a contiguous SPAN of host groups
    dies at one epoch — the blast-radius model of a shared rack, power
    domain, or top-of-rack switch, where "one host died" is the
    fair-weather case and the chaos plane's case is "its neighbors
    went with it".

    ``groups`` is the worker partition (the
    :func:`~..ops.outer_code.partition_groups` shape);
    ``epicenter`` names the first dead group and ``span`` how many
    consecutive groups the failure domain covers (clamped at the
    partition's end — a blast at the last rack does not wrap).
    Delegates the per-worker schedule to :class:`kill_group`, so death
    semantics (arbitrarily long stall from ``at_epoch`` onward) and
    picklability are exactly the single-host case's. Pure in
    ``(worker, epoch)``: a correlated-failure episode replays
    bit-identically.

    >>> sched = faults.correlated_kill(partition_groups(32, 8),
    ...                                epicenter=2, at_epoch=10, span=3)
    """

    def __init__(self, groups, *, epicenter: int, at_epoch: int,
                 span: int = 2, delay: float = 3600.0):
        n_groups = len(list(groups))
        if not 0 <= int(epicenter) < n_groups:
            raise ValueError(
                f"epicenter names group {epicenter}, but the partition "
                f"has {n_groups} groups"
            )
        if span < 1:
            raise ValueError(f"span must be >= 1, got {span}")
        self.killed_groups = list(
            range(int(epicenter), min(int(epicenter) + int(span),
                                      n_groups))
        )
        self._inner = kill_group(
            groups, {g: int(at_epoch) for g in self.killed_groups},
            delay=delay,
        )
        self.at_epoch = int(at_epoch)
        self.delay = float(delay)

    def __call__(self, worker: int, epoch: int) -> float:
        return self._inner(worker, epoch)


class partition:
    """Network partition: every worker of the named groups is
    unreachable — but NOT dead — for epochs in
    ``[from_epoch, until_epoch)``, then recovers.

    A partition is distinct from :class:`kill_group` death in exactly
    the way the chaos plane needs stated: the workers keep computing,
    their results simply cannot cross the partition, and when it heals
    they answer again with no respawn. Modelled as a stall bounded by
    the partition's width (never the kill schedules' arbitrarily long
    one): a worker dispatched at epoch ``e`` inside the window stalls
    until the window closes. ``groups`` here is the sequence of
    worker-index sequences that ARE partitioned (pass a sub-list of
    the fleet partition). Pure in ``(worker, epoch)`` given
    ``epoch_s`` (the caller's virtual epoch pitch used to convert the
    remaining window width to stall seconds), a class so it pickles
    into process-backend workers.

    >>> sched = faults.partition([hosts[2], hosts[3]], from_epoch=10,
    ...                          until_epoch=16, epoch_s=0.1)
    """

    def __init__(self, groups, from_epoch: int, until_epoch: int, *,
                 epoch_s: float = 1.0):
        if until_epoch <= from_epoch:
            raise ValueError(
                f"need from_epoch < until_epoch, got "
                f"[{from_epoch}, {until_epoch})"
            )
        if epoch_s <= 0:
            raise ValueError(f"epoch_s must be > 0, got {epoch_s}")
        self._members = sorted(
            {int(w) for grp in groups for w in grp}
        )
        self._member_set = frozenset(self._members)
        self.from_epoch = int(from_epoch)
        self.until_epoch = int(until_epoch)
        self.epoch_s = float(epoch_s)

    def __call__(self, worker: int, epoch: int) -> float:
        if int(worker) not in self._member_set:
            return 0.0
        e = int(epoch)
        if not self.from_epoch <= e < self.until_epoch:
            return 0.0
        # stalled until the window closes: the result arrives the
        # moment the partition heals, never sooner and never lost
        return (self.until_epoch - e) * self.epoch_s


class from_trace:
    """Replay recorded per-worker latencies as a delay schedule.

    Closes the record -> replay loop: run a workload with an
    :class:`~.trace.EpochTracer`, ``dump_jsonl`` it, then re-create the
    same straggler pattern deterministically in any backend —
    reproducing a production incident under the thread backend, or
    A/B-ing scheduler changes (e.g. ``AdaptiveNwait``) against the
    exact latency pattern that hurt.

    Arrival times in the trace are measured *round-trips* (dispatch ->
    arrival, the reference's ``pool.latency`` quantity); replaying them
    as injected stalls reproduces the pattern up to the (small) true
    compute time of the replay workload. Workers/epochs absent from the
    trace replay with that worker's median recorded latency; workers
    never heard from at all replay as ``missing`` seconds (default: 10x
    the largest recorded latency), so absences stay stalls.

    A class (not a closure) so it pickles into process-backend workers.
    """

    def __init__(self, path, *, missing: float | None = None):
        import json

        with open(path) as f:
            records = [json.loads(line) for line in f]
        self._init_from_records(records, missing)

    @classmethod
    def from_records(cls, records, *, missing: float | None = None):
        """Build the schedule from already-loaded epoch records — the
        dict form of :meth:`~.trace.EpochRecord.to_dict` (what
        ``dump_jsonl`` writes line-by-line). The in-memory half of the
        record -> replay loop: a live :class:`~.trace.EpochTracer`'s
        records go straight in, no file round-trip."""
        self = cls.__new__(cls)
        self._init_from_records(list(records), missing)
        return self

    def _init_from_records(self, records, missing: float | None) -> None:
        by_key: dict[tuple[int, int], float] = {}
        longest = 0.0
        for rec in records:
            dispatched: dict[int, float] = {}
            for ev in rec.get("events", []):
                w = int(ev["worker"])
                if ev["kind"] in ("dispatch", "retask"):
                    dispatched[w] = float(ev["t"])
                elif ev["kind"] in ("arrival", "drain"):
                    t0 = dispatched.pop(w, None)
                    if t0 is not None:
                        lat = float(ev["t"]) - t0
                    else:
                        # dispatched in an earlier record (cross-
                        # epoch straggle): the record's latency
                        # snapshot holds this worker's measured
                        # round-trip (reference pool.latency field)
                        try:
                            lat = float(rec["latency_s"][w])
                        except (KeyError, IndexError):
                            continue
                    by_key[(w, int(ev["epoch"]))] = lat
                    longest = max(longest, lat)
        self._by_key = by_key
        # per-worker typical latency: the fallback when replay dispatch
        # epochs drift from the recorded ones (e.g. A/B-ing a different
        # nwait shifts when workers go idle) — the worker still replays
        # with ITS characteristic speed rather than the missing stall
        per_worker: dict[int, list[float]] = {}
        for (w, _e), lat in by_key.items():
            per_worker.setdefault(w, []).append(lat)
        self._per_worker = {
            w: float(np.median(v)) for w, v in per_worker.items()
        }
        # floor the default so a trace with no computable round-trips
        # (all workers stalled/dead) still replays absences as stalls,
        # never as instant workers
        self._missing = (
            max(10.0 * longest, 1.0) if missing is None else float(missing)
        )

    def __call__(self, worker: int, epoch: int) -> float:
        exact = self._by_key.get((worker, epoch))
        if exact is not None:
            return exact
        return self._per_worker.get(worker, self._missing)


def compose(*fns: DelayFn) -> DelayFn:
    """Sum of schedules (e.g. baseline jitter + one designated straggler)."""
    return lambda worker, epoch: sum(f(worker, epoch) for f in fns)


def failing(
    work_fn: Callable,
    *,
    workers: int | Sequence[int],
    epochs: int | Sequence[int] | None = None,
    error: Callable[[], BaseException] = lambda: RuntimeError("injected fault"),
):
    """Wrap a workload so designated workers *raise* at designated epochs.

    Returns a drop-in ``work_fn(worker, payload, epoch)``. ``epochs=None``
    means every epoch. The raise happens inside the worker; the backend
    captures it and the coordinator sees a ``WorkerFailure`` at harvest.
    """
    ws = {workers} if isinstance(workers, (int, np.integer)) else set(workers)
    es = (
        None
        if epochs is None
        else ({epochs} if isinstance(epochs, (int, np.integer)) else set(epochs))
    )

    def wrapped(worker, payload, epoch):
        if worker in ws and (es is None or epoch in es):
            raise error()
        return work_fn(worker, payload, epoch)

    return wrapped


class FaultSchedule:
    """Declarative scenario composing delay + failure injections.

    >>> sched = (FaultSchedule(seed=7)
    ...          .jitter(0.001, 0.005)
    ...          .straggler(2, 0.2, every=3)
    ...          .dead_from(5, epoch=10))
    >>> backend = LocalBackend(work, n, delay_fn=sched.delay_fn)

    Keeps whole scenarios reproducible from one seed and printable for
    failure reports (``repr`` lists the stacked schedules).
    """

    def __init__(self, *, seed: int = 0):
        self.seed = seed
        self._fns: list[DelayFn] = []
        self._desc: list[str] = []

    def _add(self, fn: DelayFn, desc: str) -> "FaultSchedule":
        self._fns.append(fn)
        self._desc.append(desc)
        return self

    def jitter(self, lo: float, hi: float) -> "FaultSchedule":
        return self._add(
            seeded_uniform(lo, hi, seed=self.seed), f"jitter[{lo},{hi})"
        )

    def lognormal(self, median: float, sigma: float = 1.0) -> "FaultSchedule":
        return self._add(
            seeded_lognormal(median, sigma, seed=self.seed),
            f"lognormal(median={median},sigma={sigma})",
        )

    def straggler(
        self, workers, delay: float, *, every: int = 1, offset: int = 0
    ) -> "FaultSchedule":
        return self._add(
            straggler(workers, delay, every=every, offset=offset),
            f"straggler({workers},{delay}s,every={every})",
        )

    def intermittent(self, p: float, delay: float) -> "FaultSchedule":
        return self._add(
            intermittent(p, delay, seed=self.seed),
            f"intermittent(p={p},{delay}s)",
        )

    def dead_from(self, workers, epoch: int) -> "FaultSchedule":
        return self._add(
            dead_from(workers, epoch), f"dead_from({workers},epoch={epoch})"
        )

    def kill_group(self, groups, kills: Mapping[int, int]) -> "FaultSchedule":
        return self._add(
            kill_group(groups, kills),
            f"kill_group({dict(kills)})",
        )

    def correlated_kill(
        self, groups, *, epicenter: int, at_epoch: int, span: int = 2
    ) -> "FaultSchedule":
        return self._add(
            correlated_kill(groups, epicenter=epicenter,
                            at_epoch=at_epoch, span=span),
            f"correlated_kill(epicenter={epicenter},"
            f"at={at_epoch},span={span})",
        )

    def partition(
        self, groups, from_epoch: int, until_epoch: int, *,
        epoch_s: float = 1.0
    ) -> "FaultSchedule":
        return self._add(
            partition(groups, from_epoch, until_epoch,
                      epoch_s=epoch_s),
            f"partition([{from_epoch},{until_epoch}))",
        )

    @property
    def delay_fn(self) -> DelayFn:
        fns = list(self._fns)
        return lambda worker, epoch: sum(f(worker, epoch) for f in fns)

    def __repr__(self) -> str:
        return f"FaultSchedule(seed={self.seed}, [{', '.join(self._desc)}])"
