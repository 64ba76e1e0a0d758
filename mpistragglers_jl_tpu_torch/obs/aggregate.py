"""Cross-process telemetry: worker-local registries merged coordinator-side.

A copy of the JAX package's ``obs/aggregate.py`` (stdlib only).

The ``obs/`` layer instruments one process; a straggler-resilient
pool is many — ``ProcessBackend`` spawns OS worker processes and
``python -m mpistragglers_jl_tpu_torch.worker`` serves whole remote hosts,
and none of them can share a ``MetricsRegistry`` object. This module is
the seam: each worker process keeps a LOCAL registry + span list
(:class:`WorkerTelemetry`), snapshots it into a small picklable frame
that piggybacks on the result it was going to send anyway (plus one
final frame on the shutdown drain), and the coordinator merges arriving
frames (:class:`TelemetryAggregator`) into its own registry under a
``worker="<rank>"`` label — so a single ``/metrics`` scrape of the
coordinator shows per-worker tails live, which is exactly the
visibility the latency/straggler trade-off literature assumes
(PAPERS: Map-Shuffle-Reduce with stragglers).

Two correctness problems this module owns:

* **Counter deltas across respawns.** Worker counters are cumulative
  *in that process*; a respawned worker restarts at zero. Frames carry
  a per-incarnation ``boot`` id and the aggregator adds only the DELTA
  since the previous frame of that ``(rank, boot, series)`` — so the
  coordinator's merged counters stay monotonic across crashes and
  respawns instead of double-counting (naive re-add) or dropping to
  zero (naive overwrite). Histograms merge the same way, bucket-wise —
  the fixed log grid (:data:`~.metrics.DEFAULT_BUCKETS`) is what makes
  two processes' histograms addable at all.

* **Clock alignment.** Worker spans are stamped on the worker's own
  ``perf_counter``, which shares no epoch with the coordinator's.
  Every result frame carries the worker-side (recv, send) stamps for
  its task; the coordinator pairs them with its own (send, recv)
  stamps for the same dispatch and keeps the offset estimate from the
  minimum-transport-delay pair (the NTP discipline) — worker spans are
  then translated onto the coordinator's axis before entering the
  merged Perfetto trace, one pid per worker process.

Stdlib-only; frames are plain dicts of str/float/list so they cross
pickle (ProcessBackend pipes) and the native codec alike.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .timeline import SpanRecorder

__all__ = ["OBS_TAG", "WorkerTelemetry", "TelemetryAggregator"]

# Reserved tag for standalone telemetry frames on transports that route
# completions by (rank, tag) — far outside the pool's tag space (pools
# use small non-negative tags), so a telemetry frame can never collide
# with a data channel.
OBS_TAG = -0x0B5

_FRAME_VERSION = 1


class WorkerTelemetry:
    """Worker-process-side collector: a local registry + span buffer.

    Constructed inside the worker process (``ProcessBackend._worker_main``
    or ``worker.run_worker``) when the coordinator asked for telemetry.
    The worker loop calls :meth:`task_done` after each compute and
    :meth:`snapshot` to build the frame that rides the result; custom
    instrumentation may use ``.registry`` / :meth:`span` directly —
    everything lands in the same frame and merges under this worker's
    rank label.
    """

    def __init__(self, rank: int):
        self.rank = int(rank)
        # incarnation id: distinguishes this process from any previous
        # or future occupant of the rank, so the coordinator's counter
        # deltas reset exactly when the process actually restarted
        self.boot = f"{os.getpid()}-{time.time_ns():x}"
        self.registry = MetricsRegistry()
        self._spans: list[tuple] = []  # drained by snapshot()
        self._tasks = self.registry.counter(
            "worker_tasks_total", help="tasks computed by this worker"
        )
        self._errors = self.registry.counter(
            "worker_errors_total",
            help="tasks whose compute raised",
        )
        self._task_s = self.registry.histogram(
            "worker_task_seconds", help="compute wall per task"
        )
        self._stall_s = self.registry.counter(
            "worker_stall_seconds_total",
            help="injected delay_fn stall, cumulative",
        )

    def span(
        self, name: str, t0: float, dur: float, *,
        track: str = "compute", **args,
    ) -> None:
        """A completed span on the WORKER's perf_counter clock; the
        aggregator translates it onto the coordinator's axis. Arg
        values are sanitized to primitives at record time (non-
        primitives degrade to their ``repr``): the frame must survive
        pickle/codec on EVERY transport — an unencodable custom arg
        killing the worker process, or converting a good result into a
        serialization error, would violate the telemetry-never-kills-
        a-harvest contract."""
        self._spans.append(
            (str(track), str(name), float(t0), max(float(dur), 0.0),
             {
                 str(k): (
                     v if isinstance(
                         v, (int, float, str, bool, type(None))
                     ) else repr(v)
                 )
                 for k, v in args.items()
             })
        )

    def task_done(
        self, epoch: int, t0: float, t1: float, *,
        error: bool = False, stall: float = 0.0,
    ) -> None:
        """Record one completed task: compute span ``[t0, t1]`` plus
        the standard counters (``stall`` = injected delay seconds,
        counted separately so task_seconds stays pure compute)."""
        self._tasks.inc()
        if error:
            self._errors.inc()
        if stall > 0:
            self._stall_s.inc(stall)
        self._task_s.observe(t1 - t0)
        self.span(f"task e{epoch}", t0, t1 - t0, epoch=int(epoch))

    def snapshot(
        self, pair: tuple[int, float, float] | None = None
    ) -> dict[str, Any]:
        """The picklable frame: cumulative metric values, the spans
        recorded since the last snapshot (incremental — each span ships
        once), and ``pair`` = ``(seq, t_recv_w, t_send_w)``, the
        worker-side clock stamps of the task this frame rides on."""
        counters, gauges, hists = [], [], []
        for inst in self.registry:
            rec = (inst.name, dict(inst.labels))
            if isinstance(inst, Histogram):
                counts, total, n = inst.read()
                hists.append(rec + (list(inst.bounds), counts, total, n))
            elif isinstance(inst, Counter):
                counters.append(rec + (inst.value,))
            elif isinstance(inst, Gauge):
                gauges.append(rec + (inst.value,))
        spans, self._spans = self._spans, []
        return {
            "v": _FRAME_VERSION,
            "rank": self.rank,
            "boot": self.boot,
            "counters": counters,
            "gauges": gauges,
            "hists": hists,
            "spans": spans,
            "pair": pair,
        }


class TelemetryAggregator:
    """Coordinator-side merge point for worker telemetry frames.

    ``registry``: the coordinator :class:`~.metrics.MetricsRegistry`
    that merged series land in (None = spans/clock only). ``flight``:
    an optional :class:`~.flight.FlightRecorder` that receives the
    merged worker spans too (``src="worker <rank>"``), so a flight dump
    of a hang shows what every worker process was doing last.

    Thread-safe: backends call :meth:`merge` from their reader threads
    and :meth:`note_dispatch` from the coordinator concurrently.
    """

    # dispatch-stamp map bound: entries are popped when the matching
    # result frame merges; dispatches whose worker died unmatched would
    # otherwise accumulate forever on a long-lived backend
    _MAX_PENDING = 4096

    def __init__(self, registry=None, *, flight=None):
        self.registry = registry
        self.flight = flight
        self._lock = threading.Lock()
        # (rank, boot, name, labels) -> last cumulative value
        self._last: dict[tuple, float] = {}
        # (rank, boot, name, labels) -> (bucket counts, sum, count)
        self._last_hist: dict[tuple, tuple] = {}
        self._recorders: dict[int, SpanRecorder] = {}
        # rank -> (best transport delay, clock offset w-c seconds)
        self._offset: dict[int, tuple[float, float]] = {}
        self._offset_boot: dict[int, str] = {}
        self._dispatch: dict[tuple[int, int], float] = {}
        # rank -> boot id of its CURRENT incarnation; a new boot
        # prunes the dead incarnation's delta state (see merge)
        self._boots: dict[int, str] = {}
        self.frames_merged = 0

    # -- clock alignment --------------------------------------------------
    def note_dispatch(self, rank: int, seq: int, t: float) -> None:
        """Stamp coordinator send time for ``(rank, seq)`` — half of a
        clock-offset sample; the other half rides the result frame."""
        with self._lock:
            if len(self._dispatch) >= self._MAX_PENDING:
                self._dispatch.pop(next(iter(self._dispatch)))
            self._dispatch[(int(rank), int(seq))] = float(t)

    def _update_offset(
        self, rank: int, boot: str, pair, t_recv_c: float | None
    ) -> None:
        """NTP-style: offset from the minimum-round-trip-delay sample.
        A new boot resets the estimate — a fresh process is a fresh
        clock epoch (perf_counter starts wherever the OS pleases)."""
        if pair is None or t_recv_c is None:
            return
        try:
            seq, t_recv_w, t_send_w = pair
        except (TypeError, ValueError):
            return  # malformed pair: skip the sample, keep the frame
        t_send_c = self._dispatch.pop((rank, int(seq)), None)
        if t_send_c is None:
            return
        # transport-only delay: the worker's own (recv -> send) time —
        # compute plus any injected stall — is subtracted out, so a
        # straggling task does not poison the offset estimate
        delay = (t_recv_c - t_send_c) - (t_send_w - t_recv_w)
        offset = (
            (t_recv_w - t_send_c) + (t_send_w - t_recv_c)
        ) / 2.0
        best = self._offset.get(rank)
        if self._offset_boot.get(rank) != boot:
            best = None
            self._offset_boot[rank] = boot
        if best is None or delay < best[0]:
            self._offset[rank] = (delay, offset)

    def clock_offset(self, rank: int) -> float | None:
        """Best estimate of (worker clock - coordinator clock) seconds
        for ``rank``'s current incarnation; None before any sample."""
        with self._lock:
            got = self._offset.get(int(rank))
            return None if got is None else got[1]

    # -- the merge --------------------------------------------------------
    def merge(
        self, rank: int, frame: dict, *, t_recv_c: float | None = None
    ) -> None:
        """Fold one worker frame in: counter/histogram deltas into the
        registry under ``worker="<rank>"``, spans onto the rank's
        recorder (clock-translated), offset sample updated. Malformed
        frames are dropped — telemetry must never kill a harvest."""
        if not isinstance(frame, dict) or frame.get("v") != _FRAME_VERSION:
            return
        rank = int(rank)
        boot = str(frame.get("boot", ""))
        with self._lock:
            prev_boot = self._boots.get(rank)
            if prev_boot is not None and prev_boot != boot:
                # the rank respawned: its old incarnation can never
                # send another frame, so its per-boot delta state is
                # dead weight — prune it, or a long-lived coordinator
                # under crash/respawn churn leaks a key set per boot
                # (the same bound the _dispatch map has)
                self._last = {
                    k: v for k, v in self._last.items()
                    if k[0] != rank or k[1] == boot
                }
                self._last_hist = {
                    k: v for k, v in self._last_hist.items()
                    if k[0] != rank or k[1] == boot
                }
                # the dead incarnation's clock offset dies with it —
                # reset HERE, unconditionally, not only when a valid
                # pair sample arrives (_update_offset early-returns on
                # pair-less frames, e.g. a drain frame arriving first,
                # and translating the new process's spans with the old
                # offset would scatter them hours off-axis; offset 0
                # until the first paired frame is the honest fallback)
                self._offset.pop(rank, None)
                self._offset_boot.pop(rank, None)
            self._boots[rank] = boot
            self._update_offset(rank, boot, frame.get("pair"), t_recv_c)
            self.frames_merged += 1
            off = self._offset.get(rank)
            offset = off[1] if off is not None else 0.0
            reg = self.registry
            if reg is not None:
                try:
                    self._merge_metrics(reg, rank, boot, frame)
                except (ValueError, TypeError, KeyError):
                    pass  # a malformed series never kills the harvest
            rec = self._recorders.get(rank)
            for span in frame.get("spans", ()):
                try:
                    track, name, t0, dur, args = span
                    t0c = float(t0) - offset
                    dur = float(dur)
                    # reserved kwargs of add()/span() must not be
                    # shadowed by a worker's span args
                    args = {
                        k: v for k, v in dict(args).items()
                        if k not in ("name", "t0", "dur", "t",
                                     "track", "src")
                    }
                except (TypeError, ValueError):
                    continue  # malformed span: telemetry never kills
                    # the reader thread that carried it
                if rec is None:
                    rec = self._recorders[rank] = SpanRecorder(
                        f"worker {rank}"
                    )
                rec.add(name, t0c, dur, track=track, **args)
                if self.flight is not None:
                    self.flight.span(
                        name, t0c, dur, src=f"worker {rank}",
                        track=track, **args,
                    )

    def _merge_metrics(
        self, reg: MetricsRegistry, rank: int, boot: str, frame: dict
    ) -> None:
        wl = str(rank)
        for name, labels, value in frame.get("counters", ()):
            key = (rank, boot, name, tuple(sorted(labels.items())))
            delta = float(value) - self._last.get(key, 0.0)
            self._last[key] = float(value)
            if delta > 0:
                reg.counter(name, worker=wl, **labels).inc(delta)
        for name, labels, value in frame.get("gauges", ()):
            reg.gauge(name, worker=wl, **labels).set(float(value))
        for name, labels, bounds, counts, total, n in frame.get(
            "hists", ()
        ):
            key = (rank, boot, name, tuple(sorted(labels.items())))
            prev = self._last_hist.get(
                key, ([0] * len(counts), 0.0, 0)
            )
            self._last_hist[key] = (list(counts), float(total), int(n))
            dc = [int(c) - int(p) for c, p in zip(counts, prev[0])]
            hist = reg.histogram(name, buckets=bounds, worker=wl,
                                 **labels)
            hist.merge_deltas(dc, float(total) - prev[1],
                              int(n) - prev[2])

    # -- exports ----------------------------------------------------------
    def boots(self) -> dict[int, str]:
        """rank -> boot id of its CURRENT incarnation (snapshot).
        The windowed plane keys its counter deltas on these so a
        respawned worker's reset never yields a negative-rate window
        (:class:`~.series.SeriesStore`)."""
        with self._lock:
            return dict(self._boots)

    def recorders(self) -> list[SpanRecorder]:
        """The per-worker span recorders (one Chrome pid each in the
        merged trace), rank order."""
        with self._lock:
            return [
                self._recorders[r] for r in sorted(self._recorders)
            ]

    def __repr__(self) -> str:
        return (
            f"TelemetryAggregator({self.frames_merged} frames, "
            f"{len(self._recorders)} workers)"
        )
