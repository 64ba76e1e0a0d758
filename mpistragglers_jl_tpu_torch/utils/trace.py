"""Structured per-epoch tracing and metrics.

The reference's only observability is a per-worker round-trip latency
field (``pool.latency``, reference src/MPIAsyncPools.jl:104-105,:136,
:163-164) — no tracer, no timeline, no export. This module is the replacement subsystem: an
:class:`EpochTracer` passed to ``asyncmap``/``waitall`` records every
dispatch and arrival with monotonic timestamps, per-epoch wall-clock,
freshness outcomes and re-task counts, and exports JSONL timelines plus
aggregate straggler statistics.

Zero overhead when unused: the pool only calls the tracer if one is
passed, and every hook is a plain method call recording into Python
lists (no locks — the coordinator loop is single-threaded, mirroring the
reference's single-threaded design).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np

__all__ = ["EpochTracer", "EpochRecord", "Event"]


@dataclass
class Event:
    """One dispatch/arrival/re-task, timestamped relative to epoch begin."""

    t: float  # seconds since epoch begin
    kind: str  # "dispatch" | "arrival" | "retask" | "drain"
    worker: int
    epoch: int  # epoch the payload/result is stamped with
    fresh: bool | None = None  # arrivals only: stamped with current epoch?

    def to_dict(self) -> dict[str, Any]:
        d = {
            "t": round(self.t, 9),
            "kind": self.kind,
            "worker": self.worker,
            "epoch": self.epoch,
        }
        if self.fresh is not None:
            d["fresh"] = self.fresh
        return d


@dataclass
class EpochRecord:
    """Everything that happened inside one ``asyncmap``/``waitall`` call."""

    epoch: int
    call: str  # "asyncmap" | "waitall"
    nwait: Any  # int or "<callable>"
    t_begin: float  # monotonic clock at call entry
    events: list[Event] = field(default_factory=list)
    wall: float = 0.0  # call duration, seconds
    n_fresh: int = 0  # arrivals stamped with this epoch
    n_stale: int = 0  # arrivals carrying an older stamp
    n_retask: int = 0  # immediate re-dispatches after stale arrivals
    repochs: list[int] = field(default_factory=list)  # snapshot at return
    latency: list[float] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {
            "epoch": self.epoch,
            "call": self.call,
            "nwait": self.nwait,
            "wall_s": round(self.wall, 9),
            "n_fresh": self.n_fresh,
            "n_stale": self.n_stale,
            "n_retask": self.n_retask,
            "repochs": self.repochs,
            "latency_s": [round(x, 9) for x in self.latency],
            "events": [e.to_dict() for e in self.events],
        }


class EpochTracer:
    """Records a timeline of pool activity across epochs.

    >>> tracer = EpochTracer()
    >>> asyncmap(pool, payload, backend, tracer=tracer)
    >>> tracer.records[-1].n_fresh
    >>> tracer.dump_jsonl("trace.jsonl")
    >>> tracer.summary()["straggler_rate"]
    """

    def __init__(self) -> None:
        self.records: list[EpochRecord] = []
        self._open: EpochRecord | None = None

    # -- hooks called by pool.asyncmap / pool.waitall ---------------------
    def begin(self, call: str, epoch: int, nwait: Any) -> None:
        self._open = EpochRecord(
            epoch=int(epoch),
            call=call,
            nwait=int(nwait) if isinstance(nwait, (int, np.integer))
            else "<callable>",
            t_begin=time.perf_counter(),
        )

    def _now(self) -> float:
        assert self._open is not None
        return time.perf_counter() - self._open.t_begin

    def dispatch(self, worker: int, epoch: int, *, retask: bool = False) -> None:
        r = self._open
        if r is None:
            return
        kind = "retask" if retask else "dispatch"
        r.events.append(Event(self._now(), kind, int(worker), int(epoch)))
        if retask:
            r.n_retask += 1

    def arrival(
        self, worker: int, repoch: int, *, fresh: bool, drain: bool = False
    ) -> None:
        r = self._open
        if r is None:
            return
        kind = "drain" if drain else "arrival"
        fresh = bool(fresh)
        r.events.append(
            Event(self._now(), kind, int(worker), int(repoch), fresh=fresh)
        )
        if fresh:
            r.n_fresh += 1
        else:
            r.n_stale += 1

    def end(self, pool) -> None:
        r = self._open
        if r is None:
            return
        r.wall = self._now()
        r.repochs = [int(x) for x in pool.repochs]
        r.latency = [float(x) for x in pool.latency]
        self.records.append(r)
        self._open = None

    # -- export / analysis ------------------------------------------------
    def dump_jsonl(self, path) -> None:
        """One JSON object per epoch record."""
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r.to_dict()) + "\n")

    def chrome_events(
        self, pid: int = 0
    ) -> tuple[list[dict[str, Any]], list[dict[str, Any]]]:
        """(metadata events, span events) in Chrome trace-event form
        under process ``pid`` — the merge contract consumed by
        :func:`~..obs.timeline.dump_merged_chrome_trace`, which lays a
        pool timeline beside scheduler/training span recorders. One
        track per worker with a span per task (dispatch -> arrival,
        stale spans flagged), plus a coordinator track with one span
        per ``asyncmap``/``waitall`` call.

        Spans may cross record boundaries: a payload dispatched in epoch
        N and drained in epoch N+1 (the reference's late-arrival harvest,
        src/MPIAsyncPools.jl:91-114) is drawn over its true lifetime.
        """
        us = 1e6
        events: list[dict[str, Any]] = []
        open_dispatch: dict[int, tuple[float, int]] = {}  # worker -> (t_abs, epoch)
        for r in self.records:
            events.append({
                "name": f"{r.call}(epoch={r.epoch}, nwait={r.nwait})",
                "ph": "X", "pid": pid, "tid": -1,
                "ts": r.t_begin * us, "dur": r.wall * us,
                "args": {"n_fresh": r.n_fresh, "n_stale": r.n_stale,
                         "n_retask": r.n_retask},
            })
            for e in r.events:
                t_abs = r.t_begin + e.t
                if e.kind in ("dispatch", "retask"):
                    open_dispatch[e.worker] = (t_abs, e.epoch)
                else:  # arrival / drain
                    start = open_dispatch.pop(e.worker, None)
                    if start is None:
                        continue
                    t0, sepoch = start
                    events.append({
                        "name": f"epoch {sepoch}"
                        + ("" if e.fresh else " (stale)"),
                        "ph": "X", "pid": pid, "tid": e.worker,
                        "ts": t0 * us, "dur": (t_abs - t0) * us,
                        "args": {"fresh": bool(e.fresh), "kind": e.kind},
                    })
        meta = [
            {"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": "pool"}},
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": -1,
             "args": {"name": "coordinator"}},
        ] + [
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": w,
             "args": {"name": f"worker {w}"}}
            for w in sorted({e["tid"] for e in events if e["tid"] >= 0})
        ]
        return meta, events

    def dump_chrome_trace(self, path) -> int:
        """Export the timeline in Chrome trace-event format (open in
        ui.perfetto.dev or chrome://tracing) — see :meth:`chrome_events`
        for the track layout. Returns the number of events written."""
        meta, events = self.chrome_events()
        with open(path, "w") as f:
            json.dump({"traceEvents": meta + events}, f)
        return len(events)

    def summary(self) -> dict[str, Any]:
        """Aggregate statistics over ALL recorded calls.

        Arrival totals span asyncmap AND waitall records: a dispatch
        harvested only by a later ``waitall`` used to vanish from the
        accounting entirely (counted dispatched, its arrival dropped),
        so a traced ``fit()`` loop under-reported stale results by
        exactly its shutdown drain. ``n_waitall_arrivals`` breaks those
        drains out, and ``delivered_rate`` is the fraction of
        dispatches that eventually produced ANY arrival in the trace
        (< 1 means tasks were still in flight when tracing stopped).

        ``straggler_rate`` keeps its original meaning — the fraction of
        dispatches that did NOT come back fresh within their own
        ``asyncmap`` epoch (the straggle the pool absorbed); a waitall
        drain arriving after the fastest-k cut is still a straggle, it
        just no longer disappears from ``n_fresh``/``n_stale``.

        Asyncmap-only fields (a waitall drains whatever is in flight —
        its wall measures the drain, and its arrivals' round-trips span
        call boundaries): ``epochs``, ``wall_total/mean/p95_s``,
        ``arrival_p50/p95_s`` (fresh within-epoch round-trips). A
        waitall-only trace (a tracer attached just to a shutdown drain)
        still reports the full key set — ``epochs`` 0, wall/arrival
        fields None, the arrival totals real.
        """
        if not self.records:
            return {"epochs": 0}
        maps = [r for r in self.records if r.call == "asyncmap"]
        waits = [r for r in self.records if r.call == "waitall"]
        walls = np.array([r.wall for r in maps])
        lat = np.array(
            [
                e.t
                for r in maps
                for e in r.events
                if e.kind == "arrival" and e.fresh
            ]
        )
        dispatched = sum(
            1 for r in maps for e in r.events if e.kind in ("dispatch", "retask")
        )
        fresh_in_epoch = sum(r.n_fresh for r in maps)
        fresh = fresh_in_epoch + sum(r.n_fresh for r in waits)
        stale = sum(r.n_stale for r in self.records)
        return {
            "epochs": len(maps),
            "wall_total_s": float(walls.sum()) if maps else None,
            "wall_mean_s": float(walls.mean()) if maps else None,
            "wall_p95_s": float(np.percentile(walls, 95))
            if maps else None,
            "n_dispatched": dispatched,
            "n_fresh": fresh,
            "n_stale": stale,
            "n_retask": sum(r.n_retask for r in self.records),
            "n_waitall_arrivals": sum(
                r.n_fresh + r.n_stale for r in waits
            ),
            "straggler_rate": float(1.0 - fresh_in_epoch / dispatched)
            if dispatched
            else 0.0,
            "delivered_rate": float(min(fresh + stale, dispatched) / dispatched)
            if dispatched
            else 0.0,
            "arrival_p50_s": float(np.percentile(lat, 50)) if lat.size else None,
            "arrival_p95_s": float(np.percentile(lat, 95)) if lat.size else None,
        }

    def __repr__(self) -> str:
        return f"EpochTracer({len(self.records)} records)"
