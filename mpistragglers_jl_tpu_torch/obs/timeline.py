"""Unified runtime timeline: one Chrome/Perfetto trace for every layer.

:class:`~..utils.trace.EpochTracer` draws the pool hot path (worker
spans + coordinator calls); this module adds the host-side spans the
pool never sees — scheduler ticks, admission prefill chunks, training
steps — and merges all of them into ONE trace-event JSON that loads in
ui.perfetto.dev, each source as its own Chrome "process" track group
on the shared ``time.perf_counter`` clock (the tracer's clock, so pool
spans and scheduler ticks line up without translation).

A copy of the JAX package's ``obs/timeline.py`` with byte-identical
Chrome-trace output. Stdlib-only at import; :func:`annotate` is the
port's own: a ``torch.profiler.record_function`` range (plus an NVTX
range while a card is in use), imported lazily, so the identical
instrumented path runs on the CPU.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager, nullcontext
from typing import Any

__all__ = [
    "SpanRecorder",
    "dump_merged_chrome_trace",
    "merged_chrome_trace",
    "annotate",
    "annotate_if",
]

_US = 1e6


class SpanRecorder:
    """Append-only host-side span/counter store for one subsystem.

    One recorder = one Chrome process in the merged trace, named
    ``process``; spans land on named tracks (Chrome threads) within it.
    Timestamps are absolute ``time.perf_counter`` seconds — the same
    clock :class:`~..utils.trace.EpochTracer` stamps, so a pool tracer
    and a scheduler recorder merge aligned.

    >>> rec = SpanRecorder("serving")
    >>> with rec.span("tick 3", track="scheduler", queue=2):
    ...     ...
    >>> rec.add("decode", t0, dur, track="scheduler")   # retro span
    >>> rec.count("queue_depth", 4)                     # counter series

    Recording is plain list appends (no locks): each recorder belongs
    to one writer thread, mirroring the tracer's single-threaded
    contract. Cross-thread aggregation belongs in the registry.

    ``max_events`` (default 200k, ~tens of MB of tuples) bounds a
    long-lived writer — an instrumented scheduler appends a handful of
    events per tick forever, and an uncapped recorder would grow until
    OOM. At the cap new events are DROPPED and counted (``dropped``;
    surfaced as a marker event in the exported trace, never silently):
    the timeline keeps its beginning, the aggregate series live in the
    registry which is O(1) regardless. ``max_events=None`` removes the
    bound for short captures.
    """

    def __init__(
        self, process: str = "host", *,
        max_events: int | None = 200_000,
    ) -> None:
        self.process = str(process)
        self.max_events = None if max_events is None else int(max_events)
        self.dropped = 0
        # (track, name, t0_s, dur_s, args)
        self.spans: list[tuple[str, str, float, float, dict]] = []
        # (name, t_s, value)
        self.counters: list[tuple[str, float, float]] = []

    def _room(self) -> bool:
        if (
            self.max_events is not None
            and len(self.spans) + len(self.counters) >= self.max_events
        ):
            self.dropped += 1
            return False
        return True

    def add(
        self, name: str, t0: float, dur: float, *,
        track: str = "main", **args,
    ) -> None:
        """Record a completed span: ``t0`` absolute perf_counter
        seconds, ``dur`` seconds (clamped at 0 — a clock hiccup must
        not produce a negative-width span that Perfetto rejects)."""
        if self._room():
            self.spans.append(
                (track, str(name), float(t0), max(float(dur), 0.0),
                 args)
            )

    @contextmanager
    def span(self, name: str, *, track: str = "main", **args):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(
                name, t0, time.perf_counter() - t0, track=track, **args
            )

    def count(
        self, name: str, value: float, *, t: float | None = None
    ) -> None:
        """One sample of a counter series (Perfetto renders these as a
        filled step chart above the spans)."""
        if self._room():
            self.counters.append(
                (str(name),
                 time.perf_counter() if t is None else float(t),
                 float(value))
            )

    def __len__(self) -> int:
        return len(self.spans) + len(self.counters)

    def __repr__(self) -> str:
        drop = f", {self.dropped} dropped" if self.dropped else ""
        return (
            f"SpanRecorder({self.process!r}, {len(self.spans)} spans, "
            f"{len(self.counters)} counter samples{drop})"
        )

    # -- chrome export ----------------------------------------------------
    def chrome_events(
        self, pid: int = 0
    ) -> tuple[list[dict], list[dict]]:
        """(metadata events, span/counter events) under process ``pid``
        — the merge contract shared with ``EpochTracer.chrome_events``.

        Snapshots the span/counter lists ONCE up front: the live
        ``/trace`` endpoint calls this on recorders other threads are
        still appending to, and a two-pass read (build the track map,
        then the events) would KeyError on a span whose track landed
        between the passes. ``list()`` of an append-only list is
        GIL-atomic, so the snapshot is consistent."""
        spans = list(self.spans)
        counters = list(self.counters)
        tracks = []
        for track, *_ in spans:
            if track not in tracks:
                tracks.append(track)
        tid_of = {t: i for i, t in enumerate(tracks)}
        meta: list[dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": self.process}},
        ] + [
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": i,
             "args": {"name": t}}
            for t, i in tid_of.items()
        ]
        events: list[dict[str, Any]] = [
            {"name": name, "ph": "X", "pid": pid, "tid": tid_of[track],
             "ts": t0 * _US, "dur": dur * _US, "args": args}
            for track, name, t0, dur, args in spans
        ]
        events += [
            {"name": name, "ph": "C", "pid": pid,
             "ts": t * _US, "args": {name: value}}
            for name, t, value in counters
        ]
        if self.dropped:
            # the cap must read as a visible truncation marker in the
            # UI, never as "the run ended here"
            last = max((s[2] + s[3] for s in spans), default=0.0)
            events.append({
                "name": f"[recorder cap: {self.dropped} events dropped]",
                "ph": "I", "pid": pid, "tid": 0, "ts": last * _US,
                "s": "p",
            })
        return meta, events

    def dump_chrome_trace(self, path) -> int:
        """Standalone export (one-process trace); the merged form is
        :func:`dump_merged_chrome_trace`."""
        return dump_merged_chrome_trace(path, recorders=[self])


def merged_chrome_trace(
    *, tracers=(), recorders=()
) -> tuple[dict, int]:
    """Merge pool tracers and span recorders into one trace document.

    Returns ``(trace_doc, n_events)`` — the Chrome trace-event dict and
    the number of non-metadata events in it. This is the in-memory half
    of :func:`dump_merged_chrome_trace`, split out so a live exporter
    (``obs/export.py``'s ``/trace`` endpoint) can serve the merged
    timeline over HTTP without touching the filesystem.
    """
    meta: list[dict] = []
    events: list[dict] = []
    pid = 0
    for tracer in tracers:
        m, e = tracer.chrome_events(pid=pid)
        meta += m
        events += e
        pid += 1
    for rec in recorders:
        m, e = rec.chrome_events(pid=pid)
        meta += m
        events += e
        pid += 1
    return (
        {"traceEvents": meta + events, "displayTimeUnit": "ms"},
        len(events),
    )


def dump_merged_chrome_trace(
    path, *, tracers=(), recorders=()
) -> int:
    """Merge pool tracers and span recorders into ONE Chrome trace.

    ``tracers``: :class:`~..utils.trace.EpochTracer` instances (each
    becomes a "pool" process with its worker/coordinator tracks);
    ``recorders``: :class:`SpanRecorder` instances (scheduler ticks,
    training steps, ...). Every source gets its own Chrome pid, all on
    the shared perf_counter clock. Returns the number of non-metadata
    events written. Open the file in ui.perfetto.dev (or
    chrome://tracing).
    """
    doc, n = merged_chrome_trace(tracers=tracers, recorders=recorders)
    with open(path, "w") as f:
        # span args are arbitrary user objects; degrade to repr rather
        # than refuse the whole trace over one value
        json.dump(doc, f, default=repr)
    return n


@contextmanager
def annotate(name: str):
    """A named range around device work (the serving decode scan, a
    coded train step): ``torch.profiler.record_function``, so it shows
    in ``torch.profiler`` traces, and ``torch.cuda.nvtx.range`` while a
    CUDA context is live, so it shows in NVTX timelines. Costs nothing
    a dark path pays: callers enter it only when instrumented."""
    import torch

    with torch.profiler.record_function(name):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


_DARK = nullcontext()


def annotate_if(on: bool, name: str, worker: int | None = None,
                epoch: int | None = None):
    """A profiler range named ``name`` when ``on``, else a shared no-op
    context: a dark call site pays one boolean check and never enters
    the profiler.

    Unlike :func:`annotate`, the range is torch's ``_RecordFunctionFast``
    (a ``cpu_op`` event in the trace, on the profiler's clock) and opens
    no NVTX range: ``record_function`` enters through the op dispatcher,
    which lets go of the interpreter lock at each boundary, so on a hot
    path with other Python threads waiting for it each span hands them
    the lock and the spans time their own hand-offs. ``worker`` and
    ``epoch`` go into the name as ``name/w3/e120``, so a trace reader
    can tie a span to its epoch and task."""
    if not on:
        return _DARK
    from torch._C._profiler import _RecordFunctionFast

    if worker is not None:
        name = f"{name}/w{worker}"
    if epoch is not None:
        name = f"{name}/e{epoch}"
    return _RecordFunctionFast(name)
