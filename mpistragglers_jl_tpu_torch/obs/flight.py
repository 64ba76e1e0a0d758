"""Flight recorder: a bounded ring of recent telemetry for postmortems.

The registry (:mod:`.metrics`) answers "what are the totals"; the
recorders (:mod:`.timeline`) answer "what happened, in order" — but
both are end-of-run artifacts: when a coordinator *hangs* (a stuck
scheduler tick, a pool wait that blows its deadline, a wedged worker
the TSAN harness can't replay), nobody calls ``dump_merged_*`` because
nobody comes back. The flight recorder closes that gap the way an
aircraft FDR does: it keeps only the LAST ``capacity`` spans, events,
and counter deltas in a lock-protected ring, costs O(1) per record
regardless of run length, and gets dumped *for* you — by a watchdog
when a liveness probe goes quiet, at the pool's deadline-expiry raise,
and at interpreter exit — so the postmortem artifact exists precisely
when the run did not finish cleanly.

Stdlib-only, and opt-in like the rest of ``obs/``: instrumented layers
take ``flight=None`` and dark paths pay only the ``is None`` check
(the opt-in contract).

The dump is Chrome/Perfetto trace-event JSON on the same
``time.perf_counter`` clock as the merged timeline: each distinct
``src`` (coordinator, ``worker 3``, ...) becomes its own pid, so a
flight dump of a distributed run loads in ui.perfetto.dev with one
process track group per OS process — exactly like ``/trace``, just
truncated to the recent past.
"""

from __future__ import annotations

import atexit
import json
import threading
import time
from typing import Any, Callable

__all__ = ["FlightRecorder", "FlightWatchdog"]

_US = 1e6


class FlightRecorder:
    """Bounded ring of recent spans, instant events, and counter deltas.

    >>> fr = FlightRecorder(capacity=4096)
    >>> fr.event("respawn", src="coordinator", rank=2)
    >>> fr.span("tick 7", t0, dur, src="scheduler")
    >>> fr.counter("serving_tokens_total", 1280)   # stores the delta
    >>> fr.dump("flight.json")                     # Chrome trace JSON

    All record methods are thread-safe (reader threads, the scheduler,
    and watchdogs write concurrently) and O(1): at capacity the OLDEST
    entry is evicted (``evicted`` counts them) — the ring always holds
    the most recent history, which is the half a postmortem needs.

    ``counter`` records DELTAS: callers hand the current cumulative
    value and the ring stores how much it moved since the last record
    of that ``(src, name)`` — a hang postmortem reads "tokens stopped
    moving at t" straight off the ring without reconstructing totals.

    ``arm(path)`` sets the auto-dump destination used by watchdogs,
    :meth:`trip`, and the ``atexit`` hook (installed by ``arm``);
    every dump actually written is appended to ``dumps``.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        # (kind, src, track, name, t0_s, dur_s, args)
        self._ring: list[tuple] = []
        self._head = 0  # next write position once the ring is full
        self.evicted = 0
        self._last_counter: dict[tuple[str, str], float] = {}
        self._path: str | None = None
        self._atexit_installed = False
        self._watchdogs: list[FlightWatchdog] = []
        self.dumps: list[str] = []

    # -- recording --------------------------------------------------------
    def _append(self, entry: tuple) -> None:
        with self._lock:
            if len(self._ring) < self.capacity:
                self._ring.append(entry)
            else:
                self._ring[self._head] = entry
                self._head = (self._head + 1) % self.capacity
                self.evicted += 1

    def span(
        self, name: str, t0: float, dur: float, *,
        src: str = "coordinator", track: str = "main", **args,
    ) -> None:
        """A completed span: ``t0`` absolute ``perf_counter`` seconds,
        ``dur`` seconds (clamped at 0, the timeline discipline)."""
        self._append(
            ("X", str(src), str(track), str(name), float(t0),
             max(float(dur), 0.0), args)
        )

    def event(
        self, name: str, *, src: str = "coordinator",
        track: str = "main", t: float | None = None, **args,
    ) -> None:
        """An instant event (a respawn, a deadline expiry, a watchdog
        firing)."""
        self._append(
            ("I", str(src), str(track), str(name),
             time.perf_counter() if t is None else float(t), 0.0, args)
        )

    def counter(
        self, name: str, value: float, *, src: str = "coordinator",
        t: float | None = None,
    ) -> None:
        """One cumulative-counter reading; the ring stores the DELTA
        since the previous reading of this ``(src, name)`` (first
        reading: delta == value)."""
        key = (str(src), str(name))
        v = float(value)
        with self._lock:
            delta = v - self._last_counter.get(key, 0.0)
            self._last_counter[key] = v
        self._append(
            ("C", key[0], "main", key[1],
             time.perf_counter() if t is None else float(t), 0.0,
             {"value": v, "delta": delta})
        )

    def instants(self, name: str | None = None, *,
                 src: str | None = None) -> list[dict[str, Any]]:
        """Snapshot the ring's INSTANT events, oldest-first, optionally
        filtered by exact ``name`` and/or ``src`` — the in-memory half
        of the postmortem contract. The chaos plane's "flight recorder
        captures the episode" invariant reads this: an episode's
        shed/partition/storm instants must be on the ring at
        episode end, assertable without a file round-trip. Each entry:
        ``{"name", "src", "t", **args}``."""
        out: list[dict[str, Any]] = []
        for kind, esrc, _track, ename, t0, _dur, args in (
            self._entries_in_order()
        ):
            if kind != "I":
                continue
            if name is not None and ename != name:
                continue
            if src is not None and esrc != src:
                continue
            out.append({"name": ename, "src": esrc, "t": t0, **args})
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def __repr__(self) -> str:
        ev = f", {self.evicted} evicted" if self.evicted else ""
        return (
            f"FlightRecorder({len(self)}/{self.capacity} entries{ev}, "
            f"{len(self.dumps)} dumps)"
        )

    # -- dumping ----------------------------------------------------------
    def _entries_in_order(self) -> list[tuple]:
        with self._lock:
            return self._ring[self._head:] + self._ring[:self._head]

    def snapshot(self) -> dict[str, Any]:
        """The ring as a Chrome trace-event document (dict): one pid
        per distinct ``src``, spans as ``ph: X``, events as ``ph: I``,
        counter deltas as ``ph: C`` series carrying both the cumulative
        value and the delta."""
        entries = self._entries_in_order()
        pids: dict[str, int] = {}
        tids: dict[tuple[str, str], int] = {}
        meta: list[dict] = []
        events: list[dict] = []
        for kind, src, track, name, t0, dur, args in entries:
            pid = pids.get(src)
            if pid is None:
                pid = pids[src] = len(pids)
                meta.append({"name": "process_name", "ph": "M",
                             "pid": pid, "args": {"name": src}})
            tkey = (src, track)
            tid = tids.get(tkey)
            if tid is None:
                tid = tids[tkey] = sum(1 for s, _ in tids if s == src)
                meta.append({"name": "thread_name", "ph": "M",
                             "pid": pid, "tid": tid,
                             "args": {"name": track}})
            if kind == "X":
                events.append({"name": name, "ph": "X", "pid": pid,
                               "tid": tid, "ts": t0 * _US,
                               "dur": dur * _US, "args": args})
            elif kind == "I":
                events.append({"name": name, "ph": "I", "pid": pid,
                               "tid": tid, "ts": t0 * _US, "s": "p",
                               "args": args})
            else:  # "C"
                events.append({"name": name, "ph": "C", "pid": pid,
                               "ts": t0 * _US,
                               "args": {name: args["value"],
                                        "delta": args["delta"]}})
        if self.evicted:
            first_t = min((e[4] for e in entries), default=0.0)
            events.append({
                "name": f"[flight ring: {self.evicted} older entries "
                        "evicted]",
                "ph": "I", "pid": 0, "tid": 0, "ts": first_t * _US,
                "s": "g",
            })
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def dump(self, path: str | None = None) -> dict[str, Any]:
        """Write the ring (to ``path``, or the armed path, or nowhere)
        and return the trace document either way. Span/event ``args``
        are arbitrary user objects; anything json can't take degrades
        to its ``repr`` — a postmortem artifact with a stringified
        ndarray beats no artifact at all."""
        doc = self.snapshot()
        target = path if path is not None else self._path
        if target is not None:
            with open(target, "w") as f:
                json.dump(doc, f, default=repr)
            self.dumps.append(str(target))
        return doc

    # -- automatic dumps --------------------------------------------------
    def arm(self, path: str) -> "FlightRecorder":
        """Set the auto-dump path and install the ``atexit`` dump (the
        postmortem default: a run that dies without cleanup still
        leaves its last seconds on disk). Returns self for chaining."""
        self._path = str(path)
        if not self._atexit_installed:
            self._atexit_installed = True
            atexit.register(self._atexit_dump)
        return self

    def _atexit_dump(self) -> None:  # pragma: no cover - interpreter exit
        try:
            if self._path is not None:
                self.dump()
        except Exception:
            pass

    def trip(
        self, reason: str, *, src: str = "coordinator",
        path: str | None = None,
    ) -> None:
        """Emergency dump: record ``reason`` as an instant event and
        write the ring to ``path`` (default: the armed path; no-op
        write when neither exists — the event is still recorded).
        Called by the pool when a wait blows its deadline and by
        watchdogs (each with its OWN path); callable by anything that
        detects a hang."""
        self.event(f"[flight trip] {reason}", src=src)
        if path is not None or self._path is not None:
            try:
                self.dump(path)
            except Exception:
                # trip() runs immediately before the caller raises the
                # REAL failure (DeadWorkerError, a hang diagnosis);
                # nothing the dump throws — full disk, a pathological
                # ring entry — may mask that
                pass

    def watchdog(
        self, name: str, activity: Callable[[], float | None],
        stall_s: float, *, path: str | None = None,
    ) -> "FlightWatchdog":
        """Start a liveness watchdog: ``activity()`` returns the
        ``perf_counter`` stamp of the watched subsystem's last sign of
        life (None = not yet started, never stuck). When the stamp goes
        stale by more than ``stall_s`` the ring is dumped once per
        stall episode — it re-arms when activity resumes. ``path`` is
        THIS watchdog's dump destination (each watchdog keeps its own;
        the recorder's armed path is the fallback), so two watchdogs
        with different paths never clobber each other's artifact.
        Returns the started :class:`FlightWatchdog` (``stop()`` it, or
        :meth:`close` the recorder)."""
        wd = FlightWatchdog(self, name, activity, stall_s, path=path)
        self._watchdogs.append(wd)
        return wd

    def close(self) -> None:
        """Stop every watchdog thread (the ring itself stays usable)."""
        for wd in self._watchdogs:
            wd.stop()
        self._watchdogs.clear()


class FlightWatchdog:
    """Background liveness probe that trips a flight dump on stall.

    One daemon thread polling at ``stall_s / 4`` (floored at 10 ms):
    cheap enough to leave on in production, fast enough that a dump
    lands within ~1.25x the stall threshold of the actual hang.
    """

    def __init__(
        self, flight: FlightRecorder, name: str,
        activity: Callable[[], float | None], stall_s: float,
        *, path: str | None = None,
    ):
        if stall_s <= 0:
            raise ValueError(f"stall_s must be > 0, got {stall_s}")
        self.flight = flight
        self.name = str(name)
        self.activity = activity
        self.path = None if path is None else str(path)
        self.stall_s = float(stall_s)
        self.fired = 0
        self._stop = threading.Event()
        self._armed = True
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"flight-watchdog-{name}",
        )
        self._thread.start()

    def _loop(self) -> None:
        poll = max(self.stall_s / 4.0, 0.01)
        while not self._stop.wait(poll):
            try:
                last = self.activity()
            except Exception:
                continue  # a racy probe must not kill the watchdog
            if last is None:
                continue
            stale = time.perf_counter() - last
            if stale > self.stall_s:
                if self._armed:
                    self._armed = False
                    self.fired += 1
                    self.flight.trip(
                        f"watchdog {self.name!r}: no activity for "
                        f"{stale:.3f}s (> {self.stall_s}s)",
                        path=self.path,
                    )
            else:
                self._armed = True  # activity resumed; re-arm

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
