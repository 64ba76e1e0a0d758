"""Request-scoped causal tracing: one record per request, door to door.

Spans time *components* and counters aggregate *planes*; the
:class:`TraceBook` follows ONE request through every plane it crosses —
the router door, the DRR queue, a prefill tier, a KV-page migration, a
hedge race, a retry resubmission — as a flat list of typed events on
the owner's injected clock. That makes the record:

* **engine-agnostic** — the identical code path stamps live runs (wall
  clock) and sim runs (virtual clock); the book itself never reads a
  clock, callers pass ``t`` explicitly (so replayed days stay deterministic);
* **deterministic** — trace ids mint in submission order and events
  append in code order on virtual timestamps, so a seeded sim day
  yields byte-identical books across replays;
* **digest-neutral** — tracing draws no randomness and never perturbs
  virtual timing, so ``WorkloadReport.digest()`` is unchanged whether
  a day ran dark or traced.

Everything is strictly OPT-IN: instrumented
layers accept ``trace=`` defaulting to ``None`` and dark paths pay one
``is None`` check — no allocation, no clock reads.

Event taxonomy (the full set stamped by the serving planes):

========================  ============================================
kind                      stamped by / meaning
========================  ============================================
``submitted``             router/scheduler door; attrs: tenant, prompt
``shed``                  admission refusal; attrs: reason
``drr_queued``            DRR admission queue entry; attrs: tenant
``drr_picked``            DRR grant; attrs: tenant, cost
``admitted``              placed into a slot; attrs: replica/tick
``prefill_chunk``         one prompt chunk advanced; attrs: replica
``first_token``           first decode token surfaced
``share_hit``             prefix page shared instead of prefilled
``cow_copy``              copy-on-write fork of a shared page
``migrate_out``           KV pages captured; attrs: replica, nbytes
``adopt``                 pages landed; attrs: replica (``bounced``
                          when the dest died mid-flight)
``hedge_armed``           hedge deadline armed; attrs: fire_at
``hedge_fired``           second leg dispatched; attrs: replica
``hedge_won``             the HEDGE leg's token won the race
``hedge_cancelled``       the hedge leg lost the race and was reaped
``hedge_abandoned``       a hedge leg lost to a kill/partition, not
                          to the race; attrs: replica
``partition_abandoned``   leg unreachable behind a partition
``rerouted``              fresh leg on a surviving replica
``evacuated``             leg lost to a dead replica; attrs: replica
``evacuated_on_resize``   fleet controller drained the replica
``retry_resubmit``        timed-out request resubmitted; stamped on
                          the CHILD trace; attrs: parent, attempt
``retired``               served to completion; attrs: outcome,
                          tokens
``cancelled``             terminal cancel (timeout reap, shutdown)
========================  ============================================

Terminal kinds (``shed`` / ``retired`` / ``cancelled``) are stamped
exactly once per trace, by the request's OWNER (router or scheduler),
never by a replica reaping an individual leg — that is what makes the
conservation audit (:mod:`.audit`) decidable.
"""

from __future__ import annotations

from typing import Any, Iterator

__all__ = ["TraceBook", "TERMINAL_KINDS"]

_US = 1e6  # seconds -> Chrome trace microseconds

#: Kinds that close a trace. Exactly one per submitted request.
TERMINAL_KINDS = ("retired", "shed", "cancelled")

#: Waterfall phases derived from event pairs (start kind, end kinds,
#: phase name) — the queued/prefill/decode decomposition of a request's
#: lifetime, rendered as nested Chrome spans.
_PHASES = (
    ("submitted", ("admitted", "first_token") + TERMINAL_KINDS,
     "queued"),
    ("admitted", ("first_token",) + TERMINAL_KINDS, "prefill"),
    ("first_token", TERMINAL_KINDS, "decode"),
)


class TraceBook:
    """Mint trace ids and append typed lifecycle events.

    The book is a dumb, fast store: ``mint()`` hands out dense integer
    ids in call order, ``event()`` appends ``(kind, t, attrs)`` tuples.
    All derived views (waterfalls, cohorts, the Chrome export) walk the
    raw lists on demand — nothing is indexed at append time, so the
    traced hot path stays one list-append per transition.

    Not thread-safe by design: each book belongs to one serving plane
    on one clock, the same ownership discipline as ``SpanRecorder``.
    """

    __slots__ = ("_events", "_parent", "_children", "name")

    def __init__(self, name: str = "traces"):
        self.name = name
        self._events: list[list[tuple[str, float, dict | None]]] = []
        self._parent: dict[int, int] = {}
        self._children: dict[int, list[int]] = {}

    # -- write path -------------------------------------------------------

    def mint(self, *, parent: int | None = None) -> int:
        """Allocate the next trace id (dense, submission-ordered).

        ``parent`` links a retry resubmission's child trace back to
        the timed-out original; the link is navigable both ways."""
        tid = len(self._events)
        self._events.append([])
        if parent is not None:
            self._parent[tid] = int(parent)
            self._children.setdefault(int(parent), []).append(tid)
        return tid

    def link(self, child: int, parent: int) -> None:
        """Link ``child`` to ``parent`` after the fact — the retry
        loop's hook: the router mints the resubmission's trace as a
        fresh door entry, and the retry client (which alone knows the
        chain) attaches the lineage."""
        child, parent = int(child), int(parent)
        if self._parent.get(child) == parent:
            return
        self._parent[child] = parent
        self._children.setdefault(parent, []).append(child)

    def event(self, tid: int, kind: str, t: float, **attrs: Any) -> None:
        """Append one typed event at caller-provided time ``t``.

        The caller holds the clock (injected wall or virtual) — the
        book never reads one, so the same call site is legal in
        clock-free packages (sim/, qos/)."""
        self._events[tid].append((kind, float(t), attrs or None))

    # -- read path --------------------------------------------------------

    def __len__(self) -> int:
        return len(self._events)

    def __contains__(self, tid: int) -> bool:
        return 0 <= int(tid) < len(self._events)

    def ids(self) -> range:
        return range(len(self._events))

    def events(self, tid: int) -> list[tuple[str, float, dict | None]]:
        """The raw ``(kind, t, attrs)`` list for one trace."""
        return self._events[tid]

    def kinds(self, tid: int) -> list[str]:
        return [k for k, _, _ in self._events[tid]]

    def parent(self, tid: int) -> int | None:
        return self._parent.get(tid)

    def children(self, tid: int) -> list[int]:
        return list(self._children.get(tid, ()))

    def find(self, tid: int, kind: str) -> tuple[str, float, dict | None] | None:
        """First event of ``kind`` on trace ``tid``, or None."""
        for ev in self._events[tid]:
            if ev[0] == kind:
                return ev
        return None

    def find_last(self, tid: int, kind: str) -> tuple[str, float, dict | None] | None:
        """LAST event of ``kind`` — the one the scheduler's own
        bookkeeping reflects for stamps a re-route resets and
        re-records (``admitted``, ``first_token``)."""
        for ev in reversed(self._events[tid]):
            if ev[0] == kind:
                return ev
        return None

    def terminal(self, tid: int) -> tuple[str, float, dict | None] | None:
        """The trace's terminal event (retired/shed/cancelled), or
        None while the request is still in flight."""
        for ev in self._events[tid]:
            if ev[0] in TERMINAL_KINDS:
                return ev
        return None

    def iter_events(
        self,
    ) -> Iterator[tuple[int, str, float, dict | None]]:
        """All events across all traces as ``(tid, kind, t, attrs)``."""
        for tid, evs in enumerate(self._events):
            for kind, t, attrs in evs:
                yield tid, kind, t, attrs

    # -- derived views ----------------------------------------------------

    def cohort(self, tid: int) -> str:
        """The request cohort a trace belongs to — the Perfetto track
        grouping: how did this request's day actually go?"""
        kinds = set(self.kinds(tid))
        if "shed" in kinds:
            return "shed"
        if "cancelled" in kinds:
            return "cancelled"
        if "retired" not in kinds:
            return "open"
        if "hedge_fired" in kinds:
            return "hedged"
        if "migrate_out" in kinds:
            return "migrated"
        if "rerouted" in kinds or "retry_resubmit" in kinds:
            return "rescued"
        return "served"

    def waterfall(self, tid: int) -> dict:
        """One request's life as JSON — the ``GET /trace/<id>`` body.

        Timestamps are the owner's clock verbatim; ``ttft`` and
        ``latency`` are derived from the SAME stamps the scheduler's
        own bookkeeping uses, so they reproduce it exactly."""
        tid = int(tid)
        if tid not in self:
            raise KeyError(f"unknown trace id {tid}")
        evs = self._events[tid]
        t0 = evs[0][1] if evs else 0.0
        # LAST first_token: a re-route restarts the stream and the
        # scheduler's TTFT stamp restarts with it
        first_tok = self.find_last(tid, "first_token")
        term = self.terminal(tid)
        return {
            "trace": tid,
            "cohort": self.cohort(tid),
            "parent": self._parent.get(tid),
            "children": self.children(tid),
            "t0": t0,
            "ttft": None if first_tok is None else first_tok[1] - t0,
            "latency": None if term is None else term[1] - t0,
            "outcome": None if term is None else term[0],
            "events": [
                {"kind": k, "t": t, "dt": t - t0, "attrs": a or {}}
                for k, t, a in evs
            ],
        }

    def audit_view(self) -> dict:
        """Aggregate counts the audit and ``GET /audit`` both read."""
        n_open = n_retired = n_shed = n_cancelled = 0
        for tid in self.ids():
            term = self.terminal(tid)
            if term is None:
                n_open += 1
            elif term[0] == "retired":
                n_retired += 1
            elif term[0] == "shed":
                n_shed += 1
            else:
                n_cancelled += 1
        return {
            "traces": len(self),
            "open": n_open,
            "retired": n_retired,
            "shed": n_shed,
            "cancelled": n_cancelled,
            "retry_children": len(self._parent),
        }

    # -- chrome export ----------------------------------------------------

    def chrome_events(
        self, pid: int = 0
    ) -> tuple[list[dict], list[dict]]:
        """(metadata events, span events) under process ``pid`` — the
        merge contract shared with ``SpanRecorder.chrome_events``.

        One Chrome *thread* (track) per request cohort; each trace
        renders as an outer ``req#<id>`` span with nested
        queued/prefill/decode phase spans, so the merged Perfetto doc
        shows the request waterfalls alongside the component spans."""
        cohorts: list[str] = []
        tid_of: dict[str, int] = {}
        meta: list[dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": self.name}},
        ]
        events: list[dict[str, Any]] = []
        for trace_id in self.ids():
            evs = self._events[trace_id]
            if not evs:
                continue
            cohort = self.cohort(trace_id)
            if cohort not in tid_of:
                tid_of[cohort] = len(cohorts)
                cohorts.append(cohort)
                meta.append(
                    {"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid_of[cohort], "args": {"name": cohort}}
                )
            tid = tid_of[cohort]
            t0, t_end = evs[0][1], evs[-1][1]
            events.append({
                "name": f"req#{trace_id}", "ph": "X", "pid": pid,
                "tid": tid, "ts": t0 * _US,
                "dur": max(t_end - t0, 0.0) * _US,
                "args": {"cohort": cohort, "events": len(evs)},
            })
            for start_kind, end_kinds, phase in _PHASES:
                start = self.find(trace_id, start_kind)
                if start is None:
                    continue
                end = None
                for ev in evs:
                    if ev[0] in end_kinds and ev[1] >= start[1]:
                        end = ev
                        break
                if end is None:
                    continue
                events.append({
                    "name": phase, "ph": "X", "pid": pid, "tid": tid,
                    "ts": start[1] * _US,
                    "dur": max(end[1] - start[1], 0.0) * _US,
                    "args": {"trace": trace_id},
                })
        return meta, events

    def __repr__(self) -> str:
        v = self.audit_view()
        return (
            f"TraceBook({self.name!r}, {v['traces']} traces: "
            f"{v['retired']} retired, {v['shed']} shed, "
            f"{v['cancelled']} cancelled, {v['open']} open)"
        )
