"""Trace replay: re-run a recorded fleet under a different policy.

A copy of the JAX package's ``sim/replay.py`` (stdlib and numpy, no
torch and no OS clock): the same trace or schedule gives the same
virtual timeline in either package.

The record -> replay loop, closed on virtual time: a run traced with an
:class:`~..utils.trace.EpochTracer` (live object, ``dump_jsonl`` file,
or the Chrome/Perfetto documents the obs/ plane exports) becomes a
:class:`ReplayTrace` — per-(worker, epoch) round-trips plus per-epoch
metadata — and :func:`replay` re-executes it through the REAL
``asyncmap``/``waitall`` on a :class:`~.backend.SimBackend`, possibly
under a *different* ``nwait``, reporting counterfactual epoch latency,
fresh-worker sets, and staleness. "What would last night's straggler
incident have cost at nwait=5?" is one function call, in milliseconds.

Replay label contract (what :meth:`ReplayTrace.from_chrome` parses —
the format :meth:`~..utils.trace.EpochTracer.chrome_events` emits and
``dump_merged_chrome_trace``/``/trace`` embed): per-worker task spans
named ``epoch <N>`` (stale ones suffixed `` (stale)``) with ``tid`` =
worker index, and coordinator spans named
``asyncmap(epoch=<N>, nwait=<k>)`` on ``tid`` -1, all within one
"pool" process. Chrome docs without pool worker spans (e.g. a bare
flight ring of coordinator spans) cannot seed per-worker replay and
are rejected with a pointer to the JSONL path.

Fidelity: recorded round-trips are injected as sim delays, so replay
reproduces arrival *order* up to the true compute time of the original
workload (microseconds under millisecond-scale delays) and epoch walls
up to coordinator overhead — the drift :func:`compare` quantifies and
the bench `sim` rung tracks.
"""

from __future__ import annotations

import json
from typing import Any, Sequence

import numpy as np

from ..pool import AsyncPool, asyncmap, waitall
from ..utils.faults import from_trace
from .backend import SimBackend
from .clock import VirtualClock

__all__ = [
    "ReplayTrace", "ReplayResult", "replay", "compare",
    "replay_router_day",
]


def replay_router_day(
    router, path, *, events=(), retry=None, fast: str = "auto",
    timer=None,
):
    """Replay a recorded arrival stream (a
    :func:`~.workload.dump_arrivals_jsonl` file) through ``router`` —
    the router-plane sibling of :func:`replay`. ``fast="auto"``
    (default) runs the day on the vectorized
    :func:`~.fastpath.run_router_day_fast` engine where the day shape
    supports it (bit-identical ``digest()``, ``report.fastpath`` names
    the path taken); ``fast="never"`` pins the scalar loop, the parity
    reference. Counterfactuals — "what would yesterday's traffic have
    cost under prefix_affinity?" — are one router construction plus
    this call, in milliseconds."""
    from .tune import _resolve_fast
    from .workload import arrivals_from_jsonl, run_router_day

    arrivals = arrivals_from_jsonl(path)
    if _resolve_fast(fast):
        from .fastpath import run_router_day_fast

        return run_router_day_fast(
            router, arrivals, events=events, retry=retry, timer=timer,
        )
    return run_router_day(
        router, arrivals, events=events, retry=retry, timer=timer,
    )


class _EpochSnap:
    """Per-``asyncmap`` metadata from the recorded run."""

    __slots__ = ("epoch", "nwait", "wall", "fresh", "n_workers")

    def __init__(self, epoch, nwait, wall, fresh, n_workers):
        self.epoch = int(epoch)
        self.nwait = nwait  # int or "<callable>"
        self.wall = float(wall)
        self.fresh = frozenset(int(w) for w in fresh)
        self.n_workers = int(n_workers)

    def __repr__(self) -> str:
        return (
            f"_EpochSnap(e{self.epoch}, nwait={self.nwait}, "
            f"wall={self.wall:.4f}, fresh={sorted(self.fresh)})"
        )


class ReplayTrace:
    """A recorded run in replayable form.

    ``records`` is the list of :meth:`~..utils.trace.EpochRecord.to_dict`
    dicts (the JSONL line format); construction derives the per-epoch
    snapshots and the (worker, epoch) latency table.
    """

    def __init__(self, records: Sequence[dict]):
        self.records = [dict(r) for r in records]
        if not self.records:
            raise ValueError("empty trace: nothing to replay")
        self.epochs: list[_EpochSnap] = []
        n_workers = 0
        for rec in self.records:
            rep = rec.get("repochs") or []
            n_workers = max(n_workers, len(rep))
            if rec.get("call") != "asyncmap":
                continue
            epoch = int(rec["epoch"])
            fresh = [i for i, r in enumerate(rep) if int(r) == epoch]
            self.epochs.append(
                _EpochSnap(
                    epoch, rec.get("nwait"), rec.get("wall_s", 0.0),
                    fresh, len(rep),
                )
            )
        if not self.epochs:
            raise ValueError(
                "trace holds no asyncmap records (a bare waitall drain "
                "has no epoch policy to replay)"
            )
        self.n_workers = n_workers

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_tracer(cls, tracer) -> "ReplayTrace":
        """From a live :class:`~..utils.trace.EpochTracer` (no file)."""
        return cls([r.to_dict() for r in tracer.records])

    @classmethod
    def from_jsonl(cls, path) -> "ReplayTrace":
        """From an ``EpochTracer.dump_jsonl`` file."""
        with open(path) as f:
            return cls([json.loads(line) for line in f if line.strip()])

    @classmethod
    def from_chrome(cls, doc, *, n_workers: int | None = None) -> "ReplayTrace":
        """From a Chrome trace-event document (dict, or a path to one):
        the ``/trace`` endpoint's merged output, a
        ``dump_merged_chrome_trace`` file, or a bare
        ``EpochTracer.dump_chrome_trace``. Reconstructs epoch records
        from the pool process's spans per the replay label contract
        (module docstring).

        Format caveat: the Chrome doc only draws spans for tasks that
        ARRIVED, so a worker dead/stalled for the entire recording has
        no track at all and the fleet size is inferred one short —
        pass ``n_workers=`` explicitly to replay such an incident (the
        missing rank then replays as the ``missing``-stall fallback),
        or prefer ``from_jsonl``/``from_tracer``, whose records carry
        the true width in ``repochs``."""
        if not isinstance(doc, dict):
            with open(doc) as f:
                doc = json.load(f)
        events = doc.get("traceEvents", [])
        # pool processes are the pids whose process_name metadata says
        # "pool" (EpochTracer.chrome_events contract); a single-tracer
        # dump has exactly one, a merged doc may interleave several —
        # replay the first
        pool_pids = sorted(
            e["pid"] for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"
            and e.get("args", {}).get("name") == "pool"
        )
        if not pool_pids:
            raise ValueError(
                "no 'pool' process in the Chrome doc: per-worker replay "
                "needs EpochTracer spans (record with tracer= and use "
                "dump_jsonl/dump_chrome_trace, or merge the tracer into "
                "the /trace document)"
            )
        pid = pool_pids[0]
        us = 1e6
        coord: list[dict] = []   # asyncmap/waitall call spans
        tasks: list[dict] = []   # per-worker task spans
        for e in events:
            if e.get("pid") != pid or e.get("ph") != "X":
                continue
            if e.get("tid") == -1:
                coord.append(e)
            elif isinstance(e.get("tid"), int) and e["tid"] >= 0:
                tasks.append(e)
        if not tasks:
            raise ValueError(
                "pool process has no worker task spans: the doc cannot "
                "seed per-worker replay (see the replay label contract)"
            )
        records: list[dict] = []
        import re

        if n_workers is None:
            n_workers = max(t["tid"] for t in tasks) + 1
        n_workers = int(n_workers)
        for c in sorted(coord, key=lambda e: e["ts"]):
            m = re.match(
                r"(asyncmap|waitall)\(epoch=(-?\d+), nwait=(.+)\)",
                c.get("name", ""),
            )
            if not m:
                continue
            call, epoch = m.group(1), int(m.group(2))
            nwait = (
                int(m.group(3)) if m.group(3).lstrip("-").isdigit()
                else m.group(3)
            )
            t0, t1 = c["ts"], c["ts"] + c.get("dur", 0.0)
            events_out, repochs = [], [0] * n_workers
            latency = [0.0] * n_workers
            for t in tasks:
                te = t["ts"] + t.get("dur", 0.0)
                if not (t0 <= te <= t1 + 1e-3):
                    continue  # arrival outside this call span
                em = re.match(r"epoch (-?\d+)", t.get("name", ""))
                if not em:
                    continue
                sepoch, w = int(em.group(1)), int(t["tid"])
                lat = t.get("dur", 0.0) / us
                events_out.append({
                    "t": (t["ts"] - t0) / us, "kind": "dispatch",
                    "worker": w, "epoch": sepoch,
                })
                events_out.append({
                    "t": (te - t0) / us, "kind": "arrival", "worker": w,
                    "epoch": sepoch,
                    "fresh": bool(t.get("args", {}).get("fresh", True)),
                })
                repochs[w] = max(repochs[w], sepoch)
                latency[w] = lat
            records.append({
                "epoch": epoch, "call": call, "nwait": nwait,
                "wall_s": c.get("dur", 0.0) / us, "repochs": repochs,
                "latency_s": latency,
                "events": sorted(events_out, key=lambda e: e["t"]),
            })
        return cls(records)

    # -- derived ----------------------------------------------------------
    def delay_fn(self, *, missing: float | None = None):
        """The recorded latencies as a deterministic
        :data:`~..backends.base.DelayFn` (``utils.faults.from_trace``
        fallback semantics: absent epochs replay at that worker's
        median, never-heard workers as long stalls)."""
        return from_trace.from_records(self.records, missing=missing)

    def recorded_nwaits(self) -> list[int]:
        out = []
        for e in self.epochs:
            if not isinstance(e.nwait, int):
                raise ValueError(
                    f"epoch {e.epoch} was recorded with a callable "
                    "nwait; pass an explicit nwait= to replay()"
                )
            out.append(e.nwait)
        return out

    def __repr__(self) -> str:
        return (
            f"ReplayTrace({len(self.epochs)} epochs, "
            f"{self.n_workers} workers)"
        )


class ReplayResult:
    """Counterfactual outcome of one replay.

    ``epochs`` rows: ``epoch``, ``nwait`` (the policy replayed),
    ``wall`` (virtual seconds), ``fresh`` (frozenset of fresh workers),
    ``n_stale`` harvested that epoch.
    """

    def __init__(self, nwait_label, rows: list[dict], backend: SimBackend):
        self.nwait = nwait_label
        self.epochs = rows
        self.backend = backend

    @property
    def walls(self) -> np.ndarray:
        return np.array([r["wall"] for r in self.epochs])

    def summary(self) -> dict[str, Any]:
        walls = self.walls
        fresh = [len(r["fresh"]) for r in self.epochs]
        return {
            "nwait": self.nwait,
            "epochs": len(self.epochs),
            "wall_total_s": float(walls.sum()),
            "wall_mean_s": float(walls.mean()),
            "wall_p95_s": float(np.percentile(walls, 95)),
            "fresh_mean": float(np.mean(fresh)),
            "n_stale": int(sum(r["n_stale"] for r in self.epochs)),
            "staleness_rate": float(
                sum(r["n_stale"] for r in self.epochs)
                / max(self.backend.n_delivered, 1)
            ),
        }

    def __repr__(self) -> str:
        s = self.summary()
        return (
            f"ReplayResult(nwait={s['nwait']}, {s['epochs']} epochs, "
            f"mean {s['wall_mean_s']*1e3:.2f} ms)"
        )


def replay(
    trace: ReplayTrace,
    *,
    nwait: int | None = None,
    work_fn=None,
    payload=None,
    missing: float | None = None,
    drain: bool = True,
    clock: VirtualClock | None = None,
    registry=None,
    spans=None,
) -> ReplayResult:
    """Re-run ``trace`` through the real pool on virtual time.

    ``nwait=None`` replays each epoch under its RECORDED nwait (the
    faithfulness baseline — :func:`compare` against the trace validates
    the simulator); an int replays the counterfactual policy. The
    same epoch numbers are reused so the trace's (worker, epoch) delay
    table lines up. ``registry=`` / ``spans=`` thread through to the
    :class:`~.backend.SimBackend` (opt-in).
    """
    if work_fn is None:
        work_fn = _echo
    if payload is None:
        payload = np.zeros(1, dtype=np.float64)
    backend = SimBackend(
        work_fn, trace.n_workers,
        delay_fn=trace.delay_fn(missing=missing),
        clock=clock if clock is not None else VirtualClock(),
        registry=registry, spans=spans,
    )
    pool = AsyncPool(trace.n_workers)
    nwaits = (
        trace.recorded_nwaits() if nwait is None
        else [int(nwait)] * len(trace.epochs)
    )
    rows: list[dict] = []
    for snap, k in zip(trace.epochs, nwaits):
        t0 = backend.clock.now()
        # count stale harvests over only THIS call's deliveries (a
        # full-list rescan per epoch would make replay quadratic)
        ev0 = len(backend.events)
        asyncmap(pool, payload, backend, nwait=k, epoch=snap.epoch)
        rows.append({
            "epoch": snap.epoch,
            "nwait": k,
            "wall": backend.clock.now() - t0,
            "fresh": frozenset(int(i) for i in pool.fresh_indices()),
            "n_stale": sum(
                1 for e in backend.events[ev0:] if e.epoch < snap.epoch
            ),
        })
    if drain and pool.active.any():
        waitall(pool, backend)
    return ReplayResult(
        "recorded" if nwait is None else int(nwait), rows, backend
    )


def _echo(i, payload, epoch):
    """Default replay workload: the payload itself (the recorded run's
    numerics are gone; only its timing is being replayed)."""
    return payload


def compare(trace: ReplayTrace, result: ReplayResult) -> dict[str, Any]:
    """Drift between a recorded run and its (same-policy) replay.

    ``fresh_exact_rate`` is the headline fidelity claim — the fraction
    of epochs whose fresh-worker SET reproduced exactly; wall drift
    quantifies how much coordinator/compute overhead the recorded
    walls carried that injected delays cannot (``sim`` bench rung).
    """
    by_epoch = {r["epoch"]: r for r in result.epochs}
    matched, jaccard, drift_abs, drift_rel = [], [], [], []
    for snap in trace.epochs:
        row = by_epoch.get(snap.epoch)
        if row is None:
            continue
        matched.append(row["fresh"] == snap.fresh)
        union = row["fresh"] | snap.fresh
        jaccard.append(
            len(row["fresh"] & snap.fresh) / len(union) if union else 1.0
        )
        drift_abs.append(abs(row["wall"] - snap.wall))
        if snap.wall > 0:
            drift_rel.append(abs(row["wall"] - snap.wall) / snap.wall)
    n = len(matched)
    return {
        "epochs": n,
        "fresh_exact_rate": float(np.mean(matched)) if n else 0.0,
        "fresh_jaccard_mean": float(np.mean(jaccard)) if n else 0.0,
        "wall_drift_mean_s": float(np.mean(drift_abs)) if n else 0.0,
        "wall_drift_max_s": float(np.max(drift_abs)) if n else 0.0,
        "wall_drift_rel_mean": (
            float(np.mean(drift_rel)) if drift_rel else 0.0
        ),
    }
