"""Chaos episode outcomes: pinned invariants and the digest witness.

A copy of ``mpistragglers_jl_tpu/chaos/report.py``, not an import of it
(the port never imports the JAX package). Stdlib and numpy, no torch,
and no OS clock: the same seeded inputs give the same records in either
package.

An episode that "mostly worked" is worthless to the chaos plane — the
whole point is a small set of survival invariants that either HELD or
the run fails by name. :class:`InvariantViolation` is that failure
(raised inside the run, at the probe that saw the violation, so the
flight recorder still holds the episode when it fires), and
:class:`ChaosReport` is the evidence when everything held: the
episode's counters, the invariant checklist that ran, and
:meth:`ChaosReport.digest` — a sha256 content hash over the workload's
bit-identity witness plus every chaos-plane counter, so two runs of
the same seeded scenario must agree on ONE short string
(the :class:`~..sim.workload.WorkloadReport` digest contract, extended
over the chaos counters that report does not hash).
"""

from __future__ import annotations

import hashlib

__all__ = ["ChaosReport", "InvariantViolation"]


class InvariantViolation(AssertionError):
    """A pinned survival invariant failed INSIDE a chaos episode —
    named, at the virtual time it was seen. An AssertionError so test
    harnesses treat it as a hard failure, never an environment skip."""


def percentile(values, q: float) -> float:
    """Nearest-rank percentile over a list (stdlib-only — the chaos
    plane never imports numpy): 0 on empty input, exact order
    statistic otherwise."""
    if not values:
        return 0.0
    vs = sorted(values)
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    idx = min(int(q / 100.0 * (len(vs) - 1) + 0.5), len(vs) - 1)
    return float(vs[idx])


def windowed_p99_ttft(report, t0: float, t1: float) -> float:
    """p99 TTFT (nearest-rank) over the SERVED requests submitted in
    ``[t0, t1)`` — the before/after lens the metastable-recovery claim
    is stated through."""
    vals = [
        r.ttft for r in report.requests
        if t0 <= r.t_submit < t1 and r.ttft is not None
    ]
    return percentile(vals, 99.0)


class ChaosReport:
    """Evidence of one survived episode.

    ``workload`` is the day's :class:`~..sim.workload.WorkloadReport`
    (None for non-day scenarios like the page-churn episode);
    ``invariants`` lists the named checks that RAN (every one of them
    passed — a failing check raises :class:`InvariantViolation`
    instead of reporting); ``extras`` carries scenario-specific
    scalars (recovery factors, churn counters) that fold into the
    digest deterministically."""

    def __init__(self, scenario: str, seed: int, *, workload=None,
                 max_queue_depth: int = 0, n_probes: int = 0,
                 invariants: tuple[str, ...] = (),
                 extras: dict | None = None):
        self.scenario = str(scenario)
        self.seed = int(seed)
        self.workload = workload
        self.max_queue_depth = int(max_queue_depth)
        self.n_probes = int(n_probes)
        self.invariants = tuple(str(i) for i in invariants)
        self.extras = dict(extras or {})
        # chaos-plane counters lifted off the workload report (0 for
        # non-day scenarios)
        w = workload
        self.n_requests = 0 if w is None else int(w.n)
        self.n_shed = 0 if w is None else int(w.n_shed)
        self.n_resubmits = 0 if w is None else int(w.n_resubmits)
        self.n_partitions = 0 if w is None else int(w.n_partitions)
        self.n_stale_cancelled = (
            0 if w is None else int(w.n_stale_cancelled)
        )
        self.dropped = 0 if w is None else int(w.dropped)
        self.shed_reasons: dict[str, int] = (
            {} if w is None else dict(w.shed_reasons)
        )

    @property
    def shed_named_pct(self) -> float:
        """Percentage of shed requests carrying a reason — the
        shed-by-name invariant's scalar (100.0 when nothing shed:
        an empty drop set is vacuously all-named)."""
        if self.n_shed == 0:
            return 100.0
        return 100.0 * sum(self.shed_reasons.values()) / self.n_shed

    def digest(self) -> str:
        """sha256[:16] over the workload's bit-identity witness and
        every chaos counter — the one-line string two replays of the
        same seeded episode must agree on."""
        h = hashlib.sha256()
        h.update(self.scenario.encode())
        h.update(str(self.seed).encode())
        if self.workload is not None:
            h.update(self.workload.digest().encode())
        for key in ("n_requests", "n_shed", "n_resubmits",
                    "n_partitions", "n_stale_cancelled", "dropped",
                    "max_queue_depth"):
            h.update(f"{key}={getattr(self, key)};".encode())
        for reason in sorted(self.shed_reasons):
            h.update(
                f"shed[{reason}]={self.shed_reasons[reason]};".encode()
            )
        for k in sorted(self.extras):
            v = self.extras[k]
            if isinstance(v, float):
                v = f"{v:.9g}"
            h.update(f"extra[{k}]={v};".encode())
        return h.hexdigest()[:16]

    def __repr__(self) -> str:
        return (
            f"ChaosReport({self.scenario!r}, seed={self.seed}, "
            f"n={self.n_requests}, shed={self.n_shed}, "
            f"resubmits={self.n_resubmits}, "
            f"max_depth={self.max_queue_depth}, "
            f"digest={self.digest()})"
        )
