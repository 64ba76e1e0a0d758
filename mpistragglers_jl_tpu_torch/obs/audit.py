"""Conservation audit: the prose claims as executable invariants.

CHANGES.md says "counter-verified" a dozen times; this module turns
those claims into a check you can arm on any run. Given a
:class:`~.tracing.TraceBook` (and optionally the day's
``WorkloadReport`` and a ``MetricsRegistry``), :func:`audit` proves:

* **resolution** — every submitted trace resolves EXACTLY once
  (retired xor shed xor cancelled): no orphans at end of day, no
  double-retire even across partition heals;
* **timing** — per-trace waterfall TTFT/latency equal the scheduler's
  own bookkeeping bit-for-bit (same clock stamps, same subtraction);
* **tokens** — decoded tokens per the trace records == the report's
  per-request token counts == ``serving_tokens_total``;
* **hedges** — hedge legs cancelled == fired − won − abandoned
  (abandoned = lost to a kill/partition, not to the race);
* **migration** — every ``migrate_out`` lands exactly one ``adopt``
  (bounces included), and captured bytes ==
  ``disagg_migrated_bytes_total``;
* **pages** — share/COW event counts ==
  ``serving_prefix_share_hits_total`` / ``serving_cow_copies_total``,
  and (when a pool is passed) the pool drained back to its baseline;
* **reconciliation** — book cohort counts match the report's outcome
  counts when the whole day was traced.

Each failure is NAMED — invariant, detail, and the offending trace
ids — so a red audit is a postmortem lead, not a boolean. Registry
cross-checks that have no matching counters (e.g. a sim day with no
``registry=`` armed) are recorded as *skipped*, never silently passed.

Signature: ``audit(book, report, registry)``
— both cross-check arms optional, live snapshots (mid-run, no report)
check what is decidable and count the rest as open.
"""

from __future__ import annotations

from typing import Any

from .tracing import TraceBook

__all__ = ["audit", "AuditResult", "AuditFailure"]


class AuditFailure:
    """One named invariant violation with its offending trace ids."""

    __slots__ = ("invariant", "detail", "trace_ids")

    def __init__(self, invariant: str, detail: str,
                 trace_ids: list[int] | None = None):
        self.invariant = invariant
        self.detail = detail
        self.trace_ids = list(trace_ids or ())

    def to_dict(self) -> dict:
        return {
            "invariant": self.invariant,
            "detail": self.detail,
            "trace_ids": self.trace_ids,
        }

    def __repr__(self) -> str:
        ids = ""
        if self.trace_ids:
            shown = ", ".join(map(str, self.trace_ids[:8]))
            more = len(self.trace_ids) - 8
            ids = f" [traces {shown}{f' +{more} more' if more > 0 else ''}]"
        return f"AuditFailure({self.invariant}: {self.detail}{ids})"


class AuditResult:
    """Outcome of one :func:`audit` pass.

    ``ok`` is True iff no invariant failed; ``checked`` / ``skipped``
    name every invariant that ran / could not run (missing counters,
    no report), so "passed" is never confused with "not checked"."""

    __slots__ = ("failures", "checked", "skipped", "counts")

    def __init__(self):
        self.failures: list[AuditFailure] = []
        self.checked: list[str] = []
        self.skipped: dict[str, str] = {}
        self.counts: dict[str, Any] = {}

    @property
    def ok(self) -> bool:
        return not self.failures

    def fail(self, invariant: str, detail: str,
             trace_ids: list[int] | None = None) -> None:
        self.failures.append(AuditFailure(invariant, detail, trace_ids))

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "failures": [f.to_dict() for f in self.failures],
            "checked": list(self.checked),
            "skipped": dict(self.skipped),
            "counts": dict(self.counts),
        }

    def __repr__(self) -> str:
        if self.ok:
            return (
                f"AuditResult(ok, {len(self.checked)} invariants, "
                f"{len(self.skipped)} skipped)"
            )
        return f"AuditResult({len(self.failures)} FAILED: {self.failures})"


def _counter_sum(registry, name: str) -> float | None:
    """Sum a counter family across label sets; None when absent."""
    if registry is None:
        return None
    total, seen = 0.0, False
    for inst in registry:
        if inst.name == name and inst.kind == "counter":
            total += inst.value
            seen = True
    return total if seen else None


def audit(book: TraceBook, report=None, registry=None, *,
          pool=None) -> AuditResult:
    """Run every decidable conservation invariant over ``book``.

    ``report`` (a ``WorkloadReport``) arms end-of-day strictness and
    the timing/token reconciliation; ``registry`` arms the counter
    cross-checks; ``pool`` (a paged KV pool) arms the drain-to-baseline
    check. Returns an :class:`AuditResult`; never raises on violation.
    """
    res = AuditResult()
    end_of_day = report is not None

    # -- resolution: exactly-once terminals -------------------------------
    orphans: list[int] = []
    doubles: list[int] = []
    n_term = {"retired": 0, "shed": 0, "cancelled": 0}
    hedge_bad: list[int] = []
    mig_bad: list[int] = []
    fired = won = cancelled_legs = abandoned = 0
    mig_out = mig_adopt = 0
    mig_bytes = 0.0
    trace_tokens = 0
    n_share = n_cow = 0
    for tid in book.ids():
        kinds = book.kinds(tid)
        if "submitted" not in kinds:
            continue
        terms = [k for k in kinds if k in n_term]
        if len(terms) > 1:
            doubles.append(tid)
        elif not terms:
            if end_of_day:
                orphans.append(tid)
        else:
            n_term[terms[0]] += 1
        # hedge arithmetic per trace
        f = kinds.count("hedge_fired")
        w = kinds.count("hedge_won")
        c = kinds.count("hedge_cancelled")
        a = kinds.count("hedge_abandoned")
        fired += f
        won += w
        cancelled_legs += c
        abandoned += a
        if terms and f != w + c + a:
            hedge_bad.append(tid)
        # migration pairing per trace
        mo = kinds.count("migrate_out")
        ad = kinds.count("adopt")
        mig_out += mo
        mig_adopt += ad
        if terms and mo != ad:
            mig_bad.append(tid)
        for kind, _, attrs in book.events(tid):
            if kind == "migrate_out" and attrs:
                mig_bytes += float(attrs.get("nbytes", 0.0))
            elif kind == "retired" and attrs:
                trace_tokens += int(attrs.get("tokens", 0))
            elif kind == "share_hit":
                n_share += 1
            elif kind == "cow_copy":
                n_cow += 1

    res.checked.append("terminal_exactly_once")
    if doubles:
        res.fail(
            "terminal_exactly_once",
            f"{len(doubles)} trace(s) carry more than one terminal "
            "event (double-retire)", doubles,
        )
    if orphans:
        res.fail(
            "terminal_exactly_once",
            f"{len(orphans)} submitted trace(s) never resolved "
            "(no retired/shed/cancelled at end of day)", orphans,
        )

    res.checked.append("hedge_legs")
    if hedge_bad:
        res.fail(
            "hedge_legs",
            f"{len(hedge_bad)} trace(s) violate cancelled == fired - "
            f"won - abandoned (totals: fired={fired} won={won} "
            f"cancelled={cancelled_legs} abandoned={abandoned})",
            hedge_bad,
        )

    res.checked.append("migration_pairing")
    if mig_bad:
        res.fail(
            "migration_pairing",
            f"{len(mig_bad)} trace(s) have unmatched migrate_out/"
            f"adopt (totals: out={mig_out} adopt={mig_adopt})",
            mig_bad,
        )

    res.counts.update(book.audit_view())
    res.counts.update({
        "hedge_fired": fired, "hedge_won": won,
        "hedge_cancelled": cancelled_legs,
        "hedge_abandoned": abandoned,
        "migrate_out": mig_out, "adopts": mig_adopt,
        "migrated_bytes": mig_bytes,
        "trace_tokens": trace_tokens,
        "share_hits": n_share, "cow_copies": n_cow,
    })

    # -- report reconciliation -------------------------------------------
    if report is None:
        res.skipped["report_reconciliation"] = "no report passed"
        res.skipped["timing_equality"] = "no report passed"
        res.skipped["token_conservation"] = "no report passed"
    else:
        traced = [
            r for r in report.requests
            if getattr(r, "trace", None) is not None
        ]
        if len(traced) != report.n:
            res.skipped["report_reconciliation"] = (
                f"partial arming: {len(traced)}/{report.n} requests "
                "traced"
            )
        else:
            res.checked.append("report_reconciliation")
            n_shed_rep = report.outcomes.get("shed", 0)
            if n_term["shed"] != n_shed_rep:
                res.fail(
                    "report_reconciliation",
                    f"book sheds {n_term['shed']} != report sheds "
                    f"{n_shed_rep}",
                )
            n_served_rep = report.n - n_shed_rep - report.dropped
            n_closed = n_term["retired"] + n_term["cancelled"]
            if n_closed != n_served_rep:
                res.fail(
                    "report_reconciliation",
                    f"book retired+cancelled {n_closed} != report "
                    f"served {n_served_rep}",
                )
        # timing + tokens: per traced served request, exact equality
        res.checked.append("timing_equality")
        res.checked.append("token_conservation")
        bad_t: list[int] = []
        report_tokens = 0
        for r in traced:
            if r.outcome == "shed":
                continue
            report_tokens += len(r.tokens)
            wf = book.waterfall(r.trace)
            ttft = getattr(r, "ttft", None)
            lat = getattr(r, "latency", None)
            if ttft is not None and wf["ttft"] != ttft:
                bad_t.append(r.trace)
            elif lat is not None and wf["latency"] != lat:
                bad_t.append(r.trace)
        if bad_t:
            res.fail(
                "timing_equality",
                f"{len(bad_t)} trace waterfall(s) disagree with the "
                "scheduler's own ttft/latency stamps", bad_t,
            )
        if trace_tokens != report_tokens:
            res.fail(
                "token_conservation",
                f"per-trace token sum {trace_tokens} != report token "
                f"sum {report_tokens}",
            )

    # -- registry cross-checks -------------------------------------------
    for inv, counter, have in (
        ("token_conservation_counter", "serving_tokens_total",
         trace_tokens),
        ("migration_bytes_counter", "disagg_migrated_bytes_total",
         mig_bytes),
        ("prefix_share_counter", "serving_prefix_share_hits_total",
         n_share),
        ("cow_copy_counter", "serving_cow_copies_total", n_cow),
    ):
        got = _counter_sum(registry, counter)
        if got is None:
            res.skipped[inv] = (
                f"counter {counter} absent"
                if registry is not None else "no registry passed"
            )
            continue
        res.checked.append(inv)
        if float(got) != float(have):
            res.fail(
                inv,
                f"trace events sum to {have} but {counter} reads "
                f"{got}",
            )

    # -- pool drain ------------------------------------------------------
    if pool is None:
        res.skipped["pool_drain"] = "no pool passed"
    else:
        used = getattr(pool, "used", None)
        if used is None:
            res.skipped["pool_drain"] = "pool exposes no used gauge"
            return res
        res.checked.append("pool_drain")
        if used != 0:
            res.fail(
                "pool_drain",
                f"pool holds {used} page(s) past end of day "
                "(baseline is fully drained)",
            )
    return res
