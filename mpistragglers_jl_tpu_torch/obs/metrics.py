"""Zero-dependency metrics registry: counters, gauges, histograms.

The runtime's series store — the quantitative half of the observability
subsystem (the timeline half is :mod:`.timeline`). Stdlib-only by
design: the registry is importable wherever the pool is (the package
root stays free of compilers), and every instrument
is THREAD-SAFE so writers off the coordinator thread — the native
transport's epoll/harvest thread, a HedgedServer draining losers from
a helper thread — can record without corrupting counts (the pool's own
hot loop stays single-threaded; the lock is uncontended there).

Design, mirroring the tracer's opt-in contract (utils/trace.py):
instrumented layers take a ``registry=None`` argument and pay nothing
when none is passed — instruments are resolved ONCE at construction
(a dict lookup + lock), so the steady-state cost of an enabled series
is one locked float add per event.

Exports: :meth:`MetricsRegistry.snapshot` (JSON-able dict, the bench
contract's telemetry attachment), :meth:`MetricsRegistry.to_json`, and
:meth:`MetricsRegistry.to_prometheus` (text exposition format 0.0.4 —
scrapeable, and parseable line-by-line in tests).
"""

from __future__ import annotations

import json
import math
import re
import threading
from bisect import bisect_left
from typing import Any, Iterable

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_BUCKETS",
]

# Fixed log buckets for latency histograms: half-decade steps from 1 µs
# to 100 s (17 bounds + the implicit +Inf). Fixed — not adaptive — so
# two processes' histograms merge by bucket-wise addition and a series
# is comparable across runs.
DEFAULT_BUCKETS: tuple[float, ...] = tuple(
    round(10.0 ** (k / 2.0), 10) for k in range(-12, 5)
)


# exactly the Prometheus name grammar (ASCII — str.isalnum would admit
# unicode letters a scraper rejects); permitting anything wider (dots,
# say) would need a lossy export mapping under which two distinct
# families ("a.b", "a_b") collide into one exposition name, an invalid
# scrape
_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} must match [a-zA-Z_:][a-zA-Z0-9_:]*"
        )
    return name


def _check_labels(labels: dict, kind: str) -> None:
    # kwargs reach here as any valid PYTHON identifier, which admits
    # unicode the exposition grammar rejects; "__" is Prometheus-
    # reserved, and "le" on a histogram would collide with the bucket
    # label (overwritten on _bucket lines, kept on _sum/_count — two
    # disjoint label sets in one family)
    for k in labels:
        if not _NAME_RE.match(k) or k.startswith("__") or ":" in k:
            raise ValueError(
                f"label name {k!r} must match [a-zA-Z_][a-zA-Z0-9_]* "
                "and not start with __"
            )
        if k == "le" and kind == "histogram":
            raise ValueError(
                'label "le" is reserved for histogram buckets'
            )


class _Instrument:
    """Shared identity: name + frozen label set + help text."""

    kind = "untyped"

    def __init__(self, name: str, labels: dict[str, str], help: str = ""):
        self.name = _check_name(name)
        self.labels = dict(labels)
        self.help = help
        self._lock = threading.Lock()

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}"
            f"({self.name}{_labels_str(self.labels)})"
        )


class Counter(_Instrument):
    """Monotonically increasing count (events, tokens, decodes)."""

    kind = "counter"

    def __init__(self, name, labels, help=""):
        super().__init__(name, labels, help)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0: {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Instrument):
    """Point-in-time level (queue depth, slot occupancy, a fitted rate)."""

    kind = "gauge"

    def __init__(self, name, labels, help=""):
        super().__init__(name, labels, help)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Instrument):
    """Distribution over fixed log buckets (:data:`DEFAULT_BUCKETS`).

    ``observe(v)`` is one bisect + two adds under the lock; quantiles
    come from the cumulative bucket counts (:meth:`quantile` returns
    the upper bound of the covering bucket — resolution is the bucket
    grid, which is the deal fixed buckets buy).
    """

    kind = "histogram"

    def __init__(self, name, labels, help="", buckets=None):
        super().__init__(name, labels, help)
        bounds = tuple(
            float(b) for b in (DEFAULT_BUCKETS if buckets is None
                               else buckets)
        )
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(
                f"histogram buckets must be strictly increasing: {bounds}"
            )
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        if math.isnan(v):
            return
        i = bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float | None:
        """Upper bucket bound covering quantile ``q`` (None when empty;
        ``inf`` when it lands in the overflow bucket)."""
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"q must be in [0, 1], got {q}")
        counts, _, total = self.read()
        return _bucket_quantile(self.bounds, counts, total, q)

    def bucket_counts(self) -> list[int]:
        with self._lock:
            return list(self._counts)

    def read(self) -> tuple[list[int], float, int]:
        """(bucket counts, sum, count) under ONE lock acquisition —
        the export path must use this, not the individual properties:
        a concurrent ``observe`` between separate reads would emit an
        exposition where ``_bucket{le="+Inf"}`` != ``_count``, breaking
        the Prometheus histogram invariant."""
        with self._lock:
            return list(self._counts), self._sum, self._count

    def merge_deltas(
        self, counts: Iterable[int], sum_delta: float, count_delta: int
    ) -> None:
        """Fold another process's bucket-count DELTAS in (the fixed
        grid is what makes histograms addable — module docstring); the
        cross-process aggregation path (:mod:`.aggregate`). ``counts``
        must cover the full grid including the +Inf overflow bucket;
        negative deltas are rejected (a shrinking histogram is a
        protocol bug upstream, never mergeable)."""
        dc = [int(c) for c in counts]
        if len(dc) != len(self._counts):
            raise ValueError(
                f"bucket delta length {len(dc)} != grid size "
                f"{len(self._counts)} (bounds + overflow)"
            )
        if any(c < 0 for c in dc) or count_delta < 0:
            raise ValueError("histogram deltas must be >= 0")
        with self._lock:
            for i, c in enumerate(dc):
                self._counts[i] += c
            self._sum += float(sum_delta)
            self._count += int(count_delta)


def _bucket_quantile(bounds, counts, total, q) -> float | None:
    """Quantile over an already-read (counts, total) snapshot."""
    if total == 0:
        return None
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target and c:
            return bounds[i] if i < len(bounds) else math.inf
    return math.inf


def _escape_label(v: str) -> str:
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(v: str) -> str:
    # exposition 0.0.4 HELP escaping: backslash and newline only (no
    # quote escaping — HELP text is not quoted). Round-trips exactly,
    # unlike the old newline->space flattening.
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _prom_name(name: str) -> str:
    # _check_name already enforces the exposition grammar; kept as the
    # single seam if the registry grammar ever widens again
    return name


def _prom_num(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class MetricsRegistry:
    """Get-or-create instrument store with JSON / Prometheus exports.

    >>> reg = MetricsRegistry()
    >>> reg.counter("serving_tokens_total").inc(8)
    >>> reg.gauge("serving_queue_depth").set(3)
    >>> reg.histogram("serving_ttft_seconds").observe(0.12)
    >>> print(reg.to_prometheus())

    ``counter/gauge/histogram`` return the SAME object for the same
    (name, labels) pair — callers resolve instruments once and hold
    them; labeled series of one name share one TYPE/HELP family (a
    name registered as two different kinds raises). All methods are
    thread-safe.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[tuple, _Instrument] = {}
        self._kinds: dict[str, str] = {}
        self._buckets: dict[str, tuple] = {}  # histogram family grids

    # -- get-or-create ---------------------------------------------------
    def _get(self, cls, name, help, labels, **kw):
        _check_labels(labels, cls.kind)
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            # one bucket grid per histogram FAMILY, not per labeled
            # series: series of one name with different grids would
            # export disjoint le sets that sum-by-le quantile queries
            # silently misaggregate. First registration fixes the
            # grid; later series inherit it (buckets=None) or must
            # match it; a mismatch is a conflict exactly like a kind
            # mismatch (silently handing back another grid would route
            # out-of-range observes into +Inf with no error).
            if cls is Histogram:
                fam = self._buckets.get(name)
                want = kw.get("buckets")
                if want is not None:
                    want = tuple(float(b) for b in want)
                if fam is not None and want is not None and want != fam:
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {fam}, conflicting request {want}"
                    )
                if fam is not None:
                    kw = {**kw, "buckets": fam}
            inst = self._metrics.get(key)
            if inst is None:
                seen = self._kinds.get(name)
                if seen is not None and seen != cls.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {seen}, "
                        f"cannot re-register as {cls.kind}"
                    )
                inst = cls(name, labels, help=help, **kw)
                self._metrics[key] = inst
                self._kinds[name] = cls.kind
                if cls is Histogram:
                    self._buckets[name] = inst.bounds
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r}{labels} is a {inst.kind}, "
                    f"not a {cls.kind}"
                )
            return inst

    def counter(self, name: str, *, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, *, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(
        self, name: str, *, help: str = "",
        buckets: Iterable[float] | None = None, **labels,
    ) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def __len__(self) -> int:
        with self._lock:
            return len(self._metrics)

    def __iter__(self):
        with self._lock:
            return iter(list(self._metrics.values()))

    # -- exports ---------------------------------------------------------
    def snapshot(self) -> dict[str, Any]:
        """JSON-able dict: ``{name: {type, help, series: [...]}}``.
        Histogram series carry count/sum/mean/p50/p95 plus the raw
        bucket counts — the form the bench contract attaches."""
        out: dict[str, Any] = {}
        for inst in self:
            fam = out.setdefault(
                inst.name,
                {"type": inst.kind, "help": inst.help, "series": []},
            )
            if isinstance(inst, Histogram):
                counts, total, n = inst.read()
                val: Any = {
                    "count": n,
                    "sum": round(total, 9),
                    "mean": round(total / n, 9) if n else 0.0,
                    "p50": _json_num(_bucket_quantile(
                        inst.bounds, counts, n, 0.5)),
                    "p95": _json_num(_bucket_quantile(
                        inst.bounds, counts, n, 0.95)),
                    "buckets": dict(
                        zip(
                            [_prom_num(b) for b in inst.bounds]
                            + ["+Inf"],
                            counts,
                        )
                    ),
                }
            else:
                val = inst.value
            fam["series"].append({"labels": inst.labels, "value": val})
        return out

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus(self) -> str:
        """Text exposition format 0.0.4: ``# HELP`` / ``# TYPE`` per
        family, one sample line per series (histograms expand to
        cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``)."""
        by_name: dict[str, list[_Instrument]] = {}
        for inst in self:
            by_name.setdefault(inst.name, []).append(inst)
        lines: list[str] = []
        for name in sorted(by_name):
            insts = by_name[name]
            pname = _prom_name(name)
            if insts[0].help:
                lines.append(
                    f"# HELP {pname} "
                    + _escape_help(insts[0].help)
                )
            lines.append(f"# TYPE {pname} {insts[0].kind}")
            for inst in insts:
                if isinstance(inst, Histogram):
                    base = dict(inst.labels)
                    cum = 0
                    counts, total, n_obs = inst.read()
                    for bound, c in zip(
                        list(inst.bounds) + [math.inf], counts
                    ):
                        cum += c
                        lbl = _labels_str(
                            {**base, "le": _prom_num(bound)}
                        )
                        lines.append(f"{pname}_bucket{lbl} {cum}")
                    lbl = _labels_str(base)
                    lines.append(
                        f"{pname}_sum{lbl} {_prom_num(total)}"
                    )
                    lines.append(f"{pname}_count{lbl} {n_obs}")
                else:
                    lines.append(
                        f"{pname}{_labels_str(inst.labels)} "
                        f"{_prom_num(inst.value)}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")

    def dump_prometheus(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_prometheus())

    def dump_json(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2))

    def __repr__(self) -> str:
        return f"MetricsRegistry({len(self)} series)"


def _labels_str(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _json_num(v):
    if v is None:
        return None
    return "+Inf" if v == math.inf else v
