"""Windowed time series derived from a :class:`~.metrics.MetricsRegistry`.

The registry answers "what is counter Y *now*"; nothing answered "what
was the rate of Y over the last window" — the view every SLO and every
burn-rate alert is defined over. :class:`SeriesStore` is that layer: a
bounded ring of fixed-width windows, each one a snapshot-delta of an
attached registry taken at the window boundary:

* **counters** — the positive delta since the previous boundary, i.e.
  a per-window rate once divided by the window width;
* **gauges** — last value, sampled at the boundary;
* **histograms** — the bucket-count VECTOR delta between boundaries,
  so windowed p50/p99 come out of the existing fixed-log grid
  (:data:`~.metrics.DEFAULT_BUCKETS`) via the same nearest-bucket
  quantile the registry exports (:func:`~.metrics._bucket_quantile`).

Clock discipline (the TraceBook rule): the store
NEVER reads the OS clock. Rollover is driven either by an injected
``clock=`` (``.now()`` object or 0-arg callable — ``time.monotonic``
live, a :class:`~..sim.clock.VirtualClock` in the sim) or by explicit
``maybe_roll(now)`` calls from whoever owns the timeline
(:func:`~..sim.workload.run_router_day` does exactly this with the day
clock, so an instrumented day stays digest-neutral by construction:
rolls happen only at drive-loop points the dark run already visits,
and the store only READS the registry).

Respawn discipline (the aggregate-plane contract): a worker counter is
cumulative *per incarnation* — a respawned rank restarts at zero.
With ``aggregator=`` bound, ``worker``-labeled series fold the
aggregate plane's per-incarnation boot id
(:meth:`~.aggregate.TelemetryAggregator.boots`) into the delta key, so
an incarnation flip re-baselines the series instead of subtracting a
fresh counter from a dead one; any observed decrease (a reset the boot
map missed) is treated the same way. Either way a respawn can never
produce a negative-rate window.

Window semantics under coarse driving: ``maybe_roll`` attributes the
whole delta since the last boundary to the most recent elapsed window
and emits the intervening windows empty — the caller's cadence is
the attribution resolution (the sim loop rolls at every step/submit,
so gaps are at most one quiet window wide).
"""

from __future__ import annotations

from collections import deque
from typing import Any

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    _bucket_quantile,
)

__all__ = ["SeriesStore"]

_EPS = 1e-12
_US = 1e6


def _flat(name: str, labels: tuple) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class SeriesStore:
    """Bounded ring of per-window registry deltas (module docstring).

    >>> store = SeriesStore(registry, clock=clock, window_s=1.0)
    >>> ...  # traffic
    >>> store.maybe_roll(clock.now())
    >>> store.window_rate("router_requests_total")
    >>> store.window_quantile("router_ttft_seconds", 0.99)
    """

    def __init__(
        self, registry: MetricsRegistry, *, clock=None,
        window_s: float = 1.0, max_windows: int = 600,
        aggregator=None, name: str = "series",
    ):
        if registry is None:
            raise ValueError(
                "SeriesStore needs a MetricsRegistry to derive "
                "windows from"
            )
        self.registry = registry
        self.window_s = float(window_s)
        if self.window_s <= 0.0:
            raise ValueError(
                f"window_s must be > 0, got {window_s}"
            )
        self.max_windows = int(max_windows)
        if self.max_windows < 1:
            raise ValueError(
                f"max_windows must be >= 1, got {max_windows}"
            )
        self.aggregator = aggregator
        self.name = str(name)
        self._now = (
            clock.now if hasattr(clock, "now") else clock
        )
        # (name, labels) -> (incarnation, last cumulative value)
        self._last: dict[tuple, tuple[str, float]] = {}
        # (name, labels) -> (incarnation, counts, sum, count)
        self._last_hist: dict[tuple, tuple] = {}
        # id(instrument) -> (instrument, key, labels, kind): the delta
        # key is pure function of an instrument's identity, so build
        # it once per series, not once per window. The strong ref
        # keeps the id from ever being recycled under the cache.
        self._keys: dict[int, tuple] = {}
        # first boundary: lazily pinned at the first maybe_roll (or
        # now, when a clock was injected) so a store built before its
        # day clock exists still aligns its grid to that day's t=0
        self._t0: float | None = (
            None if self._now is None else float(self._now())
        )
        if self._t0 is not None:
            self._baseline()
        self.n_rolled = 0  # total windows ever closed (ring evicts)
        self._ring: deque[dict[str, Any]] = deque(
            maxlen=self.max_windows
        )

    # -- sampling ---------------------------------------------------------

    def _incarnation(self, labels: dict, boots) -> str:
        """The aggregate plane's boot id for this series' rank, or ""
        for series that are not per-worker (coordinator-local series
        have exactly one incarnation: this process)."""
        if boots is None:
            return ""
        w = labels.get("worker")
        if w is None:
            return ""
        try:
            return boots.get(int(w), "")
        except (TypeError, ValueError):
            return ""

    def _boots(self):
        agg = self.aggregator
        if agg is None:
            return None
        boots = getattr(agg, "boots", None)
        return boots() if callable(boots) else None

    _HIST, _CTR, _GAUGE, _OTHER = 0, 1, 2, 3

    def _key(self, inst) -> tuple:
        """(instrument, delta key, labels, kind) — cached per series
        so window close does not rebuild sorted label tuples."""
        ck = self._keys.get(id(inst))
        if ck is None:
            labels = dict(inst.labels)
            kind = (
                self._HIST if isinstance(inst, Histogram)
                else self._CTR if isinstance(inst, Counter)
                else self._GAUGE if isinstance(inst, Gauge)
                else self._OTHER
            )
            ck = (
                inst,
                (inst.name, tuple(sorted(labels.items()))),
                labels,
                kind,
            )
            self._keys[id(inst)] = ck
        return ck

    def _baseline(self) -> None:
        """Prime the delta state so the first window carries only
        in-window activity, not the registry's whole history."""
        boots = self._boots()
        for inst in self.registry:
            _, key, labels, kind = self._key(inst)
            inc = (
                "" if boots is None
                else self._incarnation(labels, boots)
            )
            if kind == self._HIST:
                counts, total, n = inst.read()
                self._last_hist[key] = (inc, counts, total, n)
            elif kind == self._CTR:
                self._last[key] = (inc, inst.value)

    def _sample(self, t0: float, t1: float) -> dict[str, Any]:
        """Close one window: snapshot the registry, delta against the
        previous boundary under the incarnation discipline (module
        docstring), return the window record."""
        boots = self._boots()
        counters: dict[tuple, float] = {}
        gauges: dict[tuple, float] = {}
        hists: dict[tuple, tuple] = {}
        for inst in self.registry:
            _, key, labels, kind = self._key(inst)
            inc = (
                "" if boots is None
                else self._incarnation(labels, boots)
            )
            if kind == self._HIST:
                counts, total, n = inst.read()
                prev = self._last_hist.get(key)
                if prev is None:
                    dc, ds, dn = counts, total, n
                else:
                    pinc, pcounts, ptotal, pn = prev
                    if pinc != inc or n < pn:
                        # respawned incarnation: the fresh histogram
                        # counts from zero — subtracting the dead
                        # incarnation's snapshot would go negative
                        dc, ds, dn = counts, total, n
                    else:
                        dc = [
                            c - p for c, p in zip(counts, pcounts)
                        ]
                        ds, dn = total - ptotal, n - pn
                self._last_hist[key] = (inc, counts, total, n)
                if dn:
                    hists[key] = (inst.bounds, dc, ds, dn)
            elif kind == self._CTR:
                cur = inst.value
                prev = self._last.get(key)
                if prev is None:
                    delta = cur  # series born since the last boundary
                else:
                    pinc, pval = prev
                    if pinc != inc or cur < pval:
                        # incarnation flip (or a reset the boot map
                        # missed): count the fresh incarnation from
                        # zero — never a negative-rate window. A
                        # monotone merged counter under a flip still
                        # subtracts cleanly (cur >= pval).
                        delta = cur - pval if cur >= pval else cur
                    else:
                        delta = cur - pval
                self._last[key] = (inc, cur)
                if delta:
                    counters[key] = delta
            elif kind == self._GAUGE:
                gauges[key] = inst.value
        return {
            "i": self.n_rolled, "t0": t0, "t1": t1,
            "counters": counters, "gauges": gauges, "hists": hists,
        }

    # -- rollover ---------------------------------------------------------

    def maybe_roll(self, now: float | None = None) -> int:
        """Close every window boundary at or before ``now``; returns
        how many windows closed (0 when none are due — idempotent, so
        any number of drive-loop call sites may share one store)."""
        if now is None:
            if self._now is None:
                raise ValueError(
                    "maybe_roll() needs an explicit now= on a store "
                    "built without clock="
                )
            now = self._now()
        now = float(now)
        if self._t0 is None:
            self._t0 = now
            self._baseline()
            return 0
        w = self.window_s
        k = int((now - self._t0 + _EPS) / w)
        if k <= 0:
            return 0
        # one registry snapshot: the whole delta lands in the most
        # recent elapsed window; intervening windows close empty
        # (module docstring — the caller's cadence is the resolution)
        for j in range(k - 1):
            t0 = self._t0 + j * w
            self._ring.append({
                "i": self.n_rolled, "t0": t0, "t1": t0 + w,
                "counters": {}, "gauges": {}, "hists": {},
            })
            self.n_rolled += 1
        t0 = self._t0 + (k - 1) * w
        self._ring.append(self._sample(t0, t0 + w))
        self.n_rolled += 1
        self._t0 += k * w
        return k

    # -- reads ------------------------------------------------------------

    def windows(self, n: int | None = None) -> list[dict[str, Any]]:
        """The most recent ``n`` closed windows (all retained when
        None), oldest first."""
        wins = list(self._ring)
        return wins if n is None else wins[-int(n):]

    def windows_upto(self, i: int, n: int) -> list[dict[str, Any]]:
        """Up to ``n`` windows ending at absolute index ``i`` (the SLO
        plane evaluates each window as it closes, even when several
        close in one roll)."""
        return [
            rec for rec in self._ring
            if i - n < rec["i"] <= i
        ]

    def counter_deltas(
        self, name: str, *, windows: int = 1,
        _wins: list | None = None,
    ) -> list[tuple[dict, float]]:
        """``(labels, delta)`` per labeled series of ``name`` over the
        last ``windows`` windows (deltas summed per series)."""
        acc: dict[tuple, float] = {}
        for rec in (self.windows(windows) if _wins is None else _wins):
            for (n, lt), d in rec["counters"].items():
                if n == name:
                    acc[lt] = acc.get(lt, 0.0) + d
        return [(dict(lt), d) for lt, d in acc.items()]

    def window_delta(
        self, name: str, *, labels: dict | None = None,
        windows: int = 1,
    ) -> float:
        """Summed counter delta of ``name`` over the last ``windows``
        windows, across every label set matching the ``labels``
        subset."""
        want = None if labels is None else set(labels.items())
        total = 0.0
        for lt, d in self.counter_deltas(name, windows=windows):
            if want is None or want <= set(lt.items()):
                total += d
        return total

    def window_rate(
        self, name: str, *, labels: dict | None = None,
        windows: int = 1,
    ) -> float:
        """:meth:`window_delta` divided by the covered span."""
        return self.window_delta(
            name, labels=labels, windows=windows
        ) / (self.window_s * max(int(windows), 1))

    def _merge_hists(
        self, name: str, windows: int, wins: list | None = None,
    ) -> tuple[tuple, list[int], float, int] | None:
        bounds = None
        dc: list[int] | None = None
        ds, dn = 0.0, 0
        for rec in (self.windows(windows) if wins is None else wins):
            for (n, _lt), (b, c, s, cnt) in rec["hists"].items():
                if n != name:
                    continue
                if dc is None:
                    bounds, dc = b, list(c)
                else:
                    dc = [x + y for x, y in zip(dc, c)]
                ds += s
                dn += cnt
        if dc is None:
            return None
        return bounds, dc, ds, dn

    def window_quantile(
        self, name: str, q: float, *, windows: int = 1,
    ) -> float | None:
        """Nearest-bucket quantile of histogram ``name`` over the last
        ``windows`` windows (None when no observation landed); label
        sets of one family merge bucket-wise — the fixed grid is what
        makes them addable."""
        got = self._merge_hists(name, windows)
        if got is None:
            return None
        bounds, dc, _ds, dn = got
        return _bucket_quantile(bounds, dc, dn, q)

    def window_count(self, name: str, *, windows: int = 1) -> int:
        """Observations of histogram ``name`` over the last
        ``windows`` windows."""
        got = self._merge_hists(name, windows)
        return 0 if got is None else got[3]

    def gauge_value(self, name: str, *, labels: dict | None = None):
        """Last sampled value of gauge ``name`` in the newest closed
        window (None before any window closed or when unseen)."""
        if not self._ring:
            return None
        want = None if labels is None else set(labels.items())
        for (n, lt), v in self._ring[-1]["gauges"].items():
            if n == name and (want is None or want <= set(lt)):
                return v
        return None

    # -- exports ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._ring)

    def to_doc(self) -> dict[str, Any]:
        """JSON-able snapshot: ring of windows with flat
        ``name{label="v"}`` series keys; histogram bucket grids hoisted
        once into ``buckets`` (they repeat per window otherwise)."""
        buckets: dict[str, list[float]] = {}
        wins = []
        for rec in self._ring:
            hists = {}
            for (n, lt), (b, c, s, cnt) in rec["hists"].items():
                buckets.setdefault(n, list(b))
                hists[_flat(n, lt)] = {
                    "counts": list(c), "sum": s, "count": cnt,
                }
            wins.append({
                "i": rec["i"], "t0": rec["t0"], "t1": rec["t1"],
                "counters": {
                    _flat(n, lt): d
                    for (n, lt), d in rec["counters"].items()
                },
                "gauges": {
                    _flat(n, lt): v
                    for (n, lt), v in rec["gauges"].items()
                },
                "hists": hists,
            })
        return {
            "name": self.name, "window_s": self.window_s,
            "max_windows": self.max_windows,
            "n_rolled": self.n_rolled, "buckets": buckets,
            "windows": wins,
        }

    def chrome_events(
        self, pid: int = 0
    ) -> tuple[list[dict], list[dict]]:
        """(metadata, counter events) under ``pid`` — the
        :meth:`~.timeline.SpanRecorder.chrome_events` merge contract,
        so a store rides :func:`~.timeline.merged_chrome_trace` as
        Perfetto counter tracks: one sample per window at the window's
        close, counters as rates, gauges as-is."""
        meta = [
            {"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": f"series {self.name}"}},
        ]
        events: list[dict[str, Any]] = []
        w = self.window_s
        for rec in self._ring:
            ts = rec["t1"] * _US
            for (n, lt), d in rec["counters"].items():
                fn = _flat(n, lt)
                events.append({
                    "name": fn, "ph": "C", "pid": pid, "ts": ts,
                    "args": {fn: d / w},
                })
            for (n, lt), v in rec["gauges"].items():
                fn = _flat(n, lt)
                events.append({
                    "name": fn, "ph": "C", "pid": pid, "ts": ts,
                    "args": {fn: v},
                })
        return meta, events

    def __repr__(self) -> str:
        return (
            f"SeriesStore({self.name!r}, window_s={self.window_s}, "
            f"{len(self._ring)}/{self.max_windows} windows, "
            f"{self.n_rolled} rolled)"
        )
