"""SLO objectives, error-budget burn-rate alerting, per-tenant cost.

The windowed layer (:class:`~.series.SeriesStore`) answers "what did
the fleet deliver over the last window"; this module turns that into
the operator plane a fleet actually pages on: named objectives, an
error budget per objective, multi-window fast/slow burn-rate alerts
(the SRE discipline: page when BOTH a short and a long window burn hot
— the short one for reaction time, the long one so a blip cannot
page), and a per-tenant cost ledger attributing busy chip-time and
shed counts per window.

Every quantity is defined over windows of the injected clock's
seconds, so the IDENTICAL policy evaluates live (``time.monotonic``)
and on a :class:`~..sim.clock.VirtualClock` — an SLO day replays
bit-identically, which is what lets the chaos plane pin "the storm
fires the fast-burn alert and recovery clears it" as an invariant and
lets :class:`~..fleet.FleetController` take burn-rate as a grow
trigger without losing decision replay.

Objective kinds (:class:`SloObjective`):

* ``"latency"`` — at most ``1 - q`` of observations of ``metric`` (a
  histogram, default ``router_ttft_seconds``) may exceed ``target``
  seconds. The bad fraction is bucket-resolved: an observation counts
  good when its bucket's upper bound is <= target (one-bucket
  conservatism, same grid as the windowed quantiles).
* ``"availability"`` — at least ``target`` of terminal requests must
  complete served (outcome != shed); budget ``1 - target``.
* ``"shed_rate"`` — at most ``target`` of door decisions may shed;
  the budget is ``target`` itself.

Burn rate over a window = (bad fraction in the window) / (budget
fraction); 1.0 means "burning exactly at the sustainable rate", and an
alert fires when burn >= ``fire_burn`` on BOTH the fast and slow
windows, clearing when the fast window recovers. Fire/clear land on
the timeline (and as ``"slo alert"`` flight-ring instants when
``flight=`` is bound) stamped at the closing window's boundary — pure
virtual time, so two replays produce byte-identical timelines.

Cost ledger: per closed window, per tenant — ``busy_s`` (admission ->
done chip-time from the router's ``qos_busy_seconds_total`` /
``router_busy_seconds_total`` counters), ``served``, ``shed``.
Tenantless traffic books under ``"-"``.
"""

from __future__ import annotations

from collections import deque
from typing import Any

from .series import SeriesStore

__all__ = ["SloObjective", "SloPolicy"]

_KINDS = ("latency", "availability", "shed_rate")


class SloObjective:
    """One named objective (module docstring for the kinds)."""

    def __init__(
        self, name: str, kind: str, target: float, *,
        q: float = 0.99, metric: str = "router_ttft_seconds",
        fast_s: float = 60.0, slow_s: float = 300.0,
        fire_burn: float = 2.0,
    ):
        if kind not in _KINDS:
            raise ValueError(
                f"objective kind {kind!r} not in {_KINDS}"
            )
        self.name = str(name)
        self.kind = kind
        self.target = float(target)
        self.q = float(q)
        self.metric = str(metric)
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        if not (0.0 < self.fast_s <= self.slow_s):
            raise ValueError(
                f"need 0 < fast_s <= slow_s, got {fast_s}/{slow_s}"
            )
        self.fire_burn = float(fire_burn)
        if self.fire_burn <= 0.0:
            raise ValueError("fire_burn must be > 0")
        if kind == "latency":
            if not (0.0 < self.q < 1.0):
                raise ValueError(f"latency q must be in (0,1): {q}")
            if self.target <= 0.0:
                raise ValueError("latency target must be > 0 seconds")
        elif kind == "availability":
            if not (0.0 < self.target < 1.0):
                raise ValueError(
                    f"availability target must be in (0,1): {target}"
                )
        elif not (0.0 < self.target < 1.0):
            raise ValueError(
                f"shed_rate target must be in (0,1): {target}"
            )

    @property
    def budget_frac(self) -> float:
        """The allowed bad fraction — the error budget."""
        if self.kind == "latency":
            return 1.0 - self.q
        if self.kind == "availability":
            return 1.0 - self.target
        return self.target

    def __repr__(self) -> str:
        return (
            f"SloObjective({self.name!r}, {self.kind}, "
            f"target={self.target})"
        )


class SloPolicy:
    """Objectives + burn alerts + ledger over one
    :class:`~.series.SeriesStore` (module docstring).

    ``maybe_roll(now)`` rolls the bound store (idempotent — the store
    may also be rolled directly) and evaluates every newly closed
    window in order. ``fast_burn_firing()`` is the consumer surface:
    the ``/slo`` endpoint 503s and the fleet controller grows on it.
    """

    def __init__(
        self, series: SeriesStore, objectives, *, flight=None,
    ):
        if series is None:
            raise ValueError(
                "SloPolicy needs the SeriesStore its windows come "
                "from"
            )
        self.series = series
        self.objectives = list(objectives)
        if not self.objectives:
            raise ValueError("SloPolicy needs >= 1 objective")
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(
                f"objective names must be unique: {names}"
            )
        self.flight = flight
        self._evaluated_through = series.n_rolled - 1
        self._firing: dict[str, bool] = {
            o.name: False for o in self.objectives
        }
        # cumulative good/bad accounting per objective (budget view)
        self._bad: dict[str, float] = {n: 0.0 for n in names}
        self._total: dict[str, float] = {n: 0.0 for n in names}
        # per-objective sliding (bad, total) spans with running sums:
        # burn at each rollover is O(1) — add the closing window, drop
        # the one leaving the span — instead of a histogram re-merge
        # over fast/slow windows of history. Counts are small integers
        # so add/subtract is float-exact and the burn numbers stay
        # bit-identical to the merge-based _burn (which to_doc still
        # uses, off the hot path). Spans cap at the ring size, the
        # most the merge-based view could ever cover.
        self._spans: dict[str, tuple] = {}
        for o in self.objectives:
            w = series.window_s
            k_f = min(
                max(1, int(round(o.fast_s / w))), series.max_windows
            )
            k_s = min(
                max(1, int(round(o.slow_s / w))), series.max_windows
            )
            self._spans[o.name] = (
                deque(maxlen=k_f), deque(maxlen=k_s),
                [0.0, 0.0, 0.0, 0.0],  # fast bad/total, slow bad/total
            )
        self.timeline: list[dict[str, Any]] = []
        self._ledger: deque[dict[str, Any]] = deque(
            maxlen=series.max_windows
        )

    # -- the accounting ---------------------------------------------------

    def _bad_total(self, obj: SloObjective, wins) -> tuple[float, float]:
        """(bad events, total events) for ``obj`` over ``wins``."""
        s = self.series
        if obj.kind == "latency":
            got = s._merge_hists(obj.metric, 0, wins)
            if got is None:
                return 0.0, 0.0
            bounds, dc, _ds, dn = got
            good = sum(
                c for b, c in zip(bounds, dc) if b <= obj.target
            )
            return float(dn - good), float(dn)
        # availability / shed_rate: door decisions — served (terminal
        # non-shed completions) vs shed-by-name, both counter planes
        served = sum(
            d for lt, d in s.counter_deltas(
                "router_requests_total", _wins=wins,
            )
            if lt.get("outcome") != "shed"
        )
        shed = sum(
            d for _lt, d in s.counter_deltas(
                "router_shed_total", _wins=wins,
            )
        )
        return float(shed), float(served + shed)

    def _burn(self, obj: SloObjective, upto_i: int, span_s: float):
        k = max(1, int(round(span_s / self.series.window_s)))
        wins = self.series.windows_upto(upto_i, k)
        bad, total = self._bad_total(obj, wins)
        if total <= 0.0:
            return 0.0
        return (bad / total) / obj.budget_frac

    def _push(
        self, obj: SloObjective, bad: float, total: float,
    ) -> tuple[float, float]:
        """Slide the objective's fast/slow spans one window and return
        (fast burn, slow burn) — the evaluation hot path."""
        fq, sq, run = self._spans[obj.name]
        if len(fq) == fq.maxlen:
            ob, ot = fq[0]
            run[0] -= ob
            run[1] -= ot
        fq.append((bad, total))
        run[0] += bad
        run[1] += total
        if len(sq) == sq.maxlen:
            ob, ot = sq[0]
            run[2] -= ob
            run[3] -= ot
        sq.append((bad, total))
        run[2] += bad
        run[3] += total
        bf = obj.budget_frac
        fast = (run[0] / run[1]) / bf if run[1] > 0.0 else 0.0
        slow = (run[2] / run[3]) / bf if run[3] > 0.0 else 0.0
        return fast, slow

    # -- rollover + evaluation --------------------------------------------

    def maybe_roll(self, now: float | None = None) -> int:
        """Roll the bound store, then evaluate every window that
        closed since the last evaluation. Returns windows evaluated."""
        self.series.maybe_roll(now)
        done = 0
        while self._evaluated_through < self.series.n_rolled - 1:
            self._evaluated_through += 1
            self._evaluate(self._evaluated_through)
            done += 1
        return done

    def _evaluate(self, i: int) -> None:
        wins = self.series.windows_upto(i, 1)
        if not wins:
            # evicted before evaluation (ring far too small): keep the
            # sliding spans aligned, counting the lost window empty
            for obj in self.objectives:
                self._push(obj, 0.0, 0.0)
            return
        win = wins[-1]
        t = win["t1"]
        for obj in self.objectives:
            bad, total = self._bad_total(obj, wins)
            self._bad[obj.name] += bad
            self._total[obj.name] += total
            fast, slow = self._push(obj, bad, total)
            firing = self._firing[obj.name]
            if not firing and (
                fast >= obj.fire_burn and slow >= obj.fire_burn
            ):
                self._transition(obj, "fire", t, fast, slow)
            elif firing and fast < obj.fire_burn:
                self._transition(obj, "clear", t, fast, slow)
        self._ledger.append(self._ledger_window(win))

    def _transition(
        self, obj: SloObjective, phase: str, t: float,
        fast: float, slow: float,
    ) -> None:
        self._firing[obj.name] = phase == "fire"
        entry = {
            "t": t, "objective": obj.name, "phase": phase,
            "fast_burn": round(fast, 9), "slow_burn": round(slow, 9),
        }
        self.timeline.append(entry)
        if self.flight is not None:
            self.flight.event(
                "slo alert", src="slo", t=t, objective=obj.name,
                phase=phase, fast_burn=entry["fast_burn"],
                slow_burn=entry["slow_burn"],
            )

    def _ledger_window(self, win: dict) -> dict[str, Any]:
        """Per-tenant cost attribution for one window: busy chip-time
        (admission -> done), served and shed counts. QoS routers label
        by tenant; tenantless traffic books under "-"."""
        tenants: dict[str, dict[str, float]] = {}

        def row(t: str) -> dict[str, float]:
            return tenants.setdefault(
                t, {"busy_s": 0.0, "served": 0, "shed": 0}
            )

        # one pass over the window's counter deltas (this runs per
        # closed window); per-tenant counters win where they exist;
        # the router-wide totals (which count the SAME chip-time /
        # sheds once more) only book — under "-" — on tenantless
        # routers
        qos_busy: list = []
        router_busy: list = []
        qos_shed: list = []
        router_shed: list = []
        for (name, lt), d in win["counters"].items():
            if name == "qos_busy_seconds_total":
                qos_busy.append((lt, d))
            elif name == "router_busy_seconds_total":
                router_busy.append(d)
            elif name == "router_requests_total":
                labels = dict(lt)
                if labels.get("outcome") != "shed":
                    row(labels.get("tenant", "-"))["served"] += int(d)
            elif name == "qos_shed_total":
                qos_shed.append((lt, d))
            elif name == "router_shed_total":
                router_shed.append(d)
        if qos_busy:
            for lt, d in qos_busy:
                row(dict(lt).get("tenant", "-"))["busy_s"] += d
        else:
            for d in router_busy:
                row("-")["busy_s"] += d
        if qos_shed:
            for lt, d in qos_shed:
                row(dict(lt).get("tenant", "-"))["shed"] += int(d)
        else:
            for d in router_shed:
                row("-")["shed"] += int(d)
        return {
            "i": win["i"], "t0": win["t0"], "t1": win["t1"],
            "tenants": {
                t: {
                    "busy_s": round(v["busy_s"], 9),
                    "served": int(v["served"]),
                    "shed": int(v["shed"]),
                }
                for t, v in sorted(tenants.items())
            },
        }

    # -- consumer surface -------------------------------------------------

    def fast_burn_firing(self) -> list[str]:
        """Names of objectives whose fast-burn alert is CURRENTLY
        firing, sorted — the controller's grow trigger and the
        ``/slo`` endpoint's 503 condition."""
        return sorted(n for n, f in self._firing.items() if f)

    def ledger(self, n: int | None = None) -> list[dict[str, Any]]:
        """The most recent ``n`` ledger windows (all retained when
        None), oldest first."""
        rows = list(self._ledger)
        return rows if n is None else rows[-int(n):]

    def alert_counts(self) -> dict[str, int]:
        """{"fired": n, "cleared": n} over the whole timeline — the
        chaos plane folds these into the episode digest."""
        fired = sum(
            1 for e in self.timeline if e["phase"] == "fire"
        )
        return {"fired": fired, "cleared": len(self.timeline) - fired}

    def to_doc(self) -> dict[str, Any]:
        """JSON-able state for ``GET /slo``: ``ok`` is False while any
        fast-burn alert is firing (the endpoint's 503 contract)."""
        objs = []
        last_i = self.series.n_rolled - 1
        for obj in self.objectives:
            total = self._total[obj.name]
            burned = (
                (self._bad[obj.name] / total) / obj.budget_frac
                if total > 0 else 0.0
            )
            objs.append({
                "name": obj.name, "kind": obj.kind,
                "target": obj.target, "q": obj.q,
                "metric": obj.metric, "fast_s": obj.fast_s,
                "slow_s": obj.slow_s, "fire_burn": obj.fire_burn,
                "firing": self._firing[obj.name],
                "fast_burn": round(
                    self._burn(obj, last_i, obj.fast_s), 9
                ),
                "slow_burn": round(
                    self._burn(obj, last_i, obj.slow_s), 9
                ),
                "budget": {
                    "bad": self._bad[obj.name],
                    "total": total,
                    "burned_frac": round(burned, 9),
                    "remaining_frac": round(1.0 - burned, 9),
                },
            })
        return {
            "ok": not any(self._firing.values()),
            "window_s": self.series.window_s,
            "objectives": objs,
            "firing": self.fast_burn_firing(),
            "timeline": list(self.timeline),
            "ledger": self.ledger(),
        }

    def __repr__(self) -> str:
        firing = self.fast_burn_firing()
        return (
            f"SloPolicy({len(self.objectives)} objectives, "
            f"{len(self.timeline)} transitions"
            + (f", FIRING {firing}" if firing else "")
            + ")"
        )
