"""Policy autotuning: sweep (nwait, hedge width, code rate) on virtual time.

A copy of the JAX package's ``sim/tune.py`` (stdlib and numpy, no
torch and no OS clock): the same trace or schedule gives the same
virtual timeline in either package.

The paper's entire value proposition is one knob — return after the
``nwait`` fastest workers — and until now the only ways to price a
setting were live runs with injected sleeps (wall-clock, flaky) or
:meth:`~..utils.straggle.PoolLatencyModel.optimal_nwait`'s closed-form
Monte Carlo (fast, but it models an epoch as one order statistic and
never exercises the real pool's stale-harvest/re-task machinery).
This module is the third estimator: run the REAL ``asyncmap`` loop on a
:class:`~.backend.SimBackend` for every candidate policy and measure
virtual wall clock — the full pool semantics at simulator speed,
against either a recorded trace (:class:`~.replay.ReplayTrace`), a
fitted latency model (:func:`~.backend.model_delay_fn`), or any
:mod:`..utils.faults` schedule.

Every sweep respects the decodability floor: for an (n, k) code, fewer
than k fresh shards cannot decode, so candidates below ``floor`` are
never evaluated (the same ``kmin`` contract as
``PoolLatencyModel.optimal_nwait`` and ``AdaptiveNwait``), and
:func:`recommend_nwait` cross-checks the sim sweep against the model's
analytic pick so the two estimators keep each other honest.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np

from ..backends.base import DelayFn
from ..pool import AsyncPool, asyncmap, waitall
from ..utils.hedge import HedgedServer
from ..utils.trace import EpochTracer
from .backend import SimBackend, model_delay_fn
from .clock import VirtualClock
from .replay import ReplayTrace, _later_12b

__all__ = [
    "NwaitSweep",
    "sweep_nwait",
    "sweep_hedge",
    "sweep_code_rate",
    "sweep_harvest_k",
    "sweep_hierarchical",
    "sweep_router_policy",
    "sweep_spill_capacity",
    "sweep_tenant_weights",
    "sweep_tier_split",
    "recommend_nwait",
    "recovered_work_per_s",
]


def _echo(i, payload, epoch):
    return payload


def recovered_work_per_s(
    k: float, mean_epoch_s: float,
    *, utility: Callable[[int], float] | None = None,
) -> float:
    """The recovered-work-per-virtual-second objective every
    code-rate-style sweep shares (``sweep_nwait``, ``sweep_code_rate``,
    ``sweep_hierarchical`` — ONE implementation, not three):
    ``utility(k) / mean_epoch_s`` with the default utility ``k`` —
    source blocks recovered per epoch, so the default objective is
    maximum decoded work per second. ``k`` is whatever the sweep's
    recovery unit is (fresh shards for a flat code, ``L * inner_nwait``
    source blocks for the hierarchical pair)."""
    u = float(k) if utility is None else float(utility(k))
    return u / mean_epoch_s if mean_epoch_s > 0 else float(np.inf)


def _resolve_delay(source, *, seed: int) -> tuple[DelayFn, int | None]:
    """(delay_fn, n_workers hint) from a trace / model / DelayFn."""
    if isinstance(source, ReplayTrace):
        return source.delay_fn(), source.n_workers
    if hasattr(source, "workers") and hasattr(source, "observe_pool"):
        return model_delay_fn(source, seed=seed), source.n_workers
    if callable(source):
        return source, None
    raise TypeError(
        "latency source must be a ReplayTrace, a PoolLatencyModel, or "
        f"a DelayFn callable, got {type(source)}"
    )


class NwaitSweep:
    """Result table of one policy sweep.

    ``entries`` rows: ``nwait``, ``mean_epoch_s`` / ``p95_epoch_s``
    (virtual), ``utility_per_s`` (``utility(k) / mean_epoch_s`` — the
    ``optimal_nwait`` objective, default utility ``k`` = fresh results
    per epoch), ``n_stale`` harvested over the run. ``best`` is the
    recommended nwait (argmax utility-per-second, never below the
    floor by construction).
    """

    def __init__(self, entries: list[dict], floor: int):
        if not entries:
            raise ValueError("empty sweep: no candidate policies ran")
        self.entries = entries
        self.floor = int(floor)
        self.best = int(
            max(entries, key=lambda r: r["utility_per_s"])["nwait"]
        )

    def entry(self, nwait: int) -> dict:
        for r in self.entries:
            if r["nwait"] == nwait:
                return r
        raise KeyError(f"nwait={nwait} was not swept")

    def table(self) -> str:
        """Human-readable sweep table (examples/policy_tuning.py)."""
        lines = [
            f"{'nwait':>6} {'mean epoch':>12} {'p95 epoch':>12} "
            f"{'util/s':>10} {'stale':>6}"
        ]
        for r in self.entries:
            mark = " <- best" if r["nwait"] == self.best else ""
            lines.append(
                f"{r['nwait']:>6} {r['mean_epoch_s']*1e3:>9.3f} ms "
                f"{r['p95_epoch_s']*1e3:>9.3f} ms "
                f"{r['utility_per_s']:>10.1f} {r['n_stale']:>6}{mark}"
            )
        return "\n".join(lines)

    def __repr__(self) -> str:
        return (
            f"NwaitSweep(best={self.best}, floor={self.floor}, "
            f"{len(self.entries)} candidates)"
        )


def sweep_nwait(
    source,
    *,
    n_workers: int | None = None,
    epochs: int = 100,
    floor: int = 1,
    nwait_values: Sequence[int] | None = None,
    utility: Callable[[int], float] | None = None,
    work_fn=None,
    payload=None,
    seed: int = 0,
    registry=None,
    spans=None,
) -> NwaitSweep:
    """Price every candidate ``nwait`` by running the real pool loop on
    virtual time.

    ``source`` supplies the fleet's latency behavior: a
    :class:`~.replay.ReplayTrace` (recorded incident), a
    :class:`~..utils.straggle.PoolLatencyModel` (fitted fleet), or a
    raw :data:`~..backends.base.DelayFn` (synthetic scenario —
    ``n_workers`` required then). Candidates default to
    ``floor..n_workers``; anything below ``floor`` (the code's
    decodability k) is refused rather than silently clamped.
    """
    delay_fn, n_hint = _resolve_delay(source, seed=seed)
    n = int(n_workers if n_workers is not None else (n_hint or 0))
    if n <= 0:
        raise ValueError(
            "n_workers is required when the latency source does not "
            "carry a pool size"
        )
    floor = int(floor)
    if not (1 <= floor <= n):
        raise ValueError(f"floor must be in [1, {n}], got {floor}")
    ks = (
        list(range(floor, n + 1)) if nwait_values is None
        else sorted({int(k) for k in nwait_values})
    )
    if any(k < floor for k in ks):
        raise ValueError(
            f"nwait candidates {sorted(k for k in ks if k < floor)} sit "
            f"below the decodability floor {floor}: fewer than "
            f"{floor} fresh shards cannot decode"
        )
    if any(k > n for k in ks):
        raise ValueError(f"nwait candidates must be <= n_workers={n}")
    if work_fn is None:
        work_fn = _echo
    if payload is None:
        payload = np.zeros(1, dtype=np.float64)
    entries: list[dict] = []
    for k in ks:
        backend = SimBackend(
            work_fn, n, delay_fn=delay_fn, clock=VirtualClock(),
            registry=registry, spans=spans,
        )
        pool = AsyncPool(n)
        tracer = EpochTracer()  # sim runs feed the same tracer plane
        walls = np.empty(epochs)
        for e in range(epochs):
            t0 = backend.clock.now()
            asyncmap(pool, payload, backend, nwait=k, tracer=tracer)
            walls[e] = backend.clock.now() - t0
        if pool.active.any():
            waitall(pool, backend, tracer=tracer)
        mean = float(walls.mean())
        entries.append({
            "nwait": k,
            "mean_epoch_s": mean,
            "p95_epoch_s": float(np.percentile(walls, 95)),
            "utility_per_s": recovered_work_per_s(k, mean, utility=utility),
            "n_stale": int(sum(r.n_stale for r in tracer.records)),
        })
    return NwaitSweep(entries, floor)


def sweep_code_rate(
    source,
    *,
    n_workers: int | None = None,
    k_values: Sequence[int],
    epochs: int = 100,
    utility: Callable[[int], float] | None = None,
    seed: int = 0,
) -> NwaitSweep:
    """Price (n, k) code rates: each candidate k runs at ``nwait=k``
    (the decodability floor IS the policy — an (n, k) code returns the
    moment k shards are fresh), utility defaulting to recovered work
    per second (``k / E[epoch]``). Lower k dodges deeper order
    statistics but discards more redundant compute; the sweep prices
    that trade on the actual pool semantics."""
    ks = sorted({int(k) for k in k_values})
    return sweep_nwait(
        source, n_workers=n_workers, epochs=epochs, floor=min(ks),
        nwait_values=ks, utility=utility, seed=seed,
    )


def sweep_hierarchical(
    source,
    *,
    groups: int,
    n_inner: int,
    candidates: Sequence[tuple[float, int]],
    inner_floor: int = 1,
    epochs: int = 60,
    failures=None,
    outer_kind: str = "auto",
    utility: Callable[[int], float] | None = None,
    seed: int = 0,
    model=None,
    registry=None,
    spans=None,
) -> dict[str, Any]:
    """Price ``(outer_rate, inner_nwait)`` pairs for the two-level
    hierarchical code (:class:`~..ops.hierarchical.
    HierarchicalCodedGemm`) by running the REAL pool loop — the real
    ``asyncmap`` under the real :func:`~..ops.outer_code.
    hierarchical_nwait` two-level predicate — on a :class:`~.backend.
    SimBackend` fleet of ``groups * n_inner`` workers, per candidate.
    This is the (outer rate, inner nwait) latency–communication
    trade-off of arxiv 1808.06583 priced on the actual pool semantics
    instead of a closed form.

    ``source`` supplies fleet latency like every sweep here (a
    :class:`~.replay.ReplayTrace`, a fitted
    :class:`~..utils.straggle.PoolLatencyModel`, or a raw DelayFn);
    ``failures`` maps group id -> kill epoch and injects whole-host
    failures via :class:`~..utils.faults.kill_group` on top of it —
    the scenario the outer code exists for, testable deterministically.

    Candidates below EITHER decodability floor are REFUSED, never
    clamped (the ``sweep_nwait`` contract): an ``inner_nwait`` below
    ``inner_floor`` cannot inner-decode, an ``outer_rate`` rounding to
    ``L < 1`` source groups cannot outer-decode, and an ``outer_rate``
    whose ``L`` exceeds the groups surviving the scheduled failures
    can never complete an epoch after the kill.

    Utility is the shared :func:`recovered_work_per_s` objective with
    recovery unit ``L * inner_nwait`` (source blocks decoded per
    epoch) — sweep_code_rate's recovered-work/s, not a third copy.

    The returned dict carries the ``recommend_nwait``-style inner
    cross-check: ``inner_model`` is the analytic
    ``PoolLatencyModel.optimal_nwait`` over ONE surviving group's
    fitted per-worker distributions (``check_group``), and ``agree``
    flags whether the sim's chosen inner_nwait matches it — divergence
    means the two-level pool dynamics (which only the sim exercises)
    moved the inner optimum.
    """
    # lazy: importing ops/ imports torch, and sim/ imports none
    from ..ops.outer_code import (
        hierarchical_nwait,
        make_outer,
        partition_groups,
    )
    from ..utils import faults
    from ..utils.straggle import PoolLatencyModel

    H, ni = int(groups), int(n_inner)
    if H < 1 or ni < 1:
        raise ValueError(f"need groups >= 1 and n_inner >= 1, got {groups}, {n_inner}")
    n = H * ni
    inner_floor = int(inner_floor)
    if not (1 <= inner_floor <= ni):
        raise ValueError(
            f"inner_floor must be in [1, {ni}], got {inner_floor}"
        )
    cands = [(float(r), int(k)) for r, k in candidates]
    if not cands:
        raise ValueError("empty sweep: no candidate policies given")
    kills = {} if failures is None else {
        int(g): int(e) for g, e in dict(failures).items()
    }
    # groups whose kill never fires inside the run count as survivors
    surviving_ids = [
        g for g in range(H) if kills.get(g, epochs + 1) > epochs
    ]
    # validate EVERY candidate before any runs: a refusal names the
    # floor it sits under, it never silently clamps. The check is on
    # the surviving group-ID SET, not its size: an LT outer whose
    # survivors are all non-systematic shards can have |survivors| >=
    # L and still never peel (review finding — the count check let
    # such a candidate run and priced the 3600 s dead-stall as data).
    outers = []
    for rate, k in cands:
        if k < inner_floor:
            raise ValueError(
                f"inner_nwait={k} sits below the inner decodability "
                f"floor {inner_floor}: fewer than {inner_floor} fresh "
                "shards cannot inner-decode a group"
            )
        if k > ni:
            raise ValueError(
                f"inner_nwait={k} exceeds the {ni} workers of a group"
            )
        outer = make_outer(H, rate=rate, kind=outer_kind, seed=seed)
        if not outer.decodable(surviving_ids):
            raise ValueError(
                f"outer_rate={rate} needs L={outer.L} decodable groups "
                f"but only groups {surviving_ids} of {H} survive the "
                f"scheduled host failures {kills}, and that set cannot "
                "clear the outer decodability floor after the kill"
            )
        outers.append(outer)
    delay_fn, n_hint = _resolve_delay(source, seed=seed)
    if n_hint is not None and int(n_hint) != n:
        raise ValueError(
            f"latency source describes {n_hint} workers but the fleet "
            f"is groups*n_inner = {H}*{ni} = {n}"
        )
    part = partition_groups(n, H)
    if kills:
        delay_fn = faults.compose(
            delay_fn, faults.kill_group(part, kills)
        )
    entries: list[dict] = []
    for (rate, k), outer in zip(cands, outers):
        def inner_arrived(g, fresh, _k=k):
            return int(fresh[part[g]].sum()) >= _k

        pred = hierarchical_nwait(part, inner_arrived, outer)
        backend = SimBackend(
            _echo, n, delay_fn=delay_fn, clock=VirtualClock(),
            registry=registry, spans=spans,
        )
        pool = AsyncPool(n)
        tracer = EpochTracer()
        walls = np.empty(epochs)
        for e in range(epochs):
            t0 = backend.clock.now()
            asyncmap(pool, np.zeros(1), backend, nwait=pred,
                     tracer=tracer)
            walls[e] = backend.clock.now() - t0
        mean = float(walls.mean())
        entries.append({
            "outer_rate": rate,
            "L": outer.L,
            "inner_nwait": k,
            "mean_epoch_s": mean,
            "p95_epoch_s": float(np.percentile(walls, 95)),
            "utility_per_s": recovered_work_per_s(
                outer.L * k, mean, utility=utility
            ),
            "n_stale": int(sum(r.n_stale for r in tracer.records)),
        })
    best = max(entries, key=lambda r: r["utility_per_s"])
    # -- recommend_nwait-style inner cross-check --------------------------
    # the analytic side sees one SURVIVING group's fitted per-worker
    # distributions; the sim's inner pick should match it whenever the
    # candidate grid covers the inner optimum
    # surviving_ids is non-empty here: every candidate proved it can
    # clear the outer floor from the survivors (a scheduled kill whose
    # epoch lies beyond the run leaves its group a survivor — the
    # membership-in-kills test crashed on exactly that, review finding)
    check_group = surviving_ids[0]
    sub = PoolLatencyModel(ni, seed=seed)
    if model is not None or (
        hasattr(source, "workers") and hasattr(source, "observe_pool")
    ):
        src_model = model if model is not None else source
        sub.workers = [
            src_model.workers[int(w)] for w in part[check_group]
        ]
    else:
        base_delay, _ = _resolve_delay(source, seed=seed)
        for e in range(150):
            for j, w in enumerate(part[check_group]):
                sub.observe(j, base_delay(int(w), e))
    inner_model = int(sub.optimal_nwait(
        kmin=inner_floor, kmax=ni, utility=utility
    ))
    return {
        "entries": entries,
        "best": (best["outer_rate"], best["inner_nwait"]),
        "best_entry": best,
        "inner_sim": int(best["inner_nwait"]),
        "inner_model": inner_model,
        "agree": int(best["inner_nwait"]) == inner_model,
        "check_group": int(check_group),
        "surviving_groups": len(surviving_ids),
    }


def sweep_router_policy(*args, **kw):
    """Sweep a routing policy over a simulated fleet day (ROADMAP.md item 12b)."""
    raise _later_12b("sweep_router_policy")


def sweep_tenant_weights(*args, **kw):
    """Sweep DRR tenant weights over a simulated fleet day (ROADMAP.md item 12b)."""
    raise _later_12b("sweep_tenant_weights")


def sweep_tier_split(*args, **kw):
    """Sweep a prefill/decode tier split over a simulated fleet day (ROADMAP.md item 12b)."""
    raise _later_12b("sweep_tier_split")


def sweep_spill_capacity(*args, **kw):
    """Sweep a fleet-cache spill capacity over a simulated fleet day (ROADMAP.md item 12b)."""
    raise _later_12b("sweep_spill_capacity")


def sweep_harvest_k(
    source,
    *,
    n_workers: int | None = None,
    nwait: int,
    epochs: int = 200,
    k_values: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
    host_epoch_s: float = 2e-3,
    host_harvest_s: float = 4e-3,
    staleness_bound_s: float | None = None,
    seed: int = 0,
    registry=None,
    spans=None,
) -> dict[str, Any]:
    """Price the K-epoch harvest cadence of device-resident
    coordination (:class:`~..parallel.device_coord.DeviceCoordinator`)
    on virtual time — the sim twin of the fused window.

    The fused window's arrival recurrence is arithmetically identical
    to the host loop over a :class:`~.backend.SimBackend` (that is the
    ``repochs``-parity contract tests/test_device_coord.py pins), so
    ONE real ``asyncmap`` run on virtual time yields the exact
    per-epoch completion times every candidate K would produce; each K
    then re-slices that timeline into ceil(epochs / K) windows. Two
    terms trade against each other (the arxiv 1808.06583
    latency/communication trade):

    * **amortized host cost** — the host loop pays ``host_epoch_s``
      interpreter time per epoch (2 + 3W host touches); a fused window
      pays ``host_harvest_s`` per harvest (stage + harvest, 2/K per
      epoch amortized). ``utility`` per K is effective epochs/second:
      ``epochs / (virtual_s + n_harvests * host_harvest_s)``. Pass the
      bench-measured costs for this box
      (benchmarks/device_coord_bench.py measures both).
    * **staleness** — a result decoded at the window's first epoch is
      only visible to the host at the window's end; ``staleness_s``
      per K is the maximum such age (≈ the longest window's virtual
      span).

    Refusals, never clamps (the ``sweep_nwait`` contract, each naming
    its floor — pinned by tests/test_device_coord.py):

    * **K < 1** — not a window;
    * **K > epochs** — the run cannot fill one window;
    * **staleness bound violated** — any candidate K whose worst
      window holds results longer than ``staleness_bound_s`` virtual
      seconds before the host sees them.

    Returns entries per K (``window_s`` max/mean, ``staleness_s``,
    ``epochs_per_s``, ``overhead_x`` vs the host loop), ``best`` (the
    K maximizing effective epochs/second), and the host-loop baseline
    rate.
    """
    delay_fn, n_hint = _resolve_delay(source, seed=seed)
    n = int(n_workers if n_workers is not None else (n_hint or 0))
    if n <= 0:
        raise ValueError(
            "n_workers is required when the latency source does not "
            "carry a pool size"
        )
    nwait = int(nwait)
    if not (1 <= nwait <= n):
        raise ValueError(f"nwait must be in [1, {n}], got {nwait}")
    epochs = int(epochs)
    ks = sorted({int(k) for k in k_values})
    bad = [k for k in ks if k < 1]
    if bad:
        raise ValueError(
            f"sweep refused: harvest window K={bad} — a window must "
            "cover at least 1 epoch"
        )
    bad = [k for k in ks if k > epochs]
    if bad:
        raise ValueError(
            f"sweep refused: harvest window K={bad} exceeds the "
            f"{epochs}-epoch run — the host would never harvest"
        )
    backend = SimBackend(
        _echo, n, delay_fn=delay_fn, clock=VirtualClock(),
        registry=registry, spans=spans,
    )
    pool = AsyncPool(n)
    walls = np.empty(epochs)
    for e in range(epochs):
        t0 = backend.clock.now()
        asyncmap(pool, np.zeros(1), backend, nwait=nwait)
        walls[e] = backend.clock.now() - t0
    virtual_s = float(walls.sum())
    host_rate = epochs / (virtual_s + epochs * float(host_epoch_s))
    entries: list[dict] = []
    violations: list[tuple[int, float]] = []
    for k in ks:
        spans_k = [
            float(walls[i : i + k].sum())
            for i in range(0, epochs, k)
        ]
        n_harvests = len(spans_k)
        stale = max(spans_k)
        if (
            staleness_bound_s is not None
            and stale > float(staleness_bound_s)
        ):
            violations.append((k, stale))
        rate = epochs / (
            virtual_s + n_harvests * float(host_harvest_s)
        )
        entries.append({
            "K": k,
            "n_harvests": n_harvests,
            "window_mean_s": float(np.mean(spans_k)),
            "window_max_s": stale,
            "staleness_s": stale,
            "epochs_per_s": rate,
            "overhead_x": rate / host_rate,
        })
    if violations:
        worst_k, worst_s = max(violations, key=lambda v: v[1])
        raise ValueError(
            f"sweep refused: harvest window K="
            f"{[k for k, _ in violations]} violates the staleness "
            f"bound {float(staleness_bound_s):.6g}s — K={worst_k} "
            f"holds results up to {worst_s:.6g} virtual seconds "
            "before the host sees them; shrink K or relax the bound"
        )
    best = max(entries, key=lambda r: r["epochs_per_s"])
    return {
        "entries": entries,
        "best": int(best["K"]),
        "best_entry": best,
        "virtual_s": virtual_s,
        "host_loop_epochs_per_s": host_rate,
        "host_epoch_s": float(host_epoch_s),
        "host_harvest_s": float(host_harvest_s),
        "nwait": nwait,
        "epochs": epochs,
    }


def sweep_hedge(
    source,
    *,
    n_workers: int | None = None,
    widths: Sequence[int] | None = None,
    requests: int = 40,
    tolerance: float = 0.05,
    seed: int = 0,
) -> dict[str, Any]:
    """Price hedge widths by running the REAL :class:`HedgedServer` on
    virtual time: per width, ``requests`` sequential requests (the
    fleet quiesced between requests so every width sees identical
    conditions), reporting virtual first-arrival latency stats and the
    replica-seconds each width burns. Recommended width: the narrowest
    whose p95 is within ``tolerance`` of the best p95 — wider hedges
    that buy no tail are pure dispatch cost."""
    delay_fn, n_hint = _resolve_delay(source, seed=seed)
    n = int(n_workers if n_workers is not None else (n_hint or 0))
    if n <= 0:
        raise ValueError(
            "n_workers is required when the latency source does not "
            "carry a pool size"
        )
    ws = list(range(1, n + 1)) if widths is None else sorted(
        {int(w) for w in widths}
    )
    if any(w < 1 or w > n for w in ws):
        raise ValueError(f"hedge widths must be in [1, {n}], got {ws}")
    entries = []
    for w in ws:
        backend = SimBackend(
            _echo, n, delay_fn=delay_fn, clock=VirtualClock()
        )
        srv = HedgedServer(backend)
        lats = np.empty(requests)
        for q in range(requests):
            t0 = backend.clock.now()
            srv.request(np.asarray([q], dtype=np.int64), hedge=w)
            lats[q] = backend.clock.now() - t0
            backend.quiesce()   # losers land before the next request
            srv._harvest()
        entries.append({
            "width": w,
            "mean_latency_s": float(lats.mean()),
            "p95_latency_s": float(np.percentile(lats, 95)),
            "max_latency_s": float(lats.max()),
            "dispatches": int(backend.n_dispatched),
        })
    best_p95 = min(r["p95_latency_s"] for r in entries)
    rec = next(
        r["width"] for r in entries
        if r["p95_latency_s"] <= best_p95 * (1.0 + tolerance)
    )
    return {
        "entries": entries,
        "recommended_width": int(rec),
        "best_p95_s": float(best_p95),
    }


def recommend_nwait(
    model,
    *,
    floor: int = 1,
    kmax: int | None = None,
    epochs: int = 300,
    seed: int = 0,
    utility: Callable[[int], float] | None = None,
) -> dict[str, Any]:
    """Cross-checked nwait recommendation from a fitted
    :class:`~..utils.straggle.PoolLatencyModel`: the sim sweep (real
    pool loop, virtual time, :func:`~.backend.model_delay_fn` fleet)
    and the model's analytic ``optimal_nwait`` side by side. Agreement
    is the expected state — both estimate argmax utility(k)/E[T_(k)]
    over the same distributions; divergence means the pool's
    stale-harvest dynamics (which only the sim sees) are moving the
    optimum, and the sim's answer is the one that priced them."""
    sweep = sweep_nwait(
        model, epochs=epochs, floor=floor,
        nwait_values=(
            None if kmax is None else range(floor, int(kmax) + 1)
        ),
        utility=utility, seed=seed,
    )
    analytic = model.optimal_nwait(
        kmin=floor, kmax=kmax, utility=utility
    )
    return {
        "sim_nwait": sweep.best,
        "model_nwait": int(analytic),
        "agree": sweep.best == int(analytic),
        "sweep": sweep,
    }
