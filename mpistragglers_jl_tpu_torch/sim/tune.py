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
from .replay import ReplayTrace

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


def _resolve_fast(fast: str) -> bool:
    """Shared ``fast=`` knob of the router-day sweeps: ``"auto"`` runs
    each candidate day through :func:`~.fastpath.run_router_day_fast`
    (bit-identical digests by contract, so the sweep's decision is
    unchanged — only its cost), ``"never"`` pins the scalar loop.
    Unsupported day shapes (e.g. ``chunk_s`` tiers) fall back to the
    scalar path inside ``run_router_day_fast`` itself, so ``"auto"``
    is always safe to leave on."""
    if fast not in ("auto", "never"):
        raise ValueError(
            f'fast must be "auto" or "never", got {fast!r}'
        )
    return fast == "auto"


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


def sweep_router_policy(
    *,
    n_replicas: int = 4,
    slots: int = 4,
    n_inner: int = 8,
    tick_s: float = 0.02,
    tick_sigma: float = 0.3,
    straggler: dict | None = None,
    policies: Sequence[str] | None = None,
    load: float = 0.8,
    prefix_share: float = 0.0,
    requests: int = 2000,
    prompt_len: int = 96,
    prefix_len: int = 64,
    n_prefix_groups: int = 4,
    max_new: int = 32,
    prompt_chunk: int = 64,
    ttft_slo: float | None = None,
    admission_slo_s: float | None = None,
    dead: Sequence[int] = (),
    seed: int = 0,
    fast: str = "auto",
) -> dict[str, Any]:
    """Recommend a request-routing policy for ONE (``load``,
    ``prefix_share``) operating point by running the REAL
    :class:`~..models.router.RequestRouter` — the identical routing
    code a live fleet runs — over :class:`~.workload.SimReplica`
    scheduler models on virtual time, one seeded Poisson stream per
    candidate policy (same seed, so every policy faces the identical
    arrivals). Call it per point to map a (load, prefix-share) grid.

    The fleet straggles realistically: per-tick service jitter
    (``tick_sigma`` lognormal, seeded per replica) plus optional
    designated stragglers (``straggler={replica: tick_multiplier}``) —
    the imbalance ``least_loaded`` routes around, ``prefix_affinity``
    trades against locality, and ``hedge_p99`` papers over at the
    cost of duplicate dispatches. ``load`` is offered load as a
    fraction of the admittable fleet's mean service capacity; ``dead``
    replicas are killed before the run (the router must route around
    them from the first request).

    Refusals, never clamps (the ``sweep_nwait`` contract — each names
    its floor, pinned by tests/test_torch_sim_workload.py):

    * **zero admittable replicas** — every replica dead: no admission
      SLO is meetable by any policy;
    * **offered load >= 1** — open-loop saturation: queues grow
      without bound, so no routing policy can meet an admission SLO;
    * **hedge_p99 without ttft_slo** — the deadline IS the policy;
    * **no policy meets the admission SLO** (post-run, when
      ``admission_slo_s`` is given and every candidate's p99 queue
      wait exceeds it).

    Returns entries per policy (p50/p99/mean TTFT, p99 queue wait,
    hedges, re-routes, shared admissions, ``admissible``), ``best``
    (lowest p99 TTFT among admissible policies), and
    ``p99_vs_round_robin`` — the headline ratio the bench rung pins.

    ``fast="auto"`` (default) prices each candidate day on the
    vectorized :mod:`~.fastpath` engine — same digest, so the same
    decision, at a fraction of the cost; the identical seeded arrival
    stream is materialized ONCE as an :class:`~.fastpath.ArrivalBatch`
    and shared across candidates. ``fast="never"`` pins the scalar
    loop (the parity suite's reference).
    """
    # lazy, like sweep_hierarchical's ops import: models/ is the
    # accelerator package namespace (the router itself imports no torch) —
    # keep sim/'s import closure free of torch
    from ..models.router import ROUTER_POLICIES, RequestRouter
    from .workload import (
        SimReplica,
        lognormal_ticks,
        poisson_arrivals,
        run_router_day,
    )

    n_replicas = int(n_replicas)
    dead_set = {int(d) for d in dead}
    if not (dead_set <= set(range(n_replicas))):
        raise ValueError(
            f"dead replicas {sorted(dead_set)} outside the fleet "
            f"[0, {n_replicas})"
        )
    admittable = n_replicas - len(dead_set)
    if admittable < 1:
        raise ValueError(
            f"sweep refused: zero admittable replicas "
            f"({len(dead_set)} of {n_replicas} dead) — no routing "
            "policy can admit anything"
        )
    load = float(load)
    if not (0.0 < load < 1.0):
        raise ValueError(
            f"sweep refused: offered load {load:.2f} must sit in "
            "(0, 1) — at or beyond 1 the open-loop queue grows "
            "without bound and no routing policy can meet an "
            "admission SLO"
        )
    if policies is None:
        # two_tier is NOT a candidate here: it needs a two-tier fleet
        # shape (and a migration byte model), which is exactly what
        # sweep_tier_split builds and prices
        policies = [
            p for p in ROUTER_POLICIES
            if (p != "hedge_p99" or ttft_slo is not None)
            and p != "two_tier"
        ]
    policies = list(policies)
    if "two_tier" in policies:
        raise ValueError(
            "sweep refused: two_tier is priced by sweep_tier_split "
            "(it sweeps the (n_prefill, n_decode) fleet shape and "
            "migration threshold, not just a policy flag)"
        )
    unknown = [p for p in policies if p not in ROUTER_POLICIES]
    if unknown:
        raise ValueError(
            f"unknown router policies {unknown}; choose from "
            f"{ROUTER_POLICIES}"
        )
    if "hedge_p99" in policies and ttft_slo is None:
        raise ValueError(
            "sweep refused: hedge_p99 without ttft_slo — the TTFT "
            "deadline IS the policy; pass ttft_slo=<seconds>"
        )
    mult = {int(k): float(v) for k, v in (straggler or {}).items()}
    # offered rate = load x the admittable fleet's mean service
    # capacity (slot-holding ticks per request at the mean tick —
    # the ONE formula, shared with fleet.signals.replica_capacity_rps)
    from .workload import service_ticks_per_request

    ticks_per_req = service_ticks_per_request(
        prompt_len=prompt_len, prompt_chunk=prompt_chunk,
        max_new=max_new, n_inner=n_inner,
    )
    per_slot_rate = 1.0 / (ticks_per_req * float(tick_s))
    fleet_rate = sum(
        int(slots) * per_slot_rate / mult.get(i, 1.0)
        for i in range(n_replicas) if i not in dead_set
    )
    rate = load * fleet_rate
    arrival_kw = dict(
        prompt_len=prompt_len, max_new=max_new,
        prefix_share=prefix_share, prefix_len=prefix_len,
        n_prefix_groups=n_prefix_groups,
    )
    batch = None
    if _resolve_fast(fast):
        from .fastpath import poisson_arrival_batch, run_router_day_fast

        # every candidate faces the identical seeded stream, so the
        # cohort batch is generated once and shared across policies
        batch = poisson_arrival_batch(
            rate, n=requests, seed=seed, **arrival_kw
        )
    entries: list[dict] = []
    for policy in policies:
        clock = VirtualClock()
        replicas = []
        for i in range(n_replicas):
            rep = SimReplica(
                clock, slots=slots, n_inner=n_inner,
                prompt_chunk=prompt_chunk,
                tick_s=lognormal_ticks(
                    float(tick_s) * mult.get(i, 1.0),
                    float(tick_sigma), seed=int(seed) * 1009 + i,
                ),
            )
            if i in dead_set:
                rep.kill()
            replicas.append(rep)
        router = RequestRouter(
            replicas, policy=policy, clock=clock,
            ttft_slo=ttft_slo if policy == "hedge_p99" else None,
        )
        if batch is not None:
            report = run_router_day_fast(router, batch)
        else:
            report = run_router_day(
                router,
                poisson_arrivals(
                    rate, n=requests, seed=seed, **arrival_kw
                ),
            )
        waits = np.asarray([
            (r.t_admitted - r.t_submit) for r in report.requests
            if r.t_admitted is not None
        ])
        p99_wait = (
            float(np.percentile(waits, 99)) if waits.size else 0.0
        )
        entries.append({
            "policy": policy,
            "p50_ttft_s": report.p50_ttft(),
            "p99_ttft_s": report.p99_ttft(),
            "mean_ttft_s": float(report.ttft.mean()),
            "p99_queue_wait_s": p99_wait,
            "completed": report.n - report.dropped,
            "dropped": report.dropped,
            "hedges": report.n_hedges,
            "rerouted": report.n_rerouted,
            "shared_admits": sum(
                r.n_shared_admits for r in replicas
            ),
            "admissible": (
                admission_slo_s is None
                or p99_wait <= float(admission_slo_s)
            ),
        })
    ok = [e for e in entries if e["admissible"]]
    if not ok:
        raise ValueError(
            f"no policy meets the admission SLO: every candidate's "
            f"p99 queue wait exceeds {admission_slo_s}s at load "
            f"{load:.2f} (swept {[e['policy'] for e in entries]}) — "
            "add replicas or shed load; the sweep refuses rather "
            "than recommend a policy that cannot admit"
        )
    best = min(ok, key=lambda e: e["p99_ttft_s"])
    rr = next(
        (e for e in entries if e["policy"] == "round_robin"), None
    )
    return {
        "entries": entries,
        "best": best["policy"],
        "best_entry": best,
        "p99_vs_round_robin": (
            None if rr is None
            else rr["p99_ttft_s"] / best["p99_ttft_s"]
        ),
        "load": load,
        "prefix_share": float(prefix_share),
        "rate_req_s": rate,
        "requests": int(requests),
    }


def sweep_tenant_weights(
    *,
    contracts: Sequence,
    candidates: Sequence[dict],
    n_replicas: int = 4,
    slots: int = 4,
    n_inner: int = 8,
    tick_s: float = 0.02,
    tick_sigma: float = 0.3,
    load: float = 0.8,
    requests: int = 2000,
    prompt_len: int = 96,
    max_new: int = 32,
    prompt_chunk: int = 64,
    seed: int = 0,
    fast: str = "auto",
    budget_s: float | None = None,
    timer: Callable[[], float] | None = None,
) -> dict[str, Any]:
    """Recommend DRR weights for a set of tenant contracts by running
    the REAL QoS plane — :class:`~..models.router.RequestRouter` +
    :class:`~..qos.DeficitScheduler` admission inside
    :class:`~.workload.SimReplica` fleets — over one seeded
    tenant-mixed day per candidate weight vector (same seed, so every
    candidate faces the identical arrivals: times, prompts, AND
    tenant labels). ``contracts`` is the fleet's
    :class:`~..qos.TenantContract` list; each candidate in
    ``candidates`` maps every tenant name to a weight.

    Each tenant offers ``load`` of ITS OWN token budget (arrival
    shares proportional to budgets), so the swept day measures what
    the weights do to compliant traffic — shed/pacing behavior is the
    bucket's job at the door, not the sweep's.

    Refusals, never clamps (the ``sweep_nwait`` contract — each names
    its floor, pinned by tests/test_torch_qos.py):

    * **infeasible contracts: aggregate budget >= capacity** — the
      tenants' token-rate budgets sum to at least the fleet's token
      capacity (or a tenant has NO budget, making the aggregate
      unbounded): the contracts cannot be jointly honored by any
      weight assignment;
    * **latency-class tenant without a ttft_slo** — the sweep scores
      latency tenants against their advertised deadline; a
      latency-class contract that never states one is an error, not
      a default;
    * **candidate weights not covering the tenant set** — every
      candidate must name exactly the contract tenants, weights > 0;
    * **no candidate meets every latency-class SLO** (post-run): the
      sweep refuses rather than recommend weights that break a
      contract.

    Returns entries per candidate (per-tenant p50/p99 TTFT via
    :meth:`~.workload.WorkloadReport.per_tenant`, the worst
    normalized latency-tenant p99 as ``score``), ``best`` (lowest
    score), and the capacity numbers the feasibility check used.

    ``fast="auto"`` prices each candidate day on the vectorized
    :mod:`~.fastpath` engine (bit-identical digest, same decision,
    lower cost); the seeded tenant-mixed stream is materialized once
    and shared across candidates. ``budget_s`` bounds the sweep's
    decision cost: candidates are evaluated in order until the budget
    is spent (at least one always runs), and the result records
    ``candidates_evaluated`` / ``budget_exhausted`` — the point of the
    fast path is that the SAME budget covers a strictly larger grid.
    Wall time is never read silently (no silent wall clock): ``budget_s``
    requires an injected ``timer``."""
    # lazy, the sweep_router_policy pattern: models/ is the
    # accelerator package namespace; qos/ is stdlib-only but stays a
    # lazy import for the same explicit-closure discipline
    from ..models.router import RequestRouter
    from ..qos import TenantContract, TenantRegistry
    from .workload import (
        SimReplica,
        lognormal_ticks,
        poisson_arrivals,
        run_router_day,
        service_ticks_per_request,
    )

    contracts = list(contracts)
    if not contracts:
        raise ValueError("sweep refused: no tenant contracts given")
    names = [c.name for c in contracts]
    for c in contracts:
        if c.cls == "latency" and c.ttft_slo is None:
            raise ValueError(
                f"sweep refused: latency-class tenant {c.name!r} has "
                "no ttft_slo — the sweep scores latency tenants "
                "against their advertised deadline; state one in the "
                "contract"
            )
        if c.rate is None:
            raise ValueError(
                f"sweep refused: tenant {c.name!r} has no token "
                "budget (rate=None) — the aggregate budget is then "
                "unbounded and can never fit capacity; give every "
                "tenant a rate"
            )
    tok_per_req = int(prompt_len) + int(max_new)
    ticks_per_req = service_ticks_per_request(
        prompt_len=prompt_len, prompt_chunk=prompt_chunk,
        max_new=max_new, n_inner=n_inner,
    )
    fleet_req_rate = (
        int(n_replicas) * int(slots)
        / (ticks_per_req * float(tick_s))
    )
    capacity_tok_s = fleet_req_rate * tok_per_req
    aggregate = sum(c.rate for c in contracts)
    if aggregate >= capacity_tok_s:
        raise ValueError(
            f"sweep refused: infeasible contracts — aggregate token "
            f"budget {aggregate:.0f} tok/s >= fleet capacity "
            f"{capacity_tok_s:.0f} tok/s ({n_replicas} replicas x "
            f"{slots} slots): no weight assignment can honor them; "
            "shrink budgets or grow the fleet"
        )
    candidates = [dict(cand) for cand in candidates]
    if not candidates:
        raise ValueError("sweep refused: no candidate weight vectors")
    for cand in candidates:
        if sorted(cand) != sorted(names):
            raise ValueError(
                f"sweep refused: candidate weights {sorted(cand)} "
                f"must name exactly the contract tenants "
                f"{sorted(names)}"
            )
        for t, w in cand.items():
            if not w > 0:
                raise ValueError(
                    f"sweep refused: candidate weight {w} for tenant "
                    f"{t!r} must be > 0"
                )
    if budget_s is not None and timer is None:
        raise ValueError(
            "budget_s requires an injected timer= (wall time is never "
            "read silently — the no-silent-clock contract); pass "
            "time.perf_counter or a virtual clock"
        )
    # each tenant offers `load` of its own budget; shares follow
    tenant_tok_rate = {c.name: load * c.rate for c in contracts}
    offered_tok = sum(tenant_tok_rate.values())
    rate = offered_tok / tok_per_req
    shares = {t: r / offered_tok for t, r in tenant_tok_rate.items()}
    latency_slo = {
        c.name: c.ttft_slo for c in contracts if c.cls == "latency"
    }
    batch = None
    if _resolve_fast(fast):
        from .fastpath import poisson_arrival_batch, run_router_day_fast

        batch = poisson_arrival_batch(
            rate, n=int(requests), seed=seed, prompt_len=prompt_len,
            max_new=max_new, tenants=shares,
        )
    t0 = timer() if timer is not None else 0.0
    entries: list[dict] = []
    n_evaluated = 0
    for cand in candidates:
        if (
            budget_s is not None and n_evaluated > 0
            and timer() - t0 > float(budget_s)
        ):
            break
        n_evaluated += 1
        reg = TenantRegistry([
            TenantContract(
                c.name, cls=c.cls, weight=cand[c.name], rate=c.rate,
                burst=c.burst, pages=c.pages, hedges=c.hedges,
                ttft_slo=c.ttft_slo,
            )
            for c in contracts
        ])
        clock = VirtualClock()
        replicas = [
            SimReplica(
                clock, slots=slots, n_inner=n_inner,
                prompt_chunk=prompt_chunk, qos=reg,
                tick_s=lognormal_ticks(
                    float(tick_s), float(tick_sigma),
                    seed=int(seed) * 1009 + i,
                ),
            )
            for i in range(int(n_replicas))
        ]
        router = RequestRouter(
            replicas, policy="least_loaded", clock=clock, qos=reg,
        )
        if batch is not None:
            report = run_router_day_fast(router, batch)
        else:
            report = run_router_day(
                router,
                poisson_arrivals(
                    rate, n=int(requests), seed=seed,
                    prompt_len=prompt_len, max_new=max_new,
                    tenants=shares,
                ),
            )
        per = report.per_tenant()
        # score: the worst latency-class p99 normalized by its SLO
        # (<= 1 means every latency contract held)
        score = 0.0
        for t, slo in latency_slo.items():
            if t in per:
                score = max(score, per[t]["p99_ttft_s"] / slo)
        entries.append({
            "weights": dict(cand),
            "per_tenant": per,
            "score": score,
            "shed": report.n_shed,
            "admissible": all(
                per.get(t, {"p99_ttft_s": 0.0})["p99_ttft_s"] <= slo
                for t, slo in latency_slo.items()
            ),
        })
    ok = [e for e in entries if e["admissible"]]
    if latency_slo and not ok:
        raise ValueError(
            f"no candidate meets every latency-class SLO "
            f"({latency_slo}): worst normalized p99 per candidate "
            f"{[round(e['score'], 3) for e in entries]} — the sweep "
            "refuses rather than recommend weights that break a "
            "contract; grow the fleet or loosen the SLOs"
        )
    pool = ok if ok else entries
    best = min(pool, key=lambda e: e["score"])
    return {
        "entries": entries,
        "best": best["weights"],
        "best_entry": best,
        "capacity_tok_s": capacity_tok_s,
        "aggregate_budget_tok_s": aggregate,
        "rate_req_s": rate,
        "tenant_shares": shares,
        "requests": int(requests),
        "candidates_evaluated": n_evaluated,
        "budget_s": budget_s,
        "budget_exhausted": n_evaluated < len(candidates),
    }


def sweep_tier_split(
    *,
    splits: Sequence[tuple[int, int]],
    migration_thresholds: Sequence[int | None] = (None,),
    slots: int = 4,
    n_inner: int = 8,
    tick_s: float = 0.02,
    chunk_s: float = 0.01,
    tick_sigma: float = 0.0,
    load: float = 0.8,
    requests: int = 2000,
    prompt_len: int = 64,
    max_new: int = 32,
    long_share: float = 0.1,
    long_prompt_len: int = 1024,
    long_max_new: int | None = None,
    prompt_chunk: int = 64,
    kv_bytes_per_token: float = 4096.0,
    migrate_gbs: float = 5.2,
    decode_p99_slo_s: float | None = None,
    seed: int = 0,
    fast: str = "auto",
) -> dict[str, Any]:
    """Price ``(n_prefill, n_decode)`` tier splits and migration-size
    thresholds for the disaggregated serving tier by running the REAL
    :class:`~..models.router.RequestRouter` ``two_tier`` policy — the
    identical placement/migration code a live fleet runs — over
    two-tier :class:`~.workload.SimReplica` fleets on virtual time,
    one seeded mixed long-prompt/short-chat Poisson stream per
    candidate (same seed: every candidate faces identical arrivals).

    Each candidate is one ``(split, threshold)`` pair from the cross
    product; ``chunk_s`` prices prefill work into tick time (the
    contention disaggregation removes — at ``chunk_s=0`` every split
    ties and the sweep is meaningless), ``migrate_gbs`` prices each
    migration's payload transfer at the measured ring rate, and the
    headline per candidate is **decode p99** — the p99 per-request
    mean inter-token gap (:meth:`~.workload.WorkloadReport.
    p99_decode_itl`), the tail a long-prompt burst wrecks.

    Refusals, never clamps (the ``sweep_nwait`` contract — each names
    its floor, pinned by tests/test_torch_disagg.py):

    * **zero replicas in either tier** — a split with no prefill or no
      decode replicas is not a two-tier fleet;
    * **offered load >= 1** — open-loop saturation: queues grow
      without bound and no split can meet a decode SLO;
    * **no split meets the decode-p99 SLO** (post-run, when
      ``decode_p99_slo_s`` is given and every candidate's decode p99
      exceeds it).

    Returns entries per candidate (decode p99, TTFT percentiles,
    migrations landed/kept local, bytes moved), ``best`` — the
    ``(split, threshold)`` with the lowest decode p99 among admissible
    candidates — and ``decode_p99_vs_worst`` for quick reading.

    ``fast="auto"`` accepts the shared sweep knob for uniformity, but
    two-tier days price prefill contention through ``chunk_s`` — a
    carried-state tick stretch the vectorized engine does not model —
    so ``run_router_day_fast`` detects the shape and runs the scalar
    loop (``report.fastpath`` names the reason); the arrival batch is
    still materialized once per split and shared across thresholds."""
    from ..models.router import RequestRouter
    from .workload import (
        SimReplica,
        lognormal_ticks,
        poisson_arrivals,
        run_router_day,
    )

    cands = [(int(p), int(d)) for p, d in splits]
    if not cands:
        raise ValueError("empty sweep: no candidate splits given")
    for p, d in cands:
        if p < 1 or d < 1:
            raise ValueError(
                f"sweep refused: split ({p}, {d}) leaves a tier empty "
                "— a two-tier fleet needs at least one prefill AND "
                "one decode replica"
            )
    load = float(load)
    if not (0.0 < load < 1.0):
        raise ValueError(
            f"sweep refused: offered load {load:.2f} must sit in "
            "(0, 1) — at or beyond 1 the open-loop queue grows "
            "without bound and no tier split can meet a decode SLO"
        )
    thresholds = list(migration_thresholds)
    lmn = int(long_max_new if long_max_new is not None else max_new)
    # offered rate: load x the fleet's bottleneck-tier capacity under
    # the EXPECTED per-request work (the long mix in expectation).
    # Prefill-tier work per request: its chunk count; decode-tier
    # work: its decode ticks. Tick time approximated at the base
    # tick_s (chunk_s stretches are what the sweep prices).
    ls = float(long_share)
    e_chunks = (
        (1.0 - ls) * -(-int(prompt_len) // int(prompt_chunk))
        + ls * -(-int(long_prompt_len) // int(prompt_chunk))
    )
    e_decode_ticks = (
        (1.0 - ls) * -(-max(int(max_new) - 1, 0) // int(n_inner))
        + ls * -(-max(lmn - 1, 0) // int(n_inner))
    )
    use_fast = _resolve_fast(fast)
    if use_fast:
        from .fastpath import poisson_arrival_batch, run_router_day_fast
    entries: list[dict] = []
    for (n_p, n_d) in cands:
        # a saturated prefill replica's tick stretches by one chunk_s
        # per admitting slot (the very contention being priced), so
        # its capacity is chunks over the STRETCHED tick; decode-tier
        # ticks run chunk-free (adoption admits without prefill)
        prefill_tick = tick_s + slots * chunk_s
        cap_prefill = n_p * slots / (e_chunks * prefill_tick)
        cap_decode = n_d * slots / (e_decode_ticks * tick_s)
        rate = load * min(cap_prefill, cap_decode)
        batch = poisson_arrival_batch(
            rate, n=requests, seed=seed, prompt_len=prompt_len,
            max_new=max_new, long_share=long_share,
            long_prompt_len=long_prompt_len,
            long_max_new=long_max_new,
        ) if use_fast else None
        for thr in thresholds:
            clock = VirtualClock()
            fleet = []
            for i in range(n_p + n_d):
                fleet.append(SimReplica(
                    clock, slots=slots, n_inner=n_inner,
                    prompt_chunk=prompt_chunk,
                    tier="prefill" if i < n_p else "decode",
                    chunk_s=chunk_s,
                    kv_bytes_per_token=kv_bytes_per_token,
                    tick_s=lognormal_ticks(
                        float(tick_s), float(tick_sigma),
                        seed=int(seed) * 1013 + i,
                    ),
                ))
            router = RequestRouter(
                fleet, policy="two_tier", clock=clock,
                migrate_threshold_bytes=thr,
                migrate_gbs=migrate_gbs,
            )
            if batch is not None:
                report = run_router_day_fast(router, batch)
            else:
                report = run_router_day(
                    router,
                    poisson_arrivals(
                        rate, n=requests, seed=seed,
                        prompt_len=prompt_len, max_new=max_new,
                        long_share=long_share,
                        long_prompt_len=long_prompt_len,
                        long_max_new=long_max_new,
                    ),
                )
            p99d = report.p99_decode_itl()
            entries.append({
                "split": (n_p, n_d),
                "threshold_bytes": thr,
                "decode_p99_s": p99d,
                "p50_ttft_s": report.p50_ttft(),
                "p99_ttft_s": report.p99_ttft(),
                "migrated": report.n_migrated,
                "kept_local": report.n_kept_local,
                "migrated_bytes": router.migrated_bytes,
                "completed": report.n - report.dropped,
                "dropped": report.dropped,
                "rate_req_s": rate,
                "admissible": (
                    decode_p99_slo_s is None
                    or p99d <= float(decode_p99_slo_s)
                ),
            })
    ok = [e for e in entries if e["admissible"]]
    if not ok:
        raise ValueError(
            f"no split meets the decode-p99 SLO: every candidate's "
            f"p99 inter-token gap exceeds {decode_p99_slo_s}s at load "
            f"{load:.2f} (swept "
            f"{[(e['split'], e['threshold_bytes']) for e in entries]})"
            " — add decode replicas or shed load; the sweep refuses "
            "rather than recommend a split that cannot hold decode"
        )
    # decode p99 is the objective; among candidates within 5% of the
    # best (the tiers hold decode equally well), the lowest p99 TTFT
    # wins — a tie on the headline must not discard the prefill
    # tier's sizing signal
    best_d = min(e["decode_p99_s"] for e in ok)
    near = [e for e in ok if e["decode_p99_s"] <= best_d * 1.05]
    best = min(near, key=lambda e: e["p99_ttft_s"])
    worst = max(entries, key=lambda e: e["decode_p99_s"])
    return {
        "entries": entries,
        "best": (best["split"], best["threshold_bytes"]),
        "best_entry": best,
        "decode_p99_vs_worst": (
            worst["decode_p99_s"] / best["decode_p99_s"]
            if best["decode_p99_s"] > 0 else float(np.inf)
        ),
        "load": load,
        "long_share": ls,
        "requests": int(requests),
    }


def sweep_spill_capacity(
    *,
    store_groups_candidates: Sequence[int],
    replicas: int = 3,
    slots: int = 4,
    n_inner: int = 8,
    tick_s: float = 0.02,
    tick_sigma: float = 0.0,
    chunk_s: float = 0.004,
    load: float = 0.8,
    requests: int = 2000,
    prompt_len: int = 512,
    max_new: int = 32,
    prefix_share: float = 0.7,
    prefix_len: int = 256,
    n_prefix_groups: int = 16,
    prompt_chunk: int = 64,
    kv_bytes_per_token: float = 4096.0,
    spill_gbs: float = 8.0,
    fetch_gbs: float = 8.0,
    seed: int = 0,
    fast: str = "auto",
) -> dict[str, Any]:
    """Price the host-DRAM spill tier's capacity
    (:class:`~.workload.SimFleetCache` ``store_groups``) by running
    the real router over fleets sharing one fleet cache per candidate,
    one seeded prefix-heavy Poisson stream for ALL candidates (same
    seed: identical arrivals, so the ONLY variable is how many prefix
    groups the DRAM tier can hold).

    The trade being swept: a fleet fetch skips a request's shared
    prefill chunks but charges the planner-priced transfer seconds to
    the admitting tick (``spill_gbs``/``fetch_gbs`` — the PERF byte
    model), while a capacity-0 tier falls back to peer-HBM hits only
    and a too-small tier churns (``evictions`` in the entry says so).
    The headline per candidate is **p99 TTFT** with the prefill
    chip-seconds saved (``chunks_saved * chunk_s``) as the efficiency
    axis.

    Refusals, never clamps (the ``sweep_nwait`` contract):

    * **empty candidate list** — nothing to sweep;
    * **negative capacity** — ``store_groups`` is a page-count floor
      at 0 (0 = peer-only fleet, a legal baseline candidate);
    * **shareless stream** (``prefix_share <= 0`` or
      ``prefix_len < 1``) — without shared prefixes every fetch path
      is dead and the sweep would recommend noise;
    * **offered load >= 1** — open-loop saturation.

    Returns entries per candidate (TTFT percentiles, fleet hits by
    tier, spills/evictions/fallbacks, bytes moved, chip seconds
    saved), ``best`` — the capacity with the lowest p99 TTFT — and
    ``p99_ttft_vs_no_dram`` against the 0-capacity baseline when one
    was swept. ``fast=`` is accepted for knob uniformity; fleet-cache
    days price tick stretches the vectorized engine does not model, so
    ``run_router_day_fast`` falls back to the scalar loop by shape."""
    from ..cache import SpillFetchPlanner
    from ..models.router import RequestRouter
    from .workload import (
        SimFleetCache,
        SimReplica,
        lognormal_ticks,
        poisson_arrivals,
        run_router_day,
    )

    cands = [int(g) for g in store_groups_candidates]
    if not cands:
        raise ValueError(
            "empty sweep: no store_groups candidates given"
        )
    for g in cands:
        if g < 0:
            raise ValueError(
                f"sweep refused: store_groups {g} is negative — the "
                "DRAM tier holds 0 or more groups (0 = peer-only "
                "baseline)"
            )
    if not (0.0 < float(prefix_share) <= 1.0) or int(prefix_len) < 1:
        raise ValueError(
            f"sweep refused: prefix_share {prefix_share} / prefix_len "
            f"{prefix_len} leaves nothing shareable — a spill-capacity "
            "sweep over a shareless stream prices a dead code path"
        )
    load = float(load)
    if not (0.0 < load < 1.0):
        raise ValueError(
            f"sweep refused: offered load {load:.2f} must sit in "
            "(0, 1) — at or beyond 1 the open-loop queue grows "
            "without bound and no cache capacity can hold TTFT"
        )
    if int(replicas) < 2:
        raise ValueError(
            "sweep refused: a fleet cache needs >= 2 replicas — with "
            "one there is no peer tier and DRAM only re-serves the "
            "spiller itself"
        )
    # offered rate: load x fleet tick capacity under expected
    # per-request work WITHOUT sharing (the pessimistic floor — cache
    # hits only relieve it, so every candidate faces feasible load)
    e_chunks = -(-int(prompt_len) // int(prompt_chunk))
    e_ticks = e_chunks + -(-max(int(max_new) - 1, 0) // int(n_inner))
    rate = load * int(replicas) * int(slots) / (
        e_ticks * (float(tick_s) + float(chunk_s))
    )
    use_fast = _resolve_fast(fast)
    if use_fast:
        from .fastpath import poisson_arrival_batch, run_router_day_fast

        batch = poisson_arrival_batch(
            rate, n=requests, seed=seed, prompt_len=prompt_len,
            max_new=max_new, prefix_share=prefix_share,
            prefix_len=prefix_len, n_prefix_groups=n_prefix_groups,
        )
    chunks_per_hit = -(-int(prefix_len) // int(prompt_chunk))
    entries: list[dict] = []
    for g in cands:
        clock = VirtualClock()
        cache = SimFleetCache(
            store_groups=g,
            kv_bytes_per_token=kv_bytes_per_token,
            planner=SpillFetchPlanner(
                spill_gbs=spill_gbs, fetch_gbs=fetch_gbs,
            ),
        )
        fleet = [
            SimReplica(
                clock, slots=slots, n_inner=n_inner,
                prompt_chunk=prompt_chunk, chunk_s=chunk_s,
                kv_bytes_per_token=kv_bytes_per_token,
                tick_s=lognormal_ticks(
                    float(tick_s), float(tick_sigma),
                    seed=int(seed) * 1013 + i,
                ),
                cache=cache,
            )
            for i in range(int(replicas))
        ]
        router = RequestRouter(
            fleet, policy="least_loaded", clock=clock,
        )
        if use_fast:
            report = run_router_day_fast(router, batch)
        else:
            report = run_router_day(
                router,
                poisson_arrivals(
                    rate, n=requests, seed=seed,
                    prompt_len=prompt_len, max_new=max_new,
                    prefix_share=prefix_share, prefix_len=prefix_len,
                    n_prefix_groups=n_prefix_groups,
                ),
            )
        hits = sum(r.n_fleet_hits for r in fleet)
        st = cache.stats()
        entries.append({
            "store_groups": g,
            "p50_ttft_s": report.p50_ttft(),
            "p99_ttft_s": report.p99_ttft(),
            "fleet_hits": hits,
            "fetches": st["fetches"],
            "fallbacks": st["fallbacks"],
            "spills": st["spills"],
            "evictions": st["evictions"],
            "spill_bytes": st["spill_bytes"],
            "fetch_bytes": st["fetch_bytes"],
            "local_shared_admits": sum(
                r.n_shared_admits for r in fleet
            ),
            "prefill_chip_s_saved": (
                hits * chunks_per_hit * float(chunk_s)
            ),
            "completed": report.n - report.dropped,
            "dropped": report.dropped,
            "rate_req_s": rate,
        })
    best = min(entries, key=lambda e: e["p99_ttft_s"])
    base = next(
        (e for e in entries if e["store_groups"] == 0), None
    )
    return {
        "entries": entries,
        "best": best["store_groups"],
        "best_entry": best,
        "p99_ttft_vs_no_dram": (
            base["p99_ttft_s"] / best["p99_ttft_s"]
            if base is not None and best["p99_ttft_s"] > 0 else None
        ),
        "load": load,
        "requests": int(requests),
    }


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
