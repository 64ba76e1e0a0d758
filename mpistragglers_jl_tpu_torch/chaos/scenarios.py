"""The chaos scenario catalog: named, seeded, replayable episodes.

A copy of ``mpistragglers_jl_tpu/chaos/scenarios.py``, not an import of
it (the port never imports the JAX package). Stdlib and numpy, no torch,
and no OS clock: the same seeded inputs give the same records in either
package.

Every scenario here is a pure function of its seed: the arrival
streams, fault timings, retry coins, and tick jitter are all drawn
from seeded generators, so an episode that fails replays
bit-identically — the :class:`~.report.ChaosReport` digest is the
witness two runs must agree on. Scenarios compose EXISTING machinery
rather than reimplementing it: arrival streams and retry clients from
:mod:`..sim.workload`, fault timing in the style of
:mod:`..utils.faults` (clock-scheduled kill/revive and
partition/heal), the real :class:`~..models.router.RequestRouter`
over :class:`~..sim.workload.SimReplica` fleets on a
:class:`~..sim.clock.VirtualClock`, and the real
:class:`~..models.paging.PagePool` for the COW-churn episode.

Catalog (``SCENARIOS``; each factory takes ``seed`` and a size knob):

=======================  =============================================
``overload_shed``        offered load 1.3 with a latency-class and a
                         batch-class tenant: the router must shed by
                         name — batch at the soft ceiling, interactive
                         only at the hard one — and queues stay under
                         the pinned ceiling
``retry_storm``          timeout-and-resubmit clients over a mid-day
                         correlated capacity dip: the storm amplifies
                         offered load past 1, then subsides; p99 must
                         return to a pinned factor of the pre-storm
                         baseline (the non-metastable claim)
``network_partition``    a 30%-of-day router<->replica partition over
                         3 of 8 replicas: the partitioned replicas
                         keep ticking, rejoin at heal, and no request
                         is double-retired or dropped
``correlated_host_kill`` a 2-host blast (4 of 8 replicas) mid-day:
                         zero drops through the re-route path, bounded
                         queues throughout
``prefix_churn``         adversarial prefix admission/COW/retire churn
                         against the real PagePool: allocator
                         invariants hold at every step and the pool
                         drains to baseline
``storm_with_host_kill`` the acceptance combo — retry storm + one
                         correlated host-group kill + a 30%-span
                         partition in ONE day, all invariants at once
``partition_mid_fetch``  a prefix-heavy fleet sharing a SimFleetCache
                         loses 3 of 8 replicas to a partition mid-day:
                         peer fetches from the partitioned owners must
                         FALL BACK to re-prefill (never deadlock, never
                         drop), the DRAM tier keeps serving, and the
                         day replays bit-identically
=======================  =============================================

Run scenarios through :class:`~.injector.ChaosInjector`, which
installs the invariant probes inside the run and assembles the
:class:`~.report.ChaosReport`.
"""

from __future__ import annotations

import hashlib
import random
from typing import Callable

from .report import InvariantViolation, windowed_p99_ttft

__all__ = ["ChaosScenario", "ReplicaKill", "SCENARIOS", "get_scenario"]

# the shared fleet shape (one place, so capacity arithmetic and
# scenario tuning can't drift apart)
_N_REP = 8
_SLOTS = 4
_NI = 8
_TICK = 0.02
_SIGMA = 0.1
_PLEN, _CHUNK, _MNEW = 96, 64, 32


class ChaosScenario:
    """One named, seeded episode: ``build(clock, registry=, flight=)``
    assembles the day (router, arrivals, events, retry client, and a
    ``post`` checker closing over the scenario's expectations);
    ``queue_ceiling``/``stall_s``/``probe_every_s`` parameterize the
    in-run invariant probes the injector installs. ``kind`` is
    ``"day"`` (a router day on virtual time) or ``"pool"`` (the
    PagePool churn episode, no router)."""

    def __init__(self, name: str, seed: int, build: Callable, *,
                 kind: str = "day", queue_ceiling: int | None = None,
                 stall_s: float = 30.0, probe_every_s: float = 0.25):
        if kind not in ("day", "pool"):
            raise ValueError(f"kind must be day/pool, got {kind!r}")
        self.name = str(name)
        self.seed = int(seed)
        self.build = build
        self.kind = kind
        self.queue_ceiling = (
            None if queue_ceiling is None else int(queue_ceiling)
        )
        self.stall_s = float(stall_s)
        self.probe_every_s = float(probe_every_s)

    def __repr__(self) -> str:
        return (
            f"ChaosScenario({self.name!r}, seed={self.seed}, "
            f"kind={self.kind!r})"
        )


class ReplicaKill:
    """Control-plane event: at ``t``, the named replicas DIE (state
    wiped — the router's health probe ejects them and re-routes their
    in-flight work, the zero-drop contract), and at ``until`` they
    revive empty. The correlated-host-kill building block: pass a
    whole host group's replica indices, the
    :class:`~..utils.faults.correlated_kill` shape lifted to the
    serving fleet."""

    __slots__ = ("t", "replicas", "until")

    def __init__(self, t: float, replicas, until: float):
        self.t = float(t)
        self.replicas = [int(i) for i in replicas]
        self.until = float(until)
        if not self.replicas:
            raise ValueError("ReplicaKill with no replicas")
        if self.until <= self.t:
            raise ValueError(
                f"revive must follow the kill: t={t}, until={until}"
            )

    def fire(self, router, controller) -> None:
        clock = router.clock
        if clock is None:
            raise ValueError(
                "ReplicaKill event needs a VirtualClock router"
            )
        for i in self.replicas:
            router.replicas[i].kill()
        # surface the deaths NOW: the driver may submit (an arrival,
        # a retry resubmission) before the next scheduled step, and a
        # stale routable set would route onto a corpse. A step at the
        # event instant is idempotent — due ticks already fired at
        # this virtual time, so this is exactly one health probe +
        # evacuation.
        router.step()

        def _revive():
            for i in self.replicas:
                router.replicas[i].revive()

        clock.call_at(self.until, _revive)

    def __repr__(self) -> str:
        return (
            f"ReplicaKill(t={self.t:.3f}, replicas={self.replicas}, "
            f"until={self.until:.3f})"
        )


def _capacity_rps(n_replicas: int) -> float:
    """Fleet request capacity from THE slot-holding-ticks formula
    (sim/workload.service_ticks_per_request — the same arithmetic the
    router sweeps and the fleet controller price with)."""
    from ..sim.workload import service_ticks_per_request

    ticks = service_ticks_per_request(
        prompt_len=_PLEN, prompt_chunk=_CHUNK, max_new=_MNEW,
        n_inner=_NI,
    )
    return n_replicas * _SLOTS / (ticks * _TICK)


def _fleet(clock, seed: int, *, qos=None, max_queue: int | None = None):
    from ..sim.workload import SimReplica, lognormal_ticks

    return [
        SimReplica(
            clock, slots=_SLOTS, n_inner=_NI, prompt_chunk=_CHUNK,
            tick_s=lognormal_ticks(_TICK, _SIGMA, seed=seed * 101 + i),
            qos=qos, max_queue=max_queue,
        )
        for i in range(_N_REP)
    ]


def _two_class_registry():
    """The shed-order fixture: one latency-class tenant ("chat") and
    one batch-class tenant ("bulk"), no token-rate budgets — overload
    shedding, not the budget door, is the actor under test."""
    from ..qos import TenantContract, TenantRegistry

    return TenantRegistry([
        TenantContract("chat", cls="latency", weight=4.0,
                       ttft_slo=0.5),
        TenantContract("bulk", cls="batch", weight=1.0),
    ])


def _check_shed_order(report) -> None:
    """Batch-class work sheds BEFORE interactive work (the QoS
    sheddability contract under overload): if any interactive request
    was shed at all, batch sheds must exist and the first of them must
    not come after the first interactive one."""
    first_batch = first_inter = None
    n_batch = 0
    for r in report.requests:
        if r.outcome != "shed":
            continue
        if not r.shed_reason:
            raise InvariantViolation(
                f"shed request {r.id} carries no reason (bare drop)"
            )
        if r.tenant == "bulk":
            n_batch += 1
            if first_batch is None:
                first_batch = r.t_submit
        elif first_inter is None:
            first_inter = r.t_submit
    if first_inter is not None:
        if n_batch == 0 or first_batch > first_inter:
            raise InvariantViolation(
                "interactive work shed before any batch work: the "
                "shed order must follow qos.SHED_ORDER (batch first)"
            )


def _check_partitions_reconciled(router) -> None:
    if router.n_partitions != router.n_partitions_healed:
        raise InvariantViolation(
            f"{router.n_partitions} partitions began but only "
            f"{router.n_partitions_healed} healed: partitioned "
            "replicas must rejoin before the episode ends"
        )
    if router.n_completed != router.n_submitted:
        raise InvariantViolation(
            f"completion ledger drifted: {router.n_completed} "
            f"completed of {router.n_submitted} submitted — a rejoin "
            "double-retired or lost a request"
        )


def overload_shed(seed: int = 0, n: int = 4000) -> ChaosScenario:
    """Offered load 1.3 over a two-class tenant mix: the router must
    shed by name rather than queue unboundedly — batch at the soft
    ceiling, interactive only at the hard one."""
    soft, hard = 12 * _N_REP // 2, 12 * _N_REP  # 48 / 96

    def build(clock, *, registry=None, flight=None):
        from ..models.router import RequestRouter
        from ..sim.workload import poisson_arrivals

        reg = _two_class_registry()
        reps = _fleet(clock, seed, qos=reg, max_queue=2 * hard)
        router = RequestRouter(
            reps, policy="least_loaded", clock=clock, qos=reg,
            shed_depth=soft, shed_depth_hard=hard,
            registry=registry, flight=flight,
        )
        arrivals = poisson_arrivals(
            1.3 * _capacity_rps(_N_REP), n=n, seed=seed,
            prompt_len=_PLEN, max_new=_MNEW,
            tenants={"chat": 0.5, "bulk": 0.5},
        )

        def post(report, router):
            if report.shed_reasons.get("overload", 0) < 1:
                raise InvariantViolation(
                    "load 1.3 shed nothing at the soft ceiling: the "
                    "overload door never fired"
                )
            _check_shed_order(report)
            served = report.n - report.outcomes.get("shed", 0)
            return {
                "shed_pct": round(
                    100.0 * report.n_shed / report.n, 2
                ),
                "served": served,
            }

        return {"router": router, "arrivals": arrivals, "post": post}

    return ChaosScenario(
        "overload_shed", seed, build, queue_ceiling=hard,
    )


def retry_storm(seed: int = 0, n: int = 5000,
                recovery_factor: float = 3.0) -> ChaosScenario:
    """Timeout-and-resubmit clients over a mid-day correlated
    capacity dip (4 of 8 replicas — two host groups — die, then
    revive): the storm drives offered load past 1; once it subsides,
    windowed p99 TTFT must return to within ``recovery_factor`` of
    the pre-storm baseline — the non-metastable claim."""
    soft, hard = 64, 128

    def build(clock, *, registry=None, flight=None):
        from ..models.router import RequestRouter
        from ..sim.workload import RetryPolicy, poisson_arrivals

        reps = _fleet(clock, seed, max_queue=2 * hard)
        router = RequestRouter(
            reps, policy="least_loaded", clock=clock,
            shed_depth=soft, shed_depth_hard=hard,
            registry=registry, flight=flight,
        )
        rate = 0.75 * _capacity_rps(_N_REP)
        span = n / rate
        t_kill, t_revive = 0.30 * span, 0.55 * span
        arrivals = poisson_arrivals(
            rate, n=n, seed=seed, prompt_len=_PLEN, max_new=_MNEW,
        )
        # the client is more impatient than the shed-bounded queue
        # wait (the soft ceiling caps TTFT near 0.5 s on the dip
        # fleet): timeouts fire, resubmissions amplify — and the shed
        # door is what keeps the amplified load from going metastable
        retry = RetryPolicy(
            timeout_s=0.35, max_retries=2, backoff=1.5, jitter_s=0.2,
            seed=seed + 5,
        )
        # two host groups die together (replicas 2-5): survivors carry
        # 2x load for the dip — the TTFT blowout that ignites the storm
        events = [ReplicaKill(t_kill, (2, 3, 4, 5), t_revive)]

        def post(report, router):
            if report.n_resubmits < 1:
                raise InvariantViolation(
                    "the storm never happened: zero client "
                    "resubmissions over the capacity dip"
                )
            pre = windowed_p99_ttft(report, 0.0, t_kill)
            post_p99 = windowed_p99_ttft(
                report, 0.85 * span, span + 1.0
            )
            rec = post_p99 / pre if pre > 0 else 0.0
            if rec > recovery_factor:
                raise InvariantViolation(
                    f"metastable: post-storm p99 {post_p99 * 1e3:.1f}"
                    f"ms is {rec:.2f}x the pre-storm "
                    f"{pre * 1e3:.1f}ms (pinned factor "
                    f"{recovery_factor})"
                )
            return {
                "p99_recovery_x": round(rec, 3),
                "pre_p99_ms": round(pre * 1e3, 2),
                "post_p99_ms": round(post_p99 * 1e3, 2),
                "resubmits": report.n_resubmits,
            }

        return {
            "router": router, "arrivals": arrivals,
            "events": events, "retry": retry, "post": post,
        }

    return ChaosScenario(
        "retry_storm", seed, build, queue_ceiling=hard,
    )


def network_partition(seed: int = 0, n: int = 3000) -> ChaosScenario:
    """A 30%-of-day router<->replica partition over 3 of 8 replicas:
    distinct from death — the replicas keep ticking behind the
    partition, rejoin at heal, and no request is double-retired or
    dropped."""

    def build(clock, *, registry=None, flight=None):
        from ..models.router import RequestRouter
        from ..sim.workload import ReplicaPartition, poisson_arrivals

        reps = _fleet(clock, seed)
        router = RequestRouter(
            reps, policy="least_loaded", clock=clock,
            registry=registry, flight=flight,
        )
        rate = 0.5 * _capacity_rps(_N_REP)
        span = n / rate
        arrivals = poisson_arrivals(
            rate, n=n, seed=seed, prompt_len=_PLEN, max_new=_MNEW,
        )
        events = [
            ReplicaPartition(0.35 * span, (5, 6, 7), 0.65 * span)
        ]

        def post(report, router):
            _check_partitions_reconciled(router)
            if report.dropped:
                raise InvariantViolation(
                    f"{report.dropped} requests dropped across the "
                    "partition: re-route must carry every one"
                )
            return {
                "partitions": router.n_partitions,
                "stale_cancelled": router.n_stale_cancelled,
                "rerouted": report.n_rerouted,
            }

        return {
            "router": router, "arrivals": arrivals,
            "events": events, "post": post,
        }

    return ChaosScenario("network_partition", seed, build)


def correlated_host_kill(seed: int = 0, n: int = 3000) -> ChaosScenario:
    """A 2-host blast — replicas (2, 3) and (4, 5) share failure
    domains and die together mid-day — with zero drops through the
    ejection/re-route path and bounded queues throughout."""
    soft, hard = 64, 128

    def build(clock, *, registry=None, flight=None):
        from ..models.router import RequestRouter
        from ..sim.workload import poisson_arrivals

        reps = _fleet(clock, seed, max_queue=2 * hard)
        router = RequestRouter(
            reps, policy="least_loaded", clock=clock,
            shed_depth=soft, shed_depth_hard=hard,
            registry=registry, flight=flight,
        )
        rate = 0.45 * _capacity_rps(_N_REP)
        span = n / rate
        arrivals = poisson_arrivals(
            rate, n=n, seed=seed, prompt_len=_PLEN, max_new=_MNEW,
        )
        events = [
            ReplicaKill(0.40 * span, (2, 3, 4, 5), 0.70 * span)
        ]

        def post(report, router):
            if report.dropped:
                raise InvariantViolation(
                    f"{report.dropped} requests dropped across the "
                    "host blast: ejection re-route must carry every "
                    "one"
                )
            if report.n_rerouted < 1:
                raise InvariantViolation(
                    "the blast re-routed nothing: the kill never "
                    "landed"
                )
            return {"rerouted": report.n_rerouted}

        return {
            "router": router, "arrivals": arrivals,
            "events": events, "post": post,
        }

    return ChaosScenario(
        "correlated_host_kill", seed, build, queue_ceiling=hard,
    )


def prefix_churn(seed: int = 0, steps: int = 2000) -> ChaosScenario:
    """Adversarial prefix-cache churn against the real
    :class:`~..models.paging.PagePool`: wrapping holders force COW
    reservations on every share, admission chains roll over more
    prefix groups than the pool can hold resident, mid-flight COW
    writes consume reservations, rollbacks strand them, and retire
    order is adversarially random — the allocator's structural
    invariants (``PagePool.check``) must hold at EVERY step and the
    pool must drain to baseline when the churn ends."""
    n_pages, chain = 64, 4
    n_groups = 24  # deliberately more chains than the pool can hold

    def build(clock, *, registry=None, flight=None):
        def run_pool(check) -> dict:
            from ..models.paging import PagePool

            pool = PagePool(n_pages, 8)
            rng = random.Random(0xC4A05 + seed)
            holders: list[dict] = []
            stats_h = hashlib.sha256()
            admits = rollbacks = retires = cows = 0
            for step in range(steps):
                u = rng.random()
                if u < 0.50:
                    g = rng.randrange(n_groups)
                    wraps = rng.random() < 0.5
                    pages: list[int] = []
                    ok = True
                    for j in range(chain):
                        d = b"chaos-%d-%d" % (g, j)
                        pid = pool.lookup(d)
                        if pid is not None:
                            res = pool.share_needs_reserve(pid, wraps)
                            if res and not pool.can_alloc(0, reserve=1):
                                ok = False
                                break
                            pool.share(pid, reserve=res,
                                       wrapper=wraps)
                        else:
                            if not pool.can_alloc(1):
                                ok = False
                                break
                            pid = pool.alloc()
                            pool.register(d, pid, volatile=wraps)
                        pages.append(pid)
                    if ok:
                        holders.append(
                            {"pages": pages, "wraps": wraps}
                        )
                        admits += 1
                    else:
                        # rollback strands this admission's shares
                        # and reservations — the clamp path under test
                        for pid in reversed(pages):
                            pool.decref(pid, wrapper=wraps)
                        rollbacks += 1
                elif u < 0.75 and holders:
                    # COW write: a WRAPPING holder overwrites one of
                    # its shared pages (non-wrapping holders never
                    # write — that is the scheduler discipline the
                    # reservation accounting is built around, and
                    # every share by/of a wrapper attached one)
                    wrappers = [h for h in holders if h["wraps"]]
                    if wrappers:
                        h = rng.choice(wrappers)
                        shared = [
                            k for k, pid in enumerate(h["pages"])
                            if pool.refcount(pid) > 1
                        ]
                        if shared:
                            k = rng.choice(shared)
                            old = h["pages"][k]
                            new = pool.cow_alloc(old)
                            pool.decref(old, wrapper=True)
                            h["pages"][k] = new
                            cows += 1
                elif holders:
                    h = holders.pop(rng.randrange(len(holders)))
                    for pid in h["pages"]:
                        pool.decref(pid, wrapper=h["wraps"])
                    retires += 1
                pool.check()  # the allocator invariant, every step
                stats_h.update(
                    b"%d,%d,%d;" % (pool.free, pool.used,
                                    pool.reserved)
                )
                check(step)
            while holders:
                h = holders.pop()
                for pid in h["pages"]:
                    pool.decref(pid, wrapper=h["wraps"])
            pool.check()
            if pool.used != 0 or pool.reserved != 0:
                raise InvariantViolation(
                    f"pool did not drain to baseline: {pool.used} "
                    f"used, {pool.reserved} reserved after full "
                    "retire"
                )
            return {
                "admits": admits, "rollbacks": rollbacks,
                "retires": retires, "cow_copies": pool.cow_copies,
                "share_hits": pool.share_hits,
                "churn_digest": stats_h.hexdigest()[:16],
            }

        return {"pool_run": run_pool}

    return ChaosScenario("prefix_churn", seed, build, kind="pool")


def storm_with_host_kill(seed: int = 0, n: int = 5000,
                         recovery_factor: float = 4.0) -> ChaosScenario:
    """The acceptance combo: a retry-storm day with ONE correlated
    host-group kill (replicas 2, 3) and a 30%-span partition
    (replicas 6, 7), over the two-class tenant mix — every pinned
    invariant at once: bounded queues, shed only by name with batch
    before interactive, partitioned replicas rejoining with no
    double-retire, zero drops, p99 recovery, and a bit-identical
    digest across replays."""
    soft, hard = 64, 128

    def build(clock, *, registry=None, flight=None):
        from ..models.router import RequestRouter
        from ..sim.workload import (
            ReplicaPartition,
            RetryPolicy,
            poisson_arrivals,
        )

        reg = _two_class_registry()
        reps = _fleet(clock, seed, qos=reg, max_queue=2 * hard)
        router = RequestRouter(
            reps, policy="least_loaded", clock=clock, qos=reg,
            shed_depth=soft, shed_depth_hard=hard,
            registry=registry, flight=flight,
        )
        rate = 0.7 * _capacity_rps(_N_REP)
        span = n / rate
        arrivals = poisson_arrivals(
            rate, n=n, seed=seed, prompt_len=_PLEN, max_new=_MNEW,
            tenants={"chat": 0.5, "bulk": 0.5},
        )
        retry = RetryPolicy(
            timeout_s=0.35, max_retries=2, backoff=1.5, jitter_s=0.2,
            seed=seed + 5,
        )
        events = [
            ReplicaPartition(0.35 * span, (6, 7), 0.65 * span),
            ReplicaKill(0.40 * span, (2, 3), 0.60 * span),
        ]

        def post(report, router):
            _check_partitions_reconciled(router)
            _check_shed_order(report)
            if report.dropped:
                raise InvariantViolation(
                    f"{report.dropped} requests dropped: shed is the "
                    "only sanctioned loss, and it is named"
                )
            if report.n_resubmits < 1:
                raise InvariantViolation(
                    "the storm never happened: zero resubmissions"
                )
            pre = windowed_p99_ttft(report, 0.0, 0.35 * span)
            post_p99 = windowed_p99_ttft(
                report, 0.85 * span, span + 1.0
            )
            rec = post_p99 / pre if pre > 0 else 0.0
            if rec > recovery_factor:
                raise InvariantViolation(
                    f"metastable: post-storm p99 is {rec:.2f}x the "
                    f"pre-storm baseline (pinned {recovery_factor})"
                )
            return {
                "p99_recovery_x": round(rec, 3),
                "resubmits": report.n_resubmits,
                "stale_cancelled": router.n_stale_cancelled,
                "rerouted": report.n_rerouted,
            }

        return {
            "router": router, "arrivals": arrivals,
            "events": events, "retry": retry, "post": post,
        }

    return ChaosScenario(
        "storm_with_host_kill", seed, build, queue_ceiling=hard,
    )


#: name -> factory(seed=..., ...) — the episode suite tier-1 runs
def partition_mid_fetch(seed: int = 0, n: int = 2400) -> ChaosScenario:
    """A prefix-heavy day over a fleet sharing one
    :class:`~..sim.workload.SimFleetCache`, with 3 of 8 replicas
    partitioned for 30% of the span: fetches that would have hit the
    partitioned owners' HBM must FALL BACK to re-prefilling (the
    cache's fail-to-prefill contract — counted, named, never a
    deadlock), the host-DRAM tier keeps serving because it is fleet
    state rather than replica state, and zero requests drop. The
    injector's replay harness holds the digest bit-identical, so the
    fallback path is deterministic, not racy."""

    def build(clock, *, registry=None, flight=None):
        from ..models.router import RequestRouter
        from ..sim.workload import (
            ReplicaPartition,
            SimFleetCache,
            SimReplica,
            lognormal_ticks,
            poisson_arrivals,
        )

        # a deliberately small DRAM tier: most groups live only in
        # some owner's HBM, so the partition actually interposes
        # peer fetches (a huge store would absorb the episode)
        cache = SimFleetCache(store_groups=2, registry=registry)
        reps = [
            SimReplica(
                clock, slots=_SLOTS, n_inner=_NI, prompt_chunk=_CHUNK,
                tick_s=lognormal_ticks(_TICK, _SIGMA,
                                       seed=seed * 101 + i),
                cache=cache,
            )
            for i in range(_N_REP)
        ]
        router = RequestRouter(
            reps, policy="least_loaded", clock=clock,
            registry=registry, flight=flight,
        )
        rate = 0.5 * _capacity_rps(_N_REP)
        span = n / rate
        arrivals = poisson_arrivals(
            rate, n=n, seed=seed, prompt_len=_PLEN, max_new=_MNEW,
            prefix_share=0.7, prefix_len=_CHUNK, n_prefix_groups=12,
        )
        events = [
            ReplicaPartition(0.35 * span, (5, 6, 7), 0.65 * span)
        ]

        def post(report, router):
            _check_partitions_reconciled(router)
            if report.dropped:
                raise InvariantViolation(
                    f"{report.dropped} requests dropped across the "
                    "partition: a failed fetch must re-prefill, "
                    "never lose the request"
                )
            hits = sum(r.n_fleet_hits for r in reps)
            if hits < 1:
                raise InvariantViolation(
                    "the fleet cache served nothing on a prefix-heavy "
                    "day: the episode never exercised the fetch path"
                )
            if cache.n_fallbacks < 1:
                raise InvariantViolation(
                    "no fetch fell back across a 30%-span partition "
                    "of 3 owners: the partition never interposed — "
                    "the scenario is not testing what it claims"
                )
            if cache.stats()["unreachable"]:
                raise InvariantViolation(
                    "replicas still marked unreachable after heal: "
                    "the router's heal hook never reached the cache"
                )
            cache.check()
            return {
                "partitions": router.n_partitions,
                "fleet_hits": hits,
                "fetch_fallbacks": cache.n_fallbacks,
                "spills": cache.n_spills,
                "rerouted": report.n_rerouted,
            }

        return {
            "router": router, "arrivals": arrivals,
            "events": events, "post": post,
        }

    return ChaosScenario("partition_mid_fetch", seed, build)


SCENARIOS: dict[str, Callable[..., ChaosScenario]] = {
    "overload_shed": overload_shed,
    "retry_storm": retry_storm,
    "network_partition": network_partition,
    "correlated_host_kill": correlated_host_kill,
    "prefix_churn": prefix_churn,
    "storm_with_host_kill": storm_with_host_kill,
    "partition_mid_fetch": partition_mid_fetch,
}


def get_scenario(name: str, seed: int = 0, **kw) -> ChaosScenario:
    """Catalog lookup, refused by name on unknown scenarios."""
    factory = SCENARIOS.get(name)
    if factory is None:
        raise ValueError(
            f"unknown chaos scenario {name!r}; catalog: "
            f"{sorted(SCENARIOS)}"
        )
    return factory(seed=seed, **kw)
