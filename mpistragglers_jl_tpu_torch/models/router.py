"""Request routing over replicated serving schedulers: the traffic tier.

A copy of ``mpistragglers_jl_tpu/models/router.py``, not an import of it
(the port never imports the JAX package). Host code, numpy and no torch:
the replicas it routes over (the port's ``ServingScheduler``,
``PrefillWorker``, ``DecodeReplica`` or the simulator's ``SimReplica``)
do the device work.

One :class:`~.serving.ServingScheduler` is a box; production is an
open-loop arrival stream hitting a FLEET of them (ROADMAP item 1). This
module is the admission/router layer in between: a
:class:`RequestRouter` owns N scheduler replicas, picks one per
arriving request under a pluggable policy, watches every routed
request to its first token and retirement, hedges requests whose TTFT
deadline blows (first-token-wins, loser cancelled — the serving-side
instance of the paper's return-at-the-fastest-k primitive, priced per
REQUEST instead of per epoch), and routes around a replica whose
health flips — then resumes when it recovers. No admitted request is
ever dropped: a dead replica's in-flight requests are re-routed onto
the survivors (at-least-once — a re-routed stream restarts from its
prompt; ``RoutedRequest.rerouted`` counts it).

Policies (``policy=``):

==================  ====================================================
``round_robin``     cycle over routable replicas — the baseline every
                    other policy is priced against
``least_loaded``    fewest ``pending + active`` requests (the live
                    queue-depth + active-slot gauges the ``_ServingObs``
                    exporters publish), ties to the lowest index
``prefix_affinity`` route by the paged cache's
                    :func:`~.paging.prefix_page_digests` chain: the
                    replica already holding the longest resident prefix
                    of this prompt wins (shared system prompts land
                    where their pages live, compounding the COW
                    capacity win) — LOAD-BOUNDED: affinity yields to
                    ``least_loaded`` once the affine replica is a full
                    slot batch deeper than the least loaded, so a hot
                    system prompt cannot melt one replica
``hedge_p99``       ``least_loaded`` placement plus TTFT-deadline
                    hedging: a request whose first token misses
                    ``ttft_slo`` is re-dispatched onto a second
                    replica via the :class:`~..utils.hedge.RequestHedge`
                    machinery; first token wins, the loser is
                    ``cancel()``-ed
``two_tier``        disaggregated placement (models/disagg.py): fresh
                    requests go ``least_loaded`` to the PREFILL tier
                    (replicas whose ``tier`` attribute is
                    ``"prefill"``); a stream's first token triggers a
                    KV-page migration to the DECODE tier — the
                    residency-affine, load-bounded decode replica
                    adopts the page set — unless its payload exceeds
                    ``migrate_threshold_bytes`` (it then decodes where
                    it prefilled). ``migrate_gbs`` prices the transfer
                    on the router clock (virtual seconds in sim; None
                    lands migrations in the same step, the live path
                    where the adoption itself takes the wall time)
==================  ====================================================

**Replica protocol.** Anything scheduler-shaped routes: ``submit(prompt,
max_new, key=None) -> request`` (the request exposing ``tokens`` /
``finished`` / ``admitted_tick``), ``step()``, ``cancel(request)``, and
the ``pending`` / ``active`` load gauges. :class:`~.serving.
ServingScheduler` satisfies it natively; :class:`~..sim.workload.
SimReplica` satisfies it on virtual time, which is how router policies
are priced offline (``sim/workload.py`` drives this very class over a
simulated diurnal day; ``sim/tune.py::sweep_router_policy`` recommends
a policy per (load, prefix-share) point). Optional members the router
uses when present: ``pool``/``P``/``max_pages`` (paged prefix
affinity), ``prefix_hits(prompt)`` (a replica-supplied affinity score,
the sim shortcut), ``alive`` (the default health probe),
``next_tick_at`` (virtual-time driver scheduling), ``last_tick_at``
(the ``/healthz`` freshness detail).

**Clocks.** ``clock=None`` reads the OS clock (live fleets);
``clock=VirtualClock()`` prices the same router — same code path, same
policies — in virtual time, bit-reproducibly. All TTFT/deadline math
uses whichever clock was given; nothing here sleeps.

**Multi-tenant QoS** (``qos=`` a :class:`~..qos.TenantRegistry`,
docs/API.md "Multi-tenant QoS"): ``submit`` then requires ``tenant=``
and becomes the budget door — the tenant's token bucket is charged
``prompt + max_new`` tokens, an over-budget SHEDDABLE (batch-class)
tenant gets the request back immediately with ``outcome == "shed"``
(named, counted, never routed), an over-budget interactive tenant is
paced by the replicas' deficit admission instead; and ``hedge_p99``
re-dispatches draw from the tenant's own entitlement (outstanding
hedge legs capped at the contract's ``hedges``, dues beyond it
refused and counted) so one tenant's deadline panic cannot consume
another's slack.

**Chaos hardening** (docs/API.md "Chaos plane"):
:meth:`~RequestRouter.partition` / :meth:`~RequestRouter.heal` model
a router<->replica NETWORK PARTITION as distinct from death — the
replica keeps ticking (its in-flight work progresses and burns
capacity), its results are unreachable, its requests re-route with
the stale legs abandoned uncancelled, and the heal withdraws them so
a rejoin can never double-retire a request. ``shed_depth=`` /
``shed_depth_hard=`` are the overload ceilings: past the soft
ceiling sheddable work (batch class; all classless traffic) is shed
BY NAME with ``shed_reason == "overload"``, past the hard ceiling
(default 2x soft) every class sheds (``"overload_hard"``) — shed
beats an unbounded queue, and tests/test_torch_imports.py statically enforces
that no drop is ever bare. Correlated (same-instant, multi-replica)
kills evacuate only after the full health scan — see
:meth:`_probe_health`.

**Observability** is strictly opt-in (the package-wide opt-in contract):
``registry=`` exports ``router_requests_total{policy,replica,outcome}``,
``router_hedge_fired_total``, ``router_replica_ejections_total``, the
``router_queue_wait_seconds`` / ``router_ttft_seconds`` histograms, and
a per-replica ``router_replica_depth`` gauge; ``flight=`` stamps
instant events on hedge fires and replica ejections/restorations into
the postmortem ring; ``exporter=`` registers the aggregate ``/healthz``
check (per-replica status in the detail, 503 only when NO replica is
admittable — :meth:`~..obs.export.ObsServer.register_router`). Dark,
the hot path pays only ``is None`` checks.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import numpy as np

from ..qos import TenantRegistry
from ..utils.hedge import RequestHedge
from .paging import prefix_page_digests

__all__ = ["RequestRouter", "RoutedRequest", "ROUTER_POLICIES"]

ROUTER_POLICIES = (
    "round_robin", "least_loaded", "prefix_affinity", "hedge_p99",
    "two_tier",
)

_NO_SCHEDULE = object()  # replica carries no next_tick_at attribute


class RoutedRequest:
    """The caller's handle on one routed request: ``tokens`` /
    ``finished`` mirror :class:`~.serving.Request`, plus the routing
    story — which replica serves it (``replica``), whether a hedge
    fired (``hedged``) and which leg won (``outcome``), how often it
    was re-routed off a dead replica (``rerouted``), and the
    router-clock latency stamps (``t_submit`` / ``t_admitted`` /
    ``t_first_token`` / ``t_done``; ``ttft`` and ``latency`` derived).

    ``outcome`` at completion: ``"ok"`` (primary leg, no drama),
    ``"hedge_won"`` (the hedge leg's first token beat the primary),
    ``"hedged"`` (a hedge fired but the primary still won),
    ``"rerouted"`` (the request survived at least one replica death),
    or ``"shed"`` (refused at the door by name — the request never
    reached a replica; ``replica`` stays None, and ``shed_reason``
    carries the name: ``"budget"`` for an over-budget sheddable
    tenant, ``"overload"``/``"overload_hard"`` for the queue-depth
    ceilings. The chaos plane's shed-by-name contract, pinned
    statically by tests/test_torch_imports.py, is that no request is
    ever shed without one).

    ``tenant`` names the contract the request is billed to (the QoS
    plane); None on routers without ``qos=``.
    """

    __slots__ = (
        "id", "prompt", "max_new", "key", "tenant", "t_submit",
        "t_admitted", "t_first_token", "t_done", "replica",
        "hedge_replica", "hedged", "rerouted", "migrated", "finished",
        "outcome", "shed_reason", "trace", "_legs", "_hedge_charged",
    )

    _next_id = 0

    def __init__(self, prompt, max_new: int, key, t_submit: float,
                 tenant: str | None = None):
        if max_new < 1:
            # a 0-token request can never produce the first token the
            # router resolves on — it would sit in the awaiting books
            # forever (serving.Request enforces the same floor)
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        self.id = RoutedRequest._next_id
        RoutedRequest._next_id += 1
        self.prompt = prompt
        self.max_new = int(max_new)
        self.key = key
        self.tenant = tenant
        self.t_submit = float(t_submit)
        self._hedge_charged = False  # holds one hedge-entitlement unit
        self.t_admitted: float | None = None
        self.t_first_token: float | None = None
        self.t_done: float | None = None
        self.replica: int | None = None      # current primary replica
        self.hedge_replica: int | None = None
        self.hedged = False
        self.rerouted = 0
        self.migrated = False  # the stream moved tiers (two_tier)
        self.finished = False
        self.outcome: str | None = None
        self.shed_reason: str | None = None  # set iff outcome "shed"
        self.trace: int | None = None  # TraceBook id (None = dark)
        # (replica_idx, scheduler_request) in dispatch order; the
        # winner leg is promoted to index 0 when first tokens resolve
        self._legs: list[tuple[int, Any]] = []

    @property
    def tokens(self):
        """The winning leg's token stream (the primary's until a hedge
        resolves). Empty before the first token."""
        return self._legs[0][1].tokens if self._legs else []

    @property
    def ttft(self) -> float | None:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def latency(self) -> float | None:
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit

    def __repr__(self) -> str:
        state = self.outcome if self.finished else "in-flight"
        return (
            f"RoutedRequest(id={self.id}, replica={self.replica}, "
            f"{state})"
        )


class _RouterObs:
    """Instrument bundle resolved once at construction (the
    ``_ServingObs`` discipline): the routing path only increments.
    Built when a registry or flight recorder is attached; a dark
    router's submit/step do no observability work beyond ``is None``
    checks."""

    def __init__(self, router: "RequestRouter", registry, flight):
        self.flight = flight
        # tenant-labeled series only exist on a qos= router — a
        # tenant-less router's series keep their pre-QoS label sets
        self._tenantful = router._qos is not None
        self._r = registry is not None
        if not self._r:
            self.registry = None
            return
        self.registry = registry
        self.policy = router.policy
        # outcome-labeled completions, series created lazily per
        # (replica, outcome[, tenant]) and cached — label churn is
        # tiny (N x 4 x tenants)
        self._done: dict[tuple, Any] = {}
        # shed-by-name counters exist on EVERY instrumented router:
        # the overload ceilings shed tenantless traffic too, and the
        # chaos invariant (no unnamed drops) reads the reason label
        self._shed_by_reason: dict[str, Any] = {}
        if self._tenantful:
            self._q_shed: dict[tuple[str, str], Any] = {}
            self._q_ttft: dict[str, Any] = {}
            self._q_hedge_ref: dict[str, Any] = {}
        self.m_partition = registry.counter(
            "router_partitions_total",
            help="router<->replica network partitions begun",
        )
        self.m_hedge = registry.counter(
            "router_hedge_fired_total",
            help="TTFT-deadline hedges dispatched (hedge_p99 policy)",
        )
        self.m_eject = registry.counter(
            "router_replica_ejections_total",
            help="replicas ejected from routing on a health flip",
        )
        self.m_queue_wait = registry.histogram(
            "router_queue_wait_seconds",
            help="submit -> scheduler admission (first prefill chunk)",
        )
        self.m_ttft = registry.histogram(
            "router_ttft_seconds",
            help="submit -> first token, across hedges and re-routes",
        )
        # busy chip-time (admission -> done): the cost-ledger plane's
        # source series — per tenant on qos routers, router-wide
        # always (the windowed SLO layer attributes these per window)
        self.m_busy = registry.counter(
            "router_busy_seconds_total",
            help="admission -> completion chip-time, all requests",
        )
        if self._tenantful:
            self._q_busy: dict[str, Any] = {}
        self.m_depth = [
            registry.gauge(
                "router_replica_depth",
                help="queued + active requests on the replica",
                replica=str(i),
            )
            for i in range(len(router.replicas))
        ]
        self.m_routable = registry.gauge(
            "router_routable_replicas",
            help="replicas currently admitting traffic",
        )
        # disaggregation series (two_tier only): the handoff plane's
        # whole telemetry budget lives here — ONE counting point for
        # live tier wrappers and sim replicas alike, since every
        # migration flows through the router's book
        self._two_tier = router.policy == "two_tier"
        if self._two_tier:
            self._mig: dict[str, Any] = {}  # reason -> counter
            self.m_mig_pages = registry.counter(
                "disagg_migrated_pages_total",
                help="KV pages moved prefill -> decode",
            )
            self.m_mig_bytes = registry.counter(
                "disagg_migrated_bytes_total",
                help="KV payload bytes moved prefill -> decode",
            )
            self.m_mig_s = registry.histogram(
                "disagg_migration_seconds",
                help="capture -> adoption, router clock",
            )
            self.m_tier_depth = {
                t: registry.gauge(
                    "disagg_tier_depth",
                    help="queued + active requests on the tier",
                    tier=t,
                )
                for t in ("prefill", "decode")
            }

    def completed(self, rr: RoutedRequest) -> None:
        if not self._r:
            return
        # the tenant label rides router_requests_total on qos routers
        # only — same lazy per-labelset cache, one more key element
        labels = {"replica": str(int(rr.replica)),
                  "outcome": str(rr.outcome)}
        if self._tenantful:
            labels["tenant"] = (
                rr.tenant if rr.tenant is not None else "-"
            )
        key = tuple(labels.values())
        c = self._done.get(key)
        if c is None:
            c = self._done[key] = self.registry.counter(
                "router_requests_total",
                help="routed requests completed",
                policy=self.policy, **labels,
            )
        c.inc()
        if self._tenantful and rr.ttft is not None \
                and rr.tenant is not None:
            h = self._q_ttft.get(rr.tenant)
            if h is None:
                h = self._q_ttft[rr.tenant] = (
                    self.registry.histogram(
                        "qos_ttft_seconds",
                        help="submit -> first token, per tenant",
                        tenant=rr.tenant,
                    )
                )
            h.observe(rr.ttft)
        if rr.ttft is not None:
            self.m_ttft.observe(rr.ttft)
        if rr.t_done is not None and rr.t_admitted is not None:
            busy = rr.t_done - rr.t_admitted
            if busy > 0:
                self.m_busy.inc(busy)
                if self._tenantful and rr.tenant is not None:
                    b = self._q_busy.get(rr.tenant)
                    if b is None:
                        b = self._q_busy[rr.tenant] = (
                            self.registry.counter(
                                "qos_busy_seconds_total",
                                help="admission -> completion "
                                "chip-time, per tenant",
                                tenant=rr.tenant,
                            )
                        )
                    b.inc(busy)

    def shed(self, rr: RoutedRequest, reason: str, t: float) -> None:
        """One request refused at the door by name (over-budget
        sheddable tenant, or an overload queue-depth ceiling): the
        per-reason counter (every router), the per-(tenant, reason)
        counter (qos routers), plus the flight-recorder instant
        event."""
        if self._r:
            c = self._shed_by_reason.get(reason)
            if c is None:
                c = self._shed_by_reason[reason] = (
                    self.registry.counter(
                        "router_shed_total",
                        help="requests shed at the router door, by "
                        "reason — the shed-by-name contract's tally",
                        reason=str(reason),
                    )
                )
            c.inc()
            if self._tenantful:
                key = (str(rr.tenant), str(reason))
                qc = self._q_shed.get(key)
                if qc is None:
                    qc = self._q_shed[key] = self.registry.counter(
                        "qos_shed_total",
                        help="requests shed at the router door, by "
                        "tenant and reason",
                        tenant=key[0], reason=key[1],
                    )
                qc.inc()
        if self.flight is not None:
            if rr.tenant is not None:
                self.flight.event(
                    "qos shed", src="router", t=t, request=rr.id,
                    tenant=str(rr.tenant), reason=str(reason),
                )
            else:
                # tenant-less shed: no tenant label at all — a
                # literal "None" masquerading as a tenant name would
                # poison the postmortem record
                self.flight.event(
                    "request shed", src="router", t=t,
                    request=rr.id, reason=str(reason),
                )

    def hedge_refused(self, rr: RoutedRequest, t: float) -> None:
        if self._r:
            c = self._q_hedge_ref.get(rr.tenant)
            if c is None:
                c = self._q_hedge_ref[rr.tenant] = (
                    self.registry.counter(
                        "qos_hedge_refused_total",
                        help="due hedges refused: the tenant was at "
                        "its outstanding-hedge entitlement",
                        tenant=str(rr.tenant),
                    )
                )
            c.inc()

    def admitted(self, wait_s: float) -> None:
        if self._r:
            self.m_queue_wait.observe(wait_s)

    def hedge_fired(self, rr: RoutedRequest, replica: int,
                    t: float) -> None:
        if self._r:
            self.m_hedge.inc()
        if self.flight is not None:
            self.flight.event(
                "hedge fired", src="router", t=t, request=rr.id,
                primary=rr.replica, hedge=replica,
            )

    def ejected(self, i: int, t: float, rerouted: int) -> None:
        if self._r:
            self.m_eject.inc()
        if self.flight is not None:
            self.flight.event(
                "replica ejected", src="router", t=t, replica=i,
                rerouted=rerouted,
            )

    def restored(self, i: int, t: float) -> None:
        if self.flight is not None:
            self.flight.event(
                "replica restored", src="router", t=t, replica=i
            )

    def partitioned(self, i: int, t: float, rerouted: int) -> None:
        """A router<->replica partition began: the replica keeps
        ticking, its results are unreachable, its in-flight requests
        re-route (legs abandoned UNCANCELLED — no cancel can cross a
        partition)."""
        if self._r:
            self.m_partition.inc()
        if self.flight is not None:
            self.flight.event(
                "replica partitioned", src="router", t=t, replica=i,
                rerouted=rerouted,
            )

    def healed(self, i: int, t: float, stale_cancelled: int) -> None:
        if self.flight is not None:
            self.flight.event(
                "partition healed", src="router", t=t, replica=i,
                stale_cancelled=stale_cancelled,
            )

    def migrated(self, rr: RoutedRequest, ticket, j: int, t: float,
                 dur: float) -> None:
        """One landed handoff: counters by reason, the page/byte
        tallies the PERF byte model prices, the capture->adoption
        latency, and the flight-recorder instant event."""
        if self._r:
            reason = str(getattr(ticket, "reason", "prefill_done"))
            c = self._mig.get(reason)
            if c is None:
                c = self._mig[reason] = self.registry.counter(
                    "disagg_migrations_total",
                    help="KV-page migrations landed on the decode tier",
                    reason=reason,
                )
            c.inc()
            self.m_mig_pages.inc(int(getattr(ticket, "pages", 0)))
            self.m_mig_bytes.inc(int(getattr(ticket, "nbytes", 0)))
            self.m_mig_s.observe(dur)
        if self.flight is not None:
            self.flight.event(
                "kv migrated", src="router", t=t, request=rr.id,
                dest=j, pages=int(getattr(ticket, "pages", 0)),
                nbytes=int(getattr(ticket, "nbytes", 0)),
            )

    def depths(self, router: "RequestRouter") -> None:
        if not self._r:
            return
        for i, r in enumerate(router.replicas):
            self.m_depth[i].set(r.pending + r.active)
        self.m_routable.set(len(router.routable_replicas))
        if self._two_tier:
            for t, members in (
                ("prefill", router._prefill_set),
                ("decode", router._decode_set),
            ):
                self.m_tier_depth[t].set(sum(
                    router.replicas[i].pending
                    + router.replicas[i].active
                    for i in members
                ))


class RequestRouter:
    """Admission router over N scheduler replicas (module docstring:
    policies, replica protocol, clock semantics).

    >>> router = RequestRouter([s0, s1, s2, s3], policy="least_loaded")
    >>> rr = router.submit(prompt, max_new=64)     # open-loop arrivals
    >>> while not rr.finished:
    ...     router.step()                          # tick the fleet
    >>> rr.tokens, rr.ttft

    ``step()`` is one fleet tick: probe replica health (eject / restore
    + re-route off the dead), tick every busy routable replica, resolve
    first tokens and completions, and fire due TTFT hedges. The caller
    owns the cadence — a live serving loop calls it hot, a virtual-time
    driver (:func:`~..sim.workload.run_router_day`) advances the clock
    to :meth:`next_event_at` between calls.

    ``health_fn(replica) -> bool`` decides routability (default: the
    replica's ``alive`` attribute, True when absent); ``mark_down`` /
    ``mark_up`` override it manually, and an ejected replica's
    in-flight requests are re-routed the moment the flip is seen —
    zero dropped requests under a replica kill, pinned by
    tests/test_torch_router.py. ``ttft_slo`` (required for ``hedge_p99``,
    ignored otherwise) is the per-request first-token budget in clock
    seconds."""

    def __init__(
        self,
        replicas: Sequence[Any],
        *,
        policy: str = "least_loaded",
        ttft_slo: float | None = None,
        clock=None,
        health_fn: Callable[[Any], bool] | None = None,
        migrate_threshold_bytes: int | None = None,
        migrate_gbs: float | None = None,
        qos: TenantRegistry | None = None,
        shed_depth: int | None = None,
        shed_depth_hard: int | None = None,
        registry=None,
        flight=None,
        exporter=None,
        trace=None,
    ):
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("a router needs at least one replica")
        if policy not in ROUTER_POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; choose one of "
                f"{ROUTER_POLICIES}"
            )
        if policy == "hedge_p99":
            if ttft_slo is None or ttft_slo <= 0:
                raise ValueError(
                    "hedge_p99 needs ttft_slo > 0: the policy IS the "
                    "deadline (re-dispatch when the first token misses "
                    "it)"
                )
        self.policy = policy
        # disaggregated placement: the fleet must actually be two
        # tiers, and the router keeps the membership sets (replica
        # `tier` attributes, models/disagg.py's wrappers and the sim's
        # two-tier SimReplica both stamp them)
        self._prefill_set: set[int] = set()
        self._decode_set: set[int] = set()
        if policy == "two_tier":
            for i, r in enumerate(self.replicas):
                t = getattr(r, "tier", "unified")
                if t == "prefill":
                    self._prefill_set.add(i)
                elif t == "decode":
                    self._decode_set.add(i)
            if not self._prefill_set or not self._decode_set:
                raise ValueError(
                    "two_tier needs at least one replica in EACH tier "
                    f"(got {len(self._prefill_set)} prefill, "
                    f"{len(self._decode_set)} decode); tag replicas "
                    "with tier='prefill'/'decode' "
                    "(models/disagg.py wrappers, or SimReplica(tier=))"
                )
        self.migrate_threshold_bytes = (
            None if migrate_threshold_bytes is None
            else int(migrate_threshold_bytes)
        )
        self.migrate_gbs = (
            None if migrate_gbs is None else float(migrate_gbs)
        )
        # in-flight migrations: rr -> [ticket, ready_at, t_captured]
        # (insertion-ordered like every router book)
        self._migrating: dict[RoutedRequest, list] = {}
        # inert unless hedging: the sim driver schedules wakeups off
        # this, and a non-hedging router must not generate deadline
        # events nothing will consume
        self.ttft_slo = (
            float(ttft_slo) if policy == "hedge_p99" else None
        )
        self.clock = clock
        self._now = (
            time.perf_counter if clock is None else clock.now
        )
        self._health_fn = health_fn  # None = the default `alive` probe
        self._up = [True] * len(self.replicas)
        self._routable: list[int] = list(range(len(self.replicas)))
        self._down_manual: set[int] = set()
        # network partitions (chaos plane): a partitioned replica is
        # unroutable but ALIVE — it keeps ticking, its results are
        # unreachable, and heal() reconciles its stale legs so a
        # rejoin can never double-retire a request
        self._partitioned: set[int] = set()
        self._partition_stale: dict[int, list] = {}
        self.n_partitions = 0
        self.n_partitions_healed = 0
        self.n_stale_cancelled = 0
        # overload shedding (chaos plane): with a soft queue-depth
        # ceiling, sheddable (batch-class; ALL classless) traffic is
        # shed by name once the fleet's queued depth reaches it; the
        # hard ceiling (default 2x soft) sheds EVERY class — the
        # bounded-queue guarantee under offered load past 1. None
        # keeps the pre-chaos queue-without-bound behavior.
        if shed_depth is not None and shed_depth < 1:
            raise ValueError(
                f"shed_depth must be >= 1 or None, got {shed_depth}"
            )
        if shed_depth_hard is not None and shed_depth is None:
            raise ValueError(
                "shed_depth_hard without shed_depth: the hard ceiling "
                "refines the soft one, it cannot stand alone"
            )
        self.shed_depth = None if shed_depth is None else int(shed_depth)
        self.shed_depth_hard = (
            None if shed_depth is None
            else int(shed_depth_hard) if shed_depth_hard is not None
            else 2 * int(shed_depth)
        )
        if (self.shed_depth_hard is not None
                and self.shed_depth_hard < self.shed_depth):
            raise ValueError(
                f"shed_depth_hard ({self.shed_depth_hard}) below "
                f"shed_depth ({self.shed_depth}): the hard ceiling "
                "must sit at or above the soft one"
            )
        self._rr = 0
        # in-flight request books, all insertion-ordered dicts (used as
        # ordered sets): hash-order iteration would break bit-identical
        # sim replays. _awaiting holds requests with no first token yet
        # (keyed per replica leg); _streaming holds requests past first
        # token, keyed by the winning replica.
        self._awaiting: list[dict[RoutedRequest, None]] = [
            {} for _ in self.replicas
        ]
        self._streaming: list[dict[RoutedRequest, None]] = [
            {} for _ in self.replicas
        ]
        self._orphans: dict[RoutedRequest, None] = {}
        self._hedge = RequestHedge()
        self.n_submitted = 0
        self.n_completed = 0
        self.n_hedges = 0
        self.n_rerouted = 0
        self.n_migrated = 0
        self.n_kept_local = 0  # threshold / no-decode-replica keeps
        self.n_bounced = 0  # captured but decode tier could never fit
        self.migrated_bytes = 0
        # multi-tenant QoS (opt-in, qos/ package): token buckets
        # charged at submit (over-budget batch work is shed by name),
        # and per-tenant TTFT-hedge entitlements (a tenant's deadline
        # panic draws from its OWN slack, counted and refused beyond
        # it — module docstring "priced isolation")
        self._qos = qos
        if qos is not None and len(qos) == 0:
            raise ValueError(
                "qos= needs at least one TenantContract registered: "
                "an empty registry can route nothing"
            )
        self._buckets = qos.buckets() if qos is not None else {}
        self._hedges_out: dict[str, int] = {}
        self.n_shed = 0
        self.n_hedges_refused = 0
        self.n_over_budget = 0  # non-sheddable classes: paced, not shed
        self._obs = (
            _RouterObs(self, registry, flight)
            if registry is not None or flight is not None
            else None
        )
        # causal tracing: OPT-IN, as everywhere in obs —
        # a dark router pays one `is None` check per transition
        self._trace = trace
        if trace is not None:
            self._propagate_trace(trace)
        # initial health reading: a replica dead at construction must
        # never receive the first submit (step() keeps probing after)
        for i, r in enumerate(self.replicas):
            self._up[i] = self._probe(r)
        self._routable = [i for i, u in enumerate(self._up) if u]
        if exporter is not None:
            exporter.register_router(self)

    # -- causal tracing -----------------------------------------------

    def attach_trace(self, book) -> None:
        """Arm causal tracing post-construction — the chaos injector's
        hook (``scenario.build`` signatures stay untouched): every
        request submitted from here on mints a trace id at the door,
        and the replica-side events (DRR, prefill chunks) stamp the
        same book."""
        self._trace = book
        self._propagate_trace(book)

    def _propagate_trace(self, book) -> None:
        for rep in self.replicas:
            at = getattr(rep, "attach_trace", None)
            if at is not None:
                at(book)

    def inflight_on(self, i: int) -> list[RoutedRequest]:
        """Snapshot of the requests with a leg on replica ``i`` — the
        fleet controller reads this at a shrink to stamp
        ``evacuated_on_resize`` on the traces it is about to drain."""
        return list(self._awaiting[i]) + list(self._streaming[i])

    # -- health ---------------------------------------------------------

    @property
    def routable_replicas(self) -> list[int]:
        """Indices currently admitting traffic (healthy + not manually
        marked down). Cached — rebuilt only on a health flip; this sits
        on the per-event hot path of million-request sims."""
        return self._routable

    @property
    def in_flight(self) -> int:
        return self.n_submitted - self.n_completed

    def mark_down(self, i: int) -> None:
        """Manually eject replica ``i`` (an operator drain, a bench
        kill): takes effect at the next :meth:`step`'s health probe."""
        self._down_manual.add(int(i))

    def mark_up(self, i: int) -> None:
        self._down_manual.discard(int(i))

    @property
    def queue_depth(self) -> int:
        """Queued (not yet admitted) requests over the ROUTABLE
        fleet — the exact quantity the overload ceilings bound, so
        the chaos plane's bounded-queue probe and the shed door can
        never disagree. Non-routable replicas are excluded by
        construction: a dead replica's queue is wiped, and a
        partitioned replica's frozen backlog (its abandoned,
        uncancelled legs) is bounded by what was in flight at
        partition onset — no new work ever lands there."""
        reps = self.replicas
        return sum(reps[i].pending for i in self._routable)

    # -- network partitions (chaos plane) -------------------------------

    def partition(self, i: int) -> None:
        """Begin a router<->replica network partition: replica ``i``
        becomes unroutable, but — unlike a death — it KEEPS TICKING
        (``step`` still drives it; in-flight work on it progresses and
        burns its capacity). Its in-flight requests re-route onto the
        survivors like an ejection, except their legs on ``i`` are
        abandoned UNCANCELLED: no cancel can cross a partition. The
        abandoned legs are remembered and reconciled at :meth:`heal`,
        so the rejoin can never double-retire a request."""
        i = int(i)
        if not 0 <= i < len(self.replicas):
            raise ValueError(f"partition({i}): no such replica")
        if i in self._partitioned:
            raise ValueError(
                f"partition({i}): replica {i} is already partitioned"
            )
        now = self._now()
        self._partitioned.add(i)
        self.n_partitions += 1
        # fleet prefix cache (cache/ package): a partitioned replica
        # can neither serve nor issue peer-page fetches — the hub
        # fails those fetches to re-prefill until heal()
        _c = getattr(self.replicas[i], "cache", None)
        if _c is not None:
            _c.partition(self.replicas[i].cache_name)
        moved = 0
        if self._up[i]:
            self._up[i] = False
            self._routable = [
                j for j, u in enumerate(self._up) if u
            ]
            moved = self._evacuate_unreachable(i, now)
        if self._obs is not None:
            self._obs.partitioned(i, now, moved)

    def heal(self, i: int) -> None:
        """End replica ``i``'s partition and reconcile: the re-routed
        copies are authoritative — every stale leg the replica still
        holds is cancelled, and legs it finished behind the partition
        are discarded (their tokens were unreachable when produced).
        The request-level books were already detached at
        :meth:`partition`, so nothing the isolated side did can
        complete a request a second time; ``n_stale_cancelled``
        counts the withdrawn legs."""
        i = int(i)
        if i not in self._partitioned:
            raise ValueError(
                f"heal({i}): replica {i} is not partitioned"
            )
        now = self._now()
        self._partitioned.discard(i)
        stale = self._partition_stale.pop(i, [])
        replica = self.replicas[i]
        cancelled = 0
        for rr, leg in stale:
            if getattr(leg, "finished", False):
                continue  # finished behind the partition: discarded
            try:
                if replica.cancel(leg):
                    cancelled += 1
            except Exception:  # noqa: BLE001 — replica died partitioned
                pass
        self.n_stale_cancelled += cancelled
        self.n_partitions_healed += 1
        _c = getattr(replica, "cache", None)
        if _c is not None:
            _c.heal(replica.cache_name)
        up = i not in self._down_manual and self._probe(replica)
        if up and not self._up[i]:
            self._up[i] = True
            self._routable = [
                j for j, u in enumerate(self._up) if u
            ]
        if self._obs is not None:
            self._obs.healed(i, now, cancelled)

    def _evacuate_unreachable(self, i: int, now: float) -> int:
        """The partition twin of :meth:`_evacuate`: requests with a
        leg on unreachable replica ``i`` lose that leg WITHOUT a
        cancel (the cancel cannot be delivered) — the abandoned legs
        are parked in the partition-stale book for :meth:`heal` to
        withdraw. Single-leg requests re-route (zero drops, the
        ejection contract)."""
        moved = 0
        stale = self._partition_stale.setdefault(i, [])
        victims = list(self._awaiting[i]) + list(self._streaming[i])
        self._awaiting[i].clear()
        self._streaming[i].clear()
        for rr in victims:
            for j, leg in rr._legs:
                if j == i:
                    stale.append((rr, leg))
            rr._legs = [leg for leg in rr._legs if leg[0] != i]
            if self._trace is not None and rr.trace is not None:
                self._trace.event(
                    rr.trace, "partition_abandoned", now, replica=i
                )
                if (rr.hedged and rr.t_first_token is None
                        and rr.hedge_replica is not None):
                    self._trace.event(
                        rr.trace, "hedge_abandoned", now, replica=i
                    )
            self._hedge_release(rr)  # the hedge episode died with a leg
            if rr._legs:
                j = rr._legs[0][0]
                if rr.t_first_token is None:
                    rr.replica = j
                    rr.hedge_replica = None
                continue
            self._hedge.disarm(rr)
            self._reroute(rr, now)
            moved += 1
        return moved

    def set_policy(self, policy: str) -> None:
        """Switch the placement policy mid-run — the fleet
        controller's re-policy hook (``fleet/controller.py`` applies
        the ``sweep_router_policy`` winner at each resize's operating
        point). Only the STATELESS placement policies are switchable:
        ``hedge_p99`` and ``two_tier`` are structural (the TTFT
        deadline / the tier membership sets are construction-time
        contracts), so switching into or out of them is refused by
        name, never coerced. In-flight requests are unaffected —
        ``policy`` is read per submit."""
        policy = str(policy)
        if policy == self.policy:
            return
        if policy not in ROUTER_POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; choose one of "
                f"{ROUTER_POLICIES}"
            )
        structural = {"hedge_p99", "two_tier"}
        if policy in structural or self.policy in structural:
            raise ValueError(
                f"set_policy({policy!r}) refused: "
                f"{(policy if policy in structural else self.policy)!r}"
                " is structural — hedge_p99's ttft_slo and two_tier's "
                "tier membership are construction-time contracts; "
                "build a router with the policy instead of switching "
                "mid-run"
            )
        self.policy = policy
        if self._obs is not None and self._obs.registry is not None:
            # completions must label the policy that ROUTED them: the
            # obs bundle caches the label and its per-(replica,
            # outcome) series — both roll over with the switch
            self._obs.policy = policy
            self._obs._done = {}

    def replica_statuses(
        self, *, max_tick_age_s: float = 30.0
    ) -> list[tuple[bool, str]]:
        """Per-replica (routable, detail) pairs for the aggregate
        ``/healthz`` check — routability as the router currently sees
        it, plus ``last_tick_at`` freshness detail where the replica
        stamps it (wall-clock routers only: a virtual-time replica's
        stamp is on the virtual axis and ages meaninglessly against
        ``perf_counter``)."""
        out = []
        for i, r in enumerate(self.replicas):
            if not self._up[i]:
                out.append((False, "ejected"))
                continue
            last = getattr(r, "last_tick_at", None)
            if self.clock is None and last is not None:
                age = time.perf_counter() - last
                busy = (r.pending + r.active) > 0
                if busy and age > max_tick_age_s:
                    out.append(
                        (False, f"stale: last tick {age:.1f}s ago")
                    )
                    continue
                out.append((True, f"ok, last tick {age:.1f}s ago"))
                continue
            out.append((True, "ok"))
        return out

    def _probe(self, r) -> bool:
        hf = self._health_fn
        return getattr(r, "alive", True) if hf is None else bool(hf(r))

    def _probe_health(self) -> None:
        now = None
        hf = self._health_fn
        dm = self._down_manual
        parts = self._partitioned
        downs: list[int] | None = None
        for i, r in enumerate(self.replicas):
            # default probe inlined: this loop runs once per step of a
            # million-event sim, and a per-replica function call
            # measured ~10% of the whole day. A partitioned replica is
            # pinned down until heal() — the probe must not flip it
            # back while its stale legs are unreconciled.
            up = i not in dm and i not in parts and (
                getattr(r, "alive", True) if hf is None else bool(hf(r))
            )
            if up == self._up[i]:
                continue
            if now is None:
                now = self._now()
            self._up[i] = up
            self._routable = [
                j for j, u in enumerate(self._up) if u
            ]
            if up:
                if self._obs is not None:
                    self._obs.restored(i, now)
            else:
                # evacuation is DEFERRED to after the full scan: a
                # CORRELATED kill flips several replicas in one probe
                # pass, and evacuating at the first flip would re-route
                # onto a same-instant casualty still marked routable
                # (the chaos plane's correlated-host-kill episode
                # caught exactly this)
                if downs is None:
                    downs = []
                downs.append(i)
        if downs is not None:
            for i in downs:
                n = self._evacuate(i, now)
                if self._obs is not None:
                    self._obs.ejected(i, now, n)

    def _evacuate(self, i: int, now: float) -> int:
        """Replica ``i`` went down: every in-flight request with a leg
        on it loses that leg; single-leg requests are re-routed onto
        the survivors (or parked until one returns — zero drops either
        way)."""
        moved = 0
        victims = list(self._awaiting[i]) + list(self._streaming[i])
        self._awaiting[i].clear()
        self._streaming[i].clear()
        replica = self.replicas[i]
        for rr in victims:
            for j, leg in rr._legs:
                if j != i:
                    continue
                # best-effort cancel: a DRAINED-but-alive replica (an
                # operator mark_down, a transient health flip) must not
                # keep decoding streams nobody reads — zombie legs
                # occupy slots (and, paged, pool pages) for their whole
                # budget and skew least_loaded on resume. A truly dead
                # replica may raise or no-op; either is fine, the leg
                # is abandoned regardless.
                try:
                    replica.cancel(leg)
                except Exception:  # noqa: BLE001 — dead replica
                    pass
            rr._legs = [leg for leg in rr._legs if leg[0] != i]
            if self._trace is not None and rr.trace is not None:
                self._trace.event(
                    rr.trace, "evacuated", now, replica=i
                )
                if (rr.hedged and rr.t_first_token is None
                        and rr.hedge_replica is not None):
                    # the hedge EPISODE died with the leg (whichever
                    # side was lost): neither won nor race-cancelled
                    # — the audit's third hedge-leg disposition
                    self._trace.event(
                        rr.trace, "hedge_abandoned", now, replica=i
                    )
            self._hedge_release(rr)  # the hedge episode died with a leg
            if rr._legs:
                # the surviving hedge leg carries the request alone
                j = rr._legs[0][0]
                if rr.t_first_token is None:
                    rr.replica = j
                    rr.hedge_replica = None
                continue
            self._hedge.disarm(rr)
            self._reroute(rr, now)
            moved += 1
        return moved

    def _reroute(self, rr: RoutedRequest, now: float) -> None:
        routable = self.routable_replicas
        rr.rerouted += 1
        self.n_rerouted += 1
        rr.t_first_token = None  # the stream restarts from the prompt
        rr.t_admitted = None
        if not routable:
            # nobody to route to RIGHT NOW: park it; each step retries
            # once a replica recovers — the request is never dropped
            self._orphans[rr] = None
            return
        j = self._pick(rr.prompt, routable)
        leg = self._submit_leg(j, rr)
        rr._legs = [(j, leg)]
        rr.replica = j
        rr.hedge_replica = None
        self._awaiting[j][rr] = None
        if self._trace is not None and rr.trace is not None:
            self._trace.event(rr.trace, "rerouted", now, replica=j)
        if self.policy == "hedge_p99":
            self._hedge.arm(rr, now + self.ttft_slo)
            if self._trace is not None and rr.trace is not None:
                self._trace.event(
                    rr.trace, "hedge_armed", now,
                    fire_at=now + self.ttft_slo,
                )

    # -- policy ---------------------------------------------------------

    def _load(self, i: int) -> int:
        r = self.replicas[i]
        return r.pending + r.active

    def _affinity(self, i: int, prompt) -> int:
        """Resident-prefix score of ``prompt`` on replica ``i``: the
        replica's own ``prefix_hits`` when it has one (the sim
        shortcut), else the number of leading
        :func:`~.paging.prefix_page_digests` pages already resident in
        its paged pool — exactly the pages admission would share."""
        r = self.replicas[i]
        hits = getattr(r, "prefix_hits", None)
        if hits is not None:
            return int(hits(prompt))
        pool = getattr(r, "pool", None)
        if pool is None or not getattr(r, "paged", False):
            return 0
        p = np.asarray(prompt, np.int32).reshape(-1)
        digests = prefix_page_digests(p, r.P, r.max_pages)
        n = 0
        for d in digests[: max(p.size - 1, 0) // r.P]:
            if pool.lookup(d) is None:
                break
            n += 1
        return n

    def _least_loaded(self, routable: list[int]) -> int:
        # hand-rolled argmin: this runs once per submit in the
        # million-request sims, where a key-lambda min measured ~3x
        best, best_load = routable[0], None
        for i in routable:
            r = self.replicas[i]
            load = r.pending + r.active
            if best_load is None or load < best_load:
                best, best_load = i, load
        return best

    def _pick(self, prompt, routable: list[int]) -> int:
        if self.policy == "two_tier":
            # fresh requests prefill-tier least_loaded; when the whole
            # prefill tier is out, any routable replica serves
            # (availability over tier purity — the decode wrappers are
            # complete schedulers)
            pre = [i for i in routable if i in self._prefill_set]
            return self._least_loaded(pre if pre else routable)
        if self.policy == "round_robin":
            n = len(self.replicas)
            for d in range(n):
                i = (self._rr + d) % n
                if i in routable:
                    self._rr = (i + 1) % n
                    return i
        if self.policy == "prefix_affinity":
            return self._bounded_affinity(prompt, routable)
        # least_loaded — also hedge_p99's placement policy
        return self._least_loaded(routable)

    def _bounded_affinity(self, prompt, cands: list[int]) -> int:
        """The resident-prefix replica (longest registered prefix-digest
        chain, the pages a placement would SHARE), load-bounded:
        affinity wins only while its load stays within one slot batch
        of the least loaded. Unbounded affinity melts a replica under a
        hot system prompt (a 0.7 share rate aimed 70% of the fleet's
        traffic at one quarter of its capacity — p99 went 100x,
        measured); the bound diverts the overflow to least_loaded,
        trading those requests' prefill skip for the fleet's tail.
        Both the ``prefix_affinity`` submit path and two-tier decode
        placement route here — one bound, not two copies."""
        aff, aff_score = None, 0
        for i in cands:
            sc = self._affinity(i, prompt)
            if sc > aff_score or (
                sc == aff_score and sc > 0
                and self._load(i) < self._load(aff)
            ):
                aff, aff_score = i, sc
        ll = self._least_loaded(cands)
        if aff is None or aff_score == 0:
            return ll
        slack = getattr(self.replicas[aff], "S", 1)
        if self._load(aff) <= self._load(ll) + slack:
            return aff
        return ll

    # -- the request path -----------------------------------------------

    @staticmethod
    def _prompt_tokens(prompt) -> int:
        """Token length of a prompt in any of the entry-door shapes:
        a SimPrompt descriptor (``length``), a bare int (the sim
        protocol's "a prompt of that many tokens" shorthand —
        ``np.size`` would read it as ONE token and undercharge the
        budget door ~100x), or a token array/list."""
        n = getattr(prompt, "length", None)
        if n is not None:
            return int(n)
        if isinstance(prompt, (int, np.integer)):
            return int(prompt)
        return int(np.size(prompt))

    def _submit_leg(self, j: int, rr: RoutedRequest):
        """One replica-submit with the tenant threaded through —
        only when the request carries one, so tenant-less traffic
        keeps the pre-QoS replica protocol verbatim."""
        if rr.trace is None:
            # dark path: the pre-trace replica protocol verbatim
            if rr.tenant is None:
                return self.replicas[j].submit(
                    rr.prompt, rr.max_new, key=rr.key
                )
            return self.replicas[j].submit(
                rr.prompt, rr.max_new, key=rr.key, tenant=rr.tenant
            )
        kw = {"trace": rr.trace}
        if rr.tenant is not None:
            kw["tenant"] = rr.tenant
        try:
            # traced path: the id travels IN the submit so the
            # replica's enqueue-time events (drr_queued) carry it
            return self.replicas[j].submit(
                rr.prompt, rr.max_new, key=rr.key, **kw
            )
        except TypeError:
            # foreign replica type without the trace kwarg: submit
            # dark, then stamp the leg post-hoc where possible
            del kw["trace"]
            leg = self.replicas[j].submit(
                rr.prompt, rr.max_new, key=rr.key, **kw
            )
            try:
                leg.trace = rr.trace
            except AttributeError:
                pass
            return leg

    def submit(self, prompt, max_new: int, key=None,
               tenant: str | None = None) -> RoutedRequest:
        """Route one request; returns the live :class:`RoutedRequest`
        whose ``tokens`` / ``finished`` the caller watches. Raises when
        no replica is routable — the condition the aggregate
        ``/healthz`` check reports as 503.

        ``tenant`` is REQUIRED on a ``qos=`` router (unknown tenants
        refused by name). The tenant's token bucket is charged
        ``prompt + max_new`` tokens here, at the door: an over-budget
        tenant whose class is sheddable (``batch``) gets the request
        back immediately with ``outcome == "shed"`` — named, counted
        (``n_shed``, ``qos_shed_total{tenant,reason}``), never routed;
        an over-budget interactive tenant is PACED instead (the
        request routes, and the replicas' deficit admission caps the
        tenant at its weight — counted in ``n_over_budget``)."""
        routable = self.routable_replicas
        if not routable:
            raise RuntimeError(
                f"no routable replicas (0 of {len(self.replicas)} "
                "admittable); repair or mark_up a replica"
            )
        now = self._now()
        contract = None
        if self._qos is not None:
            if tenant is None:
                raise ValueError(
                    "qos router needs tenant= at submit: budgets, "
                    "shed, and hedge entitlements are per-contract "
                    "(register a catch-all TenantContract for "
                    "untagged traffic)"
                )
            contract = self._qos.get(tenant)  # unknown: named KeyError
        if self.shed_depth is not None:
            # overload ceilings (chaos plane): queued depth over the
            # routable fleet (THE queue_depth quantity — one
            # implementation, so the chaos probe and this door can
            # never disagree), read BEFORE this submit queues
            # anything AND before the budget door — an overload shed
            # must not charge a token bucket for work the fleet never
            # accepted (the refund convention: refusals never
            # keep the charge). Soft ceiling sheds sheddable work
            # (batch class; all classless traffic) by name; the hard
            # ceiling sheds every class — shed beats an unbounded
            # queue.
            depth = self.queue_depth
            if depth >= self.shed_depth_hard:
                return self._shed_at_door(
                    prompt, max_new, key, tenant, now, "overload_hard"
                )
            if depth >= self.shed_depth and (
                contract is None or contract.sheddable
            ):
                return self._shed_at_door(
                    prompt, max_new, key, tenant, now, "overload"
                )
        if contract is not None:
            bucket = self._buckets.get(tenant)
            if bucket is not None and not bucket.take(
                self._prompt_tokens(prompt) + int(max_new), now
            ):
                if contract.sheddable:
                    return self._shed_at_door(
                        prompt, max_new, key, tenant, now, "budget"
                    )
                self.n_over_budget += 1
        rr = RoutedRequest(prompt, max_new, key, now, tenant=tenant)
        if self._trace is not None:
            rr.trace = self._trace.mint()
            self._trace.event(
                rr.trace, "submitted", now, tenant=tenant,
                prompt=self._prompt_tokens(prompt),
            )
        i = self._pick(prompt, routable)
        leg = self._submit_leg(i, rr)
        rr._legs = [(i, leg)]
        rr.replica = i
        self._awaiting[i][rr] = None
        if self.policy == "hedge_p99":
            self._hedge.arm(rr, now + self.ttft_slo)
            if rr.trace is not None:
                self._trace.event(
                    rr.trace, "hedge_armed", now,
                    fire_at=now + self.ttft_slo,
                )
        self.n_submitted += 1
        return rr

    def _shed_at_door(self, prompt, max_new: int, key,
                      tenant: str | None, now: float,
                      reason: str) -> RoutedRequest:
        """Refuse one request at the door BY NAME (no bare drops;
        tests/test_torch_imports.py pins it): the handle comes back
        finished with ``outcome == "shed"`` and ``shed_reason`` set,
        counted and flight-stamped, never routed."""
        if not reason:
            raise ValueError("a shed needs a non-empty reason")
        rr = RoutedRequest(prompt, max_new, key, now, tenant=tenant)
        rr.finished = True
        rr.outcome = "shed"
        rr.shed_reason = str(reason)
        rr.t_done = now
        if self._trace is not None:
            rr.trace = self._trace.mint()
            self._trace.event(
                rr.trace, "submitted", now, tenant=tenant,
                prompt=self._prompt_tokens(prompt),
            )
            self._trace.event(
                rr.trace, "shed", now, reason=str(reason)
            )
        self.n_submitted += 1
        self.n_completed += 1
        self.n_shed += 1
        if self._obs is not None:
            self._obs.shed(rr, reason, now)
        return rr

    def _hedge_entitled(self, rr: RoutedRequest, now: float) -> bool:
        """May this tenant fire one more hedge? The entitlement is a
        cap on OUTSTANDING hedge legs per tenant (contract ``hedges``;
        None = unlimited): a tenant's deadline panic re-dispatches
        draw from its own pool of slack, counted and refused beyond
        it, so they can never consume another tenant's."""
        if self._qos is None or rr.tenant is None:
            return True
        ent = self._qos.get(rr.tenant).hedges
        if ent is None:
            return True
        out = self._hedges_out.get(rr.tenant, 0)
        if out >= ent:
            self.n_hedges_refused += 1
            if self._obs is not None:
                self._obs.hedge_refused(rr, now)
            return False
        self._hedges_out[rr.tenant] = out + 1
        rr._hedge_charged = True
        return True

    def _hedge_release(self, rr: RoutedRequest) -> None:
        """The hedge episode ended (first token resolved, or the
        hedged request lost a leg): return the entitlement unit."""
        if not rr._hedge_charged:
            return
        rr._hedge_charged = False
        n = self._hedges_out.get(rr.tenant, 0) - 1
        if n > 0:
            self._hedges_out[rr.tenant] = n
        else:
            self._hedges_out.pop(rr.tenant, None)

    def _fire_hedges(self, now: float) -> None:
        if not self._hedge:
            return
        for rr in self._hedge.due(now):
            taken = {i for i, _ in rr._legs}
            cands = [
                i for i in self.routable_replicas if i not in taken
            ]
            if not cands:
                continue  # nowhere to hedge to; the primary stands
            if not self._hedge_entitled(rr, now):
                continue  # over entitlement: the primary stands
            j = self._least_loaded(cands)
            leg = self._submit_leg(j, rr)
            rr._legs.append((j, leg))
            rr.hedge_replica = j
            rr.hedged = True
            self._awaiting[j][rr] = None
            self.n_hedges += 1
            if self._obs is not None:
                self._obs.hedge_fired(rr, j, now)
            if self._trace is not None and rr.trace is not None:
                self._trace.event(
                    rr.trace, "hedge_fired", now, replica=j
                )

    def _resolve_first_tokens(self, now: float,
                              ticked: Sequence[int]) -> None:
        # only replicas that actually ticked can have produced a first
        # token (the 1M-request sim's hot path: the books of the other
        # N-1 replicas must not be rescanned per event); iterate a
        # snapshot — winners mutate the books
        for i in ticked:
            if not self._awaiting[i]:
                continue
            for rr in list(self._awaiting[i]):
                if rr not in self._awaiting[i]:
                    continue  # resolved via its other leg this pass
                winner = None
                for idx, (j, leg) in enumerate(rr._legs):
                    if rr.t_admitted is None and (
                        getattr(leg, "admitted_tick", None) is not None
                    ):
                        rr.t_admitted = now
                        if self._obs is not None:
                            self._obs.admitted(now - rr.t_submit)
                        if (self._trace is not None
                                and rr.trace is not None):
                            self._trace.event(
                                rr.trace, "admitted", now, replica=j
                            )
                    if winner is None and len(leg.tokens) > 0:
                        winner = idx
                if winner is None:
                    continue
                j, leg = rr._legs[winner]
                for k, (jj, loser) in enumerate(rr._legs):
                    if k == winner:
                        continue
                    self._awaiting[jj].pop(rr, None)
                    self.replicas[jj].cancel(loser)
                    if (self._trace is not None
                            and rr.trace is not None
                            and rr.hedged
                            and jj == rr.hedge_replica):
                        # the HEDGE leg lost the race and was reaped:
                        # the "cancelled == fired - won - abandoned"
                        # arithmetic the audit checks counts exactly
                        # these (a reaped PRIMARY is the hedge_won
                        # case, not a cancellation)
                        self._trace.event(
                            rr.trace, "hedge_cancelled", now,
                            replica=jj,
                        )
                rr._legs = [(j, leg)]
                rr.replica = j
                rr.t_first_token = now
                if self._trace is not None and rr.trace is not None:
                    self._trace.event(
                        rr.trace, "first_token", now, replica=j
                    )
                    if rr.hedged and j == rr.hedge_replica:
                        self._trace.event(
                            rr.trace, "hedge_won", now, replica=j
                        )
                self._hedge.disarm(rr)
                self._hedge_release(rr)
                self._awaiting[j].pop(rr, None)
                if (
                    self.policy == "two_tier"
                    and j in self._prefill_set
                    and not leg.finished
                    and self._begin_migration(rr, j, leg, now)
                ):
                    continue  # in the migration book, not streaming
                self._streaming[j][rr] = None

    # -- two-tier migration (the disaggregation placement brain) --------

    def _begin_migration(self, rr: RoutedRequest, i: int, leg,
                         now: float) -> bool:
        """First token just resolved on prefill replica ``i``: capture
        the stream's KV pages for the decode tier, unless the payload
        exceeds the migration-size threshold or no decode replica is
        routable — it then decodes where it prefilled (the graceful
        keep-local path, counted in ``n_kept_local``)."""
        r = self.replicas[i]
        migrate_out = getattr(r, "migrate_out", None)
        if migrate_out is None or not any(
            j in self._decode_set for j in self._routable
        ):
            self.n_kept_local += 1
            return False
        thr = self.migrate_threshold_bytes
        if thr is not None:
            size = getattr(r, "migration_nbytes", None)
            if size is not None and size(leg) > thr:
                self.n_kept_local += 1
                return False
        ticket = migrate_out(leg)
        if self._trace is not None and rr.trace is not None:
            # the trace id rides INSIDE the ticket so an adopting
            # replica (possibly a different process in the live plane)
            # can keep stamping the same record
            try:
                ticket.trace = rr.trace
            except AttributeError:
                pass
            self._trace.event(
                rr.trace, "migrate_out", now, replica=i,
                nbytes=int(getattr(ticket, "nbytes", 0)),
                pages=int(getattr(ticket, "pages", 0) or 0),
            )
        delay = (
            ticket.nbytes / (self.migrate_gbs * 1e9)
            if self.migrate_gbs else 0.0
        )
        self._migrating[rr] = [ticket, now + delay, now]
        return True

    def _pick_decode(self, rr: RoutedRequest,
                     cands: list[int]) -> int:
        """Adoption target: the decode replica already holding the
        longest resident prefix of this stream's prompt (the pages the
        adoption will SHARE instead of landing twice), load-bounded
        exactly like ``prefix_affinity``; ``least_loaded`` otherwise."""
        return self._bounded_affinity(rr.prompt, cands)

    def _bounce_candidates(self, ticket) -> list[int]:
        """Where a due-but-unadoptable migration may BOUNCE: empty
        while parking is justified — some routable decode replica
        could eventually adopt (``could_adopt``; a replica without the
        verb is assumed feasible, the sim twin's unbounded queue) —
        otherwise every routable replica that can adopt right now
        (the prefill tier included: zero drops beats tier purity)."""
        for j in self._routable:
            if j not in self._decode_set:
                continue
            ce = getattr(self.replicas[j], "could_adopt", None)
            if ce is None or ce(ticket):
                return []
        cands = []
        for j in self._routable:
            ca = getattr(self.replicas[j], "can_adopt", None)
            if ca is None or ca(ticket):
                cands.append(j)
        return cands

    def _land_migrations(self, now: float) -> None:
        """Land every due migration whose decode tier can adopt it
        right now; the rest stay booked and retry next step (capacity
        frees as decode-tier requests retire — their ticks are the
        events the sim driver advances to). Parking is only legal
        while some routable decode replica could EVER adopt the
        ticket (``could_adopt``): a dead decode tier, or one whose
        every replica is config-incompatible with the stream, BOUNCES
        it back onto any adoptable replica — zero drops, the
        ``_evacuate`` contract extended to the mid-migration window."""
        for rr in list(self._migrating):
            ticket, ready, t0 = self._migrating[rr]
            if ready > now + 1e-12:
                continue
            bounced = False
            cands = []
            for j in self._routable:
                if j not in self._decode_set:
                    continue
                ca = getattr(self.replicas[j], "can_adopt", None)
                if ca is None or ca(ticket):
                    cands.append(j)
            if not cands:
                cands = self._bounce_candidates(ticket)
                if not cands:
                    continue  # parked (or nowhere at all yet)
                bounced = True
            j = self._pick_decode(rr, cands)
            leg = self.replicas[j].adopt(ticket)
            del self._migrating[rr]
            rr._legs = [(j, leg)]
            rr.replica = j
            rr.migrated = True
            self._streaming[j][rr] = None
            self.n_migrated += 1
            if bounced:
                self.n_bounced += 1
            self.migrated_bytes += int(getattr(ticket, "nbytes", 0))
            if self._obs is not None:
                self._obs.migrated(rr, ticket, j, now, now - t0)
            if self._trace is not None and rr.trace is not None:
                self._trace.event(
                    rr.trace, "adopt", now, replica=j,
                    bounced=bounced,
                )

    def _resolve_completions(
        self, now: float, ticked: Sequence[int]
    ) -> list[RoutedRequest]:
        done: list[RoutedRequest] = []
        for j in ticked:
            if not self._streaming[j]:
                continue
            for rr in list(self._streaming[j]):
                leg = rr._legs[0][1]
                if not leg.finished:
                    continue
                del self._streaming[j][rr]
                rr.finished = True
                rr.t_done = now
                if rr.rerouted:
                    rr.outcome = "rerouted"
                elif rr.hedged:
                    rr.outcome = (
                        "hedge_won" if j == rr.hedge_replica else
                        "hedged"
                    )
                elif rr.migrated:
                    rr.outcome = "migrated"
                else:
                    rr.outcome = "ok"
                self.n_completed += 1
                if self._obs is not None:
                    self._obs.completed(rr)
                if self._trace is not None and rr.trace is not None:
                    self._trace.event(
                        rr.trace, "retired", now, outcome=rr.outcome,
                        tokens=len(leg.tokens),
                    )
                done.append(rr)
        return done

    def step(self) -> list[RoutedRequest]:
        """One fleet tick; returns the requests completed in it."""
        self._probe_health()
        if self._orphans and self.routable_replicas:
            now = self._now()
            orphans, self._orphans = self._orphans, {}
            for rr in orphans:
                rr.rerouted -= 1  # _reroute recounts
                self.n_rerouted -= 1
                self._reroute(rr, now)
        now = self._now()
        ticked: list[int] = []
        for i in self._routable:
            r = self.replicas[i]
            nt = getattr(r, "next_tick_at", _NO_SCHEDULE)
            if nt is _NO_SCHEDULE:
                # live replica (no tick schedule): step whenever busy
                if r.pending or r.active:
                    r.step()
                    ticked.append(i)
            elif nt is not None and nt <= now + 1e-12:
                r.step()
                ticked.append(i)
        # partitioned replicas KEEP TICKING (partition != death): their
        # in-flight work progresses and burns capacity, but they are
        # never in `ticked` — their first tokens and completions are
        # unreachable until heal() reconciles. Guarded: step() is the
        # hottest loop in a million-event day and partitions are rare,
        # so the common case pays one falsy check, not a sort.
        if self._partitioned:
            for i in sorted(self._partitioned):
                r = self.replicas[i]
                nt = getattr(r, "next_tick_at", _NO_SCHEDULE)
                if nt is _NO_SCHEDULE:
                    if r.pending or r.active:
                        r.step()
                elif nt is not None and nt <= now + 1e-12:
                    r.step()
        if self.clock is None:
            now = self._now()  # live: replica ticks took real time
        if ticked:
            self._resolve_first_tokens(now, ticked)
            done = self._resolve_completions(now, ticked)
        else:
            done = []
        if self._migrating:
            self._land_migrations(now)
        self._fire_hedges(now)
        if self._obs is not None:
            self._obs.depths(self)
        return done

    def next_event_at(self) -> float | None:
        """The earliest virtual time anything router-visible happens: a
        busy routable replica's next tick (replicas exposing
        ``next_tick_at`` — the sim protocol) or a pending hedge
        deadline. None when idle; the virtual-time driver
        (:func:`~..sim.workload.run_router_day`) advances the clock
        here between steps. Live replicas carry no tick schedule — a
        wall-clock serving loop just calls :meth:`step` hot."""
        best = None
        reps = self.replicas
        for i in self._routable:
            t = getattr(reps[i], "next_tick_at", None)
            if t is not None and (best is None or t < best):
                best = t
        # a partitioned replica's ticks are events too: it keeps
        # working through the partition, and the virtual-time driver
        # must advance to its ticks or its in-flight work would freeze
        # (that would be death, which a partition is not)
        for i in self._partitioned:
            t = getattr(reps[i], "next_tick_at", None)
            if t is not None and (best is None or t < best):
                best = t
        if self._hedge:
            d = self._hedge.next_deadline()
            if d is not None and (best is None or d < best):
                best = d
        if self._migrating:
            # still-transferring migrations are events; a DUE one
            # parked on decode-tier capacity is not (its wake signal
            # is the tier's next tick — capacity frees at retirement,
            # and a past-due time here would spin the driver). A due
            # one the next step would BOUNCE (decode tier dead or
            # statically unfit, an adoptable replica elsewhere) IS an
            # event — without it a day whose decode tier died with a
            # parked ticket reads as stalled before the rescuing step
            # ever runs.
            now = self._now()
            for ticket, ready, t0 in self._migrating.values():
                if ready > now:
                    if best is None or ready < best:
                        best = ready
                elif self._bounce_candidates(ticket):
                    if best is None or now < best:
                        best = now
        return best

    def drain(self, *, max_steps: int = 1_000_000) -> None:
        """Step until every in-flight request completes (live loops;
        the sim driver uses :meth:`next_event_at` instead)."""
        for _ in range(max_steps):
            if self.in_flight == 0:
                return
            self.step()
        raise RuntimeError(
            f"not drained after {max_steps} steps: "
            f"{self.in_flight} requests in flight"
        )

    def __repr__(self) -> str:
        return (
            f"RequestRouter({self.policy}, "
            f"{len(self.routable_replicas)}/{len(self.replicas)} "
            f"routable, {self.in_flight} in flight)"
        )
