"""Chaos plane in the port: correlated faults, retry storms, overload
shedding, partitions — and the pinned survival invariants over sim/.

The contract is ``tests/test_chaos.py``: its cases run here on the
port's copies with the same bounds. Then every scenario of the catalog
runs in both packages at the same seed: the ``ChaosReport.digest()``,
the invariants held and the shed reasons must be equal (tolerance:
none).

Four layers: (1) the new utils/faults builders (partition,
correlated_kill) are pure, picklable, and replay bit-identically on
SimBackend; (2) the router's partition/heal and overload-shed
machinery is pinned at the unit level (partition != death, rejoin
never double-retires, every shed is named, queues stay bounded);
(3) the chaos scenario catalog runs end-to-end through ChaosInjector
with every invariant held and a bit-identical ChaosReport digest
across replays — including the metastable-recovery claim (a retry
storm that drives offered load past 1 and subsides returns p99 to a
pinned factor of the pre-storm baseline); (4) the fleet controller
does not flap under a retry storm (hysteresis's first adversarial
test)."""

import heapq
import importlib
import pickle

import numpy as np
import pytest

from mpistragglers_jl_tpu_torch import AsyncPool, SimBackend, asyncmap, waitall
from mpistragglers_jl_tpu_torch.chaos import (
    SCENARIOS,
    ChaosInjector,
    ChaosReport,
    InvariantViolation,
    ReplicaKill,
    get_scenario,
)
from mpistragglers_jl_tpu_torch.models.router import RequestRouter
from mpistragglers_jl_tpu_torch.qos import (
    SHED_ORDER,
    TenantContract,
    TenantRegistry,
    shed_rank,
)
from mpistragglers_jl_tpu_torch.sim import (
    ReplicaPartition,
    RetryPolicy,
    SimReplica,
    VirtualClock,
    poisson_arrivals,
    run_router_day,
)
from mpistragglers_jl_tpu_torch.utils import faults


def _echo(worker, payload, epoch):
    return payload + worker


# --------------------------------------------------------------------------
# utils/faults: partition + correlated_kill builders
# --------------------------------------------------------------------------


class TestFaultBuilders:
    GROUPS = [[0, 1], [2, 3], [4, 5], [6, 7]]

    def test_partition_window_semantics(self):
        """Members stall until the window closes (the result crosses
        the instant the partition heals); outsiders and epochs outside
        the window are instant."""
        p = faults.partition(
            [self.GROUPS[1]], 10, 16, epoch_s=0.5
        )
        assert p(2, 9) == 0.0          # before the window
        assert p(2, 10) == 3.0         # 6 epochs x 0.5 s left
        assert p(3, 15) == 0.5         # last epoch inside
        assert p(2, 16) == 0.0         # healed
        assert p(0, 12) == 0.0         # not a member
        assert faults.partition(
            [self.GROUPS[1]], 10, 16, epoch_s=0.5
        )(2, 12) == p(2, 12)           # pure in (worker, epoch)

    def test_partition_refusals(self):
        with pytest.raises(ValueError, match="from_epoch"):
            faults.partition([self.GROUPS[0]], 5, 5)
        with pytest.raises(ValueError, match="epoch_s"):
            faults.partition([self.GROUPS[0]], 1, 2, epoch_s=0.0)

    def test_correlated_kill_span_and_clamp(self):
        ck = faults.correlated_kill(
            self.GROUPS, epicenter=2, at_epoch=5, span=3
        )
        assert ck.killed_groups == [2, 3]  # clamped at the end
        assert ck(4, 4) == 0.0 and ck(4, 5) == 3600.0
        assert ck(7, 9) == 3600.0
        assert ck(0, 9) == 0.0  # outside the blast radius
        with pytest.raises(ValueError, match="epicenter"):
            faults.correlated_kill(
                self.GROUPS, epicenter=9, at_epoch=5
            )
        with pytest.raises(ValueError, match="span"):
            faults.correlated_kill(
                self.GROUPS, epicenter=0, at_epoch=5, span=0
            )

    @pytest.mark.parametrize("mk", [
        lambda g: faults.partition([g[1], g[2]], 3, 7, epoch_s=0.1),
        lambda g: faults.correlated_kill(
            g, epicenter=1, at_epoch=6, span=2
        ),
    ])
    def test_picklable_and_bit_identical_sim_replay(self, mk):
        """The kill_group contract: a pure picklable class whose
        schedule replays an asyncmap run on SimBackend bit-identically
        — repochs, event stream, and final virtual time all equal."""
        sched = mk(self.GROUPS)
        clone = pickle.loads(pickle.dumps(sched))
        grid = [(w, e) for w in range(8) for e in range(12)]
        assert [sched(w, e) for w, e in grid] == [
            clone(w, e) for w, e in grid
        ]

        def run(fn):
            be = SimBackend(_echo, 8, delay_fn=faults.compose(
                faults.seeded_lognormal(0.02, 0.5, seed=3), fn,
            ))
            pool = AsyncPool(8)
            reps = [
                asyncmap(pool, np.zeros(1), be, nwait=4).copy()
                for _ in range(10)
            ]
            waitall(pool, be)
            order = [
                (ev.worker, ev.epoch, ev.t_done) for ev in be.events
            ]
            return reps, order, be.clock.now()

        r1, o1, t1 = run(sched)
        r2, o2, t2 = run(clone)
        assert all((a == b).all() for a, b in zip(r1, r2))
        assert o1 == o2 and t1 == t2

    def test_fault_schedule_builders(self):
        s = (faults.FaultSchedule(seed=2)
             .partition([self.GROUPS[0]], 2, 4, epoch_s=0.1)
             .correlated_kill(self.GROUPS, epicenter=3, at_epoch=8))
        assert "partition" in repr(s) and "correlated_kill" in repr(s)
        fn = s.delay_fn
        assert fn(0, 2) > 0.0 and fn(6, 9) >= 3600.0
        assert fn(4, 2) == 0.0


# --------------------------------------------------------------------------
# router: partition != death, rejoin without double-retire
# --------------------------------------------------------------------------


def _mini_fleet(n=2, **kw):
    clock = VirtualClock()
    reps = [
        SimReplica(clock, slots=2, n_inner=4, prompt_chunk=64,
                   tick_s=0.01)
        for _ in range(n)
    ]
    router = RequestRouter(
        reps, policy="least_loaded", clock=clock, **kw
    )
    return clock, reps, router


def _drive(clock, router, until):
    while True:
        nt = router.next_event_at()
        if nt is None or nt > until:
            break
        clock.run_until(nt)
        router.step()
    clock.run_until(until)
    router.step()


class TestRouterPartition:
    def test_partition_keeps_ticking_and_heal_cancels_stale(self):
        """Heal BEFORE the stale leg finishes: the leg progressed
        behind the partition (partition != death — in-flight work
        burns capacity), the re-routed copy is authoritative, the
        stale leg is withdrawn, and the request completes exactly
        once."""
        clock, reps, router = _mini_fleet()
        rr = router.submit(64, 64)     # long decode on replica 0
        assert rr.replica == 0
        _drive(clock, router, 0.015)   # admitted, first chunk run
        leg0 = rr._legs[0][1]
        router.partition(0)
        assert rr.replica == 1 and rr.rerouted == 1
        assert not leg0.finished       # NOT cancelled: unreachable
        emitted_at_partition = leg0.n_emitted
        _drive(clock, router, 0.05)    # both replicas tick
        assert leg0.n_emitted > emitted_at_partition  # kept ticking
        router.heal(0)
        assert leg0.finished and leg0.reason == "cancelled"
        assert router.n_stale_cancelled == 1
        _drive(clock, router, 2.0)
        assert rr.finished and rr.outcome == "rerouted"
        assert router.n_completed == router.n_submitted == 1
        assert router.n_partitions == router.n_partitions_healed == 1

    def test_heal_after_stale_leg_finished_never_double_retires(self):
        """Heal AFTER the isolated side finished the leg: its tokens
        were unreachable when produced, the finished leg is discarded,
        and the request still completes exactly once (via the
        re-routed copy)."""
        clock, reps, router = _mini_fleet()
        rr = router.submit(64, 8)      # short request
        _drive(clock, router, 0.015)
        leg0 = rr._legs[0][1]
        router.partition(0)
        _drive(clock, router, 1.0)     # isolated side finishes leg0
        assert leg0.finished and leg0.reason == "length"
        assert rr.finished             # re-routed copy completed too
        n_done_before = router.n_completed
        router.heal(0)
        _drive(clock, router, 1.5)
        assert router.n_completed == n_done_before == 1
        assert router.n_stale_cancelled == 0  # nothing to withdraw
        assert reps[0].active == 0     # no zombie slot after rejoin

    def test_partition_refusals_and_probe_pinning(self):
        clock, reps, router = _mini_fleet()
        router.partition(0)
        with pytest.raises(ValueError, match="already partitioned"):
            router.partition(0)
        with pytest.raises(ValueError, match="not partitioned"):
            router.heal(1)
        # the health probe must not flip a partitioned replica back
        router.step()
        assert 0 not in router.routable_replicas
        router.heal(0)
        router.step()
        assert 0 in router.routable_replicas

    def test_partition_event_in_day_stream(self):
        """ReplicaPartition fires partition at t and heal at `until`
        on the clock — the whole day drains with a reconciled ledger,
        bit-identically."""

        def day():
            clock, reps, router = _mini_fleet(n=3)
            arr = poisson_arrivals(
                60.0, n=300, seed=11, prompt_len=64, max_new=16,
            )
            rep = run_router_day(
                router, arr,
                events=[ReplicaPartition(1.0, (2,), 2.5)],
            )
            return rep, router

        rep1, router1 = day()
        rep2, router2 = day()
        assert rep1.digest() == rep2.digest()
        assert rep1.dropped == 0
        assert router1.n_partitions == router1.n_partitions_healed == 1
        assert router1.n_completed == router1.n_submitted
        assert rep1.n_partitions == 1
        with pytest.raises(ValueError, match="heal after"):
            ReplicaPartition(2.0, (0,), 2.0)


# --------------------------------------------------------------------------
# router: overload shedding by name
# --------------------------------------------------------------------------


class TestOverloadShed:
    def test_soft_ceiling_sheds_classless_by_name(self):
        clock, reps, router = _mini_fleet(shed_depth=4)
        assert router.shed_depth_hard == 8  # default 2x soft
        shed = []
        for _ in range(30):
            rr = router.submit(64, 16)
            if rr.outcome == "shed":
                shed.append(rr)
        assert shed, "30 instant submits never crossed depth 4"
        assert all(r.shed_reason == "overload" for r in shed)
        assert all(r.finished and r.replica is None for r in shed)
        assert router.queue_depth <= 8
        assert router.n_shed == len(shed)

    def test_batch_sheds_before_interactive(self):
        """The QoS sheddability contract under overload: at the soft
        ceiling only the batch class sheds; interactive work keeps
        routing until the hard ceiling, then sheds with the hard
        reason — and every shed carries a reason either way."""
        reg = TenantRegistry([
            TenantContract("chat", cls="latency", weight=1.0),
            TenantContract("bulk", cls="batch", weight=1.0),
        ])
        clock = VirtualClock()
        reps = [
            SimReplica(clock, slots=2, n_inner=4, prompt_chunk=64,
                       tick_s=0.01, qos=reg)
            for _ in range(2)
        ]
        router = RequestRouter(
            reps, policy="least_loaded", clock=clock, qos=reg,
            shed_depth=4, shed_depth_hard=10,
        )
        outcomes = {"chat": [], "bulk": []}
        for k in range(40):
            t = "chat" if k % 2 else "bulk"
            rr = router.submit(64, 16, tenant=t)
            outcomes[t].append(rr)
        bulk_shed = [r for r in outcomes["bulk"] if r.outcome == "shed"]
        chat_shed = [r for r in outcomes["chat"] if r.outcome == "shed"]
        assert bulk_shed and bulk_shed[0].shed_reason == "overload"
        assert chat_shed  # the hard ceiling eventually sheds everyone
        assert all(
            r.shed_reason == "overload_hard" for r in chat_shed
        )
        # batch shed strictly first (submission order interleaves)
        assert (bulk_shed[0].t_submit, bulk_shed[0].id) < (
            chat_shed[0].t_submit, chat_shed[0].id
        )
        assert router.queue_depth <= 10

    def test_overload_shed_never_charges_the_token_bucket(self):
        """The overload door sits BEFORE the budget door: a request
        the fleet refuses under overload must not drain its tenant's
        token bucket (the refund convention — refusals never keep
        the charge), or the overload penalty would leak into the
        budget plane as spurious post-storm "budget" sheds."""
        reg = TenantRegistry([
            TenantContract("bulk", cls="batch", weight=1.0,
                           rate=1e4, burst=1e6),
        ])
        clock = VirtualClock()
        reps = [
            SimReplica(clock, slots=2, n_inner=4, prompt_chunk=64,
                       tick_s=0.01, qos=reg)
            for _ in range(2)
        ]
        router = RequestRouter(
            reps, policy="least_loaded", clock=clock, qos=reg,
            shed_depth=4, shed_depth_hard=8,
        )
        bucket = router._buckets["bulk"]
        level_before = None
        shed = 0
        for _ in range(30):
            rr = router.submit(64, 16, tenant="bulk")
            if rr.outcome == "shed":
                if level_before is None:
                    level_before = bucket.level(clock.now())
                shed += 1
        assert shed > 0 and rr.shed_reason == "overload"
        # every shed after the first left the bucket untouched
        assert bucket.level(clock.now()) == level_before

    def test_shed_ceiling_validation(self):
        with pytest.raises(ValueError, match="shed_depth must be"):
            _mini_fleet(shed_depth=0)
        with pytest.raises(ValueError, match="without shed_depth"):
            _mini_fleet(shed_depth_hard=8)
        with pytest.raises(ValueError, match="at or above"):
            _mini_fleet(shed_depth=8, shed_depth_hard=4)

    def test_sim_replica_queue_ceiling_raises_by_name(self):
        clock = VirtualClock()
        rep = SimReplica(clock, slots=1, max_queue=2)
        rep.submit(16, 4)
        rep.submit(16, 4)  # pending == 2 == the ceiling
        with pytest.raises(RuntimeError, match="queue ceiling"):
            rep.submit(16, 4)
        with pytest.raises(ValueError, match="max_queue"):
            SimReplica(clock, max_queue=0)

    def test_shed_order_constants(self):
        assert SHED_ORDER[0] == "batch"
        assert shed_rank("batch") == 0
        assert shed_rank("latency") == len(SHED_ORDER) - 1
        assert TenantContract("t", cls="batch").shed_rank == 0
        with pytest.raises(ValueError, match="unknown SLO class"):
            shed_rank("gold")


# --------------------------------------------------------------------------
# retry clients: the metastable-failure generator
# --------------------------------------------------------------------------


class TestRetryClients:
    def test_retry_policy_validation(self):
        with pytest.raises(ValueError, match="timeout_s"):
            RetryPolicy(0.0)
        with pytest.raises(ValueError, match="max_retries"):
            RetryPolicy(1.0, max_retries=-1)
        with pytest.raises(ValueError, match="backoff"):
            RetryPolicy(1.0, backoff=0.5)
        with pytest.raises(ValueError, match="jitter_s"):
            RetryPolicy(1.0, jitter_s=-0.1)

    def test_resubmit_at_seeded_and_backed_off(self):
        p = RetryPolicy(1.0, backoff=2.0, jitter_s=0.5, seed=4)
        assert p.resubmit_at(10.0, 3, 0) == pytest.approx(
            RetryPolicy(1.0, backoff=2.0, jitter_s=0.5,
                        seed=4).resubmit_at(10.0, 3, 0)
        )
        base0 = RetryPolicy(1.0, backoff=2.0).resubmit_at(10.0, 3, 0)
        base1 = RetryPolicy(1.0, backoff=2.0).resubmit_at(10.0, 3, 1)
        assert base0 == 11.0 and base1 == 12.0  # timeout doubles
        # jitter stays within its band and differs across indices
        j = [p.resubmit_at(0.0, i, 0) - 1.0 for i in range(8)]
        assert all(0.0 <= x < 0.5 for x in j)
        assert len(set(j)) > 1

    def test_storm_amplifies_then_is_bounded(self):
        """A capacity dip ignites resubmissions; the amplification is
        bounded by max_retries and sheds are never retried — and the
        whole storm replays bit-identically."""

        def day():
            clock = VirtualClock()
            reps = [
                SimReplica(clock, slots=2, n_inner=4,
                           prompt_chunk=64, tick_s=0.01)
                for _ in range(4)
            ]
            router = RequestRouter(
                reps, policy="least_loaded", clock=clock,
                shed_depth=24,
            )
            n = 600
            rate = 120.0
            arr = poisson_arrivals(
                rate, n=n, seed=9, prompt_len=64, max_new=16,
            )
            events = [ReplicaKill(1.0, (1, 2, 3), 3.0)]
            rep = run_router_day(
                router, arr, events=events,
                retry=RetryPolicy(timeout_s=0.15, max_retries=2,
                                  jitter_s=0.05, seed=2),
            )
            return rep

        r1, r2 = day(), day()
        assert r1.digest() == r2.digest()
        assert r1.n_resubmits == r2.n_resubmits > 0
        assert r1.n_resubmits <= 2 * 600  # max_retries bound
        assert r1.n == 600 + r1.n_resubmits  # attempts in the report
        assert r1.dropped == 0

    def test_no_retry_day_is_byte_identical_to_pre_chaos_driver(self):
        """retry=None keeps the drive loop event-for-event: the digest
        of a plain day equals the digest of the same day driven with
        an explicitly absent retry policy."""

        def day(**kw):
            clock = VirtualClock()
            reps = [
                SimReplica(clock, slots=2, n_inner=4,
                           prompt_chunk=64, tick_s=0.01)
                for _ in range(3)
            ]
            router = RequestRouter(
                reps, policy="least_loaded", clock=clock
            )
            arr = poisson_arrivals(
                80.0, n=400, seed=21, prompt_len=64, max_new=16,
            )
            return run_router_day(router, arr, **kw)

        assert day().digest() == day(retry=None).digest()


# --------------------------------------------------------------------------
# the episode suite: every catalog scenario, invariants held, digest
# bit-identical
# --------------------------------------------------------------------------


_SMALL = {
    "overload_shed": {"n": 1500},
    "retry_storm": {"n": 1500},
    "network_partition": {"n": 1200},
    "correlated_host_kill": {"n": 1200},
    "prefix_churn": {"steps": 800},
    "storm_with_host_kill": {"n": 1800},
    "partition_mid_fetch": {"n": 1200},
}


class TestEpisodeSuite:
    @pytest.mark.parametrize("name", sorted(SCENARIOS))
    def test_episode_invariants_and_bit_identity(self, name):
        inj = ChaosInjector()
        r1 = inj.run(get_scenario(name, seed=5, **_SMALL[name]))
        r2 = inj.run(get_scenario(name, seed=5, **_SMALL[name]))
        assert isinstance(r1, ChaosReport)
        assert r1.digest() == r2.digest()
        assert r1.invariants  # the battery actually ran
        assert r1.shed_named_pct == 100.0
        assert r1.dropped == 0
        # a different seed is a different episode
        r3 = inj.run(get_scenario(name, seed=6, **_SMALL[name]))
        assert r3.digest() != r1.digest()

    def test_acceptance_combo_episode(self):
        """The headline episode: retry storm + correlated host-group
        kill + 30%-span partition completes on VirtualClock with zero
        invariant violations — queue bounded, every shed named with
        batch before interactive, partitions reconciled with no
        double-retire, no drops, and an identical digest across two
        runs (pinned by test_episode_invariants_and_bit_identity;
        here the combo's specifics)."""
        inj = ChaosInjector()
        r = inj.run(get_scenario(
            "storm_with_host_kill", seed=5,
            **_SMALL["storm_with_host_kill"],
        ))
        assert r.n_resubmits > 0                  # the storm
        assert r.n_partitions == 2                # the partition span
        assert r.shed_reasons.get("overload", 0) > 0
        assert r.max_queue_depth <= 128           # the pinned ceiling
        assert r.extras["p99_recovery_x"] <= 4.0  # non-metastable
        assert "bounded_queue" in r.invariants
        assert "shed_by_name" in r.invariants

    def test_metastable_recovery_pinned(self):
        """Satellite: the retry storm drives offered load past 1 and
        subsides; p99 returns to within the pinned factor of the
        pre-storm baseline, bit-identically across two replays."""
        inj = ChaosInjector()
        r1 = inj.run(get_scenario("retry_storm", seed=5, n=1500))
        r2 = inj.run(get_scenario("retry_storm", seed=5, n=1500))
        assert r1.digest() == r2.digest()
        assert r1.extras["p99_recovery_x"] == (
            r2.extras["p99_recovery_x"]
        ) <= 3.0
        assert r1.n_resubmits > 0

    def test_prefix_churn_counters(self):
        r = ChaosInjector().run(
            get_scenario("prefix_churn", seed=5, steps=800)
        )
        ex = r.extras
        assert ex["admits"] > 0 and ex["retires"] > 0
        assert ex["cow_copies"] > 0      # the reservation churn ran
        assert ex["rollbacks"] > 0       # stranded reservations ran
        assert ex["share_hits"] > 0
        assert len(ex["churn_digest"]) == 16

    def test_unknown_scenario_refused_by_name(self):
        with pytest.raises(ValueError, match="unknown chaos scenario"):
            get_scenario("thundering_herd")
        with pytest.raises(TypeError, match="ChaosScenario"):
            ChaosInjector().run("retry_storm")

    def test_injector_obs_and_flight_capture(self):
        """registry= exports the episode counters; flight= holds the
        episode instants (begin/end, sheds, partitions) — and the
        flight-capture invariant actually verified them."""
        from mpistragglers_jl_tpu_torch.obs import FlightRecorder
        from mpistragglers_jl_tpu_torch.obs.metrics import MetricsRegistry

        reg = MetricsRegistry()
        fr = FlightRecorder(capacity=8192)
        inj = ChaosInjector(registry=reg, flight=fr)
        r = inj.run(get_scenario(
            "storm_with_host_kill", seed=5,
            **_SMALL["storm_with_host_kill"],
        ))
        assert "flight_captured" in r.invariants
        prom = reg.to_prometheus()
        assert 'chaos_episodes_total{scenario="storm_with_host_kill"}' \
            in prom
        assert "chaos_max_queue_depth" in prom
        assert "router_shed_total" in prom
        assert "router_partitions_total" in prom
        eps = fr.instants("chaos episode")
        assert [e["phase"] for e in eps] == ["begin", "end"]
        assert eps[1]["digest"] == r.digest()
        assert fr.instants("replica partitioned")
        assert fr.instants("partition healed")
        assert fr.instants("qos shed")

    def test_dark_injector_is_dark(self):
        inj = ChaosInjector()
        assert inj.registry is None and inj.flight is None
        r = inj.run(get_scenario("overload_shed", seed=5, n=1500))
        assert "flight_captured" not in r.invariants


# --------------------------------------------------------------------------
# fleet: the controller must not flap under a retry storm
# --------------------------------------------------------------------------


class TestFleetNoFlap:
    def test_hysteresis_survives_a_retry_storm(self):
        """A storm whipsaws the arrival-rate and utilization signals;
        dwell + cooldown must keep the controller from chasing it —
        at most one grow/shrink direction flip over the whole day, and
        the day still drains with zero drops."""
        from mpistragglers_jl_tpu_torch.fleet import FleetController

        clock = VirtualClock()
        reps = [
            SimReplica(clock, slots=4, n_inner=8, prompt_chunk=64,
                       tick_s=0.02)
            for _ in range(8)
        ]
        router = RequestRouter(
            reps, policy="least_loaded", clock=clock,
            shed_depth=64, shed_depth_hard=128,
        )
        cap = 4 / (6 * 0.02)  # service_ticks_per_request arithmetic
        rate = 0.6 * 8 * cap
        n = 2400
        span = n / rate
        base = poisson_arrivals(
            rate, n=n, seed=3, prompt_len=96, max_new=32,
        )
        burst = poisson_arrivals(
            0.8 * 8 * cap, n=int(0.8 * 8 * cap * 0.25 * span),
            seed=91, start=0.35 * span, prompt_len=96, max_new=32,
        )
        ctl = FleetController(
            router, clock=clock, capacity_rps=cap, min_replicas=4,
            max_replicas=8, decision_interval_s=1.0, dwell_s=2.0,
            cooldown_s=4.0, rate_tau_s=5.0,
        )
        rep = run_router_day(
            router,
            heapq.merge(base, burst, key=lambda a: a.t),
            controller=ctl,
            retry=RetryPolicy(timeout_s=0.35, max_retries=2,
                              jitter_s=0.2, seed=7),
        )
        assert rep.dropped == 0
        assert ctl.n_direction_flips <= 1, (
            f"controller flapped: {ctl.n_resizes} resizes, "
            f"{ctl.n_direction_flips} direction flips — "
            f"{[d.action for d in ctl.decisions]}"
        )
        assert ctl.n_resizes <= 4

    def test_direction_flip_counter_semantics(self):
        """The flap detector counts REVERSALS, not resizes: two
        shrinks then a grow is one flip."""
        from mpistragglers_jl_tpu_torch.fleet import FleetController

        clock = VirtualClock()
        reps = [
            SimReplica(clock, slots=4, tick_s=0.02) for _ in range(6)
        ]
        router = RequestRouter(
            reps, policy="least_loaded", clock=clock
        )
        ctl = FleetController(
            router, clock=clock, capacity_rps=30.0, min_replicas=2,
            max_replicas=6, decision_interval_s=10.0,
        )
        ctl.resize_to(4, reason="test")
        ctl.resize_to(3, reason="test")
        assert ctl.n_direction_flips == 0
        ctl.resize_to(5, reason="test")
        assert ctl.n_direction_flips == 1
        ctl.resize_to(6, reason="test")
        assert ctl.n_direction_flips == 1
        state = ctl.state_dict()
        assert state["n_direction_flips"] == 1
        assert state["last_action"] == 1  # grow


# --------------------------------------------------------------------------
# report mechanics
# --------------------------------------------------------------------------


class TestChaosReport:
    def test_digest_covers_chaos_counters(self):
        a = ChaosReport("s", 1, extras={"x": 1.0})
        b = ChaosReport("s", 1, extras={"x": 1.0})
        assert a.digest() == b.digest()
        assert ChaosReport("s", 2).digest() != a.digest()
        assert ChaosReport(
            "s", 1, max_queue_depth=9, extras={"x": 1.0}
        ).digest() != a.digest()

    def test_shed_named_pct_vacuous_on_no_sheds(self):
        assert ChaosReport("s", 0).shed_named_pct == 100.0

    def test_invariant_violation_is_assertion(self):
        assert issubclass(InvariantViolation, AssertionError)

    def test_replica_kill_validation(self):
        with pytest.raises(ValueError, match="revive"):
            ReplicaKill(2.0, (0,), 1.0)
        with pytest.raises(ValueError, match="no replicas"):
            ReplicaKill(1.0, (), 2.0)


# --------------------------------------------------------------------------
# cross-package: one seeded episode, one digest
# --------------------------------------------------------------------------


def _episode(which, name):
    root = {"port": "mpistragglers_jl_tpu_torch",
            "jax": "mpistragglers_jl_tpu"}[which]
    chaos = importlib.import_module(root + ".chaos")
    r = chaos.ChaosInjector().run(
        chaos.get_scenario(name, seed=5, **_SMALL[name]))
    return {"digest": r.digest(), "invariants": r.invariants,
            "shed_reasons": dict(r.shed_reasons), "dropped": r.dropped,
            "resubmits": r.n_resubmits, "partitions": r.n_partitions,
            "max_depth": r.max_queue_depth}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_episode_digest_equal_in_both_packages(name):
    port = _episode("port", name)
    assert port == _episode("jax", name)
    assert port["dropped"] == 0 and port["invariants"]
