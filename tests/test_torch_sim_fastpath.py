"""Parity suite for the vectorized router-day engine in the port
(``sim/fastpath.py``).

The contract is ``tests/test_sim_fastpath.py``: its cases run here on
the port's copies. Then the cross-package checks: the batch generators
give the same arrays in both packages, and the port's fast driver gives
the JAX package's fast driver's digest and books on plain, prefix,
hedged and QoS days (tolerance: none).

The contract under test: the fast path must reproduce the scalar loop's ``digest()`` BIT-IDENTICALLY on every
seeded day — plain, QoS, elastic, chaos. The digest witness is the
spec; any divergence is a fast-path bug by definition. Elastic and
chaos days satisfy it through the documented scalar fallback, which
this suite pins too (reason string AND digest equality).

Beyond the witness, ``_assert_books`` compares the full observable
ledger — router counters, per-replica books (tick_count, busy_s,
retires, cancels, shared admits), DRR scheduler internals, and token
bucket levels — because the fast path hands the REAL QoS objects back
and the controller reads those books for its next decision.
"""

import heapq
import importlib

import numpy as np
import pytest

from mpistragglers_jl_tpu_torch.models.router import RequestRouter
from mpistragglers_jl_tpu_torch.qos import TenantContract, TenantRegistry
from mpistragglers_jl_tpu_torch.sim import (
    ArrivalBatch,
    ReplicaPartition,
    RetryPolicy,
    VirtualClock,
    diurnal_arrival_batch,
    fastpath_supported,
    poisson_arrival_batch,
    run_router_day_fast,
)
from mpistragglers_jl_tpu_torch.sim.workload import (
    FleetResize,
    SimReplica,
    diurnal_arrivals,
    lognormal_ticks,
    poisson_arrivals,
    run_router_day,
)


def _fleet(n=4, slots=4, n_inner=8, tick=0.02, sigma=0.0, seed=0,
           policy="least_loaded", qos=None, dead=(), **router_kw):
    clock = VirtualClock()
    reps = []
    for i in range(n):
        tick_s = (
            tick if sigma == 0.0
            else lognormal_ticks(tick, sigma, seed=seed * 1009 + i)
        )
        r = SimReplica(clock, slots=slots, n_inner=n_inner,
                       tick_s=tick_s, qos=qos)
        if i in dead:
            r.kill()
        reps.append(r)
    router = RequestRouter(reps, policy=policy, clock=clock,
                           qos=qos, **router_kw)
    return clock, reps, router


def _assert_books(rep_s, rep_f, reps_s, reps_f, router_s, router_f):
    """Scalar report/fleet vs fast report/fleet: witness first, then
    every non-witness book the decision planes read."""
    assert rep_s.digest() == rep_f.digest()
    assert rep_s.outcomes == rep_f.outcomes
    assert rep_s.shed_reasons == rep_f.shed_reasons
    assert rep_s.dropped == rep_f.dropped
    assert rep_s.n_resubmits == rep_f.n_resubmits
    assert rep_s.virtual_s == rep_f.virtual_s
    assert rep_s.n_events == rep_f.n_events
    np.testing.assert_array_equal(
        rep_s.decode_itl, rep_f.decode_itl
    )
    for attr in ("n_submitted", "n_completed", "n_shed", "n_hedges",
                 "n_hedges_refused", "n_over_budget", "_rr"):
        assert getattr(router_s, attr) == getattr(router_f, attr), attr
    for a, b in zip(reps_s, reps_f):
        for attr in ("tick_count", "busy_s", "last_tick_at",
                     "next_tick_at", "n_retired", "n_cancelled",
                     "n_shared_admits"):
            assert getattr(a, attr) == getattr(b, attr), attr
        da, db = a._drr, b._drr
        if da is not None:
            assert da._order == db._order
            assert da._deficit == db._deficit
            assert da._cursor == db._cursor
            assert da._n == db._n
            assert da._max_cost == db._max_cost


def _run_both(mk_fleet, arrivals_fn, batch, **day_kw):
    _, reps_s, router_s = mk_fleet()
    rep_s = run_router_day(router_s, arrivals_fn(), **day_kw)
    _, reps_f, router_f = mk_fleet()
    rep_f = run_router_day_fast(router_f, batch, **day_kw)
    return rep_s, rep_f, reps_s, reps_f, router_s, router_f


# --------------------------------------------------------------------------
# plain days
# --------------------------------------------------------------------------


class TestPlainDayParity:
    def test_least_loaded_lognormal(self):
        kw = dict(prompt_len=96, max_new=32)
        out = _run_both(
            lambda: _fleet(sigma=0.3, seed=2),
            lambda: poisson_arrivals(50.0, n=2000, seed=2, **kw),
            poisson_arrival_batch(50.0, n=2000, seed=2, **kw),
        )
        assert out[1].fastpath == "vectorized"
        _assert_books(*out)

    def test_prefix_affinity_multichunk(self):
        kw = dict(prompt_len=400, max_new=24, prefix_share=0.5,
                  prefix_len=256, n_prefix_groups=6)
        out = _run_both(
            lambda: _fleet(policy="prefix_affinity", sigma=0.25,
                           seed=5),
            lambda: poisson_arrivals(30.0, n=1200, seed=5, **kw),
            poisson_arrival_batch(30.0, n=1200, seed=5, **kw),
        )
        assert out[1].fastpath == "vectorized"
        _assert_books(*out)

    def test_round_robin_same_tick_retire(self):
        # max_new=1 retires at its admission tick — the residency
        # net-no-op corner of the fused slot scan
        kw = dict(prompt_len=32, max_new=1)
        out = _run_both(
            lambda: _fleet(policy="round_robin", n_inner=1, tick=0.01),
            lambda: poisson_arrivals(120.0, n=1500, seed=8, **kw),
            poisson_arrival_batch(120.0, n=1500, seed=8, **kw),
        )
        _assert_books(*out)

    def test_hedge_p99(self):
        kw = dict(prompt_len=64, max_new=16)
        out = _run_both(
            lambda: _fleet(policy="hedge_p99", sigma=0.35, seed=3,
                           ttft_slo=0.25),
            lambda: poisson_arrivals(45.0, n=1500, seed=3, **kw),
            poisson_arrival_batch(45.0, n=1500, seed=3, **kw),
        )
        assert out[1].n_hedges == out[0].n_hedges
        _assert_books(*out)

    def test_overload_shed(self):
        kw = dict(prompt_len=96, max_new=32)
        out = _run_both(
            lambda: _fleet(n=2, shed_depth=8, shed_depth_hard=20),
            lambda: poisson_arrivals(90.0, n=1500, seed=6, **kw),
            poisson_arrival_batch(90.0, n=1500, seed=6, **kw),
        )
        rep_s, rep_f = out[0], out[1]
        assert rep_s.n_shed > 0
        assert rep_s.shed_reasons == rep_f.shed_reasons
        _assert_books(*out)

    def test_retry_storm(self):
        kw = dict(prompt_len=96, max_new=32)
        retry = dict(timeout_s=0.1, max_retries=3, jitter_s=0.2,
                     seed=4)
        out = _run_both(
            lambda: _fleet(n=2, shed_depth=10, shed_depth_hard=30),
            lambda: poisson_arrivals(80.0, n=1200, seed=4, **kw),
            poisson_arrival_batch(80.0, n=1200, seed=4, **kw),
            retry=RetryPolicy(**retry),
        )
        assert out[0].n_resubmits > 0
        _assert_books(*out)

    def test_diurnal(self):
        kw = dict(prompt_len=64, max_new=16)
        out = _run_both(
            lambda: _fleet(sigma=0.2, seed=7),
            lambda: diurnal_arrivals(40.0, n=1500, period=120.0,
                                     seed=7, **kw),
            diurnal_arrival_batch(40.0, n=1500, period=120.0, seed=7,
                                  **kw),
        )
        assert out[1].fastpath == "vectorized"
        _assert_books(*out)

    def test_dead_replica(self):
        kw = dict(prompt_len=64, max_new=16)
        out = _run_both(
            lambda: _fleet(dead=(1,)),
            lambda: poisson_arrivals(35.0, n=900, seed=9, **kw),
            poisson_arrival_batch(35.0, n=900, seed=9, **kw),
        )
        _assert_books(*out)


# --------------------------------------------------------------------------
# QoS days
# --------------------------------------------------------------------------


def _contracts():
    return [
        TenantContract("gold", cls="latency", weight=4.0, rate=900.0,
                       burst=600.0, hedges=2, ttft_slo=2.0),
        TenantContract("silver", cls="throughput", weight=2.0,
                       rate=700.0, burst=500.0),
        TenantContract("bronze", cls="batch", weight=1.0, rate=500.0,
                       burst=400.0),
    ]


class TestQosDayParity:
    def _mk(self, **kw):
        reg = TenantRegistry(_contracts())
        return lambda: _fleet(qos=reg, **kw)

    def test_drr_and_buckets(self):
        tenants = {"gold": 0.4, "silver": 0.35, "bronze": 0.25}
        kw = dict(prompt_len=96, max_new=32, tenants=tenants)
        out = _run_both(
            self._mk(),
            lambda: poisson_arrivals(45.0, n=1500, seed=11, **kw),
            poisson_arrival_batch(45.0, n=1500, seed=11, **kw),
        )
        assert out[1].fastpath == "vectorized"
        _assert_books(*out)
        # the shared TokenBucket objects end at identical levels
        _, _, _, _, rs, rf = out
        for nm in ("gold", "silver", "bronze"):
            bs, bf = rs._buckets[nm], rf._buckets[nm]
            assert bs.tokens == bf.tokens and bs._last == bf._last

    def test_qos_shed_and_budget(self):
        tenants = {"gold": 0.4, "silver": 0.3, "bronze": 0.3}
        kw = dict(prompt_len=96, max_new=32, tenants=tenants)
        out = _run_both(
            self._mk(n=2, shed_depth=10, shed_depth_hard=24),
            lambda: poisson_arrivals(70.0, n=1200, seed=13, **kw),
            poisson_arrival_batch(70.0, n=1200, seed=13, **kw),
        )
        assert out[0].n_shed > 0
        _assert_books(*out)

    def test_qos_hedge_entitlements(self):
        tenants = {"gold": 0.5, "silver": 0.3, "bronze": 0.2}
        kw = dict(prompt_len=64, max_new=16, tenants=tenants)
        out = _run_both(
            self._mk(policy="hedge_p99", sigma=0.35, seed=17,
                     ttft_slo=0.25),
            lambda: poisson_arrivals(40.0, n=1200, seed=17, **kw),
            poisson_arrival_batch(40.0, n=1200, seed=17, **kw),
        )
        assert (out[4].n_hedges_refused
                == out[5].n_hedges_refused)
        _assert_books(*out)

    def test_qos_retry(self):
        tenants = {"gold": 0.4, "silver": 0.3, "bronze": 0.3}
        kw = dict(prompt_len=96, max_new=32, tenants=tenants)
        out = _run_both(
            self._mk(n=2, shed_depth=8, shed_depth_hard=20),
            lambda: poisson_arrivals(65.0, n=1000, seed=19, **kw),
            poisson_arrival_batch(65.0, n=1000, seed=19, **kw),
            retry=RetryPolicy(timeout_s=0.8, max_retries=2,
                              jitter_s=0.15, seed=19),
        )
        _assert_books(*out)

    def test_untenanted_on_qos_router_falls_back(self):
        # the scalar door raises on tenant=None under qos; the fast
        # path must not accept what the scalar path refuses
        mk = self._mk()
        _, _, router = mk()
        batch = poisson_arrival_batch(30.0, n=50, seed=1,
                                      prompt_len=64, max_new=8)
        rep = None
        with pytest.raises(ValueError, match="tenant"):
            rep = run_router_day_fast(router, batch)
        assert rep is None


# --------------------------------------------------------------------------
# elastic / chaos days: the documented scalar-fallback boundary
# --------------------------------------------------------------------------


class TestFallbackParity:
    def test_partition_event_day(self):
        def scalar():
            _, reps, router = _fleet(n=3)
            rep = run_router_day(
                router,
                poisson_arrivals(60.0, n=600, seed=11, prompt_len=64,
                                 max_new=16),
                events=[ReplicaPartition(1.0, (2,), 2.5)],
            )
            return rep

        _, _, router = _fleet(n=3)
        batch = poisson_arrival_batch(60.0, n=600, seed=11,
                                      prompt_len=64, max_new=16)
        rep_f = run_router_day_fast(
            router, batch, events=[ReplicaPartition(1.0, (2,), 2.5)]
        )
        assert rep_f.fastpath == (
            "scalar-fallback: control-plane events in stream"
        )
        assert scalar().digest() == rep_f.digest()

    def test_resize_event_day(self):
        # FleetResize needs a controller to act on; the controller
        # alone already routes the day to the scalar loop
        from mpistragglers_jl_tpu_torch.fleet import FleetController

        def day(fast):
            clock, reps, router = _fleet(n=4)
            ctl = FleetController(
                router, clock=clock, capacity_rps=4 / (6 * 0.02),
                min_replicas=2, max_replicas=4,
            )
            arrivals = poisson_arrivals(
                50.0, n=600, seed=21, prompt_len=64, max_new=16,
            )
            events = [FleetResize(2.0, 2), FleetResize(6.0, 4)]
            if fast:
                return run_router_day_fast(
                    router, arrivals, controller=ctl, events=events
                )
            return run_router_day(
                router, arrivals, controller=ctl, events=events
            )

        rep_f = day(fast=True)
        assert rep_f.fastpath.startswith("scalar-fallback")
        assert day(fast=False).digest() == rep_f.digest()

    def test_elastic_controller_day(self):
        from mpistragglers_jl_tpu_torch.fleet import FleetController

        def day(fast):
            clock, reps, router = _fleet(
                n=6, shed_depth=64, shed_depth_hard=128
            )
            cap = 4 / (6 * 0.02)
            ctl = FleetController(
                router, clock=clock, capacity_rps=cap,
                min_replicas=3, max_replicas=6,
                decision_interval_s=1.0, dwell_s=2.0, cooldown_s=4.0,
            )
            arrivals = poisson_arrivals(
                0.5 * 6 * cap, n=900, seed=23, prompt_len=96,
                max_new=32,
            )
            if fast:
                return run_router_day_fast(
                    router, arrivals, controller=ctl
                )
            return run_router_day(router, arrivals, controller=ctl)

        rep_f = day(fast=True)
        assert rep_f.fastpath == (
            "scalar-fallback: controller attached (elastic day)"
        )
        assert day(fast=False).digest() == rep_f.digest()

    def test_chaos_clock_injection_falls_back(self):
        # anything already scheduled on the clock (chaos episodes
        # inject via clock.call_at) disqualifies the vectorized engine
        clock, _, router = _fleet()
        clock.call_at(5.0, lambda: None)
        ok, reason = fastpath_supported(router)
        assert not ok and "chaos" in reason

    def test_tracing_attached_falls_back(self):
        # a traced day records per-request lifecycle events
        # the vectorized engine never stamps — the fallback is named
        from mpistragglers_jl_tpu_torch.obs import TraceBook

        _, _, router = _fleet()
        router.attach_trace(TraceBook())
        ok, reason = fastpath_supported(router)
        assert not ok and reason == "tracing attached"

    def test_series_slo_attached_falls_back(self):
        # a windowed day rolls the series store (and the
        # burn policy) on the drive loop — the vectorized engine has
        # no loop to hook, so the fallback is named
        from mpistragglers_jl_tpu_torch.obs import (
            MetricsRegistry,
            SeriesStore,
            SloObjective,
            SloPolicy,
        )

        _, _, router = _fleet()
        reg = MetricsRegistry()
        series = SeriesStore(reg, window_s=1.0)
        ok, reason = fastpath_supported(router, series=series)
        assert not ok and reason == "series/slo attached"
        slo = SloPolicy(series, [SloObjective(
            "ttft-p99", "latency", 0.5, q=0.99,
        )])
        ok, reason = fastpath_supported(router, slo=slo)
        assert not ok and reason == "series/slo attached"

    def test_used_router_falls_back(self):
        _, _, router = _fleet()
        batch = poisson_arrival_batch(40.0, n=200, seed=1,
                                      prompt_len=64, max_new=8)
        run_router_day_fast(router, batch)
        ok, reason = fastpath_supported(router)
        assert not ok

    def test_two_tier_falls_back(self):
        clock = VirtualClock()
        fleet = [
            SimReplica(clock, slots=4, n_inner=8, tick_s=0.02,
                       tier="prefill" if i < 1 else "decode",
                       chunk_s=0.01)
            for i in range(3)
        ]
        router = RequestRouter(fleet, policy="two_tier", clock=clock)
        ok, reason = fastpath_supported(router)
        assert not ok


# --------------------------------------------------------------------------
# property-style sweep: seeds x (retry, partition, resize)
# --------------------------------------------------------------------------


class TestPropertySweep:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize(
        "retry,event",
        [
            (None, None),
            ("retry", None),
            (None, "partition"),
            (None, "resize"),
            ("retry", "partition"),
            ("retry", "resize"),
        ],
    )
    def test_digest_parity(self, seed, retry, event):
        rp = (
            None if retry is None
            else RetryPolicy(timeout_s=0.6, max_retries=2,
                            jitter_s=0.1, seed=seed)
        )
        events = {
            None: [],
            "partition": [ReplicaPartition(1.0, (1,), 2.0)],
            "resize": [FleetResize(1.5, 2), FleetResize(4.0, 3)],
        }[event]

        def day(fast):
            clock, _, router = _fleet(n=3, sigma=0.2, seed=seed,
                                      shed_depth=16,
                                      shed_depth_hard=40)
            ctl = None
            if event == "resize":
                # FleetResize acts through a controller; attaching
                # one is itself a fallback boundary
                from mpistragglers_jl_tpu_torch.fleet import FleetController

                ctl = FleetController(
                    router, clock=clock, capacity_rps=4 / (6 * 0.02),
                    min_replicas=2, max_replicas=3,
                )
            arrivals = poisson_arrivals(
                55.0, n=400, seed=seed, prompt_len=64, max_new=16,
            )
            if fast:
                return run_router_day_fast(
                    router, arrivals, controller=ctl,
                    events=list(events), retry=rp,
                )
            return run_router_day(
                router, arrivals, controller=ctl,
                events=list(events), retry=rp,
            )

        rep_f = day(fast=True)
        rep_s = day(fast=False)
        assert rep_s.digest() == rep_f.digest()
        assert rep_s.outcomes == rep_f.outcomes
        if event is None:
            assert rep_f.fastpath == "vectorized"
        else:
            assert rep_f.fastpath.startswith("scalar-fallback")


# --------------------------------------------------------------------------
# batch generators and the events/s counter
# --------------------------------------------------------------------------


class TestArrivalBatch:
    def test_poisson_batch_equals_generator(self):
        kw = dict(prompt_len=200, max_new=24, prefix_share=0.3,
                  prefix_len=128, n_prefix_groups=4, long_share=0.1,
                  long_prompt_len=1024, long_max_new=64,
                  tenants={"a": 0.6, "b": 0.4})
        batch = poisson_arrival_batch(25.0, n=800, seed=42, **kw)
        gen = list(poisson_arrivals(25.0, n=800, seed=42, **kw))
        assert len(batch) == len(gen)
        for a, b in zip(batch, gen):
            assert a.t == b.t
            assert a.prompt.length == b.prompt.length
            assert a.prompt.prefix == b.prompt.prefix
            assert a.prompt.prefix_len == b.prompt.prefix_len
            assert a.max_new == b.max_new
            assert a.tenant == b.tenant

    def test_diurnal_batch_equals_generator(self):
        kw = dict(prompt_len=64, max_new=8)
        batch = diurnal_arrival_batch(30.0, n=500, period=90.0,
                                      amplitude=0.6, seed=5, **kw)
        gen = list(diurnal_arrivals(30.0, n=500, period=90.0,
                                    amplitude=0.6, seed=5, **kw))
        assert len(batch) == len(gen)
        for a, b in zip(batch, gen):
            assert a.t == b.t and a.max_new == b.max_new

    def test_from_arrivals_roundtrip(self):
        gen = list(poisson_arrivals(20.0, n=100, seed=3,
                                    prompt_len=64, max_new=8))
        batch = ArrivalBatch.from_arrivals(gen)
        for a, b in zip(batch, gen):
            assert (a.t, a.prompt.length, a.max_new) == (
                b.t, b.prompt.length, b.max_new)

    def test_merged_streams_ingest(self):
        # heapq.merge of two seeded streams (the burst idiom) ingests
        # through from_arrivals and runs vectorized
        base = poisson_arrivals(30.0, n=300, seed=1, prompt_len=64,
                                max_new=8)
        burst = poisson_arrivals(50.0, n=100, seed=2, start=3.0,
                                 prompt_len=64, max_new=8)
        merged = list(heapq.merge(base, burst, key=lambda a: a.t))
        _, _, router = _fleet()
        rep_f = run_router_day_fast(router, merged)
        _, _, router2 = _fleet()
        base = poisson_arrivals(30.0, n=300, seed=1, prompt_len=64,
                                max_new=8)
        burst = poisson_arrivals(50.0, n=100, seed=2, start=3.0,
                                 prompt_len=64, max_new=8)
        rep_s = run_router_day(
            router2, heapq.merge(base, burst, key=lambda a: a.t)
        )
        assert rep_f.fastpath == "vectorized"
        assert rep_s.digest() == rep_f.digest()


class TestEventsPerS:
    def test_counter_requires_timer(self):
        _, _, router = _fleet()
        batch = poisson_arrival_batch(40.0, n=300, seed=1,
                                      prompt_len=64, max_new=8)
        rep = run_router_day_fast(router, batch)
        assert rep.n_events > 0
        assert rep.wall_s is None and rep.events_per_s is None

    def test_counter_with_timer_and_cross_path_equality(self):
        ticks = [0.0]

        def timer():
            ticks[0] += 0.5
            return ticks[0]

        _, _, router = _fleet()
        batch = poisson_arrival_batch(40.0, n=300, seed=1,
                                      prompt_len=64, max_new=8)
        rep_f = run_router_day_fast(router, batch, timer=timer)
        _, _, router2 = _fleet()
        rep_s = run_router_day(
            router2,
            poisson_arrivals(40.0, n=300, seed=1, prompt_len=64,
                             max_new=8),
            timer=timer,
        )
        # n_events is a real event count, identical across paths;
        # events_per_s divides it by the injected timer's wall
        assert rep_f.n_events == rep_s.n_events
        assert rep_f.events_per_s == rep_f.n_events / rep_f.wall_s
        # digest is untouched by the self-measurement (non-witness)
        assert rep_f.digest() == rep_s.digest()


# --------------------------------------------------------------------------
# tune wiring: same decision, bigger grid per budget
# --------------------------------------------------------------------------


class TestTuneFastWiring:
    def test_router_policy_sweep_identical(self):
        from mpistragglers_jl_tpu_torch.sim.tune import sweep_router_policy

        a = sweep_router_policy(requests=500, seed=5, fast="never")
        b = sweep_router_policy(requests=500, seed=5, fast="auto")
        assert a == b

    def test_bad_fast_value_refused(self):
        from mpistragglers_jl_tpu_torch.sim.tune import sweep_router_policy

        with pytest.raises(ValueError, match="fast"):
            sweep_router_policy(requests=50, fast="always")

    def test_tenant_weights_budget_requires_timer(self):
        from mpistragglers_jl_tpu_torch.sim.tune import sweep_tenant_weights

        with pytest.raises(ValueError, match="timer"):
            sweep_tenant_weights(
                contracts=_contracts(),
                candidates=[{"gold": 1.0, "silver": 1.0,
                             "bronze": 1.0}],
                budget_s=1.0,
            )

    def test_tenant_weights_budget_cuts_grid(self):
        from mpistragglers_jl_tpu_torch.sim.tune import sweep_tenant_weights

        cands = [
            {"gold": g, "silver": 2.0, "bronze": 1.0}
            for g in (2.0, 4.0, 8.0)
        ]
        ticks = iter(float(i) for i in range(100))
        res = sweep_tenant_weights(
            contracts=_contracts(), candidates=cands, requests=400,
            seed=1, budget_s=0.5, timer=lambda: next(ticks),
        )
        # the injected timer charges ~1s per candidate: exactly one
        # fits a 0.5s budget (the first always runs)
        assert res["candidates_evaluated"] == 1
        assert res["budget_exhausted"]
        assert len(res["entries"]) == 1

    def test_deeper_grid_improves_decision_at_same_seed(self):
        # the controller-facing claim behind the fast path: the grid a
        # scalar budget affords (a prefix) scores no better than the
        # full grid the fast path affords in the same wall budget —
        # the bench rung (sim_fastpath_bench) measures the wall side;
        # this pins the decision side deterministically
        from mpistragglers_jl_tpu_torch.sim.tune import sweep_tenant_weights

        grid = [
            {"gold": g, "silver": s, "bronze": 1.0}
            for g in (1.0, 2.0, 4.0, 8.0)
            for s in (1.0, 2.0)
        ]
        full = sweep_tenant_weights(
            contracts=_contracts(), candidates=grid, requests=400,
            seed=7, fast="auto",
        )
        prefix = sweep_tenant_weights(
            contracts=_contracts(), candidates=grid[:2], requests=400,
            seed=7, fast="auto",
        )
        assert (full["best_entry"]["score"]
                <= prefix["best_entry"]["score"])
        assert full["candidates_evaluated"] == len(grid)


# --------------------------------------------------------------------------
# cross-package: the port's fast driver against the JAX package's
# --------------------------------------------------------------------------


def _xmods(which):
    root = {"port": "mpistragglers_jl_tpu_torch",
            "jax": "mpistragglers_jl_tpu"}[which]
    return (importlib.import_module(root + ".sim"),
            importlib.import_module(root + ".models.router"),
            importlib.import_module(root + ".qos"))


def _xfast(which, kind):
    sim, rmod, qos = _xmods(which)
    clock = sim.VirtualClock()
    reg = None
    if kind == "qos":
        reg = qos.TenantRegistry([
            qos.TenantContract(c.name, cls=c.cls, weight=c.weight,
                               rate=c.rate, burst=c.burst,
                               hedges=c.hedges, ttft_slo=c.ttft_slo)
            for c in _contracts()])
    reps = [sim.SimReplica(clock, slots=4, n_inner=8, qos=reg,
                           tick_s=sim.lognormal_ticks(0.02, 0.3,
                                                      seed=700 + i))
            for i in range(4)]
    policy = {"plain": "least_loaded", "prefix": "prefix_affinity",
              "hedge": "hedge_p99", "qos": "least_loaded"}[kind]
    kw = {"ttft_slo": 0.1} if kind == "hedge" else {}
    router = rmod.RequestRouter(reps, policy=policy, clock=clock, qos=reg,
                                **kw)
    akw = dict(prompt_len=96, max_new=32)
    if kind == "prefix":
        akw.update(prefix_share=0.6, prefix_len=64, n_prefix_groups=4)
    if kind == "qos":
        akw["tenants"] = {"gold": 0.4, "silver": 0.35, "bronze": 0.25}
    batch = sim.poisson_arrival_batch(45.0, n=1500, seed=23, **akw)
    rep = sim.run_router_day_fast(router, batch)
    return ({"digest": rep.digest(), "path": rep.fastpath,
             "outcomes": dict(rep.outcomes), "hedges": router.n_hedges,
             "ticks": [r.tick_count for r in reps],
             "busy": [r.busy_s for r in reps]},
            batch)


@pytest.mark.parametrize("kind", ["plain", "prefix", "hedge", "qos"])
def test_fast_driver_equal_in_both_packages(kind):
    (port, pb), (ref, jb) = _xfast("port", kind), _xfast("jax", kind)
    assert port == ref
    assert port["path"] == "vectorized"
    for a, b in zip(pb, jb):
        assert (a.t, a.prompt.length, a.prompt.prefix, a.max_new,
                a.tenant) == (b.t, b.prompt.length, b.prompt.prefix,
                              b.max_new, b.tenant)
