"""Elastic fleet control in the port (``fleet/``): closed-loop
autoscaling, sim-in-the-loop re-coding, and coordinator failover.

The contract is ``tests/test_fleet.py``: its cases run here on the
port's copies with the same bounds, the pool-plane legs over the port's
``ProcessBackend`` and ``NativeProcessBackend`` with spawned workers.
Then the cross-package checks: one elastic day with a coordinator kill
gives the same report digest and the same decision records in the JAX
package and in the port, and so do a re-coding resize and a re-policy
resize. Tolerance: none.

Three layers, all on VirtualClock (the controller reads only its
injected clock, so every scenario here replays bit-identically):

* **signals** — the deterministic rate estimator, the one
  replica-capacity formula, live-gauge snapshots, and fleet-resize
  model extrapolation, each with its refusal contract;
* **controller** — hysteresis bands (dwell/cooldown), zero-drop shrink
  through the router's eject/re-route path, the operator
  ``resize_to``/``FleetResize`` event path, re-coding via
  ``sweep_hierarchical`` (agree flag, decision budget fallback,
  refusal-by-name propagation) and re-policy via
  ``sweep_router_policy`` (structural policies never switched);
* **failover** — coded-checkpoint state round trips, the
  active/standby supervisor surviving a mid-day ``CoordinatorKill``
  with zero drops and a bit-identical replay, and the POOL-plane leg
  on a real ``ProcessBackend``: the standby adopts the living worker
  processes and the ``repochs`` history is continuous across the
  handoff (no epoch lost), with the takeover named in the flight dump.
"""

import importlib
import os
from types import SimpleNamespace

import numpy as np
import pytest

from mpistragglers_jl_tpu_torch import (
    AsyncPool,
    LocalBackend,
    ProcessBackend,
    asyncmap,
    waitall,
)
from mpistragglers_jl_tpu_torch.fleet import (
    ArrivalRateEstimator,
    ControllerSupervisor,
    FleetCheckpointer,
    FleetController,
    PoolScaler,
    adopt_pool,
    capture_pool,
    fleet_signals,
    replica_capacity_rps,
    resized_model,
    restore_pool,
)
from mpistragglers_jl_tpu_torch.models.router import RequestRouter
from mpistragglers_jl_tpu_torch.obs import FlightRecorder, MetricsRegistry
from mpistragglers_jl_tpu_torch.sim import (
    CoordinatorKill,
    FleetResize,
    SimPrompt,
    SimReplica,
    VirtualClock,
    diurnal_arrivals,
    lognormal_ticks,
    poisson_arrivals,
    run_router_day,
)
from mpistragglers_jl_tpu_torch.utils.straggle import PoolLatencyModel

# the one fleet shape every test here sizes against: slots=2 decode
# rows, n_inner=4 tokens per decode tick, 0.25 s ticks — small enough
# that a full diurnal day is a few thousand requests
SLOTS, NI, TICK, PLEN, CHUNK, MNEW = 2, 4, 0.25, 64, 64, 16
CAP = replica_capacity_rps(
    slots=SLOTS, n_inner=NI, tick_s=TICK, prompt_len=PLEN,
    prompt_chunk=CHUNK, max_new=MNEW,
)


def _fleet(n=4, *, jitter=0.0, clock=None):
    clock = VirtualClock() if clock is None else clock
    reps = [
        SimReplica(
            clock, slots=SLOTS, n_inner=NI, prompt_chunk=CHUNK,
            tick_s=(
                lognormal_ticks(TICK, jitter, seed=1009 + i)
                if jitter else TICK
            ),
        )
        for i in range(n)
    ]
    router = RequestRouter(reps, policy="least_loaded", clock=clock)
    return clock, reps, router


def _controller(router, clock, **kw):
    kw.setdefault("capacity_rps", CAP)
    kw.setdefault("min_replicas", 1)
    kw.setdefault("decision_interval_s", 10.0)
    return FleetController(router, clock=clock, **kw)


def _fitted_model(n=NI, seed=5):
    model = PoolLatencyModel(n, seed=0)
    rng = np.random.default_rng(seed)
    for _ in range(40):
        for w in range(n):
            model.observe(
                w, 0.01 * (1 + 0.3 * w) * float(rng.lognormal(0, 0.3))
            )
    return model


# --------------------------------------------------------------------------
# signals
# --------------------------------------------------------------------------


class TestSignals:
    def test_rate_estimator_tracks_constant_rate(self):
        est = ArrivalRateEstimator(10.0)
        for k in range(1, 1201):  # 20/s for 60 s = 6 tau
            est.observe(k * 0.05)
        assert est.rate(60.0) == pytest.approx(20.0, rel=0.05)

    def test_rate_estimator_warmup_debias(self):
        # after only tau/2 seconds, the raw decayed count has reached
        # ~39% of settled — the debiased estimate is already usable
        est = ArrivalRateEstimator(20.0)
        for k in range(1, 201):  # 20/s for 10 s
            est.observe(k * 0.05)
        raw = est.count / est.tau_s
        assert raw < 0.5 * 20.0  # the bias the divisor removes
        assert est.rate(10.0) == pytest.approx(20.0, rel=0.15)

    def test_rate_estimator_tracks_a_swing_down(self):
        est = ArrivalRateEstimator(5.0, t0=0.0)
        t = 0.0
        for _ in range(200):  # 20/s
            t += 0.05
            est.observe(t)
        for _ in range(40):  # then 2/s for 4 tau
            t += 0.5
            est.observe(t)
        assert est.rate(t) == pytest.approx(2.0, rel=0.25)

    def test_rate_estimator_state_roundtrip_and_refusal(self):
        est = ArrivalRateEstimator(7.5, t0=3.0)
        for k in range(50):
            est.observe(3.0 + k * 0.1)
        clone = ArrivalRateEstimator(1.0)
        clone.load_state_dict(est.state_dict())
        assert clone.rate(10.0) == est.rate(10.0)
        with pytest.raises(ValueError, match="tau_s"):
            ArrivalRateEstimator(0.0)

    def test_replica_capacity_is_the_sweep_arithmetic(self):
        # the identical slot-holding-ticks formula sweep_router_policy
        # sizes offered load with: ceil(prompt/chunk) prefill ticks +
        # ceil((max_new-1)/n_inner) decode ticks per request
        ticks = (
            -(-PLEN // CHUNK) + -(-(MNEW - 1) // NI)
        )
        assert CAP == pytest.approx(SLOTS / (ticks * TICK))

    def test_replica_capacity_refusals(self):
        with pytest.raises(ValueError, match=">= 1"):
            replica_capacity_rps(
                slots=0, n_inner=NI, tick_s=TICK, prompt_len=PLEN,
                prompt_chunk=CHUNK, max_new=MNEW,
            )
        with pytest.raises(ValueError, match="tick_s"):
            replica_capacity_rps(
                slots=SLOTS, n_inner=NI, tick_s=0.0, prompt_len=PLEN,
                prompt_chunk=CHUNK, max_new=MNEW,
            )

    def test_resized_model_cycles_fits(self):
        model = _fitted_model(3)
        grown = resized_model(model, 7)
        assert grown.n_workers == 7
        # rank j is priced like fitted rank j % 3 — a fresh worker
        # never simulates as infinitely fast
        for j in range(7):
            # priced like fitted rank j % 3, but an independent COPY
            # (review regression: aliasing let observes into the twin
            # corrupt the live fits)
            assert grown.workers[j] is not model.workers[j % 3]
            assert (
                grown.workers[j].to_dict()
                == model.workers[j % 3].to_dict()
            )
        with pytest.raises(ValueError, match="fitted"):
            resized_model(PoolLatencyModel(0), 4)
        with pytest.raises(ValueError, match=">= 1"):
            resized_model(model, 0)

    def test_resized_model_fits_are_independent(self):
        """Review regression: resized_model used to ALIAS the live
        model's mutable fits (the same object at several indices), so
        observing into the twin corrupted the live fits."""
        model = _fitted_model(4)
        before = (model.workers[0].count, model.workers[0].mean)
        out = resized_model(model, 8)
        out.observe(0, 5.0)
        out.observe(4, 5.0)  # cycled index of the same source fit
        assert (model.workers[0].count, model.workers[0].mean) == before
        assert out.workers[0].count == before[0] + 1
        assert out.workers[4].count == before[0] + 1

    def test_fleet_signals_snapshot(self):
        clock, reps, router = _fleet(3)
        est = ArrivalRateEstimator(10.0)
        for k in range(1, 101):
            est.observe(k * 0.1)  # 10/s
        for _ in range(4):
            router.submit(SimPrompt(PLEN), MNEW)
        sig = fleet_signals(
            router, est, 10.0, provisioned=3, capacity_rps=CAP,
        )
        assert sig.queue_depth == 4
        assert sig.routable == 3
        assert sig.depth_per_replica == pytest.approx(4 / 3)
        assert sig.utilization == pytest.approx(
            est.rate(10.0) / (3 * CAP)
        )
        assert set(sig.to_dict()) == {
            "t", "rate_rps", "provisioned", "routable", "queue_depth",
            "utilization",
        }


# --------------------------------------------------------------------------
# controller: hysteresis, zero-drop shrink, operator resizes
# --------------------------------------------------------------------------


def _pump_arrivals(ctl, clock, rate, seconds):
    """Feed a constant-rate arrival stamp stream and step the
    controller on its cadence (no data plane — signal-path tests)."""
    t0 = clock.now()
    dt = 1.0 / rate
    t = t0
    decisions = []
    while t < t0 + seconds:
        t += dt
        clock.run_until(t)
        ctl.observe_arrival(t)
        d = ctl.step()
        if d is not None:
            decisions.append(d)
    return decisions


class TestController:
    def test_constructor_refusals(self):
        clock, reps, router = _fleet(3)
        with pytest.raises(ValueError, match="capacity_rps"):
            _controller(router, clock, capacity_rps=0.0)
        with pytest.raises(ValueError, match="min_replicas"):
            _controller(router, clock, min_replicas=3, max_replicas=2)
        with pytest.raises(ValueError, match="min_replicas"):
            _controller(router, clock, max_replicas=9)
        with pytest.raises(ValueError, match="hysteresis"):
            _controller(router, clock, low=0.9, high=0.8)
        with pytest.raises(ValueError, match="decision_interval_s"):
            _controller(router, clock, decision_interval_s=0.0)
        # review regression: 'load'/'n_replicas' are computed by the
        # controller at each resize — passing them in policy_sweep
        # used to construct cleanly and TypeError at the FIRST
        # accepted resize, mid-run
        with pytest.raises(ValueError, match="computed by the"):
            _controller(
                router, clock,
                policy_sweep=dict(load=0.6, requests=50),
            )
        with pytest.raises(ValueError, match="computed by the"):
            _controller(
                router, clock, policy_sweep=dict(n_replicas=4),
            )

    def test_grows_on_sustained_high_util(self):
        clock, reps, router = _fleet(4)
        ctl = _controller(
            router, clock, min_replicas=2, high=0.8, low=0.3,
            dwell_s=30.0,
        )
        ctl.resize_to(2, reason="seed")  # start small
        assert ctl.size == 2
        # offered load ~ 1.5x the 2-replica fleet: sustained breach
        decisions = _pump_arrivals(ctl, clock, 1.5 * 2 * CAP, 120.0)
        grows = [d for d in decisions if d.action == "grow"]
        assert grows, decisions
        assert ctl.size > 2
        assert grows[0].reason == "util_high"
        # the grown replicas are routable again
        assert len(router.routable_replicas) == ctl.size

    def test_dwell_requires_sustained_breach(self):
        clock, reps, router = _fleet(4)
        ctl = _controller(
            router, clock, min_replicas=2, high=0.8, low=0.3,
            dwell_s=1e6,  # effectively never satisfied
        )
        ctl.resize_to(2, reason="seed")
        decisions = _pump_arrivals(ctl, clock, 1.5 * 2 * CAP, 120.0)
        assert [d for d in decisions if d.action == "grow"] == []

    def test_shrinks_on_sustained_low_util(self):
        clock, reps, router = _fleet(4)
        ctl = _controller(
            router, clock, min_replicas=1, high=0.9, low=0.5,
            dwell_s=30.0,
        )
        decisions = _pump_arrivals(ctl, clock, 0.25 * 4 * CAP, 200.0)
        shrinks = [d for d in decisions if d.action == "shrink"]
        assert shrinks and ctl.size < 4
        assert shrinks[0].reason == "util_low"
        # shrink drains from the HIGHEST index; the controller's
        # intent is re-assertable (mark_down, not kill)
        assert shrinks[0].moved[0] == 3

    def test_cooldown_blocks_consecutive_resizes(self):
        clock, reps, router = _fleet(8)
        ctl = _controller(
            router, clock, min_replicas=1, high=0.9, low=0.5,
            dwell_s=0.0, cooldown_s=1e5,
        )
        decisions = _pump_arrivals(ctl, clock, 0.2 * 8 * CAP, 300.0)
        assert len(decisions) == 1  # the second shrink sits in cooldown

    def test_depth_trigger_grows(self):
        clock, reps, router = _fleet(3)
        ctl = _controller(
            router, clock, min_replicas=1, high=1e9,  # util never
            low=0.001, target_util=0.6, depth_high=2.0, dwell_s=0.0,
        )
        ctl.resize_to(1, reason="seed")
        for _ in range(9):  # depth 9 on one replica
            router.submit(SimPrompt(PLEN), MNEW)
        # rate high enough that target sizing wants more than 1
        for k in range(1, 200):
            ctl.observe_arrival(clock.now() + k * 0.02)
        clock.advance(10.0)
        d = ctl.step()
        assert d is not None and d.action == "grow"
        assert d.reason == "depth_high"

    def test_zero_drop_shrink_drains_in_flight(self):
        # requests in flight on the drained replica restart on the
        # survivors — the router's eject/re-route path, driven by the
        # controller instead of a health flip
        clock, reps, router = _fleet(2)
        ctl = _controller(router, clock, min_replicas=1)
        rrs = [router.submit(SimPrompt(PLEN), MNEW) for _ in range(4)]
        on_1 = [rr for rr in rrs if rr.replica == 1]
        assert on_1  # least_loaded spread them
        ctl.resize_to(1, reason="drain-test")
        while router.in_flight:
            nt = router.next_event_at()
            assert nt is not None
            clock.run_until(nt)
            router.step()
        assert all(rr.finished for rr in rrs)
        assert all(rr.rerouted >= 1 for rr in on_1)
        assert router.n_rerouted >= len(on_1)

    def test_hysteresis_grow_blocked_is_named_not_silent(self):
        """Review regression: a hysteresis grow with nothing
        restorable (a replica dead at construction) used to silently
        no-op every cadence — no decision, no telemetry. It now names
        the stall once per onset and resumes when a drain makes a
        replica restorable again."""
        clock = VirtualClock()
        reps = [
            SimReplica(clock, slots=SLOTS, n_inner=NI,
                       prompt_chunk=CHUNK, tick_s=TICK)
            for _ in range(3)
        ]
        reps[2].kill()  # dead before the controller was built
        router = RequestRouter(reps, policy="least_loaded",
                               clock=clock)
        reg = MetricsRegistry()
        flight = FlightRecorder()
        ctl = _controller(
            router, clock, min_replicas=1, dwell_s=0.0,
            registry=reg, flight=flight,
        )
        assert ctl.size == 2
        decisions = _pump_arrivals(ctl, clock, 3 * 2 * CAP, 100.0)
        assert decisions == []  # nothing restorable: no resize
        assert ctl.size == 2
        # onset-counted: one named stall, not one per cadence
        assert ctl.n_grow_blocked == 1
        assert reg.counter("fleet_grow_blocked_total").value == 1
        names = [
            e.get("name") for e in flight.snapshot()["traceEvents"]
        ]
        assert names.count("fleet grow blocked") == 1
        # a drain re-arms the edge trigger: shrink, then overload again
        ctl.resize_to(1, reason="operator")
        grows = [
            d for d in _pump_arrivals(ctl, clock, 3 * 2 * CAP, 100.0)
            if d.action == "grow"
        ]
        assert grows and ctl.size == 2  # grew back to the restorable 2
        assert ctl.n_grow_blocked == 2  # then stalled again, by name

    def test_resize_to_refuses_outside_range(self):
        clock, reps, router = _fleet(4)
        ctl = _controller(router, clock, min_replicas=2)
        with pytest.raises(ValueError, match="elastic range"):
            ctl.resize_to(1)
        with pytest.raises(ValueError, match="elastic range"):
            ctl.resize_to(5)
        assert ctl.resize_to(4) is None  # already there: no decision
        d = ctl.resize_to(2, reason="operator")
        assert d.action == "shrink" and d.reason == "operator"
        assert d.size_before == 4 and d.size_after == 2
        assert ctl.chip_seconds(clock.now()) == pytest.approx(0.0)

    def test_chip_seconds_books(self):
        clock, reps, router = _fleet(4)
        ctl = _controller(router, clock, min_replicas=1)
        clock.advance(100.0)
        assert ctl.chip_seconds() == pytest.approx(400.0)
        ctl.resize_to(1)
        clock.advance(50.0)
        # 4 replicas x 100 s + 1 replica x 50 s
        assert ctl.chip_seconds() == pytest.approx(450.0)

    def test_decision_record_shape(self):
        clock, reps, router = _fleet(3)
        ctl = _controller(router, clock, min_replicas=1)
        d = ctl.resize_to(1, reason="operator")
        rec = d.to_dict()
        assert rec["action"] == "shrink"
        assert rec["size"] == [3, 1]
        assert rec["moved"] == [2, 1]
        assert rec["signal"]["provisioned"] == 3
        assert d.seq == 0 and ctl.n_resizes == 1


# --------------------------------------------------------------------------
# re-code on resize: the sweeps are the decision procedure
# --------------------------------------------------------------------------


class TestRecode:
    def _ctl(self, router, clock, **over):
        cfg = dict(
            model=_fitted_model(), n_inner=NI,
            candidates=[(1.0, 2), (1.0, 3), (0.75, 3)],
            inner_floor=2, epochs=10,
        )
        cfg.update(over.pop("recode", {}))
        return _controller(
            router, clock, min_replicas=1, recode=cfg, **over,
        )

    def test_recode_on_resize_records_the_agree_flag(self):
        clock, reps, router = _fleet(4)
        ctl = self._ctl(router, clock)
        d = ctl.resize_to(2)
        rc = d.recode
        assert rc is not None and rc["fallback"] is False
        assert isinstance(rc["agree"], bool)
        assert rc["pair"][1] == rc["inner_sim"]
        assert rc["sweep_digest"] and len(rc["sweep_digest"]) == 12
        assert ctl.code_pair == tuple(rc["pair"])
        # deterministic: the same resize re-derives the same pair
        ctl2 = self._ctl(_fleet(4)[2], clock)
        assert ctl2.resize_to(2).recode == rc

    def test_budget_overrun_falls_back_to_the_model(self):
        clock, reps, router = _fleet(4)
        ctl = self._ctl(router, clock, decision_budget=5)  # 3*10 > 5
        d = ctl.resize_to(2)
        rc = d.recode
        assert rc["fallback"] is True and rc["agree"] is None
        assert rc["budget_cost"] == 30 and rc["budget"] == 5
        # the analytic cross-check IS the decision: optimal_nwait over
        # the resized model, never below the floor
        sub = resized_model(_fitted_model(), NI)
        assert rc["pair"][1] == sub.optimal_nwait(kmin=2, kmax=NI)

    def test_infeasible_candidate_refused_by_name(self):
        clock, reps, router = _fleet(4)
        ctl = self._ctl(
            router, clock,
            recode=dict(candidates=[(1.0, 1)], inner_floor=2),
        )
        with pytest.raises(ValueError, match="decodability floor"):
            ctl.resize_to(2)

    def test_repolicy_applies_the_swept_winner(self):
        clock, reps, router = _fleet(4, jitter=0.2)
        ctl = _controller(
            router, clock, min_replicas=1,
            policy_sweep=dict(
                requests=200, slots=SLOTS, n_inner=NI, tick_s=TICK,
                prompt_len=PLEN, prompt_chunk=CHUNK, max_new=MNEW,
                seed=11,
            ),
        )
        for k in range(1, 400):
            ctl.observe_arrival(k * 0.02)
        clock.run_until(8.0)
        d = ctl.resize_to(3)
        pol = d.policy
        assert pol is not None and "sweep_digest" in pol
        assert 0.05 <= pol["load"] <= 0.95
        assert router.policy == pol["best"]
        if pol["best"] != "least_loaded":
            assert pol.get("applied") is True

    def test_structural_policy_never_switched(self):
        clock = VirtualClock()
        reps = [
            SimReplica(clock, slots=SLOTS, n_inner=NI,
                       prompt_chunk=CHUNK, tick_s=TICK)
            for i in range(3)
        ]
        router = RequestRouter(
            reps, policy="hedge_p99", ttft_slo=5.0, clock=clock,
        )
        ctl = _controller(
            router, clock, min_replicas=1,
            policy_sweep=dict(requests=100),
        )
        d = ctl.resize_to(2)
        assert d.policy["kept"] == "hedge_p99"
        assert "structural" in d.policy["refused"]
        assert router.policy == "hedge_p99"

    def test_set_policy_relabels_completion_series(self):
        """Review regression: after a mid-run switch the obs bundle's
        cached policy label (and its per-(replica, outcome) series
        cache) roll over — completions land under the policy that
        routed them, not the construction-time one."""
        reg = MetricsRegistry()
        clock = VirtualClock()
        reps = [
            SimReplica(clock, slots=SLOTS, n_inner=NI,
                       prompt_chunk=CHUNK, tick_s=TICK)
        ]
        router = RequestRouter(reps, policy="round_robin",
                               clock=clock, registry=reg)

        def one_request():
            rr = router.submit(SimPrompt(PLEN), MNEW)
            while not rr.finished:
                clock.run_until(router.next_event_at())
                router.step()

        one_request()
        router.set_policy("least_loaded")
        one_request()
        by_policy = {}
        for s in reg.snapshot()["router_requests_total"]["series"]:
            key = s["labels"]["policy"]
            by_policy[key] = by_policy.get(key, 0) + s["value"]
        assert by_policy == {"round_robin": 1.0, "least_loaded": 1.0}

    def test_router_set_policy_contract(self):
        clock, reps, router = _fleet(2)
        router.set_policy("round_robin")
        assert router.policy == "round_robin"
        router.set_policy("round_robin")  # no-op
        with pytest.raises(ValueError, match="unknown policy"):
            router.set_policy("fastest_wins")
        with pytest.raises(ValueError, match="structural"):
            router.set_policy("hedge_p99")
        hr = RequestRouter(
            [SimReplica(VirtualClock())], policy="hedge_p99",
            ttft_slo=1.0, clock=VirtualClock(),
        )
        with pytest.raises(ValueError, match="structural"):
            hr.set_policy("least_loaded")


# --------------------------------------------------------------------------
# the simulated day: autoscale + kill, bit-identical, zero drops
# --------------------------------------------------------------------------

PERIOD = 1800.0
PEAK_UTIL = 0.675
N_FLEET = 6


def _day(seed, *, kill_at=None, tmp, n_requests=None, forced=()):
    clock, reps, router = _fleet(N_FLEET, jitter=0.2)
    ck = FleetCheckpointer(os.path.join(tmp, f"ck{seed}"), n=5, k=3)
    peak = N_FLEET * CAP * PEAK_UTIL
    mean_rate = peak / 1.5  # amplitude 0.5: a 3x diurnal swing
    n = (
        int(mean_rate * PERIOD * 0.97)
        if n_requests is None else n_requests
    )

    def mk():
        return FleetController(
            router, clock=clock, capacity_rps=CAP, min_replicas=2,
            max_replicas=N_FLEET, high=0.85, low=0.5,
            decision_interval_s=15.0, dwell_s=30.0, cooldown_s=60.0,
            rate_tau_s=120.0, checkpointer=ck,
            checkpoint_every_s=90.0,
        )

    sup = ControllerSupervisor(mk, clock=clock, takeover_s=30.0)
    events = list(forced)
    if kill_at is not None:
        events.append(CoordinatorKill(kill_at))
    report = run_router_day(
        router,
        diurnal_arrivals(
            mean_rate, n=n, period=PERIOD, amplitude=0.5, seed=seed,
            prompt_len=PLEN, max_new=MNEW,
        ),
        controller=sup,
        events=events,
    )
    return report, sup, router


class TestElasticDay:
    def test_day_with_kill_zero_drops_and_bit_identical(self, tmp_path):
        """The acceptance scenario: a 3x diurnal swing, one
        coordinator kill mid-day — zero dropped requests, the fleet
        resizes with the day, the standby adopts, and two replays of
        the same seed agree on the digest AND the decision records."""
        kill = PERIOD * 0.45
        r1, s1, _ = _day(3, kill_at=kill, tmp=str(tmp_path))
        r2, s2, _ = _day(3, kill_at=kill, tmp=str(tmp_path / "b"))
        assert r1.dropped == 0
        assert r1.n_failovers == 1 and s1.n_kills == 1
        assert r1.n_resizes >= 2  # the swing actually moved the fleet
        assert r1.digest() == r2.digest()
        assert [d.to_dict() for d in s1.decisions] == [
            d.to_dict() for d in s2.decisions
        ]
        assert r1.n_resizes == r2.n_resizes

    def test_elastic_day_beats_static_peak_chip_time(self, tmp_path):
        r, sup, _ = _day(7, tmp=str(tmp_path))
        assert r.dropped == 0 and r.n_resizes >= 2
        elastic = sup.chip_seconds(r.virtual_s)
        static = N_FLEET * r.virtual_s
        assert static / elastic > 1.15, (elastic, static)

    def test_decisions_stop_while_the_coordinator_is_dead(
        self, tmp_path
    ):
        kill = PERIOD * 0.45
        r, sup, _ = _day(3, kill_at=kill, tmp=str(tmp_path))
        # the supervisor's takeover stamp: no decision lands inside
        # (kill, kill + takeover_s)
        for d in sup.decisions:
            assert not (kill < d.t < kill + 30.0 - 1e-9)

    def test_dead_coordinator_refusals(self, tmp_path):
        clock, reps, router = _fleet(2)
        ck = FleetCheckpointer(tmp_path, n=4, k=2)
        sup = ControllerSupervisor(
            lambda: _controller(
                router, clock, min_replicas=1, checkpointer=ck,
                checkpoint_every_s=5.0,
            ),
            clock=clock,
            takeover_s=10.0,
        )
        sup.kill()
        sup.kill()  # idempotent while dead
        assert sup.n_kills == 1
        with pytest.raises(RuntimeError, match="dead"):
            sup.chip_seconds()
        assert sup.decisions == []
        # a supervised controller without a checkpoint channel is
        # refused at construction: a standby cannot adopt state
        # nobody saved
        with pytest.raises(ValueError, match="checkpointer"):
            ControllerSupervisor(
                lambda: _controller(router, clock, min_replicas=1),
                clock=clock,
            )

    def test_controller_presence_does_not_perturb_the_data_plane(
        self, tmp_path
    ):
        """Digest stability: the same day with a controller whose
        bands never trigger hashes identically to the bare day — the
        control plane observes; only accepted resizes act."""
        clock, reps, router = _fleet(3, jitter=0.2)
        arr = lambda: poisson_arrivals(  # noqa: E731
            0.5 * 3 * CAP, n=600, seed=9, prompt_len=PLEN,
            max_new=MNEW,
        )
        bare = run_router_day(router, arr())
        clock2, reps2, router2 = _fleet(3, jitter=0.2)
        ctl = FleetController(
            router2, clock=clock2, capacity_rps=CAP, min_replicas=3,
            max_replicas=3, high=0.99, low=0.01,
            decision_interval_s=10.0,
        )
        watched = run_router_day(router2, arr(), controller=ctl)
        assert bare.digest() == watched.digest()
        assert watched.n_resizes == 0 and bare.n_resizes == 0

    def test_fleet_resize_event_forces_the_size(self, tmp_path):
        r, sup, router = _day(
            5, tmp=str(tmp_path), n_requests=800,
            forced=(FleetResize(20.0, 2, reason="operator"),),
        )
        assert r.dropped == 0
        ops = [d for d in sup.decisions if d.reason == "operator"]
        assert ops and ops[0].size_after == 2

    def test_event_refusals(self):
        clock, reps, router = _fleet(2)
        with pytest.raises(ValueError, match="no controller"):
            run_router_day(
                router,
                poisson_arrivals(1.0, n=5, seed=0, prompt_len=PLEN,
                                 max_new=MNEW),
                events=[FleetResize(0.5, 1)],
            )
        clock, reps, router = _fleet(2)
        ctl = _controller(router, clock, min_replicas=1)
        with pytest.raises(ValueError, match="supervised"):
            run_router_day(
                router,
                poisson_arrivals(1.0, n=5, seed=0, prompt_len=PLEN,
                                 max_new=MNEW),
                controller=ctl,
                events=[CoordinatorKill(0.5)],
            )

    def test_stalled_day_fails_by_name_with_controller_attached(self):
        """Review regression: a controller's decision cadence is
        always pending, which used to make the drain loop's stall
        guard unreachable — a day whose every replica dies (killed,
        not controller-drained, so grow can never restore them) must
        still fail by name instead of spinning forever."""
        clock, reps, router = _fleet(2)
        ctl = _controller(router, clock, min_replicas=1)
        # the kill lands AFTER the last arrival but before the decode
        # budget completes: in-flight requests freeze as orphans with
        # no routable replica to re-route onto
        clock.call_at(1.0, lambda: [r.kill() for r in reps])
        with pytest.raises(RuntimeError, match="stalled"):
            run_router_day(
                router,
                poisson_arrivals(4.0, n=3, seed=0, prompt_len=PLEN,
                                 max_new=MNEW),
                controller=ctl,
            )

    def test_decision_seqs_unique_across_incarnations(self, tmp_path):
        """Review regression: decisions accepted after the last
        checkpoint keep their seqs in the carried record, so the
        adopting standby's counter is bumped past them — the whole-day
        decision log never holds two records with one seq."""
        clock, reps, router = _fleet(4)
        ck = FleetCheckpointer(tmp_path, n=4, k=2)
        sup = ControllerSupervisor(
            lambda: _controller(
                router, clock, min_replicas=1, checkpointer=ck,
                checkpoint_every_s=1e6,  # only the zeroth checkpoint
            ),
            clock=clock,
            takeover_s=5.0,
        )
        # two decisions AFTER the only checkpoint: seqs 0, 1 carried
        sup.active.resize_to(2)
        sup.active.resize_to(3)
        sup.kill()
        clock.advance(10.0)
        sup.step()  # adopt: restored _seq=0, bumped past the carried
        d = sup.active.resize_to(2)
        assert d is not None
        seqs = [dd.seq for dd in sup.decisions]
        assert seqs == [0, 1, 2]

    def test_workload_report_counters_without_controller(self):
        clock, reps, router = _fleet(2)
        rep = run_router_day(
            router,
            poisson_arrivals(1.0, n=10, seed=0, prompt_len=PLEN,
                             max_new=MNEW),
        )
        assert rep.n_resizes == 0 and rep.n_failovers == 0


# --------------------------------------------------------------------------
# controller state: checkpoint round trip + standby adoption
# --------------------------------------------------------------------------


class TestControllerCheckpoint:
    def test_state_dict_roundtrip(self, tmp_path):
        clock, reps, router = _fleet(4)
        ck = FleetCheckpointer(tmp_path, n=5, k=3)
        ctl = _controller(
            router, clock, min_replicas=1, checkpointer=ck,
        )
        for k in range(1, 120):
            ctl.observe_arrival(k * 0.05)
        clock.run_until(6.0)
        ctl.resize_to(2)
        for _ in range(3):
            router.submit(SimPrompt(PLEN), MNEW)
        ctl.checkpoint()
        state = ck.restore()
        assert [bool(b) for b in state["provisioned"]] == [
            True, True, False, False,
        ]
        assert int(state["book_awaiting"].sum()) == 3
        assert state["inflight_ids"].size == 3
        # a fresh controller on the same router adopts the state
        standby = _controller(
            router, clock, min_replicas=1, checkpointer=ck,
        )
        standby.load_state(state, adopted=True)
        assert standby.size == 2
        assert standby.n_failovers == 1
        assert standby.n_resizes == ctl.n_resizes
        assert standby.estimator.state_dict() == (
            ctl.estimator.state_dict()
        )
        # the restored intent was re-asserted onto the router (the
        # health flip lands at the next step()'s probe, as always)
        router.step()
        assert router.routable_replicas == [0, 1]

    def test_adoption_refuses_a_mismatched_fleet(self, tmp_path):
        clock, reps, router = _fleet(4)
        ck = FleetCheckpointer(tmp_path, n=5, k=3)
        ctl = _controller(router, clock, checkpointer=ck)
        ctl.checkpoint()
        clock2, reps2, router2 = _fleet(3)
        standby = _controller(router2, clock2, min_replicas=1)
        with pytest.raises(ValueError, match="4 replicas"):
            standby.load_state(ck.restore(), adopted=True)

    def test_checkpoint_without_checkpointer_refused(self):
        clock, reps, router = _fleet(2)
        ctl = _controller(router, clock)
        with pytest.raises(ValueError, match="checkpointer"):
            ctl.checkpoint()
        # the cadence-without-channel pairing is refused at
        # CONSTRUCTION, not at the first due step mid-run
        with pytest.raises(ValueError, match="checkpoint_every_s"):
            _controller(router, clock, checkpoint_every_s=10.0)

    def test_kill_before_first_cadence_still_adopts(self, tmp_path):
        """Review regression: the supervisor writes a zeroth
        checkpoint at construction, so a kill BEFORE the first
        checkpoint cadence leaves the standby the construction-time
        state to adopt instead of crashing on an empty directory."""
        clock, reps, router = _fleet(3)
        ck = FleetCheckpointer(tmp_path, n=4, k=2)
        sup = ControllerSupervisor(
            lambda: _controller(
                router, clock, min_replicas=1, checkpointer=ck,
                checkpoint_every_s=1e6,  # cadence never fires
            ),
            clock=clock,
            takeover_s=5.0,
        )
        assert ck.n_saves == 1  # the zeroth checkpoint
        sup.kill()
        clock.advance(10.0)
        sup.step()  # the standby adopts
        assert sup.active is not None
        assert sup.n_failovers == 1
        assert sup.active.size == 3

    def test_grow_never_revives_construction_dead_replicas(self):
        """Review regression: a replica dead BEFORE the controller was
        built is not the controller's to bring back — grow restores
        only controller-drained replicas."""
        clock = VirtualClock()
        reps = [
            SimReplica(clock, slots=SLOTS, n_inner=NI,
                       prompt_chunk=CHUNK, tick_s=TICK)
            for _ in range(4)
        ]
        reps[3].kill()  # an operator took it down pre-construction
        router = RequestRouter(reps, policy="least_loaded",
                               clock=clock)
        ctl = _controller(router, clock, min_replicas=1)
        assert ctl.size == 3
        ctl.resize_to(2)  # drains replica 2
        d = ctl.resize_to(3)  # restores replica 2, NOT replica 3
        assert d.moved == [2]
        assert not reps[3].alive
        assert not ctl._provisioned[3]
        # asking beyond the drainable pool is refused by name, not
        # silently no-opped (review regression: the in-range grow used
        # to return None with no decision and no refusal)
        with pytest.raises(ValueError, match="restorable"):
            ctl.resize_to(4)
        assert ctl.size == 3 and not reps[3].alive


# --------------------------------------------------------------------------
# pool plane: capture/adopt + the elastic pair on a real ProcessBackend
# --------------------------------------------------------------------------


def _echo(i, payload, epoch):
    return np.array([float(i + 1), float(payload[0]), float(epoch)])


class _SlowWorker:
    """Picklable: one designated straggler, the rest fast."""

    def __init__(self, slow_rank, slow=0.4, fast=0.002):
        self.slow_rank, self.slow, self.fast = slow_rank, slow, fast

    def __call__(self, i, epoch):
        return self.slow if i == self.slow_rank else self.fast


class TestPoolPlane:
    def test_pool_carry_semantics(self):
        pool = AsyncPool(4, nwait=3)
        backend = LocalBackend(_echo, 4)
        try:
            for _ in range(3):
                asyncmap(pool, np.ones(1), backend, nwait=4)
            waitall(pool, backend)
        finally:
            backend.shutdown()
        carried = pool.carry([0, 1, 2, 5])
        assert carried.epoch == pool.epoch
        assert carried.nwait == 3
        for j in range(3):  # survivors keep their books
            assert carried.repochs[j] == pool.repochs[j]
            assert carried.results[j] is pool.results[j]
        # the joiner is never-heard-from: stale until it answers
        assert carried.repochs[3] == carried.epoch0
        assert carried.results[3] is None
        assert not carried.active[3]
        # nwait clamps into the shrunk range by default
        assert pool.carry([0, 1]).nwait == 2

    def test_capture_restore_roundtrip_and_kind_refusal(self):
        pool = AsyncPool(3, nwait=2)
        backend = LocalBackend(_echo, 3)
        try:
            for _ in range(4):
                asyncmap(pool, np.ones(1), backend, nwait=2)
            state = capture_pool(pool)
            clone = restore_pool(state)
            assert clone.epoch == pool.epoch
            np.testing.assert_array_equal(clone.repochs, pool.repochs)
            np.testing.assert_array_equal(clone.active, pool.active)
            for a, b in zip(clone.results, pool.results):
                if b is None:
                    assert a is None
                else:
                    np.testing.assert_array_equal(a, b)
            # the clone continues on the LIVING backend
            asyncmap(clone, np.ones(1), backend, nwait=2)
            waitall(clone, backend)
        finally:
            backend.shutdown()
        with pytest.raises(ValueError, match="not a pool checkpoint"):
            restore_pool({"kind": "weights"})

    def test_process_backend_coordinator_failover_no_epoch_lost(
        self, tmp_path
    ):
        """The acceptance failover leg: a real ProcessBackend fleet,
        the coordinator dies mid-run WITH a dispatch in flight, the
        standby adopts the worker processes through the coded
        checkpoint — the in-flight result is harvested (fresh or
        stale-then-retask), ``repochs`` history is continuous across
        the handoff, and the flight dump names the takeover."""
        backend = ProcessBackend(
            _echo, 3, delay_fn=_SlowWorker(2),
        )
        ck = FleetCheckpointer(tmp_path, n=4, k=2)
        flight = FlightRecorder()
        try:
            pool = AsyncPool(3)
            for _ in range(2):
                # nwait=2: worker 2 (the straggler) stays in flight
                asyncmap(pool, np.ones(1), backend, nwait=2,
                         timeout=30.0)
            e_cut = pool.epoch
            assert pool.active.any()  # a dispatch IS in flight
            ck.save(capture_pool(pool))
            repochs_cut = pool.repochs.copy()
            del pool  # the coordinator object dies; workers live on

            standby = adopt_pool(ck, flight=flight)
            assert standby.epoch == e_cut
            np.testing.assert_array_equal(
                standby.repochs, repochs_cut
            )
            # the standby's next epoch harvests the in-flight
            # straggler (stale -> retask) and completes: NO epoch lost
            rep = asyncmap(
                standby, np.ones(1), backend, nwait=3, timeout=30.0,
            )
            assert (rep == e_cut + 1).sum() == 3
            waitall(standby, backend, timeout=30.0)
            # repochs history continuous: every worker's stamp moved
            # forward from the cut, none reset below it
            assert (standby.repochs >= repochs_cut).all()
        finally:
            backend.shutdown()
        doc = flight.snapshot()
        names = [e.get("name") for e in doc["traceEvents"]]
        assert "coordinator takeover" in names

    def test_pool_scaler_reaps_and_respawns(self):
        backend = ProcessBackend(_echo, 4)
        try:
            pool = AsyncPool(4)
            asyncmap(pool, np.ones(1), backend, nwait=4, timeout=30.0)
            waitall(pool, backend, timeout=30.0)
            scaler = PoolScaler(pool, backend, min_workers=2)
            with pytest.raises(ValueError, match="elastic range"):
                scaler.resize(1)
            with pytest.raises(ValueError, match="elastic range"):
                scaler.resize(5)
            # shrink: ranks 2, 3 leave and their processes are reaped
            small = scaler.resize(2)
            assert small.ranks == [0, 1]
            assert sorted(backend.dead_workers()) == [2, 3]
            assert scaler.n_reaped == 2
            asyncmap(small, np.ones(1), backend, nwait=2, timeout=30.0)
            waitall(small, backend, timeout=30.0)
            # grow back: dead ranks respawn and are dispatchable
            full = scaler.resize(4)
            assert full.ranks == [0, 1, 2, 3]
            assert backend.dead_workers() == []
            assert scaler.n_respawned == 2
            # survivors carried their repochs; returners are stale
            assert full.repochs[0] == small.repochs[0]
            assert full.repochs[2] == full.epoch0
            rep = asyncmap(
                full, np.ones(1), backend, nwait=4, timeout=30.0,
            )
            assert (rep == full.epoch).sum() == 4
            waitall(full, backend, timeout=30.0)
        finally:
            backend.shutdown()

    def test_pool_scaler_nwait_passthrough(self):
        """Review regression: a shrink below the code's k used to take
        carry's silent clamp (min(old nwait, new rank count)) because
        resize exposed no way to pass the re-derived decodability
        floor."""

        class _Stub:  # carry/reset_worker only — no reap/respawn verbs
            n_workers = 8

        pool = AsyncPool(8, nwait=6)
        scaler = PoolScaler(pool, _Stub(), min_workers=2)
        small = scaler.resize(4, nwait=3)
        assert small.nwait == 3
        # without the passthrough the old clamp semantics still hold
        assert scaler.resize(8).nwait == 3

    def test_native_backend_reap_respawn_pair(self):
        """The same elastic pair on the native C++ transport: reap
        terminates the worker, the epoll thread's sticky dead marker
        surfaces in dead_workers, respawn reconnects the rank."""
        try:
            from mpistragglers_jl_tpu_torch.backends.native import (
                NativeProcessBackend,
            )
            from mpistragglers_jl_tpu_torch.native import transport as T

            T.load_lib()
        except Exception as e:  # pragma: no cover - no toolchain
            pytest.skip(f"native transport unavailable: {e}")
        backend = NativeProcessBackend(_echo, 2)
        try:
            pool = AsyncPool(2)
            asyncmap(pool, np.ones(1), backend, nwait=2, timeout=30.0)
            waitall(pool, backend, timeout=30.0)
            backend.reap(1)
            assert backend.dead_workers() == [1]
            backend.reap(1)  # idempotent
            backend.respawn(1)
            assert backend.dead_workers() == []
            pool.reset_worker(1)
            rep = asyncmap(
                pool, np.ones(1), backend, nwait=2, timeout=30.0,
            )
            assert (rep == pool.epoch).sum() == 2
            waitall(pool, backend, timeout=30.0)
        finally:
            backend.shutdown()

    def test_reap_is_idempotent_and_respawn_pairs(self):
        backend = ProcessBackend(_echo, 2)
        try:
            backend.reap(1)
            assert backend.dead_workers() == [1]
            backend.reap(1)  # idempotent
            assert backend.dead_workers() == [1]
            backend.respawn(1)
            assert backend.dead_workers() == []
            pool = AsyncPool(2)
            rep = asyncmap(
                pool, np.ones(1), backend, nwait=2, timeout=30.0,
            )
            assert (rep == pool.epoch).sum() == 2
            waitall(pool, backend, timeout=30.0)
        finally:
            backend.shutdown()


# --------------------------------------------------------------------------
# observability: the GC004-clean opt-in series
# --------------------------------------------------------------------------


class TestFleetObs:
    def test_metrics_and_flight_series(self, tmp_path):
        reg = MetricsRegistry()
        flight = FlightRecorder()
        clock, reps, router = _fleet(4)
        ck = FleetCheckpointer(tmp_path, n=4, k=2)
        ctl = _controller(
            router, clock, min_replicas=1, checkpointer=ck,
            registry=reg, flight=flight,
        )
        ctl.resize_to(2, reason="operator")
        ctl.resize_to(4, reason="operator")
        snap = reg.snapshot()
        resizes = {
            (s["labels"]["direction"], s["labels"]["reason"]):
            s["value"]
            for s in snap["fleet_resizes_total"]["series"]
        }
        assert resizes == {
            ("shrink", "operator"): 1.0, ("grow", "operator"): 1.0,
        }
        assert reg.gauge("fleet_size").value == 4
        assert reg.gauge("fleet_target_size").value == 4
        assert reg.histogram("fleet_decision_seconds").count == 2
        assert reg.counter("fleet_failovers_total").value == 0
        # a standby adoption advances the failover counter and stamps
        # the takeover event
        ctl.checkpoint()
        standby = _controller(
            router, clock, min_replicas=1, checkpointer=ck,
            registry=reg, flight=flight,
        )
        standby.load_state(ck.restore(), adopted=True)
        assert reg.counter("fleet_failovers_total").value == 1
        names = [
            e.get("name")
            for e in flight.snapshot()["traceEvents"]
        ]
        assert names.count("fleet decision") == 2
        assert "coordinator takeover" in names

    def test_dark_controller_has_no_obs(self):
        clock, reps, router = _fleet(2)
        ctl = _controller(router, clock, min_replicas=1)
        assert ctl._obs is None
        ctl.resize_to(1)  # no obs work on the decision path


# --------------------------------------------------------------------------
# cross-package: one elastic day, the same decisions
# --------------------------------------------------------------------------


def _pkgs(which):
    root = {"port": "mpistragglers_jl_tpu_torch",
            "jax": "mpistragglers_jl_tpu"}[which]
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return SimpleNamespace(sim=mod("sim"), fleet=mod("fleet"),
                           router=mod("models.router"),
                           straggle=mod("utils.straggle"))


def _xfleet(m, n, jitter=0.0):
    clock = m.sim.VirtualClock()
    reps = [
        m.sim.SimReplica(
            clock, slots=SLOTS, n_inner=NI, prompt_chunk=CHUNK,
            tick_s=(m.sim.lognormal_ticks(TICK, jitter, seed=1009 + i)
                    if jitter else TICK))
        for i in range(n)
    ]
    router = m.router.RequestRouter(reps, policy="least_loaded",
                                    clock=clock)
    return clock, reps, router


def _xday(which, tmp, seed=3):
    """``_day`` with a mid-day coordinator kill, in package ``which``."""
    m = _pkgs(which)
    clock, reps, router = _xfleet(m, N_FLEET, jitter=0.2)
    ck = m.fleet.FleetCheckpointer(os.path.join(tmp, which), n=5, k=3)
    mean_rate = N_FLEET * CAP * PEAK_UTIL / 1.5

    def mk():
        return m.fleet.FleetController(
            router, clock=clock, capacity_rps=CAP, min_replicas=2,
            max_replicas=N_FLEET, high=0.85, low=0.5,
            decision_interval_s=15.0, dwell_s=30.0, cooldown_s=60.0,
            rate_tau_s=120.0, checkpointer=ck, checkpoint_every_s=90.0,
        )

    sup = m.fleet.ControllerSupervisor(mk, clock=clock, takeover_s=30.0)
    report = m.sim.run_router_day(
        router,
        m.sim.diurnal_arrivals(mean_rate, n=int(mean_rate * PERIOD * 0.97),
                               period=PERIOD, amplitude=0.5, seed=seed,
                               prompt_len=PLEN, max_new=MNEW),
        controller=sup, events=[m.sim.CoordinatorKill(PERIOD * 0.45)],
    )
    return {"digest": report.digest(), "dropped": report.dropped,
            "resizes": report.n_resizes, "failovers": report.n_failovers,
            "decisions": [d.to_dict() for d in sup.decisions],
            "chip_s": sup.chip_seconds()}


def test_elastic_day_with_kill_decides_alike_in_both_packages(tmp_path):
    port, ref = _xday("port", str(tmp_path)), _xday("jax", str(tmp_path))
    assert port == ref
    assert port["dropped"] == 0 and port["failovers"] == 1
    assert port["resizes"] >= 2


def _xresize(which, kind):
    m = _pkgs(which)
    if kind == "recode":
        clock, reps, router = _xfleet(m, 4)
        model = m.straggle.PoolLatencyModel(NI, seed=0)
        rng = np.random.default_rng(5)
        for _ in range(40):
            for w in range(NI):
                model.observe(
                    w, 0.01 * (1 + 0.3 * w) * float(rng.lognormal(0, 0.3)))
        ctl = m.fleet.FleetController(
            router, clock=clock, capacity_rps=CAP, min_replicas=1,
            decision_interval_s=10.0,
            recode=dict(model=model, n_inner=NI,
                        candidates=[(1.0, 2), (1.0, 3), (0.75, 3)],
                        inner_floor=2, epochs=10))
        d = ctl.resize_to(2)
    else:
        clock, reps, router = _xfleet(m, 4, jitter=0.2)
        ctl = m.fleet.FleetController(
            router, clock=clock, capacity_rps=CAP, min_replicas=1,
            decision_interval_s=10.0,
            policy_sweep=dict(requests=200, slots=SLOTS, n_inner=NI,
                              tick_s=TICK, prompt_len=PLEN,
                              prompt_chunk=CHUNK, max_new=MNEW, seed=11))
        for k in range(1, 400):
            ctl.observe_arrival(k * 0.02)
        clock.run_until(8.0)
        d = ctl.resize_to(3)
    return d.to_dict(), router.policy


@pytest.mark.parametrize("kind", ["recode", "repolicy"])
def test_resize_decision_records_equal_in_both_packages(kind):
    port, ref = _xresize("port", kind), _xresize("jax", kind)
    assert port == ref
    assert (port[0].get("recode") or port[0].get("policy"))
