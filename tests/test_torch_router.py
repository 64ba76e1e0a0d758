"""Request router over scheduler replicas (``models/router.py``) in
the port, on the CPU.

The contract is ``tests/test_router.py``: its cases run here on the
port's ``RequestRouter`` over the port's ``ServingScheduler`` (the
plain versions of the kernels on CPU tensors) and ``SimReplica``, with
the same bounds. The oracle of every live stream is the JAX package's
``generate_ring_dense`` on the same weights (``init_params`` of the JAX
package, carried over with ``params_from_jax``), f32: tolerance none,
streams are token-equal. Then the same routed requests go through both
packages' routers over their own schedulers and the routed streams, the
replica each request landed on, and the router's counters must agree.

Three layers of contract:

* **replica hooks** — ``ServingScheduler.cancel`` withdraws a request
  from the queue, mid-admission, or mid-decode, returning its slot
  (and, paged, its pages);
* **live routing** — a router over REAL schedulers serves every stream
  token-for-token equal to the single-request oracle, balances load,
  routes shared prefixes to the replica already holding their pages,
  and hedges a stalled replica's requests (first-token-wins, loser
  cancelled);
* **health plane** — a replica whose health flips is ejected (its
  in-flight requests re-routed, zero drops) then resumed on recovery,
  and the ObsServer aggregate ``/healthz`` reports per-replica status
  while going 503 only when NO replica is admittable.
"""

import dataclasses
import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.models.decode import generate_ring_dense
from mpistragglers_jl_tpu.models.router import (
    RequestRouter as JaxRouter,
)
from mpistragglers_jl_tpu.models.serving import (
    ServingScheduler as JaxScheduler,
)
from mpistragglers_jl_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    init_params as jax_init_params,
)
from mpistragglers_jl_tpu_torch.models.router import (
    ROUTER_POLICIES,
    RequestRouter,
)
from mpistragglers_jl_tpu_torch.models.serving import (
    ServingScheduler as _Scheduler,
)
from mpistragglers_jl_tpu_torch.models.transformer import (
    TransformerConfig,
    params_from_jax,
)
from mpistragglers_jl_tpu_torch.obs import FlightRecorder, MetricsRegistry
from mpistragglers_jl_tpu_torch.obs.export import ObsServer
from mpistragglers_jl_tpu_torch.sim import SimPrompt, SimReplica, VirtualClock
from mpistragglers_jl_tpu_torch.utils.hedge import RequestHedge

FIELDS = dict(vocab=61, d_model=64, n_heads=8, n_kv_heads=2, n_layers=2,
              d_ff=128, attn_window=6)
CFG = TransformerConfig(**FIELDS)
JCFG = JaxConfig(**FIELDS)
JPARAMS = jax_init_params(JCFG, seed=11)
PARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS), "cpu")
RNG = np.random.default_rng(31)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ServingScheduler(_Scheduler):
    """The port's scheduler on the CPU, as every test here runs it."""

    def __init__(self, params, cfg, **kw):
        kw.setdefault("device", "cpu")
        super().__init__(params, cfg, **kw)


def _prompt(n):
    return RNG.integers(1, CFG.vocab, size=n).astype(np.int32)


def _oracle(prompt, n_new, jcfg=JCFG):
    toks = generate_ring_dense(
        JPARAMS, jnp.asarray(prompt)[None], n_new, jcfg
    )
    return [int(t) for t in np.asarray(toks)[0]]


def _sched(**kw):
    kw.setdefault("slots", 2)
    kw.setdefault("n_inner", 4)
    kw.setdefault("prompt_chunk", 8)
    kw.setdefault("max_prompt", 64)
    return ServingScheduler(PARAMS, CFG, **kw)


def _get(url, timeout=10.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


# --------------------------------------------------------------------------
# ServingScheduler.cancel — the replica hook
# --------------------------------------------------------------------------


class TestSchedulerCancel:
    def test_cancel_queued_request(self):
        s = _sched(slots=1)
        a = s.submit(_prompt(5), max_new=8)
        b = s.submit(_prompt(5), max_new=8)
        assert s.cancel(b) is True
        assert b.finished and b.reason == "cancelled"
        assert s.pending == 1  # only a remains queued
        s.run()
        assert a.tokens == _oracle(a.prompt, 8)

    def test_cancel_decoding_request_frees_slot(self):
        s = _sched(slots=1)
        a = s.submit(_prompt(5), max_new=40)
        b = s.submit(_prompt(5), max_new=8)
        s.step(); s.step()
        assert a.tokens and not a.finished  # decoding
        assert s.cancel(a) is True
        assert a.reason == "cancelled"
        s.run()
        # b got the freed slot and its stream is untouched by a's life
        assert b.tokens == _oracle(b.prompt, 8)

    def test_cancel_mid_admission_dense(self):
        s = _sched(slots=1, prompt_chunk=4)
        a = s.submit(_prompt(16), max_new=8)  # 4 chunks
        s.step()  # admission starts, not finished
        assert s.active == 1 and not a.tokens
        assert s.cancel(a) is True
        assert s.active == 0
        assert not s.cancel(a)  # idempotent: already finished

    def test_cancel_unknown_request_is_false(self):
        s = _sched()
        other = _sched()
        r = other.submit(_prompt(4), max_new=4)
        assert s.cancel(r) is False
        assert not r.finished

    def test_cancel_paged_returns_pages(self):
        s = _sched(slots=2, page_tokens=3)
        base_free = s.pool.free
        # cancel at every lifecycle stage; the pool must drain back
        # to its baseline each time (mid-admission pages live in the
        # plan, not the device table — the leak the hook must not have)
        q = s.submit(_prompt(5), max_new=12)           # queued
        assert s.cancel(q) and s.pool.free == base_free
        a = s.submit(_prompt(16), max_new=12)
        s.step()                                        # admitting
        assert s.cancel(a) and s.pool.free == base_free
        d = s.submit(_prompt(5), max_new=12)
        s.step(); s.step()                              # decoding
        assert d.tokens and s.cancel(d)
        assert s.pool.free == base_free

    def test_cancelled_never_counts_as_retired_metric(self):
        reg = MetricsRegistry()
        s = _sched(slots=1, registry=reg)
        a = s.submit(_prompt(5), max_new=6)
        s.step()
        s.cancel(a)
        s.run()
        snap = reg.snapshot()
        retired = sum(
            series["value"]
            for series in snap["serving_retired_total"]["series"]
        ) if "serving_retired_total" in snap else 0
        assert retired == 0


# --------------------------------------------------------------------------
# RequestHedge bookkeeping
# --------------------------------------------------------------------------


class TestRequestHedge:
    def test_due_fires_once_in_deadline_order(self):
        h = RequestHedge()
        a, b, c = object(), object(), object()
        h.arm(a, 2.0); h.arm(b, 1.0); h.arm(c, 5.0)
        assert h.next_deadline() == 1.0
        assert h.due(2.0) == [b, a]  # (deadline, arm-seq) order
        assert h.due(2.0) == []      # exactly once
        assert len(h) == 1
        h.disarm(c)
        assert h.next_deadline() is None

    def test_rearm_supersedes_and_ties_fire_in_arm_order(self):
        h = RequestHedge()
        a, b = object(), object()
        h.arm(a, 1.0)
        h.arm(b, 1.0)
        h.arm(a, 3.0)  # re-arm: the 1.0 deadline becomes a tombstone
        assert h.due(1.0) == [b]
        assert h.next_deadline() == 3.0
        assert h.due(3.0) == [a]

    def test_disarm_unknown_is_noop(self):
        h = RequestHedge()
        h.disarm(object())
        assert len(h) == 0


# --------------------------------------------------------------------------
# live routing over real schedulers
# --------------------------------------------------------------------------


class TestLiveRouting:
    def test_policy_validation(self):
        with pytest.raises(ValueError, match="unknown policy"):
            RequestRouter([_sched()], policy="fastest")
        with pytest.raises(ValueError, match="ttft_slo"):
            RequestRouter([_sched()], policy="hedge_p99")
        with pytest.raises(ValueError, match="at least one replica"):
            RequestRouter([])
        with pytest.raises(ValueError, match="max_new"):
            RequestRouter([_sched()]).submit(_prompt(4), max_new=0)
        assert set(ROUTER_POLICIES) == {
            "round_robin", "least_loaded", "prefix_affinity",
            "hedge_p99", "two_tier",
        }
        # two_tier needs an actual two-tier fleet shape
        with pytest.raises(ValueError, match="EACH tier"):
            RequestRouter([_sched()], policy="two_tier")

    @pytest.mark.parametrize("policy", ["round_robin", "least_loaded"])
    def test_streams_equal_oracle_across_replicas(self, policy):
        scheds = [_sched() for _ in range(3)]
        router = RequestRouter(scheds, policy=policy)
        prompts = [_prompt(3 + i % 4) for i in range(7)]
        rrs = [router.submit(p, max_new=6) for p in prompts]
        router.drain()
        for rr, p in zip(rrs, prompts):
            assert rr.finished and rr.outcome == "ok"
            assert rr.ttft is not None and rr.latency >= rr.ttft
            assert list(rr.tokens) == _oracle(p, 6)
        # round_robin spread them over every replica
        if policy == "round_robin":
            assert {rr.replica for rr in rrs} == {0, 1, 2}

    def test_least_loaded_picks_the_empty_replica(self):
        scheds = [_sched(slots=4), _sched(slots=4)]
        router = RequestRouter(scheds, policy="least_loaded")
        for _ in range(3):
            router.submit(_prompt(4), max_new=16)
        rr = router.submit(_prompt(4), max_new=16)
        # 3 on replica 0's books vs 0 on replica 1 never happens:
        # least-loaded alternates as depth grows
        depth = [s.pending + s.active for s in scheds]
        assert abs(depth[0] - depth[1]) <= 1
        router.drain()
        assert rr.finished

    def test_prefix_affinity_follows_resident_pages(self):
        # a wider window so a shared system prompt fits unwrapped AND
        # the first sharer stays resident while the second arrives
        # (wrapped prompts are neither shared nor registered, and a
        # retired holder's pages leave the prefix table — the paged-
        # cache contract); params are window-independent
        cfg = dataclasses.replace(CFG, attn_window=48)
        scheds = [
            ServingScheduler(PARAMS, cfg, slots=2, n_inner=4,
                             prompt_chunk=4, max_prompt=64,
                             page_tokens=4)
            for _ in range(3)
        ]
        router = RequestRouter(scheds, policy="prefix_affinity")
        system = _prompt(12)  # 3 page-aligned prefix pages at P=4
        p1 = np.concatenate([system, _prompt(4)])
        p2 = np.concatenate([system, _prompt(4)])
        r1 = router.submit(p1, max_new=24)  # horizon 44 < W: no wrap
        # tick until r1's prefix pages are registered (admission done)
        for _ in range(12):
            router.step()
            if r1.tokens:
                break
        assert r1.tokens and not r1.finished  # resident, decoding
        r2 = router.submit(p2, max_new=4)
        assert r2.replica == r1.replica  # routed to the pages
        router.drain()
        assert scheds[r1.replica].pool.share_hits > 0
        assert list(r2.tokens) == _oracle(
            p2, 4, dataclasses.replace(JCFG, attn_window=48))

    # the one real-thread hedging smoke of this family (virtual-time
    # siblings in tests/test_torch_sim_workload.py carry the exact claims)
    def test_hedge_p99_live_first_token_wins(self):
        class Stalled(ServingScheduler):
            """A replica wedged for its next 3 ticks (sleeping, no
            progress — the stuck-scheduler signature): TTFT blows the
            SLO while the request sits in its queue, then the replica
            recovers and finds its leg already cancelled."""

            stalls = 3

            def step(self):
                if self.stalls > 0:
                    self.stalls -= 1
                    time.sleep(0.06)
                    return []
                return super().step()

        slow = Stalled(PARAMS, CFG, slots=2, n_inner=4,
                       prompt_chunk=8, max_prompt=64)
        fast = _sched()
        router = RequestRouter([slow, fast], policy="hedge_p99",
                               ttft_slo=0.05)
        rr = router.submit(_prompt(5), max_new=6)
        assert rr.replica == 0
        router.drain()
        assert rr.finished
        assert rr.hedged and rr.outcome == "hedge_won"
        assert rr.replica == 1  # the fast replica's token won
        assert router.n_hedges == 1
        assert list(rr.tokens) == _oracle(rr.prompt, 6)
        # the losing leg was cancelled on the slow replica
        assert slow.active == 0 and slow.pending == 0


# --------------------------------------------------------------------------
# health plane: ejection, re-route, recovery, /healthz aggregate
# --------------------------------------------------------------------------


class TestHealthPlane:
    def _sim_router(self, n=4, **kw):
        clock = VirtualClock()
        reps = [
            SimReplica(clock, slots=2, n_inner=8, prompt_chunk=64,
                       tick_s=0.01)
            for _ in range(n)
        ]
        return clock, reps, RequestRouter(reps, clock=clock, **kw)

    def _run(self, clock, router, until_idle=True, max_events=10_000):
        for _ in range(max_events):
            nt = router.next_event_at()
            if nt is None:
                return
            clock.run_until(nt)
            router.step()
            if until_idle and router.in_flight == 0:
                return

    def test_kill_ejects_reroutes_and_recover_resumes(self):
        clock, reps, router = self._sim_router()
        flight = FlightRecorder()
        router._obs = None  # rebuilt below with flight only
        router2 = RequestRouter(reps, clock=clock, flight=flight,
                                policy="round_robin")
        rrs = [router2.submit(SimPrompt(64), 64) for _ in range(8)]
        victim = rrs[1].replica
        reps[victim].kill()
        router2.step()  # health flip observed: eject + re-route
        assert victim not in router2.routable_replicas
        # eviction CANCELLED the abandoned legs (a drained-but-alive
        # replica must not decode zombie streams after recovery); the
        # killed SimReplica wiped its books, so nothing was cancellable
        assert reps[victim].pending == 0 and reps[victim].active == 0
        assert all(
            rr.replica != victim for rr in rrs if not rr.finished
        )
        # nothing routes there while it is down
        for _ in range(4):
            assert router2.submit(SimPrompt(64), 8).replica != victim
        self._run(clock, router2)
        assert all(rr.finished for rr in rrs)  # zero dropped
        # flight recorder carries the ejection instant event
        doc = flight.snapshot()
        names = {e.get("name") for e in doc["traceEvents"]}
        assert "replica ejected" in names
        # recovery: the replica takes traffic again
        reps[victim].revive()
        router2.step()
        assert victim in router2.routable_replicas
        seen = {
            router2.submit(SimPrompt(64), 8).replica
            for _ in range(len(reps))
        }
        assert victim in seen
        self._run(clock, router2)
        doc = flight.snapshot()
        names = {e.get("name") for e in doc["traceEvents"]}
        assert "replica restored" in names

    def test_mark_down_and_up_are_manual_overrides(self):
        clock, reps, router = self._sim_router(n=2)
        router.mark_down(0)
        router.step()
        assert router.routable_replicas == [1]
        router.mark_up(0)
        router.step()
        assert router.routable_replicas == [0, 1]

    def test_mark_down_cancels_legs_on_the_drained_replica(self):
        """An operator drain (mark_down of a replica that is still
        ALIVE) must cancel the re-routed requests' abandoned legs —
        otherwise the drained replica decodes zombie streams for their
        whole budget and resumes with its slots full."""
        clock, reps, router = self._sim_router(n=2)
        rrs = [router.submit(SimPrompt(64), 64) for _ in range(4)]
        on0 = sum(rr.replica == 0 for rr in rrs)
        assert on0 > 0
        router.mark_down(0)
        router.step()
        assert reps[0].n_cancelled == on0
        assert reps[0].pending == 0 and reps[0].active == 0
        self._run(clock, router)
        assert all(rr.finished for rr in rrs)

    def test_healthz_aggregate_503_only_when_none_admittable(self):
        clock, reps, router = self._sim_router()
        with ObsServer() as srv:
            srv.register_router(router)
            # all up: 200, detail carries every replica
            status, body = _get(srv.url + "/healthz")
            assert status == 200
            doc = json.loads(body)
            detail = doc["checks"]["router"]["detail"]
            assert "4/4 replicas routable" in detail
            for i in range(4):
                assert f"replica {i}:" in detail
            # one dead: DEGRADED detail but still 200 — the router
            # routes around it, that is not an outage
            reps[0].kill()
            router.step()
            status, body = _get(srv.url + "/healthz")
            assert status == 200
            detail = json.loads(body)["checks"]["router"]["detail"]
            assert "3/4 replicas routable" in detail
            assert "replica 0: ejected" in detail
            # all dead: NOW it is an outage — 503
            for r in reps[1:]:
                r.kill()
            router.step()
            status, body = _get(srv.url + "/healthz")
            assert status == 503
            assert "0/4 replicas routable" in (
                json.loads(body)["checks"]["router"]["detail"]
            )
            # recovery flips it back
            reps[2].revive()
            router.step()
            status, _ = _get(srv.url + "/healthz")
            assert status == 200

    def test_exporter_kwarg_registers_the_check(self):
        clock, reps, router = self._sim_router(n=2)
        srv = ObsServer()
        RequestRouter(reps, clock=clock, exporter=srv)
        ok, doc = srv.healthz()
        assert ok and "router" in doc["checks"]

    def test_live_scheduler_statuses_report_tick_freshness(self):
        scheds = [_sched(), _sched()]
        for s in scheds:
            s.enable_tick_stamping()  # a dark scheduler never stamps
        router = RequestRouter(scheds)
        rr = router.submit(_prompt(4), max_new=4)
        router.drain()
        assert rr.finished
        statuses = router.replica_statuses()
        assert statuses[0][0] is True
        assert "last tick" in statuses[0][1]  # freshness detail


# --------------------------------------------------------------------------
# router observability (registry + flight, opt-in)
# --------------------------------------------------------------------------


class TestRouterObservability:
    def test_metrics_series(self):
        reg = MetricsRegistry()
        clock = VirtualClock()
        reps = [
            SimReplica(clock, slots=2, n_inner=8, prompt_chunk=64,
                       tick_s=lambda t, m=(1.0, 6.0)[i]: 0.01 * m)
            for i in range(2)
        ]
        router = RequestRouter(reps, policy="hedge_p99",
                               ttft_slo=0.03, clock=clock,
                               registry=reg)
        rrs = [router.submit(SimPrompt(64), 16) for _ in range(6)]
        while router.in_flight:
            clock.run_until(router.next_event_at())
            router.step()
        snap = reg.snapshot()
        done = {
            (s["labels"]["replica"], s["labels"]["outcome"]):
            s["value"]
            for s in snap["router_requests_total"]["series"]
        }
        assert sum(done.values()) == 6
        assert all(
            s["labels"]["policy"] == "hedge_p99"
            for s in snap["router_requests_total"]["series"]
        )
        assert snap["router_hedge_fired_total"]["series"][0][
            "value"
        ] == router.n_hedges > 0
        assert reg.histogram("router_ttft_seconds").count == 6
        assert reg.histogram("router_queue_wait_seconds").count == 6
        # per-replica depth gauges exist for both replicas
        for i in range(2):
            reg.gauge("router_replica_depth", replica=str(i))
        assert reg.gauge("router_routable_replicas").value == 2

    def test_flight_hedge_fire_event(self):
        flight = FlightRecorder()
        clock = VirtualClock()
        reps = [
            SimReplica(clock, slots=2, n_inner=8, prompt_chunk=64,
                       tick_s=0.01 * (1.0, 6.0)[i])
            for i in range(2)
        ]
        router = RequestRouter(reps, policy="hedge_p99",
                               ttft_slo=0.03, clock=clock,
                               flight=flight)
        router.submit(SimPrompt(64), 16)
        router.submit(SimPrompt(64), 16)
        while router.in_flight:
            clock.run_until(router.next_event_at())
            router.step()
        doc = flight.snapshot()
        names = [e.get("name") for e in doc["traceEvents"]]
        assert "hedge fired" in names

    def test_dark_router_has_no_obs(self):
        router = RequestRouter([_sched()])
        assert router._obs is None


# --------------------------------------------------------------------------
# cross-package: the same routed requests through both packages' routers
# --------------------------------------------------------------------------


def _xroute(which, policy):
    """Route ten requests over three live schedulers of package
    ``which`` on a virtual clock that moves 10 ms a router step, so the
    hedge deadlines fall on the same step in both packages. Replica 0
    skips its first ``stalls`` ticks (a wedged replica, no sleep)."""
    from mpistragglers_jl_tpu.sim import VirtualClock as JaxClock

    if which == "port":
        router_cls, sched_cls, params, cfg, clock = (
            RequestRouter, ServingScheduler, PARAMS, CFG, VirtualClock())
    else:
        router_cls, sched_cls, params, cfg, clock = (
            JaxRouter, JaxScheduler, JPARAMS, JCFG, JaxClock())
    kw = dict(slots=2, n_inner=4, prompt_chunk=8, max_prompt=64)
    if policy == "prefix_affinity":
        cfg = dataclasses.replace(cfg, attn_window=48)
        kw.update(prompt_chunk=4, page_tokens=4)

    class Stalled(sched_cls):
        stalls = 6 if policy == "hedge_p99" else 0

        def step(self):
            if self.stalls > 0:
                self.stalls -= 1
                return []
            return super().step()

    scheds = [(Stalled if i == 0 else sched_cls)(params, cfg, **kw)
              for i in range(3)]
    router = router_cls(
        scheds, policy=policy, clock=clock,
        **({"ttft_slo": 0.03} if policy == "hedge_p99" else {}))
    rng = np.random.default_rng(77)
    system = rng.integers(1, CFG.vocab, 12).astype(np.int32)
    prompts = [
        np.concatenate([system, rng.integers(1, CFG.vocab, 4)]).astype(
            np.int32) if (policy == "prefix_affinity" and i % 2 == 0)
        else rng.integers(1, CFG.vocab, 3 + i % 5).astype(np.int32)
        for i in range(10)
    ]
    rrs = []
    for i, p in enumerate(prompts):
        rrs.append(router.submit(p, max_new=6 + i % 3))
        # the first sharer's prefix pages register when its admission
        # ends: tick until its first token before the next arrives
        while policy == "prefix_affinity" and not rrs[0].tokens:
            clock.advance(0.01)
            router.step()
        if i % 2:
            clock.advance(0.01)
            router.step()
    while router.in_flight:
        clock.advance(0.01)
        router.step()
    return ([(rr.replica, rr.outcome, rr.hedged, [int(t) for t in rr.tokens])
             for rr in rrs],
            router.n_hedges, [s.pool.share_hits if s.pool is not None else 0
                              for s in scheds],
            prompts, cfg)


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded",
                                    "prefix_affinity", "hedge_p99"])
def test_routed_streams_equal_in_both_packages(policy):
    """The port's router over the port's schedulers and the JAX
    package's router over its own place the same requests on the same
    replicas with the same outcomes, and every stream is token-equal to
    the JAX ``generate_ring_dense`` oracle (f32, tolerance none)."""
    port = _xroute("port", policy)
    ref = _xroute("jax", policy)
    assert port[:3] == ref[:3]
    rows, hedges, share, prompts, _ = port
    jcfg = JCFG if policy != "prefix_affinity" else dataclasses.replace(
        JCFG, attn_window=48)
    for (_, outcome, _, toks), p, i in zip(rows, prompts, range(10)):
        assert outcome in ("ok", "hedged", "hedge_won")
        assert toks == _oracle(p, 6 + i % 3, jcfg)
    if policy == "hedge_p99":
        assert hedges > 0
    if policy == "prefix_affinity":
        assert sum(share) > 0
