"""Arrival-process determinism and router-policy pricing in the port
(``sim/workload.py`` + ``sim/tune.py::sweep_router_policy``).

The contract is ``tests/test_sim_workload.py``: its cases run here on
the port's copies with the same bounds. Everything runs on virtual
time only (this module never reads the OS clock): seeded Poisson and
diurnal streams must be bit-identical across runs, JSONL traces must
replay exactly, a full simulated day must produce a bit-identical
report digest, and the policy sweep must REFUSE (never clamp) the
SLO-infeasible configurations by name.

Then the cross-package checks: the same seeded day (every policy; a
kill, a partition, retries, QoS tenants, a two-tier fleet) gives the
same ``WorkloadReport.digest()`` in the JAX package and in the port, on
the scalar driver and on the fast one; a JSONL day written by either
package replays to one digest in both; and the four router-day sweeps
recommend the same thing in both. Tolerance: none (both are numpy on
the same virtual timeline).
"""

import importlib

import numpy as np
import pytest

from mpistragglers_jl_tpu_torch.models.router import RequestRouter
from mpistragglers_jl_tpu_torch.sim import (
    VirtualClock,
    SimPrompt,
    SimReplica,
    arrivals_from_jsonl,
    diurnal_arrivals,
    dump_arrivals_jsonl,
    lognormal_ticks,
    poisson_arrivals,
    run_router_day,
    sweep_router_policy,
)


def _fleet(clock, n=4, slots=4, base=0.02, sigma=0.2, mult=None):
    mult = mult or {}
    return [
        SimReplica(
            clock, slots=slots, n_inner=8, prompt_chunk=64,
            tick_s=lognormal_ticks(base * mult.get(i, 1.0), sigma,
                                   seed=100 + i),
        )
        for i in range(n)
    ]


def _day(policy="least_loaded", *, n=3000, seed=2, rate=120.0,
         ttft_slo=None, mult=None, hooks=None, **router_kw):
    clock = VirtualClock()
    reps = _fleet(clock, mult=mult)
    router = RequestRouter(reps, policy=policy, clock=clock,
                           ttft_slo=ttft_slo, **router_kw)
    if hooks:
        hooks(clock, reps, router)
    report = run_router_day(
        router,
        poisson_arrivals(rate, n=n, seed=seed, prompt_len=64,
                         max_new=24),
    )
    return report, reps, router


# --------------------------------------------------------------------------
# arrival-process determinism
# --------------------------------------------------------------------------


def test_poisson_arrivals_bit_identical_and_calibrated():
    a = list(poisson_arrivals(50.0, n=5000, seed=7))
    b = list(poisson_arrivals(50.0, n=5000, seed=7))
    assert [x.t for x in a] == [x.t for x in b]  # exact, not approx
    assert [x.prompt for x in a] == [x.prompt for x in b]
    # mean rate lands near the asked-for rate (law of large numbers;
    # generous band — this is a calibration sanity check, not a
    # statistics test)
    assert a[-1].t == pytest.approx(5000 / 50.0, rel=0.1)
    c = list(poisson_arrivals(50.0, n=5000, seed=8))
    assert [x.t for x in a] != [x.t for x in c]  # the seed matters


def test_poisson_prefix_share_draws_do_not_move_times():
    plain = list(poisson_arrivals(50.0, n=2000, seed=3))
    shared = list(poisson_arrivals(50.0, n=2000, seed=3,
                                   prefix_share=0.6, prefix_len=32,
                                   prompt_len=64, n_prefix_groups=3))
    assert [x.t for x in plain] == [x.t for x in shared]
    groups = {x.prompt.prefix for x in shared}
    assert None in groups and len(groups - {None}) == 3
    share = sum(x.prompt.prefix is not None for x in shared) / 2000
    assert share == pytest.approx(0.6, abs=0.05)


def test_diurnal_arrivals_bit_identical_and_diurnal():
    a = list(diurnal_arrivals(40.0, n=6000, period=120.0,
                              amplitude=0.8, seed=5))
    b = list(diurnal_arrivals(40.0, n=6000, period=120.0,
                              amplitude=0.8, seed=5))
    assert [x.t for x in a] == [x.t for x in b]
    # the schedule troughs at phase 0 and peaks at phase period/2:
    # the middle half of each cycle must hold far more arrivals than
    # the edges (analytic ratio ~3.1 at amplitude 0.8)
    phase = np.asarray([x.t for x in a]) % 120.0
    mid = int(np.sum((phase > 30.0) & (phase < 90.0)))
    edge = 6000 - mid
    assert mid > 2.0 * edge


def test_jsonl_trace_round_trip_exact(tmp_path):
    path = tmp_path / "arrivals.jsonl"
    src = list(poisson_arrivals(30.0, n=500, seed=11,
                                prefix_share=0.5, prefix_len=16,
                                prompt_len=48))
    assert dump_arrivals_jsonl(src, path) == 500
    back = arrivals_from_jsonl(path)
    assert [x.t for x in back] == [x.t for x in src]
    assert [x.prompt for x in back] == [x.prompt for x in src]
    assert [x.max_new for x in back] == [x.max_new for x in src]


def test_jsonl_empty_trace_refused(tmp_path):
    path = tmp_path / "empty.jsonl"
    path.write_text("\n")
    with pytest.raises(ValueError, match="empty arrival trace"):
        arrivals_from_jsonl(path)


def test_sim_prompt_interned_and_validated():
    assert SimPrompt(64, prefix=1, prefix_len=16) is SimPrompt(
        64, prefix=1, prefix_len=16
    )
    with pytest.raises(ValueError, match="within the prompt"):
        SimPrompt(8, prefix=0, prefix_len=9)


# --------------------------------------------------------------------------
# the simulated day
# --------------------------------------------------------------------------


def test_router_day_bit_identical_across_runs():
    r1, _, _ = _day(n=4000)
    r2, _, _ = _day(n=4000)
    assert r1.digest() == r2.digest()
    assert np.array_equal(r1.ttft, r2.ttft)
    assert np.array_equal(r1.latency, r2.latency)
    assert r1.outcomes == r2.outcomes == {"ok": 4000}
    assert r1.dropped == 0


def test_router_day_trace_replay_exact(tmp_path):
    path = tmp_path / "day.jsonl"
    dump_arrivals_jsonl(
        poisson_arrivals(120.0, n=2000, seed=9, prompt_len=64,
                         max_new=24),
        path,
    )
    digests = []
    for _ in range(2):
        clock = VirtualClock()
        router = RequestRouter(_fleet(clock), policy="least_loaded",
                               clock=clock)
        digests.append(
            run_router_day(router, arrivals_from_jsonl(path)).digest()
        )
    assert digests[0] == digests[1]


def test_replica_kill_mid_day_drops_nothing():
    """One replica dies mid-day and recovers later: every request
    still completes (re-routed onto the survivors), bit-identically
    across runs — the zero-drop half of the acceptance criteria."""

    def hooks(clock, reps, router):
        clock.call_at(3.0, reps[1].kill)
        clock.call_at(8.0, reps[1].revive)

    r1, reps, router = _day(n=3000, hooks=hooks)
    assert r1.dropped == 0
    assert r1.n_rerouted > 0
    assert r1.outcomes.get("rerouted", 0) > 0
    assert sum(r1.outcomes.values()) == 3000
    # the revived replica took traffic again after recovery
    assert reps[1].n_retired > 0
    r2, _, _ = _day(n=3000, hooks=lambda c, rp, rt: (
        c.call_at(3.0, rp[1].kill), c.call_at(8.0, rp[1].revive)
    ))
    assert r1.digest() == r2.digest()


def test_hedge_p99_fires_and_cancels_losers():
    """A 4x-slow replica under a tight TTFT SLO: hedges fire, the
    fast replica's first token wins, and the losing leg is cancelled
    on the slow replica (first-token-wins with loser cancellation)."""
    rep, reps, router = _day(
        "hedge_p99", n=800, rate=60.0, ttft_slo=0.1,
        mult={0: 4.0},
    )
    assert rep.dropped == 0
    assert rep.n_hedges > 0
    won = rep.outcomes.get("hedge_won", 0) + rep.outcomes.get(
        "hedged", 0
    )
    assert won == rep.n_hedges > 0
    # every fired hedge's losing leg was cancelled on its replica,
    # not left burning slot-ticks
    assert sum(r.n_cancelled for r in reps) == rep.n_hedges


def test_prefix_affinity_routes_to_resident_replica():
    clock = VirtualClock()
    reps = _fleet(clock, sigma=0.0)
    router = RequestRouter(reps, policy="prefix_affinity", clock=clock)
    shared = SimPrompt(64, prefix=0, prefix_len=48)
    r1 = router.submit(shared, 24)
    clock.run_until(router.next_event_at())
    router.step()  # admits r1 -> its replica now holds prefix 0
    r2 = router.submit(shared, 24)
    assert r2.replica == r1.replica
    # a unique prompt balances away instead of stacking the hot replica
    r3 = router.submit(SimPrompt(64), 24)
    assert r3.replica != r1.replica


def test_submit_with_no_routable_replicas_raises():
    clock = VirtualClock()
    reps = _fleet(clock, n=2)
    for r in reps:
        r.kill()
    router = RequestRouter(reps, clock=clock)
    with pytest.raises(RuntimeError, match="no routable replicas"):
        router.submit(SimPrompt(16), 8)


# --------------------------------------------------------------------------
# sweep_router_policy: refusals by name, then recommendations
# --------------------------------------------------------------------------


def test_sweep_refuses_zero_admittable_replicas():
    with pytest.raises(ValueError,
                       match="zero admittable replicas"):
        sweep_router_policy(n_replicas=4, dead=(0, 1, 2, 3),
                            requests=50)


def test_sweep_refuses_saturating_load():
    with pytest.raises(ValueError, match="offered load"):
        sweep_router_policy(load=1.0, requests=50)
    with pytest.raises(ValueError, match="offered load"):
        sweep_router_policy(load=1.3, requests=50)


def test_sweep_refuses_hedge_without_slo():
    with pytest.raises(ValueError,
                       match="hedge_p99 without ttft_slo"):
        sweep_router_policy(policies=("hedge_p99",), requests=50)


def test_sweep_refuses_unmeetable_admission_slo():
    with pytest.raises(ValueError,
                       match="no policy meets the admission SLO"):
        sweep_router_policy(
            requests=400, load=0.9, tick_sigma=0.5,
            straggler={0: 3.0}, admission_slo_s=1e-9, seed=3,
        )


def test_sweep_least_loaded_beats_round_robin_under_straggler():
    """The acceptance margin on the sim rung: with one straggling
    replica at 0.8 load, least_loaded's p99 TTFT beats round_robin by
    well over 15%."""
    sw = sweep_router_policy(
        requests=1500, load=0.8, straggler={0: 1.8},
        tick_sigma=0.25, seed=4,
        policies=("round_robin", "least_loaded"),
    )
    assert sw["best"] == "least_loaded"
    assert sw["p99_vs_round_robin"] >= 1.15
    by = {e["policy"]: e for e in sw["entries"]}
    assert by["least_loaded"]["dropped"] == 0
    assert by["round_robin"]["dropped"] == 0


def test_sweep_prefix_affinity_wins_at_high_share_rate():
    sw = sweep_router_policy(
        requests=1500, load=0.8, prefix_share=0.7, prefix_len=64,
        prompt_len=96, n_prefix_groups=4, tick_sigma=0.25, seed=5,
        policies=("round_robin", "least_loaded", "prefix_affinity"),
    )
    by = {e["policy"]: e for e in sw["entries"]}
    # affinity converts shared prompts into skipped prefill chunks …
    assert (by["prefix_affinity"]["shared_admits"]
            > 1.5 * by["least_loaded"]["shared_admits"])
    # … and that wins the point on mean TTFT without giving the tail
    # away (the load bound: a hot prefix must not melt one replica)
    assert (by["prefix_affinity"]["mean_ttft_s"]
            < by["least_loaded"]["mean_ttft_s"])
    assert (by["prefix_affinity"]["p99_ttft_s"]
            < 1.1 * by["least_loaded"]["p99_ttft_s"])


def test_sweep_entries_are_deterministic():
    kw = dict(requests=600, load=0.7, tick_sigma=0.3, seed=9,
              policies=("round_robin", "least_loaded"))
    a = sweep_router_policy(**kw)
    b = sweep_router_policy(**kw)
    assert a["entries"] == b["entries"]
    assert a["best"] == b["best"]


# --------------------------------------------------------------------------
# cross-package: the same seeded day, the same digest
# --------------------------------------------------------------------------

PACKAGES = {"port": "mpistragglers_jl_tpu_torch",
            "jax": "mpistragglers_jl_tpu"}


def _pkg(which):
    root = PACKAGES[which]
    return (importlib.import_module(root + ".sim"),
            importlib.import_module(root + ".models.router"),
            importlib.import_module(root + ".qos"))


def _xday(which, policy, fast, scenario="plain", path=None):
    """One seeded day over four straggling SimReplicas, in package
    ``which``; returns what both packages must agree on."""
    sim, rmod, qos = _pkg(which)
    clock = sim.VirtualClock()
    tier = None
    if policy == "two_tier":
        tier = ["prefill", "prefill", "decode", "decode"]
    reg = None
    if scenario == "qos":
        reg = qos.TenantRegistry([
            qos.TenantContract("gold", cls="latency", weight=4.0,
                               rate=900.0, burst=600.0, hedges=2,
                               ttft_slo=2.0),
            qos.TenantContract("bronze", cls="batch", weight=1.0,
                               rate=500.0, burst=400.0),
        ])
    reps = [
        sim.SimReplica(
            clock, slots=4, n_inner=8, prompt_chunk=64,
            tick_s=sim.lognormal_ticks(0.02 * (1.8 if i == 0 else 1.0),
                                       0.25, seed=300 + i),
            qos=reg, **({} if tier is None else {"tier": tier[i]}))
        for i in range(4)
    ]
    kw = {"ttft_slo": 0.08} if policy == "hedge_p99" else {}
    if scenario in ("qos", "shed"):
        kw.update(shed_depth=10, shed_depth_hard=24)
    router = rmod.RequestRouter(reps, policy=policy, clock=clock, qos=reg,
                                **kw)
    akw = dict(prompt_len=96, max_new=24, prefix_share=0.5,
               prefix_len=64, n_prefix_groups=3)
    if scenario == "qos":
        akw["tenants"] = {"gold": 0.5, "bronze": 0.5}
    rate = 160.0 if scenario in ("qos", "shed") else 110.0
    if path is not None:
        arrivals = sim.arrivals_from_jsonl(path)
    elif scenario == "diurnal":
        arrivals = sim.diurnal_arrivals(rate, n=1500, period=30.0,
                                        amplitude=0.7, seed=9, **akw)
    else:
        arrivals = sim.poisson_arrivals(rate, n=1500, seed=9, **akw)
    events, retry = [], None
    if scenario == "kill":
        clock.call_at(3.0, reps[1].kill)
        clock.call_at(7.0, reps[1].revive)
    if scenario == "partition":
        events = [sim.ReplicaPartition(2.0, (2,), 3.0)]
    if scenario in ("retry", "shed"):
        retry = sim.RetryPolicy(timeout_s=0.12, max_retries=2,
                                jitter_s=0.05, seed=9)
    drive = sim.run_router_day_fast if fast else sim.run_router_day
    rep = drive(router, arrivals, events=events, retry=retry)
    return {"digest": rep.digest(), "outcomes": dict(rep.outcomes),
            "p99_ttft": rep.p99_ttft(), "dropped": rep.dropped,
            "hedges": router.n_hedges, "rerouted": router.n_rerouted,
            "ticks": [r.tick_count for r in reps],
            "busy": [r.busy_s for r in reps]}


@pytest.mark.parametrize("fast", [False, True], ids=["scalar", "fast"])
@pytest.mark.parametrize("policy", ["round_robin", "least_loaded",
                                    "prefix_affinity", "hedge_p99",
                                    "two_tier"])
def test_same_day_same_digest_in_both_packages(policy, fast):
    port, ref = _xday("port", policy, fast), _xday("jax", policy, fast)
    assert port == ref
    assert port["dropped"] == 0
    # each policy's own machinery ran on this day
    if policy == "hedge_p99":
        assert port["hedges"] > 0 and port["outcomes"]["hedge_won"] > 0
    if policy == "two_tier":
        assert port["outcomes"] == {"migrated": 1500}


@pytest.mark.parametrize("fast", [False, True], ids=["scalar", "fast"])
@pytest.mark.parametrize("scenario", ["diurnal", "kill", "partition",
                                      "retry", "qos", "shed"])
def test_fault_and_tenant_days_same_digest_in_both_packages(scenario,
                                                            fast):
    port = _xday("port", "least_loaded", fast, scenario)
    assert port == _xday("jax", "least_loaded", fast, scenario)
    if scenario in ("kill", "partition"):
        assert port["rerouted"] > 0
    if scenario in ("qos", "shed"):
        assert port["outcomes"]["shed"] > 0
    if scenario == "retry":
        assert sum(port["outcomes"].values()) > 1500
    # the fast driver reproduces the scalar one in the port as well
    assert port["digest"] == _xday("port", "least_loaded", not fast,
                                   scenario)["digest"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_jsonl_day_written_by_either_package_replays_alike(tmp_path,
                                                           writer):
    sim = _pkg(writer)[0]
    path = tmp_path / "day.jsonl"
    sim.dump_arrivals_jsonl(
        sim.poisson_arrivals(110.0, n=800, seed=4, prompt_len=96,
                             max_new=24, prefix_share=0.5, prefix_len=64,
                             n_prefix_groups=3), path)
    want = _xday("jax", "prefix_affinity", False, path=path)
    for fast in (False, True):
        assert _xday("port", "prefix_affinity", fast, path=path) == want
    # replay_router_day is the same day through the router plane's door
    for which in PACKAGES:
        sim, rmod, _ = _pkg(which)
        clock = sim.VirtualClock()
        reps = [sim.SimReplica(clock, slots=4, n_inner=8, tick_s=0.02)
                for _ in range(3)]
        router = rmod.RequestRouter(reps, policy="least_loaded",
                                    clock=clock)
        rep = sim.replay_router_day(router, path)
        assert rep.dropped == 0
        if which == "port":
            got = rep.digest()
        else:
            assert rep.digest() == got


def _sweeps(which):
    sim = _pkg(which)[0]
    _, _, qos = _pkg(which)
    out = {}
    r = sim.sweep_router_policy(
        requests=600, load=0.8, straggler={0: 1.8}, tick_sigma=0.25,
        seed=4, prefix_share=0.5,
        policies=("round_robin", "least_loaded", "prefix_affinity"))
    out["router"] = (r["best"], r["p99_vs_round_robin"], r["entries"])
    t = sim.sweep_tenant_weights(
        contracts=[qos.TenantContract("lat", cls="latency", weight=1.0,
                                      rate=800.0, ttft_slo=2.0),
                   qos.TenantContract("bat", cls="batch", weight=1.0,
                                      rate=800.0)],
        candidates=[{"lat": 1.0, "bat": 1.0}, {"lat": 4.0, "bat": 1.0}],
        requests=400, seed=3)
    out["tenant"] = (t["best"], t["entries"])
    d = sim.sweep_tier_split(
        splits=[(1, 3), (2, 2)], requests=300, seed=7, long_share=0.15,
        long_prompt_len=1024, load=0.7, chunk_s=0.02, prompt_len=64,
        prompt_chunk=64)
    out["tier"] = (d["best"], d["entries"])
    c = sim.sweep_spill_capacity(store_groups_candidates=[0, 64],
                                 requests=300, seed=3, n_prefix_groups=24)
    out["spill"] = (c["best"], c["entries"])
    return out


def test_the_four_sweeps_recommend_alike_in_both_packages():
    port, ref = _sweeps("port"), _sweeps("jax")
    assert port == ref
    assert port["router"][0] != "round_robin"
