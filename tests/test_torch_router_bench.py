"""The router rung and the host-plane benches of the port on the CPU:
``bench/router.py`` (the router day on both drivers, the policy sweep,
the live half over a tiny paged model), ``bench/fleet.py`` and
``bench/chaos.py``, the code ``chip_smoke.py`` phases 52 and 54 run on
the card. The simulated results are virtual time, so they are held to
the JAX package's own drivers and sweeps on the same seeds (tolerance:
none); the live half's times are the CPU's and are checked only for
shape, never for speed.
"""

import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu_torch.bench import chaos as chaos_bench
from mpistragglers_jl_tpu_torch.bench import fleet as fleet_bench
from mpistragglers_jl_tpu_torch.bench import router as router_bench
from mpistragglers_jl_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_router_rung_days_agree_and_match_the_jax_package():
    from mpistragglers_jl_tpu.models.router import RequestRouter
    from mpistragglers_jl_tpu.sim import (
        SimReplica,
        VirtualClock,
        diurnal_arrivals,
        lognormal_ticks,
        run_router_day,
        sweep_router_policy,
    )

    out = router_bench.bench_router_rung(3000, witness=1000,
                                         sweep_requests=400)
    assert out["scalar"]["digest"] == out["fast"]["digest"]
    assert out["fast"]["path"] == "vectorized"
    # the same day through the JAX package's router and scalar driver
    clock = VirtualClock()
    fleet = [SimReplica(clock, slots=16, n_inner=32, prompt_chunk=128,
                        tick_s=lognormal_ticks(0.025, 0.2, seed=60 + i))
             for i in range(8)]
    router = RequestRouter(fleet, policy="least_loaded", clock=clock)
    cap = 8 * 16 / (2 * 0.025)  # the rung's own expression, bit for bit
    report = run_router_day(router, diurnal_arrivals(
        0.7 * cap, n=3000, period=86_400.0,
        amplitude=0.8, seed=4, prompt_len=128, max_new=32))
    assert report.digest() == out["fast"]["digest"]
    sweep = sweep_router_policy(
        requests=400, load=0.8, straggler={0: 1.8}, tick_sigma=0.25,
        seed=4, policies=("round_robin", "least_loaded",
                          "prefix_affinity"))
    assert out["sweep_best"] == sweep["best"]
    assert out["router_p99_x"] == sweep["p99_vs_round_robin"] > 1.15


def test_router_live_half_on_a_tiny_model():
    cfg = TransformerConfig(vocab=61, d_model=64, n_heads=8, n_kv_heads=2,
                            n_layers=2, d_ff=128, attn_window=24)
    out = router_bench.bench_router_live_rung(
        torch.device("cpu"), cfg=cfg,
        params=init_params(cfg, seed=3, device="cpu"),
        sched_kw=dict(slots=4, n_inner=4, prompt_chunk=8, max_prompt=64,
                      quantize_kv=True, page_tokens=4),
        requests=16, prompt_len=16, repeats=2)
    assert [r["policy"] for r in out["runs"]] == [
        "round_robin", "least_loaded", "least_loaded", "round_robin"]
    assert len(out["live_p99_x"]) == 2
    for r in out["runs"]:
        assert 0.0 <= r["router_share"] < 1.0
        assert 0.0 < r["p50_ttft_s"] <= r["p99_ttft_s"]
    assert out["kill_leg"]["dropped"] == 0
    assert sum(out["kill_leg"]["outcomes"].values()) == 16


class _Router:
    """The router surface ``drive_live`` touches, recording the order of
    health flips and steps."""

    def __init__(self):
        self.log, self.in_flight = [], 0
        self.replicas = []

    def mark_down(self, i):
        self.log.append(("down", i))

    def mark_up(self, i):
        self.log.append(("up", i))

    def submit(self, prompt, max_new):
        self.log.append("submit")
        return None

    def step(self):
        self.log.append("step")


def test_kill_leg_steps_between_down_and_up_however_late_the_loop():
    """Every request is already due at the first iteration (a loop
    slower than the arrivals): the replica still spends one router step
    marked down before it comes back, so its health probe sees it."""
    r = _Router()
    router_bench.drive_live(r, [np.arange(3)] * 6, 4, 0.0, kill_at=2,
                            recover_at=3)
    down, up = r.log.index(("down", 3)), r.log.index(("up", 3))
    assert "step" in r.log[down:up]
    assert r.log.count("submit") == 6


def test_gated_replica_ticks_once_and_its_hedge_loser_cancels_mid_admission(
        monkeypatch):
    """The fleet phase 52 builds for ``hedge_p99``: replica 0 gated for an
    hour ticks on its first step whatever the host clock reads (here a
    host up five seconds), prefilling one chunk of two; its leg misses
    the deadline, the hedge onto replica 1 wins, and the loser is
    cancelled mid-admission with its pages returned."""
    from mpistragglers_jl_tpu_torch.models.router import RequestRouter
    from mpistragglers_jl_tpu_torch.models.serving import ServingScheduler

    cfg = TransformerConfig(vocab=61, d_model=64, n_heads=8, n_kv_heads=2,
                            n_layers=2, d_ff=128, attn_window=24)
    params = init_params(cfg, seed=3, device="cpu")
    kw = dict(slots=4, n_inner=4, prompt_chunk=16, max_prompt=64,
              quantize_kv=True, page_tokens=4, device="cpu")
    boot = [5.0]

    def clock():
        boot[0] += 1e-3
        return boot[0]

    monkeypatch.setattr(router_bench.time, "perf_counter", clock)
    slow = router_bench.live_fleet(params, cfg, 3600.0,
                                   {**kw, "prompt_chunk": 8}, n=1,
                                   slow=0)[0].inner
    fast = ServingScheduler(params, cfg, **kw)
    router = RequestRouter([slow, fast], policy="hedge_p99", ttft_slo=0.02)
    rr = router.submit(np.arange(1, 17), 6)
    router.step()
    assert (slow.tick_count, slow.prefill_chunks, slow.active) == (1, 1, 1)
    router.drain()
    assert router.n_hedges == 1 and rr.outcome == "hedge_won"
    assert rr.replica == 1 and len(rr.tokens) == 6
    assert slow.tick_count == 1 and slow.active == slow.pending == 0
    slow.pool.check()
    assert slow.pool.used == 0


def test_fleet_rung_matches_the_jax_package(tmp_path):
    out = fleet_bench.bench_fleet_rung(3000)
    assert out["fleet_failover_drops"] == 0 and out["failovers"] == 1
    assert out["fleet_chip_time_x"] >= 1.2
    # the JAX package's rung on the same day: the same digest and books
    from benchmarks import fleet_bench as ref

    want = ref.bench_fleet_rung(3000)
    assert out["digest"] == want["digest"]
    assert (out["resizes"], out["recode_pairs"]) == (want["resizes"],
                                                     want["recode_pairs"])


def test_chaos_suite_gates_hold_for_every_episode():
    from mpistragglers_jl_tpu.chaos import ChaosInjector, get_scenario
    from mpistragglers_jl_tpu_torch.chaos import SCENARIOS

    out = chaos_bench.bench_chaos_suite(seed=5, scale=0.4)
    assert sorted(out) == sorted(SCENARIOS)
    for name, r in out.items():
        assert r["shed_named_pct"] == 100.0 and r["invariants"]
        ref = ChaosInjector().run(get_scenario(name, seed=5, **r["size"]))
        assert ref.digest() == r["digest"], name
