"""The router rung: the serving-tier router plane, simulated and live.

A port of ``benchmarks/router_bench.py``.

* **sim** (:func:`bench_router_rung`, host only): a seeded diurnal day
  over 8 straggling ``SimReplica`` schedulers through the real
  ``RequestRouter`` on a ``VirtualClock``, once through the scalar
  driver (``run_router_day``) and once through the vectorized one
  (``run_router_day_fast``): their digests must be equal, and each
  reports requests/s and events/s of host wall clock. A slice of the
  day runs twice for the bit-identity witness. Then the policy headline:
  ``sweep_router_policy`` at 0.8 load with a 1.8x straggling replica;
  ``router_p99_x`` is round_robin's p99 TTFT over the winner's.
* **live** (:func:`bench_router_live_rung`): four paged ``ServingScheduler``
  replicas on the card, replica 3 rate-limited to one tick per four warm
  ticks (the straggling replica). The warm tick is calibrated first; a
  closed burst through the straggling fleet measures the rate the
  single-threaded step loop delivers, and an open loop is paced at 0.8
  of it. ``round_robin`` and ``least_loaded`` each serve the same
  requests ``repeats`` times (round_robin, least_loaded, least_loaded,
  round_robin for two): p50/p99 TTFT on the host clock per run,
  ``live_p99_x`` = round_robin p99 / least_loaded p99 per pair, and the
  router's share of the stepping wall (the reference's gate reads <= 5%).
  Last, a kill/recover leg marks replica 3 down mid-run and up again and
  counts dropped and re-routed requests.

    python -m mpistragglers_jl_tpu_torch.bench.router [--device cpu]
        [--sim-requests N]

On the card the live model is ``MODEL`` (vocab 32768, d_model 1024, 8
heads over 2 kv heads, 8 layers, window 1024) in bf16, with the paged
int8 cache of 64-token pages, 8 slots and 8 inner steps a tick (every
decode tick runs K6); the reference's live half runs a 2-layer toy on
the slot ring. ``--device cpu`` runs that toy on pages of 4. The sim
half defaults to 200k requests (the reference's 1M cut to fit a few
seconds of host time). Prints one JSON line, host wall clock, unrounded.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np

# the sim day's fleet (replicas, slots each, mean tick); the live
# half's straggling replica, new tokens per request and prompt seed
SIM_REPLICAS, SIM_SLOTS, SIM_TICK_S = 8, 16, 0.025
SLOW_REPLICA, MAX_NEW, SEED = 3, 16, 8


def _fleet(clock):
    from ..sim import SimReplica, lognormal_ticks

    return [
        SimReplica(
            clock, slots=SIM_SLOTS, n_inner=32, prompt_chunk=128,
            tick_s=lognormal_ticks(SIM_TICK_S, 0.2, seed=60 + i),
        )
        for i in range(SIM_REPLICAS)
    ]


def router_day(requests, *, seed=4, fast=False):
    """One seeded diurnal day at 0.7 of the fleet's mean capacity;
    returns (report, scheduler ticks replayed, host seconds)."""
    from ..models.router import RequestRouter
    from ..sim import (
        VirtualClock,
        diurnal_arrival_batch,
        diurnal_arrivals,
        run_router_day,
        run_router_day_fast,
    )

    clock = VirtualClock()
    fleet = _fleet(clock)
    router = RequestRouter(fleet, policy="least_loaded", clock=clock)
    # 2 ticks per request at mean tick
    cap = SIM_REPLICAS * SIM_SLOTS / (2 * SIM_TICK_S)
    kw = dict(n=requests, period=86_400.0, amplitude=0.8, seed=seed,
              prompt_len=128, max_new=32)
    t0 = time.perf_counter()
    if fast:
        report = run_router_day_fast(
            router, diurnal_arrival_batch(0.7 * cap, **kw))
    else:
        report = run_router_day(router, diurnal_arrivals(0.7 * cap, **kw))
    wall = time.perf_counter() - t0
    return report, sum(r.tick_count for r in fleet), wall


def bench_router_rung(requests: int = 200_000, witness: int = 20_000,
                      sweep_requests: int = 3000) -> dict:
    """The sim half: the day on both drivers (equal digests required),
    the bit-identity witness, and the swept policy headline."""
    d1, _, _ = router_day(min(witness, requests), seed=11)
    d2, _, _ = router_day(min(witness, requests), seed=11)
    if d1.digest() != d2.digest():
        raise AssertionError(
            f"sim day not bit-identical: {d1.digest()} != {d2.digest()}")
    out = {"sim_requests": requests, "replay_digest": d1.digest()}
    digests = {}
    for name, fast in (("scalar", False), ("fast", True)):
        report, ticks, wall = router_day(requests, fast=fast)
        if report.dropped:
            raise AssertionError(f"{report.dropped} requests dropped")
        digests[name] = report.digest()
        out[name] = {"wall_s": wall, "req_per_s": requests / wall,
                     "events_per_s": (requests + ticks) / wall,
                     "virtual_s": report.virtual_s,
                     "p99_ttft_s": report.p99_ttft(),
                     "path": getattr(report, "fastpath", None),
                     "digest": report.digest()}
    if digests["scalar"] != digests["fast"]:
        raise AssertionError(
            f"fast driver digest {digests['fast']} != scalar "
            f"{digests['scalar']}")
    out["fast_x"] = out["scalar"]["wall_s"] / out["fast"]["wall_s"]
    from ..sim import sweep_router_policy

    sweep = sweep_router_policy(
        requests=sweep_requests, load=0.8, straggler={0: 1.8},
        tick_sigma=0.25, seed=4,
        policies=("round_robin", "least_loaded", "prefix_affinity"),
    )
    out["sweep_best"] = sweep["best"]
    out["sweep_p99_s"] = {e["policy"]: e["p99_ttft_s"]
                          for e in sweep["entries"]}
    out["router_p99_x"] = sweep["p99_vs_round_robin"]
    return out


class TimedReplica:
    """Forwarding proxy that clocks the scheduler's own ``step()`` wall,
    so the live rung can separate router bookkeeping from scheduler
    ticks (the 5% budget is on the router's share)."""

    def __init__(self, inner):
        self.inner = inner
        self.step_s = 0.0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def step(self):
        t0 = time.perf_counter()
        out = self.inner.step()
        self.step_s += time.perf_counter() - t0
        return out


def live_fleet(params, cfg, stall_s, sched_kw, n=4, slow=SLOW_REPLICA):
    """``n`` schedulers behind :class:`TimedReplica`; replica ``slow``
    ticks on its first step, then at most once per ``stall_s`` of wall
    clock."""
    from ..models.serving import ServingScheduler

    class Stalled(ServingScheduler):
        """A replica rate-limited to one tick per ``stall_s``: slow
        without blocking the shared step loop (a sleeping straggler
        would serialize every replica behind it, which independent
        scheduler processes do not do)."""

        _last_gate = -math.inf

        def step(self):
            now = time.perf_counter()
            if now - self._last_gate < stall_s:
                return []
            self._last_gate = now
            return super().step()

    return [
        TimedReplica((Stalled if i == slow else ServingScheduler)(
            params, cfg, **sched_kw))
        for i in range(n)
    ]


def drive_live(router, prompts, max_new, inter_arrival_s, kill_at=None,
               recover_at=None, min_work_s=0.0):
    """Open-loop pacing on the wall clock: request i is due at
    ``t0 + i * inter_arrival_s`` and every due request is submitted
    before the next step; optionally mark replica ``SLOW_REPLICA`` down
    and up at given request indices (the kill/recover leg). Returns (routed
    requests, stepping wall of the iterations where a scheduler ticked,
    scheduler wall inside them)."""
    rrs = []
    t0 = time.perf_counter()
    step_work = sched_work = sched_prev = 0.0
    i = steps = 0
    down_at = None  # the step count when the replica went down
    while i < len(prompts) or router.in_flight:
        now = time.perf_counter() - t0
        while i < len(prompts) and now >= i * inter_arrival_s:
            if kill_at is not None and i == kill_at:
                router.mark_down(SLOW_REPLICA)
                down_at = steps
            if recover_at is not None and i == recover_at:
                if down_at is not None and steps == down_at:
                    # a step whose health probe sees the replica down
                    # comes first, however late the loop runs
                    break
                router.mark_up(SLOW_REPLICA)
            rrs.append(router.submit(prompts[i], max_new))
            i += 1
        s0 = time.perf_counter()
        router.step()
        steps += 1
        dt = time.perf_counter() - s0
        sched_now = sum(r.step_s for r in router.replicas)
        if sched_now - sched_prev > min_work_s:
            # a real tick ran (the threshold screens out iterations
            # whose only work was a rate-gate check)
            step_work += dt
            sched_work += sched_now - sched_prev
        sched_prev = sched_now
    return rrs, step_work, sched_work


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_router_live_rung(device=None, *, params=None, cfg=None,
                           sched_kw=None, requests: int = 40,
                           prompt_len: int = 128,
                           repeats: int = 2) -> dict:
    """The live half at one configuration: ``MODEL`` in bf16 on the
    card, paged, unless ``cfg``/``params``/``sched_kw`` are given."""
    import torch

    from .._device import resolve_device
    from ..models.router import RequestRouter
    from ..models.transformer import TransformerConfig, init_params
    from ..ops import decode_attention as da
    from .serving_profile import MODEL

    dev = resolve_device(device)
    if cfg is None:
        cfg = TransformerConfig(**MODEL, dtype=torch.bfloat16)
    if params is None:
        params = init_params(cfg, seed=0, device=dev)
    if sched_kw is None:
        sched_kw = dict(slots=8, n_inner=8, prompt_chunk=256,
                        max_prompt=512, quantize_kv=True, page_tokens=64)
    sched_kw = {**sched_kw, "device": dev}
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab, size=prompt_len)
               for _ in range(requests)]
    k6_0 = da.LAUNCHES["paged_decode_attention"]
    # calibrate the warm tick: one request to completion first (first
    # launches build and load the kernels), then time a second
    warm = live_fleet(params, cfg, 0.0, sched_kw, n=1, slow=-1)[0]
    for p in prompts[:2]:
        _sync(dev)
        t0 = time.perf_counter()
        n0 = warm.tick_count
        warm.submit(p, MAX_NEW)
        while warm.active or warm.pending:
            warm.step()
        _sync(dev)
    tick_s = (time.perf_counter() - t0) / max(warm.tick_count - n0, 1)
    del warm
    stall_s = 4.0 * tick_s  # replica 3 ticks at 1/4 the fleet rate
    # 0.8 utilization of the rate the single-threaded step loop really
    # delivers through the straggling fleet, from a closed burst
    router = RequestRouter(live_fleet(params, cfg, stall_s, sched_kw),
                           policy="least_loaded")
    burst = min(24, requests)
    t0 = time.perf_counter()
    for p in prompts[:burst]:
        router.submit(p, MAX_NEW)
    router.drain()
    fleet_rate = burst / (time.perf_counter() - t0)
    inter = 1.0 / (0.8 * fleet_rate)
    del router
    out = {"tick_s": tick_s, "stall_s": stall_s,
           "fleet_req_per_s": fleet_rate, "inter_arrival_s": inter,
           "requests": requests, "prompt_len": prompt_len,
           "max_new": MAX_NEW, "runs": []}
    order = (["round_robin", "least_loaded"]
             + ["least_loaded", "round_robin"] * (repeats > 1)
             + ["round_robin", "least_loaded"] * max(repeats - 2, 0))
    for policy in order:
        router = RequestRouter(live_fleet(params, cfg, stall_s, sched_kw),
                               policy=policy)
        rrs, step_work, sched_work = drive_live(
            router, prompts, MAX_NEW, inter, min_work_s=0.1 * tick_s)
        if not all(rr.finished for rr in rrs):
            raise AssertionError(f"{policy}: a request never finished")
        ttfts = np.asarray([rr.ttft for rr in rrs])
        out["runs"].append({
            "policy": policy,
            "p50_ttft_s": float(np.percentile(ttfts, 50)),
            "p99_ttft_s": float(np.percentile(ttfts, 99)),
            "router_share": max(step_work - sched_work, 0.0) / step_work,
            "stepping_wall_s": step_work,
        })
        del router
    by = {p: [r for r in out["runs"] if r["policy"] == p]
          for p in ("round_robin", "least_loaded")}
    out["live_p99_x"] = [a["p99_ttft_s"] / b["p99_ttft_s"]
                         for a, b in zip(by["round_robin"],
                                         by["least_loaded"])]
    out["router_share_max"] = max(r["router_share"] for r in out["runs"])
    # kill/recover: replica 3 marked down mid-run and up again; denser
    # arrivals keep every replica holding live requests when it flips
    fleet = live_fleet(params, cfg, 0.0, sched_kw)
    router = RequestRouter(fleet, policy="least_loaded")
    n_kill = max(requests // 2, 16)
    rrs, _, _ = drive_live(router, prompts[:n_kill], MAX_NEW + 8,
                           inter * 0.3, kill_at=8, recover_at=n_kill - 4)
    out["kill_leg"] = {
        "requests": n_kill,
        "dropped": sum(not rr.finished for rr in rrs),
        "rerouted": router.n_rerouted,
        "outcomes": {o: sum(rr.outcome == o for rr in rrs)
                     for o in sorted({rr.outcome for rr in rrs})},
    }
    del router, fleet
    out["k6_launches"] = da.LAUNCHES["paged_decode_attention"] - k6_0
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu runs a tiny model (default: the card)")
    ap.add_argument("--sim-requests", type=int, default=200_000)
    args = ap.parse_args()
    out = {"sim": bench_router_rung(args.sim_requests)}
    if args.device is not None and args.device.startswith("cpu"):
        import torch

        from ..models.transformer import TransformerConfig, init_params

        cfg = TransformerConfig(vocab=61, d_model=64, n_heads=8,
                                n_kv_heads=2, n_layers=2, d_ff=128,
                                attn_window=24)
        out["live"] = bench_router_live_rung(
            torch.device("cpu"), cfg=cfg,
            params=init_params(cfg, seed=3, device="cpu"),
            sched_kw=dict(slots=4, n_inner=4, prompt_chunk=8,
                          max_prompt=64, quantize_kv=True, page_tokens=4),
            prompt_len=16)
    else:
        out["live"] = bench_router_live_rung(args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
