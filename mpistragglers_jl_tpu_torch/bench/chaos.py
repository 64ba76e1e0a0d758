"""The chaos rung: every episode of the catalog, twice (host only).

A port of ``benchmarks/chaos_bench.py``, widened from its one combo
episode (``storm_with_host_kill``) to every scenario in
``chaos.SCENARIOS``. Each episode runs twice through ``ChaosInjector``
with every pinned invariant armed inside the run, and the gates of the
reference hold for each: the two ``ChaosReport`` digests are equal,
nothing is dropped, 100% of shed requests carry a reason, and the peak
queue depth stays at or under the scenario's ceiling (128).

    python -m mpistragglers_jl_tpu_torch.bench.chaos [--scale S]

``--scale`` multiplies each episode's default size (``n`` requests, or
``steps`` for the page-churn episode). Prints one JSON line, host wall
clock, unrounded.
"""

from __future__ import annotations

import argparse
import inspect
import json
import time

_CEILING = 128  # the scenarios' pinned hard queue ceiling


def _sized(builder, scale: float) -> dict:
    """The episode's size argument, scaled from its default."""
    for name in ("n", "steps"):
        p = inspect.signature(builder).parameters.get(name)
        if p is not None:
            return {name: max(int(p.default * scale), 50)}
    return {}


def run_episode(name: str, seed: int = 20, scale: float = 1.0) -> dict:
    """One scenario twice; raises unless the reference's gates hold."""
    from ..chaos import SCENARIOS, ChaosInjector, get_scenario

    size = _sized(SCENARIOS[name], scale)
    t0 = time.perf_counter()
    inj = ChaosInjector()
    r1 = inj.run(get_scenario(name, seed=seed, **size))
    r2 = inj.run(get_scenario(name, seed=seed, **size))
    wall = time.perf_counter() - t0
    if r1.digest() != r2.digest():
        raise AssertionError(
            f"{name}: not bit-identical: {r1.digest()} != {r2.digest()}")
    if r1.dropped:
        raise AssertionError(f"{name}: {r1.dropped} requests dropped")
    if r1.shed_named_pct < 100.0:
        raise AssertionError(
            f"{name}: shed named {r1.shed_named_pct}% < 100: a bare drop")
    if r1.max_queue_depth > _CEILING:
        raise AssertionError(
            f"{name}: peak queue depth {r1.max_queue_depth} over "
            f"{_CEILING}")
    return {"size": size, "requests": int(r1.n_requests),
            "digest": r1.digest(), "invariants": list(r1.invariants),
            "shed": dict(r1.shed_reasons),
            "shed_named_pct": r1.shed_named_pct,
            "resubmits": int(r1.n_resubmits),
            "partitions": int(r1.n_partitions),
            "max_queue_depth": int(r1.max_queue_depth),
            "extras": {k: v for k, v in r1.extras.items()
                       if isinstance(v, (int, float, str))},
            "wall_s": wall}


def bench_chaos_suite(seed: int = 20, scale: float = 1.0) -> dict:
    from ..chaos import SCENARIOS

    return {name: run_episode(name, seed, scale)
            for name in sorted(SCENARIOS)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=20)
    args = ap.parse_args()
    print(json.dumps(bench_chaos_suite(args.seed, args.scale)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
