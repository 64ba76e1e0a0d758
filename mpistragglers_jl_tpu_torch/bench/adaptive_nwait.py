"""Bench of the pool-level utils on CUDA streams: adaptive ``nwait``
against fixed policies, trace replay into config 5, hedged requests and
a pool checkpoint.

    python -m mpistragglers_jl_tpu_torch.bench.adaptive_nwait
        [--rungs policies,coded_sgd,hedge] [--epochs 100]
        [--sgd-epochs 20] [--sgd-slow 0.1] [--rotate 5] [--requests 40]

Prints the card's name and power limit (``nvidia-smi``), then one JSON
line per rung (the reference's values in brackets where a default cuts
them):

* ``policies``: ``benchmarks/adaptive_nwait_bench.py``'s three policies
  over 8 stream workers (``CUDADeviceBackend``): 5 ms base latency, a
  75 ms straggler rotating every 20 epochs, ``--epochs`` epochs;
  full gather (``nwait=8``), fixed ``nwait=6`` and ``AdaptiveNwait(kmin=4)``;
  mean ms per epoch and fresh results per epoch;
* ``coded_sgd``: one rotating-straggler trace recorded with
  ``EpochTracer`` over 16 stream workers (0.1 s straggler [0.6], moving
  every 5 epochs [20], 20 epochs [60], full gather), replayed through
  ``faults.from_trace`` into BASELINE config 5's ``CodedSGD`` (1e6 x
  1024 on the card, 16 workers, s=2) under full gather and
  ``AdaptiveNwait(kmin=n-s)``: ms per step, final loss, final nwait;
  both decode the exact gradient, so the final weights must agree
  within ``SGD_TOL`` (relative to their largest element); then the
  drained pool is checkpointed (``utils.checkpoint.save``) and
  restored, and the two states must be equal;
* ``hedge``: ``HedgedServer`` over 4 stream replicas, each request one
  4096^2 bf16 product on the card, replica 0 stalled 50 ms on every
  dispatch; ``--requests`` requests at hedge 1 and at hedge 2; p50 and
  p99 request ms.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..backends.cuda import CUDADeviceBackend
from ..models.logreg import CodedSGD
from ..pool import AsyncPool, asyncmap, waitall
from ..utils import AdaptiveNwait, EpochTracer, HedgedServer, faults
from ..utils import checkpoint
from .coded_gemm import (SGD_DIM, SGD_LR, SGD_N, SGD_ROWS, SGD_S, SGD_TOL,
                         _sync, rel_err)
from .decode_kernel_attrib import card

POLICY_N, BASE_S, STRAGGLE_S, ROTATE_EVERY = 8, 0.005, 0.075, 20
HEDGE_N, HEDGE_DIM, HEDGE_STALL_S = 4, 4096, 0.05


class RotatingStraggler:
    """The straggler moves to worker ``(epoch // rotate_every) % n``
    (``benchmarks/adaptive_nwait_bench.py``)."""

    def __init__(self, n: int, slow: float, base: float = BASE_S,
                 rotate_every: int = ROTATE_EVERY):
        self.n, self.slow, self.base = n, slow, base
        self.rotate_every = rotate_every

    def __call__(self, worker: int, epoch: int) -> float:
        hot = (epoch // self.rotate_every) % self.n
        return self.slow if worker == hot else self.base


def _echo(i, payload, epoch):
    return payload + i


def run_policy(dev, name: str, epochs: int) -> dict:
    backend = CUDADeviceBackend(
        _echo, POLICY_N, devices=[dev],
        delay_fn=RotatingStraggler(POLICY_N, STRAGGLE_S))
    ctl = (AdaptiveNwait(POLICY_N, kmin=4, min_samples=2, refit_every=5,
                         seed=0) if name == "adaptive" else None)
    fixed = None if ctl else {"full-gather": POLICY_N, "fixed-k6": 6}[name]
    payload = torch.zeros(1, device=dev)
    try:
        pool = AsyncPool(POLICY_N)
        walls, fresh = [], []
        for _ in range(epochs):
            nwait = ctl.nwait if ctl else fixed
            t0 = time.perf_counter()
            asyncmap(pool, payload, backend, nwait=nwait)
            walls.append(time.perf_counter() - t0)
            fresh.append(int(pool.fresh_indices().size))
            if ctl:
                ctl.observe(pool)
        waitall(pool, backend, timeout=60)
    finally:
        backend.shutdown()
    return {"policy": name, "ms_per_epoch": float(np.mean(walls)) * 1e3,
            "fresh_mean": float(np.mean(fresh)), "epochs": epochs,
            "final_nwait": ctl.nwait if ctl else fixed}


def policies(dev, *, epochs=100) -> dict:
    runs = [run_policy(dev, p, epochs)
            for p in ("full-gather", "fixed-k6", "adaptive")]
    by = {r["policy"]: r for r in runs}
    return {"rung": "policies", "n": POLICY_N, "base_s": BASE_S,
            "straggler_s": STRAGGLE_S, "rotate_every": ROTATE_EVERY,
            "runs": runs,
            "ok": by["adaptive"]["ms_per_epoch"]
            < by["full-gather"]["ms_per_epoch"]}


def record_trace(dev, path, *, n=SGD_N, slow=0.1, rotate_every=5,
                 epochs=20) -> EpochTracer:
    """One rotating-straggler trace over ``n`` stream workers (full
    gather), dumped as JSONL for ``faults.from_trace``."""
    tracer = EpochTracer()
    backend = CUDADeviceBackend(
        _echo, n, devices=[dev],
        delay_fn=RotatingStraggler(n, slow, rotate_every=rotate_every))
    try:
        pool = AsyncPool(n)
        payload = torch.zeros(1, device=dev)
        for _ in range(epochs):
            asyncmap(pool, payload, backend, nwait=n, tracer=tracer)
        waitall(pool, backend, timeout=60)
    finally:
        backend.shutdown()
    tracer.dump_jsonl(path)
    return tracer


def coded_sgd(dev, *, epochs=20, slow=0.1, rotate_every=5, seed=0) -> dict:
    n, s = SGD_N, SGD_S
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.jsonl")
        tracer = record_trace(dev, path, n=n, slow=slow,
                              rotate_every=rotate_every, epochs=epochs)
        t0 = time.perf_counter()
        sgd = CodedSGD.synthetic(SGD_ROWS, SGD_DIM, n, s, devices=[dev],
                                 seed=seed, delay_fn=faults.from_trace(path))
        _sync()
        setup_s = time.perf_counter() - t0
        X_eval, y_eval = sgd.eval_data()
        runs, weights, state_equal = [], [], False
        try:
            for adaptive in (False, True):
                ctl = (AdaptiveNwait(n, kmin=n - s, min_samples=2,
                                     refit_every=5, seed=0)
                       if adaptive else None)
                pool = AsyncPool(n)
                w = torch.zeros(SGD_DIM, device=dev)
                walls = []
                for _ in range(epochs):
                    t0 = time.perf_counter()
                    w = sgd.step(pool, w, SGD_LR,
                                 nwait=ctl.nwait if ctl else n)
                    _sync()
                    walls.append(time.perf_counter() - t0)
                    if ctl:
                        ctl.observe(pool)
                waitall(pool, sgd.backend, timeout=60)
                weights.append(w)
                runs.append({
                    "policy": "adaptive" if adaptive else "full-gather",
                    "ms_per_step": float(np.mean(walls)) * 1e3,
                    "final_loss": float(sgd.model.loss(w, X_eval, y_eval)),
                    "final_nwait": ctl.nwait if ctl else n})
            # the drained pool's checkpoint round trip
            ck = os.path.join(tmp, "pool.json")
            checkpoint.save(pool, ck)
            back = checkpoint.restore(ck)
            state_equal = (checkpoint.state_dict(back)
                           == checkpoint.state_dict(pool))
        finally:
            sgd.backend.shutdown()
    # both policies decode the exact full gradient (any n - s of n
    # shards), so their weights agree to f32 rounding
    w_err = rel_err(weights[1], weights[0])
    return {
        "rung": "coded_sgd", "n": n, "s": s, "rows": SGD_ROWS,
        "dim": SGD_DIM, "trace": {"epochs": epochs, "slow_s": slow,
                                  "rotate_every": rotate_every,
                                  "straggler_rate":
                                  tracer.summary()["straggler_rate"]},
        "runs": runs, "setup_s": setup_s,
        "checkpoint_round_trip_equal": bool(state_equal),
        "w_adaptive_vs_full": w_err, "w_tol": SGD_TOL,
        "ok": bool(state_equal) and w_err <= SGD_TOL and all(
            np.isfinite(r["final_loss"]) and r["final_loss"] < np.log(2)
            for r in runs),
    }


def hedge(dev, *, requests=40, seed=0) -> dict:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    W = [torch.randn(HEDGE_DIM, HEDGE_DIM, generator=g, device=dev,
                     dtype=torch.bfloat16) for _ in range(HEDGE_N)]
    x = torch.randn(HEDGE_DIM, HEDGE_DIM, generator=g, device=dev,
                    dtype=torch.bfloat16)
    backend = CUDADeviceBackend(
        lambda i, p, e: p @ W[i], HEDGE_N, devices=[dev],
        delay_fn=faults.per_worker({0: HEDGE_STALL_S}))
    out = {"rung": "hedge", "replicas": HEDGE_N, "requests": requests,
           "product": f"{HEDGE_DIM}^2 bf16", "stalled": {"replica": 0,
                                                         "s": HEDGE_STALL_S}}
    ok = True
    try:
        srv = HedgedServer(backend)
        srv.request(x, hedge=HEDGE_N)  # warm every replica's stream
        srv.drain()
        for width in (1, 2):
            ms, ranks = [], []
            for _ in range(requests):
                t0 = time.perf_counter()
                result, rank, _ = srv.request(x, hedge=width)
                _sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                ranks.append(rank)
                ok &= bool(torch.equal(result, x @ W[rank]))
            srv.drain()
            out[f"hedge_{width}"] = {
                "p50_ms": float(np.percentile(ms, 50)),
                "p99_ms": float(np.percentile(ms, 99)),
                "max_ms": float(np.max(ms)),
                "wins_by_rank": {str(r): ranks.count(r)
                                 for r in range(HEDGE_N)}}
    finally:
        backend.shutdown()
    out["ok"] = bool(ok) and (out["hedge_2"]["p99_ms"]
                              < out["hedge_1"]["p99_ms"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rungs", default="policies,coded_sgd,hedge")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--sgd-epochs", type=int, default=20)
    ap.add_argument("--sgd-slow", type=float, default=0.1)
    ap.add_argument("--rotate", type=int, default=5)
    ap.add_argument("--requests", type=int, default=40)
    args = ap.parse_args(argv)
    name, smi = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"device: {name}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(smi)
    runs = {
        "policies": lambda: policies(dev, epochs=args.epochs),
        "coded_sgd": lambda: coded_sgd(dev, epochs=args.sgd_epochs,
                                       slow=args.sgd_slow,
                                       rotate_every=args.rotate),
        "hedge": lambda: hedge(dev, requests=args.requests),
    }
    ok = True
    for r in args.rungs.split(","):
        res = runs[r.strip()]()
        res["card"] = smi
        print(json.dumps(res), flush=True)
        ok &= res["ok"]
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
