"""Gradient-coded training of the flagship transformer over the pool on
CUDA streams: ``models/coded_train.py`` ``CodedGradTrainer`` on one card.

The flagship (vocab 32768, d_model 1024, 8 heads of 128, 8 layers, d_ff
4096, bf16, flash attention K1-K3) trained by SGD over n = 6 pool
workers (CUDA streams) with the cyclic gradient code tolerating s = 2,
the shape of ``examples/coded_transformer_training.py`` and
``tests/test_coded_train.py``. Chunk j is (2, 2049) tokens from
``np.random.default_rng((seed, j))``, so the full batch is 12 x 2048
tokens. Workers 1 and 4 stall ``--delay`` seconds before every task
(the example stalls them 1.0 s; the bf16 run stalls them ``DELAY_S``,
longer than a coded epoch lasts here, see below).

    python -m mpistragglers_jl_tpu_torch.bench.coded_train [--epochs 3]
        [--delay 4.0] [--exact-delay 0.5] [--seed 0]

Prints the card's name and power limit (``nvidia-smi``), then two JSON
lines:

* the f32 exactness check (flash f32 route, TF32 off): 2 coded epochs
  with the stragglers delayed ``--exact-delay`` seconds against direct full-batch SGD on the mean
  of the 6 chunk losses from the same parameters; each leaf's change
  over the two epochs within ``EXACT_TOL`` relative Frobenius difference
  of the direct run's, and a broken control (the last epoch decoded
  from all but one of its fresh workers, with the full fresh set's
  weights) that must miss it;
* the bf16 run: one warm-up epoch, ``--epochs`` coded epochs (``nwait
  = n - s``) and as many bulk-synchronous ones (``nwait = n``), each
  timed to a synchronize; ms/epoch of both, ``vs_baseline`` (bulk over
  coded), full-batch tokens/s, the fresh set of each coded epoch and
  whether the stragglers were out at its return, the flash kernels'
  launches over the coded epochs (read after the drain; at least 8 x
  (s+1) x (n-s) per epoch), the device's busy time and idle share over
  one traced coded epoch, and peak memory.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..backends.cuda import consume
from ..models.coded_train import CodedGradTrainer, transformer_chunk_loss
from ..models.transformer import TransformerConfig, _leaves, init_params
from ..ops import flash_attention as fa
from ..pool import AsyncPool, waitall
from .coded_gemm import device_ms
from .decode_kernel_attrib import card
from .train_profile import TRAIN, _free_garbage

N, S = 6, 2
ROWS, SEQ = 2, 2048  # a chunk is (ROWS, SEQ + 1) tokens
STRAGGLERS = (1, 4)
LR = 1e-3  # bf16 run (the train bench's rate)
# f32 check: a larger rate, so each leaf's change is many f32 ulps of
# the weight it moves
LR_F32 = 0.1
# f32 check: each leaf's change over the two coded epochs against the
# direct full-batch run's, relative Frobenius difference. Both take the
# same chunk gradients (the same kernels on the same inputs); the coded
# run sums them through the code's weights and the decode's weights in
# f32, whose error grows with the decode's condition.
EXACT_TOL = 1e-3
EXACT_EPOCHS = 2
DRAIN_S = 120.0
# bf16 run: the stragglers' stall. The run requires both stragglers to
# be out (still in flight) at every coded return, which holds only if
# the stall outlasts the four fresh workers' epoch. The epoch is paced by
# the host (six dispatcher threads under one GIL) and took 0.9-2.9 s on
# an H100 80GB HBM3 at 700 W; at a 0.5 s stall a woken straggler
# competes with the fresh workers and now and then finishes first.
DELAY_S = 4.0
# f32 check: the stall there only shapes the fresh sets; nothing is
# required of who is out
EXACT_DELAY_S = 0.5


def chunk_fn(vocab: int, seed: int = 0):
    """``chunk(j)``: (ROWS, SEQ + 1) int tokens from
    ``np.random.default_rng((seed, j))``."""

    def chunk(j):
        rng = np.random.default_rng((seed, j))
        return rng.integers(0, vocab, (ROWS, SEQ + 1)).astype(np.int32)

    return chunk


def _trainer(cfg, params0, dev, delay_s, seed):
    return CodedGradTrainer(
        transformer_chunk_loss(cfg), params0, chunk_fn(cfg.vocab, seed),
        N, S, devices=[dev],
        delay_fn=lambda i, e: delay_s if i in STRAGGLERS else 0.0)


def _direct_flat(tr, flat_w, chunk) -> torch.Tensor:
    """The full-batch gradient (mean of the n chunk losses' gradients)
    at ``flat_w``, one chunk at a time, raveled in f32."""
    leaves = [t.detach().requires_grad_(True)
              for t in tr._flat.leaves(flat_w)]
    params = tr._flat.tree(leaves)
    g = torch.zeros_like(flat_w)
    parts = tr._flat.split(g)
    for j in range(N):
        with torch.enable_grad():
            grads = torch.autograd.grad(tr._loss_fn(params, chunk(j)),
                                        leaves)
        with torch.no_grad():
            for o, gj in zip(parts, grads):
                o.add_(gj)
    return g / N


def _leaf_errors(tr, got, want) -> list:
    return [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            for a, b in zip(tr._flat.split(got), tr._flat.split(want))]


def exactness_f32(dev, *, delay_s: float = EXACT_DELAY_S,
                  seed: int = 0) -> dict:
    """Coded epochs in f32 against direct full-batch SGD from the same
    parameters (see the module docstring)."""
    cfg = TransformerConfig(**TRAIN, dtype=torch.float32)
    params0 = init_params(cfg, seed=seed, device=dev)
    tr = _trainer(cfg, params0, dev, delay_s, seed)
    chunk = chunk_fn(cfg.vocab, seed)
    pool = AsyncPool(N)
    fresh = []
    try:
        flat0 = tr._flat0
        flat = flat0
        for _ in range(EXACT_EPOCHS):
            prev = flat
            params = tr.step(pool, tr._flat.tree(tr._flat.leaves(flat)),
                             lr=LR_F32)
            flat = tr._flat.ravel(params, dev)
            fresh.append(tr.last_fresh.tolist())
        # the control: the last epoch decoded without one fresh worker,
        # with the full fresh set's weights
        last = tr.last_fresh
        a = torch.as_tensor(tr.code.decode_weights(last),
                            dtype=torch.float32, device=dev)
        G = torch.stack([consume(pool.results[i]) for i in last[:-1]])
        g_bad = (a[:-1] @ G) / N
        bad = prev - LR_F32 * g_bad
        del G
        waitall(pool, tr.backend, timeout=DRAIN_S)
    finally:
        tr.backend.shutdown()
    want = flat0
    for _ in range(EXACT_EPOCHS):
        want = want - LR_F32 * _direct_flat(tr, want, chunk)
    errs = _leaf_errors(tr, flat - flat0, want - flat0)
    ctrl = _leaf_errors(tr, bad - flat0, want - flat0)
    return {
        "epochs": EXACT_EPOCHS, "lr": LR_F32, "fresh_sets": fresh,
        "leaf_rel_err": errs, "worst_leaf_rel_err": max(errs),
        "ctrl_worst_leaf_rel_err": max(ctrl),
        "ctrl_best_leaf_rel_err": min(ctrl), "tol": EXACT_TOL,
        "ok": max(errs) <= EXACT_TOL and min(ctrl) > EXACT_TOL,
    }


def _timed_epoch(tr, pool, params, nwait=None):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tr.step(pool, params, lr=LR, nwait=nwait)
    torch.cuda.synchronize()
    return params, (time.perf_counter() - t0) * 1e3


def bench_coded_train(dev, *, epochs: int = 3, delay_s: float = DELAY_S,
                      seed: int = 0) -> dict:
    """The bf16 run (see the module docstring)."""
    cfg = TransformerConfig(**TRAIN, dtype=torch.bfloat16)
    params = init_params(cfg, seed=seed, device=dev)
    n_params = sum(p.numel() for p in _leaves(params))
    tr = _trainer(cfg, params, dev, delay_s, seed)
    pool = AsyncPool(N)
    _free_garbage()  # before the warm-up, which refills the block cache
    try:
        params, warm_ms = _timed_epoch(tr, pool, params)
        waitall(pool, tr.backend, timeout=DRAIN_S)
        torch.cuda.reset_peak_memory_stats(dev)
        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        coded, fresh, out = [], [], []
        for _ in range(epochs):
            params, ms = _timed_epoch(tr, pool, params)
            coded.append(ms)
            fresh.append(tr.last_fresh.tolist())
            out.append(all(bool(pool.active[i]) for i in STRAGGLERS))
        waitall(pool, tr.backend, timeout=DRAIN_S)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        bulk = []
        for _ in range(epochs):
            params, ms = _timed_epoch(tr, pool, params, nwait=N)
            bulk.append(ms)
        traced = device_ms(lambda: tr.step(pool, params, lr=LR), 1)
        waitall(pool, tr.backend, timeout=DRAIN_S)
        loss = tr.full_batch_loss(params)
    finally:
        tr.backend.shutdown()
    coded_ms, bulk_ms = float(np.mean(coded)), float(np.mean(bulk))
    want = cfg.n_layers * (S + 1) * (N - S) * epochs
    rep = {
        "metric": "coded-transformer-epoch", "n_workers": N, "s": S,
        "nwait": N - S, "stragglers": list(STRAGGLERS), "delay_s": delay_s,
        "chunk": [ROWS, SEQ + 1], "epochs": epochs,
        "params_m": n_params / 1e6,
        "warmup_epoch_ms": warm_ms, "coded_epoch_ms": coded,
        "bulk_epoch_ms": bulk, "ms_per_epoch": coded_ms,
        "nwait_n_epoch_ms": bulk_ms, "vs_baseline": bulk_ms / coded_ms,
        "full_batch_tokens_per_s": N * ROWS * SEQ / coded_ms * 1e3,
        "fresh_sets": fresh, "stragglers_out_at_return": out,
        "launches": launches, "launches_at_least": want,
        "peak_mem_gb": peak / 1e9, "full_batch_loss_after": loss,
    }
    if traced is not None:
        wall_ms, busy_ms, top = traced
        rep.update({"traced_epoch_ms": wall_ms, "device_busy_ms": busy_ms,
                    "device_idle_share": 1.0 - busy_ms / wall_ms,
                    "top_kernels_ms": top})
    rep["ok"] = (all(out) and np.isfinite(loss)
                 and all(launches[k] >= want for k in
                         ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
                 and launches["flash_bwd_fused"] == 0)
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--delay", type=float, default=DELAY_S)
    ap.add_argument("--exact-delay", type=float, default=EXACT_DELAY_S)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    name, smi = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"device: {name}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(smi)
    exact = exactness_f32(dev, delay_s=args.exact_delay, seed=args.seed)
    print(json.dumps({"exactness_f32": exact, "card": smi}), flush=True)
    torch.cuda.empty_cache()
    res = bench_coded_train(dev, epochs=args.epochs, delay_s=args.delay,
                            seed=args.seed)
    res["card"] = smi
    print(json.dumps(res))
    return 0 if exact["ok"] and res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
