"""Bench of the port's main path on one card: BASELINE configs 2-5.

    python -m mpistragglers_jl_tpu_torch.bench.coded_gemm [--configs 2,3,4,5]
        [--seed 0] [--delay3 1.0] [--delay4 5.0] [--delay5 2.0]
        [--epochs5 10]

Prints the card's name and power limit (``nvidia-smi``), then one JSON
line per config:

* config 2, uncoded GEMM (``bench.py:1644``): 4096^3 f32 over 4 workers,
  ``nwait=n``, one stacked product per epoch;
* config 3, (n=8, k=6) MDS-coded GEMM (``bench.py:72``): 8192^3, A padded
  to 8196 rows, ``nwait=k``; one stacked product per epoch with
  ``"ready"`` and ``"enqueue"`` arrival at ``"highest"`` (f32, TF32 off)
  and ``"default"`` (bf16 operands, f32 sums and decode); then a
  per-worker rung with workers 2 and 5 delayed, whose epochs decode from
  the parity shards;
* config 4, LT-coded GEMM (``benchmarks/config4_lt_gemm.py``): 16384^2
  over 16 workers, k=8, the variable decodability ``nwait``, workers 3
  and 11 delayed; decoded on the device and checked against the host
  peel of the same epoch;
* config 5, gradient-coded SGD (``benchmarks/config5_gradcoded_sgd.py``):
  ``CodedSGD.synthetic`` at 1e6 x 1024, 16 workers, s=2 (``nwait=14``),
  workers 2 and 9 delayed; the loss must fall, and one coded step is held
  to an uncoded full-batch step from the same ``w``.

Timing, as ``bench.py:72``: per-epoch wall clock over a chain of epochs
that ends in one ``torch.cuda.synchronize()``, the least of 3 chains.
MFU is against one raw ``torch.matmul`` of the product's shape at the
same precision, timed the same way in the same process. The error is
max|C - C_ref| / max|C_ref| against an f32 ``torch.matmul`` with TF32
off. ``vs_baseline`` is the same epoch forced to ``nwait=n`` over the
coded epoch. Operands are drawn on the card from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..models.logreg import CodedSGD, _coded_grad
from ..ops._batch import matmul, operand_dtype
from ..ops.coded_gemm import CodedGemm, LTCodedGemm
from ..ops.gemm import DistributedGemm
from ..pool import AsyncPool, asyncmap, waitall
from .decode_kernel_attrib import card
from .serving_profile import _busy_us

# BASELINE.json's configs 2-5 as the reference benches run them
UNCODED_M, UNCODED_WORKERS = 4096, 4                      # config 2
MDS_M, MDS_N, MDS_K, MDS_STRAGGLERS = 8192, 8, 6, (2, 5)  # config 3
LT_M, LT_N, LT_K, LT_STRAGGLERS = 16384, 16, 8, (3, 11)   # config 4
SGD_ROWS, SGD_DIM, SGD_N, SGD_S = 1_000_000, 1024, 16, 2  # config 5
SGD_STRAGGLERS, SGD_LR = (2, 9), 0.5
PROFILE_EPOCHS = 3  # traced epochs for the device's busy and idle time
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# limits on max|C - C_ref| / max|C_ref|: f32 products sum in other
# orders; bf16 operands round each to 8 bits, about 2**-9 relative,
# which the sums average down. A decode through parity shards scales
# the limit by cond(G_S), the condition number of the k generator rows
# it solves with (1 for the systematic rows; 24-65 for the sets the
# straggler rungs use, 852 at worst for the (8, 6) Cauchy code)
REL_TOL = {"highest": 1e-5, "default": 2.0 ** -6}
# config 5: the coded step against the uncoded full-batch step, relative
# to the largest element of the update (f32 chunk gradients summed in
# other orders, combined with the code's weights)
SGD_TOL = 1e-4


def _sync() -> None:
    torch.cuda.synchronize()


def _chains(epoch_fn, epochs: int, chains: int = 3):
    """(ms per epoch, host ms per epoch, last output): each chain runs
    ``epochs`` calls and ends in one synchronize; the least chain wins.
    The host time is the loop's own, before the synchronize."""
    best = host = None
    out = None
    for _ in range(chains):
        _sync()
        t0 = time.perf_counter()
        for _ in range(epochs):
            out = epoch_fn()
        t1 = time.perf_counter()
        _sync()
        t2 = time.perf_counter()
        ms = (t2 - t0) * 1e3 / epochs
        h = (t1 - t0) * 1e3 / epochs
        best = ms if best is None else min(best, ms)
        host = h if host is None else min(host, h)
    return best, host, out


def _operands(m: int, kdim: int, ncols: int, seed: int, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return (torch.randn(m, kdim, generator=g, device=dev),
            torch.randn(kdim, ncols, generator=g, device=dev))


def rel_err(C: torch.Tensor, C_ref: torch.Tensor) -> float:
    return float((C - C_ref).abs().max() / C_ref.abs().max())


def _cond(G, rows) -> float:
    return float(np.linalg.cond(np.asarray(G, np.float64)[list(rows)]))


def raw_matmul_ms(A, B, precision: str, reps: int = 5,
                  chains: int = 3) -> float:
    """The MFU denominator: one ``torch.matmul`` of ``A @ B`` at
    ``precision`` (operands already in its dtype), timed as the epochs
    are."""
    dt = operand_dtype(A.dtype, precision)
    a, b = A.to(dt), B.to(dt)
    matmul(a, b, precision)
    return _chains(lambda: matmul(a, b, precision), reps, chains)[0]


def device_ms(epoch_fn, epochs: int = 3):
    """Traced epochs (``torch.profiler``): (wall ms per epoch, device
    busy ms per epoch as the union of the kernels' intervals, the five
    largest kernels' ms per epoch), or None when the profiler shows no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        _sync()
        t0 = time.perf_counter()
        for _ in range(epochs):
            epoch_fn()
        _sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / epochs
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return None
    by_name: dict = {}
    for e in events:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3 / epochs
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:5])
    return wall_ms, _busy_us(events) / 1e3 / epochs, top


def config2(dev, *, seed=0, epochs=40) -> dict:
    """Uncoded row-block GEMM, nwait=n, one stacked product an epoch."""
    m, n_workers, precision = UNCODED_M, UNCODED_WORKERS, "highest"
    A, B = _operands(m, m, m, seed, dev)
    C_ref = torch.matmul(A, B)
    g = DistributedGemm(A, n_workers, devices=[dev], precision=precision,
                        batch=True, batch_arrival="enqueue")
    pool = AsyncPool(n_workers)

    def epoch():
        asyncmap(pool, B, g.backend, nwait=n_workers)
        return g.result(pool)

    try:
        epoch()
        ms, host_ms, C = _chains(epoch, epochs)
        err = rel_err(C, C_ref)
        waitall(pool, g.backend)
    finally:
        g.backend.shutdown()
    raw = raw_matmul_ms(A, B, precision)
    return {
        "config": 2, "metric": f"uncoded-gemm-{m}-{n_workers}w-epoch",
        "precision": precision, "arrival": "enqueue", "nwait": n_workers,
        "ms_per_epoch": ms, "host_ms_per_epoch": host_ms,
        "raw_matmul_ms": raw, "tflops": 2.0 * m ** 3 / ms / 1e9,
        "mfu_vs_raw_matmul": raw / ms, "rel_err": err,
        "rel_tol": REL_TOL[precision], "ok": err <= REL_TOL[precision],
        "epochs_chained": epochs, "chains_min_of": 3,
    }


def _mds_rung(A_pad, B, C_ref, precision, arrival, epochs, raw,
              dev) -> dict:
    m, n, k = MDS_M, MDS_N, MDS_K
    cg = CodedGemm(A_pad, n, k, devices=[dev], precision=precision,
                   batch=True, batch_arrival=arrival)
    pool = AsyncPool(n)

    def epoch():
        asyncmap(pool, B, cg.backend, nwait=k)
        C = cg.result_device(pool)[:m]
        waitall(pool, cg.backend)
        return C

    try:
        # warm-up: the first solve pays the solver's initialisation
        epoch()
        ms, host_ms, C = _chains(epoch, epochs)
        err = rel_err(C, C_ref)
        decode_ms = _chains(lambda: cg.result_device(pool), epochs)[0]
        ids = tuple(range(n))
        products_ms = _chains(
            lambda: cg._batch_work(ids, B, pool.epoch), epochs)[0]
        traced = device_ms(epoch, PROFILE_EPOCHS)
    finally:
        cg.backend.shutdown()
    rung = {
        "ms_per_epoch": ms, "host_ms_per_epoch": host_ms,
        "products_ms": products_ms, "decode_ms": decode_ms,
        "tflops": 2.0 * m ** 3 / ms / 1e9, "mfu_vs_raw_matmul": raw / ms,
        "rel_err": err, "rel_tol": REL_TOL[precision],
        "ok": err <= REL_TOL[precision],
    }
    if traced is not None:
        wall_ms, busy_ms, top = traced
        rung.update(traced_ms_per_epoch=wall_ms, device_busy_ms=busy_ms,
                    device_idle_share=1.0 - busy_ms / wall_ms,
                    top_kernels_ms=top)
    return rung


def _straggler_rung(A_pad, B, C_ref, delay_s, epochs, dev) -> dict:
    """Per-worker dispatch with ``MDS_STRAGGLERS`` delayed: every timed
    epoch returns at k while they are still out; then one epoch from a
    drained pool forced to nwait=n."""
    m, n, k, late = MDS_M, MDS_N, MDS_K, list(MDS_STRAGGLERS)
    cg = CodedGemm(A_pad, n, k, devices=[dev],
                   delay_fn=lambda i, e: delay_s if i in late else 0.0)
    pool = AsyncPool(n)
    try:
        asyncmap(pool, B, cg.backend, nwait=k)  # warm-up
        cg.result_device(pool)
        _sync()
        times, out_at_return = [], True
        for _ in range(epochs):
            t0 = time.perf_counter()
            asyncmap(pool, B, cg.backend, nwait=k)
            C = cg.result_device(pool)[:m]
            _sync()
            times.append((time.perf_counter() - t0) * 1e3)
            out_at_return &= bool(pool.active[late].all()) and bool(
                (pool.repochs[late] < pool.epoch).all())
        err = rel_err(C, C_ref)
        fresh = pool.fresh_indices()[:k].tolist()
        decode_ms = _chains(lambda: cg.result_device(pool), epochs)[0]
        waitall(pool, cg.backend, timeout=10 * delay_s + 60)
        t0 = time.perf_counter()
        asyncmap(pool, B, cg.backend, nwait=n)
        C_all = cg.result_device(pool)[:m]
        _sync()
        all_ms = (time.perf_counter() - t0) * 1e3
        err_all = rel_err(C_all, C_ref)
        waitall(pool, cg.backend)
    finally:
        cg.backend.shutdown()
    coded_ms = float(np.median(times))
    cond = _cond(cg.code.G, fresh)
    tol = REL_TOL["highest"] * cond
    ok = out_at_return and max(err, err_all) <= tol
    return {
        "batch": False, "stragglers": late, "delay_s": delay_s,
        "ms_per_epoch_median": coded_ms, "ms_per_epoch_each": times,
        "decoded_from": fresh, "cond_G_S": cond, "rel_tol": tol,
        "decode_ms": decode_ms,
        "stragglers_out_at_return": out_at_return,
        "nwait_n_epoch_ms": all_ms, "vs_baseline": all_ms / coded_ms,
        "rel_err": err, "rel_err_nwait_n": err_all, "ok": ok,
    }


def config3(dev, *, seed=0, delay_s=1.0, epochs=7) -> dict:
    """(n, k) MDS-coded GEMM at 8192^3 (A padded to a multiple of k)."""
    m, n, k = MDS_M, MDS_N, MDS_K
    A, B = _operands(m, m, m, seed, dev)
    C_ref = torch.matmul(A, B)
    m_pad = -(-m // k) * k
    A_pad = torch.zeros(m_pad, m, device=dev)
    A_pad[:m] = A
    raw = {p: raw_matmul_ms(A, B, p) for p in ("highest", "default")}
    rungs = {}
    for precision in ("highest", "default"):
        for arrival in ("ready", "enqueue"):
            rungs[f"{precision}_{arrival}"] = _mds_rung(
                A_pad, B, C_ref, precision, arrival, epochs,
                raw[precision], dev)
            torch.cuda.empty_cache()
    strag = _straggler_rung(A_pad, B, C_ref, delay_s, epochs, dev)
    head = rungs["highest_enqueue"]
    return {
        "config": 3, "metric": f"mds-coded-gemm-{m}-n{n}k{k}-epoch",
        "m_padded": m_pad, "nwait": k, "raw_matmul_ms": raw,
        "ms_per_epoch": head["ms_per_epoch"],
        "mfu_vs_raw_matmul": head["mfu_vs_raw_matmul"], "rungs": rungs,
        "straggler_rung": strag, "vs_baseline": strag["vs_baseline"],
        "epochs_chained": epochs, "chains_min_of": 3,
        "ok": all(r["ok"] for r in rungs.values()) and strag["ok"],
    }


def config4(dev, *, seed=0, delay_s=5.0, epochs=3, chains=3,
            raw_reps=3) -> dict:
    """LT-coded GEMM: variable decodability nwait, delayed workers."""
    m, n, k, precision = LT_M, LT_N, LT_K, "highest"
    stragglers = LT_STRAGGLERS
    A, B = _operands(m, m, m, seed, dev)
    C_ref = torch.matmul(A, B)
    lt = LTCodedGemm(A, n, k, devices=[dev], precision=precision,
                     delay_fn=lambda i, e: delay_s if i in stragglers else 0.0)
    pool = AsyncPool(n)
    drain_s = 10 * delay_s + 120
    fresh_counts = []

    def epoch():
        repochs = asyncmap(pool, B, lt.backend, nwait=lt.nwait)
        fresh_counts.append(int((repochs == pool.epoch).sum()))
        return lt.result_device(pool)

    try:
        epoch()  # warm-up
        _sync()
        waitall(pool, lt.backend, timeout=drain_s)
        fresh_counts.clear()
        ms, host_ms, C = _chains(epoch, epochs, chains)
        err = rel_err(C, C_ref)
        cond = _cond(lt._G.cpu(), lt.decode_rows(pool))
        # the same epoch peeled on the host (every fresh shard to numpy)
        t0 = time.perf_counter()
        C_host = torch.from_numpy(lt.result(pool)).to(dev)
        peel_s = time.perf_counter() - t0
        host_vs_device = float((C_host - C).abs().max() / C_ref.abs().max())
        del C_host
        stragglers_fresh = int((pool.repochs[list(stragglers)]
                                == pool.epoch).sum())
        waitall(pool, lt.backend, timeout=drain_s)
        t0 = time.perf_counter()
        asyncmap(pool, B, lt.backend, nwait=n)
        C_all = lt.result_device(pool)
        _sync()
        all_ms = (time.perf_counter() - t0) * 1e3
        err_all = rel_err(C_all, C_ref)
        del C_all
        waitall(pool, lt.backend)
    finally:
        lt.backend.shutdown()
    del lt
    torch.cuda.empty_cache()
    raw = raw_matmul_ms(A, B, precision, reps=raw_reps, chains=2)
    tol = REL_TOL[precision] * cond
    return {
        "config": 4, "metric": f"lt-coded-gemm-{m}-{n}w-epoch",
        "precision": precision, "k": k, "stragglers": list(stragglers),
        "delay_s": delay_s, "ms_per_epoch": ms, "host_ms_per_epoch": host_ms,
        "raw_matmul_ms": raw, "tflops": 2.0 * m ** 3 / ms / 1e9,
        "mfu_vs_raw_matmul": raw / ms, "fresh_at_return": fresh_counts,
        "stragglers_fresh_at_last_return": stragglers_fresh,
        "rel_err": err, "host_peel_vs_device": host_vs_device,
        "host_peel_s": peel_s, "nwait_n_epoch_ms": all_ms,
        "rel_err_nwait_n": err_all, "vs_baseline": all_ms / ms,
        "cond_G_S": cond, "rel_tol": tol, "epochs_chained": epochs,
        "chains_min_of": chains,
        "ok": max(err, err_all, host_vs_device) <= tol
        and stragglers_fresh == 0,
    }


def _full_batch_step(sgd: CodedSGD, w, lr):
    """The uncoded full-batch step: worker j's first chunk is chunk j,
    so the mean of their chunk gradients is the full-batch gradient."""
    ones = torch.ones(1, device=w.device)
    g = torch.stack([
        _coded_grad(w, Xc[:1], yc[:1], ones)
        for Xc, yc, _ in sgd._chunks
    ]).mean(0) + sgd.l2 * w
    return w - lr * g


def config5(dev, *, seed=0, delay_s=2.0, epochs=10) -> dict:
    """Gradient-coded SGD on synthetic logistic regression."""
    N, dim, n, s = SGD_ROWS, SGD_DIM, SGD_N, SGD_S
    stragglers, lr = SGD_STRAGGLERS, SGD_LR
    t0 = time.perf_counter()
    sgd = CodedSGD.synthetic(
        N, dim, n, s, devices=[dev], seed=seed,
        delay_fn=lambda i, e: delay_s if i in stragglers else 0.0)
    _sync()
    setup_s = time.perf_counter() - t0
    X_eval, y_eval = sgd.eval_data()
    pool = AsyncPool(n)
    drain_s = 10 * delay_s + 60
    try:
        w = sgd.step(pool, torch.zeros(dim, device=dev), lr)  # warm-up
        loss0 = float(sgd.model.loss(w, X_eval, y_eval))
        _sync()
        t0 = time.perf_counter()
        for _ in range(epochs):
            w = sgd.step(pool, w, lr)
        _sync()
        coded_ms = (time.perf_counter() - t0) * 1e3 / epochs
        loss1 = float(sgd.model.loss(w, X_eval, y_eval))
        traced = device_ms(lambda: sgd.step(pool, w, lr), 3)
        # one coded step from a drained pool against the full batch
        waitall(pool, sgd.backend, timeout=drain_s)
        w_coded = sgd.step(pool, w, lr)
        arrived = pool.fresh_indices().tolist()
        w_full = _full_batch_step(sgd, w, lr)
        step_err = float((w_coded - w_full).abs().max()
                         / (w - w_full).abs().max())
        waitall(pool, sgd.backend, timeout=drain_s)
        t0 = time.perf_counter()
        sgd.step(pool, w, lr, nwait=n)
        _sync()
        all_ms = (time.perf_counter() - t0) * 1e3
        waitall(pool, sgd.backend)
    finally:
        sgd.backend.shutdown()
    chunk_bytes = (N // n) * dim * 4
    prof = {}
    if traced is not None:
        wall_ms, busy_ms, top = traced
        prof = {"traced_ms_per_epoch": wall_ms, "device_busy_ms": busy_ms,
                "device_idle_share": 1.0 - busy_ms / wall_ms,
                "top_kernels_ms": top}
    return {
        "config": 5, "metric": f"gradcoded-sgd-{N}x{dim}-epoch",
        "n_workers": n, "s": s, "nwait": n - s,
        "stragglers": list(stragglers), "delay_s": delay_s,
        "ms_per_epoch": coded_ms, "nwait_n_epoch_ms": all_ms,
        "vs_baseline": all_ms / coded_ms, "loss_after_warmup": loss0,
        "loss_after_epochs": loss1, "epochs": epochs,
        "coded_step_vs_full_batch": step_err, "step_tol": SGD_TOL,
        "arrived_at_check": arrived,
        # the least time to read the arrived workers' s+1 chunks once
        "bound_ms": (n - s) * (s + 1) * chunk_bytes / HBM_BYTES_PER_S * 1e3,
        "data_gb_on_card": n * (s + 1) * chunk_bytes / 1e9,
        "setup_s": setup_s, **prof,
        "ok": loss1 < loss0 and step_err <= SGD_TOL
        and not set(stragglers) & set(arrived),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="2,3,4,5")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--delay3", type=float, default=1.0)
    ap.add_argument("--delay4", type=float, default=5.0)
    ap.add_argument("--delay5", type=float, default=2.0)
    ap.add_argument("--epochs5", type=int, default=10)
    args = ap.parse_args(argv)
    name, smi = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"device: {name}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(smi)
    runs = {
        "2": lambda: config2(dev, seed=args.seed),
        "3": lambda: config3(dev, seed=args.seed, delay_s=args.delay3),
        "4": lambda: config4(dev, seed=args.seed, delay_s=args.delay4),
        "5": lambda: config5(dev, seed=args.seed, delay_s=args.delay5,
                             epochs=args.epochs5),
    }
    ok = True
    for c in args.configs.split(","):
        res = runs[c.strip()]()
        res["card"] = smi
        print(json.dumps(res), flush=True)
        ok &= res["ok"]
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
