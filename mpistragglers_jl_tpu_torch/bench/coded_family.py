"""Bench of the rest of the coded-GEMM family on one card.

    python -m mpistragglers_jl_tpu_torch.bench.coded_family
        [--rungs rateless,overhead,matdot,poly,hierarchical,gf256]
        [--round-timeout 2.0] [--overhead-seeds 0] [--delay 0.5]
        [--hier-epochs 3]

Prints the card's name and power limit (``nvidia-smi``), then one JSON
line per rung; the defaults are the cuts ``chip_smoke.py`` runs, and the
flags undo them (the reference's values in brackets):

* ``rateless``: config 4's rateless rung
  (``benchmarks/config4_lt_gemm.py`` ``main_rateless``): 8192^3 f32
  (TF32 off), n=12, k=8, seed 16, the classic stream
  (``systematic=False``), worker 0 dead; ``prefetch_source()`` and one
  warm-up dispatch off the clock; ``round_timeout`` 2 s [60]. The decode
  is held to an on-card f32 ``torch.matmul``, rel err < 1e-3 (the
  rung's ``decode_success``);
* ``overhead``: ``bench.py`` ``bench_rateless_overhead``: m=2048, 512
  inner, 256 columns, n=8, k=8, worker 3 dead, the others staggered
  0.15-0.6 s; shards drawn until the set peels, systematic against
  classic, one seed [0, 1, 2], ``round_timeout`` 2 s [6] and no warm-up
  multiply [one at 20 s];
* ``matdot`` and ``poly``: 8192^3 f32 over n=8 stream workers, MatDot
  p=4 (k=7) and polynomial p=q=2 (k=4): a warm-up epoch and decode off
  the clock, then two epochs, the second with worker 5 delayed 0.5 s;
  ms per epoch, decode ms, cond(V_S), the error held to 1e-5 x cond(V_S)
  as config 3 is held;
* ``hierarchical``: 4 groups of 8 stream workers, k_inner=6, A 9216 x
  8192, B 8192 x 8192, f32; a warm-up epoch off the clock, then 3
  epochs with group 2 dead from the second (``faults.kill_group``); ms
  per epoch, the decode (stacking the pool's shards, batched inner
  solves, the outer pass) beside the flat (32, 24) MDS decode of the
  same product from 24 per-worker results (gaussian parity, as
  ``benchmarks/hierarchical_bench.py`` compares them), both held to
  1e-5 x cond;
* ``gf256``: ``DeviceRSGF256(8, 6)`` over the bytes of the f32
  parameters of the training model (``bench/train_profile.py``
  ``TRAIN``), both methods: decode(encode(x)) with rows 0 and 3 lost
  equal to x byte for byte, a 1 MiB slice's shards equal to the numpy
  ``RSGF256``'s, GB/s of source bytes for each.

A dead worker's stall is the fault schedule's (3600 s), held on an
``threading.Event`` the rung releases when it ends, so no dispatcher
thread outlives the rung. Operands are drawn on the card from a seed.
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np
import torch

from ..backends.base import WorkerError
from ..models.transformer import TransformerConfig, _leaves, init_params
from ..ops.coding import MDSCode, _decode
from ..ops.gf256_device import DeviceRSGF256
from ..ops.hierarchical import HierarchicalCodedGemm
from ..ops.matdot import MatDotGemm
from ..ops.outer_code import partition_groups
from ..ops.polynomial import PolyCodedGemm
from ..ops.rateless import RatelessLTGemm
from ..pool import AsyncPool, asyncmap, waitall
from ..utils import faults
from ..utils.rs_gf256 import RSGF256
from .coded_gemm import _operands, _sync, device_ms, rel_err
from .decode_kernel_attrib import card
from .train_profile import TRAIN

RATELESS = dict(m=8192, n=12, k=8, seed=16, dead=0)
OVERHEAD = dict(m=2048, inner=512, ncols=256, n=8, k=8, dead=3)
EVAL_M, EVAL_N, EVAL_SLOW = 8192, 8, 5
HIER = dict(H=4, n_inner=8, k_inner=6, m=9216, kdim=8192, ncols=8192,
            dead_group=2, kill_epoch=3)
GF_N, GF_K, GF_LOST = 8, 6, (0, 3)
RATELESS_TOL = 1e-3   # the rung's decode_success
PRODUCT_TOL = 1e-5    # x cond of the solved system, as config 3


class Releasable:
    """A delay schedule whose stalls wait on an event instead of
    sleeping: ``release()`` ends every stall at once, so a dead worker's
    dispatcher thread finishes when the rung is done with it."""

    def __init__(self, schedule):
        self.schedule = schedule
        self._released = threading.Event()

    def __call__(self, worker: int, epoch: int) -> float:
        d = self.schedule(worker, epoch)
        if d > 0:
            self._released.wait(d)
        return 0.0

    def release(self) -> None:
        self._released.set()


def _timed(fn):
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, (time.perf_counter() - t0) * 1e3


def _best_ms(fn, reps: int = 3) -> float:
    return min(_timed(fn)[1] for _ in range(reps))


def _cond(M) -> float:
    return float(np.linalg.cond(np.asarray(M, np.float64)))


def _traced(epoch_fn, epochs: int = 2) -> dict:
    """Wall and device-busy ms per epoch over traced epochs (epoch and
    decode), the idle share and the largest kernels."""
    got = device_ms(epoch_fn, epochs)
    if got is None:
        return {"traced": "no device time in the profile"}
    wall, busy, top = got
    return {"traced_ms_per_epoch": wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall, "top_kernels_ms": top}


def rateless(dev, *, round_timeout=2.0, seed=RATELESS["seed"]) -> dict:
    m, n, k, dead = (RATELESS[x] for x in ("m", "n", "k", "dead"))
    A, B = _operands(m, m, m, seed, dev)
    stall = Releasable(faults.dead_from(dead, 0))
    rg = RatelessLTGemm(A, n, k, seed=seed, systematic=False,
                        delay_fn=stall, devices=[dev])
    try:
        t0 = time.perf_counter()
        rg.prefetch_source()
        rg.backend.dispatch(1, B, 0)
        warm = rg.backend.wait(1, timeout=600)
        if warm is None or isinstance(warm, WorkerError):
            raise RuntimeError(f"rateless warm-up failed: {warm!r}")
        setup_s = time.perf_counter() - t0
        pool = AsyncPool(n)
        C, wall_ms = _timed(lambda: rg.multiply(
            B, pool, round_timeout=round_timeout, max_rounds=4))
        err = rel_err(C, torch.matmul(A, B))
        stats = dict(rg.stats)
    finally:
        stall.release()
        rg.backend.shutdown()
    return {
        "rung": "rateless", "metric": f"lt-rateless-gemm-{m}-permanent-"
        "straggler", "wall_s": wall_ms / 1e3, "round_timeout_s":
        round_timeout, "reference_round_timeout_s": 60.0,
        "decode_rel_err": err, "decode_success": err < RATELESS_TOL,
        "shards_used": stats["shards_used"], "k": k, "n": n,
        "rateless_overhead": stats["overhead"],
        "max_generation": stats["max_generation"], "dead_worker": dead,
        "setup_s": setup_s, "ok": err < RATELESS_TOL
        and stats["max_generation"] >= 1,
    }


def rateless_overhead(dev, *, round_timeout=2.0, seeds=(0,)) -> dict:
    """Shards consumed until the set peels, systematic against classic,
    under one permanent straggler and staggered arrivals."""
    m, inner, ncols, n, k, dead = (OVERHEAD[x] for x in (
        "m", "inner", "ncols", "n", "k", "dead"))
    rng = np.random.default_rng(0)
    A = rng.standard_normal((m, inner)).astype(np.float32)
    B_host = rng.standard_normal((inner, ncols)).astype(np.float32)
    B = torch.from_numpy(B_host).to(dev)
    C_ref = torch.from_numpy(A).to(dev) @ B

    def stagger(i, e):
        return 3600.0 if i == dead else 0.15 * ((i * 7 + e) % 4 + 1)

    out = {"rung": "overhead", "k": k, "n": n,
           "straggler": f"worker {dead} permanent", "seeds": list(seeds),
           "round_timeout_s": round_timeout, "reference_round_timeout_s": 6.0}
    ok = True
    for name, syst in (("systematic", True), ("classic", False)):
        used, walls = [], []
        for seed in seeds:
            stall = Releasable(stagger)
            rg = RatelessLTGemm(A, n, k, seed=seed, systematic=syst,
                                delay_fn=stall, devices=[dev])
            try:
                rg.prefetch_source()
                C, ms = _timed(lambda: rg.multiply(
                    B, AsyncPool(n), round_timeout=round_timeout,
                    max_rounds=8))
                ok &= rel_err(C, C_ref) < RATELESS_TOL
                used.append(rg.stats["shards_used"])
                walls.append(ms / 1e3)
            finally:
                stall.release()
                rg.backend.shutdown()
        out[name] = {"mean_shards_used": float(np.mean(used)),
                     "overhead": float(np.mean(used)) / k,
                     "wall_s": walls}
    out["ok"] = bool(ok)
    return out


def evalpoint(dev, code: str, *, delay_s=0.5, seed=0) -> dict:
    """MatDot p=4 or polynomial p=q=2 over 8 stream workers: a warm-up
    epoch and its decode off the clock (the first solve on a card pays
    the solver library's set-up), then two epochs, worker 5 delayed in
    the second."""
    m, n, slow = EVAL_M, EVAL_N, EVAL_SLOW
    A, B = _operands(m, m, m, seed, dev)
    C_ref = torch.matmul(A, B)

    def delay(i, e):
        return delay_s if (i == slow and e == 3) else 0.0

    if code == "matdot":
        g = MatDotGemm(A, 4, n, devices=[dev], delay_fn=delay)
    else:
        g = PolyCodedGemm(A, 2, 2, n, devices=[dev], delay_fn=delay)
    try:
        pool = AsyncPool(n)
        asyncmap(pool, B, g.backend, nwait=n)
        g.result_device(pool)
        epochs = []
        for _ in range(2):
            _, ms = _timed(lambda: asyncmap(pool, B, g.backend,
                                            nwait=g.nwait))
            idx = pool.fresh_indices()[: g.k]
            C, dec_ms = _timed(lambda: g.result_device(pool))
            V = g.code.points[idx][:, None] ** np.arange(g.k)
            cond = _cond(V)
            err = rel_err(C, C_ref)
            epochs.append({"epoch": int(pool.epoch), "ms": ms,
                           "decode_ms": dec_ms, "decoded_from":
                           idx.tolist(), "cond_V_S": cond, "rel_err": err,
                           "limit": PRODUCT_TOL * cond})
        decode_ms = _best_ms(lambda: g.result_device(pool))
        traced = _traced(lambda: (asyncmap(pool, B, g.backend,
                                           nwait=g.nwait),
                                  g.result_device(pool)))
        waitall(pool, g.backend, timeout=60)
    finally:
        g.backend.shutdown()
    return {
        "rung": code, "m": m, "n": n, "k": g.k,
        "code": {"matdot": "p=4", "poly": "p=2, q=2"}[code],
        "delayed": {"worker": slow, "epoch": 3, "s": delay_s},
        "epochs": epochs, "ms_per_epoch": [e["ms"] for e in epochs],
        "decode_ms_best_of_3": decode_ms, **traced,
        "ok": all(e["rel_err"] <= e["limit"] for e in epochs)
        and slow not in epochs[1]["decoded_from"],
    }


def hierarchical(dev, *, epochs=3, seed=0) -> dict:
    H, ni, ki = HIER["H"], HIER["n_inner"], HIER["k_inner"]
    m, kdim, ncols = HIER["m"], HIER["kdim"], HIER["ncols"]
    A, B = _operands(m, kdim, ncols, seed, dev)
    C_ref = torch.matmul(A, B)
    kill = faults.kill_group(partition_groups(H * ni, H),
                             {HIER["dead_group"]: HIER["kill_epoch"]})
    stall = Releasable(kill)
    hg = HierarchicalCodedGemm(A, groups=H, n_inner=ni, k_inner=ki,
                               devices=[dev], delay_fn=stall)
    out_epochs = []
    try:
        # a warm-up epoch and decode off the clock, then the timed ones
        pool = AsyncPool(hg.n_workers)
        asyncmap(pool, B, hg.backend, nwait=hg.n_workers)
        hg.result_device(pool)
        for _ in range(epochs):
            _, ms = _timed(lambda: asyncmap(pool, B, hg.backend,
                                            nwait=hg.nwait))
            arrived = hg.arrived_groups(pool)
            C, dec_ms = _timed(lambda: hg.result_device(pool))
            used = hg.outer.select(arrived)
            mask = np.zeros(hg.n_workers, bool)
            mask[pool.fresh_indices()] = True
            cond = max(_cond(hg._inner_G[np.flatnonzero(
                mask[hg.group_indices[g]])[:ki]].float()) for g in used)
            out_epochs.append({
                "epoch": int(pool.epoch), "ms": ms, "decode_ms": dec_ms,
                "arrived_groups": arrived, "used_groups": used,
                "cond_inner_G_S": cond, "rel_err": rel_err(C, C_ref),
                "limit": PRODUCT_TOL * cond})
        decode_ms = _best_ms(lambda: hg.result_device(pool))
        traced = _traced(lambda: (asyncmap(pool, B, hg.backend,
                                           nwait=hg.nwait),
                                  hg.result_device(pool)))
        dead_out = bool(pool.active[hg.group_indices[HIER["dead_group"]]]
                        .all())
    finally:
        stall.release()
        hg.backend.shutdown()
    del hg
    torch.cuda.empty_cache()
    # the flat code of equal host-loss resilience: (32, 24) MDS, decoded
    # from the 24 workers outside the dead group (8 of them parity)
    n_flat, k_flat = H * ni, (H - 1) * ni
    code = MDSCode(n_flat, k_flat, parity="gaussian", dtype=np.float32)
    coded = code.encode_array(A)
    dead = set(range(HIER["dead_group"] * ni, (HIER["dead_group"] + 1) * ni))
    sel = [w for w in range(n_flat) if w not in dead]
    # one result per worker, stacked inside the timed decode as the
    # hierarchical decode stacks its pool results
    results = [torch.matmul(coded[w], B) for w in sel]
    G_S = torch.from_numpy(code.G[sel]).to(dev)

    def flat_decode():
        return _decode(G_S, torch.stack(results))

    flat = flat_decode()
    flat_ms = _best_ms(flat_decode)
    flat_cond = _cond(code.G[sel])
    flat_err = rel_err(flat.reshape(-1, ncols), C_ref)
    return {
        "rung": "hierarchical", "groups": H, "n_inner": ni, "k_inner": ki,
        "shape": [m, kdim, ncols], "dead_group": HIER["dead_group"],
        "kill_epoch": HIER["kill_epoch"], "epochs": out_epochs,
        "ms_per_epoch": [e["ms"] for e in out_epochs],
        "hier_decode_ms_best_of_3": decode_ms,
        "flat_decode_ms_best_of_3": flat_ms,
        "flat": {"n": n_flat, "k": k_flat, "parity": "gaussian",
                 "cond_G_S": flat_cond, "rel_err": flat_err,
                 "limit": PRODUCT_TOL * flat_cond},
        "hier_vs_flat_decode_x": flat_ms / decode_ms, **traced,
        "ok": all(e["rel_err"] <= e["limit"] for e in out_epochs)
        and flat_err <= PRODUCT_TOL * flat_cond and dead_out
        and all(HIER["dead_group"] not in e["arrived_groups"]
                for e in out_epochs[HIER["kill_epoch"] - 2:]),
    }


def param_bytes(params) -> torch.Tensor:
    """Every parameter's bytes, concatenated in the parameter tree's
    order, as one uint8 tensor."""
    return torch.cat([p.detach().reshape(-1).view(torch.uint8)
                      for p in _leaves(params)])


def gf256(dev, raw: torch.Tensor | None = None) -> dict:
    """Encode and decode the bytes ``raw`` (default: the f32 parameters
    of the training model at ``TRAIN``'s width, seed 0)."""
    if raw is None:
        cfg = TransformerConfig(**TRAIN, dtype=torch.float32)
        raw = param_bytes(init_params(cfg, seed=0, device=dev))
    k, n = GF_K, GF_N
    L = -(-raw.numel() // k)
    data = torch.zeros(k * L, dtype=torch.uint8, device=dev)
    data[: raw.numel()] = raw.to(dev)
    data = data.reshape(k, L)
    keep = [r for r in range(n) if r not in GF_LOST]
    cols = -(-(1 << 20) // k)  # a 1 MiB slice of the source
    host = RSGF256(n, k)
    out = {"rung": "gf256", "n": n, "k": k, "lost_rows": list(GF_LOST),
           "bytes": int(raw.numel()), "columns": L}
    ok = True
    for method in ("bitslice", "gather"):
        rs = DeviceRSGF256(n, k, method=method, device=dev)
        rs.decode(rs.encode(data[:, :cols])[keep], keep)  # warm-up
        coded, enc_ms = _timed(lambda: rs.encode(data))
        back, dec_ms = _timed(lambda: rs.decode(coded[keep], keep))
        exact = bool(torch.equal(back, data))
        sl = data[:, :cols]
        host_eq = np.array_equal(rs.encode(sl).cpu().numpy(),
                                 host.encode(sl.cpu().numpy()))
        ok &= exact and host_eq
        out[method] = {"encode_ms": enc_ms, "decode_ms": dec_ms,
                       "encode_GB_per_s": data.numel() / enc_ms / 1e6,
                       "decode_GB_per_s": data.numel() / dec_ms / 1e6,
                       "round_trip_exact": exact,
                       "slice_equal_to_numpy": host_eq}
        del coded, back
    out["ok"] = bool(ok)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rungs", default="rateless,overhead,matdot,poly,"
                    "hierarchical,gf256")
    ap.add_argument("--round-timeout", type=float, default=2.0)
    ap.add_argument("--overhead-seeds", default="0")
    ap.add_argument("--delay", type=float, default=0.5)
    ap.add_argument("--hier-epochs", type=int, default=3)
    args = ap.parse_args(argv)
    name, smi = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"device: {name}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(smi)
    seeds = tuple(int(s) for s in args.overhead_seeds.split(","))
    runs = {
        "rateless": lambda: rateless(dev, round_timeout=args.round_timeout),
        "overhead": lambda: rateless_overhead(
            dev, round_timeout=args.round_timeout, seeds=seeds),
        "matdot": lambda: evalpoint(dev, "matdot", delay_s=args.delay),
        "poly": lambda: evalpoint(dev, "poly", delay_s=args.delay),
        "hierarchical": lambda: hierarchical(dev, epochs=args.hier_epochs),
        "gf256": lambda: gf256(dev),
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
