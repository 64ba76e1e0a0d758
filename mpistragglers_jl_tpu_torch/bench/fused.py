"""Bench of the fused pool and mesh decode on one card: the folded (8, 6)
pool on a one-rank mesh against the one-device gather + solve.

    python -m mpistragglers_jl_tpu_torch.bench.fused [--epochs 10]
        [--device cuda]

The port of ``benchmarks/fused_chip_bench.py``: the same (n=8, k=6)
coded workload, 1536x512 @ 512x512 f32 (TF32 off), on
``make_mesh(1)``: ``PoolMeshCodedGemm(n_workers=8, batch=True)`` (all
eight workers' blocks on the card, one stacked product an epoch, the
group's stack adopted whole, the masked combine) against
``CodedGemm(batch=True).result_device`` (the k-shard gather and solve),
both with ``batch_arrival="enqueue"`` so that neither waits on an
arrival event per epoch. Timing: alternating chains of ``--epochs``
epochs that end in one synchronize, least of 3 chains each; the
adopter's host cost per ``assemble`` call; the errors of both decodes
against float64 ``A @ B``; and ``select_coded_gemm``'s own decision on
this card. Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .._device import resolve_device
from ..ops.coded_gemm import CodedGemm
from ..parallel import PoolMeshCodedGemm, make_mesh, select_coded_gemm
from ..pool import AsyncPool, asyncmap, waitall

M, D, NCOLS = 1536, 512, 512
N, K = 8, 6
EPOCHS = 10
REPS = 3  # chains of each side, least taken


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_fused(dev=None, epochs: int = EPOCHS) -> dict:
    dev = resolve_device(dev)
    rng = np.random.default_rng(0)
    A = rng.standard_normal((M, D)).astype(np.float32)
    B_np = rng.standard_normal((D, NCOLS)).astype(np.float32)
    B = torch.from_numpy(B_np).to(dev)
    ref = A.astype(np.float64) @ B_np.astype(np.float64)
    mesh = make_mesh(1, devices=[dev])
    fg = PoolMeshCodedGemm(A, mesh, K, n_workers=N, dtype=np.float32,
                           batch=True, batch_arrival="enqueue")
    cg = CodedGemm(A, N, K, devices=[dev], batch=True,
                   batch_arrival="enqueue")
    pool_f, pool_u = AsyncPool(N), AsyncPool(N)
    try:
        decoded = fg.epoch(pool_f, B)  # warm-up
        waitall(pool_f, fg.backend)
        asyncmap(pool_u, B, cg.backend, nwait=cg.nwait)
        Cd = cg.result_device(pool_u)
        waitall(pool_u, cg.backend)
        fused_s = unfused_s = None
        for _ in range(REPS):
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(epochs):
                decoded = fg.epoch(pool_f, B)
                waitall(pool_f, fg.backend)
            _sync(dev)
            dt = (time.perf_counter() - t0) / epochs
            fused_s = dt if fused_s is None else min(fused_s, dt)
            t0 = time.perf_counter()
            for _ in range(epochs):
                asyncmap(pool_u, B, cg.backend, nwait=cg.nwait)
                Cd = cg.result_device(pool_u)
                waitall(pool_u, cg.backend)
            _sync(dev)
            dt = (time.perf_counter() - t0) / epochs
            unfused_s = dt if unfused_s is None else min(unfused_s, dt)
        ref0 = pool_f.results[int(np.flatnonzero(pool_f.repochs > 0)[0])]
        t0 = time.perf_counter()
        for _ in range(20):
            fg._adopter.assemble(pool_f, tuple(ref0.shape), ref0.dtype)
        assemble_ms = (time.perf_counter() - t0) / 20 * 1e3
        scale = np.max(np.abs(ref))
        err_f = float(np.max(np.abs(fg.full(decoded) - ref)) / scale)
        err_u = float(np.max(np.abs(Cd.cpu().numpy() - ref)) / scale)
    finally:
        fg.shutdown()
        cg.backend.shutdown()
    sel = select_coded_gemm(A, mesh, K, B, n_workers=N, dtype=np.float32,
                            batch=True, batch_arrival="enqueue")
    selection = sel.selection
    sel.shutdown()
    return {
        "metric": "fused-pool-mesh-one-card",
        "shape": f"(n={N},k={K}) coded {M}x{D} @ {D}x{NCOLS} f32",
        "device": str(dev),
        "epochs": epochs,
        "chains_min_of": REPS,
        "fused_epoch_ms": fused_s * 1e3,
        "assemble_ms_per_call": assemble_ms,
        "unfused_device0_epoch_ms": unfused_s * 1e3,
        "fused_vs_unfused": fused_s / unfused_s,
        "fused_decode_rel_err": err_f,
        "unfused_decode_rel_err": err_u,
        "auto_selection": selection,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from .decode_kernel_attrib import card

        torch.backends.cuda.matmul.allow_tf32 = False
        print(card()[1])
    print(json.dumps(bench_fused(dev, args.epochs)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
