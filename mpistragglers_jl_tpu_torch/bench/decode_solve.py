"""The coded-GEMM decode on the card at the benchmark's shapes: the
kernel, its plain version and ``_lu_solve``.

    python -m mpistragglers_jl_tpu_torch.bench.decode_solve

BASELINE config 3 decodes k=6 shards of 1366 x 8192 (8196 / 6 rows x
8192 columns) of the (8, 6) Cauchy code, here through the systematic
rows (``G_S`` the identity) and through rows 2-7 (cond(G_S) 852, the
worst set); config 4 decodes k=8 shards of 2048 x 16384 of its LT code
(seed 0), here through workers 0, 2, 4, 5, 7, 10, 12 and 13, a set
``LTCodedGemm.decode_rows`` picks (cond 10.1; it peels).

For each: ``decode_solve`` (``ops/decode_solve.py``: the host LU and
one kernel over the shards where they lie), its plain version on the
card (``decode_solve_ref``, the same factors), and ``_lu_solve`` (the
route the kernel replaced, on the card: factor, gather, two triangular
solves) on the stacked shards, with the stack timed apart. Milliseconds
per call by CUDA events around ``reps`` calls after a warm-up call (each
call moves 0.5-2.2 GB, 10-40x the 50 MB L2, so nothing stays cached);
``host_us``, the host's time to issue one ``decode_solve`` (the LU
included) without waiting for the card. The bound
(``bench/kernel_bounds.py``): the k shards read and the product written
once, 2 k rows cols 4 bytes at 3.35 TB/s. Prints the card and one JSON
line.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..ops import decode_solve as ds
from ..ops.coded_gemm import LTCodedGemm
from ..ops.coding import MDSCode, _lu_solve
from .decode_kernel_attrib import card
from .kernel_bounds import decode_solve_bounds

LT_ROWS = [0, 2, 4, 5, 7, 10, 12, 13]


def _ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cases() -> list:
    """``(label, G_S, rows, cols, reps)`` of the three decodes above:
    config 3's systematic set and rows 2-7, config 4's LT set."""
    G = MDSCode(8, 6).G
    # config 4's code: only its shard ids are used, so a tiny A on the CPU
    lt = LTCodedGemm(np.zeros((8, 2), np.float32), 16, 8,
                     devices=[torch.device("cpu")], seed=0)
    lt.backend.shutdown()
    G_lt = lt.code.generator_rows(lt.shard_ids)
    return [("mds_systematic", G[:6], 1366, 8192, 20),
            ("mds_rows_2_7", G[2:8], 1366, 8192, 20),
            ("lt", G_lt[LT_ROWS], 2048, 16384, 10)]


def case(dev, G_S, rows: int, cols: int, reps: int) -> dict:
    """One decode timed and checked: k f32 shards of rows x cols drawn
    on the card, decoded through ``G_S`` by the kernel, the plain
    version and ``_lu_solve`` (the last two also for the differences
    from the kernel, as shares of max|X|)."""
    k = G_S.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    shards = list(torch.randn(k, rows, cols, generator=gen, device=dev))
    G_dev = torch.from_numpy(np.asarray(G_S, np.float32)).to(dev)
    factors = ds.host_lu(G_S)
    flat = torch.stack(shards).reshape(k, -1)
    r = {"k": k, "rows": rows, "cols": cols,
         "cond": float(np.linalg.cond(np.asarray(G_S, np.float64))),
         "bound_ms": decode_solve_bounds(k, rows, cols)["bound_ms"]}
    r["kernel_ms"] = _ms(lambda: ds.decode_solve(shards, G_S), reps)
    r["roofline_pct"] = 100.0 * r["bound_ms"] / r["kernel_ms"]
    r["plain_ms"] = _ms(lambda: ds.decode_solve_ref(shards, *factors), reps)
    r["stack_ms"] = _ms(lambda: torch.stack(shards), reps)
    r["lu_solve_ms"] = _ms(lambda: _lu_solve(G_dev, flat), reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        ds.decode_solve(shards, G_S)
    r["host_us"] = (time.perf_counter() - t0) * 1e6 / reps
    got = ds.decode_solve(shards, G_S).reshape(k, -1)
    want = _lu_solve(G_dev, flat)
    plain = ds.decode_solve_ref(shards, *factors).reshape(k, -1)
    scale = float(want.abs().max())
    r["max_rel_diff_lu_solve"] = float((got - want).abs().max()) / scale
    r["max_rel_diff_plain"] = float((got - plain).abs().max()) / scale
    r["bit_copy"] = bool(torch.equal(got, flat)) if np.array_equal(
        G_S, np.eye(k)) else None
    return r


def main() -> int:
    name, smi = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"device: {name}, torch {torch.__version__}")
    print(smi)
    out = {"card": smi, "launches_before": ds.LAUNCHES["decode_solve"]}
    for label, G_S, rows, cols, reps in cases():
        out[label] = case(dev, G_S, rows, cols, reps)
    out["launches"] = ds.LAUNCHES["decode_solve"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
