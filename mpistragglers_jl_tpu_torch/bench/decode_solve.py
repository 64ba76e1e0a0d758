"""Where the MDS decode's solve spends its time on the card, step by step.

    python -m mpistragglers_jl_tpu_torch.bench.decode_solve

BASELINE config 3's decode solves a 6 x 6 system G_S against 6 x 11.2 M
right-hand sides (8196 / 6 rows x 8192 columns). For the systematic
rows of the (8, 6) Cauchy generator (no row exchange) and for rows 0,
1, 3, 4, 6, 7 (two parity shards; LU exchanges rows), this times
``torch.linalg.solve_ex``, the steps of ``ops/coding.py`` ``_lu_solve``
(factor, unpack, the row gather, two triangular solves from the right
on the transposed right-hand sides) and the same triangular solves from
the left. Milliseconds per call by the host clock around a synchronize,
after one warm-up call: the mean of 2 calls, or 1 call for the slow
left-sided solves. Prints the card and one JSON line with the times and
the largest difference between ``solve_ex`` and ``_lu_solve``.
"""

from __future__ import annotations

import json
import time

import torch

from ..ops.coding import MDSCode, _lu_solve
from .decode_kernel_attrib import card


def _ms(fn, reps: int):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps, out


COLS = 1366 * 8192  # one decoded block of config 3: 8196 / 6 rows x 8192


def main() -> int:
    name, smi = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"device: {name}, torch {torch.__version__}")
    print(smi)
    G = MDSCode(8, 6).G
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    F = torch.randn(6, COLS, generator=g, device=dev)
    out = {"cols": COLS, "card": smi}
    for label, rows in (("systematic", list(range(6))),
                        ("parity", [0, 1, 3, 4, 6, 7])):
        G_S = torch.from_numpy(G[rows]).to(dev)
        r = {}
        r["solve_ex_ms"], X_ex = _ms(lambda: torch.linalg.solve_ex(
            G_S, F, check_errors=False)[0], 2)
        r["lu_solve_ms"], X = _ms(lambda: _lu_solve(G_S, F), 2)
        r["max_rel_diff"] = float((X_ex - X).abs().max() / X.abs().max())
        (LU, piv, _) = torch.linalg.lu_factor_ex(G_S)
        r["lu_factor_ms"] = _ms(lambda: torch.linalg.lu_factor_ex(G_S), 2)[0]
        P, L, U = torch.lu_unpack(LU, piv)
        r["lu_unpack_ms"] = _ms(lambda: torch.lu_unpack(LU, piv), 2)[0]
        perm = P.argmax(dim=0)
        r["row_gather_ms"], pf = _ms(lambda: F.index_select(0, perm), 2)
        r["right_L_ms"], yT = _ms(lambda: torch.linalg.solve_triangular(
            L.mT, pf.mT, upper=True, left=False, unitriangular=True), 2)
        r["right_U_ms"] = _ms(lambda: torch.linalg.solve_triangular(
            U.mT, yT, upper=False, left=False), 2)[0]
        r["left_L_ms"], y = _ms(lambda: torch.linalg.solve_triangular(
            L, pf, upper=False, unitriangular=True), 1)
        r["left_U_ms"] = _ms(lambda: torch.linalg.solve_triangular(
            U, y, upper=True), 1)[0]
        out[label] = r
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
