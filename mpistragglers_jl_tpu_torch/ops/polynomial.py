"""Polynomial-coded GEMM: partition BOTH factors, decode from any pq of n.

The port of the JAX package's ``ops/polynomial.py``: the same points and
weights bit for bit, the workers' encode and product on their CUDA
streams, and the decode one pq×pq solve on the card by LU with partial
pivoting (``ops/coding.py`` ``_lu_solve``, no host sync), then the block
reassembly.

MDS row-coding (ops/coding.py) replicates the whole payload ``B`` to
every worker — fine when ``A`` dominates, wasteful otherwise. Polynomial
codes (Yu, Maddah-Ali, Avestimehr, 2017 — public technique) partition
``A`` into p row blocks AND ``B`` into q column blocks; worker i
computes the single product ``Ã_i @ B̃_i`` of the polynomial evaluations

    Ã_i = Σ_j A_j x_i^j           (j < p)
    B̃_i = Σ_l B_l x_i^(l·p)      (l < q)

so ``C̃_i = Ã_i @ B̃_i = Σ_{j,l} (A_j @ B_l) x_i^(j + l·p)`` is the
evaluation at ``x_i`` of a matrix polynomial whose pq coefficients are
exactly the blocks of ``C = A @ B``. Any pq distinct evaluations
determine the coefficients — the recovery threshold is pq with every
worker doing only 1/(pq) of the multiply work (vs 1/k of the full-B
product under MDS row coding).

Design choices:

* **Workers encode their own B̃_i** from the *broadcast* raw ``B`` — a
  cheap weighted sum over q column blocks fused in front of the worker
  matmul. This preserves the pool's snapshot-broadcast semantics
  (reference src/MPIAsyncPools.jl:51-61): the coordinator dispatches one
  payload, copied once per device, instead of shipping n distinct B̃_i.
* **Chebyshev evaluation points** ``x_i = cos((2i+1)π/2n)``: the
  resulting Vandermonde systems are far better conditioned than
  equispaced points, which is what makes a real-field f32 decode
  viable — SURVEY §7's "Float64 / conditioning" hard part.
* **Decode is one pq×pq solve** plus block reassembly, device-resident.

The ``repochs`` arrival mask selects which evaluations decode — the same
fastest-k mechanism as every other coded workload here (SURVEY §2.1).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..backends.base import DelayFn
from ._batch import as_tensor, check_precision, matmul, operand_dtype
from ._evalgemm import EvalPointCodedGemm, chebyshev_points
from .coding import _lu_solve
from .gemm import resolve_devices

__all__ = ["PolynomialCode", "PolyCodedGemm"]


def _poly_worker(A_i, w_i, B, q: int, precision: str):
    # B: (kd, nc) -> (kd, q, nc/q) column blocks; B̃_i = Σ_l w_i[l] B_l
    kd, nc = B.shape
    Bq = B.reshape(kd, q, nc // q)
    B_enc = torch.einsum("l,klw->kw", w_i.to(B.dtype), Bq)
    return matmul(A_i, B_enc, precision)


def _poly_decode(V_S: torch.Tensor, shards: torch.Tensor) -> torch.Tensor:
    # shards: (pq, r, w) evaluations; solve V_S @ coeffs = shards
    pq = V_S.shape[0]
    flat = shards.reshape(pq, -1)
    return _lu_solve(V_S.to(flat.dtype), flat).reshape(shards.shape)


class PolynomialCode:
    """(p, q) polynomial code over n workers, recovery threshold pq.

    >>> code = PolynomialCode(p=2, q=2, n=6)
    >>> A_enc = code.encode_A(A_blocks)   # (p,r,c) -> (6,r,c)
    >>> # worker i: A_enc[i] @ (sum_l B_weights[i,l] * B_l)
    >>> C_blocks = code.decode(shards, indices)   # any 4 of 6

    Encode and decode run in the blocks' dtype (the reference's
    ``precision=`` is the workers' products' only, as in
    :class:`~.coding.MDSCode`).
    """

    def __init__(self, p: int, q: int, n: int, *, dtype=np.float32):
        if p < 1 or q < 1:
            raise ValueError(f"need p, q >= 1, got p={p}, q={q}")
        if n < p * q:
            raise ValueError(
                f"need n >= p*q workers for decodability, got n={n} < "
                f"{p}*{q}={p * q}"
            )
        self.p, self.q, self.n = int(p), int(q), int(n)
        self.k = self.p * self.q  # recovery threshold
        # Chebyshev nodes: well-conditioned real Vandermonde systems
        self.points = chebyshev_points(self.n)
        # A-encode weights x_i^j, B-encode weights x_i^(l*p), decode
        # Vandermonde x_i^t for t < pq
        self.VA = (self.points[:, None] ** np.arange(self.p)).astype(dtype)
        self.VB = (
            self.points[:, None] ** (self.p * np.arange(self.q))
        ).astype(dtype)
        self.VC = (self.points[:, None] ** np.arange(self.k)).astype(dtype)

    def encode_A(self, blocks) -> torch.Tensor:
        """(p, rows, cols) row blocks of A -> (n, rows, cols) evaluations,
        where the blocks lie."""
        blocks = as_tensor(blocks)
        if blocks.shape[0] != self.p:
            raise ValueError(
                f"expected {self.p} A-blocks, got {blocks.shape[0]}"
            )
        VA = torch.from_numpy(self.VA).to(blocks.device, blocks.dtype)
        return torch.einsum("nj,jrc->nrc", VA, blocks)

    def decode(self, shards, indices) -> torch.Tensor:
        """Recover the pq coefficient blocks from any pq evaluations.

        ``shards``: (pq, rows, w) stacked worker products; ``indices``:
        which worker (= evaluation point) each came from. Returns
        ``(pq, rows, w)`` where entry ``t`` is ``A_{t % p} @ B_{t // p}``.
        """
        idx = np.asarray(indices)
        if idx.shape[0] != self.k or len(set(idx.tolist())) != self.k:
            raise ValueError(
                f"need exactly pq={self.k} distinct shard indices, got {idx}"
            )
        shards = as_tensor(shards)
        if shards.shape[0] != self.k:
            raise ValueError(f"expected {self.k} shards, got {shards.shape[0]}")
        V_S = torch.from_numpy(np.ascontiguousarray(self.VC[idx])).to(
            shards.device)
        return _poly_decode(V_S, shards)

    def assemble(self, coeffs) -> torch.Tensor:
        """(pq, r, w) coefficient blocks -> full (p*r, q*w) product."""
        pq, r, w = coeffs.shape
        # t = j + l*p  ->  grid[l, j] = C block at rows j, cols l
        grid = coeffs.reshape(self.q, self.p, r, w)
        return torch.cat([
            torch.cat([grid[l, j] for l in range(self.q)], dim=1)
            for j in range(self.p)
        ], dim=0)


class PolyCodedGemm(EvalPointCodedGemm):
    """``C = A @ B`` from any pq of n workers, both factors partitioned.

    Worker i holds the static evaluation ``Ã_i`` (m/p × kd) and encodes
    its own ``B̃_i`` from the broadcast payload, so per-worker compute
    and memory are 1/(pq) of the full product (vs 1/k compute with full
    B under :class:`~.coded_gemm.CodedGemm`).

    >>> pg = PolyCodedGemm(A, p=2, q=2, n=6)        # on the card
    >>> pool = AsyncPool(6)
    >>> repochs = asyncmap(pool, B, pg.backend, nwait=4)
    >>> C = pg.result_device(pool)        # exact A @ B from 4 of 6
    """

    def __init__(
        self,
        A,
        p: int,
        q: int,
        n: int,
        *,
        devices: Sequence | None = None,
        delay_fn: DelayFn | None = None,
        dtype=None,
        precision: str = "highest",
    ):
        A = as_tensor(A, dtype)
        m = A.shape[0]
        if m % p != 0:
            raise ValueError(f"rows {m} must divide evenly into p={p} blocks")
        self.devices = resolve_devices(devices)
        self.precision = check_precision(precision)
        self.code = PolynomialCode(
            p, q, n, dtype=torch.empty(0, dtype=A.dtype).numpy().dtype)
        self.p, self.q, self.n = p, q, n
        self.block_rows = m // p
        coded = self.code.encode_A(
            A.to(self.devices[0]).reshape(p, m // p, A.shape[1])
        ).to(operand_dtype(A.dtype, self.precision))
        self._setup_workers(coded, self.code.VB, n, delay_fn)

    def _work(self, i: int, payload: torch.Tensor, epoch: int):
        if payload.shape[1] % self.q != 0:
            raise ValueError(
                f"B cols {payload.shape[1]} must divide evenly into "
                f"q={self.q} blocks"
            )
        return _poly_worker(
            self.A_shards[i], self.B_weights[i], payload, self.q,
            self.precision,
        )

    def _decode_shards(self, shards, idx):
        return self.code.assemble(self.code.decode(shards, idx))
