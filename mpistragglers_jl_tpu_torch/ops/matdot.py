"""MatDot-coded GEMM: partition the contraction dimension, decode from
any 2p-1 of n.

The port of the JAX package's ``ops/matdot.py``: the same points and
weights (float64 on the host, bit for bit), the workers' encode and
product on their CUDA streams, the decode one weighted sum on the card.

The third coded-matmul family here (with MDS row coding, ops/coding.py,
and polynomial both-factor codes, ops/polynomial.py), after Dutta et al.,
"On the Optimal Recovery Threshold of Coded Matrix Multiplication"
(public technique). Where polynomial codes partition the *output* (each
worker computes 1/(pq) of C's entries over the full inner dimension),
MatDot partitions the *inner* dimension: A splits into p column blocks
A_j (m × kd/p), B into p row blocks B_j (kd/p × nc), and worker i
computes the full-size m × nc product

    C̃_i = Ã_i @ B̃_i,   Ã_i = Σ_j A_j x_i^j,   B̃_i = Σ_j B_j x_i^(p-1-j)

— 1/p of the total FLOPs each. The polynomial C̃(x) has degree 2p-2 and
its x^(p-1) coefficient is exactly Σ_j A_j @ B_j = A @ B, so any 2p-1
evaluations recover C. The trade against polynomial codes: lower
per-worker compute threshold arithmetic (recovery 2p-1 < p² for the same
split count) but each worker outputs the full m × nc block (more result
bytes); MatDot wins when the inner dimension dominates.

Design choices (mirroring ops/polynomial.py):

* **Workers encode their own B̃_i** from the single broadcast ``B`` — a
  weighted sum over its p row blocks, on its stream, before its matmul,
  preserving the pool's snapshot-broadcast semantics (reference
  src/MPIAsyncPools.jl:51-61; one payload copy per device).
* **Decode is one weighted sum.** The x^(p-1) coefficient is a linear
  functional of any 2p-1 evaluations: with Vandermonde V_S over the
  arrived points, ``C = Σ_i w_i C̃_i`` where ``w = V_S^{-T} e_{p-1}``.
  On the card that is a single einsum over the stacked shards — exactly
  the masked-combine shape the ``repochs`` arrival mask drives
  everywhere else in this framework (SURVEY §2.1).
* **Chebyshev evaluation points** for real-field Vandermonde
  conditioning (SURVEY §7 "Float64 / conditioning" hard part).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..backends.base import DelayFn
from ._batch import as_tensor, check_precision, matmul, operand_dtype
from ._evalgemm import EvalPointCodedGemm, chebyshev_points
from .gemm import resolve_devices

__all__ = ["MatDotCode", "MatDotGemm", "MatDotWeightCache"]


class MatDotWeightCache:
    """Bounded per-arrival-pattern cache of masked decode weights.

    ``get(sel)`` returns the length-n weight vector with the 2p-1
    interpolation weights on the arrived indices and 0 elsewhere — the
    form every MatDot decode path consumes. One source of truth for the
    numerically sensitive Vandermonde solve, and one bound: there are
    C(n, 2p-1) possible arrival patterns, so the dict is cleared at
    ``max_entries`` rather than growing toward that.
    """

    def __init__(self, code: "MatDotCode", max_entries: int = 4096):
        self.code = code
        self.max_entries = int(max_entries)
        self._cache: dict[tuple, np.ndarray] = {}

    def get(self, sel) -> np.ndarray:
        sel = tuple(int(x) for x in sel)
        w = self._cache.get(sel)
        if w is None:
            w = np.zeros(self.code.n)
            w[list(sel)] = self.code.decode_weights(list(sel))
            if len(self._cache) >= self.max_entries:
                self._cache.clear()
            self._cache[sel] = w
        return w


def _matdot_worker(A_i, w_i, B, p: int, precision: str):
    # B: (kd, nc) -> (p, kd/p, nc) row blocks; B̃_i = Σ_j w_i[j] B_j
    kd, nc = B.shape
    Bp = B.reshape(p, kd // p, nc)
    B_enc = torch.einsum("j,jkw->kw", w_i.to(B.dtype), Bp)
    return matmul(A_i, B_enc, precision)


def _matdot_combine(weights, shards):
    # C = Σ_i w_i C̃_i : one einsum over the arrived evaluations
    return torch.einsum("i,irw->rw", weights, shards)


class MatDotCode:
    """MatDot code with p inner-dimension blocks over n workers;
    recovery threshold ``k = 2p - 1``.

    >>> code = MatDotCode(p=2, n=5)
    >>> A_enc = code.encode_A(A_blocks)      # (p, m, kd/p) -> (5, m, kd/p)
    >>> # worker i: A_enc[i] @ (sum_j B_weights[i, j] * B_j)
    >>> C = code.combine(shards, indices)    # any 3 of 5 -> exact A @ B

    Encode and combine run in the blocks' dtype (the reference's
    ``precision=`` is the workers' products' only, as in
    :class:`~.coding.MDSCode`).
    """

    def __init__(self, p: int, n: int, *, dtype=np.float32):
        if p < 1:
            raise ValueError(f"need p >= 1, got p={p}")
        self.k = 2 * int(p) - 1  # recovery threshold
        if n < self.k:
            raise ValueError(
                f"need n >= 2p-1 workers for decodability, got n={n} < "
                f"{self.k}"
            )
        self.p, self.n = int(p), int(n)
        self.points = chebyshev_points(self.n)
        # A-encode weights x_i^j, B-encode weights x_i^(p-1-j); decode
        # interpolates degree-(2p-2) evaluations
        self.VA = (self.points[:, None] ** np.arange(self.p)).astype(dtype)
        self.VB = (
            self.points[:, None] ** (self.p - 1 - np.arange(self.p))
        ).astype(dtype)
        self._VC = self.points[:, None] ** np.arange(self.k)  # float64

    def encode_A(self, blocks) -> torch.Tensor:
        """(p, m, kd/p) column blocks of A -> (n, m, kd/p) evaluations,
        where the blocks lie."""
        blocks = as_tensor(blocks)
        if blocks.shape[0] != self.p:
            raise ValueError(
                f"expected {self.p} A-blocks, got {blocks.shape[0]}"
            )
        VA = torch.from_numpy(self.VA).to(blocks.device, blocks.dtype)
        return torch.einsum("nj,jrc->nrc", VA, blocks)

    def decode_weights(self, indices) -> np.ndarray:
        """The linear-functional weights w with ``C = Σ w_i C̃_i`` for
        the given arrived evaluation points: ``w = V_S^{-T} e_{p-1}``
        (solved in float64 on the host, as the reference solves it — a
        k×k system, negligible next to the m×nc shards it combines)."""
        idx = np.asarray(indices)
        if idx.shape[0] != self.k or len(set(idx.tolist())) != self.k:
            raise ValueError(
                f"need exactly 2p-1={self.k} distinct shard indices, "
                f"got {idx}"
            )
        e = np.zeros(self.k)
        e[self.p - 1] = 1.0
        return np.linalg.solve(self._VC[idx].T, e)

    def combine(self, shards, indices) -> torch.Tensor:
        """Any 2p-1 worker products -> the exact ``A @ B`` (one einsum,
        where the shards lie)."""
        shards = as_tensor(shards)
        if shards.shape[0] != self.k:
            raise ValueError(
                f"expected {self.k} shards, got {shards.shape[0]}"
            )
        w = torch.from_numpy(self.decode_weights(indices)).to(
            shards.device, shards.dtype)
        return _matdot_combine(w, shards)


class MatDotGemm(EvalPointCodedGemm):
    """``C = A @ B`` from any 2p-1 of n workers, inner dim partitioned.

    Worker i holds the static evaluation ``Ã_i`` (m × kd/p) and encodes
    its own ``B̃_i`` from the broadcast payload — per-worker FLOPs are
    1/p of the product.

    >>> mg = MatDotGemm(A, p=2, n=5)                # on the card
    >>> pool = AsyncPool(5)
    >>> repochs = asyncmap(pool, B, mg.backend, nwait=mg.nwait)
    >>> C = mg.result_device(pool)          # exact A @ B from 3 of 5
    """

    def __init__(
        self,
        A,
        p: int,
        n: int,
        *,
        devices: Sequence | None = None,
        delay_fn: DelayFn | None = None,
        dtype=None,
        precision: str = "highest",
    ):
        A = as_tensor(A, dtype)
        m, kd = A.shape
        if kd % p != 0:
            raise ValueError(
                f"inner dim {kd} must divide evenly into p={p} blocks"
            )
        self.devices = resolve_devices(devices)
        self.precision = check_precision(precision)
        self.code = MatDotCode(
            p, n, dtype=torch.empty(0, dtype=A.dtype).numpy().dtype)
        self.p, self.n = p, n
        # A's column blocks: (m, kd) -> (p, m, kd/p), encoded on the
        # first device
        blocks = A.to(self.devices[0]).reshape(m, p, kd // p).permute(1, 0, 2)
        coded = self.code.encode_A(blocks).to(
            operand_dtype(A.dtype, self.precision))
        self._setup_workers(coded, self.code.VB, n, delay_fn)

    def _work(self, i: int, payload: torch.Tensor, epoch: int):
        if payload.shape[0] % self.p != 0:
            raise ValueError(
                f"B rows {payload.shape[0]} must divide evenly into "
                f"p={self.p} blocks"
            )
        return _matdot_worker(
            self.A_shards[i], self.B_weights[i], payload, self.p,
            self.precision,
        )

    def _decode_shards(self, shards, idx):
        # one weighted einsum; stale shards never read
        return self.code.combine(shards, idx)
