"""Systematic MDS erasure coding over the reals, for coded computation.

The port of the JAX package's ``ops/coding.py``. The reference's
``repochs`` freshness mask (src/MPIAsyncPools.jl:109,:168) is the
arrival mask an erasure decoder needs: encode k source blocks into n
coded blocks, hand one to each pool worker, and decode the full result
from *any* k fresh arrivals. ops/coded_gemm.py wires it to the pool
(BASELINE config 3: (n=8, k=6) MDS-coded GEMM).

* **Generator** ``G = [I; P]`` (n×k), systematic, built in numpy exactly
  as the reference builds it (bit-identical): Cauchy parity on
  interleaved points (every square submatrix nonsingular, so provably
  MDS) or i.i.d. Gaussian parity from ``np.random.default_rng(seed)``.
* **Encode** is one einsum over the block axis.
* **Decode** is one k×k solve against the flattened shards, by LU with
  partial pivoting as ``jax.scipy.linalg.solve`` computes it (and, like
  it, without checking for a singular system, so the host never waits
  on the card).
* No conditioning guard, as in the reference: large k with Cauchy
  parity is numerically dead (docs/PERF.md:333).
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs.timeline import annotate_if
from ._batch import as_tensor

__all__ = ["MDSCode", "nwait_decodable"]


def _cauchy_parity(n_parity: int, k: int) -> np.ndarray:
    """Cauchy matrix P[i, j] = 1 / (x_i - y_j) on interleaved points.

    x and y are distinct points in [-1, 1]; interleaving keeps the
    denominators away from zero and the conditioning reasonable.
    """
    pts = np.linspace(-1.0, 1.0, n_parity + k, endpoint=True)
    x, y = pts[k:], pts[:k]  # disjoint -> all denominators nonzero
    return 1.0 / (x[:, None] - y[None, :])


def _encode(G: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    # blocks: (k, rows, cols) -> coded: (n, rows, cols)
    return torch.einsum("nk,krc->nrc", G, blocks)


def _lu_solve(G_S: torch.Tensor, flat: torch.Tensor,
              rows: torch.Tensor | None = None,
              tracer=None) -> torch.Tensor:
    """``G_S X = flat`` by LU with partial pivoting, the algorithm of
    ``jax.scipy.linalg.solve`` and LAPACK's ``gesv``: factor the small
    k x k ``G_S``, permute ``flat``'s rows in one gather, then two
    triangular solves. Nothing here checks for a singular system, so the
    host never waits on the card.

    Written out for the card's sake, with millions of right-hand sides
    (6 x 11.2 M at BASELINE config 3 on an H100; PERF.md §6):
    ``torch.linalg.solve_ex`` takes 1.1 s once the LU exchanges rows
    (2.6 ms without), and a triangular solve from the left takes
    6-7.5 s. From the right, on ``flat``'s transpose
    (column-major as it lies), each triangular solve takes 1.2-1.4 ms:
    X^T U^T = Y^T and Y^T L^T = (P^T flat)^T.

    Batched too: ``G_S`` (g, k, k) and ``flat`` (g, k, N) solve g
    systems at once (the hierarchical GEMM's per-group inner decodes),
    each exactly as the 2-D call would.

    ``rows`` (a device index tensor, 2-D ``flat`` only) solves against
    ``flat[rows]`` instead, with that selection folded into the pivots'
    gather: one copy of the k right-hand rows, not two.

    A tracer that asks for spans (the caller's ``tracer=``) opens
    ``mp.decode.factor``, ``mp.decode.gather`` and ``mp.decode.solve``."""
    on = getattr(tracer, "spans", False)
    with annotate_if(on, "mp.decode.factor"):
        LU, piv, _ = torch.linalg.lu_factor_ex(G_S)
        P, L, U = torch.lu_unpack(LU, piv)
        # G_S = P L U, so L U X = P^T flat, whose row i is flat[perm[i]]
        perm = P.argmax(dim=-2)
    with annotate_if(on, "mp.decode.gather"):
        if rows is not None:
            pf = flat.index_select(0, rows.index_select(0, perm))
        elif flat.dim() == 2:
            pf = flat.index_select(0, perm)
        else:
            batch = torch.arange(flat.shape[0], device=flat.device)
            pf = flat[batch[:, None], perm]
    with annotate_if(on, "mp.decode.solve"):
        yT = torch.linalg.solve_triangular(L.mT, pf.mT, upper=True,
                                           left=False, unitriangular=True)
        return torch.linalg.solve_triangular(U.mT, yT, upper=False,
                                             left=False).mT


def _decode(G_S: torch.Tensor, shards: torch.Tensor,
            tracer=None) -> torch.Tensor:
    # shards: (k, rows, cols) from the k arrived workers; solve
    # G_S @ X = shards for the source blocks X
    k = G_S.shape[0]
    flat = shards.reshape(k, -1)
    return _lu_solve(G_S.to(flat.dtype), flat,
                     tracer=tracer).reshape(shards.shape)


def _rows(G: torch.Tensor, idx) -> torch.Tensor:
    """Rows ``idx`` of a device-resident generator, stacked from views:
    no index tensor crosses to the device (a blocking copy would
    synchronise the host with the card)."""
    return torch.stack([G[int(i)] for i in idx])


class MDSCode:
    """Systematic (n, k) MDS code over float32/float64 block vectors.

    >>> code = MDSCode(n=8, k=6)
    >>> coded = code.encode(blocks)          # (k,r,c) -> (8,r,c)
    >>> out = code.decode(coded[idx], idx)   # any 6 shards -> (6,r,c)
    """

    def __init__(
        self,
        n: int,
        k: int,
        *,
        parity: str = "cauchy",
        dtype=np.float32,
        seed: int = 0,
    ):
        """Encode and decode run in the blocks' dtype whatever the
        products' precision (the reference's ``precision=`` is dropped:
        the decode stays f32, bench.py:196-197)."""
        if not 0 < k <= n:
            raise ValueError(f"need 0 < k <= n, got n={n}, k={k}")
        self.n, self.k = int(n), int(k)
        if n == k:
            P = np.zeros((0, k))
        elif parity == "cauchy":
            P = _cauchy_parity(n - k, k)
        elif parity == "gaussian":
            rng = np.random.default_rng(seed)
            P = rng.standard_normal((n - k, k)) / np.sqrt(k)
        else:
            raise ValueError(f"unknown parity kind {parity!r}")
        self.G = np.concatenate([np.eye(k), P], axis=0).astype(dtype)
        self._G_on: dict = {}  # device -> G there (one copy per device)

    def generator(self, device) -> torch.Tensor:
        """``G`` on ``device``, copied there once."""
        device = torch.device(device)
        G = self._G_on.get(device)
        if G is None:
            G = self._G_on[device] = torch.from_numpy(self.G).to(device)
        return G

    # -- encode ----------------------------------------------------------
    def encode(self, blocks) -> torch.Tensor:
        """(k, rows, cols) source blocks -> (n, rows, cols) coded blocks,
        on the device ``blocks`` lives on (one einsum)."""
        blocks = as_tensor(blocks)
        if blocks.shape[0] != self.k:
            raise ValueError(
                f"expected {self.k} source blocks, got {blocks.shape[0]}"
            )
        G = self.generator(blocks.device).to(blocks.dtype)
        return _encode(G, blocks)

    def encode_array(self, A) -> torch.Tensor:
        """Row-partition a 2-D array into k blocks and encode -> (n,
        rows/k, cols)."""
        A = as_tensor(A)
        m = A.shape[0]
        if m % self.k != 0:
            raise ValueError(f"rows {m} not divisible by k={self.k}")
        return self.encode(A.reshape(self.k, m // self.k, *A.shape[1:]))

    # -- decode ----------------------------------------------------------
    def decode(self, shards, indices) -> torch.Tensor:
        """Recover the k source blocks from any k coded shards.

        ``shards``: (k, rows, cols) stacked coded results;
        ``indices``: which coded block each shard is (len k, distinct).
        """
        idx = np.asarray(indices)
        if idx.shape[0] != self.k or len(set(idx.tolist())) != self.k:
            raise ValueError(
                f"need exactly k={self.k} distinct shard indices, got {idx}"
            )
        shards = as_tensor(shards)
        if shards.shape[0] != self.k:
            raise ValueError(
                f"expected {self.k} shards, got {shards.shape[0]}"
            )
        return _decode(_rows(self.generator(shards.device), idx), shards)

    def decode_array(self, shards, indices) -> torch.Tensor:
        """Like :meth:`decode` but restacks blocks into the flat (k*rows,
        cols) array layout of :meth:`encode_array`'s input."""
        blocks = self.decode(shards, indices)
        return blocks.reshape(-1, *blocks.shape[2:])


def nwait_decodable(k: int):
    """Predicate factory for ``asyncmap(nwait=...)``: return True once at
    least k workers have fresh results — the decodability condition of an
    (n, k) MDS code. The reference's functional-``nwait`` mechanism
    (src/MPIAsyncPools.jl:152-154) evaluated over the live arrival mask.
    """

    def pred(epoch: int, repochs: np.ndarray) -> bool:
        return int((repochs == epoch).sum()) >= k

    return pred
