"""Gradient coding: exact full-batch gradients despite s stragglers.

A copy of the JAX package's ``ops/gradcode.py`` (numpy only).

Cyclic-repetition gradient coding (Tandon et al., "Gradient Coding"):
the dataset is partitioned into n chunks; worker i computes a fixed
linear combination of the gradients of chunks ``{i, i+1, ..., i+s}``
(cyclic), so each chunk is replicated on s+1 workers. From the coded
sums of *any* n-s workers, the decoder finds combination weights ``a``
with ``aᵀ B_S = 1ᵀ`` and recovers the exact sum of all n chunk
gradients — stragglers cost nothing but the (s+1)× compute replication.

The pool's ``repochs`` mask (reference src/MPIAsyncPools.jl:109,:168)
selects the arrived rows ``S``; the coefficient matrix ``B`` uses random
support coefficients so every (n-s)-row subset is full-rank almost
surely, with feasibility checked at decode.
"""

from __future__ import annotations

import numpy as np

__all__ = ["GradientCode"]


class GradientCode:
    """(n, s) cyclic-repetition gradient code.

    ``B[i, j]`` is worker i's coefficient on chunk j, supported on the
    cyclic window ``{i, ..., i+s}``. ``decode_weights(arrived)`` returns
    per-worker weights whose combination reproduces ``sum_j grad_j``.
    """

    def __init__(self, n: int, s: int, *, seed: int = 0):
        if not 0 <= s < n:
            raise ValueError(f"need 0 <= s < n, got n={n}, s={s}")
        self.n, self.s = int(n), int(s)
        rng = np.random.default_rng(seed)
        # Tandon et al. cyclic construction: draw a random H (s×n) with
        # H @ 1 = 0; every row b_i of B lies in null(H) and is supported
        # on the cyclic window, with b_i[i] = 1. Then any n-s surviving
        # rows span null(H) (generic independence), which contains the
        # all-ones vector — so the decoder's aᵀ B_S = 1ᵀ is always
        # feasible. Arbitrary per-row random coefficients do NOT have
        # this property (1 is generically outside the row space).
        B = np.zeros((n, n))
        if s == 0:
            B = np.eye(n)
        else:
            H = rng.standard_normal((s, n))
            H -= H.mean(axis=1, keepdims=True)  # rows ⟂ all-ones
            for i in range(n):
                sup = [(i + d) % n for d in range(s + 1)]
                rest = sup[1:]
                # solve H[:, rest] c = -H[:, i]  (s×s, generically invertible)
                c = np.linalg.solve(H[:, rest], -H[:, sup[0]])
                B[i, sup[0]] = 1.0
                B[i, rest] = c
        self.B = B

    def support(self, i: int) -> list[int]:
        """Chunk ids worker i must compute (cyclic window of s+1)."""
        return [(i + d) % self.n for d in range(self.s + 1)]

    def decode_weights(self, arrived) -> np.ndarray:
        """Weights ``a`` with ``aᵀ B[arrived] = 1ᵀ`` (least-squares).

        Raises ``ValueError`` if the arrived set cannot reproduce the
        full gradient (fewer than n-s workers, or a degenerate subset).
        """
        idx = np.asarray(arrived)
        if idx.size < self.n - self.s:
            raise ValueError(
                f"need at least n-s={self.n - self.s} workers, "
                f"got {idx.size}"
            )
        B_S = self.B[idx]  # (m, n)
        a, *_ = np.linalg.lstsq(B_S.T, np.ones(self.n), rcond=None)
        if not np.allclose(B_S.T @ a, 1.0, atol=1e-6):
            raise ValueError(
                f"arrived set {idx.tolist()} cannot reproduce the full "
                "gradient (degenerate subset)"
            )
        return a
