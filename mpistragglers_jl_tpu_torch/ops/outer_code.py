"""Outer codes across host groups: the cheap half of two-level coding.

The hierarchical construction (ROADMAP item 3; Array BP-XOR codes for
hierarchically distributed matmul, arxiv 1904.11563) composes two codes
with very different price tags: a dense MDS/LT *inner* code over each
host's chip mesh (``ops/coding.py`` / ``ops/lt.py`` — solve- or
peel-decoded, already built) and a cheap XOR-style *outer* code striped
ACROSS hosts, whose decode is O(n) additions per element. This module
holds the outer half plus the predicate glue: a copy of the JAX
package's ``ops/outer_code.py``, the code objects and predicates in
numpy as there, so both packages pick the same groups. Its decodes
take numpy arrays or torch tensors alike, so the heavy device class
(:class:`~.hierarchical.HierarchicalCodedGemm`) runs its outer pass on
the card, after its batched inner solves.

Over the reals the XOR of the paper's binary construction becomes a
sum (the same translation :mod:`.lt` makes for LT peeling): the parity
group holds ``Σ A_j`` and a lost source group is recovered by
subtracting the surviving sources from the parity — numerically benign
(0/1 coefficients, one subtraction chain of length H-2).

Two outer families:

* :class:`ParityOuter` — the rate-(H-1)/H fast path: H-1 systematic
  source groups + ONE sum-parity group. Any H-1 of H groups decode;
  losing any single host costs one O(n) subtraction pass, never a
  solve. This is the deployment default (host failures are rare and
  overwhelmingly singular).
* :class:`LTOuter` — lower rates via the systematic LT generator
  machinery (:class:`~.lt.LTCode`, the same generator/peeling engine
  ``ops/rateless.py`` draws its shard streams from): L source groups,
  H-L coded groups with patch-distribution supports, peeling decode.
  Survives multi-host loss at rate L/H.

The ``asyncmap`` wiring is one predicate (:func:`hierarchical_nwait`):
a group has *arrived* when its inner decodability floor is met over the
live ``repochs`` freshness mask, and the epoch completes when the
arrived group set clears the outer floor — a straggling or dead host is
simply never waited on.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from .lt import LTCode, _copy, _stack

__all__ = [
    "ParityOuter",
    "LTOuter",
    "make_outer",
    "partition_groups",
    "hierarchical_nwait",
]


class ParityOuter:
    """Rate-(H-1)/H sum-parity outer code over ``H`` host groups.

    Group ``g < L`` holds source block ``g``; group ``H-1`` holds the
    parity ``Σ_j A_j``. ``decodable`` is simply ``len(groups) >= L``
    (any L distinct of H), and ``decode`` is the XOR-translated
    recovery: at most one source can be missing, and it equals the
    parity minus the surviving sources.
    """

    kind = "parity"

    def __init__(self, H: int):
        if int(H) < 2:
            raise ValueError(
                f"parity outer code needs >= 2 groups, got {H}"
            )
        self.H = int(H)
        self.L = self.H - 1

    @property
    def rate(self) -> float:
        return self.L / self.H

    def generator_rows(self) -> np.ndarray:
        """(H, L) 0/1 generator: identity rows + the all-ones parity."""
        G = np.zeros((self.H, self.L), dtype=np.float32)
        G[: self.L] = np.eye(self.L, dtype=np.float32)
        G[self.L] = 1.0
        return G

    def decodable(self, groups: Sequence[int]) -> bool:
        """True iff the arrived group ids reach the outer floor (any
        ``L`` distinct groups of the H determine all L sources)."""
        return len({int(g) for g in groups}) >= self.L

    def decode(self, shards: Sequence[np.ndarray], groups: Sequence[int]) -> np.ndarray:
        """(L, rows, cols) source blocks from any L+ arrived groups.

        O(n) per element: either the L sources all arrived (pure
        gather) or exactly one is missing and costs the subtraction
        chain ``parity - Σ survivors``.
        """
        ids = [int(g) for g in groups]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate group ids {ids}")
        if not self.decodable(ids):
            raise ValueError(
                f"{len(ids)} arrived groups {sorted(ids)} sit below the "
                f"outer decodability floor {self.L} of this "
                f"rate-{self.L}/{self.H} parity code"
            )
        by_id = dict(zip(ids, shards))
        missing = [j for j in range(self.L) if j not in by_id]
        if not missing:
            return _stack([by_id[j] for j in range(self.L)])
        # exactly one source can be absent (floor says >= L of L+1 ids)
        j = missing[0]
        rec = _copy(by_id[self.L])  # the parity group
        for g, s in by_id.items():
            if g != self.L:
                rec -= s
        return _stack([
            rec if i == j else by_id[i] for i in range(self.L)
        ])

    def select(self, arrived: Sequence[int]) -> list[int]:
        """The cheapest decodable subset of the arrived groups: the L
        sources when they all arrived (decode is a pure gather), else
        the surviving sources plus the parity (one subtraction chain)."""
        ids = sorted({int(g) for g in arrived})
        src = [g for g in ids if g < self.L]
        if len(src) == self.L:
            return src
        if not self.decodable(ids):
            raise ValueError(
                f"arrived groups {ids} sit below the outer floor {self.L}"
            )
        return src + [self.L]


class LTOuter:
    """Rate-L/H outer code on the systematic LT generator machinery.

    Group ``g`` takes outer shard id ``g`` of a systematic
    :class:`~.lt.LTCode` over L source groups: ids ``0..L-1`` ARE the
    sources, ids ``L..H-1`` are patch-distribution coded sums.
    ``decodable`` is peelability of the arrived id set and ``decode``
    is the peeling pass — still 0/1 subtractions, never a solve, but
    unlike parity it survives multi-host loss when H - L > 1.
    """

    kind = "lt"

    def __init__(self, H: int, L: int, *, seed: int = 0):
        if not 1 <= int(L) <= int(H):
            raise ValueError(
                f"need 1 <= L <= H for an (H={H}, L={L}) outer code"
            )
        self.H, self.L = int(H), int(L)
        self.code = LTCode(self.L, seed=seed, systematic=True)
        # the deployed window is the H group ids themselves; the
        # systematic prefix guarantees the full set peels, so the
        # no-loss epoch is always decodable
        if not self.code.peelable(list(range(self.H))):  # pragma: no cover
            raise ValueError(
                f"outer window 0..{self.H - 1} does not peel for L={L}"
            )

    @property
    def rate(self) -> float:
        return self.L / self.H

    def generator_rows(self) -> np.ndarray:
        """(H, L) 0/1 generator rows for the H group shard ids."""
        return self.code.generator_rows(list(range(self.H)))

    def decodable(self, groups: Sequence[int]) -> bool:
        ids = sorted({int(g) for g in groups})
        if len(ids) < self.L:  # cheap reject before the peel walk
            return False
        return self.code.peelable(ids)

    def decode(self, shards: Sequence[np.ndarray], groups: Sequence[int]) -> np.ndarray:
        ids = [int(g) for g in groups]
        if not self.decodable(ids):
            raise ValueError(
                f"arrived groups {sorted(set(ids))} sit below the outer "
                f"decodability floor of this (H={self.H}, L={self.L}) "
                "LT outer code (peeling stalls)"
            )
        return self.code.decode(list(shards), ids)

    def select(self, arrived: Sequence[int]) -> list[int]:
        """A decodable subset of the arrived groups, preferring the
        systematic prefix (pure gather) and otherwise the shortest
        peelable id prefix — every selected group pays one inner
        decode, so fewer is cheaper."""
        ids = sorted({int(g) for g in arrived})
        src = [g for g in ids if g < self.L]
        if len(src) == self.L:
            return src
        chosen: list[int] = []
        for g in ids:
            chosen.append(g)
            if len(chosen) >= self.L and self.code.peelable(chosen):
                return chosen
        raise ValueError(
            f"arrived groups {ids} sit below the outer decodability "
            f"floor of this (H={self.H}, L={self.L}) LT outer code"
        )


def make_outer(H: int, *, rate: float | None = None, kind: str = "auto",
               seed: int = 0):
    """Outer-code factory: ``kind="auto"`` picks the parity fast path
    at the rate-(H-1)/H point and the LT generator machinery anywhere
    else. ``rate=None`` defaults to (H-1)/H — single-host-loss
    tolerance, the deployment default."""
    H = int(H)
    if rate is None:
        L = H - 1 if H > 1 else 1
    else:
        L = int(round(H * float(rate)))
    if L < 1:
        raise ValueError(
            f"outer rate {rate} over {H} groups rounds to L={L} source "
            "groups — below the outer decodability floor (L >= 1)"
        )
    if L > H:
        raise ValueError(
            f"outer rate {rate} over {H} groups rounds to L={L} > H"
        )
    if kind == "auto":
        kind = "parity" if L == H - 1 else "lt"
    if kind == "parity":
        if L != H - 1:
            raise ValueError(
                f"parity outer codes are rate (H-1)/H; got L={L} of H={H}"
            )
        return ParityOuter(H)
    if kind == "lt":
        return LTOuter(H, L, seed=seed)
    raise ValueError(f"unknown outer code kind {kind!r}")


def partition_groups(
    n_workers: int, groups: int | Sequence[Sequence[int]]
) -> list[np.ndarray]:
    """Normalize a fleet partition: either ``groups`` host groups of
    contiguous worker indices (the single-host layout) or an explicit
    partition (lists of worker ids, e.g. read off a multi-process mesh
    by ``parallel.multihost.host_groups``). Groups must be
    equal-sized, disjoint, and cover ``0..n_workers-1`` exactly."""
    n = int(n_workers)
    if isinstance(groups, (int, np.integer)):
        H = int(groups)
        if H < 1 or n % H != 0:
            raise ValueError(
                f"{n} workers do not partition evenly into {H} groups"
            )
        size = n // H
        return [
            np.arange(g * size, (g + 1) * size, dtype=np.int64)
            for g in range(H)
        ]
    part = [np.asarray([int(w) for w in g], dtype=np.int64) for g in groups]
    if not part:
        raise ValueError("empty group partition")
    sizes = {len(g) for g in part}
    if sizes == {0} or len(sizes) != 1:
        raise ValueError(
            f"host groups must be equal-sized, got sizes "
            f"{sorted(len(g) for g in part)}"
        )
    flat = np.concatenate(part)
    if sorted(flat.tolist()) != list(range(n)):
        raise ValueError(
            f"groups must cover workers 0..{n - 1} exactly once, got "
            f"{sorted(flat.tolist())}"
        )
    return part


def hierarchical_nwait(
    group_indices: Sequence[np.ndarray],
    inner_arrived: Callable[[int, np.ndarray], bool],
    outer,
):
    """Predicate factory for ``asyncmap(nwait=...)`` — the two-level
    completion rule evaluated over the live ``repochs`` after every
    arrival (reference src/MPIAsyncPools.jl:152-158, the same
    mechanism :func:`~.coding.nwait_decodable` rides):

    * group ``g`` has ARRIVED when ``inner_arrived(g, fresh_mask)``
      says its inner decodability floor is met (>= k fresh shards for
      MDS, a peelable fresh id set for LT);
    * the epoch COMPLETES when the arrived group set clears
      ``outer.decodable`` — so a host that straggles or dies is never
      waited on, as long as the survivors clear the outer floor.
    """

    idx = [np.asarray(g, dtype=np.int64) for g in group_indices]

    def pred(epoch: int, repochs: np.ndarray) -> bool:
        fresh = np.asarray(repochs) == epoch
        arrived = [g for g in range(len(idx)) if inner_arrived(g, fresh)]
        return outer.decodable(arrived)

    return pred
