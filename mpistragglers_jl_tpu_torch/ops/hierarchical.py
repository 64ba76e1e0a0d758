"""Hierarchical two-level coded GEMM: XOR/LT across hosts, MDS within.

The port of the JAX package's ``ops/hierarchical.py``, over
:class:`~..backends.cuda.CUDADeviceBackend` (a chip of a host group is a
CUDA stream here; one card can carry the whole fleet).

The flat :class:`~.coded_gemm.CodedGemm` pays a full Reed–Solomon-style
solve over the whole fleet and its resilience unit is a single slow
*chip*: with (n, k) over H hosts of ``n_inner`` chips each, surviving a
whole-host failure forces ``k <= (H-1) * n_inner`` — and once a host is
down the decoder needs EVERY surviving chip, so one laggard anywhere
stalls the epoch, and the decode solves a ``k x k`` system with
``k ~ (H-1) * n_inner``. The two-level construction (arxiv 1904.11563's
Array BP-XOR hierarchy) fixes both at once:

* **inner**: each host group runs the (n_inner, k_inner) MDS code (or a
  fixed-window LT code) over its chips — per-chip straggler slack
  *within every host*;
* **outer**: a cheap sum-parity / LT code (``ops/outer_code.py``)
  striped ACROSS the H groups — any lost group is reconstructed from the
  survivors by 0/1 subtraction chains, O(n) per element, never a solve.

Decode is ``L`` small ``k_inner x k_inner`` solves, batched into one
LU with partial pivoting (``ops/coding.py`` ``_lu_solve``; no host sync,
never ``torch.linalg.solve_ex``), plus the O(n) outer pass, all on the
card; the epoch returns the moment ``L`` groups each clear their
*inner* floor — a straggling or dead host is simply never waited on.

The pool wiring is the reference's functional-``nwait`` mechanism:
:func:`~.outer_code.hierarchical_nwait` evaluates the two-level
completion rule over the live ``repochs`` after every arrival, so
``asyncmap(pool, B, backend, nwait=hg.nwait)`` is the whole coordinator
loop. Fleet partitions are an even split or explicit lists of worker
ids, such as the partition ``parallel.multihost.host_groups`` reads off
a multi-process mesh (one group per process).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..backends.base import DelayFn
from ..backends.cuda import CUDADeviceBackend, consume
from ..pool import AsyncPool
from ._batch import as_tensor, check_precision, operand_dtype
from .coding import MDSCode, _lu_solve
from .gemm import _block_matmul, resolve_devices
from .lt import LTCode, sum_support
from .outer_code import hierarchical_nwait, make_outer, partition_groups

__all__ = ["HierarchicalCodedGemm", "decode_groups"]


def decode_groups(G_S: torch.Tensor, shards: torch.Tensor) -> torch.Tensor:
    """ALL used groups' inner MDS decodes as one batched solve.

    ``G_S``: (g, k, k) per-group generator submatrices; ``shards``:
    (g, k, rows, cols) per-group fresh shard stacks. Returns the
    (g, k, rows, cols) source blocks."""
    g, k = shards.shape[0], shards.shape[1]
    flat = shards.reshape(g, k, -1)
    return _lu_solve(G_S.to(flat.dtype), flat).reshape(shards.shape)


class HierarchicalCodedGemm:
    """``C = A @ B`` recoverable from any outer-floor-many host groups,
    each recoverable from any ``k_inner`` of its ``n_inner`` chips.

    >>> hg = HierarchicalCodedGemm(A, groups=4, n_inner=8, k_inner=6)
    >>> pool = AsyncPool(hg.n_workers)
    >>> asyncmap(pool, B, hg.backend, nwait=hg.nwait)   # 3 of 4 groups
    >>> C = hg.result_device(pool)                      # exact product

    ``groups`` is a group count (contiguous split) or an explicit
    partition (lists of worker ids). The outer code defaults to the
    rate-(H-1)/H sum parity (single-host-loss tolerance, O(n) recovery);
    pass ``outer_rate`` below that for LT multi-host tolerance.
    ``inner="mds"`` (any k_inner of n_inner, solve decode) or ``"lt"``
    (fixed systematic window, peeling decode).

    ``device_backend=False`` skips building the
    :class:`~..backends.cuda.CUDADeviceBackend` (no dispatcher threads):
    externally built backends drive the same math through ``hg.work``.

    ``registry=`` / ``flight=`` follow the package-wide opt-in contract
    (dark paths pay only ``is None`` checks): decode counters
    ``hier_inner_decode_total{group=...}``, ``hier_group_losses_total``,
    ``hier_outer_recoveries_total``, and a flight-recorder instant event
    on every outer-code recovery.
    """

    def __init__(
        self,
        A,
        *,
        groups: int | Sequence[Sequence[int]],
        n_inner: int | None = None,
        k_inner: int,
        inner: str = "mds",
        outer: str = "auto",
        outer_rate: float | None = None,
        outer_seed: int = 0,
        inner_seed: int = 0,
        parity: str = "cauchy",
        dtype=None,
        precision: str = "highest",
        devices: Sequence | None = None,
        delay_fn: DelayFn | None = None,
        device_backend: bool = True,
        registry=None,
        flight=None,
    ):
        A = as_tensor(A, dtype)
        if isinstance(groups, (int, np.integer)):
            if n_inner is None:
                raise ValueError(
                    "n_inner is required when groups is a count"
                )
            self.group_indices = partition_groups(
                int(groups) * int(n_inner), int(groups)
            )
        else:
            self.group_indices = partition_groups(
                sum(len(g) for g in groups), groups
            )
            if n_inner is not None and n_inner != len(self.group_indices[0]):
                raise ValueError(
                    f"explicit groups of size {len(self.group_indices[0])} "
                    f"contradict n_inner={n_inner}"
                )
        self.H = len(self.group_indices)
        self.n_inner = len(self.group_indices[0])
        self.k_inner = int(k_inner)
        if not 0 < self.k_inner <= self.n_inner:
            raise ValueError(
                f"need 0 < k_inner <= n_inner, got k_inner={k_inner}, "
                f"n_inner={self.n_inner}"
            )
        self.n_workers = self.H * self.n_inner
        self.outer = make_outer(
            self.H, rate=outer_rate, kind=outer, seed=outer_seed
        )
        self.L = self.outer.L
        m = A.shape[0]
        if m % (self.L * self.k_inner) != 0:
            raise ValueError(
                f"rows {m} must divide evenly into L*k_inner = "
                f"{self.L}*{self.k_inner} source blocks"
            )
        self.devices = resolve_devices(devices)
        self.precision = check_precision(precision)
        self.block_rows = m // (self.L * self.k_inner)
        # the encodes sum in f32 (f64 for f64 A), then round once to A's
        # dtype, as the reference's einsums do
        wide = torch.float64 if A.dtype == torch.float64 else torch.float32
        dev = self.devices[0]
        # -- outer encode: one host-group block per group, 0/1 sums ----
        src = A.to(dev, wide).reshape(self.L, m // self.L, *A.shape[1:])
        group_blocks = torch.stack([
            sum_support(src, np.flatnonzero(row))
            for row in self.outer.generator_rows()])
        group_blocks = group_blocks.to(A.dtype).to(wide)
        # -- inner encode: the dense code over each group --------------
        self.inner = str(inner)
        if self.inner == "mds":
            self._icode = MDSCode(
                self.n_inner, self.k_inner, parity=parity,
                dtype=np.float64,
            )
            self._inner_ids = list(range(self.n_inner))
            inner_G = self._icode.G
        elif self.inner == "lt":
            self._icode = LTCode(
                self.k_inner, seed=inner_seed, systematic=True
            )
            # fixed shard window, LTCodedGemm discipline: slide until
            # the full window peels so nwait is always satisfiable
            # (systematic streams peel at the first window already)
            ids = list(range(self.n_inner))
            for _ in range(1000):
                if self._icode.peelable(ids):
                    break
                ids = [s + 1 for s in ids]
            else:
                raise ValueError(
                    f"no decodable window of {self.n_inner} LT shards "
                    f"for k_inner={self.k_inner}"
                )
            self._inner_ids = ids
            inner_G = self._icode.generator_rows(ids)
        else:
            raise ValueError(f"unknown inner code {inner!r}")
        # the generator rounded to A's dtype, as the workers compute in
        # it; the decode embeds those rounded values exactly
        self._inner_G = torch.from_numpy(np.asarray(inner_G, np.float64)).to(
            A.dtype)
        coded = torch.einsum(
            "nk,hkrc->hnrc", self._inner_G.to(dev, wide),
            group_blocks.reshape(
                self.H, self.k_inner, self.block_rows, *A.shape[1:]
            ),
        ).to(A.dtype)
        # worker w = group_indices[g][j] holds inner shard j of group g
        op_dtype = operand_dtype(A.dtype, self.precision)
        self.blocks: list = [None] * self.n_workers
        for g, members in enumerate(self.group_indices):
            for j, w in enumerate(members):
                self.blocks[int(w)] = coded[g, j].to(
                    self.devices[int(w) % len(self.devices)], op_dtype
                ).contiguous()
        del coded, group_blocks, src
        # decode runs in at least f32 (the outer subtraction chain must
        # not round at bf16 either); its generator lies on the first
        # device, so no index or row crosses to the card at decode time
        self._decode_dtype = wide
        self._inner_G_dev = self._inner_G.to(dev, wide)
        self.backend = (
            CUDADeviceBackend(
                self._work, self.n_workers, devices=self.devices,
                delay_fn=delay_fn,
            )
            if device_backend else None
        )
        # opt-in telemetry (instruments resolved once; None = dark,
        # the decode path pays one `is None` check)
        self._m = None
        self._flight = flight
        if registry is not None:
            registry.gauge(
                "hier_groups", help="host groups H of the outer code"
            ).set(self.H)
            registry.gauge(
                "hier_outer_floor",
                help="groups needed to clear the outer code",
            ).set(self.L)
            self._m = {
                "outer_rec": registry.counter(
                    "hier_outer_recoveries_total",
                    help="source group blocks reconstructed by the "
                         "outer code (a host was lost or skipped)",
                ),
                "losses": registry.counter(
                    "hier_group_losses_total",
                    help="group-epochs not inner-decodable at decode "
                         "time (straggling or dead hosts skipped)",
                ),
                "inner": [
                    registry.counter(
                        "hier_inner_decode_total",
                        help="inner decodes consumed per group",
                        group=str(g),
                    )
                    for g in range(self.H)
                ],
            }

    # -- worker side ------------------------------------------------------
    def _work(self, i: int, payload, epoch: int):
        block = self.blocks[int(i)]
        return _block_matmul(block, as_tensor(payload).to(block.device),
                             self.precision)

    @property
    def work(self):
        """The ``work_fn(worker, payload, epoch)`` for externally-built
        backends (``LocalBackend(hg.work, hg.n_workers, ...)``)."""
        return self._work

    # -- completion rule --------------------------------------------------
    def _group_arrived(self, g: int, fresh_mask: np.ndarray) -> bool:
        """Inner decodability floor of group ``g`` over a freshness
        mask: >= k_inner fresh shards (MDS) / a peelable fresh id set
        (LT)."""
        members = self.group_indices[g]
        local = np.flatnonzero(fresh_mask[members])
        if self.inner == "mds":
            return local.size >= self.k_inner
        if local.size < self.k_inner:
            return False
        return self._icode.peelable([self._inner_ids[j] for j in local])

    @property
    def nwait(self):
        """Two-level decodability predicate for ``asyncmap(nwait=...)``:
        arrive per group at the inner floor, complete at the outer
        floor."""
        return hierarchical_nwait(
            self.group_indices, self._group_arrived, self.outer
        )

    def _fresh_mask(self, pool: AsyncPool, epoch) -> np.ndarray:
        mask = np.zeros(self.n_workers, dtype=bool)
        mask[pool.fresh_indices(epoch)] = True
        return mask

    def arrived_groups(self, pool: AsyncPool, epoch: int | None = None) -> list[int]:
        """Groups whose inner floor is met by the pool's fresh results."""
        mask = self._fresh_mask(pool, epoch)
        return [
            g for g in range(self.H) if self._group_arrived(g, mask)
        ]

    # -- decode -----------------------------------------------------------
    def _shard(self, pool: AsyncPool, w: int) -> torch.Tensor:
        return consume(pool.results[int(w)]).to(
            self.devices[0], self._decode_dtype)

    def _inner_decode(self, g: int, pool: AsyncPool, fresh_mask: np.ndarray):
        """Group ``g``'s coded product block from its fresh shards by
        peeling (LT inner code), on the card."""
        members = self.group_indices[g]
        local = np.flatnonzero(fresh_mask[members])
        ids = [self._inner_ids[j] for j in local]
        shards = [self._shard(pool, members[j]) for j in local]
        blocks = self._icode.decode(shards, ids)
        return blocks.reshape(-1, *blocks.shape[2:])

    def result_device(self, pool: AsyncPool,
                      epoch: int | None = None) -> torch.Tensor:
        """Decode the full product from the arrived groups, on the first
        device, read on the current stream.

        Refuses — naming both floors — when the arrived set cannot
        decode; on a recovery (any source group missing) the outer code
        reconstructs it from the survivors and the event is counted /
        flight-recorded.
        """
        mask = self._fresh_mask(pool, epoch)
        arrived = [
            g for g in range(self.H) if self._group_arrived(g, mask)
        ]
        if not self.outer.decodable(arrived):
            raise ValueError(
                f"only {len(arrived)} of {self.H} groups are "
                f"inner-decodable (floor {self.k_inner} fresh of "
                f"{self.n_inner}) at epoch "
                f"{pool.epoch if epoch is None else epoch}; the outer "
                f"floor needs {self.L} decodable groups"
            )
        used = self.outer.select(arrived)
        if self.inner == "mds":
            # ALL inner decodes in one batched solve
            sels = [
                np.flatnonzero(mask[self.group_indices[g]])[: self.k_inner]
                for g in used
            ]
            shards = torch.stack([
                torch.stack([
                    self._shard(pool, self.group_indices[g][j]) for j in sel
                ])
                for g, sel in zip(used, sels)
            ])
            G_S = torch.stack([
                torch.stack([self._inner_G_dev[int(j)] for j in sel])
                for sel in sels
            ])
            blocks = decode_groups(G_S, shards)
            inner_blocks = [b.reshape(-1, *b.shape[2:]) for b in blocks]
        else:
            inner_blocks = [
                self._inner_decode(g, pool, mask) for g in used
            ]
        lost = self.H - len(arrived)
        recovered = self.L - sum(1 for g in used if g < self.L)
        if self._m is not None:
            if lost:
                self._m["losses"].inc(lost)
            for g in used:
                self._m["inner"][g].inc()
            if recovered:
                self._m["outer_rec"].inc(recovered)
        if self._flight is not None and recovered:
            self._flight.event(
                "hier outer recovery",
                epoch=int(pool.epoch if epoch is None else epoch),
                missing_groups=[g for g in range(self.L) if g not in used],
                recovered_blocks=int(recovered),
                arrived=len(arrived),
            )
        sources = self.outer.decode(inner_blocks, used)
        return sources.reshape(-1, *sources.shape[2:])

    def result(self, pool: AsyncPool, epoch: int | None = None) -> np.ndarray:
        """Host-copy variant of :meth:`result_device`."""
        return self.result_device(pool, epoch).cpu().numpy()
