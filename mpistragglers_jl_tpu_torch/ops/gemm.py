"""Distributed matrix multiplication over an async device pool.

Uncoded row-block GEMM (BASELINE config 2): ``C = A @ B`` with ``A`` row-
partitioned over n workers, the port of the JAX package's
``ops/gemm.py``. Worker ``w`` holds its block ``A_w`` resident on its
device (placed once at setup) and each epoch receives ``B`` as the
broadcast payload, computing ``C_w = A_w @ B``.

* blocks are placed device-resident once; only ``B`` moves per epoch;
* the per-worker program is a single large matmul in the worker's
  dtype (f32, or bf16 operands at ``precision="default"``);
* ``nwait < n`` returns a row-partial product with ``repochs`` as the
  per-block freshness mask — the uncoded base case of the coded layer
  (ops/coding.py), which makes missing blocks recoverable.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..backends.base import DelayFn
from ..backends.cuda import CUDADeviceBackend, consume
from ..pool import AsyncPool
from ._batch import (
    as_tensor,
    batch_dispatch,
    build_device_groups,
    check_precision,
    matmul,
    operand_dtype,
)


def _block_matmul(a_block: torch.Tensor, b: torch.Tensor,
                  precision: str = "highest") -> torch.Tensor:
    return matmul(a_block, b, precision)


def resolve_devices(devices) -> list:
    """The workload's device list: the card by default, each entry
    resolved (a CUDA device without a card raises)."""
    if devices is None:
        return [resolve_device()]
    return [resolve_device(d) for d in devices]


def gather_rows(
    pool: AsyncPool,
    epoch: int | None = None,
    *,
    row_splits: Sequence[int] | None = None,
) -> torch.Tensor:
    """Assemble the row-stacked result from per-worker results, on
    their device, read on the current stream.

    Rows from workers whose ``repochs[i] != epoch`` are zero-filled; the
    per-row-block freshness mask is ``pool.repochs == epoch`` (i.e. the
    value ``asyncmap`` returned) — callers needing staleness policy read
    that, this function only stacks. ``row_splits`` gives each worker's
    row count when blocks are heterogeneous (load-balanced splits);
    without it all blocks must be the same shape. Raises ``ValueError``
    if no worker has any result at all for the requested epoch.
    """
    if epoch is None:
        epoch = pool.epoch
    # read only fresh blocks — stale results are replaced by zeros
    blocks = [
        consume(pool.results[i])
        if pool.results[i] is not None and pool.repochs[i] == epoch
        else None
        for i in range(pool.n_workers)
    ]
    proto = next((b for b in blocks if b is not None), None)
    if proto is None:
        if all(r is None for r in pool.results):
            raise ValueError("no worker has returned any result yet")
        raise ValueError(f"no worker has a result for epoch {epoch}")
    if row_splits is None:  # homogeneous blocks: all shaped like proto
        row_splits = [proto.shape[0]] * pool.n_workers
    out = [
        b.to(proto.device) if b is not None
        else torch.zeros((row_splits[i], *proto.shape[1:]),
                         dtype=proto.dtype, device=proto.device)
        for i, b in enumerate(blocks)
    ]
    return torch.cat(out, dim=0)


class DistributedGemm:
    """``C = A @ B`` row-partitioned over an async pool of devices.

    >>> g = DistributedGemm(A, n_workers=8)
    >>> pool = AsyncPool(8)
    >>> repochs = asyncmap(pool, B, g.backend)   # broadcast B, fastest-k
    >>> C = g.result(pool)                       # stack fresh row blocks
    """

    def __init__(
        self,
        A,
        n_workers: int,
        *,
        row_splits: Sequence[int] | None = None,
        devices: Sequence | None = None,
        delay_fn: DelayFn | None = None,
        dtype=None,
        precision: str = "highest",
        batch: bool = False,
        batch_arrival: str = "ready",
    ):
        # ``batch=True``: coalesced dispatch — each device's workers run
        # as ONE fused stacked matmul per epoch; requires homogeneous
        # row_splits, incompatible with delay_fn.
        self.precision = check_precision(precision)
        A = as_tensor(A, dtype)
        m = A.shape[0]
        if row_splits is None:
            if m % n_workers != 0:
                raise ValueError(
                    f"rows {m} must divide evenly over {n_workers} workers "
                    "(or pass row_splits)"
                )
            row_splits = [m // n_workers] * n_workers
        else:
            row_splits = [int(r) for r in row_splits]
            if len(row_splits) != n_workers:
                raise ValueError(
                    f"row_splits has {len(row_splits)} entries for "
                    f"{n_workers} workers"
                )
            if any(r < 0 for r in row_splits) or sum(row_splits) != m:
                raise ValueError(
                    f"row_splits must be non-negative and sum to {m}, "
                    f"got {row_splits}"
                )
        devices = resolve_devices(devices)
        op_dtype = operand_dtype(A.dtype, self.precision)
        self.n_workers = n_workers
        self.row_splits = row_splits
        offsets = np.concatenate([[0], np.cumsum(row_splits)])
        self._group_of: dict[int, tuple] = {}
        if batch:
            if len(set(row_splits)) != 1:
                raise ValueError(
                    "batch=True needs homogeneous row_splits (the fused "
                    "program stacks equal-shaped blocks)"
                )
            # fused per-device stacks are the only device copy; the
            # per-worker blocks stay host-side views (ops/_batch.py)
            A_host = A.cpu()
            self.blocks = [
                A_host[offsets[i]: offsets[i + 1]] for i in range(n_workers)
            ]
            self._group_of = build_device_groups(
                self.blocks, n_workers, devices, op_dtype
            )
        else:
            # place each row block on its worker's device once, up front
            self.blocks = [
                A[offsets[i]: offsets[i + 1]].to(
                    devices[i % len(devices)], op_dtype
                )
                for i in range(n_workers)
            ]
        self.backend = CUDADeviceBackend(
            self._work, n_workers, devices=devices, delay_fn=delay_fn,
            batch_fn=self._batch_work if batch else None,
            batch_arrival=batch_arrival,
        )

    def _batch_work(self, ids, payload: torch.Tensor, epoch: int):
        """Fused dispatch: every worker's row-block matmul in one
        product (shared machinery, ops/_batch.py)."""
        return batch_dispatch(self._group_of, ids, payload, self.precision)

    @classmethod
    def load_balanced(cls, A, model, **kwargs) -> "DistributedGemm":
        """Split rows proportional to fitted worker speed — the uncoded
        straggler mitigation: slow workers get less work instead of
        being raced. ``model`` is duck-typed as in the reference (a
        fitted pool latency model with ``n_workers`` and
        ``proportional_shares(rows)``).

        >>> g = DistributedGemm.load_balanced(A, model)
        """
        splits = model.proportional_shares(A.shape[0])
        return cls(
            A, model.n_workers, row_splits=splits.tolist(), **kwargs
        )

    def _work(self, i: int, payload: torch.Tensor, epoch: int):
        return _block_matmul(self.blocks[i], payload, self.precision)

    def result(self, pool: AsyncPool, epoch: int | None = None) -> torch.Tensor:
        return gather_rows(pool, epoch, row_splits=self.row_splits)
