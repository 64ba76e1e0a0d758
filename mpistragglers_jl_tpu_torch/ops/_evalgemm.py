"""Shared scaffolding for evaluation-point coded GEMM workloads.

The port of the JAX package's ``ops/_evalgemm.py``.
:class:`~.polynomial.PolyCodedGemm` and :class:`~.matdot.MatDotGemm` are
the same machine around different codes: per-worker static evaluations
of A placed on devices, per-worker B-encode weights, a
:class:`~..backends.cuda.CUDADeviceBackend` running the fused
encode+matmul on each worker's stream, a decodability-predicate
``nwait``, and a fresh-shard harvest that decodes on the pool's first
device. That machinery lives here once; subclasses provide the code
object (with recovery threshold ``k``), the worker computation, and the
decode.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..backends.base import DelayFn
from ..backends.cuda import CUDADeviceBackend, consume
from ..pool import AsyncPool
from .coding import nwait_decodable

__all__ = ["EvalPointCodedGemm", "chebyshev_points"]


def chebyshev_points(n: int) -> np.ndarray:
    """n distinct Chebyshev nodes in (-1, 1): real-field Vandermonde
    systems over these are far better conditioned than over equispaced
    points — what makes an f32 decode viable (SURVEY §7 "Float64 /
    conditioning"). The reference's nodes, bit for bit."""
    i = np.arange(n)
    return np.cos((2 * i + 1) * np.pi / (2 * n)).astype(np.float64)


class EvalPointCodedGemm:
    """Base for pool workloads computing ``A @ B`` from coded
    evaluations. Subclasses must, in ``__init__``, set ``self.code``
    (exposing ``k``), ``self.devices``, then call :meth:`_setup_workers`
    — and implement ``_work(i, payload, epoch)`` plus
    :meth:`_decode_shards`.
    """

    code = None  # set by subclass before _setup_workers
    devices: list

    def _setup_workers(
        self,
        coded_A: torch.Tensor,
        B_weights: np.ndarray,
        n: int,
        delay_fn: DelayFn | None,
    ) -> None:
        """Place per-worker A evaluations + B-encode weights round-robin
        over the devices and wire the CUDA backend."""
        self.A_shards = [
            coded_A[i].to(self.devices[i % len(self.devices)])
            for i in range(n)
        ]
        self.B_weights = [
            torch.from_numpy(np.ascontiguousarray(B_weights[i])).to(
                self.devices[i % len(self.devices)])
            for i in range(n)
        ]
        self.backend = CUDADeviceBackend(
            self._work, n, devices=self.devices, delay_fn=delay_fn
        )

    @property
    def k(self) -> int:
        """Recovery threshold of the underlying code."""
        return self.code.k

    @property
    def nwait(self):
        """Decodability predicate: true at >= k fresh shards."""
        return nwait_decodable(self.k)

    def _decode_shards(self, shards: torch.Tensor, idx: np.ndarray):
        raise NotImplementedError

    def result_device(
        self, pool: AsyncPool, epoch: int | None = None
    ) -> torch.Tensor:
        """Decode the full product from the first k fresh shards, on the
        pool's first device, read on the current stream (the results are
        made on the workers' streams: read through ``consume``). Stale
        shards are never read."""
        fresh = pool.fresh_indices(epoch)
        if fresh.size < self.k:
            raise ValueError(
                f"only {fresh.size} fresh shards at epoch "
                f"{pool.epoch if epoch is None else epoch}, need "
                f"k={self.k}"
            )
        idx = fresh[: self.k]
        shards = torch.stack([
            consume(pool.results[i]).to(self.devices[0]) for i in idx
        ])
        return self._decode_shards(shards, idx)

    def result(self, pool: AsyncPool, epoch: int | None = None) -> np.ndarray:
        """Host-copy variant of :meth:`result_device`."""
        return self.result_device(pool, epoch).cpu().numpy()
