"""MDS- and LT-coded distributed GEMM: decode ``C = A @ B`` from any k
of n workers.

The port of the JAX package's ``ops/coded_gemm.py``. BASELINE config 3:
(n=8, k=6) systematic row blocks, ``nwait=6``. The pipeline:

1. setup: row-partition ``A`` into k source blocks, MDS-encode into n
   coded blocks (one einsum, ops/coding.py), place coded block i on
   worker i's device;
2. per epoch: broadcast ``B`` via ``asyncmap``; worker i computes
   ``Ã_i @ B`` — because encoding is linear, the coded results are the
   same code applied to the true row blocks of ``C``;
3. return when ``nwait >= k`` workers are fresh (integer nwait or the
   :func:`~.coding.nwait_decodable` predicate);
4. decode: pick the first k fresh shards by the ``repochs`` mask, factor
   their k×k generator rows on the host and solve over the shards where
   they lie (ops/decode_solve.py) — the *full* product, stragglers
   ignored.

The setup encode and the decode run in the blocks' own dtype (f32) on
either precision; ``precision="default"`` applies to the workers'
products only, as the reference's decode stays f32 (bench.py:196-197).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..backends.base import DelayFn
from ..backends.cuda import CUDADeviceBackend, StackedSlice, consume, consume_stack
from ..obs.timeline import annotate_if
from ..pool import AsyncPool
from ._batch import (
    as_tensor,
    batch_dispatch,
    build_device_groups,
    check_precision,
    operand_dtype,
)
from .coding import MDSCode, _decode, _rows, nwait_decodable
from .decode_solve import decode_solve, takes
from .gemm import _block_matmul, resolve_devices
from .lt import LTCode, nwait_lt_decodable


def _solve(shards, G_host, G_dev, tracer) -> torch.Tensor:
    """The decoded product from the k fresh shards, blocks stacked by
    rows. Where :func:`~.decode_solve.takes` the shards, ``G_host()``
    (the k generator rows as host data) is factored on the host and the
    shards solved where they lie; otherwise they are stacked and solved
    by ``_decode`` with ``G_dev()`` (the same rows on the card)."""
    if takes(shards[0], len(shards)):
        blocks = decode_solve(shards, G_host(), tracer)
    else:
        on = getattr(tracer, "spans", False)
        with annotate_if(on, "mp.decode.stack"):
            G_S = G_dev()
            flat = torch.stack(shards)
        blocks = _decode(G_S, flat, tracer)
    return blocks.reshape(-1, *blocks.shape[2:])


def _host(result) -> np.ndarray:
    """A pool result on the host, as numpy."""
    return consume(result).cpu().numpy()


class CodedGemm:
    """``C = A @ B`` recoverable from any k of n workers.

    >>> cg = CodedGemm(A, n=8, k=6)
    >>> pool = AsyncPool(8, nwait=6)
    >>> repochs = asyncmap(pool, B, cg.backend)      # waits for 6 of 8
    >>> C = cg.result_device(pool)                   # exact full product
    """

    def __init__(
        self,
        A,
        n: int,
        k: int,
        *,
        devices: Sequence | None = None,
        delay_fn: DelayFn | None = None,
        parity: str = "cauchy",
        dtype=None,
        precision: str = "highest",
        batch: bool = False,
        batch_arrival: str = "ready",
        registry=None,
    ):
        """``batch=True`` turns on coalesced dispatch: all pool workers
        sharing a device run as ONE stacked product per epoch
        (CUDADeviceBackend batch mode) instead of one per worker.
        Incompatible with ``delay_fn``.

        ``registry=`` (an :class:`~..obs.MetricsRegistry`, opt-in like
        the pool's ``tracer=``) counts decodes and records, per worker,
        how often the fastest-k recovery consumed its shard: the
        reference's series."""
        A = as_tensor(A, dtype)
        m = A.shape[0]
        if m % k != 0:
            raise ValueError(f"rows {m} must divide evenly into k={k} blocks")
        self.devices = resolve_devices(devices)
        self.precision = check_precision(precision)
        self.code = MDSCode(n, k, parity=parity,
                            dtype=torch.empty(0, dtype=A.dtype).numpy().dtype)
        self.n, self.k = n, k
        self.block_rows = m // k
        op_dtype = operand_dtype(A.dtype, self.precision)
        # encode once on the first device, then distribute coded blocks
        coded = self.code.encode_array(A.to(self.devices[0]))
        # batch mode: the fused per-device stacks are the ONLY device
        # copy; per-worker blocks stay host-side views (ops/_batch.py)
        self._group_of: dict[int, tuple] = {}
        if batch:
            coded_host = coded.cpu()
            del coded
            self.blocks = [coded_host[i] for i in range(n)]
            self._group_of = build_device_groups(
                self.blocks, n, self.devices, op_dtype
            )
        else:
            self.blocks = [
                coded[i].to(self.devices[i % len(self.devices)], op_dtype)
                for i in range(n)
            ]
        self.backend = CUDADeviceBackend(
            self._work, n, devices=self.devices, delay_fn=delay_fn,
            batch_fn=self._batch_work if batch else None,
            batch_arrival=batch_arrival,
        )

        # opt-in decode telemetry (instruments resolved once; None =
        # dark, result_device pays one `is None` check)
        self._m = None
        if registry is not None:
            registry.gauge(
                "coded_gemm_n", help="workers n of the MDS code"
            ).set(n)
            registry.gauge(
                "coded_gemm_k", help="recovery threshold k"
            ).set(k)
            self._m = {
                "decodes": registry.counter(
                    "coded_gemm_decodes_total",
                    help="full products decoded",
                ),
                "fresh_k": registry.gauge(
                    "coded_gemm_last_fresh",
                    help="fresh shards available at the last decode",
                ),
                "recovered": [
                    registry.counter(
                        "coded_gemm_worker_recovered_total",
                        help="decodes that consumed this worker's shard",
                        worker=str(i),
                    )
                    for i in range(n)
                ],
            }

    def _work(self, i: int, payload: torch.Tensor, epoch: int):
        return _block_matmul(self.blocks[i], payload, self.precision)

    def _batch_work(self, ids, payload: torch.Tensor, epoch: int):
        """Fused dispatch: the shards of every worker in ``ids`` in one
        stacked product. All ``ids`` share a device."""
        return batch_dispatch(self._group_of, ids, payload, self.precision)

    @property
    def nwait(self):
        """Decodability predicate for ``asyncmap(nwait=...)``."""
        return nwait_decodable(self.k)

    def result_device(
        self, pool: AsyncPool, epoch: int | None = None, tracer=None
    ) -> torch.Tensor:
        """Decode the full product from the first k fresh shards, on the
        first device, read on the current stream: ready to feed the next
        device computation without a host round-trip.

        ``G_S`` is factored on the host and the shards solved where they
        lie (``ops/decode_solve.py``: the CUDA kernel for f32 shards on
        the card, the plain version on the CPU); other dtypes on the
        card stack the shards and solve with ``_decode``. A tracer made
        with ``spans=True`` (``utils.trace.EpochTracer``, as
        ``asyncmap``'s) opens the decode's spans: ``mp.decode.select``,
        then ``mp.decode.factor`` and ``mp.decode.solve`` (on the
        ``_decode`` route ``mp.decode.stack`` and ``_lu_solve``'s)."""
        on = getattr(tracer, "spans", False)
        with annotate_if(on, "mp.decode.select"):
            fresh = pool.fresh_indices(epoch)
            if fresh.size < self.k:
                raise ValueError(
                    f"only {fresh.size} fresh shards at epoch "
                    f"{pool.epoch if epoch is None else epoch}, "
                    f"need k={self.k}"
                )
            idx = fresh[: self.k]
            if self._m is not None:
                self._m["decodes"].inc()
                self._m["fresh_k"].set(fresh.size)
                for i in idx:
                    self._m["recovered"][int(i)].inc()
            results = [pool.results[i] for i in idx]
            dev = self.devices[0]
            # batch-mode fast path: the k winners are lazy views of ONE
            # fused stack — decode straight off it, no per-worker slices
            if all(isinstance(r, StackedSlice) for r in results) and all(
                r.stacked is results[0].stacked for r in results
            ):
                stacked = consume_stack(results[0]).to(dev)
                shards = [stacked[r.index] for r in results]
            else:
                shards = [consume(r).to(dev) for r in results]
        return _solve(shards, lambda: self.code.G[idx],
                      lambda: _rows(self.code.generator(dev), idx), tracer)

    def result(self, pool: AsyncPool, epoch: int | None = None) -> np.ndarray:
        """Decode the full product from the first k fresh shards (host copy)."""
        return self.result_device(pool, epoch).cpu().numpy()

    def coordinator(self, *, delay_fn=None, nwait=None, **kw):
        """A :class:`~..parallel.device_coord.DeviceCoordinator` over
        this workload's coded blocks: ``asyncmap_fused(pool, B, coord,
        epochs=K)`` runs K epochs as one device program (ROADMAP item
        4). ``delay_fn`` is the window's virtual delay schedule (staged
        per window), independent of the backend's real delays."""
        from ..parallel.device_coord import DeviceCoordinator

        return DeviceCoordinator.for_coded_gemm(
            self, delay_fn=delay_fn, nwait=nwait, **kw
        )


class LTCodedGemm:
    """LT/rateless-coded GEMM (BASELINE config 4).

    Each of the n workers takes one rateless shard id; worker i holds the
    real-field sum of its shard's source blocks of ``A`` (device-
    resident). ``nwait`` is the *decodability* predicate: ``asyncmap``
    returns at the first arrival set whose shards peel, not at a fixed
    count. :meth:`result` peels on the host (ops/lt.py);
    :meth:`result_device` solves on the device.
    """

    def __init__(
        self,
        A,
        n_workers: int,
        k: int,
        *,
        devices: Sequence | None = None,
        delay_fn: DelayFn | None = None,
        seed: int = 0,
        dtype=None,
        precision: str = "highest",
        shard_ids: Sequence[int] | None = None,
        systematic: bool = False,
    ):
        A = as_tensor(A, dtype)
        m = A.shape[0]
        if m % k != 0:
            raise ValueError(f"rows {m} must divide evenly into k={k} blocks")
        self.devices = resolve_devices(devices)
        self.code = LTCode(k, seed=seed, systematic=systematic)
        self.k = k
        self.n = n_workers
        self.block_rows = m // k
        self.precision = check_precision(precision)
        if shard_ids is None:
            # rateless: any distinct ids work; slide a window over the
            # unbounded shard stream until the full set peels (so
            # nwait=n is always satisfiable)
            shard_ids = list(range(n_workers))
            for _ in range(1000):
                if self.code.peelable(shard_ids):
                    break
                shard_ids = [s + 1 for s in shard_ids]
            else:
                raise ValueError(
                    f"no decodable window of {n_workers} shards found for "
                    f"k={k}; increase n_workers/k ratio"
                )
        elif not self.code.peelable(shard_ids):
            # otherwise the nwait predicate can never fire and the pool
            # would die deep inside wait_any with an opaque error
            raise ValueError(
                f"shard_ids {list(shard_ids)} are not decodable even with "
                f"all workers fresh (peeling stalls); choose a different set"
            )
        self.shard_ids = list(shard_ids)
        dev = self.devices[0]
        G = self.code.generator_rows(self.shard_ids)  # (n, k) 0/1
        self._G = torch.from_numpy(G).to(dev)  # worker -> generator row
        blocks = A.to(dev).reshape(k, m // k, *A.shape[1:])
        coded = torch.einsum("nk,krc->nrc", self._G.to(blocks.dtype), blocks)
        op_dtype = operand_dtype(A.dtype, self.precision)
        self.blocks = [
            coded[i].to(self.devices[i % len(self.devices)], op_dtype)
            for i in range(n_workers)
        ]
        self.backend = CUDADeviceBackend(
            self._work, n_workers, devices=self.devices, delay_fn=delay_fn
        )

    def _work(self, i: int, payload: torch.Tensor, epoch: int):
        return _block_matmul(self.blocks[i], payload, self.precision)

    @property
    def nwait(self):
        """Variable decodability predicate for ``asyncmap(nwait=...)``."""
        return nwait_lt_decodable(self.code, self.shard_ids)

    def result(self, pool: AsyncPool, epoch: int | None = None) -> np.ndarray:
        """Peel on the host over every fresh shard (the exact LT
        algorithm; gathers each shard to the host)."""
        fresh = pool.fresh_indices(epoch)
        if fresh.size == 0:
            raise ValueError(f"no fresh shards at epoch {pool.epoch}")
        shards = np.stack([_host(pool.results[i]) for i in fresh])
        ids = [self.shard_ids[i] for i in fresh]
        return self.code.decode_array(shards, ids)

    def result_device(
        self, pool: AsyncPool, epoch: int | None = None, tracer=None
    ) -> torch.Tensor:
        """Decode on the device, leaving the product there.

        Peelability of the arrived set implies the 0/1 generator has
        full rank, so the same system solves as one k x k linear solve
        over a full-rank row subset, the MDS decode's math, by the same
        routes as :meth:`CodedGemm.result_device`. ``tracer`` opens the
        decode's spans, as there.
        """
        on = getattr(tracer, "spans", False)
        dev = self.devices[0]
        with annotate_if(on, "mp.decode.select"):
            rows = self.decode_rows(pool, epoch)
            shards = [consume(pool.results[i]).to(dev) for i in rows]
        return _solve(
            shards,
            lambda: self.code.generator_rows(
                [self.shard_ids[i] for i in rows]),
            lambda: _rows(self._G, rows), tracer)

    def decode_rows(self, pool: AsyncPool, epoch: int | None = None) -> list:
        """The k fresh workers whose 0/1 generator rows
        :meth:`result_device` solves with: the first full-rank subset,
        chosen greedily in arrival-mask order."""
        fresh = pool.fresh_indices(epoch)
        ids = [self.shard_ids[i] for i in fresh]
        if not self.code.peelable(ids):
            raise ValueError(
                f"fresh shards {ids} at epoch "
                f"{pool.epoch if epoch is None else epoch} are not decodable"
            )
        G = self.code.generator_rows(ids)  # (m, k) 0/1, full column rank
        sel: list[int] = []
        for r in range(len(ids)):  # greedy full-rank row subset (tiny G)
            if np.linalg.matrix_rank(G[sel + [r]]) == len(sel) + 1:
                sel.append(r)
                if len(sel) == self.k:
                    break
        return [int(fresh[r]) for r in sel]

    def coordinator(self, *, delay_fn=None, nwait=None, **kw):
        """A fused-window coordinator over this LT window: the 0/1
        generator rows of its shard ids, decoded by masked normal
        equations (``nwait`` defaults to n)."""
        from ..parallel.device_coord import DeviceCoordinator

        return DeviceCoordinator.for_lt_gemm(
            self, delay_fn=delay_fn, nwait=nwait, **kw
        )
