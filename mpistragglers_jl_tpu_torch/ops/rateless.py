"""Genuinely rateless LT-coded GEMM: re-tasks draw *fresh* coded shards.

The port of the JAX package's ``ops/rateless.py``, over
:class:`~..backends.cuda.CUDADeviceBackend` (a worker is a CUDA stream).

:class:`~.coded_gemm.LTCodedGemm` fixes one window of shard ids at
construction — a re-tasked straggler recomputes the same shard, so a
slow epoch gains nothing from extra work. This module supplies the
actual point of a rateless code: **incremental redundancy**. Every
dispatch a worker receives within an epoch advances its private shard
*generation*; the shard id is the deterministic function

    shard_id(worker, generation) = worker + n_workers * generation

so ids never repeat across workers or rounds and the shard stream is
unbounded (the LT property: any prefix of distinct ids is a valid code).
Workers encode their own coded block lazily from the source blocks, on
their device, so a fresh shard costs a few block additions and the usual
matmul, no re-setup.

Arrivals are *accumulated*, not replaced: a worker whose round-1 shard
landed and whose round-2 re-dispatch lands later contributes **two**
shards to the epoch's decode set. The pool machinery carries this
without modification — the decodability ``nwait`` predicate is
re-evaluated after every arrival (reference src/MPIAsyncPools.jl:152-158)
and closes over the epoch's collected-shard set; multi-round draws reuse
the reference's caller-chosen-epoch contract (``asyncmap(...,
epoch=e)`` with the same ``e``: re-dispatching idle workers at an
unchanged epoch is exactly src/MPIAsyncPools.jl:87's "no monotonicity is
enforced", SURVEY §2.1).

On the card a worker's product is enqueued on its stream, and the
backend detects its arrival only after ``work_fn`` returns. The
collected set is read by the predicate and the decode on the
coordinator thread, so ``_work`` waits for its own product (an event on
the worker's stream, waited on in the dispatcher thread, as the
reference blocks on its product) before it records the shard: a shard
in the set is always complete.

Decode is peeling (ops/lt.py), identical to the fixed-window path, run
where the shards lie (the same subtractions in the same order as the
host peel, so the same bits); the only new state is the per-epoch
``(shard_id, shard)`` collection and a ``stats`` record of shards
consumed vs ``k`` (the rateless overhead the benchmark reports).
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from ..backends.base import DelayFn
from ..backends.cuda import CUDADeviceBackend, consume
from ..pool import AsyncPool, DeadWorkerError, asyncmap
from ._batch import as_tensor, check_precision
from .gemm import _block_matmul, resolve_devices
from .lt import LTCode, sum_support

__all__ = ["RatelessLTGemm"]


def _to_device(x: np.ndarray, dev) -> torch.Tensor:
    """A device copy of a host array (the one upload a classic stream's
    source stack costs)."""
    return torch.from_numpy(x).to(dev, copy=True)


class RatelessLTGemm:
    """Rateless LT-coded ``C = A @ B`` with incremental redundancy.

    >>> rg = RatelessLTGemm(A, n_workers=8, k=6)    # on the card
    >>> pool = AsyncPool(8)
    >>> C = rg.multiply(B, pool)      # draws shards until the set peels
    >>> rg.stats["shards_used"]       # rateless overhead vs k

    ``multiply`` runs rounds: each round dispatches one fresh shard per
    idle worker and waits up to ``round_timeout`` for the collected set
    to become peelable; workers still busy with an earlier shard are
    left in flight (their eventual stale arrival is harvested and
    re-tasked with a *new* shard id by the pool's phase-1/phase-3
    machinery). A permanent straggler therefore costs one round of
    timeout, not decodability.
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
        block_cache_size: int = 64,
        systematic: bool = True,
    ):
        """``systematic=True`` (default): the generation-0 window's
        first k shards ARE the source blocks, so a straggler-free epoch
        peels from k arrivals and a straggler costs only the draws
        until its missing block is covered. Set False for the classic
        all-soliton stream. ``A`` is numpy or a tensor (copied to the
        host once: generation 0 encodes there)."""
        A = as_tensor(A, dtype)
        A = (A.cpu() if A.is_cuda else A).numpy()
        m = A.shape[0]
        if m % k != 0:
            raise ValueError(f"rows {m} must divide evenly into k={k} blocks")
        self.devices = resolve_devices(devices)
        self.code = LTCode(k, seed=seed, systematic=systematic)
        self.k = int(k)
        self.n = int(n_workers)
        self.block_rows = m // k
        self.precision = check_precision(precision)
        # generation 0 is host-encoded at setup (below); the device copy
        # of the source blocks is made LAZILY on the first
        # fresh-generation draw, so a straggler-free run pays no extra
        # device memory and fresh shards thereafter encode on the device
        self._src = np.ascontiguousarray(A.reshape(k, m // k, *A.shape[1:]))
        self._src_dev: dict = {}
        self._block_cache: dict[int, torch.Tensor] = {}
        self._block_cache_size = int(block_cache_size)
        self._gen: dict[tuple[int, int], int] = {}  # (epoch, worker) -> gen
        # per-epoch collected shards: {shard_id: device tensor}; added by
        # dispatcher threads once the product is complete, read by the
        # nwait predicate and the decoder on the coordinator thread
        self._collected: dict[int, dict[int, torch.Tensor]] = {}
        # epoch whose shards _work may retain; None until the first
        # multiply() (direct Backend-API users collect every epoch)
        self._live_epoch: int | None = None
        # epoch -> the shard-id set the nwait predicate fired on
        self._satisfied: dict[int, list[int]] = {}
        self._lock = threading.Lock()
        self.stats: dict = {}
        # generation 0 = the static window [0, n): pre-encode on device
        for i in range(self.n):
            self._coded_block(i, i)
        self.backend = CUDADeviceBackend(
            self._work, self.n, devices=self.devices, delay_fn=delay_fn
        )

    # -- shard plumbing ---------------------------------------------------
    def shard_id(self, worker: int, generation: int) -> int:
        """Deterministic unbounded shard stream, distinct across workers
        and rounds."""
        return int(worker) + self.n * int(generation)

    def _coded_block(self, worker: int, sid: int) -> torch.Tensor:
        """The device-resident coded block Ã_sid = Σ (support blocks),
        encoded lazily and cached (bounded).

        Generation 0 (``sid < n``, the setup window) encodes on the host
        and uploads once — no device source copy for straggler-free
        runs. Fresh generations encode on the worker's device, on its
        stream, from the lazily-built source stack. The encode runs
        outside the lock; a racing duplicate encode is benign.
        """
        with self._lock:
            blk = self._block_cache.get(sid)
            if blk is not None:
                return blk
        dev = self.devices[worker % len(self.devices)]
        sup = self.code.shard_indices(sid)
        if sid < self.n:
            blk = _to_device(sum_support(self._src, sup), dev)
        else:
            blk = sum_support(self._device_src(dev), sup)
        with self._lock:
            if len(self._block_cache) >= self._block_cache_size:
                # keep generation 0 (the steady-state window) resident
                for key in [s for s in self._block_cache if s >= self.n]:
                    del self._block_cache[key]
            return self._block_cache.setdefault(sid, blk)

    def _device_src(self, dev) -> torch.Tensor:
        """Device-resident (k, rows, cols) source stack, created ONCE
        per device — single-flight: the first thread builds, the rest
        wait on an Event, so a round of fresh-generation draws pays one
        build, not one per dispatcher thread. A systematic stream's
        generation-0 identity blocks ARE the source blocks and already
        lie on the card, so its stack is a device-side copy. A failed
        build is dropped before the waiters are released, so a later
        call retries."""
        with self._lock:
            entry = self._src_dev.get(dev)
            owner = entry is None
            if owner:
                entry = {"ready": threading.Event(), "src": None}
                self._src_dev[dev] = entry
        if not owner:
            entry["ready"].wait()
            src = entry["src"]
            if src is None:
                raise RuntimeError("device source construction failed")
            return src
        try:
            if self.code.systematic:
                with self._lock:
                    cached = [
                        self._block_cache.get(s) for s in range(self.k)
                    ]
                parts = [
                    _to_device(self._src[s], dev) if c is None  # n < k
                    else c.to(dev)
                    for s, c in enumerate(cached)
                ]
                src = torch.stack(parts)
            else:
                src = _to_device(self._src, dev)
            if src.is_cuda:
                # complete before any other stream reads it
                torch.cuda.current_stream(dev).synchronize()
            entry["src"] = src
            return src
        finally:
            if entry["src"] is None:
                with self._lock:
                    if self._src_dev.get(dev) is entry:
                        del self._src_dev[dev]
            entry["ready"].set()

    def prefetch_source(self) -> None:
        """Build the per-device source stacks up front (benches and
        latency-sensitive callers warm them here, off the clock)."""
        for dev in dict.fromkeys(self.devices[: self.n]):
            self._device_src(dev)

    def _work(self, i: int, payload: torch.Tensor, epoch: int):
        """Worker compute: advance this worker's generation, encode the
        fresh shard's block, multiply, and wait for the product before
        the shard joins the epoch's collected set. Runs in the backend's
        dispatcher thread under the worker's stream."""
        with self._lock:
            gen = self._gen.get((epoch, i), 0)
            self._gen[(epoch, i)] = gen + 1
        sid = self.shard_id(i, gen)
        out = _block_matmul(self._coded_block(i, sid), payload,
                            self.precision)
        if out.is_cuda:
            # the reference's block_until_ready: a blocking-sync event's
            # wait releases the GIL while this stream finishes
            done = torch.cuda.Event(blocking=True)
            done.record()
            done.synchronize()
        with self._lock:
            # only the live epoch accumulates: a straggler still in
            # flight from a pruned epoch must not re-create its dict
            # (it would never be pruned again and would pin the shard
            # in device memory). The shard is still returned so the
            # pool's stale-arrival bookkeeping stays intact.
            if self._live_epoch is None or epoch == self._live_epoch:
                self._collected.setdefault(epoch, {})[sid] = out
        return sid, out

    # -- decode-side ------------------------------------------------------
    def collected_ids(self, epoch: int) -> list[int]:
        with self._lock:
            return sorted(self._collected.get(epoch, {}))

    def decodable(self, epoch: int) -> bool:
        return self.code.peelable(self.collected_ids(epoch))

    def nwait(self, epoch: int):
        """Decodability predicate over the epoch's *collected* shard set
        (not just the latest per-worker result): re-evaluated after
        every arrival, reference src/MPIAsyncPools.jl:152-158. When it
        fires it snapshots the satisfying shard set, so the decode (and
        the overhead statistic) use exactly the prefix that peeled, not
        the shards that landed after."""

        def pred(ep: int, repochs: np.ndarray) -> bool:
            ids = self.collected_ids(epoch)
            if self.code.peelable(ids):
                with self._lock:
                    self._satisfied.setdefault(epoch, ids)
                return True
            return False

        return pred

    def multiply(
        self,
        B,
        pool: AsyncPool,
        *,
        round_timeout: float = 5.0,
        max_rounds: int = 8,
    ) -> torch.Tensor:
        """``A @ B`` on the first device, drawing coded shards until the
        set peels (the reference returns a host array; this returns the
        device tensor, read on the current stream).

        Round r re-enters ``asyncmap`` at the *same* epoch: idle workers
        (everyone who already delivered) are re-dispatched and — because
        their generation advanced — compute shards never seen before.
        Workers still in flight are untouched. Raises
        :class:`~..pool.DeadWorkerError` only if ``max_rounds`` rounds
        all time out (every worker dead)."""
        epoch = pool.epoch + 1
        with self._lock:
            # prune: only the live epoch's shards are retained, and
            # _work drops late arrivals from any other epoch from here on
            self._live_epoch = epoch
            self._collected = {epoch: {}}
            self._satisfied = {}
            self._gen = {k_: v for k_, v in self._gen.items()
                         if k_[0] == epoch}
        pred = self.nwait(epoch)
        last_err: DeadWorkerError | None = None
        for _ in range(max_rounds):
            try:
                asyncmap(
                    pool, B, self.backend,
                    nwait=pred, epoch=epoch, timeout=round_timeout,
                )
                last_err = None
                break
            except DeadWorkerError as e:
                # round timed out short of decodability: the next round
                # re-dispatches every idle worker with a fresh shard id
                # (incremental redundancy); stragglers stay in flight
                last_err = e
                if self.decodable(epoch):  # arrived during unwinding
                    # snapshot like pred does, so the overhead statistic
                    # is the draw-until-peel value
                    with self._lock:
                        self._satisfied.setdefault(
                            epoch, sorted(self._collected.get(epoch, {}))
                        )
                    last_err = None
                    break
        if last_err is not None:
            raise last_err
        return self._decode(epoch)

    def _decode(self, epoch: int) -> torch.Tensor:
        with self._lock:
            shards_map = dict(self._collected.get(epoch, {}))
            satisfied = self._satisfied.get(epoch)
        # decode exactly the prefix the predicate fired on (see nwait);
        # direct Backend-API users without a predicate fall back to
        # everything collected
        ids = (
            [s for s in satisfied if s in shards_map]
            if satisfied is not None
            else sorted(shards_map)
        )
        dev = self.devices[0]
        shards = [consume(shards_map[s]).to(dev) for s in ids]
        blocks = self.code.decode(shards, ids)
        self.stats = {
            "epoch": int(epoch),
            "shards_used": len(ids),
            "k": self.k,
            "overhead": len(ids) / self.k,
            "max_generation": max(s // self.n for s in ids) if ids else 0,
        }
        return blocks.reshape(-1, *blocks.shape[2:])
