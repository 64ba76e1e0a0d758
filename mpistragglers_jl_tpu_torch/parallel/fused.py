"""Fused pool and mesh coded GEMM: asyncmap map step, in-place decode.

The port of the JAX package's ``parallel/fused.py``. This is the
integration the two sides of the framework were built for:

* the **async pool** (pool.py over backends/cuda.py) runs the
  straggle-exposed map step: worker i computes on mesh rank i's
  device, on its own CUDA stream, and a slow worker delays nobody;
  ``repochs`` is the arrival mask (the reference's fastest-k contract,
  src/MPIAsyncPools.jl:145-188);
* the **masked reduce-scatter decode** (parallel/collectives.py)
  consumes the pool's *device-resident* results **in place**: the
  per-worker ``pool.results[i]`` tensors, each already on rank i's
  device, are assembled into one :class:`~.mesh.ShardedTensor` with no
  gather onto rank 0 and no host round-trip, and decoded by one
  reduce-scatter.

Contrast with the two unfused paths:

* ``ops/coded_gemm.CodedGemm.result_device`` gathers every fresh shard
  onto one device and solves there;
* ``parallel/mesh_gemm.MeshCodedGemm.epoch`` is sharded but
  bulk-synchronous: its map step runs every rank, so ``repochs`` must
  be synthesized by the caller.

The combine is weight-masked, so the values on stale ranks never affect
the output, but every rank still takes part in the collective.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..backends.base import DelayFn
from ..backends.cuda import (
    CUDADeviceBackend,
    StackedSlice,
    consume,
    consume_stack,
)
from ..ops._batch import (
    as_tensor,
    batch_dispatch,
    build_device_groups,
    check_precision,
    operand_dtype,
)
from ..ops.coding import MDSCode, nwait_decodable
from ..ops.gemm import _block_matmul
from ..ops.matdot import MatDotCode, MatDotWeightCache, _matdot_worker
from ..pool import AsyncPool, asyncmap
from .collectives import (
    all_reduce,
    masked_psum_scatter_combine,
    mds_decode_weights,
    per_rank,
)
from .mesh import Mesh, PartitionSpec, ShardedTensor, from_local
from .mesh_gemm import _np_dtype

__all__ = ["PoolMeshCodedGemm", "PoolMeshMatDotGemm", "select_coded_gemm"]


class _ShardAdopter:
    """Assembly of per-worker device-resident results into the sharded
    (n, *shard) value a decode collective consumes.

    Each ``pool.results[i]`` already lives on worker i's rank, so with
    one worker per rank the assembly adopts the tensors as they are (a
    leading unit axis, no copy). Folded, each rank's group is stacked on
    its own device (one copy there, no cross-rank traffic), or, in batch
    mode, the group's already-stacked product is adopted whole. Stale
    results whose shape or dtype no longer match the current epoch (the
    caller changed B's width) and never-heard workers get a zero
    placeholder; both enter the combine with weight 0. The placeholder
    cache keeps only the latest shape per worker.
    """

    def __init__(self, mesh: Mesh, axis: str, devices: list, fold: int = 1):
        self.mesh = mesh
        self.axis = axis
        self.devices = devices  # per-WORKER device (len n), block layout
        self.n = len(devices)
        self.fold = int(fold)  # workers per rank (1 = adoption)
        self._placeholders: dict[int, tuple] = {}  # i -> (shape, dtype, t)

    def _placeholder(self, i: int, shape, dtype) -> torch.Tensor:
        cached = self._placeholders.get(i)
        if cached is not None and cached[0] == shape and cached[1] == dtype:
            return cached[2]
        ph = torch.zeros(shape, dtype=dtype, device=self.devices[i])
        self._placeholders[i] = (shape, dtype, ph)
        return ph

    def _result(self, pool: AsyncPool, i: int, ref_shape, ref_dtype):
        r = pool.results[i]
        if (
            r is None
            or not isinstance(r, (torch.Tensor, StackedSlice))
            or tuple(r.shape) != tuple(ref_shape)
            or r.dtype != ref_dtype
        ):
            return self._placeholder(i, tuple(ref_shape), ref_dtype)
        return consume(r).to(self.devices[i])

    def _group_stack(self, pool: AsyncPool, dd: int, ref_shape, ref_dtype):
        """One rank's (fold, *shard) block. Fast path: in batch mode the
        map step computed the whole group as ONE stacked product on the
        device, every member a StackedSlice into it in group order, so
        that stack is adopted directly. Otherwise the group is stacked
        device-side."""
        lo = dd * self.fold
        group = [pool.results[lo + l] for l in range(self.fold)]
        first = group[0]
        if (
            isinstance(first, StackedSlice)
            and all(
                isinstance(r, StackedSlice)
                and r.stacked is first.stacked
                and r.index == l
                for l, r in enumerate(group)
            )
            and tuple(first.stacked.shape) == (self.fold,) + tuple(ref_shape)
            and first.stacked.dtype == ref_dtype
        ):
            return consume_stack(first)
        return torch.stack(
            [
                self._result(pool, lo + l, ref_shape, ref_dtype)
                for l in range(self.fold)
            ]
        )

    def assemble(self, pool: AsyncPool, ref_shape, ref_dtype) -> ShardedTensor:
        if self.fold == 1:
            shards = [
                self._result(pool, i, ref_shape, ref_dtype)[None]
                for i in range(self.n)
            ]  # (1, *shard) on rank i: adoption, no copies
        else:
            shards = [
                self._group_stack(pool, dd, ref_shape, ref_dtype)
                for dd in range(self.n // self.fold)
            ]
        return from_local(self.mesh, PartitionSpec(self.axis), shards,
                          (self.n,) + tuple(ref_shape))


class PoolMeshCodedGemm:
    """(n, k) MDS-coded ``C = A @ B``: pool map step, in-place mesh decode.

    >>> mesh = make_mesh(8)
    >>> fg = PoolMeshCodedGemm(A, mesh, k=6)
    >>> pool = AsyncPool(8)
    >>> decoded = fg.epoch(pool, B)     # asyncmap + reduce-scatter decode
    >>> C = fg.full(decoded)            # host gather on demand

    The map step is ``asyncmap`` over a :class:`CUDADeviceBackend` whose
    worker i computes ``Ã_i @ B`` on rank i's device; the decode
    assembles ``pool.results`` into a sharded value *in place* and runs
    the masked reduce-scatter. Output block j lands on rank j.
    """

    def __init__(
        self,
        A,
        mesh: Mesh,
        k: int,
        *,
        axis: str = "w",
        n_workers: int | None = None,
        parity: str = "cauchy",
        precision: str = "highest",
        delay_fn: DelayFn | None = None,
        dtype=None,
        batch: bool = False,
        batch_arrival: str = "ready",
    ):
        """``n_workers`` defaults to the mesh axis size (one worker per
        rank). ``n_workers > mesh size`` FOLDS the pool: contiguous
        groups of ``n/d`` workers share a rank (an (8, 6) pool on a
        one-rank mesh), the adopter stacks each group device-side, and
        the combine reduce-scatters groups (collectives.py ``fold``).

        ``batch=True`` coalesces the workers that share a device into
        ONE stacked product per epoch (ops/_batch.py, as CodedGemm's
        batch mode), and the adopter then adopts an already-stacked
        group whole. ``batch_arrival`` defaults to ``"ready"``: real
        completion order, so ``repochs`` keeps its straggler meaning."""
        A = as_tensor(A, dtype)
        d = mesh.shape[axis]
        n = int(n_workers) if n_workers is not None else d
        if n % d != 0:
            raise ValueError(
                f"n_workers {n} must be a multiple of the mesh axis "
                f"size {d} (whole worker groups per device)"
            )
        fold = n // d
        m = A.shape[0]
        if m % k != 0:
            raise ValueError(f"rows {m} must divide evenly into k={k} blocks")
        self.mesh = mesh
        self.axis = axis
        axis_devs = mesh.axis_devices(axis)
        # blocked worker -> rank map: group g = workers [g*fold, ...)
        self.devices = [axis_devs[i // fold] for i in range(n)]
        self._ranks = axis_devs
        self.fold = fold
        self.code = MDSCode(n, k, parity=parity, dtype=_np_dtype(A))
        self.n, self.k = n, k
        self.block_rows = m // k
        self.precision = check_precision(precision)
        op = operand_dtype(A.dtype, self.precision)
        coded = self.code.encode_array(A.to(self.devices[0]))  # (n, m/k, d)
        self._group_of: dict = {}
        if batch:
            # batch mode: the fused per-device stacks are the only
            # device copy (ops/_batch.py); per-worker blocks stay host
            coded_host = coded.cpu()
            self.blocks = [coded_host[i] for i in range(n)]
            self._group_of = build_device_groups(
                self.blocks, n, self.devices, op
            )
        else:
            # one coded block per worker, on its rank's device
            self.blocks = [
                coded[i].to(self.devices[i], op, copy=True) for i in range(n)
            ]
        del coded
        self.backend = CUDADeviceBackend(
            self._work, n, devices=self.devices, delay_fn=delay_fn,
            batch_fn=self._batch_work if batch else None,
            batch_arrival=batch_arrival,
        )
        self._combine = masked_psum_scatter_combine(mesh, axis, fold=fold)
        self._adopter = _ShardAdopter(mesh, axis, self.devices, fold=fold)
        # steady state re-uses one arrival pattern epoch after epoch:
        # cache the per-rank weight copies per (pattern, dtype), so the
        # hot path pays neither the k x k inverse nor the uploads
        self._weights_cache: dict[tuple, list] = {}

    def _work(self, i: int, payload: torch.Tensor, epoch: int):
        return _block_matmul(self.blocks[i], payload, self.precision)

    def _batch_work(self, ids, payload: torch.Tensor, epoch: int):
        """Fused dispatch: every worker in ``ids`` (one device's group)
        as one stacked product."""
        return batch_dispatch(self._group_of, ids, payload, self.precision)

    @property
    def nwait(self):
        """Decodability predicate for ``asyncmap(nwait=...)``."""
        return nwait_decodable(self.k)

    def _check_pool(self, pool: AsyncPool) -> None:
        if pool.n_workers != self.n:
            raise ValueError(
                f"pool has {pool.n_workers} workers but this workload "
                f"is laid out for {self.n} (n_workers; {self.fold} per "
                "mesh device) — they must match one-to-one"
            )

    def decode_from_pool(
        self, pool: AsyncPool, epoch: int | None = None
    ) -> ShardedTensor:
        """Masked reduce-scatter decode of the pool's device-resident
        results. Returns the decoded (n, m/k, cols) value, block j on
        rank j // fold (blocks j >= k are zeros)."""
        self._check_pool(pool)
        fresh = pool.fresh_indices(epoch)
        if fresh.size < self.k:
            raise ValueError(
                f"only {fresh.size} fresh shards at epoch "
                f"{pool.epoch if epoch is None else epoch}, need k={self.k}"
            )
        idx = fresh[: self.k]
        ref = pool.results[int(idx[0])]
        shards = self._adopter.assemble(pool, tuple(ref.shape), ref.dtype)
        key = (tuple(int(x) for x in idx), str(ref.dtype))
        weights = self._weights_cache.get(key)
        if weights is None:
            W = torch.from_numpy(mds_decode_weights(self.code, idx)).to(
                ref.dtype)
            weights = per_rank(W, self._ranks)
            if len(self._weights_cache) >= 4096:  # C(n,k) patterns: bound
                self._weights_cache.clear()
            self._weights_cache[key] = weights
        return self._combine(shards, weights)

    # -- one fused epoch ---------------------------------------------------
    def epoch(
        self,
        pool: AsyncPool,
        B,
        *,
        nwait=None,
        epoch: int | None = None,
        timeout: float | None = None,
        tracer=None,
    ) -> ShardedTensor:
        """One full fused epoch: ``asyncmap`` map step (fastest-k, real
        arrivals) + in-place masked decode. ``repochs`` comes from the
        pool, never synthesized."""
        self._check_pool(pool)
        if nwait is None:
            nwait = self.nwait
        asyncmap(
            pool, B, self.backend,
            nwait=nwait, epoch=epoch, timeout=timeout, tracer=tracer,
        )
        return self.decode_from_pool(pool)

    def full(self, decoded: ShardedTensor) -> np.ndarray:
        """Host gather of the first k decoded blocks -> (m, cols)."""
        out = np.asarray(decoded)  # (n, m/k, cols)
        return out[: self.k].reshape(-1, out.shape[-1])

    def device_coordinator(self, *, delay_fn=None, nwait=None, **kw):
        """The fully device-resident form of this fused workload: a
        :class:`~.device_coord.DeviceCoordinator` running K epochs of
        map + arrival masking + the masked reduce-scatter decode per
        window over this mesh: the host stages and harvests per window
        instead of driving ``asyncmap`` + :meth:`decode_from_pool` per
        epoch. One worker per mesh rank (``fold == 1``); folded pools
        keep the host loop."""
        if self.fold != 1:
            raise ValueError(
                f"device windows need one worker per mesh device, but "
                f"this workload folds {self.fold} workers per device"
            )
        from .device_coord import DeviceCoordinator

        return DeviceCoordinator(
            torch.stack([as_tensor(b).cpu() for b in self.blocks]),
            decode="mds", G=self.code.G, k=self.k,
            nwait=self.k if nwait is None else nwait,
            mesh=self.mesh, axis=self.axis, delay_fn=delay_fn,
            precision=self.precision, backend=self.backend, **kw,
        )

    def shutdown(self) -> None:
        self.backend.shutdown()


class PoolMeshMatDotGemm:
    """MatDot-coded ``C = A @ B``: pool map step, decode = ONE weighted
    all-reduce over the pool's device-resident evaluations.

    Same fusion as :class:`PoolMeshCodedGemm` but for MatDot codes
    (ops/matdot.py, inner-dimension partitioning, recovery threshold
    2p-1): worker i encodes B̃_i on its own rank from the broadcast B and
    computes ``Ã_i @ B̃_i``; the decode scales each resident evaluation
    by its interpolation weight (0 for stale workers) and one all-reduce
    yields the full product on every rank.
    """

    def __init__(
        self,
        A,
        mesh: Mesh,
        p: int,
        *,
        axis: str = "w",
        precision: str = "highest",
        delay_fn: DelayFn | None = None,
        dtype=None,
    ):
        A = as_tensor(A, dtype)
        n = mesh.shape[axis]
        m, kd = A.shape
        if kd % p != 0:
            raise ValueError(
                f"inner dim {kd} must divide evenly into p={p} blocks"
            )
        self.mesh = mesh
        self.axis = axis
        self.devices = mesh.axis_devices(axis)
        self.code = MatDotCode(p, n, dtype=_np_dtype(A))
        self.p, self.n, self.k = p, n, self.code.k
        self.precision = check_precision(precision)
        blocks = A.reshape(m, p, kd // p).permute(1, 0, 2)
        coded = self.code.encode_A(blocks)  # (n, m, kd/p)
        self.A_evals = [
            coded[i].to(self.devices[i], copy=True) for i in range(n)
        ]
        self.B_weights = [
            torch.from_numpy(self.code.VB[i]).to(self.devices[i])
            for i in range(n)
        ]
        self.backend = CUDADeviceBackend(
            self._work, n, devices=self.devices, delay_fn=delay_fn
        )
        self._adopter = _ShardAdopter(mesh, axis, self.devices)
        self._weights = MatDotWeightCache(self.code)

    def _work(self, i: int, payload: torch.Tensor, epoch: int):
        return _matdot_worker(
            self.A_evals[i], self.B_weights[i], payload, self.p,
            self.precision,
        )

    @property
    def nwait(self):
        """Decodability predicate: 2p-1 fresh evaluations."""
        return nwait_decodable(self.k)

    def _check_pool(self, pool: AsyncPool) -> None:
        if pool.n_workers != self.n:
            raise ValueError(
                f"pool has {pool.n_workers} workers but the mesh pool axis "
                f"has {self.n} devices; they must match one-to-one"
            )

    def decode_from_pool(
        self, pool: AsyncPool, epoch: int | None = None
    ) -> ShardedTensor:
        """One weighted all-reduce over the pool's resident evaluations.
        Returns the full (m, cols) product, replicated over the mesh."""
        self._check_pool(pool)
        fresh = pool.fresh_indices(epoch)
        if fresh.size < self.k:
            raise ValueError(
                f"only {fresh.size} fresh evaluations, need 2p-1={self.k}"
            )
        sel = tuple(int(x) for x in fresh[: self.k])
        w = self._weights.get(sel)
        ref = pool.results[sel[0]]
        ev = self._adopter.assemble(pool, tuple(ref.shape), ref.dtype)
        wC = per_rank(torch.from_numpy(w).to(ref.dtype), self.devices)
        parts = [wC[i][i] * ev.local(i)[0] for i in range(self.n)]
        out = all_reduce(parts, self.devices)
        return from_local(self.mesh, PartitionSpec(), out,
                          tuple(out[0].shape))

    def epoch(
        self,
        pool: AsyncPool,
        B,
        *,
        nwait=None,
        epoch: int | None = None,
        timeout: float | None = None,
        tracer=None,
    ) -> ShardedTensor:
        self._check_pool(pool)
        if nwait is None:
            nwait = self.nwait
        asyncmap(
            pool, B, self.backend,
            nwait=nwait, epoch=epoch, timeout=timeout, tracer=tracer,
        )
        return self.decode_from_pool(pool)

    def shutdown(self) -> None:
        self.backend.shutdown()


class _UnfusedCodedGemm:
    """Adapter giving :class:`~..ops.coded_gemm.CodedGemm` (the
    one-device gather+solve decode) the fused ``epoch()`` surface so
    :func:`select_coded_gemm` can drive either winner identically."""

    fused = False

    def __init__(self, cg):
        self.gemm = cg
        self.backend = cg.backend
        self.k = cg.code.k

    def epoch(self, pool: AsyncPool, B, *, nwait=None, epoch=None):
        asyncmap(pool, B, self.backend,
                 nwait=self.gemm.nwait if nwait is None else nwait,
                 epoch=epoch)
        return self.gemm.result_device(pool)

    def full(self, decoded) -> np.ndarray:
        return decoded.detach().cpu().numpy()

    def shutdown(self) -> None:
        self.backend.shutdown()


def _fence(out) -> None:
    """Wait until ``out`` (a tensor or a sharded value) is computed."""
    parts = (
        [out.local(i) for i in range(out.mesh.size)]
        if isinstance(out, ShardedTensor) else [out]
    )
    for t in parts:
        float(t.float().sum())


def select_coded_gemm(
    A,
    mesh: Mesh,
    k: int,
    B_probe,
    *,
    n_workers: int | None = None,
    probe_epochs: int = 3,
    chains: int = 2,
    **kw,
):
    """Measured fused-vs-unfused selection.

    On a mesh of several cards the fused path's structural win (no
    k-shard gather onto one device) is decisive; on ONE card the two
    paths differ only by dispatch costs. So instead of hardcoding a
    loser, probe both: alternating timed chains of ``probe_epochs``
    epochs, keep the winner, shut the loser down. The decision and both
    measurements ride on ``winner.selection``:

    >>> g = select_coded_gemm(A, mesh, k, B_probe)
    >>> g.selection          # {"picked": ..., "fused_ms": ..., ...}
    >>> decoded = g.epoch(pool, B)

    ``**kw`` (``axis``, ``batch``, ``batch_arrival``, ``precision``,
    ``parity``, ``dtype``) is forwarded to both candidates.
    """
    from ..ops.coded_gemm import CodedGemm
    from ..pool import waitall

    # pop-and-forward: the axis names BOTH the probe's device order and
    # the fused candidate's mesh axis (dropping it here would break every
    # non-default-axis mesh inside PoolMeshCodedGemm)
    axis = kw.pop("axis", "w")
    devices = mesh.axis_devices(axis)
    n = int(n_workers) if n_workers is not None else len(devices)
    fused = PoolMeshCodedGemm(A, mesh, k, n_workers=n, axis=axis, **kw)
    dev_map = [devices[i * len(devices) // n] for i in range(n)]
    unfused = _UnfusedCodedGemm(CodedGemm(A, n, k, devices=dev_map, **kw))

    times = {True: None, False: None}
    pools = {True: AsyncPool(n), False: AsyncPool(n)}
    for g, is_fused in ((fused, True), (unfused, False)):  # warmup
        _fence(g.epoch(pools[is_fused], B_probe))
        waitall(pools[is_fused], g.backend)
    for _ in range(chains):
        for g, is_fused in ((fused, True), (unfused, False)):
            pool = pools[is_fused]
            t0 = time.perf_counter()
            for _ in range(probe_epochs):
                out = g.epoch(pool, B_probe)
                waitall(pool, g.backend)
            _fence(out)
            dt = (time.perf_counter() - t0) / probe_epochs
            prev = times[is_fused]
            times[is_fused] = dt if prev is None else min(prev, dt)
    pick_fused = times[True] <= times[False]
    winner, loser = (fused, unfused) if pick_fused else (unfused, fused)
    loser.shutdown()
    winner.selection = {
        "picked": "fused" if pick_fused else "unfused",
        "fused_ms": round(times[True] * 1e3, 2),
        "unfused_ms": round(times[False] * 1e3, 2),
        "probe_epochs": probe_epochs,
        "chains": chains,
        "mesh_devices": len(devices),
    }
    return winner
