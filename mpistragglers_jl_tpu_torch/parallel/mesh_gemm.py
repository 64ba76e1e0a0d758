"""Mesh-collective coded GEMM: both steps as per-rank programs.

The port of the JAX package's ``parallel/mesh_gemm.py``. Complement to
ops/coded_gemm.CodedGemm (which runs the map step through the
asynchronous pool and decodes on one device). Here both steps run over
a ``("w",)`` mesh:

* **map**: rank w computes ``Ã_w @ B`` with no cross-rank traffic (the
  straggler-exposed step stays embarrassingly parallel);
* **decode**: the masked reduce-scatter combine
  (parallel/collectives.py): stale workers enter with weight zero, one
  collective places source block j on rank j.

Output stays sharded; ``full()`` gathers to the host only on demand.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops._batch import as_tensor, check_precision, matmul
from ..ops.coding import MDSCode
from ..ops.matdot import MatDotCode, MatDotWeightCache, _matdot_worker
from .collectives import all_reduce, distributed_mds_decode, per_rank
from .mesh import Mesh, PartitionSpec, ShardedTensor, from_local, shard

__all__ = ["MeshCodedGemm", "MeshMatDotGemm"]


def _np_dtype(t: torch.Tensor):
    return torch.empty(0, dtype=t.dtype).numpy().dtype


class MeshCodedGemm:
    """(n, k) MDS-coded ``C = A @ B`` as per-rank programs.

    >>> mesh = make_mesh(8)
    >>> mg = MeshCodedGemm(A, mesh, k=6)
    >>> C_sharded = mg.epoch(B, repochs, epoch)   # blocks j<k on rank j
    >>> C = mg.full(C_sharded)                    # host gather
    """

    def __init__(
        self,
        A,
        mesh: Mesh,
        k: int,
        *,
        axis: str = "w",
        parity: str = "cauchy",
        precision: str = "highest",
    ):
        A = as_tensor(A)
        n = mesh.shape[axis]
        m = A.shape[0]
        if m % k != 0:
            raise ValueError(f"rows {m} must divide evenly into k={k} blocks")
        self.mesh = mesh
        self.axis = axis
        self.devices = mesh.axis_devices(axis)
        self.code = MDSCode(n, k, parity=parity, dtype=_np_dtype(A))
        self.n, self.k = n, k
        self.block_rows = m // k
        self.precision = check_precision(precision)
        coded = self.code.encode_array(A)  # (n, m/k, d)
        self.blocks = shard(coded, mesh, PartitionSpec(axis))  # w on rank w
        self._decode = distributed_mds_decode(mesh, self.code, axis)

    def map_step(self, B) -> ShardedTensor:
        """Per-rank coded shard products (n, m/k, cols), sharded."""
        Bs = per_rank(as_tensor(B), self.devices)
        out = [matmul(self.blocks.local(w)[0], Bs[w], self.precision)[None]
               for w in range(self.n)]
        return from_local(self.mesh, PartitionSpec(self.axis), out,
                          (self.n, self.block_rows, out[0].shape[-1]))

    def epoch(self, B, repochs=None, epoch: int = 0) -> ShardedTensor:
        """One full coded epoch: map + masked decode. ``repochs``/``epoch``
        select the fresh shards (default: all fresh)."""
        shards = self.map_step(B)
        if repochs is None:
            repochs = np.full(self.n, epoch)
        return self._decode(shards, repochs, epoch)

    def full(self, decoded: ShardedTensor) -> np.ndarray:
        """Host gather of the first k decoded blocks -> (m, cols)."""
        out = np.asarray(decoded)  # (n, m/k, cols)
        return out[: self.k].reshape(-1, out.shape[-1])


class MeshMatDotGemm:
    """MatDot-coded ``C = A @ B`` as per-rank programs: the decode is ONE
    weighted all-reduce over the mesh axis.

    MatDot's linear-functional decode (``C = Σ_i w_i C̃_i``, see
    ops/matdot.py) is the best-case shape for a collective: each rank
    scales its local evaluation by its decode weight and one sum over
    the axis yields the full product; stale ranks contribute with weight
    0, exactly like the masked MDS combine.

    * **map**: rank i computes ``Ã_i @ B̃_i`` with its resident A
      evaluation and a B̃ encoded on its device from the replicated B;
    * **decode**: weights from the host-side 2p-1 x 2p-1 solve (float64,
      cached per arrival pattern), then ``Σ w_i * C̃_i`` in rank order.

    >>> mg = MeshMatDotGemm(A, mesh, p=2)
    >>> C = mg.epoch(B, repochs, epoch)      # (m, cols), replicated
    """

    def __init__(
        self,
        A,
        mesh: Mesh,
        p: int,
        *,
        axis: str = "w",
        precision: str = "highest",
    ):
        A = as_tensor(A)
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
        self.A_evals = shard(coded, mesh, PartitionSpec(axis))
        self.B_weights = shard(torch.from_numpy(self.code.VB), mesh,
                               PartitionSpec(axis))  # row i on rank i
        self._weights = MatDotWeightCache(self.code)

    def decode_weights(self, repochs, epoch: int) -> np.ndarray:
        """Per-rank combine weights from the arrival mask: the first
        2p-1 fresh ranks carry the interpolation weights, everyone
        else 0."""
        fresh = np.flatnonzero(np.asarray(repochs) == epoch)
        if fresh.size < self.k:
            raise ValueError(
                f"only {fresh.size} fresh shards, need 2p-1={self.k}"
            )
        return self._weights.get(fresh[: self.k])

    def epoch(self, B, repochs=None, epoch: int = 0) -> ShardedTensor:
        """One coded epoch: per-rank B encode + local matmul + one
        weighted all-reduce. Returns the full (m, cols) product,
        replicated."""
        if repochs is None:
            repochs = np.full(self.n, epoch)
        w = self.decode_weights(repochs, epoch)
        B = as_tensor(B)
        Bs = per_rank(B, self.devices)
        wC = per_rank(torch.from_numpy(w).to(B.dtype), self.devices)
        parts = []
        for i in range(self.n):
            Ct = _matdot_worker(self.A_evals.local(i)[0],
                                self.B_weights.local(i)[0], Bs[i], self.p,
                                self.precision)
            parts.append(wC[i][i] * Ct)
        out = all_reduce(parts, self.devices)
        return from_local(self.mesh, PartitionSpec(), out,
                          tuple(out[0].shape))
