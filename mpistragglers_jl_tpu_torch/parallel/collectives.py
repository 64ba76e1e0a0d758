"""Sharded decode and combine collectives over a single-controller mesh.

The port of the JAX package's ``parallel/collectives.py``. Computation
stays per-rank independent (the pool's map step: a straggling rank
delays nobody); aggregation over the winners is where the collectives
belong. In the reference they are ``shard_map`` programs whose traffic
is one ``psum_scatter`` or ``all_gather``. Here each collective is an
explicit loop over the ranks: a rank's slice moves to its destination
rank's device with ``.to(device)``, and the destination reduces what
it receives in rank order 0..n-1, so every run and every placement
gives the same bits. Ranks that share a card still hold separate
tensors; on a host with several cards the moves are peer copies.

The masked combine is data-independent of stragglers: stale shards
enter with weight zero, so the result never depends on their data.

Why a reduce-scatter: the MDS decode ``X = W @ shards`` (W the k x k
inverse padded to n x n with zero rows and columns for stale workers)
is, per output block j, a weighted sum over workers. Each rank computes
its weighted contribution to every output block, and one
reduce-scatter both sums the contributions and leaves output block j
on rank j.

The sharded transformer's collectives (:func:`psum`,
:func:`ring_shift`, :func:`all_to_all`, :func:`all_gather`) run over the groups of one or
more named axes of an N-d mesh (:meth:`.mesh.Mesh.axis_groups`). They
take and return one tensor per flat mesh position (row-major), and are
differentiable: they are built of ``.to``, out-of-place sums, ``split``
and ``cat``, so one ``backward`` over every rank's graph runs their
transposes (a ``psum``'s cotangents summed back to every member, the
shift run backwards, the inverse all-to-all). Each result is a fresh
tensor of its rank: ranks that share a card would otherwise alias
another rank's tensor, which a later in-place update would change. The
one exception is a ``psum`` group of one member, whose result is its
own input.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh, PartitionSpec, ShardedTensor, from_local, shard

__all__ = [
    "all_gather",
    "all_to_all",
    "masked_psum_scatter_combine",
    "mds_decode_weights",
    "distributed_mds_decode",
    "psum",
    "ring_allgather",
    "ring_shift",
]


def mds_decode_weights(code, idx) -> np.ndarray:
    """(n, n) masked decode-weight matrix for an (n, k) MDS code: row j =
    coefficients of output block j over workers, zero column for every
    worker not in ``idx``. The numerically sensitive inversion lives here,
    shared by the bulk-synchronous decode below and the pool-fused decode
    (parallel/fused.py)."""
    idx = np.asarray(idx)
    Winv = np.linalg.inv(code.G[idx])  # tiny k x k host solve
    weights = np.zeros((code.n, code.n), dtype=code.G.dtype)
    weights[: code.k, idx] = Winv
    return weights


def reduce_scatter(parts, devices, fold: int = 1) -> list:
    """``parts[w]`` is rank w's (n, ...) contribution; rank j receives
    rows ``[j*fold, (j+1)*fold)`` of every contribution on its device
    and sums them in rank order."""
    out = []
    for j, dev in enumerate(devices):
        rows = slice(j * fold, (j + 1) * fold)
        acc = parts[0][rows].to(dev, copy=True)
        for w in range(1, len(parts)):
            acc += parts[w][rows].to(dev)
        out.append(acc)
    return out


def all_reduce(parts, devices) -> list:
    """Every rank gets the rank-ordered sum of ``parts``: reduced on rank
    0's device, then copied to each rank's device (the same bits
    everywhere)."""
    acc = parts[0].to(devices[0], copy=True)
    for w in range(1, len(parts)):
        acc += parts[w].to(devices[0])
    return [acc if j == 0 else acc.to(dev, copy=True)
            for j, dev in enumerate(devices)]


def ring_pass(blocks, devices) -> list:
    """The ring all-gather of one block per rank: n-1 steps, each rank
    handing what it last received to rank i+1. Returns, per rank, the
    (n, *block) stack of every rank's block, on that rank's device."""
    n = len(blocks)
    out = []
    for i, dev in enumerate(devices):
        t = torch.empty((n,) + tuple(blocks[i].shape),
                        dtype=blocks[i].dtype, device=dev)
        t[i] = blocks[i]
        out.append(t)
    recv = list(blocks)
    for step in range(1, n):
        recv = [recv[(i - 1) % n].to(devices[i]) for i in range(n)]
        for i in range(n):
            out[i][(i - step) % n] = recv[i]
    return out


def _as_sharded(x, mesh: Mesh, axis: str) -> ShardedTensor:
    if isinstance(x, ShardedTensor):
        return x
    return shard(x, mesh, PartitionSpec(axis))


def per_rank(value, devices) -> list:
    """A replicated operand on every rank's device (a list passes
    through: already one tensor per rank)."""
    if isinstance(value, (list, tuple)):
        return list(value)
    t = value if isinstance(value, torch.Tensor) else torch.as_tensor(
        np.asarray(value))
    cache: dict = {}
    for dev in devices:
        if dev not in cache:
            cache[dev] = t.to(dev)
    return [cache[dev] for dev in devices]


def masked_psum_scatter_combine(mesh: Mesh, axis: str = "w",
                                fold: int = 1):
    """Build the masked weighted-combine over a pool mesh.

    Returns ``combine(shards, weights)`` where ``shards`` is an (n, rows,
    cols) value split along ``axis`` with ``fold`` worker blocks per
    rank (``n = fold * mesh.shape[axis]``; fold=1 is one worker per
    rank; a tensor is split first) and ``weights`` an (n, n) matrix
    (row j = coefficients of output block j over workers; zero column
    for every stale worker), or one copy per rank. Output: (n, rows,
    cols), block j on rank j // fold, still sharded. ``fold > 1`` is the
    folded pool (more workers than mesh ranks, e.g. an (8, 6) pool on
    one card): each rank contributes its local group with one einsum
    and the same reduce-scatter places the output groups.
    """
    devices = mesh.axis_devices(axis)
    fold = int(fold)

    def combine(shards, weights) -> ShardedTensor:
        sh = _as_sharded(shards, mesh, axis)
        ws = per_rank(weights, devices)
        parts = []
        for w, dev in enumerate(devices):
            local = sh.local(w)  # (fold, rows, cols)
            wsel = ws[w][:, w * fold:(w + 1) * fold].to(local.dtype)
            parts.append(torch.einsum("jl,lrc->jrc", wsel, local))
        out = reduce_scatter(parts, devices, fold)
        return from_local(mesh, PartitionSpec(axis), out, sh.shape)

    return combine


def distributed_mds_decode(mesh: Mesh, code, axis: str = "w"):
    """Sharded decode for an (n, k) MDS code (ops/coding.MDSCode).

    Returns ``decode(shards, repochs, epoch)``: given the pool's sharded
    coded results (n, rows, cols) and the arrival mask, computes the
    decode weights host-side (tiny k x k solve on fresh rows of G) and
    runs the masked reduce-scatter combine: source block j lands on rank
    j, ranks j >= k receive zeros.
    """
    combine = masked_psum_scatter_combine(mesh, axis)
    k = code.k

    def decode(shards, repochs, epoch):
        fresh = np.flatnonzero(np.asarray(repochs) == epoch)
        if fresh.size < k:
            raise ValueError(
                f"only {fresh.size} fresh shards, need k={k}"
            )
        return combine(shards, torch.from_numpy(
            mds_decode_weights(code, fresh[:k])))

    return decode


def ring_allgather(mesh: Mesh, axis: str = "w"):
    """Ring all-gather, the building block of ring attention, exposed
    standalone.

    Returns ``gather(x)`` mapping per-rank (rows, cols) blocks (an
    (n, rows, cols) value split along ``axis``) to the full
    (n*rows, cols) array on every rank: the result is (n, n*rows, cols)
    split along ``axis``, moving one block per step around the ring
    (n-1 steps).
    """
    devices = mesh.axis_devices(axis)
    n = len(devices)

    def gather(x) -> ShardedTensor:
        sh = _as_sharded(x, mesh, axis)
        blocks = [sh.local(i)[0] for i in range(n)]
        full = ring_pass(blocks, devices)
        rows = blocks[0].shape[0]
        locals_ = [f.reshape((1, n * rows) + tuple(f.shape[2:]))
                   for f in full]
        return from_local(mesh, PartitionSpec(axis), locals_,
                          (n, n * rows) + tuple(blocks[0].shape[1:]))

    return gather


# --------------------------------------------------------------------------
# collectives over named axes of an N-d mesh (the sharded transformer)
# --------------------------------------------------------------------------


def _per_position(xs, mesh: Mesh) -> list:
    xs = list(xs)
    if len(xs) != mesh.size:
        raise ValueError(
            f"need one tensor per mesh position ({mesh.size}), got {len(xs)}")
    return xs


def psum(xs, mesh: Mesh, axes, *, dtype=None) -> list:
    """``jax.lax.psum`` over ``axes`` (one name or several): every
    member of a group gets the sum of the group's tensors, added in
    rank order on the group's first device (the same bits on every
    member). ``dtype`` accumulates in that type (the result keeps it);
    None adds in the tensors' own type. A group of one member has
    nothing to add and gets its own tensor back (cast to ``dtype``)."""
    xs = _per_position(xs, mesh)
    devs = mesh.devices.flatten()
    out = [None] * len(xs)
    for group in mesh.axis_groups(axes):
        if len(group) == 1:
            out[group[0]] = xs[group[0]].to(dtype=dtype)
            continue
        dev0 = devs[group[0]]
        acc = xs[group[0]].to(dev0, dtype=dtype, copy=True)
        for r in group[1:]:
            acc = acc + xs[r].to(dev0, dtype=dtype)
        out[group[0]] = acc
        for r in group[1:]:
            out[r] = acc.to(devs[r], copy=True)
    return out


def ring_shift(xs, mesh: Mesh, axis: str, *, shift: int = 1) -> list:
    """``jax.lax.ppermute`` with ``perm = [(j, (j + shift) % n)]`` over
    ``axis``: the member at coordinate ``c`` receives the tensor of
    the member at ``(c - shift) % n`` (a copy on its own device). An
    entry may be None, a member with nothing to send (a pipeline's idle
    slot): its receiver gets None and nothing moves."""
    xs = _per_position(xs, mesh)
    devs = mesh.devices.flatten()
    out = [None] * len(xs)
    for group in mesh.axis_groups(axis):
        n = len(group)
        for c, r in enumerate(group):
            src = xs[group[(c - shift) % n]]
            if src is not None:
                out[r] = src.to(devs[r], copy=True)
    return out


def all_gather(xs, mesh: Mesh, axis: str, dim: int) -> list:
    """Tiled ``jax.lax.all_gather`` over ``axis``: every member gets the
    members' tensors concatenated along ``dim`` in coordinate order.
    The backward hands each member's cotangent slice back to its owner,
    where autograd sums them: ``psum_scatter``, JAX's transpose."""
    xs = _per_position(xs, mesh)
    devs = mesh.devices.flatten()
    out = [None] * len(xs)
    for group in mesh.axis_groups(axis):
        for r in group:
            out[r] = torch.cat([xs[m].to(devs[r]) for m in group], dim=dim)
    return out


def all_to_all(xs, mesh: Mesh, axis: str, split_dim: int,
               concat_dim: int) -> list:
    """Tiled ``jax.lax.all_to_all`` over ``axis``: each member splits
    its tensor into n equal chunks along ``split_dim``; member ``j``
    receives chunk ``j`` of every member and concatenates them along
    ``concat_dim`` in the senders' coordinate order."""
    xs = _per_position(xs, mesh)
    devs = mesh.devices.flatten()
    out = [None] * len(xs)
    for group in mesh.axis_groups(axis):
        n = len(group)
        size = xs[group[0]].shape[split_dim]
        if size % n:
            raise ValueError(
                f"dimension {split_dim} of size {size} does not split "
                f"into {n} parts over {axis!r}")
        chunks = [torch.split(xs[r], size // n, dim=split_dim)
                  for r in group]
        for j, r in enumerate(group):
            out[r] = torch.cat([c[j].to(devs[r]) for c in chunks],
                               dim=concat_dim)
    return out
