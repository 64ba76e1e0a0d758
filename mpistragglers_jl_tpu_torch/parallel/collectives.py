"""Sharded decode and combine collectives over a mesh.

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

**Across processes.** Over a mesh that spans processes
(:func:`.multihost.make_multihost_mesh`) every collective takes and
returns this process's list, one tensor per position of
:meth:`.mesh.Mesh.local_ranks`. A group whose members are all local
runs as above. A group that spans processes moves its members' tensors
over a ``torch.distributed`` subgroup of the processes that hold them
(made once per mesh and axes, in group order, on every process, since
``new_group`` is collective over the whole job): every process gathers
the group's tensors as bytes (through host memory under ``gloo``, on
the card under ``nccl``) and computes its members' results from them as
the single-controller loop does, sums in rank order 0..n-1 included,
so a run over processes gives the bits of the single-controller program
on the same mesh shape. All of one call's groups that span processes
form one ``torch.autograd.Function``, whose backward is JAX's
transpose (a ``psum``'s cotangents ``psum``-ed back to every member,
each ``all_gather`` slice summed back to its owner, the inverse
``all_to_all``, the shift run backwards): every process enters the
same backward collectives in the same order. A backward whose loss
does not reach every such node on every process (a pipeline's idle
stage) runs inside :func:`crossing_chain`, which orders them. The
members of such a
group share one shape and dtype, and each process holds as many of
them as every other. :func:`agree` holds inputs that every process
passes equal across the processes, by one exchange of their digests.
:data:`EXCHANGES` counts the gathers, their bytes and seconds;
:func:`exchanges_dropped` is the control that skips them.
"""

from __future__ import annotations

import contextlib
import hashlib
import time
from functools import partial

import numpy as np
import torch

from .mesh import (
    Mesh,
    PartitionSpec,
    ShardedTensor,
    _dist,
    from_bytes,
    from_local,
    shard,
    to_bytes,
)

__all__ = [
    "EXCHANGES",
    "agree",
    "all_gather",
    "all_to_all",
    "crossing_chain",
    "digest",
    "exchanges_dropped",
    "masked_psum_scatter_combine",
    "mds_decode_weights",
    "distributed_mds_decode",
    "psum",
    "ring_allgather",
    "ring_shift",
    "zero_exchanges",
]

# Per process, since the last zero_exchanges(): the exchanges across
# processes that ran (one per group that spans processes and holds a
# member of this one), the bytes this process put in them (its members'
# tensors, sent once to each other process of the group), and their
# seconds on the host clock (the copy to the host included under gloo;
# under nccl the host only enqueues).
EXCHANGES = {"calls": 0, "bytes": 0, "seconds": 0.0}
_dropped = False


def zero_exchanges() -> None:
    EXCHANGES.update(calls=0, bytes=0, seconds=0.0)


@contextlib.contextmanager
def exchanges_dropped():
    """A control: inside, no exchange across processes runs and each
    hands back zeros for the members of other processes (their bytes
    never arrive), so a result that does not move has not used them.
    Counts nothing in :data:`EXCHANGES`."""
    global _dropped
    _dropped = True
    try:
        yield
    finally:
        _dropped = False


@contextlib.contextmanager
def crossing_chain(mesh: Mesh):
    """Inside, every collective call over ``mesh`` that crosses
    processes under grad also takes and returns a token, a 0-d tensor
    that requires grad: the calls form one chain per process, in the
    order the forward made them. Yields the list ``[start, end]`` of the
    chain. A backward
    seeded at the end as well as at the losses, and asked for the
    start's gradient as well as the parameters', runs every crossing
    node, even one whose outputs the loss does not reach on this process
    (a pipeline stage that gets nothing at a tick), and runs each node's
    backward after the one made after it: so every process enters the
    backward exchanges in one order. The values are unchanged."""
    start = torch.zeros((), requires_grad=True)
    mesh._chain = [start, start]
    try:
        yield mesh._chain
    finally:
        mesh._chain = None


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


def over_pool(op, xs, mesh: Mesh, axis: str = "w", **kw) -> list:
    """Run the rank-list collective ``op`` (:func:`reduce_scatter`,
    :func:`all_reduce` or :func:`ring_pass`) over the 1-D ``(axis,)``
    pool mesh: ``xs`` holds one tensor per rank this process drives, in
    :meth:`.mesh.Mesh.local_ranks` order, and so does the result. Across
    processes the members' tensors are gathered first
    (:func:`_exchange`), and each local member's result is computed from
    them as the single-controller loop computes it: the same bits."""
    devices = mesh.local_axis_devices(axis)
    if not mesh.spans_processes:
        return op(xs, devices, **kw)
    devs = mesh.devices.flatten()
    out = []
    for group, pg, mine, local in _per_group(
            mesh, _cross_groups(mesh, axis), xs):
        every = _exchange(mesh, group, pg, local)
        if op is all_reduce:
            out += all_reduce(every, [devs[r] for r in mine])
        elif op is reduce_scatter:
            fold = kw.get("fold", 1)
            for r in mine:
                j = group.index(r)
                out += reduce_scatter(
                    [t[j * fold:(j + 1) * fold] for t in every], [devs[r]],
                    fold)
        elif op is ring_pass:
            out += [torch.stack([b.to(devs[r]) for b in every])
                    for r in mine]
        else:
            raise ValueError(f"no pool collective {op!r}")
    return out


_FAULT_BYTES = 512  # room for one guard's message in agree()'s record


def digest(*values) -> bytes:
    """A sha256 over ``values``: a tensor or array by its dtype, shape
    and bytes (a card's copied to the host), anything else by its
    ``repr``."""
    h = hashlib.sha256()
    for v in values:
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if isinstance(v, torch.Tensor):
            t = v.detach().contiguous()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).cpu().numpy())
        else:
            h.update(repr(v).encode())
    return h.digest()


def agree(mesh: Mesh, axis: str, digests: dict, fault: str = "") -> None:
    """Hold this process's inputs to every other's over the 1-D
    ``(axis,)`` pool mesh, as JAX's ``device_put`` of a host value to a
    sharding that spans processes holds them
    (``multihost_utils.assert_equal``): one exchange of their
    :func:`digest` s (``digests``: name -> digest, the same names in the
    same order on every process) and of ``fault``, the message of a
    guard this process tripped on its own state ("" for none). Raises
    ValueError on every process together when a process reports a fault
    or a named input differs, so no process is left waiting in a later
    exchange. On a mesh of this process's alone, or inside
    :func:`exchanges_dropped`, nothing is exchanged and only ``fault``
    raises."""
    if not mesh.spans_processes or _dropped:
        if fault:
            raise ValueError(fault)
        return
    ((group, pg),) = _cross_groups(mesh, axis)
    procs = _owners(mesh, group)
    note = fault.encode()[:_FAULT_BYTES].ljust(_FAULT_BYTES, b"\0")
    rec = torch.frombuffer(bytearray(b"".join(digests.values()) + note),
                           dtype=torch.uint8)
    t0 = time.perf_counter()
    payload = to_bytes(rec.to(mesh.local_devices()[0]), mesh.backend)
    bufs = [torch.empty_like(payload) for _ in procs]
    _dist().all_gather(bufs, payload, group=pg)
    recs = [bytes(b.cpu().numpy()) for b in bufs]
    EXCHANGES["calls"] += 1
    EXCHANGES["bytes"] += payload.numel()
    EXCHANGES["seconds"] += time.perf_counter() - t0
    faults = [(p, r[-_FAULT_BYTES:].rstrip(b"\0").decode(errors="replace"))
              for p, r in zip(procs, recs) if r[-_FAULT_BYTES:].strip(b"\0")]
    if faults:
        raise ValueError("refused on every process: " + "; ".join(
            f"process {p}: {m}" for p, m in faults))
    differ, at = [], 0
    for name, d in digests.items():
        if len({r[at:at + len(d)] for r in recs}) > 1:
            differ.append(name)
        at += len(d)
    if differ:
        raise ValueError(
            f"processes {list(procs)} pass different values of "
            f"{', '.join(differ)}: every process must pass the same value, "
            "as every JAX process passes the same host value to a sharding "
            "across processes")


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
    devices = mesh.local_axis_devices(axis)
    ranks = mesh.local_ranks()
    fold = int(fold)

    def combine(shards, weights) -> ShardedTensor:
        sh = _as_sharded(shards, mesh, axis)
        ws = per_rank(weights, devices)
        parts = []
        for i, w in enumerate(ranks):
            local = sh.local(w)  # (fold, rows, cols)
            wsel = ws[i][:, w * fold:(w + 1) * fold].to(local.dtype)
            parts.append(torch.einsum("jl,lrc->jrc", wsel, local))
        out = over_pool(reduce_scatter, parts, mesh, axis, fold=fold)
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
    mesh.local_axis_devices(axis)  # a 1-D (axis,) mesh of this job
    n = mesh.shape[axis]

    def gather(x) -> ShardedTensor:
        sh = _as_sharded(x, mesh, axis)
        blocks = [t[0] for t in sh.locals()]
        full = over_pool(ring_pass, blocks, mesh, axis)
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
    n = len(mesh.local_ranks())
    if len(xs) != n:
        raise ValueError(
            f"need one tensor per mesh position this process drives ({n}), "
            f"got {len(xs)}")
    return xs


def _owners(mesh: Mesh, group) -> tuple:
    """The processes that drive ``group``'s members, ascending."""
    return tuple(sorted({int(mesh.process_index.flat[r]) for r in group}))


def _cross_groups(mesh: Mesh, axes) -> list:
    """The groups over ``axes`` whose members span processes, each with
    the ``torch.distributed`` group of those processes (None: the whole
    job). Made on first use, for every such group in group order on
    every process (``new_group`` is collective over the job, members or
    not), and cached on the mesh."""
    if not mesh.spans_processes:
        return []
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if axes not in mesh._cross:
        dist = _dist()
        job = tuple(range(dist.get_world_size()))
        out = []
        for group in mesh.axis_groups(axes):
            procs = _owners(mesh, group)
            if len(procs) < 2:
                continue
            if procs not in mesh._pgroups:
                mesh._pgroups[procs] = (None if procs == job
                                        else dist.new_group(list(procs)))
            out.append((group, mesh._pgroups[procs]))
        mesh._cross[axes] = out
    return mesh._cross[axes]


def _per_group(mesh: Mesh, cross, ts):
    """Walk the groups of :func:`_cross_groups` that hold positions of
    this process, with this process's tensors ``ts`` (their members'
    tensors, group after group): yields (group, process group, the
    local members' ranks, their tensors)."""
    at = set(mesh.local_ranks())
    it = iter(ts)
    for group, pg in cross:
        mine = [r for r in group if r in at]
        if mine:
            yield group, pg, mine, [next(it) for _ in mine]


def _exchange(mesh: Mesh, group, pg, local) -> list:
    """Every member's tensor of ``group``, in group order, from this
    process's members' tensors ``local``: one all-gather of their bytes
    over ``pg``. The local members' entries are their own tensors; the
    others arrive on the host (``gloo``) or on this process's card
    (``nccl``)."""
    owners = mesh.process_index.flatten()
    procs = _owners(mesh, group)
    held = [[r for r in group if owners[r] == p] for p in procs]
    if len({len(h) for h in held}) != 1:
        raise ValueError(
            f"the processes {list(procs)} hold {[len(h) for h in held]} "
            f"members of a group over the mesh's axes: a collective across "
            "processes needs as many on each")
    like = local[0]
    me = int(_dist().get_rank())
    if _dropped:
        got = dict(zip(held[procs.index(me)], local))
        return [got[r] if r in got else torch.zeros_like(like)
                for r in group]
    t0 = time.perf_counter()
    payload = torch.cat([to_bytes(t, mesh.backend) for t in local])
    bufs = [torch.empty_like(payload) for _ in procs]
    _dist().all_gather(bufs, payload, group=pg)
    got = {}
    for p, ranks, buf in zip(procs, held, bufs):
        if p == me:
            got.update(zip(ranks, local))
            continue
        for r, part in zip(ranks, buf.chunk(len(ranks))):
            got[r] = from_bytes(part, like.dtype, like.shape)
    EXCHANGES["calls"] += 1
    EXCHANGES["bytes"] += payload.numel()
    EXCHANGES["seconds"] += time.perf_counter() - t0
    return [got[r] for r in group]


class _Crossing(torch.autograd.Function):
    """One collective call's groups that span processes, as one autograd
    node: ``fwd`` maps this process's members' tensors to their results,
    ``bwd`` their cotangents to the inputs' (the transpose). Every
    process enters both, in the same order as every other. ``tok`` is
    the :func:`crossing_chain` token (None outside a chain): the node
    returns the chain's next one first."""

    @staticmethod
    def forward(ctx, fwd, bwd, tok, *xs):
        ctx.bwd, ctx.chained = bwd, tok is not None
        nxt = torch.zeros(()) if ctx.chained else None
        return (nxt, *fwd(list(xs)))

    @staticmethod
    def backward(ctx, gtok, *gs):
        return (None, None, torch.zeros(()) if ctx.chained else None,
                *ctx.bwd(list(gs)))


def _collective(xs, mesh: Mesh, axes, local_fn, fwd, bwd) -> list:
    """Run one collective over ``axes``: ``local_fn(group, at, out)``
    fills ``out`` for each group wholly on this process (``at`` maps a
    flat rank to its place in the local list); the groups that span
    processes run through ``fwd``/``bwd`` (:class:`_Crossing`) on their
    local members' tensors, given with the cross groups as
    ``fwd(cross, ts)``."""
    at = {r: i for i, r in enumerate(mesh.local_ranks())}
    cross = _cross_groups(mesh, axes)
    spanning = {r for group, _ in cross for r in group}
    out = [None] * len(xs)
    for group in mesh.axis_groups(axes):
        if group[0] not in spanning and group[0] in at:
            local_fn(group, at, out)
    ranks = [r for group, _ in cross for r in group if r in at]
    if ranks:
        chain = mesh._chain if torch.is_grad_enabled() else None
        nxt, *res = _Crossing.apply(
            partial(fwd, cross), partial(bwd, cross),
            None if chain is None else chain[1],
            *[xs[at[r]] for r in ranks])
        if chain is not None:
            chain[1] = nxt
        for r, t in zip(ranks, res):
            out[at[r]] = t
    return out


def _psum_cross(mesh, cross, ts, dtype=None) -> list:
    devs = mesh.devices.flatten()
    out = []
    for group, pg, mine, local in _per_group(mesh, cross, ts):
        every = _exchange(mesh, group, pg, local)
        dev0 = devs[mine[0]]
        acc = every[0].to(dev0, dtype=dtype, copy=True)
        for t in every[1:]:
            acc = acc + t.to(dev0, dtype=dtype)
        out += [acc] + [acc.to(devs[r], copy=True) for r in mine[1:]]
    return out


def psum(xs, mesh: Mesh, axes, *, dtype=None) -> list:
    """``jax.lax.psum`` over ``axes`` (one name or several): every
    member of a group gets the sum of the group's tensors, added in
    rank order on the group's first device (the same bits on every
    member). ``dtype`` accumulates in that type (the result keeps it);
    None adds in the tensors' own type. A group of one member has
    nothing to add and gets its own tensor back (cast to ``dtype``).
    Across processes the members' tensors are gathered first and each
    process adds them in rank order on its first member's device."""
    xs = _per_position(xs, mesh)
    devs = mesh.devices.flatten()

    def local_fn(group, at, out):
        if len(group) == 1:
            out[at[group[0]]] = xs[at[group[0]]].to(dtype=dtype)
            return
        dev0 = devs[group[0]]
        acc = xs[at[group[0]]].to(dev0, dtype=dtype, copy=True)
        for r in group[1:]:
            acc = acc + xs[at[r]].to(dev0, dtype=dtype)
        out[at[group[0]]] = acc
        for r in group[1:]:
            out[at[r]] = acc.to(devs[r], copy=True)

    # the inputs' types, in the order of the members that cross
    at = {r: i for i, r in enumerate(mesh.local_ranks())}
    types = [xs[at[r]].dtype for group, _ in _cross_groups(mesh, axes)
             for r in group if r in at]

    def bwd(cross, gs):
        return [g.to(dt) for g, dt in
                zip(_psum_cross(mesh, cross, gs), types)]

    return _collective(xs, mesh, axes, local_fn,
                       partial(_psum_cross, mesh, dtype=dtype), bwd)


def _shift_cross(mesh, shift, sends, like, cross, ts) -> list:
    devs = mesh.devices.flatten()
    out = []
    for group, pg, mine, local in _per_group(mesh, cross, ts):
        n = len(group)
        src = [group[(group.index(r) - shift) % n] for r in mine]
        if sends is not None:
            if not any(sends[m] for m in group):
                out += [None] * len(mine)  # nobody sends: nothing moves
                continue
            local = [torch.zeros(like.shape, dtype=like.dtype,
                                 device=devs[r]) if t is None else t
                     for r, t in zip(mine, local)]
        every = _exchange(mesh, group, pg, local)
        out += [None if sends is not None and not sends[s_] else
                every[group.index(s_)].to(devs[r], copy=True)
                for r, s_ in zip(mine, src)]
    return out


def ring_shift(xs, mesh: Mesh, axis: str, *, shift: int = 1, sends=None,
               like=None) -> list:
    """``jax.lax.ppermute`` with ``perm = [(j, (j + shift) % n)]`` over
    ``axis``: the member at coordinate ``c`` receives the tensor of
    the member at ``(c - shift) % n`` (a copy on its own device). An
    entry may be None, a member with nothing to send (a pipeline's idle
    slot): its receiver gets None and nothing moves. Across processes a
    receiver cannot see that, so the caller names the senders:
    ``sends`` holds, per flat rank of the mesh, whether that member
    sends (the schedule's state, which every process knows), and
    ``like`` a tensor of the shape and dtype every sender sends. A group
    across processes in which nobody sends then moves nothing; in any
    other, each process sends zeros like ``like`` for its members that
    send nothing, and their receivers get None."""
    xs = _per_position(xs, mesh)
    devs = mesh.devices.flatten()

    def local_fn(group, at, out):
        n = len(group)
        for c, r in enumerate(group):
            src = xs[at[group[(c - shift) % n]]]
            if src is not None:
                out[at[r]] = src.to(devs[r], copy=True)

    at = {r: i for i, r in enumerate(mesh.local_ranks())}
    crossing = [r for group, _ in _cross_groups(mesh, axis) for r in group
                if r in at]
    if sends is None:
        if any(xs[at[r]] is None for r in crossing):
            raise ValueError(
                "a ring shift across processes with a member that sends "
                "nothing needs sends= (who sends, per flat rank) and like=")
        back = None
    else:
        bad = [r for r in at if (xs[at[r]] is not None) != bool(sends[r])]
        if bad:
            raise ValueError(f"sends disagrees with the tensors at flat "
                             f"ranks {bad}")
        back = [False] * mesh.size  # who sends each cotangent back
        for group in mesh.axis_groups(axis):
            n = len(group)
            for c, r in enumerate(group):
                back[r] = bool(sends[group[(c - shift) % n]])
    return _collective(xs, mesh, axis, local_fn,
                       partial(_shift_cross, mesh, shift, sends, like),
                       partial(_shift_cross, mesh, -shift, back, like))


def all_gather(xs, mesh: Mesh, axis: str, dim: int) -> list:
    """Tiled ``jax.lax.all_gather`` over ``axis``: every member gets the
    members' tensors concatenated along ``dim`` in coordinate order.
    The backward hands each member's cotangent slice back to its owner,
    where autograd sums them: ``psum_scatter``, JAX's transpose."""
    xs = _per_position(xs, mesh)
    devs = mesh.devices.flatten()

    def local_fn(group, at, out):
        for r in group:
            out[at[r]] = torch.cat([xs[at[m]].to(devs[r]) for m in group],
                                   dim=dim)

    def fwd(cross, ts):
        out = []
        for group, pg, mine, local in _per_group(mesh, cross, ts):
            every = _exchange(mesh, group, pg, local)
            out += [torch.cat([t.to(devs[r]) for t in every], dim=dim)
                    for r in mine]
        return out

    def bwd(cross, gs):
        size = xs[0].shape[dim]
        out = []
        for group, pg, mine, local in _per_group(mesh, cross, gs):
            every = _exchange(mesh, group, pg, local)
            for r in mine:
                c = group.index(r)
                acc = every[0].narrow(dim, c * size, size).to(devs[r],
                                                              copy=True)
                for g in every[1:]:
                    acc = acc + g.narrow(dim, c * size, size).to(devs[r])
                out.append(acc)
        return out

    return _collective(xs, mesh, axis, local_fn, fwd, bwd)


def _a2a_cross(mesh, split_dim, concat_dim, cross, ts) -> list:
    devs = mesh.devices.flatten()
    out = []
    for group, pg, mine, local in _per_group(mesh, cross, ts):
        n = len(group)
        size = local[0].shape[split_dim]
        every = _exchange(mesh, group, pg, local)
        chunks = [torch.split(t, size // n, dim=split_dim) for t in every]
        out += [torch.cat([c[group.index(r)].to(devs[r]) for c in chunks],
                          dim=concat_dim) for r in mine]
    return out


def all_to_all(xs, mesh: Mesh, axis: str, split_dim: int,
               concat_dim: int) -> list:
    """Tiled ``jax.lax.all_to_all`` over ``axis``: each member splits
    its tensor into n equal chunks along ``split_dim``; member ``j``
    receives chunk ``j`` of every member and concatenates them along
    ``concat_dim`` in the senders' coordinate order."""
    xs = _per_position(xs, mesh)
    devs = mesh.devices.flatten()
    n = mesh.shape[axis]
    for x in xs:
        if x.shape[split_dim] % n:
            raise ValueError(
                f"dimension {split_dim} of size {x.shape[split_dim]} does "
                f"not split into {n} parts over {axis!r}")

    def local_fn(group, at, out):
        size = xs[at[group[0]]].shape[split_dim]
        chunks = [torch.split(xs[at[r]], size // n, dim=split_dim)
                  for r in group]
        for j, r in enumerate(group):
            out[at[r]] = torch.cat([c[j].to(devs[r]) for c in chunks],
                                   dim=concat_dim)

    return _collective(xs, mesh, axis, local_fn,
                       partial(_a2a_cross, mesh, split_dim, concat_dim),
                       partial(_a2a_cross, mesh, concat_dim, split_dim))
