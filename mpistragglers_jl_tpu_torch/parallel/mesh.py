"""Device meshes and values laid out over them.

The port of the JAX package's ``parallel/mesh.py``. A JAX ``Mesh`` is
one process driving N devices; so is this one, or several processes
that each drive their own. A :class:`Mesh` is an
ndarray of ``torch.device`` with named axes, and one device may appear
at several positions (ranks): eight logical ranks can share one card,
``make_mesh(8, devices=[torch.device("cuda", 0)] * 8)``. On a host
with several cards, each position is its own card and the collectives
of :mod:`.collectives` move real bytes between them by peer copies.

A :class:`ShardedTensor` stands where the reference returns a
``NamedSharding``-ed ``jax.Array``: the mesh, a :class:`PartitionSpec`
(``spec``, what the reference's ``.sharding`` carries) and one tensor
per mesh position, on that position's device. Two positions on
the same card still hold separate tensors. There is no ``shard_map``
emulator: each module writes its per-rank loop and calls the
collectives explicitly. A per-rank program reads its coordinates
with :meth:`Mesh.axis_index` (``jax.lax.axis_index``) and the members
of a collective over named axes with :meth:`Mesh.axis_groups`.

A mesh from :func:`.multihost.make_multihost_mesh` spans processes:
``process_index`` names the process that drives each position and
``backend`` the ``torch.distributed`` backend that moves its bytes.
Each process then drives only its own positions,
:meth:`Mesh.local_ranks`, and every per-rank list a module builds is
indexed by position in that list (on a single-controller mesh it is
``range(size)``, so the same program text runs on both). :func:`shard`
and :func:`from_local` fill only the local positions (a
:class:`ShardedTensor` holds None at another process's), and
:meth:`ShardedTensor.gather` is a collective: every process calls it
and gets the whole value. The pool-fused GEMMs of :mod:`.fused`, which
run over a mesh of one process's alone as the JAX package's do, call
:meth:`Mesh.require_local`, which says why and names what runs across
processes instead.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["Mesh", "PartitionSpec", "ShardedTensor", "make_mesh", "shard"]


class PartitionSpec(tuple):
    """Per tensor dimension, the mesh axis it is split over (or None:
    whole on every position), as ``jax.sharding.PartitionSpec``.
    Dimensions past the spec's length are whole."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _process_index() -> int:
    dist = _dist()
    return 0 if dist is None else int(dist.get_rank())


def _process_count() -> int:
    dist = _dist()
    return 1 if dist is None else int(dist.get_world_size())


def dist_backend() -> str | None:
    """The ``torch.distributed`` backend that moves CUDA tensors in this
    job: ``"nccl"`` or ``"gloo"``, None without a job."""
    dist = _dist()
    if dist is None:
        return None
    return "nccl" if "nccl" in str(dist.get_backend()) else "gloo"


class Mesh:
    """Devices on named axes. ``shape`` is an ordered mapping, so
    ``mesh.shape[axis]`` reads as in JAX; ``process_index`` holds, per
    position, the process that drives it (all this process's in a
    single-controller mesh, see :mod:`.multihost`); :attr:`backend` is
    the ``torch.distributed`` backend that moves the bytes of a mesh
    that spans processes."""

    def __init__(self, devices, axis_names: Sequence[str],
                 process_index=None):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(src[idx])
        self.devices = arr
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != arr.ndim:
            raise ValueError(
                f"{arr.ndim}-d device array for axes {self.axis_names}")
        self.shape = OrderedDict(zip(self.axis_names, arr.shape))
        if process_index is None:
            process_index = np.full(arr.shape, _process_index(), dtype=int)
        self.process_index = np.asarray(process_index, dtype=int)
        self.spans_processes = len(np.unique(self.process_index)) > 1
        self._local = None  # (process, world, local ranks)
        self._pgroups: dict = {}  # process tuple -> torch.distributed group
        self._cross: dict = {}  # axes -> [(group, process group)]
        self._chain = None  # collectives.crossing_chain's [start, end]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def backend(self) -> str | None:
        """The job's :func:`dist_backend` over a mesh that spans
        processes (``"gloo"``: bytes cross through host memory;
        ``"nccl"``: they stay on the cards), None otherwise."""
        return dist_backend() if self.spans_processes else None

    def local_ranks(self) -> list:
        """The flat ranks (row-major) this process drives, ascending:
        ``range(size)`` on a single-controller mesh. Raises for a mesh
        that names a process absent from the job."""
        me, world = _process_index(), _process_count()
        if self._local is None or self._local[:2] != (me, world):
            owners = [int(p) for p in self.process_index.flat]
            absent = sorted(set(owners) - set(range(world)))
            if absent:
                raise ValueError(
                    f"mesh positions are driven by process(es) {absent}, "
                    f"absent from this job of {world} process(es): a mesh "
                    "across processes comes from make_multihost_mesh after "
                    "initialize_multihost")
            self._local = (me, world,
                           [r for r, p in enumerate(owners) if p == me])
        return list(self._local[2])

    def local_devices(self) -> list:
        """The devices of :meth:`local_ranks`, in that order."""
        flat = self.devices.flatten()
        return [flat[r] for r in self.local_ranks()]

    def require_local(self, what: str = "this entry point") -> None:
        """Raise unless this process drives every position: ``what``
        runs over a mesh of this process's alone. That is the JAX
        package's limit for the pool-fused GEMMs: their map step is a
        host ``asyncmap`` whose fastest-k set one process's pool
        decides, and no exchange makes the processes agree on it."""
        me = _process_index()
        others = sorted({int(p) for p in self.process_index.flat} - {me})
        if others:
            raise ValueError(
                f"mesh positions are driven by process(es) {others}, not "
                f"by this one ({me}): {what} runs over a mesh that one "
                "process drives whole, as in the JAX package: its fastest-k "
                "set is decided by one process's asyncmap from the "
                "arrivals its own threads see, and no exchange makes the "
                "processes agree on it. DeviceCoordinator(mesh=...) runs "
                "the coded window across processes, and "
                "local_worker_indices(mesh) names this process's workers")

    def axis_devices(self, axis: str,
                     what: str = "this entry point") -> list:
        """The devices along ``axis`` of a 1-D mesh that this process
        drives whole, in rank order (the pool-fused GEMMs, named by
        ``what``): raises through :meth:`require_local` over a mesh that
        spans processes."""
        self.require_local(what)
        return self.local_axis_devices(axis)

    def local_axis_devices(self, axis: str) -> list:
        """:meth:`local_devices` of a 1-D ``(axis,)`` mesh (a pool
        axis, whose ranks are the workers)."""
        if len(self.axis_names) != 1 or self.axis_names[0] != axis:
            raise ValueError(
                f"need a 1-D ({axis!r},) mesh, got {self.axis_names}")
        return self.local_devices()

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(
                    f"axis {a!r} not in mesh axes {self.axis_names}")
        return axes

    def axis_index(self, axis: str) -> list:
        """Per flat position (row-major), its coordinate along ``axis``:
        what ``jax.lax.axis_index(axis)`` reads on that device."""
        (axis,) = self._axes(axis)
        d = self.axis_names.index(axis)
        return [int(idx[d]) for idx in np.ndindex(self.devices.shape)]

    def axis_groups(self, axes) -> list:
        """The positions that differ only along ``axes`` (one name or
        several), as lists of flat ranks, one list per group, each in
        ascending rank order (row-major over ``axes`` in the mesh's axis
        order, so along one axis the list is in coordinate order): the
        members of a ``psum``, ``ppermute`` or ``all_to_all`` over
        ``axes``. Every position is in exactly one group."""
        axes = self._axes(axes)
        keep = [d for d, a in enumerate(self.axis_names) if a not in axes]
        over = [d for d, a in enumerate(self.axis_names) if a in axes]
        ranks = np.arange(self.size).reshape(self.devices.shape)
        ranks = ranks.transpose(keep + over)
        width = int(np.prod([self.devices.shape[d] for d in over]))
        return [[int(r) for r in row] for row in ranks.reshape(-1, width)]

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.devices.flatten()]})")


def make_mesh(
    axis_sizes: Sequence[int] | int,
    axis_names: Sequence[str] | str = "w",
    *,
    devices: Sequence | None = None,
) -> Mesh:
    """Build a Mesh from the first ``prod(axis_sizes)`` devices: the
    visible CUDA devices unless ``devices=`` names them (a device may
    repeat; ``["cpu"] * 8`` is eight CPU ranks).

    >>> make_mesh(8, devices=[torch.device("cuda", 0)] * 8)  # ('w',)
    >>> make_mesh((2, 4), ("dp", "tp"), devices=["cpu"] * 8)
    """
    if isinstance(axis_sizes, (int, np.integer)):
        axis_sizes = (int(axis_sizes),)
    if isinstance(axis_names, str):
        axis_names = (axis_names,)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(
            f"axis_sizes {axis_sizes} and axis_names {axis_names} "
            "must have equal length"
        )
    need = int(np.prod(axis_sizes))
    if devices is None:
        resolve_device()  # no card: raise rather than build a CPU mesh
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [resolve_device(d) for d in devices]
    if len(devices) < need:
        raise ValueError(
            f"mesh {dict(zip(axis_names, axis_sizes))} needs {need} "
            f"devices, have {len(devices)}"
        )
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    return Mesh(arr.reshape(tuple(axis_sizes)), tuple(axis_names))


def _axis_names(part) -> tuple:
    """The mesh axes of one spec entry: none, one name, or a tuple of
    names (the dimension split over their product, the first major)."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def _slices(mesh: Mesh, spec, shape, idx) -> tuple:
    """The index of position ``idx``'s block of a ``shape`` value."""
    out = []
    for d, size in enumerate(shape):
        axes = _axis_names(spec[d] if d < len(spec) else None)
        if not axes:
            out.append(slice(None))
            continue
        parts, i = 1, 0
        for a in axes:  # row-major over the axes, as JAX lays them out
            n = mesh.shape[a]
            parts, i = parts * n, i * n + idx[mesh.axis_names.index(a)]
        if size % parts:
            raise ValueError(
                f"dimension {d} of size {size} does not split into "
                f"{parts} parts over {spec[d]!r}")
        step = size // parts
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


class ShardedTensor:
    """One tensor per mesh position, laid out by ``spec``.

    ``shards`` is an object ndarray of the mesh's shape; the tensor at
    ``shards[idx]`` lies on ``mesh.devices[idx]``. :meth:`gather` (and
    ``np.asarray``) assembles the global value on the host."""

    def __init__(self, mesh: Mesh, spec, shards, shape):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        for part in self.spec:
            for axis in _axis_names(part):
                if axis not in mesh.axis_names:
                    raise ValueError(
                        f"axis {axis!r} not in mesh axes {mesh.axis_names}")
        self.shards = shards
        self.shape = tuple(int(s) for s in shape)

    @property
    def dtype(self):
        return self.local(self.mesh.local_ranks()[0]).dtype

    def local(self, rank: int) -> torch.Tensor:
        """The tensor at flat position ``rank`` (row-major over axes);
        None at a position another process drives."""
        return self.shards.flat[int(rank)]

    def locals(self) -> list:
        """This process's tensors, in :meth:`Mesh.local_ranks` order."""
        return [self.shards.flat[r] for r in self.mesh.local_ranks()]

    def gather(self, device="cpu") -> torch.Tensor:
        """The global value, assembled on ``device`` (the host by
        default). Over a mesh that spans processes this is a collective:
        every process calls it and gets the whole value, each block sent
        by the process of the lowest rank that holds it (a block that
        every process holds is not sent)."""
        mesh = self.mesh
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        if not mesh.spans_processes:
            for idx in np.ndindex(mesh.devices.shape):
                out[_slices(mesh, self.spec, self.shape, idx)] = \
                    self.shards[idx].detach().to(out.device)
            return out
        blocks: dict = {}  # block index -> the ranks that hold it
        for r, idx in enumerate(np.ndindex(mesh.devices.shape)):
            sl = _slices(mesh, self.spec, self.shape, idx)
            blocks.setdefault(tuple((b.start, b.stop) for b in sl),
                              []).append(r)
        owners = mesh.process_index.flatten()
        me, world = _process_index(), _process_count()
        for key, ranks in blocks.items():
            sl = tuple(slice(a, b) for a, b in key)
            mine = [r for r in ranks if owners[r] == me]
            if mine and {int(owners[r]) for r in ranks} >= set(range(world)):
                out[sl] = self.local(mine[0]).detach().to(out.device)
                continue
            src = int(owners[ranks[0]])
            like = self.local(mine[0] if mine else
                              mesh.local_ranks()[0])
            blk = (self.local(ranks[0]).detach() if src == me else
                   torch.empty(out[sl].shape, dtype=self.dtype,
                               device=like.device))
            buf = to_bytes(blk, mesh.backend)
            _dist().broadcast(buf, src=src)
            out[sl] = from_bytes(buf, self.dtype,
                                 out[sl].shape).to(out.device)
        return out

    def __array__(self, dtype=None, copy=None):
        a = self.gather().numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, spec={self.spec}, "
                f"mesh={dict(self.mesh.shape)})")


def to_bytes(t: torch.Tensor, backend) -> torch.Tensor:
    """``t``'s bytes as a flat uint8 tensor, where ``backend`` moves
    them: on the host for ``gloo`` (it has no CUDA transport), on ``t``'s
    card for ``nccl``. Any dtype crosses as bytes, bit for bit."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    return b if backend == "nccl" else b.cpu()


def from_bytes(buf: torch.Tensor, dtype, shape) -> torch.Tensor:
    """:func:`to_bytes`' inverse: a view of ``buf`` as ``dtype`` of
    ``shape``."""
    return buf.view(dtype).reshape(shape)


def shard(x, mesh: Mesh, spec) -> ShardedTensor:
    """Lay ``x`` (numpy or torch; the global value, which every process
    holds) out over ``mesh`` by ``spec``: each position this process
    drives gets its own copy of its block on its device, never a view of
    another position's; another process's positions hold None."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    spec = PartitionSpec(*spec)
    shards = np.empty(mesh.devices.shape, dtype=object)
    idxs = list(np.ndindex(mesh.devices.shape))
    for r in mesh.local_ranks():
        idx = idxs[r]
        blk = t[_slices(mesh, spec, tuple(t.shape), idx)]
        shards[idx] = blk.to(mesh.devices[idx], copy=True).contiguous()
    return ShardedTensor(mesh, spec, shards, t.shape)


def from_local(mesh: Mesh, spec, locals_, shape) -> ShardedTensor:
    """Wrap this process's tensors, one per position of
    :meth:`Mesh.local_ranks` in that order, as one value."""
    ranks = mesh.local_ranks()
    locals_ = list(locals_)
    if len(locals_) != len(ranks):
        raise ValueError(
            f"need one tensor per position this process drives "
            f"({len(ranks)}), got {len(locals_)}")
    shards = np.empty(mesh.devices.shape, dtype=object)
    for r, t in zip(ranks, locals_):
        shards.flat[r] = t
    return ShardedTensor(mesh, spec, shards, shape)
