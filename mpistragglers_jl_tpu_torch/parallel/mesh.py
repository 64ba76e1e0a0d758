"""Device meshes and values laid out over them, single-controller.

The port of the JAX package's ``parallel/mesh.py``. A JAX ``Mesh`` is
one process driving N devices; so is this one. A :class:`Mesh` is an
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

Every position of a mesh that this module shards over, and that the
collectives run on, must be driven by this process. A mesh from
:func:`.multihost.make_multihost_mesh` that spans processes serves the
ownership reads of :mod:`.multihost` only: :func:`shard`,
:func:`from_local` and :meth:`Mesh.axis_devices` (through which every
collective and mesh GEMM finds its ranks) refuse it, rather than run
each process's copy of the whole collective on its own devices.
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


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


class Mesh:
    """Devices on named axes. ``shape`` is an ordered mapping, so
    ``mesh.shape[axis]`` reads as in JAX; ``process_index`` holds, per
    position, the process that drives it (all this process's in a
    single-controller mesh, see :mod:`.multihost`)."""

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

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def require_local(self) -> None:
        """Raise unless this process drives every position."""
        me = _process_index()
        others = sorted({int(p) for p in self.process_index.flat} - {me})
        if others:
            raise ValueError(
                f"mesh positions are driven by process(es) {others}, not "
                f"by this one ({me}): the mesh plane moves shards with "
                "`.to(device)` inside one process, and a collective "
                "across processes is ROADMAP item 18g (collectives "
                "across processes)")

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis`` of a 1-D mesh, in rank order."""
        if len(self.axis_names) != 1 or self.axis_names[0] != axis:
            raise ValueError(
                f"need a 1-D ({axis!r},) mesh, got {self.axis_names}")
        self.require_local()
        return list(self.devices.flatten())

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
        self.require_local()
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
        self.require_local()
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
        return self.local(0).dtype

    def local(self, rank: int) -> torch.Tensor:
        """The tensor at flat position ``rank`` (row-major over axes)."""
        return self.shards.flat[int(rank)]

    def gather(self, device="cpu") -> torch.Tensor:
        """The global value, assembled on ``device`` (the host by
        default)."""
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for idx in np.ndindex(self.mesh.devices.shape):
            out[_slices(self.mesh, self.spec, self.shape, idx)] = \
                self.shards[idx].detach().to(out.device)
        return out

    def __array__(self, dtype=None, copy=None):
        a = self.gather().numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, spec={self.spec}, "
                f"mesh={dict(self.mesh.shape)})")


def shard(x, mesh: Mesh, spec) -> ShardedTensor:
    """Lay ``x`` (numpy or torch) out over ``mesh`` by ``spec``: each
    position gets its own copy of its block on its device, never a view
    of another position's."""
    mesh.require_local()
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    spec = PartitionSpec(*spec)
    shards = np.empty(mesh.devices.shape, dtype=object)
    for idx in np.ndindex(mesh.devices.shape):
        blk = t[_slices(mesh, spec, tuple(t.shape), idx)]
        shards[idx] = blk.to(mesh.devices[idx], copy=True).contiguous()
    return ShardedTensor(mesh, spec, shards, t.shape)


def from_local(mesh: Mesh, spec, locals_, shape) -> ShardedTensor:
    """Wrap per-position tensors (flat, row-major) as one value."""
    mesh.require_local()
    shards = np.empty(mesh.devices.shape, dtype=object)
    for i, t in enumerate(locals_):
        shards.flat[i] = t
    return ShardedTensor(mesh, spec, shards, shape)
