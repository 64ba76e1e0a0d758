"""Multi-process runtime init and meshes over several processes.

The port of the JAX package's ``parallel/multihost.py``, the one module
of the mesh plane that maps onto ``torch.distributed``: the reference
scales across hosts by launching more ranks and wiring them into one
runtime (``jax.distributed.initialize``, the analog of ``MPI.Init()``);
here :func:`initialize_multihost` is ``init_process_group`` (``gloo``
for CPU ranks, or for processes that share a card; ``nccl`` for one
card per process). A mesh built by :func:`make_multihost_mesh` lists
every process's devices, process-major, with ``mesh.process_index``
naming the process that drives each position and ``mesh.backend`` the
backend that moves its bytes. Each process drives its own positions
(``Mesh.local_ranks``): the sharded programs run their ranks' share of
the per-rank loops, and the collectives of :mod:`.collectives` cross
processes over ``torch.distributed`` where a group's members do.
:func:`local_worker_indices` and :func:`host_groups` read ownership off
the mesh.

Single-process runs (tests, the one-card bench) need none of this:
every function degrades to the local-device path, so the same program
text runs everywhere.
"""

from __future__ import annotations

import os
import socket
from typing import Sequence

import numpy as np
import torch

from .._device import resolve_device
from .mesh import Mesh, dist_backend

__all__ = [
    "backend",
    "initialize_multihost",
    "make_multihost_mesh",
    "local_worker_indices",
    "host_groups",
]

_initialized = False
_local_devices: list | None = None  # what this process contributes


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _in_cluster_env() -> bool:
    """True when the environment describes a multi-process job whose
    coordinates ``init_process_group(init_method="env://")`` can read:
    ``torchrun``'s ``MASTER_ADDR`` with a ``WORLD_SIZE`` above 1. A
    single-process value (``WORLD_SIZE=1``) does not count."""
    env = os.environ
    if not env.get("MASTER_ADDR"):
        return False
    try:
        return int(env.get("WORLD_SIZE", "1")) > 1
    except ValueError:
        return False


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: Sequence[int] | None = None,
    *,
    device=None,
    backend: str | None = None,
) -> None:
    """Wire this process into a multi-process runtime (idempotent).

    Guarded wrapper over ``torch.distributed.init_process_group``, the
    analog of ``MPI.Init()``. A bare call initializes from the
    environment when a cluster job is detected (``_in_cluster_env``)
    and is a no-op otherwise, so the same program text runs on a laptop,
    one card and a cluster. Passing ``coordinator_address``
    (``"host:port"`` or a ``tcp://`` URL) with ``num_processes`` and
    ``process_id`` always initializes.

    ``device`` is this process's device: the card by default
    (``local_device_ids[0]``, else ``process_id`` modulo the visible
    cards), or ``"cpu"``. ``backend`` moves the mesh's bytes: ``"gloo"``
    (through host memory; the default for a CPU device, and legal with a
    card) or ``"nccl"`` (on the cards; the default for a card). Right
    after ``init_process_group`` every process's (host, device) is
    gathered once: ``nccl`` needs a card of its own per process, and two
    processes on one card raise a ``ValueError`` that asks for
    ``backend="gloo"`` (the backend is never switched quietly)."""
    global _initialized, _local_devices
    if _initialized:
        return
    explicit = coordinator_address is not None or (
        num_processes is not None and num_processes > 1
    )
    if not explicit and not _in_cluster_env():
        # nothing to coordinate: single-process (tests / one-card bench)
        _initialized = True
        return
    import torch.distributed as dist

    if coordinator_address is not None:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    else:
        url = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    if device is None:
        if local_device_ids:
            device = torch.device("cuda", int(local_device_ids[0]))
        else:
            device = torch.device(
                "cuda", rank % max(torch.cuda.device_count(), 1))
    dev = resolve_device(device)
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(
            f"backend='nccl' moves CUDA tensors, and this process's device "
            f"is {dev}: pass backend='gloo'")
    # object collectives (the check below, make_multihost_mesh's device
    # gather) run over gloo in both cases; CUDA tensors over nccl
    dist.init_process_group(
        "gloo" if backend == "gloo" else "cpu:gloo,cuda:nccl",
        init_method=url, world_size=world, rank=rank)
    every: list = [None] * world
    dist.all_gather_object(every, (socket.gethostname(), str(dev)))
    try:
        check_backend(backend, every)
    except ValueError:
        dist.destroy_process_group()
        raise
    if backend == "nccl":
        torch.cuda.set_device(dev)
    _local_devices = [dev]
    _initialized = True


def check_backend(backend: str, every: Sequence) -> None:
    """Raise unless ``backend`` can serve processes whose (host name,
    device) pairs are ``every`` (indexed by process): ``nccl`` refuses
    two ranks of one communicator on one GPU, at its first collective
    and with its own error, so two processes on one card are refused
    here, by name."""
    if backend != "nccl":
        return
    seen: dict = {}
    for p, (host, dev) in enumerate(every):
        if (host, dev) in seen:
            raise ValueError(
                f"processes {seen[host, dev]} and {p} share {dev} on host "
                f"{host!r}: nccl needs a card of its own per process; pass "
                "backend='gloo' to run them on one card")
        seen[host, dev] = p


def backend() -> str | None:
    """The backend :func:`initialize_multihost` chose (``"gloo"`` or
    ``"nccl"``), or None in a single-process run: what ``mesh.backend``
    reads (:func:`.mesh.dist_backend`)."""
    return dist_backend()


def _global_devices(devices) -> tuple[list, list]:
    """(every process's devices, their process indices), process-major.
    One process: ``devices`` (default the visible cards) as they are."""
    dist = _dist()
    if devices is None:
        devices = _local_devices
    if dist is None:
        if devices is None:
            resolve_device()  # no card: raise rather than use the CPU
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [resolve_device(d) for d in devices]
        return devices, [0] * len(devices)
    mine = [str(resolve_device(d)) for d in (devices or [resolve_device()])]
    every: list = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    flat, owners = [], []
    for p, devs in enumerate(every):
        flat += [torch.device(d) for d in devs]
        owners += [p] * len(devs)
    return flat, owners


def process_count() -> int:
    dist = _dist()
    return 1 if dist is None else int(dist.get_world_size())


def process_index() -> int:
    dist = _dist()
    return 0 if dist is None else int(dist.get_rank())


def make_multihost_mesh(
    axis_sizes: Sequence[int] | int,
    axis_names: Sequence[str] | str = "w",
    *,
    dcn_axis: str | None = None,
    devices: Sequence | None = None,
) -> Mesh:
    """Build a mesh over *all* processes' devices, the cross-process axis
    outermost.

    ``dcn_axis`` moves one axis outermost, so it is the axis that spans
    processes; in a multi-process run its size must be a multiple of the
    process count and the mesh must span *all* global devices (a partial
    mesh cannot guarantee the axis actually crosses processes). Without
    it the devices fill the mesh row-major, process-major, so the
    outermost axis crosses processes. Any axis may cross: the
    collectives over it run across processes (:mod:`.collectives`).
    With one process this is ``make_mesh`` over the local devices.
    ``devices=`` is what this process contributes (default: its device
    from :func:`initialize_multihost`, or the visible cards).

    >>> initialize_multihost()
    >>> mesh = make_multihost_mesh((4, 8), ("dp", "tp"), dcn_axis="dp")
    """
    if isinstance(axis_sizes, (int, np.integer)):
        axis_sizes = (int(axis_sizes),)
    if isinstance(axis_names, str):
        axis_names = (axis_names,)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    axis_names = tuple(axis_names)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(
            f"axis_sizes {axis_sizes} and axis_names {axis_names} "
            "must have equal length"
        )
    if dcn_axis is not None and dcn_axis not in axis_names:
        raise ValueError(f"dcn_axis {dcn_axis!r} not in {axis_names}")
    need = int(np.prod(axis_sizes))
    flat, owners = _global_devices(devices)
    n_proc = process_count()
    if len(flat) < need:
        raise ValueError(
            f"mesh {dict(zip(axis_names, axis_sizes))} needs {need} "
            f"devices, have {len(flat)} across {n_proc} process(es)"
        )
    if n_proc > 1 and dcn_axis is not None:
        if need != len(flat):
            raise ValueError(
                f"multi-process mesh with dcn_axis must span all "
                f"{len(flat)} global devices, but "
                f"{dict(zip(axis_names, axis_sizes))} covers {need}"
            )
        size = axis_sizes[axis_names.index(dcn_axis)]
        if size % n_proc != 0:
            raise ValueError(
                f"dcn_axis {dcn_axis!r} size {size} must be a multiple "
                f"of process count {n_proc}"
            )
        # process-major device order with dcn_axis moved outermost: each
        # process's devices fill a contiguous run of the dcn axis
        order = (dcn_axis,) + tuple(a for a in axis_names if a != dcn_axis)
        shape = tuple(axis_sizes[axis_names.index(a)] for a in order)
        perm = [order.index(a) for a in axis_names]
        dev_arr = np.empty(need, dtype=object)
        dev_arr[:] = flat
        dev_arr = dev_arr.reshape(shape).transpose(perm)
        own = np.asarray(owners).reshape(shape).transpose(perm)
        return Mesh(dev_arr, axis_names, process_index=own)
    dev_arr = np.empty(need, dtype=object)
    dev_arr[:] = flat[:need]
    return Mesh(dev_arr.reshape(axis_sizes), axis_names,
                process_index=np.asarray(owners[:need]).reshape(axis_sizes))


def _positions(mesh: Mesh, axis: str) -> np.ndarray:
    """Process index per (position along ``axis``, other positions)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} not in mesh axes {mesh.axis_names}")
    ax = mesh.axis_names.index(axis)
    moved = np.moveaxis(mesh.process_index, ax, 0)
    return moved.reshape(moved.shape[0], -1)


def host_groups(
    n_workers: int | None = None,
    *,
    mesh: Mesh | None = None,
    axis: str = "w",
    n_hosts: int | None = None,
) -> list[list[int]]:
    """Partition pool worker indices into host groups, the fleet layout
    :class:`~..ops.hierarchical.HierarchicalCodedGemm`'s outer code
    stripes across.

    With ``mesh`` (from :func:`make_multihost_mesh`), positions along
    ``axis`` group by the process driving their devices, exactly the
    ownership :func:`local_worker_indices` reports per process,
    assembled for every process. Groups must come out equal-sized; a
    position spanning several processes is refused (such a position
    cannot be a straggler-independence unit).

    Without a mesh (tests, sim fleets, a single host), ``n_workers``
    splits evenly into ``n_hosts`` contiguous groups.

    >>> groups = host_groups(mesh=mesh)               # one per process
    >>> hg = HierarchicalCodedGemm(A, groups=groups, k_inner=6)
    """
    if mesh is None:
        if n_workers is None or n_hosts is None:
            raise ValueError(
                "without a mesh, host_groups needs n_workers and n_hosts"
            )
        from ..ops.outer_code import partition_groups

        return [
            g.tolist()
            for g in partition_groups(int(n_workers), int(n_hosts))
        ]
    flat = _positions(mesh, axis)
    by_host: dict[int, list[int]] = {}
    for i in range(flat.shape[0]):
        owners = {int(p) for p in flat[i]}
        if len(owners) != 1:
            raise ValueError(
                f"position {i} along {axis!r} spans processes "
                f"{sorted(owners)}; a host group must live on one host "
                "to be a straggler-independence unit"
            )
        by_host.setdefault(owners.pop(), []).append(i)
    groups = [by_host[p] for p in sorted(by_host)]
    if len({len(g) for g in groups}) != 1:
        raise ValueError(
            f"hosts own unequal worker counts "
            f"{[len(g) for g in groups]} along {axis!r}; lay the pool "
            "axis out per-host-uniform"
        )
    return groups


def local_worker_indices(mesh: Mesh, axis: str = "w") -> list[int]:
    """Positions along ``axis`` whose devices this process drives.

    A multi-process pool runs one coordinator per process driving its
    local devices; the cross-process combine is a collective over the
    full mesh. This returns the pool indices this process owns."""
    flat = _positions(mesh, axis)
    pid = process_index()
    return [int(i) for i in range(flat.shape[0]) if (flat[i] == pid).any()]
