"""Training checkpoint/resume: model state + pool bookkeeping together.

A copy of the JAX package's ``utils/train_checkpoint.py`` in its npz
layout, which either package reads:

    <dir>/step_<N>/state.npz     leaves ``leaf_<i>`` of the state nest
    <dir>/step_<N>/pool.json     pool bookkeeping (optional)
    <dir>/step_<N>/tree.json     the nest's structure (this package only)

:mod:`.checkpoint` covers the piece model checkpoints do not know about
— the pool's straggler bookkeeping (epoch counter, freshness mask,
latency estimates). This module couples it with the model and optimizer
state of a training loop under one step-numbered directory, so a
coordinator restart resumes *both* the learning state and the epoch
numbering.

The state is any nest of dicts, lists and tuples of tensors, arrays or
scalars: a parameter dict, ``opt.state_dict()`` (back through
``load_state_dict``). Leaves go in ``jax.tree_util.tree_leaves``' order
(:func:`.coded_checkpoint.tree_leaves`), so the port's parameter dict
writes the same ``leaf_<i>`` as the JAX package's parameter pytree; a
bf16 tensor is stored as its raw 2-byte payload (``V2``), as ``np.savez``
stores a JAX bf16 array. ``restore(target=...)`` rebuilds each leaf with
the target's dtype and device; without a target the structure comes from
``tree.json`` (tensors on the CPU). A :class:`..parallel.mesh.ShardedTensor`
leaf (a parameter laid out over a mesh) is written as its gathered global
value, the array a JAX-saved sharded array holds, and a target's sharded
leaf is laid out again by its own mesh and spec. Over a mesh that spans
processes ``save`` is a collective: every process of the job calls it
and takes part in each leaf's gather, process 0 alone writes the step
(through a ``.tmp`` directory, renamed), and each of the others returns
only once process 0 has said that the step is in place (or raises if
process 0 failed to write it), so none reads a half-written step.
``restore`` needs no collective: each process reads the files and lays
each sharded leaf out on its own positions. Writes are numpy only: a
step written by orbax (a ``state/`` directory) is refused by name.

>>> ckpt = TrainCheckpointer(dir)
>>> ckpt.save(12, {"params": params, "opt": opt.state_dict()}, pool=pool)
>>> state, pool_state, step = ckpt.restore(target=like)   # latest step
>>> pool = load_state_dict(pool_state)                    # quiescent pool
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any

import numpy as np
import torch

from ..parallel.mesh import ShardedTensor, shard
from ..pool import AsyncPool
from .checkpoint import state_dict as pool_state_dict
from .coded_checkpoint import (leaf_like, to_numpy, tree_leaves,
                               tree_rebuild)

__all__ = ["TrainCheckpointer"]

_STEP_RE = re.compile(r"^step_(\d+)$")
_SCALARS = {"bool": bool, "int": int, "float": float, "str": str}


def _spec(tree):
    """The nest's structure as JSON: containers with their keys, each
    leaf's kind (tensor dtype, Python scalar type, or array)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {"dict": [[k, _spec(tree[k])] for k in sorted(tree)]}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_spec(v) for v in tree]}
    if isinstance(tree, (torch.Tensor, ShardedTensor)):
        return {"tensor": str(tree.dtype).removeprefix("torch.")}
    if type(tree) in _SCALARS.values():
        return {"scalar": type(tree).__name__}
    return {"array": True}


def _from_spec(spec, it):
    if spec is None:
        return None
    (kind, val), = spec.items()
    if kind == "dict":
        return {k: _from_spec(s, it) for k, s in val}
    if kind in ("list", "tuple"):
        vals = [_from_spec(s, it) for s in val]
        return vals if kind == "list" else tuple(vals)
    arr = next(it)
    if kind == "tensor":
        like = torch.empty(0, dtype=getattr(torch, val))
        return leaf_like(arr, like)
    if kind == "scalar":
        return _SCALARS[val](arr.item())
    return arr


def _spanning(tree):
    """The first mesh that spans processes among ``tree``'s sharded
    leaves, or None."""
    for x in tree_leaves(tree):
        if isinstance(x, ShardedTensor) and x.mesh.spans_processes:
            return x.mesh
    return None


def _announce(mesh, ok: bool | None) -> bool:
    """Process 0's word on a step, heard by every process of the job:
    ``ok`` on process 0 (None elsewhere), one byte broadcast over the
    job's group (on the card under ``nccl``)."""
    import torch.distributed as dist

    dev = (mesh.local_devices()[0] if mesh.backend == "nccl"
           else torch.device("cpu"))
    flag = torch.tensor([int(bool(ok))], dtype=torch.uint8, device=dev)
    dist.broadcast(flag, src=0)
    return bool(flag.item())


def _lay_out(arr: np.ndarray, like: ShardedTensor) -> ShardedTensor:
    """A global array laid out as the target leaf ``like``: its dtype,
    mesh and spec, each block on its position's device."""
    host = leaf_like(arr, torch.empty(0, dtype=like.dtype))
    return shard(host, like.mesh, like.spec)


class TrainCheckpointer:
    """Step-numbered checkpoints of (state nest, pool bookkeeping).

    ``keep`` bounds how many step directories are retained (oldest
    pruned after each save, sparing the step just written); ``backend``
    is always ``"npz"``.
    """

    def __init__(self, directory, *, keep: int | None = None):
        self.directory = os.path.abspath(os.fspath(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.backend = "npz"

    # -- paths -------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}")

    def steps(self) -> list[int]:
        """Existing checkpoint steps, ascending."""
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save --------------------------------------------------------------
    def save(
        self,
        step: int,
        state,
        *,
        pool: AsyncPool | None = None,
        allow_active: bool = False,
    ) -> str:
        """Write ``state`` (any nest) and optional pool bookkeeping as
        step ``step``. The pool must be quiescent (``waitall`` first)
        unless ``allow_active``. Returns the step directory. Over a mesh
        that spans processes every process calls it (the module
        docstring): process 0 writes, the others wait for its word."""
        d = self._step_dir(step)
        arrays = {f"leaf_{i}": to_numpy(
            x.gather() if isinstance(x, ShardedTensor) else x)
            for i, x in enumerate(tree_leaves(state))}
        mesh = _spanning(state)
        if mesh is None:
            return self._write(d, step, state, arrays, pool, allow_active)
        import torch.distributed as dist

        if dist.get_rank() != 0:
            if not _announce(mesh, None):
                raise RuntimeError(
                    f"process 0 failed to write {d}: its own error says why")
            return d
        try:
            self._write(d, step, state, arrays, pool, allow_active)
        except BaseException:
            _announce(mesh, False)
            raise
        _announce(mesh, True)
        return d

    def _write(self, d, step, state, arrays, pool, allow_active) -> str:
        tmp = d + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "state.npz"), **arrays)
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump(_spec(state), f)
        if pool is not None:
            with open(os.path.join(tmp, "pool.json"), "w") as f:
                json.dump(
                    pool_state_dict(pool, allow_active=allow_active), f
                )
        if os.path.exists(d):
            shutil.rmtree(d)
        os.replace(tmp, d)
        if self.keep is not None:
            # retain the `keep` highest-numbered steps, but never the one
            # just written (a rollback re-save must not self-destruct)
            steps = self.steps()
            excess = len(steps) - self.keep
            if excess > 0:
                victims = [s for s in steps if s != int(step)][:excess]
                for old in victims:
                    shutil.rmtree(self._step_dir(old), ignore_errors=True)
        return d

    # -- restore -----------------------------------------------------------
    def restore(
        self, step: int | None = None, *, target=None
    ) -> tuple[Any, dict | None, int]:
        """Load ``(state, pool_state_dict_or_None, step)``.

        ``step=None`` loads the latest. ``target`` (a matching nest)
        rebuilds each leaf with the target leaf's type, dtype and device
        (a ShardedTensor's mesh and spec);
        without it the structure comes from ``tree.json``, which a step
        written by the JAX package lacks. Feed the pool dict to
        :func:`.checkpoint.load_state_dict`.
        """
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}"
                )
        d = self._step_dir(step)
        if os.path.isdir(os.path.join(d, "state")):
            raise ValueError(
                f"{d} holds an orbax checkpoint (a state/ directory); "
                "this package reads only the npz layout (state.npz): "
                "re-save it without orbax")
        with np.load(os.path.join(d, "state.npz")) as z:
            keys = sorted(
                (k for k in z.files if re.fullmatch(r"leaf_\d+", k)),
                key=lambda k: int(k.split("_")[1]),
            )
            leaves = [z[k] for k in keys]
        if target is not None:
            n = len(tree_leaves(target))
            if n != len(leaves):
                raise ValueError(f"checkpoint holds {len(leaves)} leaves, "
                                 f"target has {n}")
            state = tree_rebuild(target, iter(
                _lay_out(a, like) if isinstance(like, ShardedTensor) else a
                for a, like in zip(leaves, tree_leaves(target))))
        else:
            spec_path = os.path.join(d, "tree.json")
            if not os.path.exists(spec_path):
                raise ValueError(
                    "this step has no tree.json (written by the JAX "
                    "package): pass `target` to rebuild the tree")
            with open(spec_path) as f:
                state = _from_spec(json.load(f), iter(leaves))
        pool_state = None
        pool_path = os.path.join(d, "pool.json")
        if os.path.exists(pool_path):
            with open(pool_path) as f:
                pool_state = json.load(f)
        return state, pool_state, int(step)
