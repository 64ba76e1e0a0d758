"""Erasure-coded checkpoints: survive losing any n-k shard files.

A copy of the JAX package's ``utils/coded_checkpoint.py``. The manifest
format string names a data format, not an import, and stays the
reference's, as do the shard names, the CRC32 exclusion and the
``flock``-guarded generation swap: a checkpoint written by either
package restores in the other.

The coded-computation layer protects *compute* against stragglers; this
module applies the same any-k-of-n idea to checkpoint *storage*. A
state tree is packed to bytes, split into k source blocks,
RS(n, k)-encoded with the byte-exact GF(256) codec
(:mod:`.rs_gf256`; native and numpy routes give the same bytes), and
written as n shard files plus a manifest. Restore reads whichever shards
are present and uncorrupted (each shard carries a CRC32; bad files are
detected and excluded like stale pool results are masked by
``repochs``) and decodes from any k of them.

A state is any nest of dicts, lists and tuples whose leaves are torch
tensors, numpy arrays or scalars. Leaves are packed in
``jax.tree_util.tree_leaves``' order (dict keys sorted, sequences in
order, ``None`` holds no leaf) as ``leaf_<i>`` of an ``.npz``; a bf16
tensor goes in as its 2-byte payload viewed as ``V2``, which is what
``np.savez`` stores for a JAX bf16 array. Importing this module imports
no torch: tensors are recognised through ``sys.modules``.

>>> cc = CodedCheckpoint(n=5, k=3)
>>> cc.save(dir, {"w": w, "step": 7})
>>> # delete/corrupt any 2 of the 5 shard files...
>>> state = cc.restore(dir, target={"w": w_like, "step": 0})
"""

from __future__ import annotations

import io
import json
import os
import sys
import uuid
import zlib
from typing import Any

import numpy as np

from .rs_gf256 import RSGF256

__all__ = ["CodedCheckpoint", "CheckpointCorrupt"]

_MANIFEST = "manifest.json"
_FORMAT = "mpistragglers_jl_tpu.coded-ckpt-v1"


class CheckpointCorrupt(RuntimeError):
    """Too few intact shards to decode (``have`` < ``need``)."""

    def __init__(self, have: int, need: int, detail: str):
        self.have, self.need = have, need
        super().__init__(
            f"only {have} intact shards, need {need}: {detail}"
        )


def _torch():
    """The torch module if something already imported it, else None
    (a tensor leaf implies torch is loaded)."""
    return sys.modules.get("torch")


def _is_tensor(x) -> bool:
    torch = _torch()
    return torch is not None and isinstance(x, torch.Tensor)


def tree_leaves(tree) -> list:
    """The leaves of a nest in ``jax.tree_util.tree_leaves``' order:
    dict keys sorted, list and tuple items in order, ``None`` holds no
    leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_rebuild(target, it):
    """``target``'s nest with its leaves replaced, in :func:`tree_leaves`
    order, by ``leaf_like(item, target_leaf)`` for the items of ``it``."""
    if target is None:
        return None
    if isinstance(target, dict):
        return {k: tree_rebuild(target[k], it) for k in sorted(target)}
    if isinstance(target, (list, tuple)):
        vals = [tree_rebuild(v, it) for v in target]
        return vals if isinstance(target, list) else tuple(vals)
    return leaf_like(next(it), target)


def to_numpy(x) -> np.ndarray:
    """A leaf as the array ``np.savez`` stores: a tensor's host copy, a
    bf16 tensor as its raw 2-byte payload viewed as ``V2``."""
    if _is_tensor(x):
        torch = _torch()
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view("V2")
        return x.numpy()
    return np.asarray(x)


def _bf16_tensor(arr: np.ndarray):
    """A ``V2`` array (raw bf16 payload) as a bf16 CPU tensor, by
    reinterpreting its bytes."""
    torch = _torch()
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()
                            ).view(torch.bfloat16)


def leaf_like(arr: np.ndarray, like):
    """Loaded array ``arr`` rebuilt with the type of target leaf ``like``:
    a tensor with ``like``'s dtype and device (a ``V2`` array becomes bf16
    by its bytes, never through a float cast), an array of ``like``'s
    dtype, or a Python/numpy scalar of ``like``'s type."""
    if _is_tensor(like):
        torch = _torch()
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            t = _bf16_tensor(arr)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return arr if arr.dtype == like.dtype else arr.astype(like.dtype)
    if isinstance(like, np.generic):
        return like.dtype.type(arr[()])
    if isinstance(like, (bool, int, float, str)):
        return type(like)(arr.item())
    return arr


def _pack(tree) -> bytes:
    """State -> npz bytes (leaves only; structure comes from ``target``
    at restore, matching TrainCheckpointer's npz convention)."""
    buf = io.BytesIO()
    np.savez(buf, **{f"leaf_{i}": to_numpy(x)
                     for i, x in enumerate(tree_leaves(tree))})
    return buf.getvalue()


def _unpack(data: bytes, target):
    with np.load(io.BytesIO(data)) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    if target is None:
        return leaves
    return tree_rebuild(target, iter(leaves))


class CodedCheckpoint:
    """(n, k) Reed-Solomon-coded checkpoint writer/reader."""

    def __init__(self, n: int, k: int):
        self.n, self.k = int(n), int(k)
        self.rs = RSGF256(n, k)

    # -- save --------------------------------------------------------------
    def save(self, directory, state) -> list[str]:
        """Pack ``state``, encode, write ``shard_<i>.<suffix>.rs`` files +
        manifest; returns the shard paths.

        Crash-atomic over an existing checkpoint: shard filenames carry
        a fresh suffix and the manifest replace is the single commit
        point — a crash before it leaves the previous manifest + its
        (untouched) shards fully restorable; a crash after it leaves the
        new checkpoint complete, with at worst stale shard files from
        the previous generation lying around (cleaned on the next
        successful save)."""
        directory = os.fspath(directory)
        os.makedirs(directory, exist_ok=True)
        payload = _pack(state)
        coded, payload_bytes = self.rs.encode_bytes(payload)
        suffix = uuid.uuid4().hex[:8]
        # exclusive advisory lock for the whole save: without it, a
        # concurrent saver's prune step could delete this save's
        # not-yet-committed shards (single-host writers; cross-host
        # coordination is the caller's job)
        lock_fd = os.open(
            os.path.join(directory, ".save.lock"),
            os.O_CREAT | os.O_RDWR, 0o644,
        )
        try:
            import fcntl

            fcntl.flock(lock_fd, fcntl.LOCK_EX)
            return self._save_locked(
                directory, coded, payload_bytes, suffix
            )
        finally:
            os.close(lock_fd)  # closing releases the flock

    def _save_locked(
        self, directory: str, coded, payload_bytes: int, suffix: str
    ) -> list[str]:
        paths = []
        crcs = []
        for i in range(self.n):
            p = os.path.join(directory, f"shard_{i}.{suffix}.rs")
            raw = coded[i].tobytes()
            with open(p + ".tmp", "wb") as f:
                f.write(raw)
            os.replace(p + ".tmp", p)
            paths.append(p)
            crcs.append(zlib.crc32(raw))
        manifest = {
            "format": _FORMAT,
            "n": self.n,
            "k": self.k,
            "suffix": suffix,
            "payload_bytes": int(payload_bytes),
            "shard_bytes": int(coded.shape[1]),
            "crc32": crcs,
        }
        mpath = os.path.join(directory, _MANIFEST)
        with open(mpath + ".tmp", "w") as f:
            json.dump(manifest, f)
        os.replace(mpath + ".tmp", mpath)  # commit point
        for name in os.listdir(directory):  # prune previous generations
            stale_shard = (
                name.endswith(".rs") and f".{suffix}." not in name
            )
            if stale_shard or name.endswith(".rs.tmp"):
                try:
                    os.remove(os.path.join(directory, name))
                except OSError:  # pragma: no cover - concurrent cleanup
                    pass
        return paths

    # -- restore -----------------------------------------------------------
    def restore(self, directory, *, target=None) -> Any:
        """Decode from whichever shards are present AND intact (CRC32
        verified — a corrupt shard is excluded exactly like a stale pool
        result is masked by ``repochs``). Raises
        :class:`CheckpointCorrupt` below k intact shards. Without
        ``target`` returns the list of leaves as numpy arrays."""
        directory = os.fspath(directory)
        with open(os.path.join(directory, _MANIFEST)) as f:
            man = json.load(f)
        if man.get("format") != _FORMAT:
            raise ValueError(f"unrecognized manifest format {man.get('format')!r}")
        if (man["n"], man["k"]) != (self.n, self.k):
            raise ValueError(
                f"checkpoint is ({man['n']}, {man['k']})-coded, "
                f"decoder is ({self.n}, {self.k})"
            )
        L = man["shard_bytes"]
        suffix = man["suffix"]
        rows, idx, problems = [], [], []
        for i in range(self.n):
            if len(idx) == self.k:
                break  # any k suffice
            p = os.path.join(directory, f"shard_{i}.{suffix}.rs")
            try:
                with open(p, "rb") as f:
                    raw = f.read()
            except OSError as e:
                problems.append(f"shard {i}: {e}")
                continue
            if len(raw) != L or zlib.crc32(raw) != man["crc32"][i]:
                problems.append(f"shard {i}: corrupt (crc/length mismatch)")
                continue
            rows.append(np.frombuffer(raw, dtype=np.uint8))
            idx.append(i)
        if len(idx) < self.k:
            raise CheckpointCorrupt(
                len(idx), self.k, "; ".join(problems) or "no shards found"
            )
        payload = self.rs.decode_bytes(
            np.stack(rows), idx, man["payload_bytes"]
        )
        return _unpack(payload, target)
