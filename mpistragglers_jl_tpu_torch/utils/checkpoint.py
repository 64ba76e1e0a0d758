"""Checkpoint / resume of pool epoch state.

A copy of the JAX package's ``utils/checkpoint.py``. The format
string names a data format, not an import, and stays the
reference's: a pool checkpoint written by either package restores
in the other.

The reference has no serialization at all — the only resume hooks are the
``epoch0``/``epoch`` keyword arguments by which a caller could manually
re-seed a numbering scheme (reference src/MPIAsyncPools.jl:35,:68; SURVEY
§5 "Checkpoint / resume: absent"). Here pool state round-trips through a
plain dict (JSON-able) or an ``.npz`` file, so an iterative workload can
resume with its epoch counter, freshness mask and latency estimates
intact after a coordinator restart.

Only *quiescent* state is checkpointable: in-flight dispatches live in
the backend (device queues, threads) and cannot meaningfully be
serialized — callers drain with ``waitall`` first, mirroring how any MPI
checkpoint must first quiesce communication. ``save`` enforces this.

Model/optimizer state belongs to the training checkpoints (``torch.save``
of the parameters), not here; this module covers the piece those do not
know about — the pool's straggler bookkeeping.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

from ..pool import AsyncPool

__all__ = ["state_dict", "load_state_dict", "save", "restore"]

_FORMAT = "mpistragglers_jl_tpu.pool-v1"


def state_dict(pool: AsyncPool, *, allow_active: bool = False) -> dict[str, Any]:
    """Snapshot pool bookkeeping as a JSON-able dict.

    Raises if any worker is active (in-flight work is not serializable)
    unless ``allow_active``; then active workers are recorded as inactive
    — on restore their last *received* epoch is still correct, the
    in-flight task is simply dropped, which is exactly what a coordinator
    crash does anyway.
    """
    if pool.active.any() and not allow_active:
        raise RuntimeError(
            f"workers {np.flatnonzero(pool.active).tolist()} still active; "
            "drain with waitall() before checkpointing, or pass "
            "allow_active=True to drop in-flight work"
        )
    return {
        "format": _FORMAT,
        "ranks": list(pool.ranks),
        "epoch": int(pool.epoch),
        "epoch0": int(pool.epoch0),
        "nwait": int(pool.nwait),
        "sepochs": [int(x) for x in pool.sepochs],
        "repochs": [int(x) for x in pool.repochs],
        "latency": [float(x) for x in pool.latency],
    }


def load_state_dict(state: dict[str, Any]) -> AsyncPool:
    """Reconstruct a quiescent pool from :func:`state_dict` output."""
    if state.get("format") != _FORMAT:
        raise ValueError(
            f"unrecognized checkpoint format {state.get('format')!r}"
        )
    pool = AsyncPool(
        state["ranks"], epoch0=state["epoch0"], nwait=state["nwait"]
    )
    pool.epoch = int(state["epoch"])
    pool.sepochs[:] = state["sepochs"]
    pool.repochs[:] = state["repochs"]
    pool.latency[:] = state["latency"]
    # all workers inactive; pool.results is transport state, not restored
    return pool


def save(pool: AsyncPool, path, *, allow_active: bool = False) -> None:
    """Write pool state to ``path`` (JSON)."""
    with open(path, "w") as f:
        json.dump(state_dict(pool, allow_active=allow_active), f, indent=1)


def restore(path) -> AsyncPool:
    """Load a pool previously written by :func:`save`."""
    with open(path) as f:
        return load_state_dict(json.load(f))
