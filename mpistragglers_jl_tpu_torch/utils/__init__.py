"""Jax-free utilities of the port: the counter-based generator
(:mod:`.prng`), the pool's epoch tracer (:mod:`.trace`), deterministic
fault injection (:mod:`.faults`), the straggler latency model and the
adaptive ``nwait`` controller (:mod:`.straggle`), hedged requests
(:mod:`.hedge`), pool checkpoints (:mod:`.checkpoint`), the GF(256)
Reed-Solomon codec (:mod:`.rs_gf256`), erasure-coded checkpoints
(:mod:`.coded_checkpoint`) and training checkpoints
(:mod:`.train_checkpoint`). Copies of the JAX package's modules of the
same names."""

from . import faults
from .checkpoint import load_state_dict, restore, save, state_dict
from .coded_checkpoint import CheckpointCorrupt, CodedCheckpoint
from .hedge import HedgedServer, RequestHedge
from .rs_gf256 import RSGF256
from .straggle import AdaptiveNwait, PoolLatencyModel, WorkerStats
from .trace import EpochRecord, EpochTracer, Event

__all__ = [
    "faults",
    "HedgedServer",
    "RequestHedge",
    "AdaptiveNwait",
    "PoolLatencyModel",
    "WorkerStats",
    "EpochTracer",
    "EpochRecord",
    "Event",
    "state_dict",
    "load_state_dict",
    "save",
    "restore",
    "RSGF256",
    "CodedCheckpoint",
    "CheckpointCorrupt",
    "TrainCheckpointer",
]


def __getattr__(name):
    # lazy: TrainCheckpointer pulls in torch; the rest of the utils
    # package stays importable without it
    if name == "TrainCheckpointer":
        from .train_checkpoint import TrainCheckpointer

        return TrainCheckpointer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
