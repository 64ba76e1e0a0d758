"""Jax-free utilities of the port: the counter-based generator
(:mod:`.prng`), the pool's epoch tracer (:mod:`.trace`), deterministic
fault injection (:mod:`.faults`), the straggler latency model and the
adaptive ``nwait`` controller (:mod:`.straggle`), hedged requests
(:mod:`.hedge`), pool checkpoints (:mod:`.checkpoint`) and the GF(256)
Reed-Solomon codec (:mod:`.rs_gf256`). Copies of the JAX package's
modules of the same names; its coded and training checkpoints
(``coded_checkpoint.py``, ``train_checkpoint.py``) are ROADMAP.md Queue 1
item 19."""

from . import faults
from .checkpoint import load_state_dict, restore, save, state_dict
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
]
