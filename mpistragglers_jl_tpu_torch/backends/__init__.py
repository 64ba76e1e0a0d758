"""Transports under the pool: the ``Backend`` contract, thread workers
(``LocalBackend``), CUDA streams (``CUDADeviceBackend``) and OS worker
processes over pipes (``ProcessBackend``) or the native C++ transport
(``NativeProcessBackend``).

Lazy, as the JAX package's: importing this package imports no torch
(``CUDADeviceBackend`` does, on first use) and builds nothing (the
native transport compiles at its first use)."""

from .base import Backend, SlotBackend, WorkerError, WorkerFailure
from .local import LocalBackend
from .process import ProcessBackend, RemoteWorkerError, WorkerProcessDied

__all__ = [
    "Backend",
    "SlotBackend",
    "WorkerError",
    "WorkerFailure",
    "LocalBackend",
    "CUDADeviceBackend",
    "ProcessBackend",
    "RemoteWorkerError",
    "WorkerProcessDied",
    "NativeProcessBackend",
]


def __getattr__(name):
    if name == "CUDADeviceBackend":
        from .cuda import CUDADeviceBackend

        return CUDADeviceBackend
    if name == "NativeProcessBackend":
        from .native import NativeProcessBackend

        return NativeProcessBackend
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
