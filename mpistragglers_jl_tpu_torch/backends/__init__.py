"""Transports under the pool: the ``Backend`` contract, thread workers
(``LocalBackend``) and CUDA streams (``CUDADeviceBackend``)."""

from .base import Backend, SlotBackend, WorkerError, WorkerFailure
from .cuda import CUDADeviceBackend
from .local import LocalBackend

__all__ = [
    "Backend",
    "SlotBackend",
    "WorkerError",
    "WorkerFailure",
    "LocalBackend",
    "CUDADeviceBackend",
]
