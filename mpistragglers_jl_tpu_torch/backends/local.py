"""Thread-pool worker backend: the fast, fake-able transport.

A copy of the JAX package's ``backends/local.py`` (numpy only).

The reference has no in-process backend at all — its only execution mode is
``mpiexec`` spawning real OS processes, and its test harness shells out to
``mpiexec -n N julia`` per scenario (test/runtests.jl:17), which SURVEY §4
calls out as the weakness to fix. :class:`LocalBackend` is that fix: pure
numpy worker threads with *deterministic* straggler injection replacing the
reference's ``sleep(rand())`` (examples/iterative_example.jl:74,
test/kmap2.jl:95). The worker loop itself lives in
:class:`~.base.MailboxBackend`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .base import MailboxBackend, DelayFn

WorkFn = Callable[[int, np.ndarray, int], object]


class LocalBackend(MailboxBackend):
    """n worker threads computing ``work_fn(worker_index, payload, epoch)``.

    Parameters
    ----------
    work_fn:
        The worker computation. Receives the pool-local worker index, a
        private snapshot of the dispatched payload, and the epoch it was
        dispatched at (so workloads can echo it, as the reference tests
        make workers do — test/kmap2.jl:92-94).
    n_workers:
        Pool size.
    delay_fn:
        Deterministic latency injection: seconds to stall before
        computing, as a function of ``(worker_index, epoch)``.
    """

    def __init__(
        self,
        work_fn: WorkFn,
        n_workers: int,
        *,
        delay_fn: DelayFn | None = None,
    ):
        self.work_fn = work_fn
        super().__init__(
            n_workers, delay_fn=delay_fn, join_timeout=1.0,
            thread_name="local-worker",
        )

    def _snapshot(self, i: int, sendbuf, epoch: int) -> np.ndarray:
        # host copy: the reference's per-worker isendbuf discipline
        # (src/MPIAsyncPools.jl:130) — in-flight sends survive caller
        # mutation of sendbuf
        return np.array(sendbuf, copy=True)

    def _compute(self, i: int, payload: np.ndarray, epoch: int):
        return self.work_fn(i, payload, epoch)
