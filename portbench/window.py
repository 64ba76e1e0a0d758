"""The measured window every driver runs, and what it shares around it.

:func:`measure` runs a driver's ``epoch(i)`` from the end of the set-up
for ``ctx.seconds``: closed (``in_flight`` 1: each epoch complete on the
card before the next, its latency read by :class:`Clock` from the
window's mark before the call to the ``epoch``'s own mark) or with up to
``in_flight`` epochs unfinished (the window waits on epoch i -
in_flight's completion event before it issues epoch i). The window
closes at the completion of the last epoch issued before ``seconds``
have passed; then ``close()`` (the driver's: release the stalls, drain
the pool) runs inside the profiler, so that every task dispatched lies
inside the trace. Spans: ``pb.window`` around it all, ``pb.epoch``
around each epoch, ``pb.sync`` and ``pb.wait`` where the host waits on
the card.

:func:`memory_peak` and :func:`collect` are the steps after it: the
program's peak, then its objects freed before the reference runs.
"""

from __future__ import annotations

import collections
import gc
import time
from types import SimpleNamespace

import torch

from . import trace


def sync(dev) -> None:
    """Wait for the current stream of ``dev`` (nothing on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


class Clock:
    """Latency of one closed-loop epoch: CUDA events on the card, the
    host's clock on the CPU."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self):
        return self.start()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def measure(ctx, epoch, close, clock: Clock, in_flight: int = 1):
    """Run ``epoch(i)`` (which returns ``clock.stop()``'s mark, or None
    with ``in_flight`` over 1) for ``ctx.seconds``, then ``close()``.
    Returns ``n_epochs``, ``window_s``, ``latency_ms`` (one an epoch
    when closed) and ``trace`` (the parsed trace of a traced run)."""
    dev, tracing = ctx.device, ctx.trace
    lat, done = [], collections.deque()
    with trace.profiler(tracing) as prof:
        with trace.span("pb.window", tracing):
            w0 = time.perf_counter()
            i = 0
            while time.perf_counter() - w0 < ctx.seconds:
                if len(done) >= in_flight:
                    with trace.span("pb.wait", tracing):
                        done.popleft().synchronize()
                with trace.span("pb.epoch", tracing):
                    t0 = clock.start() if in_flight == 1 else None
                    t1 = epoch(i)
                    if in_flight == 1:
                        with trace.span("pb.sync", tracing):
                            sync(dev)
                        lat.append(clock.ms(t0, t1))
                    elif dev.type == "cuda":
                        ev = torch.cuda.Event()
                        ev.record()
                        done.append(ev)
                i += 1
            with trace.span("pb.sync", tracing):
                sync(dev)
            w1 = time.perf_counter()
        close()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return SimpleNamespace(n_epochs=i, window_s=w1 - w0, latency_ms=lat,
                           trace=trace.read(prof) if tracing else None)


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def memory_peak(dev, check_bytes: int) -> int:
    """The allocator's peak on ``dev`` less what the check holds."""
    if dev.type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(dev) - check_bytes


def collect(dev) -> None:
    """Free what the caller dropped: the program's objects hold each
    other, so a collection frees them, then the allocator's cache."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
