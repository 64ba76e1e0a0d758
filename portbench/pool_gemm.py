"""The window of a coded-GEMM cell, shared by the coded-GEMM drivers.

A driver builds the program under test (``build``) from the operands
and the traffic's dispatch mode; this module runs it. An epoch is the
program's own path: ``pool.asyncmap`` of payload ``e mod P`` with the
code's ``nwait``, then the program's decode of the full product on the
device. The loop keeps at most ``in_flight`` epochs unfinished: with 1
it is closed (each decoded product is complete on the card before the
next call, and the epoch's latency is read from CUDA events around it:
the call on an idle stream to the decoded product); with 2 or more, the
harness waits on epoch e - in_flight's completion event before it
issues epoch e.

The window runs from the first ``asyncmap`` after the warm-up to the
completion of the last epoch issued before ``seconds`` have passed.
Inside it, after each decode, the benchmark takes its check (span
``pb.check``): the product's projection on the probe vector ``v`` for
every epoch, and a copy of the whole product for the epochs the seeded
reservoir picks. Once the window has closed, the stalls are released,
the pool drained and the program freed, the plain reference
(``reference.py``) judges both.

``memory_peak_bytes`` is the peak the program and its inputs reach on
the card: the allocator's peak less what the check holds, the
reservoir (allocated first) and the projections (one vector an epoch;
the program reaches its peak in every epoch, so at the last one all
but that epoch's are held).
"""

from __future__ import annotations

import collections
import resource
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import bounds, generator, reference, trace


def program(backend, nwait, decode, *, k, block_rows):
    """What ``build`` of ``drivers/<driver>.py`` returns: the pool
    backend, the code's ``nwait``, ``decode(pool) -> (m, ncols)`` product
    on the device, and the shapes the bounds count (k shards of
    ``block_rows`` rows)."""
    return SimpleNamespace(backend=backend, nwait=nwait, decode=decode, k=k,
                           block_rows=block_rows)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


class _Clock:
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


def _bytes(t) -> int:
    return t.numel() * t.element_size()


def run(ctx, build) -> dict:
    from mpistragglers_jl_tpu_torch.pool import AsyncPool, asyncmap, waitall
    from mpistragglers_jl_tpu_torch.utils.trace import EpochTracer

    cfg, tr, dev, tracing = ctx.cfg, ctx.traffic, ctx.device, ctx.trace
    m, kdim, ncols, n = cfg["m"], cfg["kdim"], cfg["ncols"], cfg["n"]
    P, in_flight = int(tr["payloads"]), int(tr["in_flight"])
    marks = [("harness", time.perf_counter())]
    sampler = generator.Reservoir(int(cfg["check_sample"]), ctx.seed)
    samples = torch.empty(sampler.size, m, ncols, device=dev)
    A, B, v = generator.operands(m, kdim, ncols, P, ctx.seed, dev)
    _sync(dev)
    marks.append(("operands", time.perf_counter()))
    table = generator.stall_table(tr["stall"], cfg, n, ctx.seed)
    gate = generator.StallGate(table) if table.any() else None
    if ctx.control == "tf32":  # the control: the program's products in TF32
        torch.backends.cuda.matmul.allow_tf32 = True
    prog = build(cfg, A, dev, delay_fn=gate,
                 batch=tr["dispatch"] == "coalesced",
                 batch_arrival=tr.get("batch_arrival", "ready"))
    pool = AsyncPool(n)
    _sync(dev)
    marks.append(("program", time.perf_counter()))
    proj = []  # the window's projections, one an epoch
    clock = _Clock(dev)
    lat, host_ms, fresh = [], [], []
    tracer = None

    def epoch(i: int, timed: bool):
        t0 = clock.start() if timed and in_flight == 1 else None
        h0 = time.perf_counter()
        with trace.span("pb.asyncmap", tracing):
            repochs = asyncmap(pool, B[i % P], prog.backend,
                               nwait=prog.nwait, tracer=tracer)
        h1 = time.perf_counter()
        n_fresh = int((repochs == pool.epoch).sum())
        with trace.span("pb.decode", tracing):
            C = prog.decode(pool)
        t1 = clock.stop() if t0 is not None else None
        with trace.span("pb.check", tracing):
            p = torch.mv(C, v)
            if timed:
                proj.append(p)
                j = sampler.slot(i)
                if j is not None:
                    samples[j].copy_(C)
        if timed:
            host_ms.append((h1 - h0) * 1e3)
            fresh.append(n_fresh)
        return t0, t1

    for i in range(int(tr.get("warmup_epochs", 2))):
        epoch(i, timed=False)
        _sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    usage = resource.getrusage(resource.RUSAGE_SELF)
    marks.append(("warm-up", time.perf_counter()))
    marks = list(ctx.marks) + marks
    setup_parts = {marks[0][0]: marks[0][1] - ctx.t_start}
    for (_, t0), (name, t1) in zip(marks, marks[1:]):
        setup_parts[name] = t1 - t0

    tracer = EpochTracer() if tracing else None
    done = collections.deque()
    prof_cm = trace.profiler(tracing)
    with prof_cm as prof:
        with trace.span("pb.window", tracing):
            w0 = time.perf_counter()
            i = 0
            while time.perf_counter() - w0 < ctx.seconds:
                if len(done) >= in_flight:
                    with trace.span("pb.wait", tracing):
                        done.popleft().synchronize()
                with trace.span("pb.epoch", tracing):
                    t0, t1 = epoch(i, timed=True)
                    if in_flight == 1:
                        with trace.span("pb.sync", tracing):
                            _sync(dev)
                        lat.append(clock.ms(t0, t1))
                    elif dev.type == "cuda":
                        ev = torch.cuda.Event()
                        ev.record()
                        done.append(ev)
                i += 1
            with trace.span("pb.sync", tracing):
                _sync(dev)
            w1 = time.perf_counter()
        # the close: no stall is waited out; every task dispatched is
        # drained, so its product lies inside the trace
        if gate is not None:
            gate.release()
        waitall(pool, prog.backend, timeout=600.0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    n_epochs = i
    traced = trace.read(prof) if tracing else None
    check_bytes = _bytes(samples) + sum(_bytes(p) for p in proj)
    memory_peak = (torch.cuda.max_memory_allocated(dev) - check_bytes
                   if dev.type == "cuda" else 0)
    dispatched = None
    if tracer is not None:
        dispatched = sum(1 for r in tracer.records for e in r.events
                         if e.kind in ("dispatch", "retask"))

    # the program's state goes before the reference runs
    prog.backend.shutdown()
    pool.results = [None] * n
    k, block_rows = prog.k, prog.block_rows
    variable_nwait = callable(prog.nwait)
    del prog, pool
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    proj_err = np.zeros(n_epochs)
    for p in range(P):
        ref = reference.projection(A, B[p], v)
        idx = list(range(p, n_epochs, P))
        for i in idx:
            proj_err[i] = reference.proj_rel_err(proj[i], ref)
        del ref
    full_err = {e: reference.rel_err(samples[j], A, B[e % P])
                for j, e in enumerate(sampler.epochs) if e >= 0}

    return {
        "setup_s": setup_s,
        "setup_parts": setup_parts,
        "setup_cpu_s": {"user": usage.ru_utime, "sys": usage.ru_stime},
        "window_s": w1 - w0,
        "n_epochs": n_epochs,
        "latency_ms": lat,
        "asyncmap_host_ms": host_ms,
        "fresh_at_return": fresh,
        "k": k,
        "variable_nwait": variable_nwait,
        "useful_flops_per_epoch": 2 * m * kdim * ncols,
        "product_flops": bounds.product_flops(block_rows, kdim, ncols),
        "products_dispatched": dispatched,
        "decode_bytes": bounds.decode_bytes(k, block_rows, ncols),
        "decode_flops": bounds.decode_flops(k, block_rows, ncols),
        "trace": traced,
        "memory_peak_bytes": memory_peak,
        "memory_check_bytes": check_bytes,
        "checks": {"proj_err": proj_err.tolist(),
                   "full_err": list(full_err.values())},
        "check_epochs": {"proj_err": list(range(n_epochs)),
                         "full_err": list(full_err.keys())},
    }
