"""The window of a coded-GEMM cell, shared by the coded-GEMM drivers.

A driver builds the program under test (``build``) from the operands
and the traffic's dispatch mode; this module runs it. An epoch is the
program's own path: ``pool.asyncmap`` of payload ``e mod P`` with the
code's ``nwait``, then the program's decode of the full product on the
device. The window (``window.measure``) keeps at most ``in_flight``
epochs unfinished: with 1 it is closed, and the epoch's latency is the
call on an idle stream to the decoded product.

Inside the window, after each decode, the benchmark takes its check
(span ``pb.check``): the product's projection on the probe vector ``v``
for every epoch, and a copy of the whole product for the epochs the
seeded reservoir picks. Once the window has closed, the stalls are
released, the pool drained and the program freed, the plain reference
(``reference.py``) judges both: ``proj_err`` and ``full_err`` against
``A @ B`` of the f32 operands. Where a configuration stores its blocks
below f32 (``"default"``: bf16), that rounding, amplified by the decode
through the parity shards, hides a product rounded below what the
configuration states; so the rows of the blocks that a systematic shard
fresh at return delivered straight (the program's ``direct``; an MDS
decode from the first k fresh shards uses every fresh systematic one)
are judged again, ``proj_err_direct`` and ``full_err_direct``, against
the product of the operands as stored, in float64.

``memory_peak_bytes`` is the peak the program and its inputs reach on
the card: the allocator's peak less what the check holds, the
reservoir (allocated first) and the projections (one vector an epoch;
the program reaches its peak in every epoch, so at the last one all
but that epoch's are held).

What the coded-GEMM drivers declare (``harness``): the controls, each
the program's products one step below a precision a configuration
states (``tf32``: f32 products in TF32, cuBLAS's own mode; ``fp8``:
bf16 products with operands rounded to float8 e4m3 under a per-tensor
power-of-two scale, f32 sums, a mode the program lacks; ``bf16_out``:
bf16 products rounded to bf16 where they are made, for the f32 products
a ``"default"`` configuration states); and the faults:

* ``stale``: the decode returns its first product every epoch (a step
  that returns its state unchanged);
* ``half``: the decoded product's second half of rows left out (zeros);
* ``altered``: every worker's product altered in one element where it
  is produced.

The cells run on one chip, so no exchange between chips can be left out.
"""

from __future__ import annotations

import contextlib
import sys
import time
from types import SimpleNamespace
from unittest import mock

import torch

from . import bounds, generator, harness, reference, trace, window

# the products' precision as the bounds name it
PRECISION = {"highest": "f32", "default": "bf16"}
FP8_MAX = 448.0  # float8 e4m3's largest finite value


def program(backend, nwait, decode, *, k, block_rows, direct=None):
    """What ``build`` of ``drivers/<driver>.py`` returns: the pool
    backend, the code's ``nwait``, ``decode(pool) -> (m, ncols)`` product
    on the device, the shapes the bounds count (k shards of
    ``block_rows`` rows) and, for a systematic code, ``direct(fresh)``:
    the row blocks the decode takes straight from a shard, given the
    workers fresh at return (a boolean array)."""
    return SimpleNamespace(backend=backend, nwait=nwait, decode=decode, k=k,
                           block_rows=block_rows, direct=direct)


def _matmul_sites():
    """Where the workers' products are made: ``ops/gemm.py``'s per-worker
    product and ``ops/_batch.py``'s stacked one."""
    from mpistragglers_jl_tpu_torch.ops import _batch, gemm

    return [(gemm, "matmul"), (_batch, "matmul")]


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor power-of-two scale
    (its largest magnitude brought just under e4m3's largest), as
    bfloat16, which holds each such value exactly."""
    amax = x.abs().amax().float().clamp_min(1e-30)
    scale = torch.exp2(torch.floor(torch.log2(FP8_MAX / amax)))
    q = (x.float() * scale).to(torch.float8_e4m3fn).float()
    return (q / scale).to(torch.bfloat16)


@contextlib.contextmanager
def _tf32():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def _products(wrap):
    """Every worker's product made by ``wrap(matmul)`` in place of the
    program's ``matmul``."""
    with contextlib.ExitStack() as stack:
        for mod, name in _matmul_sites():
            stack.enter_context(
                mock.patch.object(mod, name, wrap(getattr(mod, name))))
        yield


def _fp8():
    return _products(lambda mm: lambda a, b, precision:
                     mm(fp8(a), fp8(b), precision))


def _bf16_out():
    return _products(lambda mm: lambda a, b, precision:
                     mm(a, b, precision).to(torch.bfloat16).float())


CONTROLS = {"tf32": _tf32, "fp8": _fp8, "bf16_out": _bf16_out}


def _stale(decode):
    first = []

    def wrapped(pool):
        C = decode(pool)
        if not first:
            first.append(C.clone())
        return first[0]
    return wrapped


def _half(decode):
    def wrapped(pool):
        C = decode(pool).clone()
        C[C.shape[0] // 2:] = 0
        return C
    return wrapped


def _wrap_decode(wrap):
    def plant(monkeypatch):
        build = program

        def wrapped(backend, nwait, decode, **kw):
            return build(backend, nwait, wrap(decode), **kw)

        monkeypatch.setattr(sys.modules[__name__], "program", wrapped)
    return plant


def _altered(monkeypatch):
    def altering(matmul):
        def wrapped(a, b, precision):
            out = matmul(a, b, precision)
            out.reshape(-1)[0] += 1.0
            return out
        return wrapped

    for mod, name in _matmul_sites():
        monkeypatch.setattr(mod, name, altering(getattr(mod, name)))


FAULTS = {"stale": _wrap_decode(_stale), "half": _wrap_decode(_half),
          "altered": _altered}


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
    window.sync(dev)
    marks.append(("operands", time.perf_counter()))
    table = generator.stall_table(tr["stall"], cfg, n, ctx.seed)
    gate = generator.StallGate(table) if table.any() else None
    control = contextlib.ExitStack()
    if ctx.control is not None:  # the program's products one step down
        control.enter_context(CONTROLS[ctx.control]())
    prog = build(cfg, A, dev, delay_fn=gate,
                 batch=tr["dispatch"] == "coalesced",
                 batch_arrival=tr.get("batch_arrival", "ready"))
    pool = AsyncPool(n)
    window.sync(dev)
    marks.append(("program", time.perf_counter()))
    # the blocks delivered straight by a systematic shard are judged
    # against the operands as stored where they are rounded below f32
    by_block = prog.direct is not None and cfg["precision"] != "highest"
    proj = []  # the window's projections, one an epoch
    clock = window.Clock(dev)
    host_ms, fresh, direct = [], [], []
    tracer = None

    def epoch(i: int, timed: bool):
        h0 = time.perf_counter()
        with trace.span("pb.asyncmap", tracing):
            repochs = asyncmap(pool, B[i % P], prog.backend,
                               nwait=prog.nwait, tracer=tracer)
        h1 = time.perf_counter()
        at_return = repochs == pool.epoch
        with trace.span("pb.decode", tracing):
            C = prog.decode(pool)
        t1 = clock.stop() if timed and in_flight == 1 else None
        with trace.span("pb.check", tracing):
            p = torch.mv(C, v)
            if timed:
                proj.append(p)
                j = sampler.slot(i)
                if j is not None:
                    samples[j].copy_(C)
        if timed:
            host_ms.append((h1 - h0) * 1e3)
            fresh.append(int(at_return.sum()))
            if by_block:
                direct.append(prog.direct(at_return))
        return t1

    for i in range(int(tr.get("warmup_epochs", 2))):
        epoch(i, timed=False)
        window.sync(dev)
    setup_parts, setup_cpu = harness.setup_parts(ctx, marks)

    def close():  # no stall is waited out; every task dispatched drains
        if gate is not None:
            gate.release()
        waitall(pool, prog.backend, timeout=600.0)

    tracer = EpochTracer() if tracing else None
    win = window.measure(ctx, lambda i: epoch(i, timed=True), close, clock,
                         in_flight)
    check_bytes = window.nbytes([samples, *proj])
    memory_peak = window.memory_peak(dev, check_bytes)
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
    window.collect(dev)
    control.close()

    n_epochs = win.n_epochs
    names = ["proj_err", "full_err"]
    if by_block:
        names += ["proj_err_direct", "full_err_direct"]
        Aq = reference.as_stored(A, cfg["precision"])
    checks = {name: {} for name in names}  # {epoch: value}

    def rows(blocks):
        return [(b * block_rows, min((b + 1) * block_rows, m))
                for b in blocks]

    for p in range(P):
        ref = reference.projection(A, B[p], v)
        idx = range(p, n_epochs, P)
        for i in idx:
            checks["proj_err"][i] = reference.proj_rel_err(proj[i], ref)
        if by_block:
            ref = reference.projection(Aq, reference.as_stored(
                B[p], cfg["precision"]), v)
            for i in idx:
                checks["proj_err_direct"][i] = reference.proj_rel_err(
                    proj[i], ref, rows(direct[i]))
        del ref
    for j, e in enumerate(sampler.epochs):
        if e < 0:
            continue
        checks["full_err"][e] = reference.rel_err(samples[j], A, B[e % P])
        if by_block:
            checks["full_err_direct"][e] = reference.rel_err(
                samples[j], Aq,
                reference.as_stored(B[e % P], cfg["precision"]),
                rows(direct[e]))

    return {
        "setup_parts": setup_parts,
        "setup_cpu_s": setup_cpu,
        "precision": PRECISION[cfg["precision"]],
        "window_s": win.window_s,
        "n_epochs": n_epochs,
        "latency_ms": win.latency_ms,
        "asyncmap_host_ms": host_ms,
        "fresh_at_return": fresh,
        "k": k,
        "variable_nwait": variable_nwait,
        "useful_flops_per_epoch": 2 * m * kdim * ncols,
        "product_flops": bounds.product_flops(block_rows, kdim, ncols),
        "products_dispatched": dispatched,
        "decode_bytes": bounds.decode_bytes(k, block_rows, ncols),
        "decode_flops": bounds.decode_flops(k, block_rows, ncols),
        "trace": win.trace,
        "memory_peak_bytes": memory_peak,
        "memory_check_bytes": check_bytes,
        "checks": {name: list(c.values()) for name, c in checks.items()},
        "check_epochs": {name: list(c) for name, c in checks.items()},
    }
