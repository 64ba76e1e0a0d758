"""Driver of the gradient-coded SGD configurations: ``CodedSGD``.

Logistic regression with L2 on ``rows`` x ``dim`` float32 data drawn on
the card from the seed (``generator.logreg``), cut into n chunks; each
of the n stream workers holds its s + 1 cyclic chunks (the program's
``CodedSGD`` set-up, handed the benchmark's data: copies of the chunks,
as ``CodedSGD.synthetic`` makes them) and returns the code's combination
of their gradients. A step is the program's ``CodedSGD.step``: one
``asyncmap`` of the weights with ``nwait`` n - s, the decode of the
full-batch gradient from whichever workers arrived, and the update.

Set-up drives the program from zero weights through its first steps
(at least three; the warm-up), one after another. In the window the
payload of epoch ``e`` is the seed's weight vector ``W[e mod P]``, so
that every step is an answer of its own: the full-batch step from those
weights. The closed loop and the window are ``window.measure``'s.

The checks (``reference_logreg.py``, float64, after the window, the
program freed):

* ``step_err``, every epoch of the window: max |w' - w'_ref| / max
  |w'_ref - w|, w' the program's step from ``W[e mod P]``;
* ``grad_gap``: the first step's gradient as the update gives it, (w_0
  - w_1) / lr, against the reference's at w_0 = 0: the gap between their
  norms over the reference's norm;
* ``change_gap``: the same for the weights' change over the first three
  steps, the reference following them on its own.

The program's step computes no loss (its workers return gradients), so
no loss is compared. The spans: ``pb.asyncmap`` around the program's
``asyncmap`` inside the step (the driver wraps the name the step calls),
``pb.decode`` from its return to the step's (the decode weights, the
stack of the arrived gradients, the combination and the update).
``products_dispatched`` counts the tasks the stall gate saw.

The control (``tf32``) puts ``reference_logreg.step_tf32`` in the
program's place: the program runs, and each step's answer is the
reference's in TF32. The faults:

* ``stale``: the step returns the weights it was given;
* ``half``: each worker's chunk gradients are the mean over the first
  half of its rows (half of the batch left out, the mean over the rest);
* ``altered``: worker 0's coded gradient altered in one element, by its
  largest magnitude, where it is produced.
"""

from __future__ import annotations

import contextlib
import time
from unittest import mock

import torch

from portbench import (generator, harness, pool_gemm, reference_logreg,
                       trace, window)

CONTROLS = ("tf32",)


def _logreg():
    from mpistragglers_jl_tpu_torch.models import logreg

    return logreg


def _stale(monkeypatch):
    logreg = _logreg()
    real = logreg.CodedSGD.step

    def step(self, pool, w, lr, *a, **kw):
        real(self, pool, w, lr, *a, **kw)
        return torch.as_tensor(w, dtype=torch.float32)

    monkeypatch.setattr(logreg.CodedSGD, "step", step)


def _half(monkeypatch):
    logreg = _logreg()
    real = logreg._coded_grad

    def coded_grad(w, Xc, yc, coeffs):
        h = Xc.shape[1] // 2
        return real(w, Xc[:, :h], yc[:, :h], coeffs)

    monkeypatch.setattr(logreg, "_coded_grad", coded_grad)


def _altered(monkeypatch):
    logreg = _logreg()
    real = logreg.CodedSGD._work

    def work(self, i, payload, epoch):
        out = real(self, i, payload, epoch)
        if i == 0:
            out[0] += out.abs().max()
        return out

    monkeypatch.setattr(logreg.CodedSGD, "_work", work)


FAULTS = {"stale": _stale, "half": _half, "altered": _altered}


def build(cfg, X, y, device, *, delay_fn):
    """The program: ``CodedSGD`` over the benchmark's data."""
    logreg = _logreg()
    n, s = cfg["n"], cfg["s"]
    rows = X.shape[0] // n
    Xv, yv = X.view(n, rows, -1), y.view(n, rows)
    sgd = logreg.CodedSGD.__new__(logreg.CodedSGD)
    sgd._setup(X.shape[1], n, s, [device], delay_fn, float(cfg["l2"]),
               int(cfg["code_seed"]), lambda sup, dev: (Xv[sup], yv[sup]))
    return sgd


def _norm_gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    top = float(ref.norm())
    gap = abs(float(a.double().norm()) - top)
    return gap / top if top > 0 and gap == gap else float("inf")


def run(ctx) -> dict:
    from mpistragglers_jl_tpu_torch.pool import AsyncPool, waitall

    logreg = _logreg()
    cfg, tr, dev, tracing = ctx.cfg, ctx.traffic, ctx.device, ctx.trace
    if cfg["precision"] != "highest":
        raise ValueError("CodedSGD computes in float32 only")
    if tr["dispatch"] != "per_worker" or int(tr["in_flight"]) != 1:
        raise ValueError("a coded SGD step is one closed-loop asyncmap "
                         "with per-worker dispatch")
    rows, dim, n = cfg["rows"], cfg["dim"], cfg["n"]
    lr, l2 = float(cfg["lr"]), float(cfg["l2"])
    P = int(tr["payloads"])
    marks = [("harness", time.perf_counter())]
    X, y, W = generator.logreg(rows, dim, P, ctx.seed, dev)
    window.sync(dev)
    marks.append(("data", time.perf_counter()))
    # a gate on every run: it counts the tasks handed out
    gate = generator.StallGate(generator.stall_table(tr["stall"], cfg, n,
                                                     ctx.seed))
    sgd = build(cfg, X, y, dev, delay_fn=gate)
    pool = AsyncPool(n)
    nwait = int(cfg["nwait"])
    X_ctrl = reference_logreg.tf32(X) if ctx.control == "tf32" else None
    window.sync(dev)
    marks.append(("program", time.perf_counter()))

    clock = window.Clock(dev)
    host_ms, outs = [], []
    timed = [False]
    decode_span = contextlib.ExitStack()
    real_asyncmap = logreg.asyncmap

    def asyncmap(*a, **kw):
        h0 = time.perf_counter()
        with trace.span("pb.asyncmap", tracing):
            out = real_asyncmap(*a, **kw)
        if timed[0]:
            host_ms.append((time.perf_counter() - h0) * 1e3)
        decode_span.enter_context(trace.span("pb.decode", tracing))
        return out

    def step(w):
        w_new = sgd.step(pool, w, lr, nwait=nwait)
        decode_span.close()
        if X_ctrl is not None:  # the reference in TF32 in its place
            w_new = reference_logreg.step_tf32(
                X_ctrl, y, torch.as_tensor(w, device=dev), lr, l2)
        return w_new

    def epoch(i):
        outs.append(step(W[i % P]))
        return clock.stop()

    def close():  # no stall is waited out; every task dispatched drains
        gate.release()
        waitall(pool, sgd.backend, timeout=600.0)

    # the step calls the name ``asyncmap`` of its module: wrapped for the
    # spans and the pool's host time, from the warm-up to the close
    with mock.patch.object(logreg, "asyncmap", asyncmap):
        chain = [torch.zeros(dim, device=dev)]
        for _ in range(max(3, int(tr.get("warmup_epochs", 2)))):
            chain.append(step(chain[-1]))
            window.sync(dev)
        setup_parts, setup_cpu = harness.setup_parts(ctx, marks)
        timed[0] = True
        calls0 = sum(gate.calls)
        win = window.measure(ctx, epoch, close, clock)
    n_epochs = win.n_epochs
    dispatched = sum(gate.calls) - calls0
    check_bytes = window.nbytes(outs)
    memory_peak = window.memory_peak(dev, check_bytes)
    s = sgd.s
    sgd.backend.shutdown()
    pool.results = [None] * n
    del sgd, pool, X_ctrl
    window.collect(dev)

    ref = reference_logreg.step(X, y, W.T, lr, l2).T  # (P, dim)
    step_err = []
    for e, w_out in enumerate(outs):
        p = e % P
        top = float((ref[p] - W[p].double()).abs().max())
        gap = float((w_out.double() - ref[p]).abs().max())
        step_err.append(gap / top if gap == gap else float("inf"))
    w_ref = [torch.zeros(dim, dtype=torch.float64, device=dev)]
    for _ in range(3):
        w_ref.append(reference_logreg.step(X, y, w_ref[-1][:, None], lr,
                                           l2)[:, 0])
    grad_gap = _norm_gap((chain[0] - chain[1]) / lr,
                         (w_ref[0] - w_ref[1]) / lr)
    change_gap = _norm_gap(chain[3] - chain[0], w_ref[3] - w_ref[0])

    return {
        "setup_parts": setup_parts,
        "setup_cpu_s": setup_cpu,
        "precision": pool_gemm.PRECISION[cfg["precision"]],
        "window_s": win.window_s,
        "n_epochs": n_epochs,
        "latency_ms": win.latency_ms,
        "asyncmap_host_ms": host_ms,
        # the full-batch gradient's forward and backward products; the
        # code's s + 1 copies of each chunk are not counted
        "useful_flops_per_epoch": 4 * rows * dim,
        "product_flops": 4 * (s + 1) * (rows // n) * dim,
        "product_bytes": (s + 1) * (rows // n) * dim * 4,
        "products_dispatched": dispatched,
        "trace": win.trace,
        "memory_peak_bytes": memory_peak,
        "memory_check_bytes": check_bytes,
        "checks": {"step_err": step_err, "grad_gap": [grad_gap],
                   "change_gap": [change_gap]},
        "check_epochs": {"step_err": list(range(n_epochs)),
                         "grad_gap": [-1], "change_gap": [-1]},
    }
