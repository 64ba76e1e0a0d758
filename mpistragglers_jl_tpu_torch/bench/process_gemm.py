"""BASELINE config 2 over OS worker processes that compute on the card.

    python -m mpistragglers_jl_tpu_torch.bench.process_gemm
        [--epochs 10] [--chains 3] [--m 4096] [--seed 0]
        [--device cuda|cpu] [--respawn] [--streams]

Uncoded row-block GEMM, ``4096^3`` f32 with TF32 off, 4 workers,
``nwait=4`` (``bench/coded_gemm.py`` ``config2``), but every worker is a
spawned OS process (``ProcessBackend`` over pipes and shared-memory
rings, or ``NativeProcessBackend`` over the C++ transport) with its own
CUDA context. Each worker makes ``A`` on its card from the seed once, as
``bench/coded_gemm.py`` ``_operands`` does, and keeps its ``m/n`` row
block; each epoch the coordinator broadcasts ``B`` (64 MiB) from the
host through the transport, every worker copies it to its card,
multiplies, and returns its block (16 MiB) to the host ``recvbuf``.

Prints the card's name and power limit, then one JSON line per backend:
ms/epoch (the least of ``--chains`` chains of ``--epochs`` epochs, host
wall clock: an epoch ends with every block in ``recvbuf``), the
slowest worker's task ms an epoch from the workers' telemetry spans
over the fastest chain (payload to the card, product, result to the
host) and the rest of the epoch as transport ms,
worker start-up seconds (every backend's workers start together, from
construction to the end of the backend's first epoch; each backend is
then timed alone while the others idle), and max|C - C_ref| / max|C_ref|
against one on-card ``torch.matmul`` held to ``REL_TOL["highest"]``. ``--respawn``
adds a run on ``NativeProcessBackend`` where worker 2 exits with code 9
in the fifth of 10 epochs: the pool must raise ``WorkerFailure``, then
``respawn(2)``, and the last four epochs must equal the first
bit for bit. ``--streams`` runs config 2 on CUDA streams
(``bench/coded_gemm.py``) in the same process for comparison.

The processes share one card: without MPS their kernels time-slice, so
an epoch's four products run one after another. ``--device cpu`` runs
the same path on the host at a small ``--m`` (the tests).
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
import warnings

import numpy as np

from ..obs.metrics import MetricsRegistry
from ..pool import AsyncPool, asyncmap, waitall

UNCODED_M, UNCODED_WORKERS = 4096, 4  # BASELINE config 2
RESPAWN_WORKER, RESPAWN_EPOCH, RESPAWN_EPOCHS = 2, 5, 10
RESPAWN_BASE = 1000  # the respawn run's epochs are 1001..1010


class RowBlockWork:
    """``(i, B, epoch) -> A_i @ B`` on this worker process's device.

    ``A`` is made from ``seed`` on the device at the first task, exactly
    as ``bench/coded_gemm.py`` ``_operands`` makes it, and only the
    worker's row block is kept. ``B`` arrives as a read-only view of
    transport memory: it is copied to the device (never written), and
    the view is dropped before the result leaves, so its ring slot is
    free again. The result is a device tensor, which the transport
    copies to the host. ``die_at=(worker, epoch)`` makes that worker
    exit with code 9 at that epoch (a crashed rank)."""

    def __init__(self, m: int, n_workers: int, seed: int = 0,
                 device: str | None = None, die_at=None):
        self.m, self.n_workers, self.seed = int(m), int(n_workers), seed
        self.device = device
        self.die_at = None if die_at is None else tuple(die_at)
        self._a = None

    def __getstate__(self):
        return {**self.__dict__, "_a": None}

    def prepare(self, i: int):
        """Make worker ``i``'s row block of ``A`` on its device (the
        first task does this when nobody called it before)."""
        import torch

        from .._device import resolve_device
        from .coded_gemm import _operands

        torch.backends.cuda.matmul.allow_tf32 = False
        dev = resolve_device(self.device)
        A, _ = _operands(self.m, self.m, self.m, self.seed, dev)
        rows = self.m // self.n_workers
        self._a = A[i * rows:(i + 1) * rows].clone()
        return self._a

    def __call__(self, i: int, payload, epoch: int):
        import torch

        if self.die_at == (i, epoch):
            os._exit(9)
        a = self._a if self._a is not None else self.prepare(i)
        with warnings.catch_warnings():
            # read-only view: torch warns, but nothing writes to it
            warnings.simplefilter("ignore", UserWarning)
            host = torch.from_numpy(payload)
        b = host.to(a.device, copy=True)
        del host, payload
        return torch.matmul(a, b)


def _reference(m: int, seed: int, device):
    """(B on the host, C_ref) from the seed: ``torch.matmul`` of the
    same operands on ``device``."""
    import torch

    from .coded_gemm import _operands

    A, B = _operands(m, m, m, seed, device)
    C_ref = torch.matmul(A, B)
    return B.cpu().numpy(), C_ref


def _make_backend(kind: str, work, n: int, registry):
    if kind == "process":
        from ..backends.process import ProcessBackend

        return ProcessBackend(work, n, registry=registry)
    from ..backends.native import NativeProcessBackend

    return NativeProcessBackend(work, n, registry=registry)


def _task_ms(backend, epochs) -> tuple[float, float]:
    """From the workers' telemetry spans over ``epochs`` (the fastest
    chain's): (the slowest worker's task ms, the sum of the workers'
    task ms), per epoch."""
    by_epoch: dict[int, list[float]] = {}
    for rec in backend.aggregator.recorders():
        for _track, _name, _t0, dur, args in rec.spans:
            e = args.get("epoch")
            if e in epochs:
                by_epoch.setdefault(e, []).append(dur * 1e3)
    if not by_epoch:
        return float("nan"), float("nan")
    return (float(np.mean([max(v) for v in by_epoch.values()])),
            float(np.mean([sum(v) for v in by_epoch.values()])))


def _rel_err(C: np.ndarray, C_ref) -> float:
    import torch

    got = torch.from_numpy(C).to(C_ref.device)
    return float((got - C_ref).abs().max() / C_ref.abs().max())


def _rung(backend, B, C_ref, *, epochs, chains, respawn, first) -> dict:
    """One started backend's timed chains (and respawn run)."""
    from .coded_gemm import REL_TOL

    n = backend.n_workers
    pool, C = first
    want = C.copy()
    best, epoch, timed = None, 1, []
    for _ in range(chains):
        ts = time.perf_counter()
        chain = []
        for _ in range(epochs):
            epoch += 1
            asyncmap(pool, B, backend, C, nwait=n, epoch=epoch)
            chain.append(epoch)
        ms = (time.perf_counter() - ts) * 1e3 / epochs
        if best is None or ms < best:
            best, timed = ms, chain
    waitall(pool, backend, C)
    out = {"ms_per_epoch": best, "rel_err": _rel_err(C, C_ref),
           "rel_tol": REL_TOL["highest"],
           "bit_equal_across_epochs": bool(np.array_equal(C, want)),
           # reported, not required: the workers' row-block products
           # and the one full product may take different cuBLAS kernels
           "bit_equal_to_reference": bool(
               np.array_equal(C, C_ref.cpu().numpy()))}
    if respawn:
        out["respawn"] = _respawn_run(pool, backend, B, C, want)
    out["timed_epochs"] = timed
    return out


def run(kinds=("process", "native"), *, m=UNCODED_M,
        n_workers=UNCODED_WORKERS, seed=0, epochs=10, chains=3,
        device=None, respawn=False) -> list[dict]:
    """Every backend's rung (see the module docstring). All backends'
    workers start together (one warm-up epoch dispatched to each, then
    harvested), then each backend is timed alone while the others'
    workers idle. ``respawn`` adds the respawn run on ``native``."""
    import torch

    from .._device import resolve_device

    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    B, C_ref = _reference(m, seed, dev)
    rigs = []
    t0 = time.perf_counter()
    try:
        for kind in kinds:
            die = respawn and kind == "native"
            work = RowBlockWork(
                m, n_workers, seed,
                device=None if dev.type == "cuda" else str(dev),
                die_at=((RESPAWN_WORKER, RESPAWN_BASE + RESPAWN_EPOCH)
                        if die else None))
            reg = MetricsRegistry()
            rigs.append({"kind": kind, "reg": reg, "respawn": die,
                         "backend": _make_backend(kind, work, n_workers,
                                                  reg),
                         "pool": AsyncPool(n_workers),
                         "C": np.empty((m, m), np.float32)})
        for r in rigs:  # the warm-up epoch on every backend at once
            asyncmap(r["pool"], B, r["backend"], r["C"], nwait=0, epoch=1)
        for r in rigs:
            waitall(r["pool"], r["backend"], r["C"])
            r["startup_s"] = time.perf_counter() - t0
        for r in rigs:
            r["out"] = _rung(r["backend"], B, C_ref,
                             epochs=epochs, chains=chains,
                             respawn=r["respawn"],
                             first=(r["pool"], r["C"]))
    finally:
        # the backends' workers exit (and free their CUDA contexts)
        # together
        stops = [threading.Thread(target=r["backend"].shutdown)
                 for r in rigs]
        for t in stops:
            t.start()
        for t in stops:
            t.join()
    results = []
    for r in rigs:
        o, backend = r["out"], r["backend"]
        task, task_sum = _task_ms(backend, set(o.pop("timed_epochs")))
        o = {"backend": r["kind"], "m": m, "n_workers": n_workers,
             "nwait": n_workers, "precision": "highest",
             "payload_mib": B.nbytes / 2 ** 20,
             "result_mib_per_worker": m * m * 4 / n_workers / 2 ** 20,
             "startup_s": r["startup_s"], **o,
             "worker_task_ms": task, "worker_task_sum_ms": task_sum,
             "transport_ms": o["ms_per_epoch"] - task,
             "epochs_chained": epochs, "chains_min_of": chains,
             "worker_spans": sum(len(rec.spans)
                                 for rec in backend.aggregator.recorders()),
             "worker_tasks": sum(s.value for s in r["reg"]
                                 if s.name == "worker_tasks_total")}
        o["ok"] = bool(o["rel_err"] <= o["rel_tol"]
                       and o["bit_equal_across_epochs"]
                       and (not r["respawn"] or o["respawn"]["ok"]))
        results.append(o)
    return results


def _respawn_run(pool, backend, B, C, want) -> dict:
    """Worker ``RESPAWN_WORKER`` exits at epoch ``RESPAWN_EPOCH`` of
    ``RESPAWN_EPOCHS``: the harvest raises ``WorkerFailure``, the rank is
    respawned, and the later epochs must give ``want`` bit for bit."""
    from ..backends.base import WorkerFailure

    n = pool.n_workers
    failed, exact = None, []
    t_respawn = None
    for k in range(1, RESPAWN_EPOCHS + 1):
        e = RESPAWN_BASE + k
        try:
            asyncmap(pool, B, backend, C, nwait=n, epoch=e)
        except WorkerFailure as err:
            failed = {"epoch": k, "worker": err.worker,
                      "cause": type(err.error).__name__}
            waitall(pool, backend)  # the others' tasks of this epoch
            t0 = time.perf_counter()
            backend.respawn(err.worker)
            t_respawn = time.perf_counter() - t0
            continue
        if k > RESPAWN_EPOCH:
            exact.append(bool(np.array_equal(C, want)))
    waitall(pool, backend, C)
    ok = (failed is not None and failed["epoch"] == RESPAWN_EPOCH
          and failed["worker"] == RESPAWN_WORKER
          and len(exact) == RESPAWN_EPOCHS - RESPAWN_EPOCH and all(exact))
    return {"failure": failed, "respawn_s": t_respawn,
            "exact_after": exact, "dead_after": backend.dead_workers(),
            "ok": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--chains", type=int, default=3)
    ap.add_argument("--m", type=int, default=UNCODED_M)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--respawn", action="store_true")
    ap.add_argument("--streams", action="store_true")
    args = ap.parse_args(argv)
    import torch

    on_card = args.device is None or args.device.startswith("cuda")
    if on_card:
        from .decode_kernel_attrib import card

        name, smi = card()
        print(f"device: {name}, torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}")
        print(smi)
    ok = True
    for res in run(m=args.m, seed=args.seed, epochs=args.epochs,
                   chains=args.chains, device=args.device,
                   respawn=args.respawn):
        if on_card:
            res["card"] = smi
        print(json.dumps(res), flush=True)
        ok &= res["ok"]
    if args.streams and on_card:
        from .coded_gemm import config2

        res = config2(torch.device("cuda", 0), seed=args.seed)
        res["card"] = smi
        print(json.dumps({"streams": res}), flush=True)
        ok &= res["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
