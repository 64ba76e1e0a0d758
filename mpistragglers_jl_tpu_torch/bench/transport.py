"""Transport microbenchmark of the port's host backends.

    python -m mpistragglers_jl_tpu_torch.bench.transport [--epochs 200]

A port of the JAX package's ``benchmarks/transport_bench.py``: the
coordinator-side cost of the pool's hot path (dispatch -> wait ->
harvest) with trivial worker compute, so the numbers are the
transport's. Workers are spawned OS processes that import no torch.

* round trip: an 8-byte payload, 1 worker, ``nwait=1``, ``--epochs``
  epochs, for ``pipes`` (``ProcessBackend``) and ``native``
  (``NativeProcessBackend``); us/epoch;
* broadcast: a 4 MiB payload to 4 workers with full gather, each worker
  summing its payload, ``max(epochs // 10, 5)`` epochs, for ``pipes``,
  ``socket`` (``NativeProcessBackend(zero_copy=False)``: every body
  through the sockets) and ``shm_ring`` (the default: the broadcast
  arena in shared memory); GiB/s of payload delivered to the workers.

Prints one JSON line per configuration, host wall clock, unrounded.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..pool import AsyncPool, asyncmap, waitall

BCAST_MIB, BCAST_WORKERS = 4, 4


def _echo_small(i, payload, epoch):
    return payload


def _sum_large(i, payload, epoch):
    # touch the whole payload (forces full deserialization + a pass)
    return np.array([float(payload.sum())])


def _make(kind: str, fn, n: int):
    if kind == "pipes":
        from ..backends.process import ProcessBackend

        return ProcessBackend(fn, n)
    from ..backends.native import NativeProcessBackend

    return NativeProcessBackend(fn, n, zero_copy=kind != "socket")


def roundtrip(kind: str, epochs: int) -> dict:
    backend = _make(kind, _echo_small, 1)
    try:
        pool = AsyncPool(1)
        payload = np.zeros(1)
        asyncmap(pool, payload, backend, nwait=1)  # warm-up
        t0 = time.perf_counter()
        for _ in range(epochs):
            asyncmap(pool, payload, backend, nwait=1)
        dt = time.perf_counter() - t0
        waitall(pool, backend)
    finally:
        backend.shutdown()
    return {"metric": f"transport-roundtrip-{kind}",
            "value": dt / epochs * 1e6, "unit": "us/epoch",
            "epochs": epochs, "payload_bytes": payload.nbytes}


def broadcast(kind: str, epochs: int) -> dict:
    n, mb = BCAST_WORKERS, BCAST_MIB
    backend = _make(kind, _sum_large, n)
    try:
        pool = AsyncPool(n)
        payload = np.ones(mb * 2 ** 20 // 8)  # 4 MiB of float64
        recv = np.zeros(n)
        asyncmap(pool, payload, backend, recv, nwait=n)  # warm-up
        reps = max(epochs // 10, 5)
        t0 = time.perf_counter()
        for _ in range(reps):
            asyncmap(pool, payload, backend, recv, nwait=n)
        dt = time.perf_counter() - t0
        waitall(pool, backend, recv)
        if not np.all(recv == payload.size):
            raise AssertionError(f"{kind}: workers summed {recv}")
    finally:
        backend.shutdown()
    return {"metric": f"transport-broadcast-{kind}",
            "value": mb / 1024 * n * reps / dt, "unit": "GiB/s",
            "payload_mib": mb, "n_workers": n, "epochs": reps,
            "us_per_epoch": dt / reps * 1e6}


def run(epochs: int = 200) -> list[dict]:
    return ([roundtrip(k, epochs) for k in ("pipes", "native")]
            + [broadcast(k, epochs) for k in ("pipes", "socket",
                                               "shm_ring")])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=200)
    args = ap.parse_args(argv)
    for r in run(args.epochs):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
