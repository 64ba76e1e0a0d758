"""The uncoded row-block GEMM as one SPMD script under the launcher.

    python -m mpistragglers_jl_tpu_torch.launch -n 3 \\
        mpistragglers_jl_tpu_torch/bench/launch_gemm.py [--m 4096]
        [--epochs 3] [--seed 0] [--device cuda|cpu]
        [--exit-rank R --exit-code C]

Every rank runs this file (the reference's ``mpiexec -n N julia
script.jl``): rank 0 coordinates, the other ranks compute. The operands
are BASELINE config 2's (``bench/coded_gemm.py`` ``_operands`` from
``--seed``, f32, TF32 off); each worker rank makes ``A`` on its card and
keeps its ``m / (n - 1)`` row block (``bench/process_gemm.py``
``RowBlockWork``), and each epoch rank 0 broadcasts ``B`` from the host
and gathers the blocks into a host ``recvbuf``. Rank 0 then holds the
product to one ``torch.matmul`` on its own device within
``REL_TOL["highest"]`` and prints one JSON line ``{"launch_gemm":
{...}}`` (whether the result also equals that product bit for bit is
reported, not required). It exits 0 when the product holds, else 1.
``--exit-rank R --exit-code C`` makes rank R exit with code C before
it does anything, which must fail the launch with C.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):  # run as a file, as the launcher runs it
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from mpistragglers_jl_tpu_torch import launch  # noqa: E402
from mpistragglers_jl_tpu_torch.bench.process_gemm import (  # noqa: E402
    RowBlockWork,
    _reference,
    _rel_err,
)
from mpistragglers_jl_tpu_torch.pool import (  # noqa: E402
    AsyncPool,
    asyncmap,
    waitall,
)


def coordinator(ctx, args) -> int:
    import torch

    from mpistragglers_jl_tpu_torch._device import resolve_device
    from mpistragglers_jl_tpu_torch.bench.coded_gemm import REL_TOL

    torch.backends.cuda.matmul.allow_tf32 = False
    n, m = ctx.n_workers, args.m
    t0 = time.perf_counter()
    backend = ctx.coordinator_backend(connect_timeout=args.connect_timeout)
    t_connect = time.perf_counter() - t0
    try:
        B, C_ref = _reference(m, args.seed, resolve_device(args.device))
        pool = AsyncPool(n)
        C = np.empty((m, m), np.float32)
        ms = []
        for epoch in range(1, args.epochs + 1):
            ts = time.perf_counter()
            asyncmap(pool, B, backend, C, nwait=n, epoch=epoch)
            ms.append((time.perf_counter() - ts) * 1e3)
        waitall(pool, backend, C)
    finally:
        backend.shutdown()
    err = _rel_err(C, C_ref)
    got = torch.from_numpy(C).to(C_ref.device)
    res = {"ranks": ctx.n_ranks, "m": m, "rows_per_worker": m // n,
           "epochs": args.epochs, "connect_s": t_connect,
           "epoch_ms": ms, "rel_err": err, "rel_tol": REL_TOL["highest"],
           "bit_equal": bool(torch.equal(got, C_ref)),
           "ok": err <= REL_TOL["highest"]}
    print(json.dumps({"launch_gemm": res}), flush=True)
    return 0 if res["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=4096)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--connect-timeout", type=float, default=120.0)
    ap.add_argument("--exit-rank", type=int, default=-1)
    ap.add_argument("--exit-code", type=int, default=3)
    args = ap.parse_args(argv)
    ctx = launch.init()
    if ctx.rank == args.exit_rank:
        return args.exit_code
    if ctx.is_coordinator:
        return coordinator(ctx, args)
    work = RowBlockWork(args.m, ctx.n_workers, args.seed,
                        device=args.device)
    work.prepare(ctx.worker_index)  # while rank 0 starts up
    ctx.serve(work, connect_timeout=args.connect_timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
