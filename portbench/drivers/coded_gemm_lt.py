"""Driver of the LT-coded GEMM configurations: ``LTCodedGemm``.

``C = A @ B`` with A cut into k row blocks; each of the n stream
workers holds the real-field sum of its LT shard's blocks. ``nwait`` is
the program's decodability predicate (``LTCodedGemm.nwait``): the pool
returns at the first fresh set that peels, and the program decodes on
the device from a full-rank k of it (``LTCodedGemm.result_device``).
The program has no coalesced dispatch for this code.
"""

from __future__ import annotations

from portbench import pool_gemm

CONTROLS, FAULTS = pool_gemm.CONTROLS, pool_gemm.FAULTS


def build(cfg, A, device, *, delay_fn, batch, batch_arrival):
    from mpistragglers_jl_tpu_torch.ops.coded_gemm import LTCodedGemm

    if batch:
        raise ValueError("LTCodedGemm has no coalesced dispatch")
    m, n, k = A.shape[0], cfg["n"], cfg["k"]
    lt = LTCodedGemm(A, n, k, devices=[device], delay_fn=delay_fn,
                     seed=int(cfg["code_seed"]), precision=cfg["precision"])
    return pool_gemm.program(
        lt.backend, lt.nwait, lt.result_device,
        k=k, block_rows=m // k)


def run(ctx) -> dict:
    return pool_gemm.run(ctx, build)
