"""Driver of the MDS-coded GEMM configurations: ``CodedGemm``.

``C = A @ B`` with A's rows padded with zeros to a multiple of k, cut
into k blocks and encoded by the program's systematic (n, k) code into
n coded blocks, one per stream worker; ``nwait`` is k, and the program
decodes the full product from the first k fresh shards
(``CodedGemm.result_device``), whose first m rows are the product. The
code is systematic (its generator is ``[I; P]``), so every fresh shard
j < k is among the first k and delivers row block j as it is.
Coalesced dispatch (``batch=True``) where the traffic asks for it.
"""

from __future__ import annotations

import torch

from portbench import pool_gemm

CONTROLS, FAULTS = pool_gemm.CONTROLS, pool_gemm.FAULTS


def build(cfg, A, device, *, delay_fn, batch, batch_arrival):
    from mpistragglers_jl_tpu_torch.ops.coded_gemm import CodedGemm

    m, n, k = A.shape[0], cfg["n"], cfg["k"]
    m_pad = -(-m // k) * k
    A_pad = torch.zeros(m_pad, A.shape[1], device=device, dtype=A.dtype)
    A_pad[:m] = A
    cg = CodedGemm(A_pad, n, k, devices=[device], delay_fn=delay_fn,
                   parity=cfg["parity"], precision=cfg["precision"],
                   batch=batch, batch_arrival=batch_arrival)
    return pool_gemm.program(
        cg.backend, int(cfg["nwait"]),
        lambda pool: cg.result_device(pool)[:m],
        k=k, block_rows=m_pad // k,
        direct=lambda fresh: [j for j in range(k) if fresh[j]])


def run(ctx) -> dict:
    return pool_gemm.run(ctx, build)
