"""In-kernel attribution of the int8 decode-attention kernel (K5) on
the GPU.

Port of ``benchmarks/decode_kernel_attrib.py``. Each K7 variant strips
what K5 does after its tiles land in shared memory while keeping the
same grid, tiles and loads (``ops/csrc/decode_attention.cu``, the
kernel's MODE), so the differences attribute K5's time:

  dma        load every tile, one f32 sum per k-block: the streaming
             floor of this grid and tiling (no dots, no softmax)
  dot        + the score dots (no scales, no softmax: a max per block)
  dequant    + the per-key scale corrections
  full_nosm  + the PV products (no softmax)
  full       K5 itself (online softmax and PV)

Beside them: one decode step's attention on the einsum route
(``models/decode.py`` ``_cached_attention(..., use_kernel=False)``)
over the bf16 cache and over the int8 cache, and the byte bound
(``kernel_bounds.attrib_bound``). Inputs are the reference's: numpy
seed 0, the same draws in the same order, ``pos = L - 1`` (every key
visible), its ``block_k=8192`` through the reference's block picker
(4096 at the flagship shape).

Timing: 24 data-dependent calls (each output feeds the next call's
query, the reference's one-jit chain) are captured as one CUDA graph;
a variant's time is the least of 3 replays, timed with CUDA events,
over 24. The same chain run eagerly gives the per-call time with the
launch cost (``eager_ms``). ``launches`` is the kernels' own counters
(``ops/decode_attention.py`` ``LAUNCHES``) over the run: the eager
calls, 3 chains of 24 per variant. The calls recorded into a graph and
the graph's replays (``graph_replays`` per variant, of 24 calls each)
are not in it.

Runs on the card only; without one it raises. Prints the flagship
attribution (B=1, L=16384, H=8, Hkv=2, D=128), then the batched sweep
(B in {4, 8}, the full kernel only):

    python -m mpistragglers_jl_tpu_torch.bench.decode_kernel_attrib
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from ..models.decode import _cached_attention
from ..ops import decode_attention as da
from .kernel_bounds import attrib_bound

INNER = 24  # chained calls per timing
REPLAYS = 3
VARIANTS = {"dma": "kernel_dma_ms", "dot": "kernel_dot_ms",
            "dequant": "kernel_dequant_ms",
            "full_nosm": "kernel_nosoftmax_ms"}


def card() -> tuple[str, str]:
    """The card's name and ``nvidia-smi``'s "name, power limit" line;
    raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("decode_kernel_attrib: no CUDA device; this "
                           "bench runs only on the GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(0), smi


def _events_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _chain_ms(fn_one, q0) -> tuple[float, float, dict]:
    """(graph ms per call, eager ms per call, eager launches by name) of
    ``INNER`` chained calls of ``fn_one`` from ``q0``."""
    def chain():
        o = q0
        for _ in range(INNER):
            o = fn_one(o).to(q0.dtype).reshape(q0.shape)
        return o

    before = dict(da.LAUNCHES)
    chain()  # warm-up: builds and loads the kernel
    torch.cuda.synchronize()
    eager = _events_ms(chain) / INNER
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()  # warm-up on a side stream before capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chain()
    graph.replay()
    best = min(_events_ms(graph.replay) for _ in range(REPLAYS))
    torch.cuda.synchronize()
    runs = {k: da.LAUNCHES[k] - before[k] for k in da.LAUNCHES}
    return best / INNER, eager, {k: n for k, n in runs.items() if n}


def inputs(B, L, H, Hkv, D, dev):
    """The reference's draws, in its order: q (bf16), int8 k and v, f32
    k_s and v_s."""
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.standard_normal((B, 1, H, D))).to(
        torch.bfloat16).to(dev)
    cache = {
        "k": rng.integers(-127, 128, (B, L, Hkv, D)),
        "v": rng.integers(-127, 128, (B, L, Hkv, D)),
        "k_s": rng.random((B, L, Hkv)) * 0.01,
        "v_s": rng.random((B, L, Hkv)) * 0.01,
    }
    cache = {k: torch.as_tensor(a).to(torch.int8 if k in "kv" else
                                      torch.float32).to(dev)
             for k, a in cache.items()}
    return q, cache


def run(B=1, L=16384, H=8, Hkv=2, D=128, bk=8192, variants=True) -> dict:
    """One attribution at (B, L, H, Hkv, D); the reference's
    ``main()`` keys (without ``fence_rtt_ms``: there is no tunnel) plus
    the card, its power limit, the byte bound, eager times and eager
    launches."""
    name, smi = card()
    dev = torch.device("cuda", 0)
    q, cache = inputs(B, L, H, Hkv, D, dev)
    cache_bf = {n: cache[n].to(torch.bfloat16)
                * cache[n + "_s"][..., None].to(torch.bfloat16)
                for n in ("k", "v")}
    pos = torch.tensor(L - 1, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    bk_eff = da._pick_block_128(L, bk, Hkv, D)
    if bk_eff is None or bk_eff % 32:
        raise ValueError(f"no k-block for L={L} at block {bk}: {bk_eff}")
    times, eager, runs = {}, {}, {}

    def timed(key, fn_one):
        times[key], eager[key], r = _chain_ms(fn_one, q)
        for k, n in r.items():
            runs[k] = runs.get(k, 0) + n

    timed("einsum_bf16_ms", lambda x: _cached_attention(
        x, cache_bf, pos[None], scale, use_kernel=False))
    timed("einsum_int8_ms", lambda x: _cached_attention(
        x, cache, pos[None], scale, use_kernel=False))
    timed("kernel_full_ms", lambda x: da.quantized_decode_attention(
        x, cache, pos, scale))
    if variants:
        for mode, key in VARIANTS.items():
            timed(key, lambda x, mode=mode: da.decode_attention_attrib(
                x, cache, pos, scale, mode, bk_eff))
    bound = attrib_bound(B=B, L=L, H=H, Hkv=Hkv, D=D)["K7"]
    return {
        "shape": f"B={B} L={L} H={H} Hkv={Hkv} D={D} bk={bk_eff} "
                 f"nk={L // bk_eff}",
        "device": name,
        "name_power_limit": smi,
        "int8_bytes_mib": B * 2 * L * Hkv * D / 2 ** 20,
        "bf16_bytes_mib": B * 2 * L * Hkv * D * 2 / 2 ** 20,
        **times,
        "kernel_vs_bf16": times["einsum_bf16_ms"] / times["kernel_full_ms"],
        "einsum_int8_vs_bf16": (times["einsum_bf16_ms"]
                                / times["einsum_int8_ms"]),
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "bound_bytes": bound["bytes"],
        "eager_ms": eager,
        "launches": runs,
        "graph_replays": 1 + REPLAYS,
        "chain": INNER,
        "replays_min_of": REPLAYS,
    }


def main() -> list[dict]:
    """The flagship attribution, then the batched sweep (the full
    kernel only), one JSON line each."""
    out = [run()]
    print(json.dumps(out[-1]), flush=True)
    for B in (4, 8):
        out.append(run(B=B, variants=False))
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
