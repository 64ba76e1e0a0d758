"""The least time an H100 could take for each TPU kernel of the repo,
at the shape its caller uses: the larger of the bytes the function must
move (each input read once, each output written once) over the card's
3.35 TB/s and its matrix operations over the bf16 tensor-core peak of
989 TFLOP/s (H100 SXM data sheet).

* K1–K4, the flash-attention kernels of ``ops/flash_attention.py``, at
  the default configuration of ``benchmarks/transformer_train_bench.py``
  (batch 8, seq 2048, d_model 1024, 8 heads of 128, MHA, bf16, causal,
  no window). Operations count the causally visible (query, key) pairs
  only, ``L (L + 1) / 2`` per head: 2 * D per pair for each product the
  kernel forms (K1: QK, PV; K2: QK, dO V, dS K; K3: QK, dO V, P dO,
  dS Q; K4: all five). Exponentials are not counted. K4 writes dq, dk
  and dv in bf16, as the port's kernel does (its f32 dq sum is scratch;
  the reference writes f32 dk/dv partials per block of 1024 queries;
  K4 is bound by operations either way). Beside the bound of the
  function, K1-K4 print the tensor work their bf16 kernels issue
  (``hi_lo``): every product that takes P or dS as an operand runs
  twice, on its bf16 hi and lo halves (K1: 3 products' worth, 1.5x; K2:
  4, 4/3x; K3: 6, 1.5x; K4: 8, 1.6x).
* K7, the attribution variants of ``benchmarks/decode_kernel_attrib.py``
  at their own shape (B=1, L=16384, H=8, Hkv=2, D=128, bf16 q, every
  key visible) and at B = 4 and 8 (the bench's batched sweep): the
  bytes and operations of the fullest variant, which reads what K5
  reads.
* The sampling kernel (``ops/csrc/sampling.cu``, the port's own, not a
  TPU kernel's counterpart) at the serving shape: R = 8 rows of V =
  32768 bf16 logits. Its work is integer and f32 arithmetic on the CUDA
  cores, not tensor-core products: per entry Threefry-2x32 takes 71
  int32 operations (20 rounds of add, rotate and xor, 5 key
  injections, the counter's add) and the bits, the uniform and the two
  logs' exponents 9 more; the uniform, two XLA logs (a Cephes
  polynomial of 9 fused multiply-adds each), the scaling, mask and
  running maximum about 55 f32 operations. The rates are the data
  sheet's at its 1.98 GHz boost clock: 132 SMs x 64 int32 lanes a clock
  (16.7 Tops/s) and x 128 f32 lanes a clock (33.4 Tops/s, the 67
  TFLOP/s figure counting a fused multiply-add as two). The two pipes
  run side by side, so the bound is the larger of the two times and the
  bytes' (the logits read once, tokens written once).
* The coded-GEMM decode kernel (``ops/csrc/decode_solve.cu``, the
  port's own; the JAX package decodes with ``jax.scipy.linalg.solve``)
  at BASELINE config 3 (k = 6 f32 shards of 1366 x 8192) and config 4
  (k = 8 of 2048 x 16384): the k shards read once and the k blocks of
  the product written once, 2 k rows cols 4 bytes. Its k^2 fused
  multiply-adds an element run at the f32 rate above (two operations
  each), under the bytes' time.

Pure arithmetic, no card needed:

    python -m mpistragglers_jl_tpu_torch.bench.kernel_bounds
"""

from __future__ import annotations

import json

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
F32_OPS_PER_S = 132 * 128 * 1.98e9
# per vocabulary entry of the sampling kernel (module docstring)
SAMPLE_INT32_OPS = 80
SAMPLE_F32_OPS = 55


def _bound(nbytes: int, nops: int, hi_lo_ops: int | None = None) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / BF16_OPS_PER_S * 1e3
    out = {"bytes": nbytes, "ops": nops, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if hi_lo_ops is not None:
        out["hi_lo_ops"] = hi_lo_ops
        out["hi_lo_bound_ms"] = hi_lo_ops / BF16_OPS_PER_S * 1e3
    return out


def flash_bounds(B=8, L=2048, H=8, D=128, Hkv=None) -> dict:
    """K1–K4 at one causal (B, L, H, D) bf16 attention call; K1's K and
    V carry ``Hkv`` heads (GQA; default H)."""
    BH = B * H
    act = BH * L * D * 2  # one bf16 (B, L, H, D) tensor
    kv = act * (Hkv or H) // H  # one bf16 (B, L, Hkv, D) tensor
    stat = BH * L * 4  # one f32 per-row statistic (lse, delta)
    pairs = BH * L * (L + 1) // 2  # causally visible (query, key) pairs
    prod = 2 * D * pairs  # operations of one product over the band
    return {
        "K1": _bound(2 * act + 2 * kv + stat, 2 * prod, 3 * prod),
        "K2": _bound(4 * act + 2 * stat + act, 3 * prod, 4 * prod),
        "K3": _bound(4 * act + 2 * stat + 2 * act, 4 * prod, 6 * prod),
        "K4": _bound(4 * act + 2 * stat + 3 * act, 5 * prod, 8 * prod),
    }


def attrib_bound(B=1, L=16384, H=8, Hkv=2, D=128) -> dict:
    """K7 at its own shape: int8 K and V, f32 scales, bf16 q in and
    out, the position."""
    nbytes = (B * L * Hkv * D * 2 + B * L * Hkv * 4 * 2
              + B * H * D * 2 * 2 + 4)
    return {"K7": _bound(nbytes, 4 * B * H * L * D)}


def sampling_bounds(R=8, V=32768, logit_bytes=2) -> dict:
    """The sampling kernel over (R, V) logits of ``logit_bytes`` each:
    bytes (logits in; per row the key, position, fold index and token)
    against its int32 and f32 operations on the CUDA cores."""
    n = R * V
    nbytes = n * logit_bytes + R * (16 + 4 + 4 + 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_int = n * SAMPLE_INT32_OPS / INT32_OPS_PER_S * 1e3
    t_f32 = n * SAMPLE_F32_OPS / F32_OPS_PER_S * 1e3
    t_ops = max(t_int, t_f32)
    return {"bytes": nbytes, "int32_ops": n * SAMPLE_INT32_OPS,
            "f32_ops": n * SAMPLE_F32_OPS, "ops": n * (
                SAMPLE_INT32_OPS + SAMPLE_F32_OPS),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def decode_solve_bounds(k=6, rows=1366, cols=8192) -> dict:
    """The decode kernel over k f32 shards of rows x cols: the bytes
    (each shard element read once, each product element written once)
    against its k^2 fused multiply-adds an element at the f32 rate."""
    n = rows * cols
    nbytes = 2 * k * n * 4
    nops = 2 * k * k * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": nops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def main() -> int:
    rows = {**flash_bounds(),
            **{f"K7 B={B}": attrib_bound(B=B)["K7"] for B in (1, 4, 8)},
            "sample_rows R=8 V=32768 bf16": sampling_bounds(),
            "decode_solve k=6 1366x8192": decode_solve_bounds(),
            "decode_solve k=8 2048x16384": decode_solve_bounds(
                8, 2048, 16384)}
    for name, r in rows.items():
        hi_lo = (f"; hi/lo tensor work {r['hi_lo_bound_ms'] * 1e3:.2f} us"
                 if "hi_lo_ops" in r else "")
        print(f"{name}: {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}; "
              f"{r['bytes']} B, {r['ops']} ops{hi_lo})")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
