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
  dS Q; K4: all five). Exponentials are not counted. K4's f32 dk/dv
  sums count as written once, the port's layout (the reference writes
  one partial per block of 1024 queries; K4 is bound by operations
  either way). Beside the bound of the function, K1-K3 print the
  tensor work their bf16 kernels issue (``hi_lo``): every product that
  takes P or dS as an operand runs twice, on its bf16 hi and lo halves
  (K1: 3 products' worth, 1.5x; K2: 4, 4/3x; K3: 6, 1.5x).
* K7, the attribution variants of ``benchmarks/decode_kernel_attrib.py``
  at their own shape (B=1, L=16384, H=8, Hkv=2, D=128, bf16 q, every
  key visible) and at B = 4 and 8 (the bench's batched sweep): the
  bytes and operations of the fullest variant, which reads what K5
  reads.

Pure arithmetic, no card needed:

    python -m mpistragglers_jl_tpu_torch.bench.kernel_bounds
"""

from __future__ import annotations

import json

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12


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
    f32_sum = BH * L * D * 4  # one f32 (BH, Lk, D) dk or dv sum
    prod = 2 * D * pairs  # operations of one product over the band
    return {
        "K1": _bound(2 * act + 2 * kv + stat, 2 * prod, 3 * prod),
        "K2": _bound(4 * act + 2 * stat + act, 3 * prod, 4 * prod),
        "K3": _bound(4 * act + 2 * stat + 2 * act, 4 * prod, 6 * prod),
        "K4": _bound(4 * act + 2 * stat + act + 2 * f32_sum,
                     5 * 2 * D * pairs),
    }


def attrib_bound(B=1, L=16384, H=8, Hkv=2, D=128) -> dict:
    """K7 at its own shape: int8 K and V, f32 scales, bf16 q in and
    out, the position."""
    nbytes = (B * L * Hkv * D * 2 + B * L * Hkv * 4 * 2
              + B * H * D * 2 * 2 + 4)
    return {"K7": _bound(nbytes, 4 * B * H * L * D)}


def main() -> int:
    rows = {**flash_bounds(),
            **{f"K7 B={B}": attrib_bound(B=B)["K7"] for B in (1, 4, 8)}}
    for name, r in rows.items():
        hi_lo = (f"; hi/lo tensor work {r['hi_lo_bound_ms'] * 1e3:.2f} us"
                 if "hi_lo_ops" in r else "")
        print(f"{name}: {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}; "
              f"{r['bytes']} B, {r['ops']} ops{hi_lo})")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
