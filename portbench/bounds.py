"""The card's peaks and the least work each measured layer must do.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): 67 TFLOP/s in float32 outside
the tensor cores (the rate of an f32 product with TF32 off, as the
configurations state it), 989 TFLOP/s in bfloat16 on the tensor cores
(bf16 operands, f32 sums) and 3.35 TB/s of HBM bandwidth. A record
states the precision of its products (``"f32"`` where it states none);
its operations are held to that precision's peak.

A bound is the least time the card could take: the larger of the
operations over the peak rate and the bytes over the bandwidth, each
input byte read once and each output byte written once, whatever a
kernel reads again. A roofline share is that bound over the measured
device time, in percent; it cannot pass 100 unless the operations or
bytes are counted too high or the time leaves out part of the work.
"""

from __future__ import annotations

FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"f32": FP32_FLOPS_PER_S, "bf16": BF16_FLOPS_PER_S}


def product_flops(rows: int, kdim: int, ncols: int) -> int:
    """One worker's product: a (rows, kdim) block times the (kdim,
    ncols) payload, a multiply and an add per term."""
    return 2 * rows * kdim * ncols


def decode_bytes(k: int, rows: int, ncols: int, itemsize: int = 4) -> int:
    """The decode of k shards of (rows, ncols): the k shards read once
    and the (k * rows, ncols) product written once."""
    return 2 * k * rows * ncols * itemsize


def decode_flops(k: int, rows: int, ncols: int) -> int:
    """The two triangular solves of a k x k LU against rows * ncols
    right-hand sides: k * k multiply-adds per right-hand side in all.
    The k x k factorization is left out (k**3, nothing beside these)."""
    return 2 * k * k * rows * ncols


def bound_s(flops: float, nbytes: float, precision: str = "f32") -> float:
    """The least time for ``flops`` operations at ``precision``'s peak
    and ``nbytes`` of HBM traffic."""
    return max(flops / PEAK_FLOPS_PER_S[precision], nbytes / HBM_BYTES_PER_S)


def share_pct(bound: float, measured: float) -> float | None:
    """``bound`` over ``measured`` in percent; None where nothing was
    measured."""
    if not measured or measured <= 0:
        return None
    return 100.0 * bound / measured
