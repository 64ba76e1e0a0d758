"""The plain reference of the coded-GEMM cells: ``C = A @ B`` in float64.

Plain PyTorch, imported by nothing of the program and importing
nothing of it: it takes the operands the benchmark drew from the seed
and judges the program's decoded products against products it works
out itself, in float64 with TF32 off, in blocks of rows so that it fits
beside what the run holds. No code, generator, shard or fresh set of
the program is used: a decoded product is right or wrong by what it
says.

* :func:`projection` is ``A @ (B @ v)``: the product's projection on
  the benchmark's probe vector ``v``, to judge the projection the run
  took of every decoded product in its window.
* :func:`rel_err` is ``max |C - A @ B| / max |A @ B|`` over a whole
  decoded product, or over some of its rows (the top is the whole
  product's).
* :func:`as_stored` is an operand as a configuration states it is
  stored: rounded to bf16 (to nearest even) at ``"default"``, as it is;
  the reference rounds the benchmark's operands itself.
"""

from __future__ import annotations

import torch

ROW_BLOCK = 2048


def _exact():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def as_stored(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as stored at ``precision``: bf16 values at ``"default"``."""
    return x.to(torch.bfloat16).float() if precision == "default" else x


def _mask(n: int, rows, device) -> torch.Tensor | None:
    """A boolean mask of the ``(start, end)`` row ranges, or None for
    all (made on the host: one copy to the device)."""
    if rows is None:
        return None
    mask = torch.zeros(n, dtype=torch.bool)
    for r0, r1 in rows:
        mask[r0:r1] = True
    return mask.to(device)


def projection(A: torch.Tensor, B: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """``A @ (B @ v)`` in float64: an (m,) vector."""
    _exact()
    Bv = B.double() @ v.double()
    out = torch.empty(A.shape[0], dtype=torch.float64, device=A.device)
    for r in range(0, A.shape[0], ROW_BLOCK):
        out[r:r + ROW_BLOCK] = A[r:r + ROW_BLOCK].double() @ Bv
    return out


def rel_err(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
            rows=None) -> float:
    """``max |C - A @ B| / max |A @ B|``, the product in float64 and in
    blocks of ``ROW_BLOCK`` rows; the gap over the ``(start, end)`` row
    ranges ``rows`` only, where given (0 where they are none)."""
    _exact()
    if C.shape != (A.shape[0], B.shape[1]):
        return float("inf")
    mask = _mask(A.shape[0], rows, A.device)
    B64 = B.double()
    worst = top = 0.0
    for r in range(0, A.shape[0], ROW_BLOCK):
        ref = A[r:r + ROW_BLOCK].double() @ B64
        diff = (C[r:r + ROW_BLOCK].double() - ref).abs()
        if mask is not None:
            diff = diff[mask[r:r + ROW_BLOCK]]
        gap = float(diff.max()) if diff.numel() else 0.0
        if gap != gap:  # a NaN in the product is wrong, not small
            return float("inf")
        worst = max(worst, gap)
        top = max(top, float(ref.abs().max()))
    del B64
    return worst / top if top > 0 else float("inf")


def proj_rel_err(y: torch.Tensor, ref: torch.Tensor, rows=None) -> float:
    """``max |y - ref| / max |ref|`` of one projection, the gap over the
    ``(start, end)`` row ranges ``rows`` only, where given."""
    top = float(ref.abs().max())
    diff = (y.double() - ref).abs()
    mask = _mask(ref.shape[0], rows, ref.device)
    if mask is not None:
        diff = diff[mask]
    gap = float(diff.max()) if diff.numel() else 0.0
    if gap != gap or top <= 0:
        return float("inf")
    return gap / top
