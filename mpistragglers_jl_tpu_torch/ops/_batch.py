"""Shared coalesced-dispatch machinery for pool GEMM workloads.

One device = one fused stacked matmul per epoch
(``CUDADeviceBackend(batch_fn=...)``): the helpers here build the
per-device stacks and dispatch against them, shared by
:class:`~.gemm.DistributedGemm` and :class:`~.coded_gemm.CodedGemm`
so the group-building and re-task-subset logic exist exactly once.

In batch mode the per-worker blocks stay HOST-resident (the fused
stacks are the only device copy — the per-worker dispatch path never
runs, so device-resident individual blocks would be dead memory).

Precision is a string, the port's form of the reference's
``jax.lax.Precision``: ``"highest"`` is an f32 product (TF32 off, a
process-wide setting the caller makes once), ``"default"`` takes bf16
operands and accumulates and returns f32.
"""

from __future__ import annotations

import numpy as np
import torch

PRECISIONS = ("highest", "default")


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {precision!r}"
        )
    return precision


def operand_dtype(dtype: torch.dtype, precision: str) -> torch.dtype:
    """The dtype a block is stored in for products at ``precision``."""
    return torch.bfloat16 if precision == "default" else dtype


def as_tensor(A, dtype=None) -> torch.Tensor:
    """``A`` (numpy or torch) as a tensor, cast to ``dtype`` (a numpy or
    torch dtype) when given; a numpy array is not copied."""
    t = A if isinstance(A, torch.Tensor) else torch.as_tensor(np.asarray(A))
    if dtype is not None and not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.empty(0, dtype)).dtype
    return t if dtype is None else t.to(dtype)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` at ``precision`` (2-D operands at ``"default"``)."""
    if precision == "highest":
        return torch.matmul(a, b)
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a16.is_cuda:
        return torch.mm(a16, b16, out_dtype=torch.float32)
    # the same bf16 products (exact in f32), summed in f32
    return torch.mm(a16.float(), b16.float())


def _stacked_matmul(blocks, payload, precision):
    # (w, r, c) x (c, d) -> (w, r, d) as ONE large 2-D matmul: a batched
    # product leaves the tiling a small per-batch M (r rows); folding
    # the worker axis into M runs at plain-matmul rate
    w, r, c = blocks.shape
    flat = matmul(blocks.reshape(w * r, c), payload, precision)
    return flat.reshape(w, r, *flat.shape[1:])


def _stacked_matmul_gather(blocks_all, sel, payload, precision):
    # re-task subsets: gather the members' blocks (stacked views, no
    # index tensor to copy to the device), then the fused matmul
    blocks = torch.stack([blocks_all[j] for j in sel])
    return _stacked_matmul(blocks, payload, precision)


def build_device_groups(host_blocks, n: int, devices, dtype=None) -> dict:
    """Group worker ids by their DEVICE and place ONE stacked tensor of
    each group's blocks on it (in ``dtype`` when given).

    ``devices`` maps worker i to ``devices[i % len(devices)]`` — a
    short list is the round-robin layout, a length-n list an explicit
    per-worker map. Grouping is by device, matching how the backend
    coalesces dispatches, so both layouts produce the groups the
    batch_fn will be called with.

    Returns ``{worker: (ids_tuple, stacked, {worker: position})}`` —
    every member maps to its group entry. Blocks must be equal-shaped
    within a group (callers enforce their own split constraints).
    """
    by_dev: dict = {}
    for i in range(n):
        by_dev.setdefault(devices[i % len(devices)], []).append(i)
    group_of: dict = {}
    for dev, ids in by_dev.items():
        stacked = torch.stack([as_tensor(host_blocks[i]) for i in ids])
        stacked = stacked.to(dev, dtype)
        entry = (tuple(ids), stacked, {w: p for p, w in enumerate(ids)})
        for i in ids:
            group_of[i] = entry
    return group_of


def batch_dispatch(group_of: dict, ids, payload, precision):
    """The shared ``batch_fn`` body: whole-group broadcasts use the
    stack as-is; re-task subsets gather their members' positions."""
    group_ids, stacked, pos = group_of[int(ids[0])]
    if tuple(ids) == group_ids:
        return _stacked_matmul(stacked, payload, precision)
    sel = [pos[int(i)] for i in ids]
    return _stacked_matmul_gather(stacked, sel, payload, precision)
