"""The coded-GEMM decode from a host factor: the CUDA kernel, its plain
version and the route between them.

``CodedGemm.result_device`` and ``LTCodedGemm.result_device`` solve
``G_S X = S`` for the k source blocks ``X`` of the product, ``S`` being
the k fresh workers' shards and ``G_S`` their k generator rows. Both
the fresh set and the generator are host data (``pool.fresh_indices``,
``MDSCode.G``, ``LTCode.generator_rows``), so :func:`host_lu` factors
``G_S`` on the host, in float64 with partial pivoting (the algorithm of
``gesv`` and ``jax.scipy.linalg.solve``, which the JAX package decodes
with), and no factor, gather or index tensor runs on the card or
crosses to it. The substitution then runs over the k shards where they
lie (rows of a fused stack or each worker's own result), with nothing
stacked first:

* CUDA f32 shards, k <= ``MAX_K``: ``csrc/decode_solve.cu``, one launch
  on the current stream that reads every shard element once and writes
  every product element once (the source note says why and how);
* CPU shards: :func:`decode_solve_ref`, the plain version, the same
  factors in the shards' dtype and the same order of operations over
  torch tensors.

:func:`takes` is the route: where it is False (CUDA shards of another
dtype, or k > ``MAX_K``) the caller keeps ``ops/coding.py``'s ``_decode``,
which factors on the card. ``LAUNCHES`` counts the kernel's launches
(not plain-version calls, not calls recorded into a CUDA graph).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from ..obs.timeline import annotate_if

__all__ = ["LAUNCHES", "MAX_K", "decode_solve", "decode_solve_ref",
           "host_lu", "takes"]

MAX_K = 16  # the kernel's template instances: k float4 in registers

# kernel name -> launches since the counter was last set to 0
LAUNCHES = {"decode_solve": 0}


def takes(t: torch.Tensor, k: int) -> bool:
    """Whether :func:`decode_solve` serves k shards like ``t``: any CPU
    tensor (the plain version), and f32 CUDA tensors with k <= MAX_K
    (the kernel)."""
    if t.device.type == "cpu":
        return True
    return t.device.type == "cuda" and t.dtype == torch.float32 \
        and k <= MAX_K


def host_lu(G_S) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """LU with partial pivoting of the k x k ``G_S``, in float64 on the
    host: ``(perm, lu, dinv)`` with ``G_S[perm] = L U``, ``lu`` holding
    the unit-lower ``L`` below its diagonal and ``U`` on and above it,
    and ``dinv = 1 / diag(U)``. Each column's pivot is its first largest
    magnitude, as LAPACK's ``getf2`` picks it. Raises on a zero pivot
    (a singular ``G_S``)."""
    a = np.array(G_S, dtype=np.float64)
    k = a.shape[0]
    if a.shape != (k, k):
        raise ValueError(f"G_S must be square, got {a.shape}")
    # Python floats, not numpy rows: k <= 16 leaves numpy's per-call cost
    # the whole cost, and the host issues this once a decode
    a = a.tolist()
    perm = list(range(k))
    for j in range(k):
        col = [abs(a[i][j]) for i in range(j, k)]
        p = j + col.index(max(col))
        if a[p][j] == 0.0:
            raise ValueError(f"G_S is singular (column {j})")
        if p != j:
            a[j], a[p] = a[p], a[j]
            perm[j], perm[p] = perm[p], perm[j]
        rj = a[j]
        for i in range(j + 1, k):
            ri = a[i]
            f = ri[j] = ri[j] / rj[j]
            for c in range(j + 1, k):
                ri[c] -= f * rj[c]
    lu = np.array(a)
    return np.array(perm), lu, 1.0 / np.diag(lu)


def decode_solve_ref(shards: Sequence[torch.Tensor], perm, lu,
                     dinv) -> torch.Tensor:
    """The plain version: ``X`` (k, *shard shape) from
    :func:`host_lu`'s factors rounded once to the shards' dtype, by the
    kernel's substitution: forward over ``L`` in increasing j, then back
    over ``U`` in decreasing j, each row scaled by its ``dinv`` last."""
    k = len(shards)
    t0 = shards[0]
    dt = t0.dtype
    c = torch.from_numpy(np.asarray(lu)).to(dt).tolist()
    d = torch.from_numpy(np.asarray(dinv)).to(dt).tolist()
    out = torch.empty((k, *t0.shape), dtype=dt, device=t0.device)
    x = out.view(k, -1)
    for i in range(k):
        x[i] = shards[int(perm[i])].reshape(-1)
        for j in range(i):
            x[i].add_(x[j], alpha=-c[i][j])
    for i in range(k - 1, -1, -1):
        for j in range(k - 1, i, -1):
            x[i].add_(x[j], alpha=-c[i][j])
        x[i].mul_(d[i])
    return out


def _kernel_lib():
    from ._build import load

    lib = load("decode_solve")
    if lib.decode_solve.argtypes is None:
        vp, fp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)
        lib.decode_solve.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), fp, fp, vp,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, vp]
        lib.decode_solve.restype = ctypes.c_int
        lib.decode_solve_error_string.argtypes = [ctypes.c_int]
        lib.decode_solve_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_shards(shards: Sequence[torch.Tensor]) -> None:
    k = len(shards)
    if k > MAX_K:
        raise ValueError(f"the decode kernel takes k <= {MAX_K}, got {k}")
    t0 = shards[0]
    for i, s in enumerate(shards):
        if s.dtype != torch.float32:
            raise ValueError(f"the decode kernel takes f32 shards, shard "
                             f"{i} is {s.dtype}")
        if s.device != t0.device or s.shape != t0.shape:
            raise ValueError(f"shard {i} is {tuple(s.shape)} on {s.device},"
                             f" shard 0 {tuple(t0.shape)} on {t0.device}")
        if not s.is_contiguous():
            raise ValueError(f"shard {i} is not contiguous")


def _float4(n: int, ptrs: Sequence[int]) -> bool:
    """Whether the kernel's float4 instance serves shards of ``n``
    elements at ``ptrs`` (the output's among them): n a multiple of 4
    and every address 16-byte aligned. Otherwise its float instance
    does (a shard of 3 x 3, or the rows of a stack of such shards)."""
    return n % 4 == 0 and all(p % 16 == 0 for p in ptrs)


def _launch(shards: Sequence[torch.Tensor], perm, lu,
            dinv) -> torch.Tensor:
    from .decode_attention import sm_count

    _check_kernel_shards(shards)
    k, t0 = len(shards), shards[0]
    dev = t0.device
    out = torch.empty((k, *t0.shape), dtype=torch.float32, device=dev)
    ptrs = [shards[int(p)].data_ptr() for p in perm]
    n = t0.numel()
    src = (ctypes.c_void_p * k)(*ptrs)
    # the factors rounded once to f32, as the plain version's
    lu32 = (ctypes.c_float * (k * k)).from_buffer(lu.astype(np.float32))
    dinv32 = (ctypes.c_float * k).from_buffer(dinv.astype(np.float32))
    lib = _kernel_lib()
    err = lib.decode_solve(k, src, lu32, dinv32, out.data_ptr(), n,
                           int(_float4(n, [*ptrs, out.data_ptr()])),
                           sm_count(dev),
                           torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("decode_solve kernel launch failed: "
                           + lib.decode_solve_error_string(err).decode())
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES["decode_solve"] += 1
    return out


def decode_solve(shards: Sequence[torch.Tensor], G_S,
                 tracer=None) -> torch.Tensor:
    """``X`` (k, *shard shape) with ``G_S X = S``: the k source blocks
    from the k shards ``S`` (equal shapes, one device, read where they
    lie) and their host-side k x k generator rows ``G_S``.

    CPU shards run :func:`decode_solve_ref`; CUDA shards (f32,
    contiguous, k <= MAX_K; any shape and alignment) launch the kernel
    on the current stream, or raise: there is no fallback. The caller
    keeps the shards alive for the kernel (the pool's ``consume``
    records them on the current stream). A tracer
    that asks for spans opens ``mp.decode.factor`` (the host LU) and
    ``mp.decode.solve`` (the substitution)."""
    k = len(shards)
    if np.shape(G_S) != (k, k):
        raise ValueError(f"G_S must be ({k}, {k}) for {k} shards, got "
                         f"{np.shape(G_S)}")
    on = getattr(tracer, "spans", False)
    with annotate_if(on, "mp.decode.factor"):
        perm, lu, dinv = host_lu(G_S)
    with annotate_if(on, "mp.decode.solve"):
        dev = shards[0].device
        if dev.type == "cpu":
            return decode_solve_ref(shards, perm, lu, dinv)
        if dev.type != "cuda":
            raise ValueError(f"no decode kernel for device {dev}")
        return _launch(shards, perm, lu, dinv)
