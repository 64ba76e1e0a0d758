"""Per-row token sampling: the fused CUDA kernel and its plain version.

The reference picks a sampled token with ``jax.random``
(``mpistragglers_jl_tpu/models/decode.py`` ``_pick_token``):
``lg = logits.f32 / temperature``, entries below the k-th largest set to
``-inf`` when ``top_k`` is given, then
``categorical(fold_in(fold_in(key, pos), row), lg)``. The generators
fold the global batch row; the serving scheduler evaluates every slot
as row 0 of its own stream with its request's key
(``models/serving.py`` ``_pick_rows``). :func:`sample_rows` is that rule
with a key, a position and a fold index per row, so both callers share
it.

:func:`sample_rows_ref` is the plain version: ``utils/prng.py``'s eager
chain, bit-equal to ``jax.random`` and the only route on the CPU. On
CUDA tensors :func:`sample_rows` launches ``csrc/sampling.cu`` (one
block per row; ``torch.topk`` and ``amin`` before it for the k-th value
when ``top_k`` is set) or raises: there is no fallback to the plain chain.
The kernel reads ``pos`` and the keys from device tensors and never
syncs, so a CUDA graph can capture it. ``LAUNCHES`` counts the kernel's
launches (not plain-version calls, not calls recorded into a graph).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import prng

__all__ = ["LAUNCHES", "sample_rows", "sample_rows_ref"]

# kernel name -> launches since the counter was last set to 0
LAUNCHES = {"sample_rows": 0}


def _check(logits, pos, keys, row_ids, temperature, top_k):
    if logits.dim() != 2:
        raise ValueError(f"logits must be (R, V), got {tuple(logits.shape)}")
    R, V = logits.shape
    if tuple(keys.shape) != (R, 2):
        raise ValueError(f"keys must be (R, 2) = ({R}, 2), got "
                         f"{tuple(keys.shape)}")
    for name, t in (("pos", pos), ("row_ids", row_ids)):
        if tuple(t.shape) != (R,):
            raise ValueError(f"{name} must be (R,) = ({R},), got "
                             f"{tuple(t.shape)}")
    if not temperature > 0.0:
        raise ValueError(f"sampling needs temperature > 0, got "
                         f"{temperature}")
    if top_k is not None and not 1 <= top_k <= V:
        raise ValueError(f"top_k must lie in [1, V={V}], got {top_k}")


def sample_rows_ref(logits, pos, keys, row_ids, temperature: float,
                    top_k: int | None = None) -> torch.Tensor:
    """The plain version: ``utils/prng.py`` in JAX's order of f32
    operations. Returns int32 tokens (R,)."""
    _check(logits, pos, keys, row_ids, temperature, top_k)
    t = torch.tensor(temperature, dtype=torch.float32, device=logits.device)
    lg = logits.float() / t  # a true division, never a reciprocal product
    if top_k is not None:
        kth = torch.topk(lg, int(top_k), dim=-1).values[:, -1:]
        lg = torch.where(lg < kth, float("-inf"), lg)
    k = prng.fold_in(prng.fold_in(keys, pos), row_ids)
    g = prng.gumbel(k, (lg.shape[1],))
    return torch.argmax(g + lg, dim=-1).to(torch.int32)


def _kernel_lib():
    from ._build import load

    lib = load("sampling")
    if lib.sample_rows.argtypes is None:
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sample_rows.argtypes = [vp, cll, ci, ci, ci, vp, cll, vp, vp,
                                    vp, ctypes.c_float, vp, vp, vp, vp]
        lib.sample_rows.restype = ci
        lib.sampling_error_string.argtypes = [ci]
        lib.sampling_error_string.restype = ctypes.c_char_p
    return lib


def sample_rows(logits, pos, keys, row_ids, temperature: float,
                top_k: int | None = None, *, bits_out=None,
                noise_out=None) -> torch.Tensor:
    """Sample one token per row of ``logits`` (R, V): row r draws with
    the key ``fold_in(fold_in(keys[r], pos[r]), row_ids[r])``
    (``keys`` (R, 2) as ``utils/prng.py`` holds them, ``pos`` and
    ``row_ids`` (R,) integer tensors on the same device). Returns int32
    tokens (R,).

    CPU tensors run :func:`sample_rows_ref`. CUDA tensors (f32 or bf16
    logits, rows contiguous) launch the kernel on the current stream or
    raise. ``bits_out`` (int32 (R, V)) and ``noise_out`` (f32 (R, V))
    take each entry's random bits and Gumbel noise, for tests."""
    _check(logits, pos, keys, row_ids, temperature, top_k)
    if logits.device.type == "cpu":
        if bits_out is not None or noise_out is not None:
            raise ValueError("bits_out and noise_out are the kernel's")
        return sample_rows_ref(logits, pos, keys, row_ids, temperature,
                               top_k)
    if logits.device.type != "cuda":
        raise ValueError(f"no kernel for device {logits.device}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"logits must be f32 or bf16, got {logits.dtype}")
    if logits.stride(1) != 1:
        logits = logits.contiguous()
    R, V = logits.shape
    dev = logits.device
    for name, t in (("keys", keys), ("pos", pos), ("row_ids", row_ids)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, logits on {dev}")
    keys = keys.to(torch.int64).contiguous()
    pos = pos.to(torch.int32).contiguous()
    row_ids = row_ids.to(torch.int32).contiguous()
    kth, kth_ld = None, 0
    if top_k is not None:
        # the k largest unsorted, then their least: the k-th largest,
        # without topk's sort (fewer launches)
        kth = torch.topk(logits, int(top_k), dim=-1, sorted=False).values
        kth, kth_ld = kth.amin(dim=-1), 1
    extra = []
    for t, dt in ((bits_out, torch.int32), (noise_out, torch.float32)):
        if t is not None and (t.dtype != dt or tuple(t.shape) != (R, V)
                              or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"debug output must be {dt} ({R}, {V}) "
                             f"contiguous on {dev}")
        extra.append(None if t is None else t.data_ptr())
    out = torch.empty(R, dtype=torch.int32, device=dev)
    lib = _kernel_lib()
    err = lib.sample_rows(
        logits.data_ptr(), logits.stride(0), R, V,
        int(logits.dtype == torch.bfloat16),
        None if kth is None else kth.data_ptr(), kth_ld, pos.data_ptr(),
        keys.data_ptr(), row_ids.data_ptr(), float(temperature),
        out.data_ptr(), *extra, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError("sample_rows kernel launch failed: "
                           + lib.sampling_error_string(err).decode())
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES["sample_rows"] += 1
    return out
