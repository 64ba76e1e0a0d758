"""Int8 KV-cache decode attention: the CUDA kernel, its plain PyTorch
version, and the routing predicate.

Counterpart of ``mpistragglers_jl_tpu/ops/decode_attention.py``. The
TPU kernel there (``_kernel``, launched by
``quantized_decode_attention``) becomes ``csrc/decode_attention.cu``:
single-query GQA attention over an int8 ``(B, L, Hkv, D)`` cache with
f32 ``(B, L, Hkv)`` scales, dequantised in registers, positions per
row from a device vector. It is bound by bytes: at the serving shape
(B=8, L=W=1024, Hkv=2, D=128, g=4) one launch moves about 4.36 MB,
1.30 us at the H100's 3.35 TB/s. The source note says how the design
meets that and what is left for later (split-K, TMA).

:func:`quantized_decode_attention` runs the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts kernel launches (never plain-version calls), so a
run can show its main path went through the kernel.

The paged mode (``page_table=``, the reference's ``_paged_kernel``)
is ``ROADMAP.md`` Queue 1 item 7.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "LAUNCHES",
    "DEFAULT_BLOCK_K",
    "decode_kernel_viable",
    "quantized_decode_attention",
    "quantized_decode_attention_ref",
]

_NEG = -1e30
_MAX_GROUP = 8  # q rows per kv head the kernel carries (one per warp)

# kernel name -> launches since the counter was last set to 0
LAUNCHES = {"quantized_decode_attention": 0}

# The routing predicate below keeps the reference's TPU block-picker
# arithmetic (ops/decode_attention.py ``_pick_block_128`` with its
# calibrated scoped-VMEM budget) so the port routes exactly the calls
# the JAX package routes. The CUDA kernel itself takes any length:
# re-deriving the gate for the H100 is later work (ROADMAP.md).
_VMEM_PER_ROW_HEAD = 11.3
_VMEM_CAP = 12 * 2 ** 20
DEFAULT_BLOCK_K = 8192


def decode_kernel_viable(L: int, Hkv: int, D: int) -> bool:
    """Would the reference route a cache of length ``L`` to its kernel?
    True iff its ``_pick_block_128(L, DEFAULT_BLOCK_K, Hkv, D)`` finds
    a block: a multiple of 128 dividing L within the budget, or the
    whole length when that fits."""
    cap = int(_VMEM_CAP / (Hkv * D * _VMEM_PER_ROW_HEAD))
    b = min(DEFAULT_BLOCK_K, L, max(cap, 128))
    b -= b % 128
    while b >= 128:
        if L % b == 0:
            return True
        b -= 128
    return L <= max(cap, 128)


def _pos_vector(pos, B: int, device) -> torch.Tensor:
    """Scalar or (B,) positions -> a contiguous (B,) int32 tensor on
    ``device``; a tensor already there is never fetched to the host."""
    p = torch.as_tensor(pos, device=device).to(torch.int32).reshape(-1)
    return p.expand(B).contiguous()


def _check(q, cache_l, ring: bool, window):
    if ring and window is not None:
        raise ValueError(
            "ring mode encodes the window in the cache layout; pass "
            "window=None (the ring length IS the window)"
        )
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    B, T, H, D = q.shape
    if T != 1:
        raise ValueError(f"decode kernel is single-query, got T={T}")
    Hkv = cache_l["k"].shape[2]
    if H % Hkv != 0 or H // Hkv > _MAX_GROUP:
        raise ValueError(
            f"GQA group {H}/{Hkv} must be a whole number <= {_MAX_GROUP}"
        )
    return B, H, D, Hkv


def quantized_decode_attention_ref(q, cache_l: dict, pos, scale,
                                   window=None, *, ring: bool = False):
    """Plain PyTorch version of the kernel, same function: q
    ``(B, 1, H, D)``; ``cache_l`` {"k","v"} int8 ``(B, L, Hkv, D)`` +
    {"k_s","v_s"} f32 ``(B, L, Hkv)``; ``pos`` scalar or ``(B,)``.
    Masked keys get p = 0 and the normaliser is clamped at 1e-20, so a
    row with nothing visible returns zeros, as the kernel does.
    Returns ``(B, 1, H, D)`` in q's dtype."""
    B, H, D, Hkv = _check(q, cache_l, ring, window)
    L = cache_l["k"].shape[1]
    g = H // Hkv
    posv = _pos_vector(pos, B, q.device)[:, None]
    kidx = torch.arange(L, device=q.device)[None, :]
    if ring:
        valid = (kidx <= posv) | (posv >= L)
    else:
        valid = kidx <= posv
        if window is not None:
            valid = valid & (posv - kidx < window)
    q5 = q.float().reshape(B, Hkv, g, D)
    s = torch.einsum("bhgd,blhd->bhgl", q5, cache_l["k"].float()) * scale
    s = s * cache_l["k_s"].permute(0, 2, 1)[:, :, None, :]
    vm = valid[:, None, None, :]
    s = torch.where(vm, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vm, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    pv = p * cache_l["v_s"].permute(0, 2, 1)[:, :, None, :]
    o = torch.einsum("bhgl,blhd->bhgd", pv, cache_l["v"].float()) / l
    return o.reshape(B, 1, H, D).to(q.dtype)


def _kernel_lib():
    from ._build import load

    lib = load("decode_attention")
    fn = lib.k5_decode_attention_int8
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 7 + [ci] * 5 + [ctypes.c_float] + [ci] * 3 + [vp]
        fn.restype = ci
        lib.k5_error_string.argtypes = [ci]
        lib.k5_error_string.restype = ctypes.c_char_p
    return lib


def quantized_decode_attention(q, cache_l: dict, pos, scale, window=None,
                               *, ring: bool = False, page_table=None):
    """Single-query grouped attention against an int8 cache layer,
    the reference's signature and layouts (see
    :func:`quantized_decode_attention_ref` for the function).

    CPU tensors run the plain version. CUDA tensors launch the kernel
    on the current stream (bf16 or f32 q; contiguous leaves; ``pos``
    may be a device vector, so a decode step never syncs) or raise;
    there is no fallback. ``ring=True`` reads the O(W) ring layout
    (L == W), where ``window`` must be None."""
    if page_table is not None:
        raise NotImplementedError(
            "the paged kernel (page_table=) is ROADMAP.md Queue 1 "
            "item 7, not yet ported"
        )
    if q.device.type == "cpu":
        return quantized_decode_attention_ref(q, cache_l, pos, scale,
                                              window, ring=ring)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, H, D, Hkv = _check(q, cache_l, ring, window)
    kc, vc, ks, vs = (cache_l[n] for n in ("k", "v", "k_s", "v_s"))
    L = kc.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if D % 128 != 0 or D > 512:
        raise ValueError(f"kernel takes head_dim in 128..512 step 128, "
                         f"got {D}")
    for name, t, dt, shape in (
        ("k", kc, torch.int8, (B, L, Hkv, D)),
        ("v", vc, torch.int8, (B, L, Hkv, D)),
        ("k_s", ks, torch.float32, (B, L, Hkv)),
        ("v_s", vs, torch.float32, (B, L, Hkv)),
    ):
        if t.device != q.device or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"cache leaf {name!r}: want {dt} {shape} on {q.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"cache leaf {name!r} must be contiguous")
    qc = q.contiguous()
    posv = _pos_vector(pos, B, q.device)
    out = torch.empty_like(qc)
    lib = _kernel_lib()
    err = lib.k5_decode_attention_int8(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), posv.data_ptr(), out.data_ptr(), B, L, Hkv,
        H // Hkv, D, float(scale), 0 if window is None else int(window),
        int(bool(ring)), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            "decode-attention kernel launch failed: "
            + lib.k5_error_string(err).decode()
        )
    LAUNCHES["quantized_decode_attention"] += 1
    return out
