"""Flash attention: the four CUDA kernels (K1-K4), their plain PyTorch
versions, and the autograd function that joins them.

Counterpart of ``mpistragglers_jl_tpu/ops/flash_attention.py``. Its four
TPU kernels become ``csrc/flash_attention.cu``:

* ``_fwd_kernel`` (K1): O and the per-row logsumexp, online softmax over
  key tiles, tiles wholly outside the causal/sliding band skipped;
* ``_bwd_dq_kernel`` (K2): dq from P recomputed from the logsumexp, one
  query tile against the band's key tiles;
* ``_bwd_dkv_kernel`` (K3): dk, dv per q head, one key tile against the
  band's query tiles;
* ``_bwd_fused_kernel`` (K4): dq, dk and dv in one sweep that forms S
  and dP once per tile pair.

bf16 inputs run on Hopper's tensor cores: ``wgmma`` from swizzled bf16
tiles in shared memory, cp.async double-buffered streams, one
warpgroup per 64-row tile (``tc::flash_fwd_wgmma_kernel``,
``tc::flash_bwd_dq_wgmma_kernel``, ``tc::flash_bwd_dkv_wgmma_kernel``,
``tc::flash_bwd_fused_wgmma_kernel``). They keep the reference's
precision: Q.K^T and dO.V^T from exact bf16 products summed in f32, and
every product that takes P or dS (P.V, dS.K, P^T.dO, dS^T.Q) runs on
its two bf16 halves, hi + lo within 2^-17 of the f32 value. What bounds
them is operations; the halves add 1.5x (K1, K3), 4/3 (K2) and 1.6x
(K4) to the tensor work. At the training shape (bf16, B=8, L=2048, H=8,
D=128, causal) on an H100 80GB HBM3 at 700 W, K1-K3 take 281-295,
323-357 and 482-491 us (``chip_smoke.py`` phase 16,
``bench/flash_bwd_ab.py``), against 5197, 5956 and 6986 us for the f32
FMA kernels they replaced there; K4 854-872 us (9004-9102 us for the
FMA kernel it replaced), which is not faster than K2 and K3 together
(797-815 us), so ``bwd_impl="auto"`` stays split. f32 inputs keep FMA
kernels.

K4 is key-major, as FlashAttention-2 and -3 run the backward: a block
holds one key tile's dk and dv in registers across the q heads of its
kv head (so the GQA sum is in registers, and dk, dv come out per kv
head) and adds each tile pair's dq contribution into an f32 ``(B*H,
Lq, D)`` sum with atomics, which a second launch scales and casts to
dq. The reference's ``(B*H, nq, Lk, D)`` f32 partials, which made its
fused kernel the slower one on its chip, do not exist here.

As in the reference, ``delta = rowsum(dO * O)`` and the split
backward's GQA group sum stay outside the kernels, in PyTorch.

Not ported: the TPU's block picking and VMEM guard (``_pick_block``,
``_check_vmem``, ``_grid_params``) and ``interpret``. ``block_q`` and
``block_k`` are accepted for the reference's signature; the CUDA tiles
are the kernels' own (64 x 64).

The functions below run the plain versions only for tensors on the
CPU; for CUDA tensors they launch a kernel or raise. ``LAUNCHES``
counts kernel launches (never plain-version calls), one entry per
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..parallel.ring_attention import _NEG, _band_mask

__all__ = ["LAUNCHES", "flash_attention"]

_KERNEL_HEAD_DIMS = (64, 128)

# kernel name -> launches since the counter was last set to 0
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_bwd_fused": 0}


# --------------------------------------------------------------------------
# plain versions (materialising, f32)
# --------------------------------------------------------------------------


def _kv_rows(x3, g: int):
    """(B*Hkv, L, D) -> f32 (B*H, L, D): q row b reads kv row b // g."""
    x = x3.float()
    return x.repeat_interleave(g, dim=0) if g > 1 else x


def _scores(q3, k3, scale, causal, window, g):
    """Masked f32 scores (B*H, Lq, Lk) and the mask (or None)."""
    s = torch.matmul(q3.float(), _kv_rows(k3, g).transpose(1, 2)) * scale
    dev = q3.device
    mask = _band_mask(torch.arange(q3.shape[1], device=dev),
                      torch.arange(k3.shape[1], device=dev), causal, window)
    if mask is not None:
        s = torch.where(mask, s, _NEG)
    return s, mask


def _fwd_ref(q3, k3, v3, scale, causal, window, g):
    """Plain version of K1: (o (B*H, Lq, D) in q's dtype, lse (B*H, Lq,
    1) f32). Masked keys get p = 0 and the normaliser is floored at
    1e-20, as in the reference."""
    s, mask = _scores(q3, k3, scale, causal, window, g)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    o = torch.matmul(p, _kv_rows(v3, g)) / l
    return o.to(q3.dtype), m + torch.log(l)


def _probs_and_ds(q3, k3, v3, do3, lse, delta, scale, causal, window, g):
    """P recomputed from the logsumexp and dS = P * (dP - delta), f32."""
    s, _ = _scores(q3, k3, scale, causal, window, g)
    p = torch.exp(s - lse)
    dp = torch.matmul(do3.float(), _kv_rows(v3, g).transpose(1, 2))
    return p, p * (dp - delta)


def _bwd_dq_ref(q3, k3, v3, do3, lse, delta, scale, causal, window, g):
    """Plain version of K2: dq (B*H, Lq, D) in q's dtype."""
    _, ds = _probs_and_ds(q3, k3, v3, do3, lse, delta, scale, causal,
                          window, g)
    return (torch.matmul(ds, _kv_rows(k3, g)) * scale).to(q3.dtype)


def _bwd_dkv_ref(q3, k3, v3, do3, lse, delta, scale, causal, window, g):
    """Plain version of K3: dk, dv per q head, (B*H, Lk, D) in k's and
    v's dtypes (the GQA group sum is the caller's)."""
    p, ds = _probs_and_ds(q3, k3, v3, do3, lse, delta, scale, causal,
                          window, g)
    dv = torch.matmul(p.transpose(1, 2), do3.float())
    dk = torch.matmul(ds.transpose(1, 2), q3.float()) * scale
    return dk.to(k3.dtype), dv.to(v3.dtype)


def _bwd_fused_ref(q3, k3, v3, do3, lse, delta, scale, causal, window, g):
    """Plain version of K4: dq in q's dtype; dk, dv summed over the
    GQA group in f32, (B*Hkv, Lk, D) in k's and v's dtypes."""
    p, ds = _probs_and_ds(q3, k3, v3, do3, lse, delta, scale, causal,
                          window, g)
    dq = (torch.matmul(ds, _kv_rows(k3, g)) * scale).to(q3.dtype)
    dk = torch.matmul(ds.transpose(1, 2), q3.float()) * scale
    dv = torch.matmul(p.transpose(1, 2), do3.float())
    return dq, _group_sum(dk, g, k3.dtype), _group_sum(dv, g, v3.dtype)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _kernel_lib():
    from ._build import load

    lib = load("flash_attention")
    if lib.flash_fwd.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [ci] * 5 + [cf] + [ci] * 3 + [vp]
        for fn, n_ptr in ((lib.flash_fwd, 5), (lib.flash_bwd_dq, 7),
                          (lib.flash_bwd_dkv, 8), (lib.flash_bwd_fused, 10)):
            fn.argtypes = [vp] * n_ptr + tail
            fn.restype = ci
        lib.flash_attention_error_string.argtypes = [ci]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(q3, k3, g, named):
    """Kernel inputs: on q's device, contiguous, of the stated dtype and
    shape; q, k, v bf16 or f32 with a head_dim the kernel has."""
    if q3.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q3.dtype}")
    BH, Lq, D = q3.shape
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_KERNEL_HEAD_DIMS}, "
                         f"got {D}")
    if g < 1 or BH % g != 0:
        raise ValueError(f"B*H={BH} is not a multiple of the group {g}")
    for name, t, dt, shape in named:
        if t.device != q3.device or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"{name!r}: want {dt} {shape} on {q3.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name!r} must be contiguous")
    return BH, Lq, k3.shape[1], D


def _launch(name, ptrs, q3, g, Lq, Lk, D, scale, causal, window):
    """Launch kernel ``name`` (its C entry has the same name) on the
    current stream; raise on a refused launch, else count it."""
    lib = _kernel_lib()
    err = getattr(lib, name)(
        *ptrs, q3.shape[0], g, Lq, Lk, D, float(scale), int(bool(causal)),
        0 if window is None else int(window),
        int(q3.dtype == torch.bfloat16),
        torch.cuda.current_stream(q3.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    LAUNCHES[name] += 1


def _device_route(q3) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); any other device raises."""
    if q3.device.type == "cpu":
        return False
    if q3.device.type != "cuda":
        raise ValueError(f"no kernel for device {q3.device}")
    return True


def _kv_check(q3, k3, v3, g):
    BH, Lq, D = q3.shape
    Lk = k3.shape[1]
    return [("q", q3, q3.dtype, (BH, Lq, D)),
            ("k", k3, q3.dtype, (BH // g, Lk, D)),
            ("v", v3, q3.dtype, (BH // g, Lk, D))]


def _bwd_check(q3, k3, v3, do3, lse, delta, g):
    BH, Lq, D = q3.shape
    return _kv_check(q3, k3, v3, g) + [
        ("do", do3, q3.dtype, (BH, Lq, D)),
        ("lse", lse, torch.float32, (BH, Lq, 1)),
        ("delta", delta, torch.float32, (BH, Lq, 1)),
    ]


# Each wrapper below takes its plain version's arguments and returns
# what it returns: the plain version for CPU tensors, the kernel's
# result for CUDA tensors.


def _fwd(q3, k3, v3, scale, causal, window, g):
    """K1: (o (B*H, Lq, D) in q's dtype, lse (B*H, Lq, 1) f32)."""
    if not _device_route(q3):
        return _fwd_ref(q3, k3, v3, scale, causal, window, g)
    BH, Lq, Lk, D = _check_kernel_inputs(q3, k3, g,
                                         _kv_check(q3, k3, v3, g))
    o = torch.empty_like(q3)
    lse = torch.empty((BH, Lq, 1), dtype=torch.float32, device=q3.device)
    _launch("flash_fwd", [t.data_ptr() for t in (q3, k3, v3, o, lse)],
            q3, g, Lq, Lk, D, scale, causal, window)
    return o, lse


def _bwd_dq(q3, k3, v3, do3, lse, delta, scale, causal, window, g):
    """K2: dq (B*H, Lq, D) in q's dtype."""
    if not _device_route(q3):
        return _bwd_dq_ref(q3, k3, v3, do3, lse, delta, scale, causal,
                           window, g)
    _, Lq, Lk, D = _check_kernel_inputs(
        q3, k3, g, _bwd_check(q3, k3, v3, do3, lse, delta, g))
    dq = torch.empty_like(q3)
    _launch("flash_bwd_dq", [t.data_ptr() for t in
                             (q3, k3, v3, do3, lse, delta, dq)],
            q3, g, Lq, Lk, D, scale, causal, window)
    return dq


def _bwd_dkv(q3, k3, v3, do3, lse, delta, scale, causal, window, g):
    """K3: dk, dv per q head, (B*H, Lk, D) in k's and v's dtypes."""
    if not _device_route(q3):
        return _bwd_dkv_ref(q3, k3, v3, do3, lse, delta, scale, causal,
                            window, g)
    BH, Lq, Lk, D = _check_kernel_inputs(
        q3, k3, g, _bwd_check(q3, k3, v3, do3, lse, delta, g))
    dkq = torch.empty((BH, Lk, D), dtype=k3.dtype, device=q3.device)
    dvq = torch.empty_like(dkq)
    _launch("flash_bwd_dkv", [t.data_ptr() for t in
                              (q3, k3, v3, do3, lse, delta, dkq, dvq)],
            q3, g, Lq, Lk, D, scale, causal, window)
    return dkq, dvq


def _bwd_fused_grads(q3, k3, v3, do3, lse, delta, scale, causal, window,
                     g):
    """K4: dq (B*H, Lq, D) in q's dtype; dk, dv summed over the GQA
    group, (B*Hkv, Lk, D) in k's and v's dtypes."""
    if not _device_route(q3):
        return _bwd_fused_ref(q3, k3, v3, do3, lse, delta, scale, causal,
                              window, g)
    BH, Lq, Lk, D = _check_kernel_inputs(
        q3, k3, g, _bwd_check(q3, k3, v3, do3, lse, delta, g))
    # the kernel adds into the f32 dq sum: zeroed here, never inside it
    dqa = torch.zeros((BH, Lq, D), dtype=torch.float32, device=q3.device)
    dq = torch.empty_like(q3)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    _launch("flash_bwd_fused", [t.data_ptr() for t in
                                (q3, k3, v3, do3, lse, delta, dqa, dq, dk,
                                 dv)],
            q3, g, Lq, Lk, D, scale, causal, window)
    return dq, dk, dv


def _delta(do3, o3):
    """rowsum(dO * O) in f32, (B*H, Lq, 1): outside the kernels, as in
    the reference."""
    return (do3.float() * o3.float()).sum(dim=-1, keepdim=True)


def _group_sum(x, g: int, dtype):
    """Per-q-head (B*H, Lk, D) -> (B*Hkv, Lk, D): flattened q row b =
    (batch*Hkv + hkv)*g + g_idx, so the group is axis 1 of a reshape."""
    if g == 1:
        return x.to(dtype)
    BH, Lk, D = x.shape
    return x.reshape(BH // g, g, Lk, D).sum(dim=1).to(dtype)


def _bwd(q3, k3, v3, o3, lse, do3, scale, causal, window, g):
    """Split backward: K2 for dq, then K3 for per-q-head dk/dv, group
    summed outside. Returns (dq, dk, dv)."""
    args = (q3, k3, v3, do3, lse, _delta(do3, o3), scale, causal, window,
            g)
    dq = _bwd_dq(*args)
    dkq, dvq = _bwd_dkv(*args)
    return dq, _group_sum(dkq, g, k3.dtype), _group_sum(dvq, g, v3.dtype)


def _bwd_fused(q3, k3, v3, o3, lse, do3, scale, causal, window, g):
    """Fused backward: K4 alone, dk and dv group summed inside it.
    Returns (dq, dk, dv)."""
    return _bwd_fused_grads(q3, k3, v3, do3, lse, _delta(do3, o3), scale,
                            causal, window, g)


# --------------------------------------------------------------------------
# autograd function over (B*H, L, D) tensors
# --------------------------------------------------------------------------


class _Flash3(torch.autograd.Function):
    """The counterpart of the reference's ``_flash3`` custom VJP: the
    forward saves (q3, k3, v3, o, lse); the backward is split (K2, K3)
    or fused (K4)."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale, causal, window, g, fused):
        o, lse = _fwd(q3, k3, v3, scale, causal, window, g)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.meta = (scale, causal, window, g, fused)
        return o

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, o, lse = ctx.saved_tensors
        scale, causal, window, g, fused = ctx.meta
        impl = _bwd_fused if fused else _bwd
        dq, dk, dv = impl(q3, k3, v3, o, lse, do3.contiguous(), scale,
                          causal, window, g)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None, window: int | None = None,
                    block_q: int = 1024, block_k: int = 1024,
                    bwd_impl: str = "auto"):
    """Fused flash attention on (B, L, H, D) tensors; differentiable.

    Drop-in for :func:`..parallel.ring_attention.reference_attention`
    (same layout, same causal and window semantics); ``k`` and ``v`` may
    carry fewer heads (GQA: q head h reads kv head h // (H // Hkv)).
    ``scale`` defaults to ``D ** -0.5``.

    ``bwd_impl``: ``"split"`` runs K2 (dq) and K3 (dk, dv);
    ``"fused"`` runs K4 alone; ``"auto"`` (default) resolves to split.
    ``block_q`` and ``block_k`` are the reference's TPU block sizes and
    are not used: the CUDA kernels tile by 64.

    CPU tensors run the plain versions; CUDA tensors launch the kernels
    on the current stream or raise (no fallback).
    """
    del block_q, block_k  # the kernels' tiles are their own
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    Hkv = k.shape[2]
    if H % Hkv != 0:
        raise ValueError(
            f"q heads ({H}) must be a multiple of kv heads ({Hkv})"
        )
    g = H // Hkv
    if scale is None:
        scale = D ** -0.5
    if bwd_impl not in ("auto", "split", "fused"):
        raise ValueError(
            f"bwd_impl must be 'auto'|'split'|'fused', got {bwd_impl!r}"
        )
    # "auto" is the split backward, as in the reference (whose fused
    # kernel measured slower on its chip). On an H100 the key-major K4
    # ties the split pair at L=2048 and loses at L=4096 (PERF.md §5)
    fused_bwd = bwd_impl == "fused"

    def to3(x, L, h):
        # at B == 1 the reshape can be a strided view; the kernels take
        # contiguous rows
        return x.transpose(1, 2).reshape(B * h, L, D).contiguous()

    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    o3 = _Flash3.apply(
        to3(q, Lq, H), to3(k, Lk, Hkv), to3(v, Lk, Hkv), float(scale),
        bool(causal), None if window is None else int(window), g,
        fused_bwd,
    )
    return o3.reshape(B, H, Lq, D).transpose(1, 2)
