"""Per-device attention pieces the serving path shares.

Counterpart of ``mpistragglers_jl_tpu/parallel/ring_attention.py``.
Slice 1 ports the GQA grouping helpers (``_group_scores``,
``_group_pv``), the band mask, and the ``"reference"`` per-device
attention; slice 3 resolves ``"flash"`` to the flash-attention kernels.
Ring and Ulysses sequence parallelism are a later slice (``ROADMAP.md``
Queue 1 item 18).
"""

from __future__ import annotations

import torch

__all__ = ["reference_attention", "resolve_attention_impl"]

_NEG = -1e30  # large-negative mask value; -inf breaks the m-update exp


def _group_scores(q, kc, scale):
    """(B, Lq, H, D) x (B, Lk, Hkv, D) -> (B, H, Lq, Lk) f32 scores with
    GQA grouping: q head h = hkv*g + g_idx reads kv head hkv. Both
    operands go to float32 first, so a bf16 q accumulates in f32 like
    the reference's ``preferred_element_type``; K is never repeated."""
    Hq, Hkv = q.shape[2], kc.shape[2]
    B, Lq, _, D = q.shape
    g = Hq // Hkv
    q5 = q.float().reshape(B, Lq, Hkv, g, D)
    s5 = torch.einsum("bqhgd,bkhd->bhgqk", q5, kc.float()) * scale
    return s5.reshape(B, Hq, Lq, kc.shape[1])


def _group_pv(p, vc):
    """(B, H, Lq, Lk) f32 probs x (B, Lk, Hkv, D) values -> (B, Lq, H, D)
    f32, with the grouping of :func:`_group_scores`."""
    Hq, Hkv = p.shape[1], vc.shape[2]
    B, _, Lq, Lk = p.shape
    g = Hq // Hkv
    p5 = p.reshape(B, Hkv, g, Lq, Lk)
    o5 = torch.einsum("bhgqk,bkhd->bqhgd", p5, vc.float())
    return o5.reshape(B, Lq, Hq, vc.shape[-1])


def _band_mask(qpos, kpos, causal, window):
    """(Lq, Lk) visibility: causal (kpos <= qpos) intersected with the
    sliding band (qpos - kpos < window) when set; None when nothing is
    masked."""
    mask = None
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
    if window is not None:
        band = qpos[:, None] - kpos[None, :] < window
        mask = band if mask is None else mask & band
    return mask


def resolve_attention_impl(impl: str):
    """Resolve a per-device attention by name: the materialising
    ``"reference"`` oracle or ``"flash"`` (``ops/flash_attention.py``,
    kernels K1-K4)."""
    if impl == "flash":
        from ..ops.flash_attention import flash_attention

        return flash_attention
    if impl == "reference":
        return reference_attention
    raise ValueError(f"unknown attention impl {impl!r}")


def reference_attention(q, k, v, *, causal=False, scale=None,
                        window=None):
    """Plain full-materialization attention in the (B, L, H, D) layout;
    k/v may carry fewer (grouped) heads, expanded here by repeat (head
    h <- kv head h // g). f32 scores, softmax and products; the output
    is cast to q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    dev = q.device
    mask = _band_mask(torch.arange(q.shape[1], device=dev),
                      torch.arange(k.shape[1], device=dev), causal, window)
    if mask is not None:
        s = torch.where(mask[None, None], s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
