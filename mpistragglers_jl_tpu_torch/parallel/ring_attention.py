"""Sequence parallelism (ring attention and Ulysses all-to-all) and the
per-device attention pieces that serving shares.

Counterpart of ``mpistragglers_jl_tpu/parallel/ring_attention.py``.
Slice 1 ported the GQA grouping helpers (``_group_scores``,
``_group_pv``), the band mask and the ``"reference"`` per-device
attention; slice 3 resolves ``"flash"`` to the flash-attention kernels
(K1-K4, ``ops/flash_attention.py``). Slice 17 adds the two strategies
over an ``"sp"`` axis of a single-controller mesh (``mesh.py``):

* **Ring attention** (:func:`ring_self_attention`): Q stays on its
  rank; the K/V blocks make n - 1 hops around the ring
  (:func:`.collectives.ring_shift`, the reference's ``ppermute``), and
  the online-softmax carry ``(o, m, l)`` (:func:`_block_update`) makes
  the result exact. Causal and window masks come from global
  positions. It runs einsums, no kernel, as the reference's ring does.
* **Ulysses** (:func:`ulysses_attention`): one tiled
  :func:`.collectives.all_to_all` turns sequence-sharded Q/K/V into
  head-sharded full-sequence tensors, each rank runs the per-device
  attention (``impl="flash"`` launches K1 and, in the backward, K2 and
  K3 or K4 on that rank's tensors), and the inverse all-to-all
  restores the sequence sharding.

The reference writes both as per-shard functions called inside a
``shard_map``. Here they are per-rank programs: each takes and returns
one tensor per mesh position this process drives (``Mesh.local_ranks``
order; every position on a single-controller mesh), on that position's
device, and the collectives between ranks are explicit (across
processes where ``sp`` spans them).
:func:`make_ring_attention` and :func:`make_ulysses_attention` wrap them
over global ``(B, L, H, D)`` values laid out with ``P(None, axis,
None, None)`` (:class:`.mesh.ShardedTensor`). Everything is
differentiable through autograd.
"""

from __future__ import annotations

from functools import partial

import torch

from .collectives import all_to_all, ring_shift
from .mesh import Mesh, PartitionSpec, ShardedTensor, from_local, shard

__all__ = [
    "make_ring_attention",
    "make_ulysses_attention",
    "reference_attention",
    "resolve_attention_impl",
    "ring_self_attention",
    "ulysses_attention",
]

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


def _block_update(q, kc, vc, o, m, l, qpos, kpos, scale, causal,
                  window=None):
    """One online-softmax accumulation step against K/V block (kc, vc).

    q: (B, Lq, H, D); kc/vc: (B, Lk, Hkv, D) where Hkv divides H (GQA;
    Hkv == H is plain MHA); o: (B, Lq, H, D) f32; m, l: (B, H, Lq) f32
    running max and normaliser.
    """
    s = _group_scores(q, kc, scale)
    mask = _band_mask(qpos, kpos, causal, window)
    if mask is not None:
        s = torch.where(mask[None, None], s, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # rows with nothing visible yet keep m=_NEG; their p underflows to 0
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = torch.where(mask[None, None], p, 0.0)
    corr = torch.exp(m - m_new)  # (B, H, Lq)
    l = l * corr + p.sum(dim=-1)
    o = o * corr.transpose(1, 2)[..., None] + _group_pv(p, vc)
    return o, m_new, l


def ring_self_attention(qs, ks, vs, mesh: Mesh, *, axis: str = "sp",
                        causal: bool = False,
                        window: int | None = None) -> list:
    """Exact attention over a ring-sharded sequence, per rank.

    ``qs``, ``ks``, ``vs`` hold each mesh position's local chunk,
    (B, L/n, H, D) and (B, L/n, Hkv, D), with n = ``mesh.shape[axis]``.
    The K/V pair makes n - 1 hops (hop first, then accumulate: block
    ``i`` on the member at coordinate ``me`` came from ``(me - i) %
    n``, so its keys sit at ``src * Lc + arange(Lc)``). Returns each
    position's local (B, L/n, H, D) output in q's dtype.
    """
    n = mesh.shape[axis]
    me = mesh.axis_index(axis)
    Lc = qs[0].shape[1]
    scale = qs[0].shape[-1] ** -0.5

    def positions(c, t):
        return c * Lc + torch.arange(Lc, device=t.device)

    ranks = mesh.local_ranks()
    qpos = [positions(me[r], q) for r, q in zip(ranks, qs)]
    carry = []
    for r, (q, k, v) in enumerate(zip(qs, ks, vs)):
        # step 0: the resident block, no communication
        o0 = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        m0 = torch.full((q.shape[0], q.shape[2], Lc), _NEG,
                        dtype=torch.float32, device=q.device)
        carry.append(_block_update(q, k, v, o0, m0, torch.zeros_like(m0),
                                   qpos[r], qpos[r], scale, causal, window))
    kc, vc = list(ks), list(vs)
    for i in range(1, n):
        kc = ring_shift(kc, mesh, axis)
        vc = ring_shift(vc, mesh, axis)
        carry = [
            _block_update(q, kc[j], vc[j], *carry[j], qpos[j],
                          positions((me[r] - i) % n, q), scale, causal,
                          window)
            for j, (r, q) in enumerate(zip(ranks, qs))]
    out = []
    for q, (o, _, l) in zip(qs, carry):
        l = l.clamp_min(1e-20)  # fully masked rows (non-causal never hits)
        out.append((o / l.transpose(1, 2)[..., None]).to(q.dtype))
    return out


def ulysses_attention(qs, ks, vs, mesh: Mesh, *, axis: str = "sp",
                      causal: bool = False, impl: str = "reference",
                      window: int | None = None,
                      bwd_impl: str = "auto") -> list:
    """All-to-all sequence parallelism, per rank.

    Local chunks (B, L/n, H, D) become (B, L, H/n, D), full sequence and
    a head subset, by one all-to-all; each rank runs ``impl`` (the
    reference or the flash kernels, with ``bwd_impl``) on its heads, and
    the inverse all-to-all restores (B, L/n, H, D). Requires H % n == 0.

    GQA/MQA: k/v may carry Hkv < H heads. When ``Hkv % n == 0`` the kv
    heads split like the q heads. When instead ``n % Hkv == 0`` they are
    first repeated n/Hkv-fold, so that each rank lands exactly the one
    kv head its q-head slice reads. Anything else is rejected.
    """
    n = mesh.shape[axis]
    H, Hkv = qs[0].shape[2], ks[0].shape[2]
    if H % n != 0:
        raise ValueError(
            f"ulysses needs heads ({H}) divisible by the "
            f"sequence-parallel degree ({n})"
        )
    if Hkv % n != 0:
        if n % Hkv != 0:
            raise ValueError(
                f"ulysses with GQA needs kv heads ({Hkv}) and the "
                f"sequence-parallel degree ({n}) to divide one another"
            )
        r = n // Hkv  # now n heads; the member at c gets kv head c // r
        ks = [k.repeat_interleave(r, dim=2) for k in ks]
        vs = [v.repeat_interleave(r, dim=2) for v in vs]
    # (B, L/n, H, D) -> (B, L, H/n, D): split heads, concat sequence
    a2a = partial(all_to_all, mesh=mesh, axis=axis, split_dim=2,
                  concat_dim=1)
    qf, kf, vf = a2a(qs), a2a(ks), a2a(vs)
    kw = {"bwd_impl": bwd_impl} if impl == "flash" else {}
    attn = resolve_attention_impl(impl)
    of = [attn(q, k, v, causal=causal, window=window, **kw)
          for q, k, v in zip(qf, kf, vf)]
    # inverse: split sequence back out, concat heads
    return all_to_all(of, mesh, axis, split_dim=1, concat_dim=2)


def _make_wrapped(inner, mesh: Mesh, axis: str, causal: bool, **kw):
    spec = PartitionSpec(None, axis, None, None)

    def locals_(x):
        if not isinstance(x, ShardedTensor):
            x = shard(x, mesh, spec)
        elif x.mesh is not mesh or tuple(x.spec) != tuple(spec):
            raise ValueError(
                f"need a value laid out as {spec} on this mesh, got "
                f"{x.spec}")
        return x, x.locals()

    def run(q, k, v) -> ShardedTensor:
        (qsh, qs), (_, ks), (_, vs) = locals_(q), locals_(k), locals_(v)
        out = inner(qs, ks, vs, mesh, axis=axis, causal=causal, **kw)
        return from_local(mesh, spec, out, qsh.shape)

    return run


def make_ring_attention(mesh: Mesh, *, axis: str = "sp",
                        causal: bool = False, window: int | None = None):
    """Ring attention over global (B, L, H, D) values sequence-sharded
    along ``axis`` of ``mesh`` (a tensor is sharded first); returns a
    :class:`.mesh.ShardedTensor` laid out the same way."""
    return _make_wrapped(ring_self_attention, mesh, axis, causal,
                         window=window)


def make_ulysses_attention(mesh: Mesh, *, axis: str = "sp",
                           causal: bool = False, impl: str = "reference",
                           window: int | None = None,
                           bwd_impl: str = "auto"):
    """Ulysses attention over global (B, L, H, D) values, as
    :func:`make_ring_attention`."""
    return _make_wrapped(ulysses_attention, mesh, axis, causal, impl=impl,
                         window=window, bwd_impl=bwd_impl)


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
