"""Inference for the flagship transformer: KV caches, the incremental
forward, the positional-cache generator (``generate_dense``) and the
ring-cache generator that is the serving oracle.

Counterpart of ``mpistragglers_jl_tpu/models/decode.py`` (single
device; with experts, every layer runs ``moe_ffn_dense`` at the capacity
of the call's own token count, so a config that drops tokens may drop
differently in prefill than in the full-sequence forward, as in the
reference). Prefill and decode are one incremental forward at two
chunk sizes; the O(W) ring cache keeps position ``p`` at slot
``p % W`` and slot ``s`` at decode position ``pos`` holds position
``kpos(s) = pos - ((pos - s) mod W)``, valid iff ``kpos >= 0``.

Differences from the reference, all deliberate:

* cache writes are IN PLACE (slice assignment): the functions still
  return the cache, but the dict they were given is the one updated;
* an out-of-range write raises instead of clamping (the reference's
  ``dynamic_update_slice`` clamps the start index, which silently
  misplaces K/V, see ``models/serving.py``);
* a Python loop replaces ``lax.scan``.

Over a mesh (``make_prefill``, ``make_decode_step``, ``make_extend``,
``make_generate``, ``make_ring_generate``; the cache by ``init_cache``
with ``mesh``, ``cache_specs`` and ``shard_cache``) the reference's
``shard_map`` program is a per-rank loop on the single-controller mesh
(``parallel/mesh.py``), as the sharded training forward
(``models/transformer.py`` ``_forward_local``): batch over ``dp`` (and
``ep`` with experts), q heads and ``d_ff`` over ``tp``, one ``psum``
over ``tp`` after the attention out-projection and one after the MLP
(``b2``, or the experts' ``be2`` term, outside it). With ``kv_heads <
tp`` the cache's head axis has ``tp`` slots, slot ``t`` holding kv head
``t * kv_heads // tp`` (the replicated-groups layout). Every rank's
cache block is its own buffer, written in place; the entry points take
:func:`~.transformer.shard_params`' tree and global or laid-out token
arrays, and return :class:`~..parallel.mesh.ShardedTensor` values.
Each rank's prefill chunk runs ``cfg.attn_impl`` (K1 under flash) and
each rank's int8 decode step K5 when routed, the routing resolved at
the rank's local batch. Over a mesh that spans processes each process
prefills and decodes its own ranks' rows and the tp psums (and the
experts' all-to-alls over ep) cross processes where those axes do; the
decode loops (positional and ring) run a fixed ``n_new`` with no stop
vote, so no agreement across processes is needed, and the tokens come
back as a value every process can ``gather``. Every guard (a cache
overflow, a bad ``n_new``) is decided from arguments and global shapes,
which every process holds, before any collective: all processes raise
together, and none waits in an exchange for one that raised.

Sampling (``temperature > 0``, ``top_k``, a ``key`` from
``utils/prng.py``) draws the reference's tokens: ``utils/prng.py`` is
bit-equal to ``jax.random``, and ``ops/sampling.py`` ``sample_rows``
folds the key with the position and the batch row as ``_pick_token``
does (one CUDA kernel on the card).

The int8 decode-kernel routing gate (``use_decode_kernel``,
``KERNEL_MIN_BATCH``, ``_route_kernel``, ``_kernel_viable``,
``_kernel_possible``, ``_paged_kernel_possible``) is the reference's,
verbatim, so the port routes exactly the calls the JAX package routes.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .._device import resolve_device
from ..parallel.collectives import psum
from ..parallel.mesh import (
    Mesh,
    PartitionSpec as P,
    ShardedTensor,
    from_local,
    shard,
)
from ..parallel.ring_attention import (
    _band_mask,
    _group_pv,
    _group_scores,
    resolve_attention_impl,
)
from ..ops.sampling import sample_rows
from .moe import moe_ffn_dense, moe_ffn_sharded
from .transformer import (
    TransformerConfig,
    _check_layout,
    _kv_tp_sharded,
    _laid_out,
    _ln,
    _mlp,
    _qkv,
    _rebuild,
    _spec_key,
    make_kv_slice,
    param_specs,
)

__all__ = [
    "init_cache",
    "cache_specs",
    "decode_batch_axes",
    "shard_cache",
    "init_ring_cache",
    "ring_from_cache",
    "prefill_dense",
    "decode_step_dense",
    "decode_step_ring_dense",
    "generate_dense",
    "generate_ring_dense",
    "make_prefill",
    "make_decode_step",
    "make_extend",
    "make_generate",
    "make_ring_generate",
    "use_decode_kernel",
]

_NEG = -1e30  # matches parallel/ring_attention.py

# int8 decode-kernel routing. Tri-state: None (default) = AUTO, route
# the kernel only for batched decode (local batch >= KERNEL_MIN_BATCH);
# True forces it at every batch; False forces the einsum path. The
# threshold is the reference's TPU measurement, kept verbatim.
_USE_DECODE_KERNEL: bool | None = None
KERNEL_MIN_BATCH = 4

_UNSET = object()  # "no snapshot" sentinel for _kernel_possible


def use_decode_kernel(enabled: bool | None) -> None:
    """Set int8 decode-attention routing: ``True`` forces the kernel,
    ``False`` the einsum dequant path, ``None`` restores AUTO (kernel
    iff local batch >= ``KERNEL_MIN_BATCH``). Schedulers resolve it at
    construction."""
    global _USE_DECODE_KERNEL
    _USE_DECODE_KERNEL = None if enabled is None else bool(enabled)


def _route_kernel(use_kernel, B: int) -> bool:
    """Resolve the tri-state toggle at a concrete local batch.
    ``_UNSET`` reads the live global; an explicit ``None`` is a
    snapshot of AUTO and resolves without re-reading it."""
    if use_kernel is _UNSET:
        use_kernel = _USE_DECODE_KERNEL
    if use_kernel is None:
        return B >= KERNEL_MIN_BATCH
    return bool(use_kernel)


def _kernel_viable(q, cache_l) -> bool:
    """Shape gate shared by every int8-kernel call site: quantized
    cache, single query, head_dim a multiple of 128, a GQA group of at
    most 8, and a cache length the reference's block picker accepts
    (``ops.decode_attention.decode_kernel_viable``)."""
    if not _is_quantized(cache_l):
        return False
    Hq, Hkv = q.shape[2], cache_l["k"].shape[2]
    if (
        q.shape[1] != 1
        or q.shape[-1] % 128 != 0
        or Hq % Hkv != 0
        or Hq // Hkv > 8
    ):
        return False
    from ..ops.decode_attention import decode_kernel_viable

    return decode_kernel_viable(cache_l["k"].shape[1], Hkv, q.shape[-1])


def _kernel_possible(cfg, quantize_kv: bool, use_kernel=_UNSET) -> bool:
    """Could a program for ``cfg`` route T=1 cached attention through
    the int8 kernel? Toggle not forced off, quantized cache, head_dim a
    multiple of 128; AUTO counts as possible."""
    if use_kernel is _UNSET:
        use_kernel = _USE_DECODE_KERNEL
    return bool(
        quantize_kv and use_kernel is not False
        and cfg.head_dim % 128 == 0
    )


def _paged_kernel_possible(cfg, quantize_kv: bool, page_tokens: int,
                           use_kernel=_UNSET) -> bool:
    """Could the paged serving tick route the paged int8 kernel?
    ``_kernel_possible``, plus a GQA group of at most 8 and a page size
    the reference's paged kernel streams
    (``ops.decode_attention.paged_block_viable``). The scheduler
    resolves it once, at construction."""
    if not _kernel_possible(cfg, quantize_kv, use_kernel):
        return False
    if cfg.n_heads // cfg.kv_heads > 8 or cfg.n_heads % cfg.kv_heads:
        return False
    from ..ops.decode_attention import paged_block_viable

    return paged_block_viable(page_tokens)


# --------------------------------------------------------------------------
# int8 KV-cache quantization
# --------------------------------------------------------------------------


def _kv_quantize(x):
    """Per-(batch, position, head) absmax int8 quantization over the
    head_dim axis: ``x ~= x_i8 * s[..., None]``; round half to even,
    scale clamped at 1e-8 (all-zero rows)."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / 127.0
    s = s.clamp_min(1e-8)
    return torch.round(xf / s[..., None]).to(torch.int8), s


def _is_quantized(cache_l: dict) -> bool:
    return "k_s" in cache_l


def _expand_kv_scale(s, Hq):
    """(B, L, Hkv) per-position scales -> (B, Hq, 1, L), each kv head's
    scale repeated over its GQA group."""
    g = Hq // s.shape[2]
    if g > 1:
        s = s.repeat_interleave(g, dim=2)
    return s.permute(0, 2, 1)[:, :, None, :]


def _cache_write(cache_l: dict, k, v, off: int) -> dict:
    """Write a chunk's K/V at position offset ``off`` IN PLACE,
    quantizing when the cache is int8. Raises when the chunk does not
    fit (the reference clamps the offset instead)."""
    T, L = k.shape[1], cache_l["k"].shape[1]
    if off < 0 or off + T > L:
        raise ValueError(
            f"chunk [{off}, {off + T}) does not fit the cache of {L} "
            "positions"
        )
    sl = slice(off, off + T)
    if not _is_quantized(cache_l):
        cache_l["k"][:, sl] = k.to(cache_l["k"].dtype)
        cache_l["v"][:, sl] = v.to(cache_l["v"].dtype)
        return cache_l
    kq, ks = _kv_quantize(k)
    vq, vs = _kv_quantize(v)
    cache_l["k"][:, sl] = kq
    cache_l["v"][:, sl] = vq
    cache_l["k_s"][:, sl] = ks
    cache_l["v_s"][:, sl] = vs
    return cache_l


def _cache_scores(q, cache_l: dict, scale):
    """Grouped f32 scores against the cache; int8 K dequantizes via the
    rank-1 score correction."""
    kc = cache_l["k"]
    if not _is_quantized(cache_l):
        return _group_scores(q, kc, scale)
    s = _group_scores(q, kc.to(q.dtype), scale)
    return s * _expand_kv_scale(cache_l["k_s"], q.shape[2])


def _cache_pv(p, cache_l: dict):
    """Grouped probs x V; int8 V dequantizes by folding its scale into
    the probabilities."""
    if _is_quantized(cache_l):
        p = p * _expand_kv_scale(cache_l["v_s"], p.shape[1])
    return _group_pv(p, cache_l["v"])


def _zero_cache_layer(B, L, H, Dh, dtype, quantize_kv, device):
    kvdt = torch.int8 if quantize_kv else dtype
    layer = {
        "k": torch.zeros((B, L, H, Dh), dtype=kvdt, device=device),
        "v": torch.zeros((B, L, H, Dh), dtype=kvdt, device=device),
    }
    if quantize_kv:
        layer["k_s"] = torch.zeros((B, L, H), device=device)
        layer["v_s"] = torch.zeros((B, L, H), device=device)
    return layer


def _cache_heads_global(cfg: TransformerConfig, mesh: Mesh | None) -> int:
    """Global cache head count: ``kv_heads``, or ``tp`` replicated-group
    slots when kv_heads < tp (slot ``t`` holds kv head ``t * kv_heads //
    tp``, computed by tp member t from its tp-replicated K/V
    projections: the layout needs no extra collective)."""
    if mesh is None or "tp" not in mesh.axis_names:
        return cfg.kv_heads
    return cfg.kv_heads if _kv_tp_sharded(cfg, mesh) else mesh.shape["tp"]


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               mesh: Mesh | None = None, *, quantize_kv: bool = False,
               device=None) -> list[dict]:
    """Zeroed per-layer positional cache: {"k","v"} of
    ``(B, max_len, cache_heads, head_dim)``, int8 plus f32 ``(B,
    max_len, cache_heads)`` scales {"k_s","v_s"} when ``quantize_kv``.
    ``cache_heads`` is ``kv_heads``, or the ``tp`` slots of the
    replicated-groups layout when ``mesh``'s tp exceeds kv_heads
    (:func:`shard_cache` then lays it out). Every leaf is its own
    buffer (writes are in place)."""
    dev = resolve_device(device)
    return [
        _zero_cache_layer(batch, max_len, _cache_heads_global(cfg, mesh),
                          cfg.head_dim, cfg.dtype, quantize_kv, dev)
        for _ in range(cfg.n_layers)
    ]


def _cached_attention(q, cache_l, qpos, scale, window=None,
                      use_kernel=_UNSET):
    """Grouped attention of the chunk's queries against the positional
    cache (validity ``kpos <= qpos``, plus the band when ``window``);
    int8 caches at T == 1 take the decode kernel when routed."""
    if _route_kernel(use_kernel, q.shape[0]) and _kernel_viable(
        q, cache_l
    ):
        from ..ops.decode_attention import quantized_decode_attention

        return quantized_decode_attention(q, cache_l, qpos[0], scale,
                                          window)
    Lmax = cache_l["k"].shape[1]
    s = _cache_scores(q, cache_l, scale)  # (B, H, T, Lmax) f32
    mask = _band_mask(qpos, torch.arange(Lmax, device=q.device), True,
                      window)
    s = torch.where(mask[None, None], s, _NEG)
    p = torch.softmax(s, dim=-1)
    return _cache_pv(p, cache_l).to(q.dtype)


def _ring_cached_attention(q, cache_l, pos, scale, use_kernel=_UNSET):
    """Single-query attention against an O(W) ring cache at scalar
    position ``pos``: ``kpos >= 0`` is the whole mask (causal bound,
    window bound and warm-up guard at once)."""
    W = cache_l["k"].shape[1]
    if _route_kernel(use_kernel, q.shape[0]) and _kernel_viable(
        q, cache_l
    ):
        from ..ops.decode_attention import quantized_decode_attention

        return quantized_decode_attention(q, cache_l, pos, scale,
                                          ring=True)
    s = _cache_scores(q, cache_l, scale)  # (B, H, 1, W) f32
    slots = torch.arange(W, device=q.device)
    kpos = pos - torch.remainder(pos - slots, W)
    s = torch.where((kpos >= 0)[None, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    return _cache_pv(p, cache_l).to(q.dtype)


def _attend(q, k, v, cache_l, qpos, off: int, cfg, *, chunk_attn,
            ring=False, decode_kernel=_UNSET):
    """Write a chunk's K/V at ``off`` (slot ``off % W`` in ring mode) in
    place, then attend: the one write-and-attend path of the dense and
    the per-rank forwards, so the int8 kernel's routing
    (``_route_kernel`` at the caller's local batch, ``_kernel_viable``)
    is decided in one place. Returns (o, cache_l)."""
    if ring:
        off = off % cache_l["k"].shape[1]
    cache_l = _cache_write(cache_l, k, v, off)
    scale = cfg.head_dim ** -0.5
    if chunk_attn is not None:
        # prefill at offset 0: attention on the exact chunk K/V; only
        # the cache quantizes
        return chunk_attn(q, k, v), cache_l
    if ring:
        return _ring_cached_attention(q, cache_l, qpos[0], scale,
                                      use_kernel=decode_kernel), cache_l
    return _cached_attention(q, cache_l, qpos, scale, cfg.attn_window,
                             use_kernel=decode_kernel), cache_l


def _incremental_layer(x, lp, cache_l, qpos, off: int, cfg, *,
                       chunk_attn, ring=False, decode_kernel=_UNSET):
    """One layer of the incremental forward: write the chunk's K/V at
    ``off`` (slot ``off % W`` in ring mode) in place, attend, MLP (or
    the experts). Returns (x, cache_l)."""
    o, cache_l = _attend(*_qkv(x, lp, qpos), cache_l, qpos, off, cfg,
                         chunk_attn=chunk_attn, ring=ring,
                         decode_kernel=decode_kernel)
    x = x + torch.einsum("blhk,hkd->bld", o, lp["wo"])
    h2 = _ln(x, lp["ln2_s"], lp["ln2_b"])
    if cfg.n_experts:
        return x + moe_ffn_dense(h2, lp, cfg.capacity_factor)[0], cache_l
    return x + _mlp(h2, lp) + lp["b2"], cache_l


def _check_ring_chunk(T: int, prefill: bool, ring: bool) -> None:
    if ring and (T != 1 or prefill):
        raise ValueError(
            "ring cache reads are decode-only (T == 1): prefill runs "
            "positionally, then ring_from_cache gathers the window"
        )


def _chunk_attention(cfg: TransformerConfig):
    """The prefill chunk's attention: ``cfg.attn_impl`` (flash runs K1),
    causal, the config's window."""
    impl = resolve_attention_impl(cfg.attn_impl)

    def chunk_attn(q, k, v):
        return impl(q, k, v, causal=True, window=cfg.attn_window)

    return chunk_attn


def _incremental_forward(params, tokens, cache, offset: int, cfg, *,
                         prefill, ring=False, decode_kernel=_UNSET):
    """Chunk forward at global ``offset`` (a Python int); returns
    (logits (B, T, V), cache). ``prefill=True`` means offset 0 and
    chunk attention through the configured per-device kernel;
    otherwise attention reads the cache (the O(W) ring when
    ``ring=True``, decode only)."""
    T = tokens.shape[1]
    _check_ring_chunk(T, prefill, ring)
    qpos = offset + torch.arange(T, device=tokens.device)
    chunk_attn = _chunk_attention(cfg) if prefill else None
    x = params["emb"][tokens]
    new_cache = []
    for lp, cache_l in zip(params["layers"], cache):
        x, cache_l = _incremental_layer(
            x, lp, cache_l, qpos, offset, cfg, chunk_attn=chunk_attn,
            ring=ring, decode_kernel=decode_kernel,
        )
        new_cache.append(cache_l)
    x = _ln(x, params["lnf_s"], params["lnf_b"])
    return torch.einsum("bld,vd->blv", x, params["emb"]), new_cache


def _check_prefill_fits(T: int, cache) -> None:
    Lmax = cache[0]["k"].shape[1]
    if T > Lmax:
        raise ValueError(
            f"chunk of {T} tokens does not fit the cache (max_len "
            f"{Lmax}); build the cache at least prompt+decode long"
        )


def _aligned_quantized_prefill(params, prompt, cache, cfg, *,
                               decode_kernel, chunk=512):
    """Quantized-ring oracle prefill in C-token chunks, each attending
    the ALREADY-QUANTIZED cache (``prefill=False``): the only math the
    scheduler's chunked admission can evaluate. Per-position absmax
    quantization makes the chunk size invisible. Returns the last
    chunk's logits and the cache."""
    Tp = prompt.shape[1]
    _check_prefill_fits(Tp, cache)
    logits = None
    for off in range(0, Tp, chunk):
        logits, cache = _incremental_forward(
            params, prompt[:, off:off + chunk], cache, off, cfg,
            prefill=False, decode_kernel=decode_kernel,
        )
    return logits, cache


def prefill_dense(params, tokens, cache, cfg: TransformerConfig):
    """Fill the cache from a prompt (exact chunk attention); returns
    (logits (B, T, V), cache)."""
    _check_prefill_fits(tokens.shape[1], cache)
    return _incremental_forward(params, tokens, cache, 0, cfg,
                                prefill=True)


def _check_ring_cfg(cfg: TransformerConfig) -> int:
    if cfg.attn_window is None:
        raise ValueError(
            "the ring cache is the sliding-window cache: set "
            "TransformerConfig(attn_window=W) to use it"
        )
    return cfg.attn_window


def init_ring_cache(cfg: TransformerConfig, batch: int,
                    mesh: Mesh | None = None, *, quantize_kv: bool = False,
                    device=None) -> list[dict]:
    """Zeroed per-layer ring cache: (B, attn_window, cache_heads, Dh),
    laid out over a mesh by :func:`cache_specs` as the positional
    cache."""
    W = _check_ring_cfg(cfg)
    return init_cache(cfg, batch, W, mesh, quantize_kv=quantize_kv,
                      device=device)


def _ring_from_cache(cache_l: dict, Tp: int, W: int) -> dict:
    """Gather a positional cache holding positions [0, Tp) into the
    ring layout: slot ``s`` <- the latest position congruent to ``s``
    (mod W); slots no position reached stay zero. ``Tp`` is a host
    int. Returns new tensors."""
    dev = cache_l["k"].device
    s = torch.arange(W, device=dev)
    p = (Tp - 1) - torch.remainder((Tp - 1) - s, W)
    valid = p >= 0
    idx = p.clamp_min(0)

    def gather(a):
        g = a.index_select(1, idx)
        shape = (1, W) + (1,) * (a.dim() - 2)
        return torch.where(valid.reshape(shape), g, torch.zeros_like(g))

    return {kk: gather(a) for kk, a in cache_l.items()}


def ring_from_cache(cache, Tp: int, cfg: TransformerConfig) -> list[dict]:
    """Convert a positional cache holding prompt positions [0, Tp) into
    the O(W) ring layout :func:`decode_step_ring_dense` consumes."""
    W = _check_ring_cfg(cfg)
    have = cache[0]["k"].shape[1] if cache else 0
    if have < Tp:
        raise ValueError(
            f"source cache holds {have} positions < prompt {Tp}; the "
            "ring gather needs every prompt position present"
        )
    return [_ring_from_cache(cl, Tp, W) for cl in cache]


def decode_step_ring_dense(params, token, cache, pos: int,
                           cfg: TransformerConfig):
    """One decode step against the ring cache: ``token`` (B,) at global
    position ``pos``; the cache updates in place. Returns
    (logits (B, V), cache)."""
    _check_ring_cfg(cfg)
    logits, cache = _incremental_forward(
        params, token[:, None], cache, int(pos), cfg, prefill=False,
        ring=True,
    )
    return logits[:, 0], cache


def _check_sampling_params(temperature, top_k) -> None:
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")


def _check_sampling(temperature, top_k, key) -> None:
    """The reference's checks: a key only with ``temperature > 0``, and
    always then."""
    _check_sampling_params(temperature, top_k)
    if temperature == 0.0 and key is not None:
        raise ValueError("a PRNG key is only meaningful with "
                         "temperature > 0 (greedy decoding is "
                         "deterministic)")
    if temperature > 0.0 and key is None:
        raise ValueError("temperature > 0 needs a PRNG key "
                         "(utils.prng.key)")


def _pick_token(logits, pos=None, keys=None, rows=None,
                temperature: float = 0.0, top_k: int | None = None):
    """Next token per row of ``logits`` (B, V): greedy (the first
    maximal index, as ``jnp.argmax``) at temperature 0, else sampled
    with row b's key ``fold_in(fold_in(keys[b], pos[b]), rows[b])``
    (``ops/sampling.py``; device tensors ``pos``, ``rows`` (B,) and
    ``keys`` (B, 2)). Returns int32 (B,)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return sample_rows(logits, pos, keys, rows, temperature, top_k)


def _picker(B: int, dev, temperature: float, top_k, key, row0: int = 0):
    """The generators' choice ``pick(logits, pos)`` at a host position:
    greedy, or batch row b sampled with ``fold_in(fold_in(key, pos),
    row0 + b)``, the reference's fold: ``row0`` is the global batch row
    of this rank's first row (0 on one device)."""
    if temperature == 0.0:
        return lambda lg, pos: _pick_token(lg)
    keys = torch.as_tensor(key).to(dev, torch.int64)
    if tuple(keys.shape) != (2,):
        raise ValueError(f"key must be one key of shape (2,), got "
                         f"{tuple(keys.shape)}")
    keys = keys.expand(B, 2).contiguous()
    rows = row0 + torch.arange(B, dtype=torch.int32, device=dev)

    def pick(lg, pos: int):
        p = torch.full((B,), pos, dtype=torch.int32, device=dev)
        return _pick_token(lg, p, keys, rows, temperature, top_k)

    return pick


def _eos_clamp(nxt, tok, done, eos_id):
    """Static-shape EOS handling: once a row has emitted ``eos_id``
    every later token is forced to it. Returns (next_token, done)."""
    if eos_id is None:
        return nxt, done
    done = done | (tok == eos_id)
    return torch.where(done, torch.full_like(nxt, eos_id), nxt), done


def _decode_loop(step, toks, Tp: int, n_new: int, eos_id, picks) -> list:
    """The decode loop of every generator, dense (one rank) or over a
    mesh: ``toks`` holds each rank's (B,) prefill pick, then ``n_new -
    1`` decode forwards ``step(toks, pos) -> [logits (B, V)]`` (one per
    rank), each rank's token chosen by its ``picks[r](logits, pos)`` at
    the position it was fed at (the last token emitted is never fed
    back). Returns each rank's (B, n_new) int32 tokens."""
    done = [torch.zeros_like(t, dtype=torch.bool) for t in toks]
    out = [[] for _ in toks]
    for pos in range(Tp, Tp + n_new - 1):
        nxt = []
        for r, lg in enumerate(step(toks, pos)):
            t, done[r] = _eos_clamp(picks[r](lg, pos), toks[r], done[r],
                                    eos_id)
            out[r].append(toks[r])
            nxt.append(t)
        toks = nxt
    return [torch.stack(o + [t], dim=1) for o, t in zip(out, toks)]


def _dense_step(params, c, cfg, *, ring, use_kernel):
    """:func:`_decode_loop`'s step on one device, over cache ``c``."""

    def step(toks, pos):
        lg, _ = _incremental_forward(
            params, toks[0][:, None], c, pos, cfg, prefill=False, ring=ring,
            decode_kernel=use_kernel,
        )
        return [lg[:, 0]]

    return step


def _generation_setup(prompt, n_new: int, temperature, top_k, key,
                      quantize_kv, cfg, device):
    """Checks and routing shared by both generators: (device, prompt as
    int64 on it, use_kernel, pick), the routing resolved once per
    call."""
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")
    _check_sampling(temperature, top_k, key)
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int64)
    use_kernel = (_kernel_possible(cfg, quantize_kv)
                  and _route_kernel(_UNSET, prompt.shape[0]))
    pick = _picker(prompt.shape[0], dev, float(temperature), top_k, key)
    return dev, prompt, use_kernel, pick


def decode_step_dense(params, token, cache, pos: int,
                      cfg: TransformerConfig):
    """One decode step against the positional cache: ``token`` (B,) at
    global position ``pos`` (a host int below the cache's max_len; a
    write past it raises). The cache updates in place. Returns
    (logits (B, V), cache)."""
    logits, cache = _incremental_forward(
        params, token[:, None], cache, int(pos), cfg, prefill=False,
    )
    return logits[:, 0], cache


def generate_dense(params, prompt, n_new: int, cfg: TransformerConfig,
                   max_len: int | None = None, *,
                   temperature: float = 0.0, top_k: int | None = None,
                   key=None, eos_id: int | None = None,
                   quantize_kv: bool = False, device=None):
    """Generation over the positional ``max_len`` cache (default
    ``Tp + n_new``): exact prefill through ``cfg.attn_impl`` (flash runs
    K1), then one decode forward per token, int8 caches through K5 when
    routed. Greedy by default; ``temperature > 0`` samples (optionally
    top-k truncated) with ``key`` (``utils/prng.py``), the first token
    at position ``Tp - 1``, each later one at its own. ``prompt`` (B, Tp)
    int tokens -> (B, n_new) int32 tokens; rows that emit ``eos_id``
    keep emitting it. ``device`` defaults to ``cuda``; ``params`` must
    live there."""
    dev, prompt, use_kernel, pick = _generation_setup(
        prompt, n_new, temperature, top_k, key, quantize_kv, cfg, device)
    B, Tp = prompt.shape
    if max_len is None:
        max_len = Tp + n_new
    if max_len < Tp + n_new:
        raise ValueError(
            f"max_len {max_len} < prompt {Tp} + n_new {n_new}: decode "
            "positions would not fit the cache"
        )
    with torch.no_grad():
        c = init_cache(cfg, B, max_len, quantize_kv=quantize_kv, device=dev)
        logits, c = prefill_dense(params, prompt, c, cfg)
        tok = pick(logits[:, -1], Tp - 1)
        del logits  # the (B, Tp, V) prefill logits, before the loop
        step = _dense_step(params, c, cfg, ring=False, use_kernel=use_kernel)
        return _decode_loop(step, [tok], Tp, n_new, eos_id, [pick])[0]


def generate_ring_dense(params, prompt, n_new: int,
                        cfg: TransformerConfig, *,
                        temperature: float = 0.0, top_k: int | None = None,
                        key=None, eos_id: int | None = None,
                        quantize_kv: bool = False, device=None):
    """Sliding-window generation over the O(W) ring cache: ``prompt``
    (B, Tp) int tokens -> (B, n_new) int32 tokens, greedy or sampled as
    :func:`generate_dense`.

    With ``quantize_kv=True`` this is THE serving oracle: prefill
    attends the already-quantized cache exactly like the scheduler's
    chunked admission, so a scheduler slot reproduces this stream as
    an identity. ``device`` defaults to ``cuda``; ``params`` must live
    there."""
    W = _check_ring_cfg(cfg)
    dev, prompt, use_kernel, pick = _generation_setup(
        prompt, n_new, temperature, top_k, key, quantize_kv, cfg, device)
    B, Tp = prompt.shape
    with torch.no_grad():
        c = init_cache(cfg, B, Tp, quantize_kv=quantize_kv, device=dev)
        if quantize_kv:
            logits, c = _aligned_quantized_prefill(
                params, prompt, c, cfg, decode_kernel=use_kernel,
            )
        else:
            logits, c = prefill_dense(params, prompt, c, cfg)
        c = [_ring_from_cache(cl, Tp, W) for cl in c]
        step = _dense_step(params, c, cfg, ring=True, use_kernel=use_kernel)
        return _decode_loop(step, [pick(logits[:, -1], Tp - 1)], Tp, n_new,
                            eos_id, [pick])[0]


# --------------------------------------------------------------------------
# sharded (dp [x ep] x tp mesh) API
# --------------------------------------------------------------------------


def decode_batch_axes(cfg: TransformerConfig) -> tuple[str, ...]:
    """Mesh axes the batch shards over at decode: MoE configs add
    ``ep`` (every expert-parallel member routes distinct rows, the
    training path's GShard layout)."""
    return ("dp", "ep") if cfg.n_experts else ("dp",)


def cache_specs(cfg: TransformerConfig, *,
                quantize_kv: bool = False) -> list[dict]:
    """PartitionSpecs of the cache: batch over dp (and ep for MoE),
    heads over tp; int8 scales shard as their K/V."""
    s = P(decode_batch_axes(cfg), None, "tp", None)
    layer = {"k": s, "v": s}
    if quantize_kv:
        ss = P(decode_batch_axes(cfg), None, "tp")
        layer["k_s"], layer["v_s"] = ss, ss
    return [dict(layer) for _ in range(cfg.n_layers)]


def shard_cache(cache, cfg: TransformerConfig, mesh: Mesh) -> list[dict]:
    """Lay a global cache (:func:`init_cache` with ``mesh``) out by
    :func:`cache_specs`: a tree of :class:`ShardedTensor` in which every
    position holds its own copy of its block, so a position replicated
    over an axis the specs do not name writes only its own buffer."""
    return [{kk: shard(a, mesh, spec[kk]) for kk, a in layer.items()}
            for layer, spec in zip(cache, cache_specs(
                cfg, quantize_kv=_is_quantized(cache[0])))]


def _check_decode_mesh(cfg: TransformerConfig, mesh: Mesh) -> None:
    """MoE decode composes expert parallelism: the mesh carries ``ep``
    (size 1 folds the experts onto each member) beside dp and tp, as
    the training path; then :func:`~.transformer._check_layout`."""
    need = {"dp", "tp"} | ({"ep"} if cfg.n_experts else set())
    missing = need - set(mesh.axis_names)
    if missing:
        raise ValueError(
            f"decode mesh is missing axes {sorted(missing)}; MoE "
            "configs shard over (dp, ep, tp), dense over (dp, tp)"
        )
    _check_layout(cfg, mesh)


def _rank_params(params, cfg, mesh) -> list:
    """Each position's tree of local shards of :func:`shard_params`'
    tree."""
    leaves = _laid_out(params, param_specs(cfg, mesh), mesh,
                       "shard_params(params, cfg, mesh)")
    return [_rebuild(params, iter(leaf.local(r) for leaf in leaves))
            for r in mesh.local_ranks()]


def _rank_blocks(x, mesh: Mesh, spec) -> tuple[list, tuple]:
    """Each position's block of ``x`` (a global array, or a
    :class:`ShardedTensor` laid out by ``spec``) and the global shape."""
    if isinstance(x, ShardedTensor):
        if x.mesh is not mesh or _spec_key(x.spec) != _spec_key(spec):
            raise ValueError(f"expected a value laid out as {spec} on the "
                             f"mesh, got {x}")
        return x.locals(), x.shape
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))
    sh = shard(t, mesh, spec)
    return sh.locals(), sh.shape


def _rank_tokens(x, cfg, mesh, trailing: int) -> tuple[list, tuple]:
    """Each position's int64 token block of a (B[, T]) array laid out
    over the decode batch axes."""
    spec = P(decode_batch_axes(cfg), *([None] * trailing))
    blocks, shape = _rank_blocks(x, mesh, spec)
    return [b.long() for b in blocks], shape


def _rank_caches(cache, cfg, mesh, quantize_kv: bool):
    """(the cache as a tree of ShardedTensor, each position's list of
    layer dicts of its local blocks). A global cache is laid out first
    (a copy: the caller then reads the returned tree); a laid-out one is
    checked against :func:`cache_specs` and written in place."""
    if _is_quantized(cache[0]) != quantize_kv:
        raise ValueError(
            f"quantize_kv={quantize_kv} but the cache is "
            f"{'int8' if _is_quantized(cache[0]) else 'not int8'}: build "
            "it with init_cache(..., quantize_kv=...) to match")
    heads = _cache_heads_global(cfg, mesh)
    if cache[0]["k"].shape[2] != heads:
        raise ValueError(
            f"the cache holds {cache[0]['k'].shape[2]} heads, the mesh's "
            f"layout {heads}: build it with init_cache(cfg, B, L, mesh)")
    if not isinstance(cache[0]["k"], ShardedTensor):
        cache = shard_cache(cache, cfg, mesh)
    for layer, spec in zip(cache, cache_specs(cfg, quantize_kv=quantize_kv)):
        for kk, a in layer.items():
            if a.mesh is not mesh or _spec_key(a.spec) != _spec_key(spec[kk]):
                raise ValueError(f"cache leaf {kk} laid out as {a.spec}, "
                                 f"cache_specs says {spec[kk]}")
    local = [[{kk: a.local(r) for kk, a in layer.items()} for layer in cache]
             for r in mesh.local_ranks()]
    return cache, local


def _layers_local(lparams, xs, cfg, mesh, attend):
    """The per-rank layer stack over a mesh, shared by the decode and
    serving programs: ``lparams[j]`` and ``xs[j]`` (B', T, d) are those
    of the j-th position this process drives (``mesh.local_ranks()``).
    Per layer ``attend(j, i, x, lp, kv_slice)`` gives that rank's
    attention output on its q-head shard (its cache written in
    place; ``kv_slice``, from :func:`make_kv_slice`, picks the rank's kv
    head when kv_heads < tp), then the out-projection's partial sums
    meet in a ``psum`` over ``tp``, as do the MLP's d_ff shards, ``b2``
    added outside it (with experts ``moe_ffn_sharded``, its ``be2``
    term outside). Every tp member ends with the same logits. Returns
    each rank's (B', T, V) logits."""
    kv = make_kv_slice(cfg, mesh)
    slices = [None if kv is None else partial(kv, rank=r)
              for r in mesh.local_ranks()]
    for i in range(cfg.n_layers):
        lps = [lp["layers"][i] for lp in lparams]
        outs = [torch.einsum("blhk,hkd->bld", attend(r, i, x, lp, slices[r]),
                             lp["wo"])
                for r, (x, lp) in enumerate(zip(xs, lps))]
        xs = [x + a for x, a in zip(xs, psum(outs, mesh, "tp"))]
        hs = [_ln(x, lp["ln2_s"], lp["ln2_b"]) for x, lp in zip(xs, lps)]
        if cfg.n_experts:
            y, bias, _ = moe_ffn_sharded(hs, lps, cfg.capacity_factor,
                                         mesh=mesh)
            xs = [x + yi + bi
                  for x, yi, bi in zip(xs, psum(y, mesh, "tp"), bias)]
        else:
            y = psum([_mlp(h, lp) for h, lp in zip(hs, lps)], mesh, "tp")
            xs = [x + yi + lp["b2"] for x, yi, lp in zip(xs, y, lps)]
    return [torch.einsum("bld,vd->blv", _ln(x, lp["lnf_s"], lp["lnf_b"]),
                         lp["emb"]) for x, lp in zip(xs, lparams)]


def _incremental_forward_local(lparams, ltokens, lcaches, offset: int, cfg,
                               mesh, *, prefill, ring=False,
                               decode_kernel=_UNSET):
    """The per-rank incremental forward over a mesh: ``lparams[j]``,
    ``ltokens[j]`` (B', T) and ``lcaches[j]`` (layer dicts) are those of
    the j-th position this process drives. :func:`_layers_local` with :func:`_attend` as each
    rank's attention half. Returns (each rank's (B', T, V) logits, each
    rank's caches, written in place)."""
    _check_ring_chunk(ltokens[0].shape[1], prefill, ring)
    T = ltokens[0].shape[1]
    qpos = [offset + torch.arange(T, device=t.device) for t in ltokens]
    chunk_attn = _chunk_attention(cfg) if prefill else None

    def attend(r, i, x, lp, kv_slice):
        o, lcaches[r][i] = _attend(
            *_qkv(x, lp, qpos[r], kv_slice), lcaches[r][i], qpos[r], offset,
            cfg, chunk_attn=chunk_attn, ring=ring,
            decode_kernel=decode_kernel)
        return o

    xs = [lp["emb"][t] for lp, t in zip(lparams, ltokens)]
    return _layers_local(lparams, xs, cfg, mesh, attend), lcaches


def _aligned_quantized_prefill_local(lparams, lprompts, lcaches, cfg, mesh,
                                     *, decode_kernel, chunk=512):
    """:func:`_aligned_quantized_prefill` per rank: the quantized-ring
    oracle prefill in C-token chunks, each attending the already
    quantized cache. Returns each rank's last-chunk logits and
    caches."""
    Tp = lprompts[0].shape[1]
    _check_prefill_fits(Tp, lcaches[0])
    logits = None
    for off in range(0, Tp, chunk):
        logits, lcaches = _incremental_forward_local(
            lparams, [p[:, off:off + chunk] for p in lprompts], lcaches,
            off, cfg, mesh, prefill=False, decode_kernel=decode_kernel)
    return logits, lcaches


def _batch_row0(cfg, mesh: Mesh, r: int, B: int) -> int:
    """The global batch row of flat position ``r``'s first row: the
    mixed-radix index over :func:`decode_batch_axes` (dp-major, then
    ep) times the local batch ``B``."""
    row0 = 0
    for ax in decode_batch_axes(cfg):
        row0 = row0 * mesh.shape[ax] + mesh.axis_index(ax)[r]
    return row0 * B


def make_prefill(cfg: TransformerConfig, mesh: Mesh, *,
                 quantize_kv: bool = False):
    """``prefill(params, tokens (B, Tp), cache) -> (last-position logits
    (B, V), cache)`` over ``mesh``: :func:`shard_params`' tree, tokens
    global or laid out over the batch axes (:func:`decode_batch_axes`),
    the cache from :func:`init_cache` with ``mesh`` (laid out here) or
    :func:`shard_cache`, written in place. Batch over dp (and ep for
    MoE, expert routing sharded with the all-to-alls over ep, as in
    training), heads over tp; every rank's prefill chunk runs
    ``cfg.attn_impl`` (flash launches K1 once per rank per layer).
    ``quantize_kv`` must match the cache. Logits come back as a
    :class:`ShardedTensor` laid out ``P(batch axes, None)``."""
    _check_decode_mesh(cfg, mesh)
    bax = decode_batch_axes(cfg)

    def prefill(params, tokens, cache):
        lparams = _rank_params(params, cfg, mesh)
        toks, (B, _) = _rank_tokens(tokens, cfg, mesh, 1)
        cache, lcaches = _rank_caches(cache, cfg, mesh, quantize_kv)
        _check_prefill_fits(toks[0].shape[1], lcaches[0])
        with torch.no_grad():
            logits, _ = _incremental_forward_local(
                lparams, toks, lcaches, 0, cfg, mesh, prefill=True)
        return from_local(mesh, P(bax, None), [lg[:, -1] for lg in logits],
                          (B, cfg.vocab)), cache

    return prefill


def make_decode_step(cfg: TransformerConfig, mesh: Mesh, *,
                     quantize_kv: bool = False):
    """``step(params, token (B,), cache, pos) -> (logits (B, V),
    cache)``: one decode step at host position ``pos`` (a write past the
    cache raises). The int8 kernel's routing is snapshotted now and
    resolved at each rank's local batch: an int8 cache takes K5 once per
    rank per layer when routed."""
    _check_decode_mesh(cfg, mesh)
    bax = decode_batch_axes(cfg)
    use_kernel = _USE_DECODE_KERNEL  # make-time snapshot

    def step(params, token, cache, pos):
        lparams = _rank_params(params, cfg, mesh)
        toks, (B,) = _rank_tokens(token, cfg, mesh, 0)
        cache, lcaches = _rank_caches(cache, cfg, mesh, quantize_kv)
        with torch.no_grad():
            logits, _ = _incremental_forward_local(
                lparams, [t[:, None] for t in toks], lcaches, int(pos), cfg,
                mesh, prefill=False, decode_kernel=use_kernel)
        return from_local(mesh, P(bax, None), [lg[:, 0] for lg in logits],
                          (B, cfg.vocab)), cache

    return step


def make_extend(cfg: TransformerConfig, mesh: Mesh, *,
                quantize_kv: bool = False):
    """``extend(params, tokens (B, T), cache, offset) -> (logits (B, T,
    V), cache)``: a T-token chunk at any host ``offset``, attending
    causally within the chunk and to everything cached below it (the
    masked cached-attention path), so a streaming prefill equals the
    one-shot :func:`make_prefill` position for position. A chunk past
    the cache raises (the reference clamps its offset)."""
    _check_decode_mesh(cfg, mesh)
    bax = decode_batch_axes(cfg)
    use_kernel = _USE_DECODE_KERNEL  # make-time snapshot

    def extend(params, tokens, cache, offset):
        lparams = _rank_params(params, cfg, mesh)
        toks, (B, T) = _rank_tokens(tokens, cfg, mesh, 1)
        cache, lcaches = _rank_caches(cache, cfg, mesh, quantize_kv)
        _check_prefill_fits(T, lcaches[0])
        with torch.no_grad():
            logits, _ = _incremental_forward_local(
                lparams, toks, lcaches, int(offset), cfg, mesh,
                prefill=False, decode_kernel=use_kernel)
        return from_local(mesh, P(bax, None, None), logits,
                          (B, T, cfg.vocab)), cache

    return extend


def make_generate(cfg: TransformerConfig, mesh: Mesh, n_new: int,
                  max_len: int | None = None, *,
                  temperature: float = 0.0, top_k: int | None = None,
                  eos_id: int | None = None, quantize_kv: bool = False,
                  ring: bool = False):
    """``gen(params, prompt (B, Tp)[, key]) -> (B, n_new)`` int32 tokens
    over ``mesh`` (a :class:`ShardedTensor` laid out ``P(batch axes,
    None)``): every rank prefills its batch rows (K1 per rank per layer
    under flash) into its own cache, then ``n_new - 1`` decode steps run
    the per-rank forward (an int8 cache through K5 per rank per layer
    when routed). Greedy by default; ``temperature > 0`` samples
    (optionally top-k) with ``key``, each rank folding its rows'
    GLOBAL batch index (:func:`_batch_row0`), so the stream equals
    :func:`generate_dense`'s for the same key however the batch is
    split, and every tp member draws the same token from the identical
    post-psum logits. Rows that emit ``eos_id`` keep emitting it.

    The routing snapshot is taken now and resolved at each rank's local
    batch; with int8 routed and a cache past 2048 positions its length
    rounds up to a multiple of 2048 (the kernel's block picker accepts
    it; extra slots are masked). ``ring=True`` (see
    :func:`make_ring_generate`) decodes over the O(W) ring; ``max_len``
    is then ignored."""
    _check_decode_mesh(cfg, mesh)
    W = _check_ring_cfg(cfg) if ring else None
    bax = decode_batch_axes(cfg)
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")
    _check_sampling_params(temperature, top_k)
    use_kernel = _USE_DECODE_KERNEL  # make-time snapshot
    Hc = _cache_heads_global(cfg, mesh) // mesh.shape["tp"]

    def gen(params, prompt, key=None):
        _check_sampling(temperature, top_k, key)
        lparams = _rank_params(params, cfg, mesh)
        prompts, (Bg, Tp) = _rank_tokens(prompt, cfg, mesh, 1)
        B = prompts[0].shape[0]
        routed = (_kernel_possible(cfg, quantize_kv, use_kernel)
                  and _route_kernel(use_kernel, B))
        if ring:
            L = Tp  # transient positional prefill cache, gathered below
        else:
            L = max_len if max_len is not None else Tp + n_new
            if L < Tp + n_new:
                raise ValueError(
                    f"max_len {L} < prompt {Tp} + n_new {n_new}: decode "
                    "positions would not fit the cache")
            if quantize_kv and routed and L > 2048:
                L = -(-L // 2048) * 2048
        with torch.no_grad():
            lcaches = [[_zero_cache_layer(B, L, Hc, cfg.head_dim, cfg.dtype,
                                          quantize_kv, p.device)
                        for _ in range(cfg.n_layers)] for p in prompts]
            if ring and quantize_kv:
                logits, lcaches = _aligned_quantized_prefill_local(
                    lparams, prompts, lcaches, cfg, mesh,
                    decode_kernel=routed)
            else:
                logits, lcaches = _incremental_forward_local(
                    lparams, prompts, lcaches, 0, cfg, mesh, prefill=True)
            if ring:
                lcaches = [[_ring_from_cache(cl, Tp, W) for cl in c]
                           for c in lcaches]
            picks = [_picker(B, p.device, float(temperature), top_k, key,
                             _batch_row0(cfg, mesh, r, B))
                     for r, p in zip(mesh.local_ranks(), prompts)]
            toks = [pk(lg[:, -1], Tp - 1) for pk, lg in zip(picks, logits)]
            del logits

            def step(toks, pos):
                lg, _ = _incremental_forward_local(
                    lparams, [t[:, None] for t in toks], lcaches, pos, cfg,
                    mesh, prefill=False, ring=ring, decode_kernel=routed)
                return [x[:, 0] for x in lg]

            out = _decode_loop(step, toks, Tp, n_new, eos_id, picks)
        return from_local(mesh, P(bax, None), out, (Bg, n_new))

    return gen


def make_ring_generate(cfg: TransformerConfig, mesh: Mesh, n_new: int, *,
                       temperature: float = 0.0, top_k: int | None = None,
                       eos_id: int | None = None,
                       quantize_kv: bool = False):
    """Sharded sliding-window generation over the O(W) ring cache:
    ``gen(params, prompt (B, Tp)[, key]) -> (B, n_new)`` tokens, equal
    to :func:`generate_ring_dense`'s. :func:`make_generate` with the
    decode steps' cache replaced by the ring: prefill runs positionally
    into a Tp-long transient per rank (quantized, through the per-rank
    aligned prefill), each layer's last W positions gather into ring
    slots, and every step writes slot ``pos % W`` and reads W."""
    return make_generate(
        cfg, mesh, n_new, temperature=temperature, top_k=top_k,
        eos_id=eos_id, quantize_kv=quantize_kv, ring=True,
    )
