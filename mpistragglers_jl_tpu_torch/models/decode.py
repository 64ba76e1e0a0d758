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

import torch

from .._device import resolve_device
from ..parallel.ring_attention import (
    _band_mask,
    _group_pv,
    _group_scores,
    resolve_attention_impl,
)
from ..ops.sampling import sample_rows
from .moe import moe_ffn_dense
from .transformer import TransformerConfig, _ln, _mlp, _rope

__all__ = [
    "init_cache",
    "init_ring_cache",
    "ring_from_cache",
    "decode_step_dense",
    "decode_step_ring_dense",
    "generate_dense",
    "generate_ring_dense",
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


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, *,
               quantize_kv: bool = False, device=None) -> list[dict]:
    """Zeroed per-layer positional cache: {"k","v"} of
    ``(B, max_len, kv_heads, head_dim)``, int8 plus f32 ``(B, max_len,
    kv_heads)`` scales {"k_s","v_s"} when ``quantize_kv``. Every leaf
    is its own buffer (writes are in place)."""
    dev = resolve_device(device)
    return [
        _zero_cache_layer(batch, max_len, cfg.kv_heads, cfg.head_dim,
                          cfg.dtype, quantize_kv, dev)
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


def _incremental_layer(x, lp, cache_l, qpos, off: int, cfg, *,
                       chunk_attn, ring=False, decode_kernel=_UNSET):
    """One layer of the incremental forward: write the chunk's K/V at
    ``off`` (slot ``off % W`` in ring mode) in place, attend, MLP (or
    the experts). Returns (x, cache_l)."""
    h = _ln(x, lp["ln1_s"], lp["ln1_b"])
    q = torch.einsum("bld,dhk->blhk", h, lp["wq"])
    k = torch.einsum("bld,dhk->blhk", h, lp["wk"])
    v = torch.einsum("bld,dhk->blhk", h, lp["wv"])
    q, k = _rope(q, qpos), _rope(k, qpos)
    if ring:
        off = off % cache_l["k"].shape[1]
    cache_l = _cache_write(cache_l, k, v, off)
    scale = cfg.head_dim ** -0.5
    if chunk_attn is not None:
        # prefill at offset 0: attention on the exact chunk K/V; only
        # the cache quantizes
        o = chunk_attn(q, k, v)
    elif ring:
        o = _ring_cached_attention(q, cache_l, qpos[0], scale,
                                   use_kernel=decode_kernel)
    else:
        o = _cached_attention(q, cache_l, qpos, scale, cfg.attn_window,
                              use_kernel=decode_kernel)
    x = x + torch.einsum("blhk,hkd->bld", o, lp["wo"])
    h2 = _ln(x, lp["ln2_s"], lp["ln2_b"])
    if cfg.n_experts:
        return x + moe_ffn_dense(h2, lp, cfg.capacity_factor)[0], cache_l
    return x + _mlp(h2, lp) + lp["b2"], cache_l


def _incremental_forward(params, tokens, cache, offset: int, cfg, *,
                         prefill, ring=False, decode_kernel=_UNSET):
    """Chunk forward at global ``offset`` (a Python int); returns
    (logits (B, T, V), cache). ``prefill=True`` means offset 0 and
    chunk attention through the configured per-device kernel;
    otherwise attention reads the cache (the O(W) ring when
    ``ring=True``, decode only)."""
    T = tokens.shape[1]
    if ring and (T != 1 or prefill):
        raise ValueError(
            "ring cache reads are decode-only (T == 1): prefill runs "
            "positionally, then ring_from_cache gathers the window"
        )
    qpos = offset + torch.arange(T, device=tokens.device)
    chunk_attn = None
    if prefill:
        impl = resolve_attention_impl(cfg.attn_impl)

        def chunk_attn(q, k, v):
            return impl(q, k, v, causal=True, window=cfg.attn_window)

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


def init_ring_cache(cfg: TransformerConfig, batch: int, *,
                    quantize_kv: bool = False, device=None) -> list[dict]:
    """Zeroed per-layer ring cache: (B, attn_window, kv_heads, Dh)."""
    W = _check_ring_cfg(cfg)
    return init_cache(cfg, batch, W, quantize_kv=quantize_kv,
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


def _picker(B: int, dev, temperature: float, top_k, key):
    """The generators' choice ``pick(logits, pos)`` at a host position:
    greedy, or batch row b sampled with ``fold_in(fold_in(key, pos),
    b)``, the reference's fold (``row0 = 0`` on one device)."""
    if temperature == 0.0:
        return lambda lg, pos: _pick_token(lg)
    keys = torch.as_tensor(key).to(dev, torch.int64)
    if tuple(keys.shape) != (2,):
        raise ValueError(f"key must be one key of shape (2,), got "
                         f"{tuple(keys.shape)}")
    keys = keys.expand(B, 2).contiguous()
    rows = torch.arange(B, dtype=torch.int32, device=dev)

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


def _decode_loop(params, tok, c, Tp: int, n_new: int, cfg, *, ring,
                 use_kernel, eos_id, pick):
    """The decode loop shared by both generators: ``tok`` (B,) is the
    prefill's pick, then ``n_new - 1`` decode forwards, each token
    chosen by ``pick(logits, pos)`` at the position it was fed at (the
    last token emitted is never fed back). Returns (B, n_new) int32
    tokens."""
    done = torch.zeros_like(tok, dtype=torch.bool)
    toks = []
    for pos in range(Tp, Tp + n_new - 1):
        lg, c = _incremental_forward(
            params, tok[:, None], c, pos, cfg, prefill=False, ring=ring,
            decode_kernel=use_kernel,
        )
        nxt, done = _eos_clamp(pick(lg[:, 0], pos), tok, done, eos_id)
        toks.append(tok)
        tok = nxt
    toks.append(tok)
    return torch.stack(toks, dim=1)


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
        return _decode_loop(params, tok, c, Tp, n_new, cfg, ring=False,
                            use_kernel=use_kernel, eos_id=eos_id,
                            pick=pick)


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
        return _decode_loop(params, pick(logits[:, -1], Tp - 1), c, Tp,
                            n_new, cfg, ring=True, use_kernel=use_kernel,
                            eos_id=eos_id, pick=pick)
