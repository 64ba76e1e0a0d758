"""Continuous batching: the multi-request serving scheduler over the
slot-ring cache or the paged cache.

Counterpart of ``mpistragglers_jl_tpu/models/serving.py``. The
scheduler owns ``S`` slots. Each slot decodes at its own global
position: RoPE, cache writes and the ``kpos >= 0`` ring mask are per
row, so a reused slot's stale rows self-mask until overwritten.

* **Slot ring** (default): per layer one batched O(W) ring cache
  ``(S, W, kv_heads, head_dim)`` (int8 plus f32 scales with
  ``quantize_kv``) holds every slot.
* **Paged** (``page_tokens=P``): per layer one pool of ``cache_pages``
  pages of P ring slots, ``(cache_pages * P, kv_heads, head_dim)``,
  shared by all slots through a host-owned ``(S, W / P)`` page table
  (:class:`~.paging.PagePool`: refcounts, a prefix table, copy-on-write
  reservations). Admission hashes the prompt's page-aligned prefix and
  shares resident pages, skipping their prefill; a pre-tick pass copies
  any shared page a slot is about to write, so the device tick only
  writes pages its row owns. With an int8 cache the tick's attention
  reads pages in place through the CUDA paged kernel; otherwise each
  layer's ring views are gathered once per tick, the slot-ring tick
  runs on them, and they are scattered back.

Each ``step()`` tick advances every admitting request by one C-token
prefill chunk (into a transient positional cache, attending the
already-quantized cache), installs finished admissions into their
slot, runs ``n_inner`` decode steps for all slots, and fetches the
``(S, n_inner)`` token block to the host ONCE. Rows that emit
``eos_id`` keep emitting it; the host strips the tail and retires the
request. Greedy streams equal ``generate_ring_dense`` token for token;
with ``temperature > 0`` every slot samples with its request's key
(``utils/prng.py``, bit-equal to ``jax.random``) as row 0 of its own
stream, so a sampled stream equals ``generate_ring_dense(..., key=)``
and the JAX package's scheduler with the same key.

Multi-tenant QoS is opt-in, as in the reference: ``qos=`` (a
:class:`~..qos.TenantRegistry`) replaces FIFO admission with
weighted deficit-round-robin over per-tenant queues (``submit`` then
needs a registered ``tenant=``) and, paged, holds each tenant to its
page quota: a retiring request's sole-held registered prefix pages go
COLD (kept resident for future sharers, attributed to the tenant) and
are reclaimed oldest-first under pool or quota pressure, never from
under a live holder.

Page-state migration and the fleet prefix cache, as in the reference:
``export_page_state`` gathers a decoding slot's ring view out of the
pool (fresh tensors: the gather indexes, so it copies) and frees the
slot; ``adopt_page_state`` re-plans the pages in another scheduler's
pool, shares its resident prefix pages, writes only the pages the
request does not share, in place, and re-registers the prefix chain
(``models/disagg.py`` moves the image between them). ``cache=`` (a
:class:`~..cache.FleetPrefixCache`) extends the admission share walk
to pages spilled to host DRAM or resident on a peer scheduler: a
fetched page is a fresh page filled in place with the page's bytes,
and a fetch that comes back empty falls back to prefill.

Observability is opt-in, as in the reference: ``registry=``,
``spans=``, ``flight=``, ``exporter=`` and ``trace=`` (``obs/``
copies) record the reference's series, spans and request events; a
dark scheduler does no work beyond ``is None`` checks.

Cache writes are IN PLACE (``index_put_`` for the per-row writes, slice
and page-block assignment for prefill chunks, installs and page
copies): the device arenas are allocated once and never copied per
tick.

Faults of the reference not copied (``ROADMAP.md`` Queue 3): it
allocates the transient prefill arena at ``max_prompt`` while padding
the prompt to whole chunks, so a last chunk that overruns the arena
has its write start clamped and the prompt's K/V land in the wrong
rows; on the paged path a sharing admission starts at ``base > 0``, the
clamp lands on the seeded prefix rows, and the install then scatters
those rows over the shared pages another request reads. Here the arena
holds ``max_prompt + prompt_chunk - 1`` positions, so no chunk overruns
it from any ``base``, and the paged install writes only the pages the
request does not share.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from .._device import resolve_device
from ..obs.timeline import annotate as _annotate
from ..utils import prng
from ..ops.decode_attention import paged_ring_view, quantized_decode_attention
from ..qos import DeficitScheduler, TenantRegistry
from .decode import (
    _NEG,
    _UNSET,
    _cache_pv,
    _cache_scores,
    _check_ring_cfg,
    _check_sampling_params,
    _eos_clamp,
    _incremental_forward,
    _is_quantized,
    _kernel_possible,
    _kernel_viable,
    _kv_quantize,
    _layers_local,
    _paged_kernel_possible,
    _pick_token,
    _ring_from_cache,
    _rank_blocks,
    _rank_caches,
    _rank_params,
    _route_kernel,
    init_cache,
)
from . import decode as _decode
from ..parallel.mesh import PartitionSpec as P, from_local
from .paging import NULL_PAGE, PagePool, PagePoolExhausted, prefix_page_digests
from .transformer import (
    TransformerConfig,
    _check_layout,
    _ln,
    _mlp,
    _qkv,
    _rope_freqs,
)

__all__ = ["Request", "ServingScheduler", "make_serving_scan",
           "serving_decode_step_dense"]


# --------------------------------------------------------------------------
# per-row primitives (each slot at its own global position)
# --------------------------------------------------------------------------


def _rope_rows(x, pos):
    """Rotary embedding for single-token rows: x (S, 1, H, D), pos (S,)
    global positions."""
    half = x.shape[-1] // 2
    ang = pos.float()[:, None] * _rope_freqs(half, x.device)[None, :]
    cos = torch.cos(ang)[:, None, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, None, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _write_index(pos, W: int, paged):
    """Where each row's new K/V go: ``(row, ring slot)`` in the batched
    ring, or ``(pool row,)`` through the page table ``paged = (pt, P)``:
    ring slot ``s`` of row i lives at pool row
    ``pt[i, s // P] * P + s % P``."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    slot = torch.remainder(pos, W).long()
    if paged is None:
        return rows, slot
    pt, P = paged
    return (pt[rows, slot // P].long() * P + slot % P,)


def _write_rows(cache_l: dict, k, v, index):
    """Write each row's single-token K/V, in place, at ``index`` (from
    :func:`_write_index`): k, v (S, 1, Hkv, D). On the paged path the
    pre-tick copy-on-write pass has made every page written here the
    row's own (or the null page, for idle rows)."""

    def put(c, u):
        c.index_put_(index, u.to(c.dtype))

    if not _is_quantized(cache_l):
        put(cache_l["k"], k[:, 0])
        put(cache_l["v"], v[:, 0])
        return cache_l
    kq, ks = _kv_quantize(k[:, 0])
    vq, vs = _kv_quantize(v[:, 0])
    put(cache_l["k"], kq)
    put(cache_l["v"], vq)
    put(cache_l["k_s"], ks)
    put(cache_l["v_s"], vs)
    return cache_l


def _ring_attention_rows(q, cache_l, pos, scale, use_kernel=False):
    """Single-query ring attention with a per-row position: slot ``s``
    holds ``kpos(s) = pos - ((pos - s) mod W)``, valid iff >= 0 (the
    causal bound, window bound, warm-up AND slot-reuse guard).
    ``use_kernel=True`` routes int8 caches through the decode kernel's
    ring mode, one launch for all S slots; default False keeps this the
    einsum oracle step."""
    W = cache_l["k"].shape[1]
    if use_kernel and _kernel_viable(q, cache_l):
        return quantized_decode_attention(q, cache_l, pos, scale,
                                          ring=True)
    s = _cache_scores(q, cache_l, scale)  # (S, H, 1, W) f32
    slots = torch.arange(W, device=q.device)
    kpos = pos[:, None] - torch.remainder(pos[:, None] - slots[None, :], W)
    s = torch.where((kpos >= 0)[:, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    return _cache_pv(p, cache_l).to(q.dtype)


def _paged_attention_rows(q, cache_l, paged, pos, scale):
    """Single-query ring attention through the page table, the paged
    kernel route only: one launch reads every slot's pages in place.
    The einsum paged tick never comes here (it runs the slot-ring
    attention on gathered views, :func:`_serving_scan_paged`)."""
    pt, P = paged
    return quantized_decode_attention(q, cache_l, pos, scale, ring=True,
                                      page_table=pt, page_tokens=P)


def _serving_attend(q, k, v, cache_l, pos, cfg, index, *, use_kernel=False,
                    paged=None):
    """The serving step's write-and-attend, one rank's: the rows' K/V
    (per-row RoPE applied) written in place at ``index``, then
    single-query attention over the slot ring (``use_kernel`` its
    routing) or, with ``paged = (pt, P)``, the page pool through the
    kernel. Returns (o, cache_l)."""
    scale = cfg.head_dim ** -0.5
    cache_l = _write_rows(cache_l, k, v, index)
    if paged is None:
        o = _ring_attention_rows(q, cache_l, pos, scale,
                                 use_kernel=use_kernel)
    else:
        o = _paged_attention_rows(q, cache_l, paged, pos, scale)
    return o, cache_l


def _serving_layer(x, lp, cache_l, pos, cfg, index, *, use_kernel=False,
                   paged=None):
    """One layer of the per-row serving step (decode.py's
    ``_incremental_layer`` with per-row positions). ``paged = (pt, P)``
    reads the page pool through the kernel; None is the slot ring."""
    o, cache_l = _serving_attend(*_qkv(x, lp, pos, rope=_rope_rows),
                                 cache_l, pos, cfg, index,
                                 use_kernel=use_kernel, paged=paged)
    x = x + torch.einsum("blhk,hkd->bld", o, lp["wo"])
    h2 = _ln(x, lp["ln2_s"], lp["ln2_b"])
    return x + _mlp(h2, lp) + lp["b2"], cache_l


def _serving_forward(params, tok, pos, caches, cfg, *, use_kernel=False,
                     paged=None):
    """(tok (S,), pos (S,), caches) -> (logits (S, V), caches)."""
    W = (paged[0].shape[1] * paged[1] if paged is not None
         else caches[0]["k"].shape[1])
    index = _write_index(pos, W, paged)  # shared by every layer
    x = params["emb"][tok[:, None]]  # (S, 1, d)
    new = []
    for lp, cl in zip(params["layers"], caches):
        x, cl = _serving_layer(x, lp, cl, pos, cfg, index,
                               use_kernel=use_kernel, paged=paged)
        new.append(cl)
    x = _ln(x, params["lnf_s"], params["lnf_b"])
    logits = torch.einsum("bld,vd->blv", x, params["emb"])
    return logits[:, 0], new


def serving_decode_step_dense(params, tok, pos, caches,
                              cfg: TransformerConfig):
    """One batched serving decode step, every slot at its own position;
    always the einsum path. Returns (logits (S, V), caches); the
    caches update in place."""
    _check_ring_cfg(cfg)
    with torch.no_grad():
        return _serving_forward(params, tok, pos, caches, cfg)


def _scan_ranks(forward, tok, pos, done, eos_id, n_inner, picks):
    """``n_inner`` decode steps for every rank's slots, on the device,
    with no host sync: ``forward(tok, pos) -> logits (S', V)`` per rank
    (one rank on one device; every rank of a mesh, whose forward sums
    over tp), ``picks[r](logits, pos)`` choosing rank r's tokens. Lists
    hold one tensor per rank. Returns (tok, pos, done, toks (S',
    n_inner)), a list each."""
    tok, pos, done = list(tok), list(pos), list(done)
    toks = [torch.empty((t.shape[0], n_inner), dtype=torch.int32,
                        device=t.device) for t in tok]
    for t in range(n_inner):
        for r, lg in enumerate(forward(tok, pos)):
            nxt, done[r] = _eos_clamp(picks[r](lg, pos[r]), tok[r], done[r],
                                      eos_id)
            toks[r][:, t] = nxt
            tok[r], pos[r] = nxt, pos[r] + 1
    return tok, pos, done, toks


def _scan_body(params, tok, pos, done, caches, cfg, eos_id, n_inner,
               pick, *, use_kernel=False, paged=None):
    """``n_inner`` decode steps for all S slots of one device (the
    caches written in place); ``pick(logits, pos)`` chooses each step's
    tokens. Returns (tok, pos, done, caches, toks (S, n_inner))."""

    def forward(tok, pos):
        lg, _ = _serving_forward(params, tok[0], pos[0], caches, cfg,
                                 use_kernel=use_kernel, paged=paged)
        return [lg]

    (tok,), (pos,), (done,), (toks,) = _scan_ranks(
        forward, [tok], [pos], [done], eos_id, n_inner, [pick])
    return tok, pos, done, caches, toks


def _serving_forward_local(lparams, tok, pos, lcaches, cfg, mesh, *,
                           use_kernel):
    """The per-row serving step per rank over a mesh: ``lparams[r]``,
    ``tok[r]``, ``pos[r]`` (S',) and ``lcaches[r]`` are flat position
    r's. decode.py's per-rank layer stack with :func:`_serving_attend`
    (``use_kernel[r]`` its routing) as each rank's attention half.
    Returns each rank's logits (S', V)."""
    W = lcaches[0][0]["k"].shape[1]
    index = [_write_index(p, W, None) for p in pos]

    def attend(r, i, x, lp, kv_slice):
        o, lcaches[r][i] = _serving_attend(
            *_qkv(x, lp, pos[r], kv_slice, rope=_rope_rows), lcaches[r][i],
            pos[r], cfg, index[r], use_kernel=use_kernel[r])
        return o

    xs = [lp["emb"][t[:, None]] for lp, t in zip(lparams, tok)]
    return [lg[:, 0] for lg in _layers_local(lparams, xs, cfg, mesh, attend)]


def make_serving_scan(cfg: TransformerConfig, mesh, n_inner: int, *,
                      eos_id: int | None = None, quantize_kv: bool = False,
                      temperature: float = 0.0, top_k: int | None = None):
    """The serving tick over a mesh: slots over ``dp``, heads over
    ``tp`` (the training path's psum placement; the mesh counterpart of
    ``make_decode_step`` with per-row positions). Returns ``f(params,
    tok, pos, done, caches, keys=None) -> (tok, pos, done, caches, toks
    (S, n_inner))``: ``params`` is ``shard_params``' tree; ``tok``,
    ``pos``, ``done`` (S,) and ``keys`` (S, 2) (the slots' request keys,
    read only at ``temperature > 0``) global or laid out ``P("dp")``;
    ``caches`` the (S, W, cache_heads, head_dim) ring (int8 plus scales
    with ``quantize_kv``) global or laid out by ``decode.cache_specs``,
    written in place per rank. Each rank runs ``n_inner`` decode steps
    for its slots, each picking its tokens (greedy, or every slot as
    row 0 of its own stream with its own key), the int8 kernel's routing
    snapshotted now and resolved at the rank's local slot count: a
    routed int8 ring launches K5's ring mode once per rank per layer
    per inner step. With ``kv_heads < tp`` the cache's head axis has
    ``tp`` slots (``decode.init_cache(..., mesh)``'s replicated groups).
    A mesh axis the specs do not name (``sp``) replicates: its ranks
    compute the same rows. Outputs are ShardedTensors. Over a mesh that
    spans processes each process runs its own positions' slots and the
    tp psums cross processes where tp does; the tick is a fixed
    ``n_inner`` steps with no vote, and its guards read only arguments
    and global shapes, so every process raises together."""
    _check_ring_cfg(cfg)
    _check_sampling_params(temperature, top_k)
    if cfg.n_experts:
        raise ValueError(
            "serving scheduler covers dense-FFN configs; MoE decode "
            "routes per chunk (models/decode.py prefill caveat) and is "
            "served via make_generate"
        )
    missing = sorted({"dp", "tp"} - set(mesh.axis_names))
    if missing:
        raise ValueError(f"the serving tick shards over (dp, tp); mesh "
                         f"{dict(mesh.shape)} lacks {missing}")
    tp = int(mesh.shape["tp"])
    if cfg.kv_heads % tp != 0 and tp % cfg.kv_heads != 0:
        raise ValueError(
            f"kv_heads {cfg.kv_heads} and tp {tp} must nest (one "
            "divide the other) for the sharded serving tick's cache "
            "layout"
        )
    _check_layout(cfg, mesh)
    use_kernel = _decode._USE_DECODE_KERNEL  # make-time snapshot
    slots = P("dp")

    def pick_for(keys):
        if temperature == 0.0:
            return lambda lg, pos: _pick_token(lg)
        rows = torch.zeros(keys.shape[0], dtype=torch.int32,
                           device=keys.device)
        return lambda lg, pos: _pick_token(lg, pos, keys, rows, temperature,
                                           top_k)

    def f(params, tok, pos, done, caches, keys=None):
        if temperature > 0.0 and keys is None:
            raise ValueError("temperature > 0 needs the slots' keys")
        lparams = _rank_params(params, cfg, mesh)
        ltok, (S,) = _rank_blocks(tok, mesh, slots)
        lpos, _ = _rank_blocks(pos, mesh, slots)
        ldone, _ = _rank_blocks(done, mesh, slots)
        lkeys = ([None] * len(ltok) if keys is None else
                 [k.to(torch.int64) for k in _rank_blocks(keys, mesh,
                                                          slots)[0]])
        caches, lcaches = _rank_caches(caches, cfg, mesh, quantize_kv)
        routed = [_kernel_possible(cfg, quantize_kv, use_kernel)
                  and _route_kernel(use_kernel, t.shape[0]) for t in ltok]
        with torch.no_grad():
            ltok, lpos, ldone, ltoks = _scan_ranks(
                lambda t, p: _serving_forward_local(
                    lparams, t, p, lcaches, cfg, mesh, use_kernel=routed),
                ltok, lpos, [d.bool() for d in ldone], eos_id, n_inner,
                [pick_for(k) for k in lkeys])
        return (from_local(mesh, slots, ltok, (S,)),
                from_local(mesh, slots, lpos, (S,)),
                from_local(mesh, slots, ldone, (S,)), caches,
                from_local(mesh, P("dp", None), ltoks, (S, n_inner)))

    return f


# --------------------------------------------------------------------------
# the paged pool (device side; the host side is paging.PagePool)
# --------------------------------------------------------------------------


def _fresh_pages(cfg: TransformerConfig, n_pages: int, P: int,
                 quantize_kv: bool, device) -> list[dict]:
    """Zeroed per-layer page pool: {"k","v"} ``(n_pages * P, kv_heads,
    head_dim)``, scales ``(n_pages * P, kv_heads)`` when int8. Page
    ``p`` owns rows ``[p*P, (p+1)*P)``; page 0 is the null page."""
    return [{kk: a[0] for kk, a in layer.items()}
            for layer in init_cache(cfg, 1, n_pages * P,
                                    quantize_kv=quantize_kv, device=device)]


def _write_pages(leaf, pids, blocks, P: int) -> None:
    """Write whole pages in place: ``blocks`` (n * P, ...) into pool
    pages ``pids`` (n,) of ``leaf`` (n_pages * P, ...)."""
    tail = leaf.shape[1:]
    pages = leaf.view((leaf.shape[0] // P, P) + tail)
    pages[pids.long()] = blocks.reshape((-1, P) + tail).to(leaf.dtype)


def _paged_gather(cache_l: dict, pt, P: int) -> dict:
    """Every slot's W-row ring view out of the pool, one page-block
    gather per leaf: the slot-ring layout ``(S, W, ...)``, so the
    einsum tick runs the unchanged slot-ring math on it."""
    return {kk: paged_ring_view(a, pt, P) for kk, a in cache_l.items()}


def _paged_scatter(cache_l: dict, view_l: dict, pt, P: int) -> None:
    """Write a tick's ring views back through the page table, in place.
    A page several slots share comes back with the bytes it went out
    with (the tick wrote only pages their row owns); the null page
    takes the writes of idle rows, which nothing reads unmasked."""
    flat = pt.reshape(-1)
    for kk, a in cache_l.items():
        _write_pages(a, flat, view_l[kk], P)


def _serving_scan_paged(params, tok, pos, done, caches, pt, cfg, eos_id,
                        n_inner, pick, P: int, use_kernel: bool):
    """The paged tick: ``n_inner`` decode steps for all slots through
    the ``(S, max_pages)`` int32 page table (tick-invariant: copy-on-
    write retargets it on the host between ticks). The kernel route
    reads pages in place at every step. The einsum route gathers each
    layer's ring views once, runs the slot-ring tick on them, and
    scatters them back."""
    if use_kernel:
        return _scan_body(params, tok, pos, done, caches, cfg, eos_id,
                          n_inner, pick, paged=(pt, P))
    views = [_paged_gather(cl, pt, P) for cl in caches]
    tok, pos, done, views, toks = _scan_body(
        params, tok, pos, done, views, cfg, eos_id, n_inner, pick)
    for cl, vw in zip(caches, views):
        _paged_scatter(cl, vw, pt, P)
    return tok, pos, done, caches, toks


def _seed_admit_paged(cache, pages, pids, base: int, P: int) -> None:
    """Seed rows ``[0, base)`` of a transient positional prefill cache
    from shared prefix pages, in place: ring slot s of a within-window
    prefix holds position s, so the page rows ARE the positional rows
    and admission skips their prefill. ``pids`` (base // P,) device."""
    for cl, pl in zip(cache, pages):
        for kk in cl:
            cl[kk][:, :base] = paged_ring_view(pl[kk], pids[None], P)


def _place_paged(caches, ring, pids, m: int, n: int, P: int) -> None:
    """Paged install: write the admitted request's ring rows of pages
    ``[m, n)`` (its own pages; ``m`` shared, ``n`` budgeted) through
    ``pids`` (device, ``max_pages``). The shared pages are never
    written: another slot reads them."""
    if n <= m:
        return
    own = pids[m:n]
    for c, r in zip(caches, ring):
        for kk in c:
            _write_pages(c[kk], own, r[kk][0, m * P:n * P], P)


def _copy_pages_paged(caches, src, dst, P: int) -> None:
    """Copy-on-write page copies across every layer and leaf, in place:
    each leaf gathers every ``src`` page before any ``dst`` write, so a
    page that is the source of two copies reads its old bytes both
    times (``dst`` pages are freshly allocated, never a source)."""
    for cl in caches:
        for a in cl.values():
            pages = a.view((a.shape[0] // P, P) + a.shape[1:])
            pages[dst] = pages[src]


# --------------------------------------------------------------------------
# admission (chunked prefill -> ring window -> slot)
# --------------------------------------------------------------------------


def _extend_chunk_dense(params, chunk, cache, offset: int, cfg):
    """One C-token prefill chunk into a (1, L) transient positional
    cache at ``offset``, attending the cache (written in place)."""
    return _incremental_forward(params, chunk, cache, offset, cfg,
                                prefill=False)


def _finish_admit_dense(cache, last_logits, true_len: int, last_off: int,
                        W: int, pick):
    """Gather the last-W window of a filled positional cache into ring
    rows and pick the first token from the last chunk's logits at the
    prompt's last position (``pick(logits (1, V), pos (1,))``).
    Returns (tok0 (1,) int32 tensor, ring leaves (1, W, ...))."""
    ring = [_ring_from_cache(cl, true_len, W) for cl in cache]
    lg = last_logits[0, true_len - 1 - last_off][None]
    tok0 = pick(lg, torch.full((1,), true_len - 1, dtype=torch.int32,
                               device=lg.device))
    return tok0, ring


def _start_row(tok, pos, done, keys, s: int, tok0, pos0: int,
               key) -> None:
    """Set slot ``s``'s row state: first token, start position, live,
    and its request's key on a sampling scheduler (``keys`` None when
    greedy)."""
    tok[s] = tok0[0]
    pos[s] = pos0
    done[s] = False
    if keys is not None:
        keys[s] = key


def _place_dense(caches, ring, s: int) -> None:
    """Install an admitted request's ring rows into slot ``s`` of the
    batched cache, in place."""
    for c, r in zip(caches, ring):
        for kk in c:
            c[kk][s] = r[kk][0].to(c[kk].dtype)


# --------------------------------------------------------------------------
# observability (obs/ registry + timeline, strictly opt-in)
# --------------------------------------------------------------------------


class _ServingObs:
    """Instrument bundle for one scheduler, resolved once at
    construction so the tick only increments and observes: the
    reference's ``_ServingObs`` (its series names, labels and buckets,
    the QoS series of ``qos=`` and the fleet tiers of ``cache=``
    included). Built only when a registry or a span recorder is
    attached."""

    def __init__(self, sched: "ServingScheduler", registry, spans):
        self.registry = registry
        self.spans = spans
        self.annotate = _annotate
        # tokens delivered in the current tick (admission first tokens
        # plus the trimmed decode harvest: serving_tokens_total's
        # population, so the per-tick rate and the counter cross-check)
        self._tick_toks = 0
        # last published page-pool tallies (delta counters)
        self._last_share = 0
        self._last_cow = 0
        self._r = registry is not None
        if not self._r:
            return
        registry.gauge(
            "serving_slots", help="configured serving slots"
        ).set(sched.S)
        self.m_queue = registry.gauge(
            "serving_queue_depth",
            help="requests queued, not yet admitted",
        )
        self.m_active = registry.gauge(
            "serving_active_slots", help="slots decoding or admitting"
        )
        self.m_ticks = registry.counter("serving_ticks_total")
        self.m_tick_s = registry.histogram(
            "serving_tick_seconds", help="scheduler tick wall clock"
        )
        self.m_tokens = registry.counter(
            "serving_tokens_total",
            help="tokens delivered into request streams (first tokens "
            "+ decode harvest, post-retirement trim)",
        )
        self.m_tok_rate = registry.gauge(
            "serving_tokens_per_s",
            help="tokens delivered / tick wall, last tick",
        )
        self.m_ttft = registry.histogram(
            "serving_ttft_seconds", help="submit -> first token"
        )
        self.m_intertoken = registry.histogram(
            "serving_intertoken_seconds",
            help="mean per-token gap, one sample per (slot, tick)",
        )
        self.m_admitted = registry.counter("serving_admitted_total")
        self.m_retired = {
            "eos": registry.counter(
                "serving_retired_total", reason="eos"
            ),
            "length": registry.counter(
                "serving_retired_total", reason="length"
            ),
        }
        self.m_prefill = registry.counter(
            "serving_prefill_chunks_total",
            help="admission prefill chunks advanced",
        )
        # the scheduler's resolved int8-kernel route, counted once per
        # decode tick (when the route fired, not only that it could)
        self.m_route = registry.counter(
            "serving_kernel_route_total",
            help="decode ticks by resolved int8-kernel route",
            route="kernel" if sched.use_kernel else "einsum",
        )
        if sched.paged:
            self.m_pages_free = registry.gauge(
                "serving_cache_pages_free",
                help="KV cache pages on the free list",
            )
            self.m_pages_used = registry.gauge(
                "serving_cache_pages_used",
                help="KV cache pages allocated to slots",
            )
            self.m_share = registry.counter(
                "serving_prefix_share_hits_total",
                help="prompt prefix pages whose prefill was skipped "
                "at admission, by serving tier (hbm = local share, "
                "dram = host page store, peer = replica fetch)",
                tier="hbm",
            )
            # dram/peer series appear lazily, at the first fleet hit
            self._share_tier = {"hbm": self.m_share}
            self.m_cow = registry.counter(
                "serving_cow_copies_total",
                help="copy-on-write page copies (a slot wrote a page "
                "another slot still reads)",
            )
        # QoS series (qos= schedulers only): per-tenant admission
        # counters plus deficit / page-quota-usage gauges, created
        # lazily per tenant and cached
        self._qos = sched._qos
        if self._qos is not None:
            self._q_admit: dict[str, object] = {}
            self._q_deficit: dict[str, object] = {}
            self._q_quota: dict[str, object] = {}

    def qos_admitted(self, sched: "ServingScheduler",
                     tenant: str) -> None:
        if not self._r or self._qos is None:
            return
        c = self._q_admit.get(tenant)
        if c is None:
            cls = (self._qos.get(tenant).cls
                   if tenant in self._qos else "unknown")
            c = self._q_admit[tenant] = self.registry.counter(
                "qos_admitted_total",
                help="requests admitted into slots, by tenant and "
                "SLO class (DRR order)",
                tenant=tenant, cls=cls,
            )
        c.inc()

    def qos_gauges(self, sched: "ServingScheduler") -> None:
        """Per-tenant deficit + quota-usage gauges, refreshed once per
        tick (tick_done)."""
        drr = sched._drr
        for contract in self._qos:
            t = contract.name
            g = self._q_deficit.get(t)
            if g is None:
                g = self._q_deficit[t] = self.registry.gauge(
                    "qos_deficit",
                    help="carried DRR credit (tokens) per tenant",
                    tenant=t,
                )
            g.set(drr.deficit(t))
            if sched.paged:
                q = self._q_quota.get(t)
                if q is None:
                    q = self._q_quota[t] = self.registry.gauge(
                        "qos_pages_quota_used",
                        help="KV pages attributed to the tenant "
                        "(hot refs + cold cache) against its quota",
                        tenant=t,
                    )
                q.set(sched._tenant_usage(t))

    def first_token(self, req: "Request", t: float) -> None:
        self._tick_toks += 1
        if self._r:
            self.m_admitted.inc()
            self.m_tokens.inc()
            if req._t_submit is not None:
                self.m_ttft.observe(t - req._t_submit)
        req._t_last_tok = t

    def tokens_emitted(self, req: "Request", n: int, t: float) -> None:
        self._tick_toks += n
        if self._r:
            self.m_tokens.inc(n)
            last = req._t_last_tok
            if last is not None and n:
                self.m_intertoken.observe((t - last) / n)
        req._t_last_tok = t

    def prefill_chunk(self) -> None:
        if self._r:
            self.m_prefill.inc()

    def fleet_hit(self, tier: str) -> None:
        """One prefix page served by the fleet cache (``dram`` or
        ``peer``) instead of prefilled: the share counter's family, one
        series per tier."""
        if not self._r:
            return
        c = self._share_tier.get(tier)
        if c is None:
            c = self._share_tier[tier] = self.registry.counter(
                "serving_prefix_share_hits_total", tier=tier,
            )
        c.inc()

    def tick_done(self, sched: "ServingScheduler", retired, t0: float,
                  t1: float, t2: float | None) -> None:
        """t0 tick begin, t1 admissions done, t2 decode fetched (None
        when no slot decoded this tick)."""
        t3 = time.perf_counter()
        wall = t3 - t0
        n_toks, self._tick_toks = self._tick_toks, 0
        if self._r:
            self.m_ticks.inc()
            self.m_tick_s.observe(wall)
            self.m_queue.set(sched.pending)
            self.m_active.set(sched.active)
            self.m_tok_rate.set(n_toks / wall if wall > 0 else 0.0)
            if t2 is not None:
                self.m_route.inc()
            for req in retired:
                self.m_retired[req.reason].inc()
            if sched.paged:
                pool = sched.pool
                self.m_pages_free.set(pool.free)
                self.m_pages_used.set(pool.used)
                self.m_share.inc(pool.share_hits - self._last_share)
                self._last_share = pool.share_hits
                self.m_cow.inc(pool.cow_copies - self._last_cow)
                self._last_cow = pool.cow_copies
            if self._qos is not None:
                self.qos_gauges(sched)
        sp = self.spans
        if sp is not None:
            tick = sched.tick_count
            sp.add(
                f"tick {tick}", t0, wall, track="scheduler",
                queue=sched.pending, active=sched.active,
                tokens=n_toks, retired=len(retired),
            )
            sp.add("admit", t0, t1 - t0, track="scheduler")
            if t2 is not None:
                sp.add("decode", t1, t2 - t1, track="scheduler")
                sp.add("retire", t2, t3 - t2, track="scheduler")
            sp.count("queue_depth", sched.pending, t=t3)
            sp.count("active_slots", sched.active, t=t3)
            if sched.paged:
                sp.count("pages_used", sched.pool.used, t=t3)


# --------------------------------------------------------------------------
# the scheduler
# --------------------------------------------------------------------------


class Request:
    """One generation request: ``prompt`` (1D int tokens) in,
    ``tokens`` (the generated ids, EOS kept if emitted) out.
    ``finished`` flips at retirement; ``reason`` is ``"eos"``,
    ``"length"`` or ``"cancelled"``. ``key`` is the request's PRNG key
    on a sampling scheduler (None: derived from the id at admission);
    ``tenant`` is the contract it is billed to on a ``qos=`` scheduler;
    ``trace`` is its ``TraceBook`` id (None: dark)."""

    _next_id = 0

    def __init__(self, prompt, max_new: int, key=None,
                 tenant: str | None = None):
        self.id = Request._next_id
        Request._next_id += 1
        self.key = key
        self.tenant = tenant
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        self.max_new = int(max_new)
        self.tokens: list[int] = []
        self.finished = False
        self.reason: str | None = None
        self.admitted_tick: int | None = None
        self.retired_tick: int | None = None
        # latency stamps (perf_counter), set only by an instrumented
        # scheduler: submit time and last-token time
        self._t_submit: float | None = None
        self._t_last_tok: float | None = None
        # incremental EOS scan: index of the first EOS if found, and
        # how many tokens were already scanned
        self._eos_at: int | None = None
        self._scanned = 0
        # _trace_owned: the trace was minted at this scheduler's door,
        # so this scheduler stamps its terminal events
        self.trace: int | None = None
        self._trace_owned = False


class _Admitting:
    """Per-slot chunked-prefill state: the transient positional cache
    plus the chunk cursor. Paged admissions also carry their page plan:
    ``base`` (tokens of shared prefix whose prefill is skipped; chunk i
    runs at ``base + i*C``), ``pids`` (the slot's page-table row,
    installed only at finish), ``n_pages`` (pages budgeted),
    ``digests``/``n_cover`` (prefix digests to register at finish) and
    ``wraps`` (the request can wrap its ring)."""

    def __init__(self, req: Request, cache, padded, n_chunks: int, *,
                 base: int = 0, pids=None, n_pages: int = 0, digests=(),
                 n_cover: int = 0, wraps: bool = False):
        self.req = req
        self.cache = cache
        self.padded = padded  # (1, n_chunks * C) device tokens
        self.n_chunks = n_chunks
        self.next_chunk = 0
        self.last_logits = None
        self.base = base
        self.pids = pids
        self.n_pages = n_pages
        self.digests = digests
        self.n_cover = n_cover
        self.wraps = wraps


class ServingScheduler:
    """Continuous-batching scheduler over ``slots`` fixed slots.

    >>> sched = ServingScheduler(params, cfg, slots=8, eos_id=2)
    >>> r = sched.submit(prompt, max_new=64)   # any time, any order
    >>> sched.run()                            # or step() per tick
    >>> r.tokens                               # == generate_ring_dense

    ``prompt_chunk`` bounds the decode stall a long prompt injects into
    in-flight requests (one chunk per tick); ``max_prompt`` bounds the
    prompt length. ``device`` defaults to ``cuda``; ``params`` must
    live there. ``decode_ticks`` counts the ticks that ran the decode
    loop (each launches ``n_layers * n_inner`` attention calls) and
    ``prefill_chunks`` the prefill chunks run.

    ``page_tokens=P`` (dividing the window) switches to the paged
    cache of ``cache_pages`` pages (default: every slot a full window,
    plus the null page). A request holds only the pages its lifetime
    can touch, ``ceil(min(W, Tp + max_new + n_inner) / P)``, and
    admission waits (FIFO) while the pool cannot cover the head
    request, so the pool never runs dry mid-decode. Prompts sharing a
    page-aligned prefix with a resident request share its pages and
    skip their prefill (``pool.share_hits``); a page is copied before a
    slot writes it while it is shared (``pool.cow_copies``).

    Greedy by default; ``temperature > 0`` (optionally ``top_k``)
    samples each slot with its request's key (``submit(..., key=)``,
    from ``utils/prng.py``; ``prng.key(id + 1)`` when omitted). The
    first token is drawn at the prompt's last position, each later one
    at its own. ``max_queue`` caps the queue: a submit past it raises.

    Observability, all opt-in: ``registry=`` (an
    :class:`~..obs.MetricsRegistry`) for the tick, queue, slot and
    token series, TTFT and inter-token histograms, kernel-route and
    page-pool counters; ``spans=`` (an :class:`~..obs.SpanRecorder`)
    for per-tick admit/decode/retire spans in the merged Perfetto
    timeline; ``flight=`` (an :class:`~..obs.FlightRecorder`) for
    per-tick spans in its ring and the ``last_tick_at`` stamp;
    ``exporter=`` (an :class:`~..obs.ObsServer`) registers the
    tick-freshness ``/healthz`` check and the span recorder;
    ``trace=`` (a :class:`~..obs.TraceBook`) records each request's
    lifecycle events. With none of them the tick does no
    observability work beyond ``is None`` checks.

    ``qos=`` (a :class:`~..qos.TenantRegistry`) admits in weighted
    deficit-round-robin order over per-tenant queues (cost: prompt +
    ``max_new`` tokens); a tenant whose head cannot be planned (pool
    pressure, or its page quota after reclaiming its own cold pages)
    is passed over for the rest of the pass, never blocking another
    tenant. Paged, a retiring request's sole-held registered prefix
    pages go cold (resident, attributed to its tenant) and are
    reclaimed oldest-first, over-quota tenants' first.

    ``cache=`` (a :class:`~..cache.FleetPrefixCache`, paged only)
    attaches the scheduler to a fleet prefix cache: where the local
    share walk breaks, admission fetches the prompt's prefix pages from
    host DRAM or a peer scheduler instead of prefilling them
    (``fleet_hit`` per page), and a sole-held registered page about to
    be freed or evicted spills to DRAM first.

    Page-state migration: :meth:`export_page_state` takes a decoding
    request out with its pages, :meth:`adopt_page_state` lands it in
    another paged scheduler, and the stream goes on token for token.
    """

    def __init__(self, params, cfg: TransformerConfig, *, slots: int = 8,
                 n_inner: int = 8, eos_id: int | None = None,
                 prompt_chunk: int = 256, max_prompt: int = 2048,
                 quantize_kv: bool = False, temperature: float = 0.0,
                 top_k: int | None = None, page_tokens: int | None = None,
                 cache_pages: int | None = None,
                 qos: TenantRegistry | None = None,
                 max_queue: int | None = None, registry=None, spans=None,
                 flight=None, exporter=None, trace=None, cache=None,
                 device=None):
        _check_sampling_params(temperature, top_k)
        W = _check_ring_cfg(cfg)
        if cfg.n_experts:
            raise ValueError(
                "serving scheduler covers dense-FFN configs (MoE: see "
                "make_serving_scan's error note)"
            )
        if slots < 1 or n_inner < 1:
            raise ValueError("slots and n_inner must be >= 1")
        if prompt_chunk > max_prompt:
            raise ValueError("prompt_chunk must be <= max_prompt")
        self.paged = page_tokens is not None
        if self.paged:
            self.P = int(page_tokens)
            if self.P < 1 or W % self.P != 0:
                raise ValueError(
                    f"page_tokens must divide the attention window "
                    f"(W={W}), got {page_tokens}"
                )
            self.max_pages = W // self.P
        elif cache_pages is not None:
            raise ValueError(
                "cache_pages without page_tokens: pass page_tokens to "
                "enable the paged cache"
            )
        self.device = resolve_device(device)
        if params["emb"].device != self.device:
            raise ValueError(
                f"params live on {params['emb'].device}, the scheduler "
                f"on {self.device}"
            )
        self.params = params
        self.cfg = cfg
        self.S = int(slots)
        self.W = W
        self.n_inner = int(n_inner)
        self.eos_id = eos_id
        self.C = int(prompt_chunk)
        self.Lmax = int(max_prompt)
        # transient prefill arena: a chunk starts below max_prompt at
        # any base (a shared prefix ends on a page boundary, not a
        # chunk boundary), so it ends below max_prompt + C - 1
        self.L_arena = self.Lmax + self.C - 1
        self.quantize_kv = bool(quantize_kv)
        # queue-depth ceiling: the router sheds by name before a
        # replica sees a request; this is the hard backstop behind it
        if max_queue is not None and max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1 or None, got {max_queue}"
            )
        self.max_queue = None if max_queue is None else int(max_queue)
        self._queue: deque[Request] = deque()
        # multi-tenant QoS (opt-in): admission order moves from the
        # FIFO deque to weighted deficit-round-robin over per-tenant
        # queues, and paged admission enforces page quotas with
        # cold-page reclaim
        if qos is not None and len(qos) == 0:
            raise ValueError(
                "qos= needs at least one TenantContract registered: "
                "an empty registry can admit nothing"
            )
        self._qos = qos
        self._drr = DeficitScheduler(qos) if qos is not None else None
        if qos is not None:
            # per-tenant page accounting: hot refs (pages the tenant's
            # resident slots hold) + cold pages (retired prefix pages
            # kept resident, attributed to the tenant that landed
            # them); quota usage is their sum
            self._tenant_pages: dict[str, int] = {}
            self._cold: dict[int, str] = {}  # pid -> tenant, oldest first
            self._cold_count: dict[str, int] = {}
        self._slot_req: list[Request | None] = [None] * self.S
        self._admitting: dict[int, _Admitting] = {}
        self.tick_count = 0
        self.decode_ticks = 0
        self.prefill_chunks = 0
        dev = self.device
        self._tok = torch.zeros((self.S,), dtype=torch.int32, device=dev)
        self._pos = torch.zeros((self.S,), dtype=torch.int32, device=dev)
        self._done = torch.ones((self.S,), dtype=torch.bool, device=dev)
        # sampling: one device key per slot (written at admission; idle
        # rows draw with whatever key they hold, and nobody reads them)
        self.temperature = float(temperature)
        self.top_k = top_k
        self._keys = (torch.zeros((self.S, 2), dtype=torch.int64,
                                  device=dev)
                      if self.temperature > 0.0 else None)
        self._rows0 = torch.zeros((self.S,), dtype=torch.int32, device=dev)
        # int8 kernel routing, resolved once against this slot count
        # (the reference's AUTO gate: the tick batches all S slots into
        # one kernel call per layer)
        if self.paged:
            n_pages = (int(cache_pages) if cache_pages is not None
                       else self.S * self.max_pages + 1)
            if n_pages < self.max_pages + 1:
                raise ValueError(
                    f"cache_pages {n_pages} cannot hold even one "
                    f"window-filling request ({self.max_pages} pages "
                    "+ the null page)"
                )
            self.pool = PagePool(n_pages, self.P)
            self._caches = _fresh_pages(cfg, n_pages, self.P,
                                        self.quantize_kv, dev)
            # host-owned page table; the device copy is refreshed
            # lazily after admission, COW or retirement changed it
            self._pt_host = np.full((self.S, self.max_pages), NULL_PAGE,
                                    np.int32)
            self._pt_dev = None
            # per-slot global position, for the pre-tick COW pass
            self._host_pos = [0] * self.S
            # per-slot: can the resident request wrap its ring?
            self._slot_wraps = [False] * self.S
            self.use_kernel = (
                _paged_kernel_possible(cfg, self.quantize_kv, self.P)
                and _route_kernel(_UNSET, self.S)
            )
        else:
            self.pool = None
            self._caches = init_cache(cfg, self.S, W,
                                      quantize_kv=self.quantize_kv,
                                      device=dev)
            self.use_kernel = (
                _kernel_possible(cfg, self.quantize_kv)
                and _route_kernel(_UNSET, self.S)
            )
        # instruments resolved once here; None = dark (no tick cost)
        self._obs = (_ServingObs(self, registry, spans)
                     if registry is not None or spans is not None
                     else None)
        self._flight = flight
        # perf_counter of the latest tick: the liveness signal of the
        # /healthz tick-freshness check and flight watchdogs; a fully
        # dark scheduler never reads the clock
        self.last_tick_at: float | None = None
        self._stamp_ticks = (self._obs is not None or flight is not None
                             or exporter is not None)
        self._trace = None
        if trace is not None:
            self.attach_trace(trace)
        # fleet prefix cache (opt-in): the fleet unit is the page
        self.cache = cache
        self.cache_name: str | None = None
        if cache is not None:
            if not self.paged:
                raise ValueError(
                    "cache= needs the paged arena: pass page_tokens "
                    "(the fleet cache's unit is the prefix page)"
                )
            self.cache_name = cache.attach(self)
        if exporter is not None:
            exporter.register_scheduler(self)

    def attach_trace(self, book) -> None:
        """Arm causal tracing: request lifecycle events go to ``book``
        (a :class:`~..obs.TraceBook`) on the wall clock. DRR admission
        transitions ride the scheduler's hook (qos/ reads no clock)."""
        self._trace = book
        if self._drr is not None:
            self._drr.set_trace(self._drr_trace_event)

    def _drr_trace_event(self, kind, tenant, item, cost) -> None:
        tid = item.trace
        if tid is not None:
            self._trace.event(tid, kind, time.perf_counter(),
                              tenant=tenant, cost=cost)

    # -- public API -----------------------------------------------------

    def enable_tick_stamping(self) -> None:
        """Turn on the per-tick ``last_tick_at`` stamp (one clock read
        a tick); :meth:`ObsServer.register_scheduler` calls it so a
        scheduler registered after a dark construction is probeable."""
        self._stamp_ticks = True

    def _pick(self, lg, pos, keys):
        """Per-row token choice (the reference's ``_pick_rows``): greedy,
        or each row sampled as row 0 of its own stream with its own key
        and position, so a slot's stream equals
        ``generate_ring_dense(..., key=)`` with its request's key."""
        return _pick_token(lg, pos, keys, self._rows0[:lg.shape[0]],
                           self.temperature, self.top_k)

    def submit(self, prompt, max_new: int, key=None,
               tenant: str | None = None, trace=None) -> Request:
        """Queue a request; returns the live :class:`Request` whose
        ``tokens``/``finished`` the caller watches. Admission happens
        inside subsequent ticks. ``key``: the request's key (a
        ``utils/prng.py`` key, or its uint32 data) on a sampling
        scheduler; raises on a greedy one. ``tenant``: the contract the
        request is billed to, required on a ``qos=`` scheduler (an
        unknown tenant raises ``KeyError`` by name); otherwise it rides
        the request.
        ``trace``: a ``TraceBook`` id minted upstream (a router's); else
        an attached book mints one here."""
        if key is not None and self.temperature == 0.0:
            raise ValueError(
                "submit(key=...) on a greedy scheduler: the key would "
                "be silently unused; construct the scheduler with "
                "temperature > 0 (generate_* raises the same way)"
            )
        if self.max_queue is not None and self.pending >= self.max_queue:
            raise RuntimeError(
                f"queue ceiling: {self.pending} requests already "
                f"queued at max_queue={self.max_queue}; shed at the "
                "router instead of queueing unboundedly"
            )
        if self._qos is not None:
            if tenant is None:
                raise ValueError(
                    "qos scheduler needs tenant= at submit: admission "
                    "order and page quotas are per-contract (register "
                    "a catch-all TenantContract for untagged traffic)"
                )
            self._qos.get(tenant)  # unknown tenant: named KeyError
        if key is not None:
            key = torch.as_tensor(key).to(self.device, torch.int64)
            if tuple(key.shape) != (2,):
                raise ValueError(f"key must be one key of shape (2,), got "
                                 f"{tuple(key.shape)}")
        req = Request(prompt, max_new, key=key, tenant=tenant)
        if req.prompt.size > self.Lmax:
            raise ValueError(
                f"prompt of {req.prompt.size} tokens exceeds max_prompt "
                f"{self.Lmax}; raise max_prompt"
            )
        obs = self._obs
        if obs is not None:
            req._t_submit = time.perf_counter()
        if trace is not None:
            req.trace = trace
        elif self._trace is not None:
            # this scheduler is the entry door: mint here and own the
            # terminal events
            req.trace = self._trace.mint()
            req._trace_owned = True
            self._trace.event(
                req.trace, "submitted", time.perf_counter(),
                tenant=tenant, prompt=int(req.prompt.size),
            )
        if self._drr is not None:
            # DRR cost is in tokens (prompt + budget), so fairness is
            # fair chip work, not fair request counts
            self._drr.enqueue(tenant, req,
                              float(req.prompt.size + req.max_new))
        else:
            self._queue.append(req)
        if obs is not None and obs._r:
            obs.m_queue.set(self.pending)
        return req

    @property
    def active(self) -> int:
        """Slots currently decoding or admitting."""
        return sum(r is not None for r in self._slot_req)

    @property
    def pending(self) -> int:
        return (self._drr.total if self._drr is not None
                else len(self._queue))

    def step(self) -> list[Request]:
        """One scheduler tick; returns the requests retired in it
        (including any that retire at admission). Instrumented, the
        tick records admit/decode/retire spans and the queue, slot and
        token series; dark, it adds only ``is None`` checks."""
        obs = self._obs
        flight = self._flight
        lit = self._stamp_ticks
        t0 = time.perf_counter() if lit else 0.0
        self.tick_count += 1
        retired: list[Request] = []
        t2 = None
        with torch.no_grad():
            for s in list(self._admitting):
                self._advance_admission(s, retired)
            self._admit_from_queue(retired)
            t1 = time.perf_counter() if obs is not None else 0.0
            decoding = [
                s for s, r in enumerate(self._slot_req)
                if r is not None and s not in self._admitting
            ]
            if decoding:
                if self.paged:
                    # every page the next n_inner writes touch must be
                    # the row's own before the tick runs
                    self._prepare_tick_pages(decoding)
                if obs is None:
                    host = self._decode_fetch(decoding)
                else:
                    with obs.annotate("serving.decode_scan"):
                        host = self._decode_fetch(decoding)
                    t2 = time.perf_counter()
        for s in decoding:
            req = self._slot_req[s]
            n_before = len(req.tokens) if obs is not None else 0
            req.tokens.extend(int(t) for t in host[s])
            due = self._retire_if_due(req)
            if obs is not None:
                # counted after the retirement trim: the EOS-clamped
                # tail the host strips was never delivered
                obs.tokens_emitted(req, len(req.tokens) - n_before, t2)
            if due:
                self._free_slot(s)
                retired.append(req)
        if obs is not None:
            obs.tick_done(self, retired, t0, t1, t2)
        if lit:
            now = time.perf_counter()
            self.last_tick_at = now
            if flight is not None:
                flight.span(
                    f"tick {self.tick_count}", t0, now - t0,
                    src="scheduler", track="scheduler",
                    queue=self.pending, active=self.active,
                    retired=len(retired),
                )
                flight.counter(
                    "serving_ticks_total", self.tick_count, t=now
                )
        return retired

    def _decode_fetch(self, decoding: list[int]) -> np.ndarray:
        """Run the decode tick for every slot and fetch its (S, n_inner)
        token block to the host: the tick's one sync. ``decoding``: the
        slots whose requests decode (their host positions advance)."""
        pick = (lambda lg, pos: self._pick(lg, pos, self._keys))
        if self.paged:
            (self._tok, self._pos, self._done, self._caches,
             toks) = _serving_scan_paged(
                self.params, self._tok, self._pos, self._done,
                self._caches, self._device_pt(), self.cfg, self.eos_id,
                self.n_inner, pick, self.P, self.use_kernel,
            )
            for s in decoding:
                self._host_pos[s] += self.n_inner
        else:
            (self._tok, self._pos, self._done, self._caches,
             toks) = _scan_body(
                self.params, self._tok, self._pos, self._done,
                self._caches, self.cfg, self.eos_id, self.n_inner, pick,
                use_kernel=self.use_kernel,
            )
        self.decode_ticks += 1
        return toks.cpu().numpy()

    def run(self, max_ticks: int = 10_000) -> None:
        """Tick until every queued and in-flight request retires."""
        for _ in range(max_ticks):
            if self.pending == 0 and self.active == 0:
                return
            self.step()
        raise RuntimeError(
            f"not drained after {max_ticks} ticks: {self.pending} "
            f"queued, {self.active} active"
        )

    def cancel(self, req: Request) -> bool:
        """Withdraw ``req`` wherever it is (queued, admitting or
        decoding), freeing its slot and pages. True when it was live
        here and is now retired with ``reason == "cancelled"``."""
        if req.finished:
            return False
        if self._drr is not None:
            removed = self._drr.remove(req)
        else:
            removed = req in self._queue
            if removed:
                self._queue.remove(req)
        if removed:
            self._retire_cancelled(req)
            return True
        for s, r in enumerate(self._slot_req):
            if r is req:
                st = self._admitting.pop(s, None)
                if st is not None and self.paged:
                    # mid-admission the pages live in the plan (the
                    # table row stays null until finish)
                    for pid in st.pids[:st.n_pages]:
                        self.pool.decref(pid, wrapper=st.wraps)
                    self._tenant_debit(req.tenant, st.n_pages)
                self._free_slot(s)
                self._retire_cancelled(req)
                return True
        return False

    def _retire_cancelled(self, req: Request) -> None:
        req.finished = True
        req.reason = "cancelled"
        req.retired_tick = self.tick_count
        # terminal events belong to the request's owner (the door that
        # minted its trace)
        if self._trace is not None and req.trace is not None \
                and req._trace_owned:
            self._trace.event(
                req.trace, "cancelled", time.perf_counter(),
                tick=self.tick_count,
            )

    def _device_pt(self):
        """The device page table, refreshed from the host copy when
        admission, COW or retirement changed it."""
        if self._pt_dev is None:
            self._pt_dev = torch.tensor(self._pt_host, device=self.device)
        return self._pt_dev

    # -- page payloads (the fleet cache's wire and storage format) -------

    def _page_row_bytes(self) -> int:
        """Bytes one page carries across every layer and leaf."""
        return sum(a.nbytes * self.P // a.shape[0]
                   for cl in self._caches for a in cl.values())

    def _page_payload(self, pid: int) -> np.ndarray:
        """One page's KV bytes as a flat host ``uint8`` array: per
        layer (list order), per leaf (sorted key order), the page's
        rows as raw bytes: the reference's layout, so on one arena
        content both packages give the same bytes. One gather on the
        device, one copy to the host."""
        P = self.P
        parts = [cl[kk][pid * P:(pid + 1) * P].reshape(-1).view(torch.uint8)
                 for cl in self._caches for kk in sorted(cl)]
        return torch.cat(parts).cpu().numpy()

    def _install_page_payload(self, pid: int, payload) -> None:
        """Write a :meth:`_page_payload`-format byte string into page
        ``pid`` of this arena, in place (one copy to the device, then a
        page write per leaf). A size mismatch is refused by name."""
        P = self.P
        buf = np.asarray(payload).reshape(-1).view(np.uint8)
        nbytes = self._page_row_bytes()
        if buf.size != nbytes:
            raise ValueError(
                f"page payload is {buf.size} bytes, this arena's "
                f"pages are {nbytes}"
            )
        dev = torch.from_numpy(buf.copy()).to(self.device)
        pids = torch.tensor([pid], device=self.device)
        off = 0
        for cl in self._caches:
            for kk in sorted(cl):
                a = cl[kk]
                nb = a.nbytes * P // a.shape[0]
                # clone: a view to a wider dtype needs an aligned start
                rows = dev[off:off + nb].clone().view(a.dtype)
                _write_pages(a, pids, rows.reshape((P,) + a.shape[1:]), P)
                off += nb

    def _spill_page(self, pid: int, *, tenant: str | None = None) -> None:
        """Offer a registered, sole-held page to the fleet cache's DRAM
        tier before it is freed or evicted, reading its bytes while
        they still match its digest. A no-op when the fleet holds the
        digest somewhere else."""
        d = self.pool.digest_of(pid)
        if d is None:
            return
        if not self.cache.wants(d, exclude=self.cache_name):
            return
        self.cache.spill(d, self._page_payload(pid), tenant=tenant)

    # -- page-state migration -------------------------------------------
    #
    # Export gathers a decoding slot's ring view out of the pool (fresh
    # tensors) with the row's token, position and key, and frees the
    # slot; adopt re-plans the pages in this pool (sharing resident
    # prefix pages with COW reservations, as admission does), writes the
    # view into the pages the request does not share, and re-registers
    # the prefix chain. Between the two the request is resident nowhere:
    # models/disagg.py's MigrationPlanner owns that window.

    def _migration_slot(self, req: Request) -> int | None:
        """The slot of a migratable request: resident, past admission
        (first token emitted), not finished. None otherwise."""
        if not self.paged or req.finished or not req.tokens:
            return None
        for s, r in enumerate(self._slot_req):
            if r is req and s not in self._admitting:
                return s
        return None

    def migration_nbytes(self, req: Request) -> int:
        """Payload bytes a migration of ``req`` would move: the pages
        its slot holds times :meth:`_page_row_bytes`. 0 when ``req`` is
        not migratable here."""
        s = self._migration_slot(req)
        if s is None:
            return 0
        n_pages = int(np.sum(self._pt_host[s] != NULL_PAGE))
        return n_pages * self._page_row_bytes()

    def export_page_state(self, req: Request) -> dict:
        """Capture ``req``'s decode state and free its slot (its pages
        decref'd; a shared prefix just drops a reference). The dict
        holds everything :meth:`adopt_page_state` needs to continue the
        stream token for token on a scheduler with the same params and
        generation config: the gathered ``(1, W, ...)`` ring view per
        layer (new tensors, independent of this pool's later reuse),
        the row's token, position and key data (two ``uint32`` words;
        zeros on a greedy scheduler), and the prefix-digest chain. The
        request is not finished or changed: it is resident nowhere
        until adopted."""
        s = self._migration_slot(req)
        if s is None:
            raise ValueError(
                "export_page_state: request must be decoding on this "
                "paged scheduler (queued/mid-admission/finished "
                "requests have no page image to move)"
            )
        pos = self._host_pos[s]
        n_pages = int(np.sum(self._pt_host[s] != NULL_PAGE))
        # prefix pages hold what their digests describe only until a
        # ring write wraps past W
        clean = pos <= self.W and req.prompt.size <= self.W
        if clean:
            digests = prefix_page_digests(req.prompt, self.P,
                                          self.max_pages)
            n_cover = min(req.prompt.size // self.P, self.max_pages)
        else:
            digests, n_cover = [], 0
        pt_row = torch.tensor(self._pt_host[s][None], device=self.device)
        ring = [_paged_gather(cl, pt_row, self.P) for cl in self._caches]
        key_data = (prng.key_data(self._keys[s]) if self._keys is not None
                    else np.zeros(2, np.uint32))
        state = {
            "request": req,
            "prompt": req.prompt,
            "tokens": list(req.tokens),
            "max_new": req.max_new,
            "tok": int(self._tok[s]),
            "pos": int(pos),
            "key_data": key_data,
            "ring": ring,
            "digests": tuple(digests),
            "n_cover": int(n_cover),
            "n_pages": n_pages,
            "P": self.P,
            "W": self.W,
            "quantize_kv": self.quantize_kv,
            "temperature": self.temperature,
            "top_k": self.top_k,
            "eos_id": self.eos_id,
        }
        self._free_slot(s)
        return state

    def _check_adopt_compat(self, state: dict) -> None:
        for k, want in (
            ("P", self.P), ("W", self.W),
            ("quantize_kv", self.quantize_kv),
            ("temperature", self.temperature), ("top_k", self.top_k),
            ("eos_id", self.eos_id),
        ):
            if state[k] != want:
                raise ValueError(
                    f"adopt_page_state: {k} mismatch (source "
                    f"{state[k]!r}, this scheduler {want!r}): tiers "
                    "must share page geometry and generation config "
                    "for the stream to continue token-for-token"
                )

    def _plan_adopt(self, state: dict, *, reclaim: bool = False):
        """(slot, shared pids, n_pages, wraps) for adopting ``state``,
        or None when no free slot or pool capacity covers it: the
        admission's whole-lifetime budget, so the pool never runs dry
        mid-decode. Under ``qos=`` cold pages count as headroom (a
        stream is resident nowhere while its migration waits):
        ``reclaim=True`` (the adopt path) evicts the shortfall, False
        (the :meth:`can_adopt_state` probe) only counts it, so probing
        never drains the cold cache."""
        free_s = next((s for s, r in enumerate(self._slot_req)
                       if r is None and s not in self._admitting), None)
        if free_s is None:
            return None
        Tp = state["prompt"].size
        horizon = Tp + state["max_new"] + self.n_inner
        wraps = horizon > self.W
        n_pages = -(-min(self.W, horizon) // self.P)
        shared: list[int] = []
        for d in state["digests"][:min(state["n_cover"], n_pages)]:
            pid = self.pool.lookup(d)
            if pid is None:
                break
            shared.append(pid)
        reserve = sum(self.pool.share_needs_reserve(pid, wraps)
                      for pid in shared)
        shortfall = (n_pages - len(shared) + reserve
                     + self.pool.reserved - self.pool.free)
        if shortfall > 0:
            if self._drr is None:
                return None
            sset = set(shared)
            if reclaim:
                for _ in range(shortfall):
                    if not self._evict_cold_page(protect=sset):
                        return None
            elif sum(pid not in sset for pid in self._cold) < shortfall:
                return None
        return free_s, shared, n_pages, wraps

    def can_adopt_state(self, state: dict) -> bool:
        """Would :meth:`adopt_page_state` succeed right now (a free slot
        and pool capacity for the whole-lifetime budget, resident
        shares counted)? False, never a raise, on a config mismatch."""
        if not self.paged:
            return False
        try:
            self._check_adopt_compat(state)
        except ValueError:
            return False
        return self._plan_adopt(state) is not None

    def could_adopt_state(self, state: dict) -> bool:
        """Would :meth:`adopt_page_state` ever succeed here, with every
        slot and page free? False: the pool is statically too small or
        the config mismatches, and waiting cannot help."""
        if not self.paged:
            return False
        try:
            self._check_adopt_compat(state)
        except ValueError:
            return False
        Tp = state["prompt"].size
        horizon = Tp + state["max_new"] + self.n_inner
        n_pages = -(-min(self.W, horizon) // self.P)
        # an empty pool has n_pages - 1 usable pages (page 0 is null)
        return n_pages <= self.pool.n_pages - 1

    def adopt_page_state(self, state: dict,
                         request: Request | None = None) -> Request:
        """Land a migrated request (:meth:`export_page_state` of the
        source) here: allocate its page budget, sharing resident
        prefix pages with COW reservations as admission does; write the
        carried ring view into the pages it does not share, in place
        (a shared page is never written, so no sharer's bytes change);
        install the row's token, position and key; and re-register the
        prefix chain. ``request`` overrides the continued request
        object (a ticket rebuilt from frames carries none, and then a
        new one is made)."""
        if not self.paged:
            raise ValueError(
                "adopt_page_state on an unpaged scheduler: migration "
                "is a page-layout transfer (construct with "
                "page_tokens=)"
            )
        self._check_adopt_compat(state)
        plan = self._plan_adopt(state, reclaim=True)
        if plan is None:
            raise PagePoolExhausted(
                "adopt_page_state: no free slot or page capacity for "
                "the migrated request (gate on can_adopt_state)"
            )
        s, shared, n_pages, wraps = plan
        req = request if request is not None else state["request"]
        if req is None:
            req = Request(state["prompt"], state["max_new"])
            req.tokens = list(state["tokens"])
            req._scanned = len(req.tokens)
        pids = [NULL_PAGE] * self.max_pages
        for j, pid in enumerate(shared):
            self.pool.share(
                pid, reserve=self.pool.share_needs_reserve(pid, wraps),
                wrapper=wraps,
            )
            pids[j] = pid
            if self._trace is not None and req.trace is not None:
                self._trace.event(
                    req.trace, "share_hit", time.perf_counter(),
                    page=int(pid),
                )
            if self._drr is not None and pid in self._cold:
                self._drop_cold(pid)
        try:
            for j in range(len(shared), n_pages):
                pids[j] = self.pool.alloc()
        except PagePoolExhausted:
            # a planned adoption never half-commits
            for pid in pids:
                if pid != NULL_PAGE:
                    self.pool.decref(int(pid), wrapper=wraps)
            raise
        if self._drr is not None and req.tenant is not None:
            # the stream's tenant takes its pages over here
            self._tenant_pages[req.tenant] = (
                self._tenant_pages.get(req.tenant, 0) + n_pages)
        self._pt_host[s] = pids
        self._pt_dev = None
        self._host_pos[s] = state["pos"]
        self._slot_wraps[s] = wraps
        ring = [{kk: a.to(self.device) for kk, a in cl.items()}
                for cl in state["ring"]]
        _place_paged(self._caches, ring,
                     torch.tensor(pids, device=self.device),
                     len(shared), n_pages, self.P)
        rkey = (prng.wrap_key_data(state["key_data"], device=self.device)
                if self._keys is not None else None)
        _start_row(self._tok, self._pos, self._done, self._keys, s,
                   torch.tensor([state["tok"]], dtype=torch.int32),
                   state["pos"], rkey)
        for j in range(min(state["n_cover"], n_pages)):
            self.pool.register(state["digests"][j], pids[j],
                               volatile=wraps)
        self._slot_req[s] = req
        if req.admitted_tick is None:
            req.admitted_tick = self.tick_count
        if self._trace is not None and req.trace is not None:
            self._trace.event(
                req.trace, "admitted", time.perf_counter(),
                tick=self.tick_count, adopted=True,
            )
        return req

    # -- admission ------------------------------------------------------

    def _admit_from_queue(self, retired: list[Request]) -> None:
        free = [s for s, r in enumerate(self._slot_req) if r is None]
        if self._drr is not None:
            self._admit_drr(free, retired)
            return
        while self._queue and free:
            plan = None
            if self.paged:
                plan = self._plan_pages(self._queue[0])
                if plan is None:
                    # the head request does not fit the pool: wait for
                    # retirements (FIFO, so it is never starved)
                    break
            self._admit_into(free.pop(0), self._queue.popleft(), plan,
                             retired)

    def _admit_drr(self, free: list[int], retired: list[Request]) -> None:
        """QoS admission: free slots fill in deficit-round-robin order
        (:class:`~..qos.DeficitScheduler`: weighted, work-conserving,
        deficits carried). A tenant whose head cannot be planned right
        now (pool pressure, or its page quota even after reclaiming its
        own cold pages) is restored unchanged and passed over for the
        rest of this pass: one tenant's unplannable head never blocks
        another tenant's admission."""
        deferred: set[str] = set()
        while free:
            pick = self._drr.pick(skip=deferred)
            if pick is None:
                return
            tenant, req, cost = pick
            plan = None
            if self.paged:
                plan = self._plan_pages_qos(req)
                if plan is None:
                    self._drr.restore(tenant, req, cost)
                    deferred.add(tenant)
                    continue
            self._admit_into(free.pop(0), req, plan, retired)

    def _admit_into(self, s: int, req: Request, plan,
                    retired: list[Request]) -> None:
        Tp = req.prompt.size
        base, paging = 0, {}
        if self.paged:
            base, paging = self._commit_pages(req, plan)
        rem = Tp - base
        n_chunks = -(-rem // self.C)
        padded = np.zeros((1, n_chunks * self.C), np.int32)
        padded[0, :rem] = req.prompt[base:]
        cache = init_cache(self.cfg, 1, self.L_arena,
                           quantize_kv=self.quantize_kv, device=self.device)
        if base:
            # skip the shared prefix's prefill: its K/V are the pages'
            _seed_admit_paged(
                cache, self._caches,
                torch.tensor(paging["pids"][:base // self.P],
                             device=self.device),
                base, self.P,
            )
        self._slot_req[s] = req
        self._admitting[s] = _Admitting(
            req, cache, torch.as_tensor(padded, device=self.device),
            n_chunks, base=base, **paging,
        )
        req.admitted_tick = self.tick_count
        if self._obs is not None and req.tenant is not None:
            self._obs.qos_admitted(self, req.tenant)
        if self._trace is not None and req.trace is not None:
            self._trace.event(
                req.trace, "admitted", time.perf_counter(),
                tick=self.tick_count,
            )
        # the first chunk runs this very tick
        self._advance_admission(s, retired)

    def _advance_admission(self, s: int, retired: list[Request]) -> None:
        """Prefill the admission's next chunk, and after its last chunk
        pick the first token and start the row. Nothing of the
        admission's state is committed (chunk counter, counts, obs and
        trace events) until the chunk, and on the last chunk the pick,
        has succeeded: a raise leaves the slot as it was, so the next
        step retries the same chunk and raises the same error, as the
        reference does."""
        st = self._admitting[s]
        i = st.next_chunk
        chunk = st.padded[:, i * self.C:(i + 1) * self.C]
        logits, cache = _extend_chunk_dense(
            self.params, chunk, st.cache, st.base + i * self.C, self.cfg
        )
        last = i + 1 == st.n_chunks
        if last:
            Tp = st.req.prompt.size
            rkey = None
            if self._keys is not None:
                rkey = (st.req.key if st.req.key is not None
                        else prng.key(st.req.id + 1, device=self.device))
            tok0, ring = _finish_admit_dense(
                cache, logits, Tp, st.base + i * self.C, self.W,
                lambda lg, pos: self._pick(
                    lg, pos, None if rkey is None else rkey[None]),
            )
        st.last_logits, st.cache = logits, cache
        st.next_chunk = i + 1
        self.prefill_chunks += 1
        if self._obs is not None:
            self._obs.prefill_chunk()
        if self._trace is not None and st.req.trace is not None:
            self._trace.event(
                st.req.trace, "prefill_chunk", time.perf_counter(),
                tick=self.tick_count,
            )
        if not last:
            return
        if self.paged:
            # install the table row now (the row's stale writes went to
            # the null page until here), then the request's own pages
            self._pt_host[s] = st.pids
            self._pt_dev = None
            self._host_pos[s] = Tp
            self._slot_wraps[s] = st.wraps
            _place_paged(self._caches, ring,
                         torch.tensor(st.pids, device=self.device),
                         st.base // self.P, st.n_pages, self.P)
            # the prompt-covered pages now hold what their digests
            # describe: publish them (first-wins)
            for j in range(st.n_cover):
                self.pool.register(st.digests[j], st.pids[j],
                                   volatile=st.wraps)
        else:
            _place_dense(self._caches, ring, s)
        _start_row(self._tok, self._pos, self._done, self._keys, s, tok0,
                   Tp, rkey)
        st.req.tokens.append(int(tok0[0]))
        if self._obs is not None:
            self._obs.first_token(st.req, time.perf_counter())
        if self._trace is not None and st.req.trace is not None:
            self._trace.event(
                st.req.trace, "first_token", time.perf_counter(),
                tick=self.tick_count,
            )
        del self._admitting[s]
        if self._retire_if_due(st.req):  # max_new == 1 or prompt EOS
            self._free_slot(s)
            retired.append(st.req)

    # -- paged admission planning ---------------------------------------

    def _plan_pages(self, req: Request):
        """Page budget of ``req``: the resident prefix pages it can
        share, its digests, the pages its whole lifetime can touch
        (ring slots ``[0, min(W, Tp + max_new + n_inner))``), whether
        it wraps, and the digests to fetch from the fleet cache. None
        when the pool cannot cover the fresh pages plus one COW
        reservation per share that can end in a write; the request then
        stays queued."""
        shared, digests, n_pages, wraps, n_fresh, reserve, fetch = \
            self._page_needs(req)
        if not self.pool.can_alloc(n_fresh, reserve=reserve):
            return None
        return shared, digests, n_pages, wraps, fetch

    def _page_needs(self, req: Request):
        """The share walk and budget arithmetic both planners share:
        (shared, digests, n_pages, wraps, n_fresh, reserve, fetch),
        computed without consulting pool capacity. ``fetch``: where the
        local share walk breaks, the walk goes on against the fleet
        cache, and each digest it can probe, contiguously, is a planned
        fetch. A fetched page is a fresh page (inside ``n_fresh``), so
        the capacity and quota arithmetic is unchanged; a fetch that
        fails at commit prefills what the plan budgeted anyway."""
        Tp = req.prompt.size
        W, P = self.W, self.P
        digests: list[bytes] = []
        shared: list[int] = []
        fetch: list[bytes] = []
        if Tp <= W:
            # within the window ring slot s holds position s, so the
            # page-aligned prefix determines the pages: shareable. At
            # least the last prompt token prefills (its logits give
            # the first token).
            digests = prefix_page_digests(req.prompt, P, self.max_pages)
            shareable = digests[:(Tp - 1) // P]
            for d in shareable:
                pid = self.pool.lookup(d)
                if pid is None:
                    break
                shared.append(pid)
            if self.cache is not None:
                for d in shareable[len(shared):]:
                    if self.cache.probe(d, exclude=self.cache_name) is None:
                        break
                    fetch.append(d)
        horizon = Tp + req.max_new + self.n_inner
        wraps = horizon > W
        n_pages = -(-min(W, horizon) // P)
        reserve = sum(self.pool.share_needs_reserve(pid, wraps)
                      for pid in shared)
        return shared, digests, n_pages, wraps, n_pages - len(shared), \
            reserve, fetch

    def _commit_pages(self, req: Request, plan) -> tuple[int, dict]:
        """Execute a plan: share the prefix pages (attaching their COW
        reservations), fetch the planned fleet-cache pages (each a fresh
        page filled in place with the fetched bytes and registered,
        extending the prefill skip past the local share run), and
        allocate the rest. A fetch that comes back empty (eviction,
        partition or kill raced the plan) stops the fetch run; the rest
        of the prompt prefills as budgeted. Returns (base,
        :class:`_Admitting` keywords)."""
        shared, digests, n_pages, wraps, fetch = plan
        m = len(shared)
        pids = [NULL_PAGE] * self.max_pages
        for j, pid in enumerate(shared):
            self.pool.share(
                pid, reserve=self.pool.share_needs_reserve(pid, wraps),
                wrapper=wraps,
            )
            pids[j] = pid
            if self._trace is not None and req.trace is not None:
                self._trace.event(
                    req.trace, "share_hit", time.perf_counter(),
                    page=int(pid),
                )
            if self._drr is not None and pid in self._cold:
                # a cold page found its next sharer: the cache's hold
                # transfers to the new slot (warm)
                self._drop_cold(pid)
        for d in fetch:
            got = self.cache.fetch(d, exclude=self.cache_name)
            if got is None:
                break  # prefill the rest of the run
            src, payload = got
            pid = self.pool.alloc()
            self._install_page_payload(pid, payload)
            # first-wins: a digest registered since planning keeps its
            # page, and this one is the slot's private copy
            self.pool.register(d, pid, volatile=wraps)
            pids[m] = pid
            m += 1
            if self._obs is not None:
                self._obs.fleet_hit(src)
            if self._trace is not None and req.trace is not None:
                self._trace.event(
                    req.trace, "share_hit", time.perf_counter(),
                    page=int(pid), tier=src,
                )
        for j in range(m, n_pages):
            pids[j] = self.pool.alloc()
        if self._drr is not None:
            self._tenant_pages[req.tenant] = (
                self._tenant_pages.get(req.tenant, 0) + n_pages)
        Tp = req.prompt.size
        n_cover = min(Tp // self.P, self.max_pages) if Tp <= self.W else 0
        return m * self.P, {
            "pids": pids, "n_pages": n_pages, "digests": tuple(digests),
            "n_cover": n_cover, "wraps": wraps,
        }

    # -- QoS page quotas and cold-page reclaim (qos= only) ---------------
    #
    # A retiring request's still-registered refcount-1 prefix pages go
    # COLD instead of freeing: resident for future sharers (their
    # digests stay in the prefix table, their bytes untouched, since
    # no slot's table names them), attributed to the departing tenant,
    # and evictable. Cold pages have refcount 1 (a cold page that gains
    # a sharer leaves the cold set first), so eviction never touches a
    # page a live holder reads.

    def _tenant_usage(self, tenant: str) -> int:
        """Pages attributed to the tenant: hot refs held by its
        resident slots + its cold pages. The quota number."""
        return (self._tenant_pages.get(tenant, 0)
                + self._cold_count.get(tenant, 0))

    def _tenant_debit(self, tenant: str | None, n: int) -> None:
        if self._drr is None or tenant is None or n == 0:
            return
        left = self._tenant_pages.get(tenant, 0) - n
        if left:
            self._tenant_pages[tenant] = left
        else:
            self._tenant_pages.pop(tenant, None)

    def _over_quota(self, tenant: str) -> bool:
        quota = self._qos.get(tenant).pages
        return quota is not None and self._tenant_usage(tenant) > quota

    def _drop_cold(self, pid: int) -> str:
        """Take ``pid`` out of the cold set (warmed by a new sharer, or
        evicted) and drop the cache's hold; returns the tenant it was
        attributed to."""
        t = self._cold.pop(pid)
        n = self._cold_count.get(t, 0) - 1
        if n:
            self._cold_count[t] = n
        else:
            self._cold_count.pop(t, None)
        self.pool.decref(pid)
        return t

    def _evict_cold_page(self, *, protect=frozenset(),
                         tenant: str | None = None) -> bool:
        """Evict ONE cold page (freeing it). ``tenant`` narrows to that
        tenant's cold pages (quota enforcement); otherwise pool-pressure
        order: an over-quota tenant's cold pages first, then any.
        Oldest first within each class; ``protect`` pins the pages the
        plan in flight would share. False when nothing is evictable."""
        victim = None
        if tenant is not None:
            victim = next((pid for pid, t in self._cold.items()
                           if t == tenant and pid not in protect), None)
        else:
            victim = next((pid for pid, t in self._cold.items()
                           if pid not in protect and self._over_quota(t)),
                          None)
            if victim is None:
                victim = next((pid for pid in self._cold
                               if pid not in protect), None)
        if victim is None:
            return False
        if self.cache is not None:
            # the cold page's last device copy dies here: spill it to
            # the DRAM tier (tenant-attributed, so spill quotas bind)
            self._spill_page(victim, tenant=self._cold.get(victim))
        t = self._drop_cold(victim)
        if self._flight is not None:
            self._flight.event("qos reclaim", src="scheduler", tenant=t,
                               page=victim)
        return True

    def _plan_pages_qos(self, req: Request):
        """:meth:`_plan_pages` under the tenant's page quota, with
        cold-page reclaim on both pressure paths: pool exhaustion
        evicts exactly the shortfall in cold pages; quota exhaustion
        evicts the tenant's OWN cold pages. None when the request still
        cannot be planned (the DRR pass then defers this tenant)."""
        contract = self._qos.get(req.tenant)
        shared, digests, n_pages, wraps, n_fresh, reserve, fetch = \
            self._page_needs(req)
        # the plan's own shares are never victims: evicting one would
        # trade a prefill skip for a fresh page
        protect = set(shared)
        # an evicted cold page (refcount 1, no reservation) frees
        # exactly one page, so the shortfall is reclaimed in one pass
        shortfall = (n_fresh + reserve + self.pool.reserved
                     - self.pool.free)
        for _ in range(max(shortfall, 0)):
            if not self._evict_cold_page(protect=protect):
                return None
        if contract.pages is not None:
            # sharing one's own cold page moves it cold -> hot: no new
            # usage; everything else is net-new attribution
            own_cold_shared = sum(1 for pid in shared
                                  if self._cold.get(pid) == req.tenant)
            need = (self._tenant_usage(req.tenant) + n_pages
                    - own_cold_shared)
            while need > contract.pages:
                if not self._evict_cold_page(protect=protect,
                                             tenant=req.tenant):
                    return None
                need -= 1
        return shared, digests, n_pages, wraps, fetch

    def _prepare_tick_pages(self, decoding: list[int]) -> None:
        """Pre-tick COW pass: the next ``n_inner`` steps write ring
        slots ``[pos, pos + n_inner)`` (mod W) of every decoding row. A
        touched page still shared is copied to a fresh page (consuming
        the reservation attached at admission) and the row retargeted;
        a touched page the row owns alone leaves the prefix table (its
        bytes are about to change). All copies run in one call."""
        src: list[int] = []
        dst: list[int] = []
        for s in decoding:
            pos = self._host_pos[s]
            touched = {((pos + t) % self.W) // self.P
                       for t in range(self.n_inner)}
            for j in sorted(touched):
                pid = int(self._pt_host[s, j])
                if pid == NULL_PAGE:
                    raise PagePoolExhausted(
                        f"slot {s} page {j} unallocated at write time "
                        "(admission budget bug)"
                    )
                if self.pool.refcount(pid) > 1:
                    new = self.pool.cow_alloc(pid)
                    src.append(pid)
                    dst.append(new)
                    r = self._slot_req[s]
                    if self._trace is not None and r.trace is not None:
                        self._trace.event(
                            r.trace, "cow_copy", time.perf_counter(),
                            page=int(pid),
                        )
                    # only wrapping rows write shared pages
                    self.pool.decref(pid, wrapper=self._slot_wraps[s])
                    self._pt_host[s, j] = new
                    self._pt_dev = None
                else:
                    self.pool.note_write(pid)
        if src:
            _copy_pages_paged(
                self._caches, torch.tensor(src, device=self.device),
                torch.tensor(dst, device=self.device), self.P,
            )

    # -- retirement -----------------------------------------------------

    def _retire_if_due(self, req: Request) -> bool:
        cut = None
        if self.eos_id is not None and req._eos_at is None:
            # scan only the tokens new since the last scan
            try:
                req._eos_at = req.tokens.index(self.eos_id, req._scanned)
            except ValueError:
                pass
            req._scanned = len(req.tokens)
        if req._eos_at is not None:
            cut = req._eos_at + 1
            if cut <= req.max_new:
                req.reason = "eos"
            else:
                cut = None
        if cut is None and len(req.tokens) >= req.max_new:
            cut = req.max_new
            req.reason = "length"
        if cut is None:
            return False
        del req.tokens[cut:]
        req.finished = True
        req.retired_tick = self.tick_count
        # owner-only terminal stamp (see _retire_cancelled)
        if self._trace is not None and req.trace is not None \
                and req._trace_owned:
            self._trace.event(
                req.trace, "retired", time.perf_counter(),
                outcome=req.reason, tokens=len(req.tokens),
            )
        return True

    def _free_slot(self, s: int) -> None:
        req = self._slot_req[s]
        self._slot_req[s] = None
        # the row keeps decoding garbage until reused; done=True makes
        # it emit EOS-clamped tokens nobody reads
        self._done[s] = True
        if self.paged:
            # drop the slot's page references (a shared page frees only
            # with its last holder) and null the row, so its writes land
            # in the null page. Under qos=, a sole-held page whose
            # prefix digest is still registered goes COLD instead of
            # freeing: resident for future sharers, attributed to the
            # departing tenant, evicted oldest-first under pressure.
            tenant = (req.tenant if self._drr is not None
                      and req is not None else None)
            keep_cold = tenant is not None and not self._slot_wraps[s]
            n_refs = 0
            for pid in self._pt_host[s]:
                if pid == NULL_PAGE:
                    continue
                pid = int(pid)
                n_refs += 1
                if (keep_cold and self.pool.refcount(pid) == 1
                        and self.pool.registered(pid)):
                    self._cold[pid] = tenant
                    self._cold_count[tenant] = (
                        self._cold_count.get(tenant, 0) + 1)
                else:
                    # a sole-held registered page about to free: offer
                    # its bytes to the fleet's DRAM tier first (cold
                    # retention above takes precedence)
                    if (self.cache is not None
                            and not self._slot_wraps[s]
                            and self.pool.refcount(pid) == 1
                            and self.pool.registered(pid)):
                        self._spill_page(pid, tenant=tenant)
                    self.pool.decref(pid, wrapper=self._slot_wraps[s])
            self._tenant_debit(tenant, n_refs)
            self._pt_host[s] = NULL_PAGE
            self._pt_dev = None
            self._host_pos[s] = 0
            self._slot_wraps[s] = False
