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
request. Greedy streams equal ``generate_ring_dense`` token for token.

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

from collections import deque

import numpy as np
import torch

from .._device import resolve_device
from ..ops.decode_attention import paged_ring_view, quantized_decode_attention
from .decode import (
    _NEG,
    _UNSET,
    _cache_pv,
    _cache_scores,
    _check_ring_cfg,
    _check_sampling,
    _eos_clamp,
    _incremental_forward,
    _is_quantized,
    _kernel_possible,
    _kernel_viable,
    _kv_quantize,
    _paged_kernel_possible,
    _pick_token,
    _ring_from_cache,
    _route_kernel,
    init_cache,
)
from .paging import NULL_PAGE, PagePool, PagePoolExhausted, prefix_page_digests
from .transformer import TransformerConfig, _ln, _mlp, _rope_freqs

__all__ = ["Request", "ServingScheduler", "serving_decode_step_dense"]


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


def _serving_layer(x, lp, cache_l, pos, cfg, index, *, use_kernel=False,
                   paged=None):
    """One layer of the per-row serving step (decode.py's
    ``_incremental_layer`` with per-row positions). ``paged = (pt, P)``
    reads the page pool through the kernel; None is the slot ring."""
    h = _ln(x, lp["ln1_s"], lp["ln1_b"])
    q = torch.einsum("bld,dhk->blhk", h, lp["wq"])
    k = torch.einsum("bld,dhk->blhk", h, lp["wk"])
    v = torch.einsum("bld,dhk->blhk", h, lp["wv"])
    q, k = _rope_rows(q, pos), _rope_rows(k, pos)
    scale = cfg.head_dim ** -0.5
    cache_l = _write_rows(cache_l, k, v, index)
    if paged is None:
        o = _ring_attention_rows(q, cache_l, pos, scale,
                                 use_kernel=use_kernel)
    else:
        o = _paged_attention_rows(q, cache_l, paged, pos, scale)
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


def _pick_rows(lg):
    """Per-row greedy token choice."""
    return _pick_token(lg)


def _scan_body(params, tok, pos, done, caches, cfg, eos_id, n_inner,
               *, use_kernel=False, paged=None):
    """``n_inner`` greedy decode steps for all S slots, on the device,
    with no host sync. Returns (tok, pos, done, caches, toks (S,
    n_inner))."""
    toks = torch.empty((tok.shape[0], n_inner), dtype=torch.int32,
                       device=tok.device)
    for t in range(n_inner):
        lg, caches = _serving_forward(params, tok, pos, caches, cfg,
                                      use_kernel=use_kernel, paged=paged)
        nxt, done = _eos_clamp(_pick_rows(lg), tok, done, eos_id)
        toks[:, t] = nxt
        tok, pos = nxt, pos + 1
    return tok, pos, done, caches, toks


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
                        n_inner, P: int, use_kernel: bool):
    """The paged tick: ``n_inner`` decode steps for all slots through
    the ``(S, max_pages)`` int32 page table (tick-invariant: copy-on-
    write retargets it on the host between ticks). The kernel route
    reads pages in place at every step. The einsum route gathers each
    layer's ring views once, runs the slot-ring tick on them, and
    scatters them back."""
    if use_kernel:
        return _scan_body(params, tok, pos, done, caches, cfg, eos_id,
                          n_inner, paged=(pt, P))
    views = [_paged_gather(cl, pt, P) for cl in caches]
    tok, pos, done, views, toks = _scan_body(
        params, tok, pos, done, views, cfg, eos_id, n_inner)
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
                        W: int):
    """Gather the last-W window of a filled positional cache into ring
    rows and pick the first token from the last chunk's logits.
    Returns (tok0 0-d int32 tensor, ring leaves (1, W, ...))."""
    ring = [_ring_from_cache(cl, true_len, W) for cl in cache]
    tok0 = _pick_rows(last_logits[0, true_len - 1 - last_off])
    return tok0, ring


def _start_row(tok, pos, done, s: int, tok0, pos0: int) -> None:
    """Set slot ``s``'s row state: first token, start position, live."""
    tok[s] = tok0
    pos[s] = pos0
    done[s] = False


def _place_dense(caches, ring, s: int) -> None:
    """Install an admitted request's ring rows into slot ``s`` of the
    batched cache, in place."""
    for c, r in zip(caches, ring):
        for kk in c:
            c[kk][s] = r[kk][0].to(c[kk].dtype)


# --------------------------------------------------------------------------
# the scheduler
# --------------------------------------------------------------------------


class Request:
    """One generation request: ``prompt`` (1D int tokens) in,
    ``tokens`` (the generated ids, EOS kept if emitted) out.
    ``finished`` flips at retirement; ``reason`` is ``"eos"``,
    ``"length"`` or ``"cancelled"``."""

    _next_id = 0

    def __init__(self, prompt, max_new: int):
        self.id = Request._next_id
        Request._next_id += 1
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
        # incremental EOS scan: index of the first EOS if found, and
        # how many tokens were already scanned
        self._eos_at: int | None = None
        self._scanned = 0


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


def _later(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is ROADMAP.md Queue 1 item {item}, not yet ported"
    )


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

    Arguments of later slices raise ``NotImplementedError`` naming
    their ``ROADMAP.md`` item: ``qos``,
    ``registry``/``spans``/``flight``/``exporter``/``trace``, ``cache``,
    ``temperature > 0``.
    """

    def __init__(self, params, cfg: TransformerConfig, *, slots: int = 8,
                 n_inner: int = 8, eos_id: int | None = None,
                 prompt_chunk: int = 256, max_prompt: int = 2048,
                 quantize_kv: bool = False, temperature: float = 0.0,
                 page_tokens: int | None = None,
                 cache_pages: int | None = None, qos=None,
                 registry=None, spans=None,
                 flight=None, exporter=None, trace=None, cache=None,
                 device=None):
        if qos is not None:
            raise _later("multi-tenant QoS (qos=)", 10)
        if cache is not None:
            raise _later("the fleet prefix cache (cache=)", 10)
        if any(a is not None for a in (registry, spans, flight, exporter,
                                       trace)):
            raise _later("serving observability (registry=, spans=, "
                         "flight=, exporter=, trace=)", 9)
        _check_sampling(temperature)
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
        self._queue: deque[Request] = deque()
        self._slot_req: list[Request | None] = [None] * self.S
        self._admitting: dict[int, _Admitting] = {}
        self.tick_count = 0
        self.decode_ticks = 0
        self.prefill_chunks = 0
        dev = self.device
        self._tok = torch.zeros((self.S,), dtype=torch.int32, device=dev)
        self._pos = torch.zeros((self.S,), dtype=torch.int32, device=dev)
        self._done = torch.ones((self.S,), dtype=torch.bool, device=dev)
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

    # -- public API -----------------------------------------------------

    def submit(self, prompt, max_new: int) -> Request:
        """Queue a request; returns the live :class:`Request` whose
        ``tokens``/``finished`` the caller watches. Admission happens
        inside subsequent ticks."""
        req = Request(prompt, max_new)
        if req.prompt.size > self.Lmax:
            raise ValueError(
                f"prompt of {req.prompt.size} tokens exceeds max_prompt "
                f"{self.Lmax}; raise max_prompt"
            )
        self._queue.append(req)
        return req

    @property
    def active(self) -> int:
        """Slots currently decoding or admitting."""
        return sum(r is not None for r in self._slot_req)

    @property
    def pending(self) -> int:
        return len(self._queue)

    def step(self) -> list[Request]:
        """One scheduler tick; returns the requests retired in it
        (including any that retire at admission)."""
        self.tick_count += 1
        retired: list[Request] = []
        with torch.no_grad():
            for s in list(self._admitting):
                self._advance_admission(s, retired)
            self._admit_from_queue(retired)
            decoding = [
                s for s, r in enumerate(self._slot_req)
                if r is not None and s not in self._admitting
            ]
            if not decoding:
                return retired
            if self.paged:
                # every page the next n_inner writes touch must be the
                # row's own before the tick runs
                self._prepare_tick_pages(decoding)
                (self._tok, self._pos, self._done, self._caches,
                 toks) = _serving_scan_paged(
                    self.params, self._tok, self._pos, self._done,
                    self._caches, self._device_pt(), self.cfg,
                    self.eos_id, self.n_inner, self.P, self.use_kernel,
                )
                for s in decoding:
                    self._host_pos[s] += self.n_inner
            else:
                (self._tok, self._pos, self._done, self._caches,
                 toks) = _scan_body(
                    self.params, self._tok, self._pos, self._done,
                    self._caches, self.cfg, self.eos_id, self.n_inner,
                    use_kernel=self.use_kernel,
                )
            self.decode_ticks += 1
            host = toks.cpu().numpy()  # the tick's one host fetch
        for s in decoding:
            req = self._slot_req[s]
            req.tokens.extend(int(t) for t in host[s])
            if self._retire_if_due(req):
                self._free_slot(s)
                retired.append(req)
        return retired

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
        if req in self._queue:
            self._queue.remove(req)
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
                self._free_slot(s)
                self._retire_cancelled(req)
                return True
        return False

    def _retire_cancelled(self, req: Request) -> None:
        req.finished = True
        req.reason = "cancelled"
        req.retired_tick = self.tick_count

    def _device_pt(self):
        """The device page table, refreshed from the host copy when
        admission, COW or retirement changed it."""
        if self._pt_dev is None:
            self._pt_dev = torch.tensor(self._pt_host, device=self.device)
        return self._pt_dev

    # -- admission ------------------------------------------------------

    def _admit_from_queue(self, retired: list[Request]) -> None:
        free = [s for s, r in enumerate(self._slot_req) if r is None]
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
        # the first chunk runs this very tick
        self._advance_admission(s, retired)

    def _advance_admission(self, s: int, retired: list[Request]) -> None:
        st = self._admitting[s]
        i = st.next_chunk
        chunk = st.padded[:, i * self.C:(i + 1) * self.C]
        st.last_logits, st.cache = _extend_chunk_dense(
            self.params, chunk, st.cache, st.base + i * self.C, self.cfg
        )
        st.next_chunk += 1
        self.prefill_chunks += 1
        if st.next_chunk < st.n_chunks:
            return
        Tp = st.req.prompt.size
        tok0, ring = _finish_admit_dense(
            st.cache, st.last_logits, Tp,
            st.base + (st.n_chunks - 1) * self.C, self.W,
        )
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
        _start_row(self._tok, self._pos, self._done, s, tok0, Tp)
        st.req.tokens.append(int(tok0))
        del self._admitting[s]
        if self._retire_if_due(st.req):  # max_new == 1 or prompt EOS
            self._free_slot(s)
            retired.append(st.req)

    # -- paged admission planning ---------------------------------------

    def _plan_pages(self, req: Request):
        """Page budget of ``req``: the resident prefix pages it can
        share, its digests, the pages its whole lifetime can touch
        (ring slots ``[0, min(W, Tp + max_new + n_inner))``) and
        whether it wraps. None when the pool cannot cover the fresh
        pages plus one COW reservation per share that can end in a
        write; the request then stays queued."""
        Tp = req.prompt.size
        W, P = self.W, self.P
        digests: list[bytes] = []
        shared: list[int] = []
        if Tp <= W:
            # within the window ring slot s holds position s, so the
            # page-aligned prefix determines the pages: shareable. At
            # least the last prompt token prefills (its logits give
            # the first token).
            digests = prefix_page_digests(req.prompt, P, self.max_pages)
            for d in digests[:(Tp - 1) // P]:
                pid = self.pool.lookup(d)
                if pid is None:
                    break
                shared.append(pid)
        horizon = Tp + req.max_new + self.n_inner
        wraps = horizon > W
        n_pages = -(-min(W, horizon) // P)
        reserve = sum(self.pool.share_needs_reserve(pid, wraps)
                      for pid in shared)
        if not self.pool.can_alloc(n_pages - len(shared), reserve=reserve):
            return None
        return shared, digests, n_pages, wraps

    def _commit_pages(self, req: Request, plan) -> tuple[int, dict]:
        """Execute a plan: share the prefix pages (attaching their COW
        reservations) and allocate the rest. Returns (base,
        :class:`_Admitting` keywords)."""
        shared, digests, n_pages, wraps = plan
        pids = [NULL_PAGE] * self.max_pages
        for j, pid in enumerate(shared):
            self.pool.share(
                pid, reserve=self.pool.share_needs_reserve(pid, wraps),
                wrapper=wraps,
            )
            pids[j] = pid
        for j in range(len(shared), n_pages):
            pids[j] = self.pool.alloc()
        Tp = req.prompt.size
        n_cover = min(Tp // self.P, self.max_pages) if Tp <= self.W else 0
        return len(shared) * self.P, {
            "pids": pids, "n_pages": n_pages, "digests": tuple(digests),
            "n_cover": n_cover, "wraps": wraps,
        }

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
        return True

    def _free_slot(self, s: int) -> None:
        self._slot_req[s] = None
        # the row keeps decoding garbage until reused; done=True makes
        # it emit EOS-clamped tokens nobody reads
        self._done[s] = True
        if self.paged:
            # drop the slot's page references (a shared page frees only
            # with its last holder) and null the row, so its writes land
            # in the null page
            for pid in self._pt_host[s]:
                if pid != NULL_PAGE:
                    self.pool.decref(int(pid),
                                     wrapper=self._slot_wraps[s])
            self._pt_host[s] = NULL_PAGE
            self._pt_dev = None
            self._host_pos[s] = 0
            self._slot_wraps[s] = False
