"""Continuous batching: the multi-request serving scheduler over the
slot-ring cache.

Counterpart of ``mpistragglers_jl_tpu/models/serving.py``, dense
slot-ring mode. The scheduler owns ``S`` slots; per layer one batched
O(W) ring cache ``(S, W, kv_heads, head_dim)`` (int8 plus f32 scales
with ``quantize_kv``) holds every slot. Each slot decodes at its own
global position: RoPE, ring writes and the ``kpos >= 0`` mask are per
row, so a reused slot's stale rows self-mask until overwritten.

Each ``step()`` tick advances every admitting request by one C-token
prefill chunk (into a transient positional cache, attending the
already-quantized cache), installs finished admissions into their
slot, runs ``n_inner`` decode steps for all slots, and fetches the
``(S, n_inner)`` token block to the host ONCE. Rows that emit
``eos_id`` keep emitting it; the host strips the tail and retires the
request. Greedy streams equal ``generate_ring_dense`` token for token.

Cache writes are IN PLACE (``index_put_`` for the per-row ring writes,
slice assignment for prefill chunks and slot installs): the device
arena is allocated once and never copied per tick.

One fault of the reference is not copied: it allocates the transient
prefill arena at ``max_prompt`` while padding the prompt to whole
chunks, so a last chunk that overruns the arena has its write start
clamped by ``dynamic_update_slice`` and the prompt's K/V land in the
wrong slots (``ROADMAP.md`` Queue 3). Here the arena holds
``ceil(max_prompt / C) * C`` positions, so no chunk overruns it.

The int8 decode attention of the tick runs the CUDA kernel
(``ops/decode_attention.py``) when the reference's gate routes it.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from .._device import resolve_device
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
    _pick_token,
    _ring_from_cache,
    _route_kernel,
    init_cache,
)
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


def _ring_write_rows(cache_l: dict, k, v, slot):
    """Write each row's single-token K/V at its own ring slot, in
    place: k, v (S, 1, Hkv, D), slot (S,) device indices."""
    rows = torch.arange(k.shape[0], device=k.device)

    def put(c, u):
        c.index_put_((rows, slot), u.to(c.dtype))

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
        from ..ops.decode_attention import quantized_decode_attention

        return quantized_decode_attention(q, cache_l, pos, scale,
                                          ring=True)
    s = _cache_scores(q, cache_l, scale)  # (S, H, 1, W) f32
    slots = torch.arange(W, device=q.device)
    kpos = pos[:, None] - torch.remainder(pos[:, None] - slots[None, :], W)
    s = torch.where((kpos >= 0)[:, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    return _cache_pv(p, cache_l).to(q.dtype)


def _serving_layer(x, lp, cache_l, pos, cfg, *, use_kernel=False):
    """One layer of the per-row serving step (decode.py's
    ``_incremental_layer`` with per-row positions)."""
    h = _ln(x, lp["ln1_s"], lp["ln1_b"])
    q = torch.einsum("bld,dhk->blhk", h, lp["wq"])
    k = torch.einsum("bld,dhk->blhk", h, lp["wk"])
    v = torch.einsum("bld,dhk->blhk", h, lp["wv"])
    q, k = _rope_rows(q, pos), _rope_rows(k, pos)
    scale = cfg.head_dim ** -0.5
    W = cache_l["k"].shape[1]
    cache_l = _ring_write_rows(cache_l, k, v, torch.remainder(pos, W))
    o = _ring_attention_rows(q, cache_l, pos, scale, use_kernel=use_kernel)
    x = x + torch.einsum("blhk,hkd->bld", o, lp["wo"])
    h2 = _ln(x, lp["ln2_s"], lp["ln2_b"])
    return x + _mlp(h2, lp) + lp["b2"], cache_l


def _serving_forward(params, tok, pos, caches, cfg, *, use_kernel=False):
    """(tok (S,), pos (S,), caches) -> (logits (S, V), caches)."""
    x = params["emb"][tok[:, None]]  # (S, 1, d)
    new = []
    for lp, cl in zip(params["layers"], caches):
        x, cl = _serving_layer(x, lp, cl, pos, cfg, use_kernel=use_kernel)
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
               *, use_kernel=False):
    """``n_inner`` greedy decode steps for all S slots, on the device,
    with no host sync. Returns (tok, pos, done, caches, toks (S,
    n_inner))."""
    toks = torch.empty((tok.shape[0], n_inner), dtype=torch.int32,
                       device=tok.device)
    for t in range(n_inner):
        lg, caches = _serving_forward(params, tok, pos, caches, cfg,
                                      use_kernel=use_kernel)
        nxt, done = _eos_clamp(_pick_rows(lg), tok, done, eos_id)
        toks[:, t] = nxt
        tok, pos = nxt, pos + 1
    return tok, pos, done, caches, toks


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


def _place_dense(caches, ring, tok, pos, done, s: int, tok0, pos0: int):
    """Install an admitted request into slot ``s``, in place: ring rows
    into the batched cache, first token and start position into the row
    state."""
    for c, r in zip(caches, ring):
        for kk in c:
            c[kk][s] = r[kk][0].to(c[kk].dtype)
    tok[s] = tok0
    pos[s] = pos0
    done[s] = False


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
    plus the chunk cursor."""

    def __init__(self, req: Request, cache, padded, n_chunks: int):
        self.req = req
        self.cache = cache
        self.padded = padded  # (1, n_chunks * C) device tokens
        self.n_chunks = n_chunks
        self.next_chunk = 0
        self.last_logits = None


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
    loop (each launches ``n_layers * n_inner`` attention calls).

    Arguments of later slices raise ``NotImplementedError`` naming
    their ``ROADMAP.md`` item: ``page_tokens``/``cache_pages``,
    ``qos``, ``registry``/``spans``/``flight``/``exporter``/``trace``,
    ``cache``, ``temperature > 0``.
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
        if page_tokens is not None or cache_pages is not None:
            raise _later("the paged cache (page_tokens=, cache_pages=)", 7)
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
        if slots < 1 or n_inner < 1:
            raise ValueError("slots and n_inner must be >= 1")
        if prompt_chunk > max_prompt:
            raise ValueError("prompt_chunk must be <= max_prompt")
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
        # transient prefill arena: whole chunks, so none overruns it
        self.L_arena = -(-self.Lmax // self.C) * self.C
        self.quantize_kv = bool(quantize_kv)
        self._queue: deque[Request] = deque()
        self._slot_req: list[Request | None] = [None] * self.S
        self._admitting: dict[int, _Admitting] = {}
        self.tick_count = 0
        self.decode_ticks = 0
        dev = self.device
        self._tok = torch.zeros((self.S,), dtype=torch.int32, device=dev)
        self._pos = torch.zeros((self.S,), dtype=torch.int32, device=dev)
        self._done = torch.ones((self.S,), dtype=torch.bool, device=dev)
        self._caches = init_cache(cfg, self.S, W,
                                  quantize_kv=self.quantize_kv, device=dev)
        # int8 kernel routing, resolved once against this slot count
        # (the reference's AUTO gate: the tick batches all S slots into
        # one kernel call per layer)
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
        decoding), freeing its slot. True when it was live here and is
        now retired with ``reason == "cancelled"``."""
        if req.finished:
            return False
        if req in self._queue:
            self._queue.remove(req)
            self._retire_cancelled(req)
            return True
        for s, r in enumerate(self._slot_req):
            if r is req:
                self._admitting.pop(s, None)
                self._free_slot(s)
                self._retire_cancelled(req)
                return True
        return False

    def _retire_cancelled(self, req: Request) -> None:
        req.finished = True
        req.reason = "cancelled"
        req.retired_tick = self.tick_count

    # -- admission ------------------------------------------------------

    def _admit_from_queue(self, retired: list[Request]) -> None:
        free = [s for s, r in enumerate(self._slot_req) if r is None]
        while self._queue and free:
            self._admit_into(free.pop(0), self._queue.popleft(), retired)

    def _admit_into(self, s: int, req: Request,
                    retired: list[Request]) -> None:
        Tp = req.prompt.size
        n_chunks = -(-Tp // self.C)
        padded = np.zeros((1, n_chunks * self.C), np.int32)
        padded[0, :Tp] = req.prompt
        cache = init_cache(self.cfg, 1, self.L_arena,
                           quantize_kv=self.quantize_kv, device=self.device)
        self._slot_req[s] = req
        self._admitting[s] = _Admitting(
            req, cache, torch.as_tensor(padded, device=self.device),
            n_chunks,
        )
        req.admitted_tick = self.tick_count
        # the first chunk runs this very tick
        self._advance_admission(s, retired)

    def _advance_admission(self, s: int, retired: list[Request]) -> None:
        st = self._admitting[s]
        i = st.next_chunk
        chunk = st.padded[:, i * self.C:(i + 1) * self.C]
        st.last_logits, st.cache = _extend_chunk_dense(
            self.params, chunk, st.cache, i * self.C, self.cfg
        )
        st.next_chunk += 1
        if st.next_chunk < st.n_chunks:
            return
        Tp = st.req.prompt.size
        tok0, ring = _finish_admit_dense(
            st.cache, st.last_logits, Tp, (st.n_chunks - 1) * self.C,
            self.W,
        )
        _place_dense(self._caches, ring, self._tok, self._pos, self._done,
                     s, tok0, Tp)
        st.req.tokens.append(int(tok0))
        del self._admitting[s]
        if self._retire_if_due(st.req):  # max_new == 1 or prompt EOS
            self._free_slot(s)
            retired.append(st.req)

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
