"""Speculative decoding: draft ``k`` tokens, verify them in one
``k + 1``-token forward, keep the longest prefix the model agrees with.

Counterpart of ``mpistragglers_jl_tpu/models/speculative.py``: the
dense program, and ``make_speculative`` over a ``(dp=1, tp)`` mesh,
where every rank runs the per-rank forward of ``models/decode.py`` and
keeps its own token buffer. The output is
exactly :func:`~.decode.generate_dense`'s greedy stream: a draft token
is accepted only when it equals the model's argmax at that position
teacher-forced on the accepted prefix, and the first rejected position
emits that argmax instead. Every iteration emits 1 to ``k + 1``
tokens.

The verify forward at cursor ``c`` writes positions ``[c - 1, c + k -
1]`` before attending, and the next verify starts at most at ``c + k +
1``, so its writes cover every position a rejected tail left stale
before anything reads it. Two drafters share the loop:

* n-gram lookup (default): the continuation of the most recent earlier
  occurrence of the last bigram, else the last token repeated;
* ``draft_layers=d``: the first ``d`` layers of the same checkpoint
  with the shared head, with a KV cache of their own; each iteration
  teacher-forces the trailing ``k + 1`` window through them, then
  drafts ``k`` tokens one at a time.

The reference's ``lax.while_loop`` is a Python ``while`` here: the
token buffer and caches stay on the device, and each iteration fetches
one number, the count of accepted drafts, which moves the host cursor.
Over a mesh every tp member computes the same post-psum logits, hence
the same drafts and acceptance, so the count is fetched from flat rank
0 alone and every rank's buffer ends bit-equal. Over a mesh that spans
processes the process that drives flat rank 0 broadcasts that count
(one int64 over the job's group) each iteration, and every process
moves its cursor by it: no process reads a count of its own ranks in
its place.
"""

from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from ..parallel.mesh import PartitionSpec as P, from_local
from .decode import (
    _cache_heads_global,
    _check_decode_mesh,
    _incremental_forward,
    _incremental_forward_local,
    _rank_blocks,
    _rank_params,
    _zero_cache_layer,
    init_cache,
)
from .transformer import TransformerConfig

__all__ = ["generate_speculative_dense", "make_speculative",
           "make_speculative_dense"]


def _bigram_draft(buf, cursor: int, k: int):
    """(Lbuf,) token buffer, known through ``cursor`` -> (k,) draft:
    the ``k`` tokens after the most recent earlier occurrence of the
    bigram ``(buf[cursor-2], buf[cursor-1])``, else ``buf[cursor-1]``
    repeated. Device ops only (no host fetch)."""
    idx = torch.arange(buf.shape[0], device=buf.device)
    match = ((buf == buf[cursor - 2]) & (torch.roll(buf, -1) == buf[cursor - 1])
             & (idx < cursor - 2))
    p = torch.where(match, idx, -1).max()
    has = p >= 0
    # start + k <= cursor - 1 + k < Lbuf: the slice never runs off
    start = torch.where(has, p + 2, cursor - 1)
    dr = buf[start + torch.arange(k, device=buf.device)]
    return torch.where(has, dr, buf[cursor - 1])


def _make_model_draft(fwd, k: int):
    """Truncated-layer draft model over any per-rank forward ``fwd(tokens,
    cache, offset, prefill) -> (logits, cache)`` (tokens and logits one
    per rank: one device's, or every rank's of a mesh):
    ``(draft_init, draft_step)``. ``draft_init(prompts, cache_d)``
    prefills the draft cache; ``draft_step(bufs, cursor, cache_d) ->
    (drafts (k,) per rank, cache_d)`` teacher-forces the trailing ``k +
    1`` window (rewrites are idempotent, so stale positions of a
    rejected tail are covered) and drafts ``k`` tokens greedily."""

    def draft_init(prompts, cache_d):
        _, cache_d = fwd(prompts, cache_d, 0, True)
        return cache_d

    def draft_step(bufs, cursor: int, cache_d):
        off = max(cursor - 1 - k, 0)
        lg, cache_d = fwd([b[off:off + k + 1][None] for b in bufs], cache_d,
                          off, False)
        # the logits at local index cursor-1-off predict position cursor
        tok = [torch.argmax(x[0, cursor - 1 - off]) for x in lg]
        toks = [[] for _ in bufs]
        for i in range(k - 1):
            lg1, cache_d = fwd([t.reshape(1, 1) for t in tok], cache_d,
                               cursor + i, False)
            for ts, t in zip(toks, tok):
                ts.append(t)
            tok = [torch.argmax(x[0, 0]) for x in lg1]
        return [torch.stack(ts + [t]).to(b.dtype)
                for ts, t, b in zip(toks, tok, bufs)], cache_d

    return draft_init, draft_step


def _rank0_count(mesh):
    """The count of accepted drafts that moves the cursor: flat rank 0's
    (the first of ``ms``) on a mesh one process drives; over a mesh that
    spans processes, broadcast each call from the process that drives
    flat rank 0, through the host under ``gloo`` and on the card under
    ``nccl``."""
    if not mesh.spans_processes:
        return lambda ms: int(ms[0])
    import torch.distributed as dist

    src = int(mesh.process_index.flat[0])
    mine = src == int(dist.get_rank())
    dev = (mesh.local_devices()[0] if mesh.backend == "nccl"
           else torch.device("cpu"))

    def count(ms):
        t = (ms[0].to(dev, torch.int64).reshape(1) if mine
             else torch.empty(1, dtype=torch.int64, device=dev))
        dist.broadcast(t, src=src)
        return int(t.item())

    return count


def _spec_loop(prefill, step, cache, prompts, n_new: int, k: int,
               draft=None, dstate=None, count=None):
    """THE draft/verify loop, shared by both drafters and by the dense
    and mesh programs (the exact-greedy acceptance lives here once):
    ``prefill(prompts, cache) -> (logits, cache)``, then one ``k +
    1``-token verify forward ``step(chunks, cache, offset) -> (logits,
    cache)`` per iteration. Prompts, chunks and logits hold one tensor
    per rank (one, on one device), and every rank keeps its own token
    buffer. ``draft(bufs, cursor, dstate) -> (drafts (k,) per rank,
    dstate)``, the n-gram lookup by default. The cursor moves by
    ``count(ms)``, flat rank 0's accepted count (``ms[0]`` by default;
    :func:`_rank0_count` across processes), the iteration's one host
    fetch: over a mesh every rank sees the same post-psum logits, so the
    counts agree. Returns (each rank's tokens (n_new,), verify
    forwards)."""
    if count is None:
        def count(ms):
            return int(ms[0])
    if draft is None:
        def draft(bufs, cursor, dstate):
            return [_bigram_draft(b, cursor, k) for b in bufs], dstate

    Tp = prompts[0].shape[1]
    Lbuf = Tp + n_new + k + 1  # slack: the last verify may overrun
    logits, cache = prefill(prompts, cache)
    bufs = []
    for p, lg in zip(prompts, logits):
        buf = torch.zeros((Lbuf,), dtype=p.dtype, device=p.device)
        buf[:Tp] = p[0]
        buf[Tp] = torch.argmax(lg[0, -1])
        bufs.append(buf)
    del logits
    lanes = [torch.arange(k + 1, device=b.device) for b in bufs]
    cursor, iters = Tp + 1, 0
    while cursor < Tp + n_new:
        drs, dstate = draft(bufs, cursor, dstate)  # (k,) per rank
        # positions cursor-1 .. cursor+k-1
        chunks = [torch.cat([b[cursor - 1:cursor], dr])[None]
                  for b, dr in zip(bufs, drs)]
        lg, cache = step(chunks, cache, cursor - 1)
        ms = []
        for buf, dr, x, ln in zip(bufs, drs, lg, lanes):
            # greedy[i]: the model's token for position cursor+i given
            # the exact prefix; drafts are accepted while they match it
            greedy = torch.argmax(x[0], dim=-1).to(buf.dtype)
            m = torch.cumprod((greedy[:k] == dr).to(torch.int32), 0).sum()
            # emit[i < m] = draft[i] (== greedy[i]); emit[m] = greedy[m],
            # the correction; later entries are overwritten before any read
            buf[cursor:cursor + k + 1] = torch.where(
                ln < m, torch.cat([dr, dr[-1:]]), greedy)
            ms.append(m)
        cursor += count(ms) + 1  # the one host fetch of the iteration
        iters += 1
    return [b[Tp:Tp + n_new] for b in bufs], iters


def _truncated(params, d: int):
    """Draft params: the first ``d`` layers and the shared embedding and
    final norm of the same checkpoint (no extra weights)."""
    return {**params, "layers": params["layers"][:d]}


def _check_draft_layers(cfg: TransformerConfig, draft_layers):
    if draft_layers is None:
        return None
    d = int(draft_layers)
    if not 0 < d < cfg.n_layers:
        raise ValueError(
            f"draft_layers must be in [1, {cfg.n_layers - 1}] "
            f"(a strict truncation of the model), got {draft_layers}"
        )
    return d


def _dense_fwd(params, cfg: TransformerConfig):
    """:func:`_spec_loop`'s forward on one device: one rank's tokens in,
    one rank's logits out, the cache written in place."""

    def fwd(toks, cache, off: int, prefill: bool):
        lg, cache = _incremental_forward(params, toks[0], cache, off, cfg,
                                         prefill=prefill)
        return [lg], cache

    return fwd


def make_speculative_dense(cfg: TransformerConfig, Tp: int, n_new: int,
                           k: int = 4, *, draft_layers: int | None = None,
                           device=None):
    """The generator for one prompt length: ``run(params, prompt (1,
    Tp)) -> (tokens (1, n_new) int64, verify forwards)``.
    ``draft_layers=d`` swaps the n-gram drafter for the truncated-layer
    model draft. Most callers want :func:`generate_speculative_dense`.
    ``device`` defaults to ``cuda``; ``params`` must live there."""
    Tp, n_new, k = int(Tp), int(n_new), int(k)
    d = _check_draft_layers(cfg, draft_layers)
    dev = resolve_device(device)
    Lbuf = Tp + n_new + k + 1

    def run(params, prompt):
        prompt = torch.as_tensor(prompt, device=dev).to(torch.int64)
        if prompt.shape[1] != Tp:
            raise ValueError(
                f"made for Tp={Tp}, got a prompt of {prompt.shape[1]} "
                "tokens: its caches and token buffer are sized for Tp"
            )
        with torch.no_grad():
            cache = init_cache(cfg, 1, Lbuf, device=dev)
            draft, dstate = None, None
            if d is not None:
                cfg_d = dataclasses.replace(cfg, n_layers=d)
                draft_init, draft = _make_model_draft(
                    _dense_fwd(_truncated(params, d), cfg_d), k)
                dstate = draft_init([prompt], init_cache(cfg_d, 1, Lbuf,
                                                         device=dev))
            fwd = _dense_fwd(params, cfg)
            toks, iters = _spec_loop(
                lambda pr, c: fwd(pr, c, 0, True),
                lambda ch, c, off: fwd(ch, c, off, False),
                cache, [prompt], n_new, k, draft=draft, dstate=dstate)
        return toks[0][None], iters

    return run


def generate_speculative_dense(params, prompt, n_new: int,
                               cfg: TransformerConfig, *, k: int = 4,
                               draft_layers: int | None = None, device=None):
    """Greedy generation by draft-k / verify-in-one-forward speculation.

    ``prompt``: (1, Tp) int tokens, Tp >= 2 (the bigram draft needs
    one). Returns ``(tokens (1, n_new) int64, n_forwards)``: the stream
    is exactly :func:`~.decode.generate_dense`'s greedy stream;
    ``n_forwards`` counts the verify forwards after the prefill, so
    speculation made ``(n_new - 1) / n_forwards`` tokens per decode
    forward. Greedy only. ``device`` defaults to ``cuda``."""
    B, Tp = tuple(torch.as_tensor(prompt).shape)
    if B != 1:
        raise ValueError(
            f"speculative decode is per-stream (B=1), got batch {B}; "
            "run one stream per call"
        )
    if Tp < 2:
        raise ValueError(f"bigram drafting needs a prompt >= 2, got {Tp}")
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")
    if k < 1:
        raise ValueError(f"draft length k must be >= 1, got {k}")
    return make_speculative_dense(cfg, Tp, n_new, k,
                                  draft_layers=draft_layers,
                                  device=device)(params, prompt)


def make_speculative(cfg: TransformerConfig, mesh, Tp: int, n_new: int, *,
                     k: int = 4, draft_layers: int | None = None):
    """Speculative generation over a ``(dp=1, tp)`` mesh: ``run(params,
    prompt (1, Tp)) -> (tokens (1, n_new), verify forwards)``, the
    stream and count of :func:`generate_speculative_dense`. ``params``
    is :func:`~.transformer.shard_params`' tree; the prompt goes to
    every rank. Every rank runs the per-rank forward (the prefill chunk
    through ``cfg.attn_impl``, K1 per rank per layer under flash) into
    its own cache and keeps its own token buffer: ``tokens`` is a
    :class:`~..parallel.mesh.ShardedTensor` laid out ``P()``, each
    rank's copy its own buffer's tokens. ``draft_layers=d``: the
    truncated-layer drafter, sharded as the verify stack.

    Per-stream (B=1; shard streams over dp by running one program per
    stream, so ``dp > 1`` is refused), dense configs only (the
    reference refuses MoE: its expert all-to-all makes the loop's
    carries vary over ep). Over a mesh that spans processes every
    process moves its cursor by flat rank 0's count, broadcast from the
    process that drives it (:func:`_rank0_count`), so the stream and the
    verify count are the single-controller program's."""
    _check_decode_mesh(cfg, mesh)
    if cfg.n_experts:
        raise ValueError(
            "sharded speculative decoding supports dense configs only "
            "(MoE expert-parallel carries cannot replicate across the "
            "speculation loop); serve MoE with make_generate"
        )
    if int(mesh.shape["dp"]) != 1:
        raise ValueError(
            "speculative decode is per-stream: use dp=1 (run one "
            "program per stream for batch serving)"
        )
    if Tp < 2 or n_new < 1 or k < 1:
        raise ValueError(f"need Tp >= 2, n_new >= 1, k >= 1; got "
                         f"{(Tp, n_new, k)}")
    Tp, n_new, k = int(Tp), int(n_new), int(k)
    d = _check_draft_layers(cfg, draft_layers)
    Lbuf = Tp + n_new + k + 1
    heads = _cache_heads_global(cfg, mesh) // mesh.shape["tp"]

    def caches(c, devices):
        return [[_zero_cache_layer(1, Lbuf, heads, c.head_dim, c.dtype,
                                   False, dev) for _ in range(c.n_layers)]
                for dev in devices]

    def forward(lparams, c):
        def fwd(toks, cache, off: int, prefill: bool):
            return _incremental_forward_local(lparams, toks, cache, off, c,
                                              mesh, prefill=prefill)

        return fwd

    def run(params, prompt):
        lparams = _rank_params(params, cfg, mesh)
        prompts, shape = _rank_blocks(prompt, mesh, P())
        if tuple(shape) != (1, Tp):
            raise ValueError(
                f"made for a (1, Tp={Tp}) prompt, got {tuple(shape)}: its "
                "caches and token buffer are sized for Tp")
        prompts = [p.long() for p in prompts]
        devices = [p.device for p in prompts]
        with torch.no_grad():
            draft, dstate = None, None
            if d is not None:
                # the draft stack shards as the verify stack (same tp
                # psum, same kv slicing), so its argmax replicates too
                cfg_d = dataclasses.replace(cfg, n_layers=d)
                draft_init, draft = _make_model_draft(
                    forward([_truncated(lp, d) for lp in lparams], cfg_d), k)
                dstate = draft_init(prompts, caches(cfg_d, devices))
            fwd = forward(lparams, cfg)
            toks, iters = _spec_loop(
                lambda pr, c: fwd(pr, c, 0, True),
                lambda ch, c, off: fwd(ch, c, off, False),
                caches(cfg, devices), prompts, n_new, k, draft=draft,
                dstate=dstate, count=_rank0_count(mesh))
        return from_local(mesh, P(), [t[None] for t in toks],
                          (1, n_new)), iters

    return run
