"""Speculative decoding: draft ``k`` tokens, verify them in one
``k + 1``-token forward, keep the longest prefix the model agrees with.

Counterpart of ``mpistragglers_jl_tpu/models/speculative.py`` (the
dense program; the mesh-sharded ``make_speculative`` waits for the
multi-device slice, ``ROADMAP.md`` Queue 1 item 18). The output is
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
"""

from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from .decode import _incremental_forward, init_cache, prefill_dense
from .transformer import TransformerConfig

__all__ = ["generate_speculative_dense", "make_speculative_dense"]


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


def _make_model_draft(params_d, cfg_d: TransformerConfig, k: int):
    """Truncated-layer draft model: ``(draft_init, draft_step)`` over a
    draft cache. ``draft_init(prompt, cache_d)`` prefills it;
    ``draft_step(buf, cursor, cache_d) -> (draft (k,), cache_d)``
    teacher-forces the trailing ``k + 1`` window (rewrites are
    idempotent, so stale positions of a rejected tail are covered) and
    drafts ``k`` tokens greedily."""

    def draft_init(prompt, cache_d):
        _, cache_d = _incremental_forward(params_d, prompt, cache_d, 0,
                                          cfg_d, prefill=True)
        return cache_d

    def draft_step(buf, cursor: int, cache_d):
        off = max(cursor - 1 - k, 0)
        lg, cache_d = _incremental_forward(
            params_d, buf[off:off + k + 1][None], cache_d, off, cfg_d,
            prefill=False,
        )
        # the logits at local index cursor-1-off predict position cursor
        tok = torch.argmax(lg[0, cursor - 1 - off])
        toks = []
        for i in range(k - 1):
            lg1, cache_d = _incremental_forward(
                params_d, tok.reshape(1, 1), cache_d, cursor + i, cfg_d,
                prefill=False,
            )
            toks.append(tok)
            tok = torch.argmax(lg1[0, 0])
        toks.append(tok)
        return torch.stack(toks).to(buf.dtype), cache_d

    return draft_init, draft_step


def _spec_loop(params, cfg: TransformerConfig, cache, prompt, n_new: int,
               k: int, draft=None, dstate=None):
    """THE draft/verify loop, shared by both drafters: exact prefill
    through :func:`~.decode.prefill_dense`, then one ``k + 1``-token
    verify forward per iteration. ``draft(buf, cursor, dstate) ->
    (draft (k,), dstate)``, the n-gram lookup by default. Returns
    (tokens (n_new,), verify forwards)."""
    if draft is None:
        def draft(buf, cursor, dstate):
            return _bigram_draft(buf, cursor, k), dstate

    dev, Tp = prompt.device, prompt.shape[1]
    Lbuf = Tp + n_new + k + 1  # slack: the last verify may overrun
    logits, cache = prefill_dense(params, prompt, cache, cfg)
    buf = torch.zeros((Lbuf,), dtype=prompt.dtype, device=dev)
    buf[:Tp] = prompt[0]
    buf[Tp] = torch.argmax(logits[0, -1])
    del logits
    lanes = torch.arange(k + 1, device=dev)
    cursor, iters = Tp + 1, 0
    while cursor < Tp + n_new:
        dr, dstate = draft(buf, cursor, dstate)  # (k,)
        # positions cursor-1 .. cursor+k-1
        chunk = torch.cat([buf[cursor - 1:cursor], dr])[None]
        lg, cache = _incremental_forward(params, chunk, cache, cursor - 1,
                                         cfg, prefill=False)
        # greedy[i]: the model's token for position cursor+i given the
        # exact prefix; drafts are accepted while they match it
        greedy = torch.argmax(lg[0], dim=-1).to(buf.dtype)
        m = torch.cumprod((greedy[:k] == dr).to(torch.int32), 0).sum()
        # emit[i < m] = draft[i] (== greedy[i]); emit[m] = greedy[m], the
        # correction; later entries are overwritten before any read
        emit = torch.where(lanes < m, torch.cat([dr, dr[-1:]]), greedy)
        buf[cursor:cursor + k + 1] = emit
        cursor += int(m) + 1  # the one host fetch of the iteration
        iters += 1
    return buf[Tp:Tp + n_new], iters


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
                    _truncated(params, d), cfg_d, k)
                dstate = draft_init(prompt, init_cache(cfg_d, 1, Lbuf,
                                                       device=dev))
            toks, iters = _spec_loop(params, cfg, cache, prompt, n_new, k,
                                     draft=draft, dstate=dstate)
        return toks[None], iters

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
