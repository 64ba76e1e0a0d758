"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's two serving paths (the int8 continuous-batching
server ``mpistragglers_jl_tpu_torch.models.serving.ServingScheduler``
on the slot ring and on the paged cache) at the full width of the
widest model the repo serves, and holds every CUDA kernel of those
paths against its plain PyTorch version:

1. card name and power limit;
2. build the kernels from the source in this checkout;
3. K5 against its plain version at the serving shape, bf16 and f32,
   ring and positional (with and without window) masks, GQA groups
   1, 4 and 8;
4. slot-ring serving parity in f32 at full width: ~10 requests through
   the scheduler on the kernel route, then on the einsum route
   (``use_decode_kernel(False)``); greedy streams must be identical,
   equal the ``generate_ring_dense`` oracle, and K5 must launch
   ``n_layers * n_inner * decode ticks`` times on the first run and
   never on the second;
5. slot-ring main path: serving in bf16, S=8 slots of 512-token
   prompts, ``n_inner=64``; every launch count is set to 0 just before
   and read just after; decode tokens/s, ms/step and peak memory;
6. K5 timing at the serving shape (CUDA events, caches rotated past
   the 50 MB L2) beside its byte bound, the plain version and one
   ``F.scaled_dot_product_attention`` call over the dequantised cache
   (a yardstick only: the port never calls it);
7. K6 (the paged kernel) against its plain version: B=8, pages of 16,
   64 and 24 rows, GQA groups 1, 4 and 8, bf16 and f32, page tables
   from a seeded permutation with shared pages and null entries past
   the budget of rows in warm-up, positions in warm-up, at W - 1, at W
   and wrapped;
8. paged serving parity in f32 at full width, kernel route against the
   gather route: ~10 requests, two of them sharing a 256-token prefix
   and wrapping past it (copy-on-write); identical streams, those two
   equal to the oracle, K6 launches counted, K5 none, the pool drained;
9. paged main path: bf16, S=8, pages of 64, 8 requests on one
   256-token system prompt; share hits, prefill chunks, decode
   tokens/s, ms/step, peak memory, launches (all counts set to 0 just
   before);
10. K6 timing at the serving shape, as phase 6.

Prints a ``{"kernels": [...]}`` JSON line and, last,
``{"ok": true, "device": {...}}``. Exits nonzero, printing no result,
without a CUDA device or when any phase fails.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from mpistragglers_jl_tpu_torch.bench.serving_profile import MODEL
from mpistragglers_jl_tpu_torch.models import decode as td
from mpistragglers_jl_tpu_torch.models.serving import ServingScheduler
from mpistragglers_jl_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)
from mpistragglers_jl_tpu_torch.ops import _build
from mpistragglers_jl_tpu_torch.ops import decode_attention as da

SLOTS = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel against plain version: |got - want| <= atol + rtol * |want|.
# Both sum in f32 (in different orders, hence atol); a bf16 output is
# held against the f32 plain result and may differ by one bf16
# rounding, at most 2**-8 of the value.
TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-5, 2.0 ** -8)}
K5 = "quantized_decode_attention"
K6 = "paged_decode_attention"
PAGE = 64  # the paged main path's page size


class SmokeFailure(RuntimeError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _zero_launches() -> None:
    for name in da.LAUNCHES:
        da.LAUNCHES[name] = 0


def _cache(B, L, Hkv, D, gen, dev):
    kq, ks = td._kv_quantize(torch.randn(B, L, Hkv, D, generator=gen))
    vq, vs = td._kv_quantize(torch.randn(B, L, Hkv, D, generator=gen))
    return {n: t.to(dev) for n, t in
            {"k": kq, "k_s": ks, "v": vq, "v_s": vs}.items()}


def _hold(got, want, dt, label: str) -> float:
    """Hold a kernel output against the f32 plain result; returns the
    max abs error."""
    torch.cuda.synchronize()
    atol, rtol = TOL[dt]
    diff = (got.float() - want).abs()
    err = diff.max().item()
    # share of the limit used by the worst element (<= 1)
    used = (diff / (atol + rtol * want.abs())).max().item()
    ok = bool(torch.isfinite(got).all()) and used <= 1.0
    print(f"  {label} {str(dt):15s} max_abs_err={err:.3e} limit "
          f"atol={atol:.0e} rtol={rtol:.3e} used {used:.3f} "
          f"{'ok' if ok else 'FAIL'}")
    _require(ok, f"kernel disagrees with plain version: {label} {dt} "
                 f"err={err} limit used {used}")
    return err


def phase_kernel_vs_plain(dev) -> float:
    """K5: every mode, both q types, GQA 1/4/8 at B=8, L=W=1024,
    D=128."""
    gen = torch.Generator().manual_seed(0)
    B, L, D, Hq = SLOTS, MODEL["attn_window"], 128, 8
    pos = torch.tensor([0, 7, 31, 32, 1023, 1024, 5000, 2047],
                       dtype=torch.int32, device=dev)
    worst = 0.0
    for Hkv in (8, 2, 1):
        cache = _cache(B, L, Hkv, D, gen, dev)
        q32 = torch.randn(B, 1, Hq, D, generator=gen).to(dev)
        for dt in (torch.bfloat16, torch.float32):
            q = q32.to(dt)
            for kw in ({"ring": True}, {}, {"window": 100}):
                got = da.quantized_decode_attention(q, cache, pos,
                                                    D ** -0.5, **kw)
                # the plain version in f32 on the same (bf16-valued) q
                want = da.quantized_decode_attention_ref(
                    q.float(), cache, pos, D ** -0.5, **kw)
                worst = max(worst, _hold(got, want, dt,
                                         f"g={Hq // Hkv} {str(kw):16s}"))
    return worst


def _paged_case(B, W, P, Hkv, D, gen, dev):
    """A pool of B * W/P + 4 pages (page 0 the null page), a page table
    from a seeded permutation with pages shared by rows 1 and 2 and
    null entries past the budget of the rows in warm-up, and positions
    in warm-up, at W - 1, at W and wrapped."""
    mp = W // P
    n_pages = B * mp + 4
    pool = {k: t[0] for k, t in
            _cache(1, n_pages * P, Hkv, D, gen, dev).items()}
    pt = torch.randperm(n_pages - 1, generator=gen)[:B * mp] + 1
    pt = pt.reshape(B, mp).to(torch.int32)
    pos = torch.tensor([0, 7, 31, 32, W - 1, W, 5000, 3 * W + 1],
                       dtype=torch.int32)[:B]
    pt[2, :3] = pt[1, :3]
    for b in range(B):
        if pos[b] < W:
            pt[b, int(pos[b]) // P + 1:] = 0
    return pool, pt.to(dev), pos.to(dev)


def phase_paged_vs_plain(dev) -> float:
    """K6: pages of 16, 64 and 24 rows, GQA 1/4/8, both q types."""
    gen = torch.Generator().manual_seed(4)
    B, D, Hq = SLOTS, 128, 8
    worst = 0.0
    for P, W in ((16, 1024), (64, 1024), (24, 960)):
        for Hkv in (8, 2, 1):
            pool, pt, pos = _paged_case(B, W, P, Hkv, D, gen, dev)
            q32 = torch.randn(B, 1, Hq, D, generator=gen).to(dev)
            for dt in (torch.bfloat16, torch.float32):
                q = q32.to(dt)
                got = da.quantized_decode_attention(
                    q, pool, pos, D ** -0.5, ring=True, page_table=pt,
                    page_tokens=P)
                want = da.paged_decode_attention_ref(
                    q.float(), pool, pos, D ** -0.5, pt, P)
                worst = max(worst, _hold(got, want, dt,
                                         f"P={P:2d} W={W} g={Hq // Hkv}"))
    return worst


def _prompts(rng, lens, vocab):
    return [rng.integers(0, vocab, n, dtype=np.int64) for n in lens]


def _oracle_equal(params, cfg, prompt, n, stream, dev, what):
    o = td.generate_ring_dense(params, prompt[None], n, cfg,
                               quantize_kv=True, device=dev)
    _require(o.cpu().numpy()[0].tolist() == stream,
             f"{what} differs from the generate_ring_dense oracle")


def phase_serving_parity_f32(dev) -> None:
    cfg = TransformerConfig(**MODEL, dtype=torch.float32)
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(1)
    lens = [512, 300, 77, 450, 128, 5, 260, 511, 64, 333]
    budgets = [16, 32, 24, 16, 32, 20, 16, 28, 32, 18]
    prompts = _prompts(rng, lens, cfg.vocab)
    streams = []
    for toggle in (None, False):
        td.use_decode_kernel(toggle)
        try:
            sched = ServingScheduler(params, cfg, slots=SLOTS, n_inner=8,
                                     prompt_chunk=256, max_prompt=512,
                                     quantize_kv=True, device=dev)
        finally:
            td.use_decode_kernel(None)
        _require(sched.use_kernel == (toggle is None),
                 f"routing: use_kernel={sched.use_kernel} at toggle "
                 f"{toggle}")
        _zero_launches()
        reqs = [sched.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
        sched.run()
        n = da.LAUNCHES[K5]
        want = (cfg.n_layers * sched.n_inner * sched.decode_ticks
                if toggle is None else 0)
        route = "kernel" if toggle is None else "einsum"
        print(f"  {route} route: {sched.decode_ticks} decode ticks, "
              f"{n} kernel launches (want {want})")
        _require(n == want, f"{route} route launched the kernel {n} times, "
                            f"want {want}")
        _require(all(r.finished and len(r.tokens) == b
                     for r, b in zip(reqs, budgets)),
                 f"{route} route: a request did not finish its budget")
        streams.append([r.tokens for r in reqs])
    same = sum(a == b for a, b in zip(*streams))
    print(f"  streams identical on both routes: {same}/{len(prompts)}")
    _require(same == len(prompts), "kernel and einsum routes disagree")
    for i in (2, 5):
        _oracle_equal(params, cfg, prompts[i], budgets[i], streams[0][i],
                      dev, f"request {i}")
    print("  requests 2 and 5 equal the generate_ring_dense oracle")
    del params


def phase_paged_parity_f32(dev) -> None:
    """Ten requests through pages of 64 on both routes. Requests A and
    B are 900 tokens on one 256-token prefix; B is submitted once A
    has its first token, so it shares A's 4 prefix pages, and both
    decode past position 1024, so the first of them to write page 0
    copies it."""
    cfg = TransformerConfig(**MODEL, dtype=torch.float32)
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(5)
    sys_prompt = rng.integers(0, cfg.vocab, 256)
    pa, pb = (np.concatenate([sys_prompt, rng.integers(0, cfg.vocab, 644)])
              for _ in range(2))
    others = _prompts(rng, [77, 450, 128, 5, 260, 511, 64, 333], cfg.vocab)
    budgets = [16, 32, 24, 16, 32, 20, 16, 28]
    n_ab = 160
    streams = []
    for toggle in (None, False):
        td.use_decode_kernel(toggle)
        try:
            sched = ServingScheduler(params, cfg, slots=SLOTS, n_inner=8,
                                     prompt_chunk=256, max_prompt=1024,
                                     quantize_kv=True, page_tokens=PAGE,
                                     device=dev)
        finally:
            td.use_decode_kernel(None)
        route = "kernel" if toggle is None else "gather"
        _require(sched.use_kernel == (toggle is None),
                 f"routing: use_kernel={sched.use_kernel} at toggle "
                 f"{toggle}")
        _zero_launches()
        ra = sched.submit(pa, max_new=n_ab)
        reqs = [sched.submit(p, max_new=n)
                for p, n in zip(others[:6], budgets[:6])]
        while not ra.tokens:
            sched.step()
        rb = sched.submit(pb, max_new=n_ab)
        reqs += [sched.submit(p, max_new=n)
                 for p, n in zip(others[6:], budgets[6:])]
        sched.run()
        n5, n6 = da.LAUNCHES[K5], da.LAUNCHES[K6]
        want = (cfg.n_layers * sched.n_inner * sched.decode_ticks
                if toggle is None else 0)
        pool = sched.pool
        print(f"  {route} route: {sched.decode_ticks} decode ticks, K6 "
              f"{n6} launches (want {want}), K5 {n5}; share hits "
              f"{pool.share_hits}, COW copies {pool.cow_copies}")
        _require(n6 == want and n5 == 0,
                 f"{route} route launched K6 {n6} times (want {want}) "
                 f"and K5 {n5} times (want 0)")
        _require(pool.share_hits == 4 and pool.cow_copies > 0,
                 f"{route} route: {pool.share_hits} share hits (want 4), "
                 f"{pool.cow_copies} COW copies (want > 0)")
        pool.check()
        _require(pool.used == 0 and pool.reserved == 0,
                 f"{route} route: pool not drained: {pool.stats()}")
        _require(all(r.finished and len(r.tokens) == b for r, b in
                     zip([ra, rb] + reqs, [n_ab, n_ab] + budgets)),
                 f"{route} route: a request did not finish its budget")
        streams.append([r.tokens for r in [ra, rb] + reqs])
    same = sum(a == b for a, b in zip(*streams))
    print(f"  streams identical on both routes: {same}/{len(streams[0])}")
    _require(same == len(streams[0]), "kernel and gather routes disagree")
    for name, p, s in (("A", pa, streams[0][0]), ("B", pb, streams[0][1])):
        _oracle_equal(params, cfg, p, n_ab, s, dev, f"request {name}")
    print("  the two sharing requests equal the generate_ring_dense oracle")
    del params


def _serving_report(sched, cfg, n_inner, ticks, dt, t_admit, dev):
    peak = torch.cuda.max_memory_allocated(dev)
    rep = {
        "decode_tokens_per_s": SLOTS * n_inner * ticks / dt,
        "ms_per_step": dt / (n_inner * ticks) * 1e3,
        "admit_tick_s": t_admit,
        "peak_mem_gb": peak / 1e9,
        "decode_ticks": sched.decode_ticks,
    }
    print(f"  aggregate decode {rep['decode_tokens_per_s']:.1f} tokens/s, "
          f"{rep['ms_per_step']:.3f} ms/step (S={SLOTS}), admission tick "
          f"{t_admit:.3f} s, peak memory {rep['peak_mem_gb']:.3f} GB")
    return rep


def _timed_ticks(sched, ticks):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        sched.step()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_serving_bf16(dev):
    """The slot-ring main path: returns (launches, report)."""
    cfg = TransformerConfig(**MODEL, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=dev)
    n_inner, ticks, Tp = 64, 3, 512
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(2)
    _zero_launches()
    sched = ServingScheduler(params, cfg, slots=SLOTS, n_inner=n_inner,
                             prompt_chunk=Tp, max_prompt=Tp,
                             quantize_kv=True, device=dev)
    _require(sched.use_kernel, "the S=8 int8 tick did not route the kernel")
    reqs = [sched.submit(p, max_new=n_inner * (ticks + 2))
            for p in _prompts(rng, [Tp] * SLOTS, cfg.vocab)]
    t0 = time.perf_counter()
    sched.step()  # admits all 8 (one 512-token chunk each) + 1 tick
    torch.cuda.synchronize()
    t_admit = time.perf_counter() - t0
    dt = _timed_ticks(sched, ticks)
    launches = dict(da.LAUNCHES)
    want = cfg.n_layers * n_inner * sched.decode_ticks
    _require(launches[K5] == want and launches[K6] == 0,
             f"main path launched K5 {launches[K5]} times (want {want}) "
             f"and K6 {launches[K6]} times (want 0)")
    for r in reqs:
        _require(len(r.tokens) == 1 + n_inner * (ticks + 1),
                 f"request {r.id} holds {len(r.tokens)} tokens")
        _require(all(0 <= t < cfg.vocab for t in r.tokens),
                 f"request {r.id} emitted an out-of-vocabulary token")
    print(f"  {sched.decode_ticks} decode ticks ({ticks} timed), "
          f"{launches[K5]} K5 launches (= {cfg.n_layers} layers x "
          f"{n_inner} steps x {sched.decode_ticks} ticks)")
    rep = _serving_report(sched, cfg, n_inner, ticks, dt, t_admit, dev)
    del sched, params
    return launches, rep


def phase_paged_serving_bf16(dev):
    """The paged main path: request 1 is a 256-token system prompt plus
    256 own tokens; once it has its first token, 7 more on the same
    system prompt arrive, each sharing its 4 prefix pages and running
    one prefill chunk. Budgets keep every request resident and short of
    the wrap. Returns (launches, report)."""
    cfg = TransformerConfig(**MODEL, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=dev)
    n_inner, ticks, max_new = 64, 3, 384
    rng = np.random.default_rng(6)
    sys_prompt = rng.integers(0, cfg.vocab, 256)
    prompts = [np.concatenate([sys_prompt, rng.integers(0, cfg.vocab, 256)])
               for _ in range(SLOTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launches()
    sched = ServingScheduler(params, cfg, slots=SLOTS, n_inner=n_inner,
                             prompt_chunk=256, max_prompt=512,
                             quantize_kv=True, page_tokens=PAGE, device=dev)
    _require(sched.use_kernel,
             "the S=8 paged int8 tick did not route the kernel")
    first = sched.submit(prompts[0], max_new=max_new)
    while not first.tokens:
        sched.step()  # two 256-token chunks, then its first tick
    reqs = [first] + [sched.submit(p, max_new=max_new) for p in prompts[1:]]
    t0 = time.perf_counter()
    sched.step()  # admits the 7 (one chunk each) + a tick of all 8
    torch.cuda.synchronize()
    t_admit = time.perf_counter() - t0
    dt = _timed_ticks(sched, ticks)
    launches = dict(da.LAUNCHES)
    pool = sched.pool
    want = cfg.n_layers * n_inner * sched.decode_ticks
    print(f"  share hits {pool.share_hits} (want 28), prefill chunks "
          f"{sched.prefill_chunks} (want 9), pages used {pool.used} of "
          f"{pool.n_pages - 1}")
    print(f"  {sched.decode_ticks} decode ticks ({ticks} timed), "
          f"{launches[K6]} K6 launches (= {cfg.n_layers} layers x "
          f"{n_inner} steps x {sched.decode_ticks} ticks), "
          f"{launches[K5]} K5")
    _require(launches[K6] == want and launches[K5] == 0,
             f"main path launched K6 {launches[K6]} times (want {want}) "
             f"and K5 {launches[K5]} times (want 0)")
    _require(pool.share_hits == 28 and sched.prefill_chunks == 9,
             f"{pool.share_hits} share hits (want 28), "
             f"{sched.prefill_chunks} prefill chunks (want 9)")
    pool.check()
    for r in reqs:
        _require(not r.finished and len(r.tokens) > n_inner,
                 f"request {r.id} retired or holds {len(r.tokens)} tokens")
        _require(all(0 <= t < cfg.vocab for t in r.tokens),
                 f"request {r.id} emitted an out-of-vocabulary token")
    rep = _serving_report(sched, cfg, n_inner, ticks, dt, t_admit, dev)
    rep.update(share_hits=pool.share_hits,
               prefill_chunks=sched.prefill_chunks, pages_used=pool.used)
    del sched, params
    return launches, rep


def _time_ms(fn, n_iter, n_warm=10):
    for i in range(n_warm):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(n_iter):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def _timing(kern_fn, plain_fn, views, q, pos, nbytes, label):
    """Time a kernel, its plain version and the SDPA yardstick over the
    dequantised ring views (heads repeated for GQA, the same ring mask,
    here all visible); bound from the bytes and operations the call
    needs. ``views`` are the rotated copies' (B, W, ...) ring views."""
    B, _, H, D = q.shape
    W, Hkv = views[0]["k"].shape[1], views[0]["k"].shape[2]
    dt = q.dtype
    n = len(views)
    kern = _time_ms(lambda i: kern_fn(i % n), 400)
    plain = _time_ms(lambda i: plain_fn(i % n), 50)
    g = H // Hkv
    deq = []
    for c in views:
        kd = (c["k"].float() * c["k_s"][..., None]).to(dt)
        vd = (c["v"].float() * c["v_s"][..., None]).to(dt)
        deq.append((kd.repeat_interleave(g, 2).transpose(1, 2).contiguous(),
                    vd.repeat_interleave(g, 2).transpose(1, 2).contiguous()))
    kidx = torch.arange(W, device=q.device)
    mask = ((kidx[None] <= pos[:, None]) | (pos[:, None] >= W))[:, None,
                                                                None, :]
    qh = q.transpose(1, 2).contiguous()
    lib = _time_ms(lambda i: F.scaled_dot_product_attention(
        qh, deq[i % n][0], deq[i % n][1], attn_mask=mask,
        scale=D ** -0.5), 200)
    nops = 4 * B * H * W * D  # q.k and p.v multiply-adds, all visible
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S[dt] * 1e3
    rep = {"ms": kern, "plain_ms": plain, "library_ms": lib,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "ops": nops}
    print(f"  {label} {kern * 1e3:.2f} us/launch, bound "
          f"{rep['bound_ms'] * 1e3:.3f} us ({nbytes} B at 3.35 TB/s; "
          f"{nops} ops {t_ops * 1e3:.4f} us), plain {plain * 1e3:.2f} us, "
          f"SDPA over dequantised cache {lib * 1e3:.2f} us")
    return rep


def _attention_bytes(B, W, Hkv, D, q):
    """Each input read once, the output written once: int8 K and V,
    f32 k_s and v_s over the W visible keys, q in and out, positions."""
    return (B * W * Hkv * D * 2 + B * W * Hkv * 4 * 2
            + q.numel() * q.element_size() * 2 + B * 4)


def phase_kernel_timing(dev) -> dict:
    """K5, bf16 ring mode, every row past warm-up (all W keys visible),
    16 cache copies rotated so each launch finds its cache outside
    L2."""
    gen = torch.Generator().manual_seed(3)
    B, L, Hkv, D = SLOTS, MODEL["attn_window"], MODEL["n_kv_heads"], 128
    caches = [_cache(B, L, Hkv, D, gen, dev) for _ in range(16)]
    q = torch.randn(B, 1, MODEL["n_heads"], D,
                    generator=gen).to(torch.bfloat16).to(dev)
    pos = torch.arange(B, dtype=torch.int32, device=dev) + 5000
    scale = D ** -0.5
    return _timing(
        lambda i: da.quantized_decode_attention(q, caches[i], pos, scale,
                                                ring=True),
        lambda i: da.quantized_decode_attention_ref(q, caches[i], pos, scale,
                                                    ring=True),
        caches, q, pos, _attention_bytes(B, L, Hkv, D, q), "K5")


def phase_paged_timing(dev) -> dict:
    """K6, bf16, pages of 64, W=1024 (16 pages a row), every row past
    warm-up; 16 pools, each with its own page-table permutation,
    rotated so each launch finds its pages outside L2."""
    gen = torch.Generator().manual_seed(7)
    B, W, Hkv, D = SLOTS, MODEL["attn_window"], MODEL["n_kv_heads"], 128
    mp = W // PAGE
    n_pages = B * mp + 1
    pools, pts = [], []
    for _ in range(16):
        pools.append({k: t[0] for k, t in
                      _cache(1, n_pages * PAGE, Hkv, D, gen, dev).items()})
        pts.append((torch.randperm(n_pages - 1, generator=gen) + 1)
                   .reshape(B, mp).to(torch.int32).to(dev))
    q = torch.randn(B, 1, MODEL["n_heads"], D,
                    generator=gen).to(torch.bfloat16).to(dev)
    pos = torch.arange(B, dtype=torch.int32, device=dev) + 5000
    scale = D ** -0.5
    views = [{k: da.paged_ring_view(a, pt, PAGE) for k, a in p.items()}
             for p, pt in zip(pools, pts)]
    nbytes = _attention_bytes(B, W, Hkv, D, q) + pts[0].numel() * 4
    return _timing(
        lambda i: da.quantized_decode_attention(
            q, pools[i], pos, scale, ring=True, page_table=pts[i],
            page_tokens=PAGE),
        lambda i: da.paged_decode_attention_ref(q, pools[i], pos, scale,
                                                pts[i], PAGE),
        views, q, pos, nbytes, "K6")


def _kernel_row(name, replaces_line, launches, err, tim):
    return {
        "name": name,
        "route": "cuda",
        "source": "mpistragglers_jl_tpu_torch/ops/csrc/decode_attention.cu",
        "replaces": ("mpistragglers_jl_tpu/ops/decode_attention.py:"
                     f"{replaces_line}"),
        "launches": launches,
        "max_abs_err": err,
        "ms": tim["ms"],
        "plain_ms": tim["plain_ms"],
        "bound_ms": tim["bound_ms"],
        "bound_by": tim["bound_by"],
        "library_ms": tim["library_ms"],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on "
              "the GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # f32 parity needs full-precision products, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1] device: {name}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(smi)

    t0 = time.perf_counter()
    _build.load("decode_attention")
    t_build = time.perf_counter() - t0
    print(f"[2] built decode_attention.cu (K5 and K6) in {t_build:.1f} s")
    for kname, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {kname}: {line.strip()}")

    print("[3] K5 against plain version, B=8 L=W=1024 D=128")
    err5 = phase_kernel_vs_plain(dev)

    print("[4] serving parity, f32, full width, kernel vs einsum route")
    phase_serving_parity_f32(dev)
    torch.cuda.empty_cache()

    print("[5] main path: bf16 serving, S=8, 512-token prompts, "
          "n_inner=64")
    launches5, serve = phase_serving_bf16(dev)
    torch.cuda.empty_cache()

    print("[6] K5 timing, bf16 ring, B=8 L=W=1024 Hkv=2 g=4 D=128")
    tim5 = phase_kernel_timing(dev)

    print("[7] K6 against plain version, B=8 D=128, pages of 16/64/24")
    err6 = phase_paged_vs_plain(dev)

    print("[8] paged serving parity, f32, full width, pages of 64, "
          "kernel vs gather route")
    phase_paged_parity_f32(dev)
    torch.cuda.empty_cache()

    print("[9] paged main path: bf16, S=8, pages of 64, a shared "
          "256-token system prompt, n_inner=64")
    launches9, serve_paged = phase_paged_serving_bf16(dev)
    torch.cuda.empty_cache()

    print("[10] K6 timing, bf16, B=8 W=1024 (16 pages of 64) Hkv=2 g=4 "
          "D=128")
    tim6 = phase_paged_timing(dev)

    kernels = [_kernel_row(K5, 134, launches5[K5], err5, tim5),
               _kernel_row(K6, 105, launches9[K6], err6, tim6)]
    _require(all(k["launches"] > 0 for k in kernels),
             "a kernel of a main path was never launched")
    print(json.dumps({"serving_bf16": serve,
                      "paged_serving_bf16": serve_paged,
                      "build_s": t_build,
                      "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
