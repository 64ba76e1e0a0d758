"""The port's CUDA kernels on the card, against their plain PyTorch
versions, and the routes that launch them: the decode kernels (dense K5
and paged K6) with the serving scheduler, and the flash-attention
kernels (K1-K4) with the train step. Every test here is ``gpu``-marked
and skips without a card (the kernels have no CPU mode). This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: decode kernels with f32 q within 1e-5 absolute of the plain
version (the two sum in f32 in different orders); a bf16 output within
1e-5 + 2**-8 of the f32 plain result on the same q (one bf16 rounding
of the value). Flash kernels: f32 o and lse within 2e-5 + 2e-5 |want|,
f32 gradients within 5e-5 + 5e-5 |want| (the JAX package's own bounds,
tests/test_flash_attention.py); a bf16 output adds one bf16 rounding,
2**-8 |want|. The plain versions run in f32 with TF32 off.
"""

import pytest
import torch

from mpistragglers_jl_tpu_torch.models import decode as td
from mpistragglers_jl_tpu_torch.models.serving import ServingScheduler
from mpistragglers_jl_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    loss_and_grads,
    make_train_step,
)
from mpistragglers_jl_tpu_torch.ops import decode_attention as da
from mpistragglers_jl_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cache(B, L, Hkv, D, gen, dev):
    k = torch.randn(B, L, Hkv, D, generator=gen)
    v = torch.randn(B, L, Hkv, D, generator=gen)
    kq, ks = td._kv_quantize(k)
    vq, vs = td._kv_quantize(v)
    return {n: t.to(dev) for n, t in
            {"k": kq, "k_s": ks, "v": vq, "v_s": vs}.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv,D", [(8, 8, 128), (8, 2, 128),
                                      (8, 1, 128), (4, 2, 256)])
def test_kernel_matches_plain_version(dtype, Hq, Hkv, D):
    dev = _card()
    gen = torch.Generator().manual_seed(Hq * 100 + Hkv + D)
    dt = getattr(torch, dtype)
    B, L = 8, 1024
    cache = _cache(B, L, Hkv, D, gen, dev)
    q = torch.randn(B, 1, Hq, D, generator=gen).to(dt).to(dev)
    pos = torch.tensor([0, 7, 31, 32, 1023, 1024, 5000, 100],
                       dtype=torch.int32, device=dev)
    rtol = 0.0 if dt == torch.float32 else 2.0 ** -8
    for kw in ({"ring": True}, {}, {"window": 100}, {"window": 1}):
        got = da.quantized_decode_attention(q, cache, pos, D ** -0.5, **kw)
        want = da.quantized_decode_attention_ref(q.float(), cache, pos,
                                                 D ** -0.5, **kw)
        torch.cuda.synchronize()
        assert got.dtype == dt
        torch.testing.assert_close(got.float(), want, rtol=rtol,
                                   atol=1e-5, msg=str(kw))


def test_kernel_counts_launches_and_rejects_bad_leaves():
    dev = _card()
    gen = torch.Generator().manual_seed(1)
    cache = _cache(2, 256, 2, 128, gen, dev)
    q = torch.randn(2, 1, 4, 128, generator=gen, device="cpu").to(dev)
    before = da.LAUNCHES["quantized_decode_attention"]
    da.quantized_decode_attention(q, cache, 3, 0.1, ring=True)
    assert da.LAUNCHES["quantized_decode_attention"] == before + 1
    bad = dict(cache, k=cache["k"].transpose(0, 1).contiguous()
               .transpose(0, 1))
    with pytest.raises(ValueError, match="contiguous"):
        da.quantized_decode_attention(q, bad, 3, 0.1, ring=True)


def test_scheduler_kernel_route_equals_einsum_route():
    """f32 serving on the card: the kernel tick and the einsum tick
    give the same greedy streams, and the kernel launches once per
    layer per decode step."""
    dev = _card()
    cfg = TransformerConfig(vocab=97, d_model=256, n_heads=2, n_kv_heads=1,
                            n_layers=2, d_ff=256, attn_window=128)
    params = init_params(cfg, seed=31, device=dev)
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(1, 97, (n,), generator=gen).numpy()
               for n in (5, 9, 3, 7, 12, 30)]
    streams = []
    for toggle in (None, False):
        td.use_decode_kernel(toggle)
        try:
            sched = ServingScheduler(params, cfg, slots=4, n_inner=3,
                                     prompt_chunk=8, max_prompt=32,
                                     quantize_kv=True, device=dev)
        finally:
            td.use_decode_kernel(None)
        assert sched.use_kernel == (toggle is None)
        da.LAUNCHES["quantized_decode_attention"] = 0
        reqs = [sched.submit(p, max_new=10) for p in prompts]
        sched.run()
        n = da.LAUNCHES["quantized_decode_attention"]
        want = (cfg.n_layers * sched.n_inner * sched.decode_ticks
                if toggle is None else 0)
        assert n == want
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]
    oracle = [td.generate_ring_dense(params, p[None], 10, cfg,
                                     quantize_kv=True, device=dev)
              .cpu().numpy()[0].tolist() for p in prompts]
    assert streams[0] == oracle


def _paged_case(B, W, P, Hkv, D, gen, dev):
    """A pool of B * W/P + 4 pages (page 0 the null page), a page table
    from a seeded permutation with pages shared by rows 1 and 2 and
    null entries past the budget of the rows in warm-up."""
    mp = W // P
    n_pages = B * mp + 4
    pool = _cache(1, n_pages * P, Hkv, D, gen, dev)
    pool = {k: t[0] for k, t in pool.items()}
    pt = torch.randperm(n_pages - 1, generator=gen)[:B * mp] + 1
    pt = pt.reshape(B, mp).to(torch.int32)
    pos = torch.tensor([0, 7, 31, 32, W - 1, W, 5000, 3 * W + 1],
                       dtype=torch.int32)[:B]
    pt[2, :3] = pt[1, :3]
    for b in range(B):
        if pos[b] < W:
            pt[b, int(pos[b]) // P + 1:] = 0
    return pool, pt.to(dev), pos.to(dev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,W", [(16, 1024), (24, 960), (64, 1024)])
@pytest.mark.parametrize("Hq,Hkv", [(8, 8), (8, 2), (8, 1)])
def test_paged_kernel_matches_plain_version(dtype, P, W, Hq, Hkv):
    dev = _card()
    gen = torch.Generator().manual_seed(P * 10 + Hkv)
    dt = getattr(torch, dtype)
    B, D = 8, 128
    pool, pt, pos = _paged_case(B, W, P, Hkv, D, gen, dev)
    q = torch.randn(B, 1, Hq, D, generator=gen).to(dt).to(dev)
    # K6 splits the ring at these shapes, the combine folds the splits
    assert da.paged_split_plan(B, Hkv, W, P, n_sm=da.sm_count(dev))[1] > 1
    got = da.quantized_decode_attention(q, pool, pos, D ** -0.5, ring=True,
                                        page_table=pt, page_tokens=P)
    want = da.paged_decode_attention_ref(q.float(), pool, pos, D ** -0.5,
                                         pt, P)
    torch.cuda.synchronize()
    assert got.dtype == dt
    rtol = 0.0 if dt == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=1e-5)


def test_paged_kernel_counts_launches_and_rejects_bad_leaves():
    dev = _card()
    gen = torch.Generator().manual_seed(3)
    pool, pt, pos = _paged_case(4, 256, 16, 2, 128, gen, dev)
    q = torch.randn(4, 1, 4, 128, generator=gen).to(dev)
    before = dict(da.LAUNCHES)
    da.quantized_decode_attention(q, pool, pos, 0.1, ring=True,
                                  page_table=pt, page_tokens=16)
    assert da.LAUNCHES["paged_decode_attention"] == (
        before["paged_decode_attention"] + 1)
    assert (da.LAUNCHES["quantized_decode_attention"]
            == before["quantized_decode_attention"])
    with pytest.raises(ValueError, match="page_table"):
        da.quantized_decode_attention(q, pool, pos, 0.1, ring=True,
                                      page_table=pt.long(), page_tokens=16)
    with pytest.raises(ValueError, match="contiguous"):
        da.quantized_decode_attention(q, pool, pos, 0.1, ring=True,
                                      page_table=pt.t().contiguous().t(),
                                      page_tokens=16)
    bad = dict(pool, k_s=pool["k_s"].double())
    with pytest.raises(ValueError, match="k_s"):
        da.quantized_decode_attention(q, bad, pos, 0.1, ring=True,
                                      page_table=pt, page_tokens=16)


def test_paged_scheduler_kernel_route_equals_einsum_route():
    """f32 paged serving on the card, a shared prefix that both holders
    wrap past: the kernel tick and the gather tick give the same
    streams with copy-on-write copies, the paged kernel launches once
    per layer per decode step, K5 never, and the pools drain."""
    dev = _card()
    cfg = TransformerConfig(vocab=97, d_model=256, n_heads=2, n_kv_heads=1,
                            n_layers=2, d_ff=256, attn_window=128)
    params = init_params(cfg, seed=31, device=dev)
    gen = torch.Generator().manual_seed(4)
    sys_prompt = torch.randint(1, 97, (32,), generator=gen)
    prompts = [torch.cat([sys_prompt, torch.randint(1, 97, (n,),
                                                    generator=gen)]).numpy()
               for n in (20, 30)]
    prompts += [torch.randint(1, 97, (n,), generator=gen).numpy()
                for n in (5, 9, 3)]
    budgets = [120, 110, 10, 12, 8]
    streams = []
    for toggle in (None, False):
        td.use_decode_kernel(toggle)
        try:
            sched = ServingScheduler(params, cfg, slots=4, n_inner=4,
                                     prompt_chunk=16, max_prompt=64,
                                     quantize_kv=True, page_tokens=16,
                                     device=dev)
        finally:
            td.use_decode_kernel(None)
        assert sched.use_kernel == (toggle is None)
        for k in da.LAUNCHES:
            da.LAUNCHES[k] = 0
        first = sched.submit(prompts[0], max_new=budgets[0])
        while not first.tokens:
            sched.step()
        reqs = [first] + [sched.submit(p, max_new=n)
                          for p, n in zip(prompts[1:], budgets[1:])]
        sched.run()
        want = (cfg.n_layers * sched.n_inner * sched.decode_ticks
                if toggle is None else 0)
        assert da.LAUNCHES["paged_decode_attention"] == want
        assert da.LAUNCHES["quantized_decode_attention"] == 0
        assert sched.pool.share_hits == 2 and sched.pool.cow_copies > 0
        sched.pool.check()
        assert sched.pool.used == 0 and sched.pool.reserved == 0
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]
    for i in (0, 1):
        o = td.generate_ring_dense(params, prompts[i][None], budgets[i], cfg,
                                   quantize_kv=True, device=dev)
        assert streams[0][i] == o.cpu().numpy()[0].tolist()


# ---------------------------------------------------------------- flash


def _flash_case(B, L, H, Hkv, D, dt, seed, dev):
    """(B*H, L, D) q3 and do3, (B*Hkv, L, D) k3 and v3, from a seeded
    generator, in ``dt`` on ``dev``."""
    gen = torch.Generator().manual_seed(seed)

    def mk(h):
        return torch.randn(B * h, L, D, generator=gen).to(dt).to(dev)

    return mk(H), mk(Hkv), mk(Hkv), mk(H)


def _close(got, want, atol, label):
    rtol = atol + (2.0 ** -8 if got.dtype == torch.bfloat16 else 0.0)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol, msg=label)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,Hkv,D,causal,window", [
    (2, 200, 4, 2, 64, True, None),
    (1, 130, 2, 2, 128, False, None),
    (2, 257, 4, 1, 128, True, 64),
    (1, 64, 2, 1, 64, False, 40),
    # the main path's head width and length, causal, GQA
    (1, 2048, 4, 2, 128, True, None),
])
def test_flash_kernels_match_plain_versions(dtype, B, L, H, Hkv, D, causal,
                                            window):
    """K1-K4 against their plain versions on the same inputs: the
    plain versions take the f32 copies, so a bf16 kernel output is held
    against the exact f32 result."""
    dev = _card()
    dt = getattr(torch, dtype)
    q3, k3, v3, do3 = _flash_case(B, L, H, Hkv, D, dt, L + D, dev)
    g, scale = H // Hkv, D ** -0.5
    f32 = [t.float() for t in (q3, k3, v3, do3)]
    meta = (scale, causal, window, g)
    o, lse = fa._fwd(q3, k3, v3, *meta)
    o_ref, lse_ref = fa._fwd_ref(*f32[:3], *meta)
    _close(o, o_ref, 2e-5, "K1 o")
    _close(lse, lse_ref, 2e-5, "K1 lse")
    delta = fa._delta(do3, o)
    args = (q3, k3, v3, do3, lse, delta) + meta
    args_ref = tuple(f32) + (lse, delta) + meta
    _close(fa._bwd_dq(*args), fa._bwd_dq_ref(*args_ref), 5e-5, "K2 dq")
    for got, want, name in zip(fa._bwd_dkv(*args), fa._bwd_dkv_ref(*args_ref),
                               ("K3 dk", "K3 dv")):
        _close(got, want, 5e-5, name)
    for got, want, name in zip(fa._bwd_fused_grads(*args),
                               fa._bwd_fused_ref(*args_ref),
                               ("K4 dq", "K4 dk", "K4 dv")):
        _close(got, want, 5e-5, name)
    torch.cuda.synchronize()


def test_flash_counts_launches_and_rejects_bad_inputs():
    dev = _card()
    q3, k3, v3, do3 = _flash_case(1, 96, 4, 2, 64, torch.bfloat16, 5, dev)
    q = q3.reshape(1, 4, 96, 64).transpose(1, 2).requires_grad_()
    k = k3.reshape(1, 2, 96, 64).transpose(1, 2).requires_grad_()
    v = v3.reshape(1, 2, 96, 64).transpose(1, 2).requires_grad_()
    for impl, want in (("auto", {"flash_fwd": 1, "flash_bwd_dq": 1,
                                 "flash_bwd_dkv": 1, "flash_bwd_fused": 0}),
                       ("fused", {"flash_fwd": 1, "flash_bwd_dq": 0,
                                  "flash_bwd_dkv": 0,
                                  "flash_bwd_fused": 1})):
        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        o = fa.flash_attention(q, k, v, causal=True, bwd_impl=impl)
        torch.autograd.grad(o.float().sum(), (q, k, v))
        assert fa.LAUNCHES == want, impl
    with pytest.raises(ValueError, match="head_dim"):
        fa._fwd(q3[..., :32].contiguous(), k3[..., :32].contiguous(),
                v3[..., :32].contiguous(), 0.1, True, None, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa._fwd(q3, k3.transpose(0, 1).contiguous().transpose(0, 1), v3,
                0.1, True, None, 2)
    with pytest.raises(ValueError, match="'k'"):
        fa._fwd(q3, k3.float(), v3, 0.1, True, None, 2)


@pytest.mark.parametrize("B", [1, 3])
def test_flash_attention_matches_reference_attention(B):
    """flash_attention on model-layout (B, L, H, D) tensors, a batch of
    one included, against the reference attention: output and grads,
    f32 (2e-5 and 5e-5)."""
    from mpistragglers_jl_tpu_torch.parallel.ring_attention import (
        reference_attention,
    )

    dev = _card()
    gen = torch.Generator().manual_seed(B)
    q, k, v, w = (torch.randn(B, 100, h, 64, generator=gen).to(dev)
                  for h in (4, 2, 2, 4))
    outs = []
    for fn in (fa.flash_attention, reference_attention):
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        o = fn(qg, kg, vg, causal=True, window=70)
        outs.append((o,) + torch.autograd.grad((o * w).sum(), (qg, kg, vg)))
    for got, want, tol in zip(outs[0], outs[1], (2e-5, 5e-5, 5e-5, 5e-5)):
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_flash_train_step_matches_reference_attention():
    """f32 training on the card: loss and grads through K1-K3 (split)
    and K4 (fused) against the reference attention, and one SGD step
    launching each kernel once per layer."""
    dev = _card()
    fields = dict(vocab=97, d_model=256, n_heads=4, n_kv_heads=2,
                  n_layers=2, d_ff=256, attn="ulysses", attn_window=48)
    gen = torch.Generator().manual_seed(9)
    tok = torch.randint(0, 97, (2, 129), generator=gen).to(dev)
    inp, tgt = tok[:, :-1], tok[:, 1:]
    params = init_params(TransformerConfig(**fields), seed=3, device=dev)
    loss_r, g_r = loss_and_grads(params, inp, tgt,
                                 TransformerConfig(**fields))
    for bwd in ("auto", "fused"):
        cfg = TransformerConfig(**fields, attn_impl="flash", flash_bwd=bwd)
        loss, grads = loss_and_grads(params, inp, tgt, cfg)
        torch.testing.assert_close(loss, loss_r, rtol=1e-5, atol=0)
        for a, b in zip(grads["layers"], g_r["layers"]):
            for name in a:
                torch.testing.assert_close(a[name], b[name], rtol=1e-4,
                                           atol=1e-5, msg=f"{bwd} {name}")
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    step = make_train_step(TransformerConfig(**fields, attn_impl="flash"),
                           lr=1e-2, donate=True)
    _, loss = step(params, inp, tgt)
    assert torch.isfinite(loss)
    assert fa.LAUNCHES == {"flash_fwd": 2, "flash_bwd_dq": 2,
                           "flash_bwd_dkv": 2, "flash_bwd_fused": 0}


# ------------------------------------------------ K7 and long-context decode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,bk", [(1, 2048, 512), (2, 1000, 160),
                                    (3, 96, 32)])
def test_attrib_variants_match_plain_versions(dtype, B, L, bk):
    """K7's four variants against their plain versions: dma exactly
    (integer sums), the others within 1e-5 of the largest value plus
    1e-5 relative (f32 sums in other orders); L % bk != 0 leaves a
    short last segment."""
    dev = _card()
    gen = torch.Generator().manual_seed(B * 1000 + L)
    dt = getattr(torch, dtype)
    cache = _cache(B, L, 2, 128, gen, dev)
    q = torch.randn(B, 1, 8, 128, generator=gen).to(dt).to(dev)
    for mode in da.ATTRIB_MODES:
        before = da.LAUNCHES["decode_attention_attrib"]
        got = da.decode_attention_attrib(q, cache, L - 1, 128 ** -0.5, mode,
                                         bk)
        want = da.decode_attention_attrib_ref(q.float(), cache, L - 1,
                                              128 ** -0.5, mode, bk)
        torch.cuda.synchronize()
        assert da.LAUNCHES["decode_attention_attrib"] == before + 1
        assert got.dtype == torch.float32 and got.shape == (B, 8, 128)
        if mode == "dma":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(
                got, want, rtol=1e-5,
                atol=1e-5 * want.abs().max().item(), msg=mode)


def test_attrib_rejects_bad_block_and_mode():
    dev = _card()
    gen = torch.Generator().manual_seed(5)
    cache = _cache(1, 256, 2, 128, gen, dev)
    q = torch.randn(1, 1, 8, 128, generator=gen).to(dev)
    with pytest.raises(ValueError, match="multiple of 32"):
        da.decode_attention_attrib(q, cache, 255, 0.1, "dot", 48)
    with pytest.raises(ValueError, match="mode"):
        da.decode_attention_attrib(q, cache, 255, 0.1, "full", 64)


def test_graph_capture_and_replay_are_not_counted():
    """A call recorded into a CUDA graph does not run, so neither it
    nor the graph's replays add to LAUNCHES; the replay still computes
    the eager call's result."""
    dev = _card()
    gen = torch.Generator().manual_seed(7)
    cache = _cache(1, 1024, 2, 128, gen, dev)
    q = torch.randn(1, 1, 8, 128, generator=gen).to(dev)
    pos = torch.tensor([1023], dtype=torch.int32, device=dev)
    want = da.decode_attention_attrib(q, cache, pos, 0.1, "full_nosm", 256)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.decode_attention_attrib(q, cache, pos, 0.1, "full_nosm", 256)
    torch.cuda.current_stream().wait_stream(side)
    before = dict(da.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = da.decode_attention_attrib(q, cache, pos, 0.1, "full_nosm",
                                         256)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert da.LAUNCHES == before
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_positional_at_16k(dtype):
    """K5 in positional mode at the long-context length, rows at the
    end of the cache, mid-way and near the start, with and without a
    window."""
    dev = _card()
    gen = torch.Generator().manual_seed(16)
    dt = getattr(torch, dtype)
    B, L = 4, 16384
    cache = _cache(B, L, 2, 128, gen, dev)
    q = torch.randn(B, 1, 8, 128, generator=gen).to(dt).to(dev)
    pos = torch.tensor([L - 1, 8191, 31, 16000], dtype=torch.int32,
                       device=dev)
    rtol = 0.0 if dt == torch.float32 else 2.0 ** -8
    for kw in ({}, {"window": 1000}):
        got = da.quantized_decode_attention(q, cache, pos, 128 ** -0.5, **kw)
        want = da.quantized_decode_attention_ref(q.float(), cache, pos,
                                                 128 ** -0.5, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, rtol=rtol, atol=1e-5,
                                   msg=str(kw))


def test_generate_dense_kernel_route_equals_einsum_route():
    """f32 generation on the positional int8 cache: the kernel route
    (AUTO at B=4, and forced at B=1) gives the einsum route's greedy
    streams, launching K5 once per layer per decode step."""
    dev = _card()
    cfg = TransformerConfig(vocab=97, d_model=256, n_heads=2, n_kv_heads=1,
                            n_layers=2, d_ff=256, attn="ulysses",
                            attn_impl="flash")
    params = init_params(cfg, seed=41, device=dev)
    gen = torch.Generator().manual_seed(6)
    for B, kernel_toggle in ((4, None), (1, True)):
        prompt = torch.randint(1, 97, (B, 300), generator=gen)
        streams = []
        for toggle in (kernel_toggle, False):
            td.use_decode_kernel(toggle)
            try:
                da.LAUNCHES["quantized_decode_attention"] = 0
                streams.append(td.generate_dense(params, prompt, 20, cfg,
                                                 quantize_kv=True,
                                                 device=dev))
            finally:
                td.use_decode_kernel(None)
            want = cfg.n_layers * 19 if toggle is not False else 0
            assert da.LAUNCHES["quantized_decode_attention"] == want
        assert torch.equal(streams[0], streams[1]), B


# ------------------------------------------ K5 split-K and K1 on the tensor
# cores


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,kw,positions", [
    # 64 splits of 256 keys; one row at the end, one that leaves every
    # split past 5461 empty, and a window cutting a chunk in two
    (1, 16384, {}, [16383]),
    (1, 16384, {"window": 1000}, [5461]),
    (4, 16384, {"window": 1000}, [16383, 8191, 31, 5461]),
    # a ragged length: the last chunk is short
    (3, 1000, {}, [999, 500, 0]),
    (3, 1000, {"window": 77}, [999, 421, 5]),
    # the ring in warm-up, at W - 1, at W, wrapped, and a row with
    # nothing visible
    (8, 1024, {"ring": True}, [0, 31, 32, 1023, 1024, 5000, 2047, -1]),
])
def test_kernel_split_matches_plain_version(dtype, B, L, kw, positions):
    dev = _card()
    gen = torch.Generator().manual_seed(B * 7 + L)
    dt = getattr(torch, dtype)
    cache = _cache(B, L, 2, 128, gen, dev)
    q = torch.randn(B, 1, 8, 128, generator=gen).to(dt).to(dev)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    assert da.split_plan(B, 2, L, n_sm=da.sm_count(dev))[1] > 1
    got = da.quantized_decode_attention(q, cache, pos, 128 ** -0.5, **kw)
    want = da.quantized_decode_attention_ref(q.float(), cache, pos,
                                             128 ** -0.5, **kw)
    torch.cuda.synchronize()
    rtol = 0.0 if dt == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=1e-5)
    if -1 in positions:
        assert bool((got[positions.index(-1)] == 0).all())


def test_kernel_split_captures_into_a_graph():
    """One K5 call with 64 splits, its scratch allocated inside the
    capture: replays equal the eager output, and neither the capture
    nor the replays count as launches."""
    dev = _card()
    gen = torch.Generator().manual_seed(8)
    cache = _cache(1, 16384, 2, 128, gen, dev)
    q = torch.randn(1, 1, 8, 128, generator=gen).to(torch.bfloat16).to(dev)
    pos = torch.tensor([16383], dtype=torch.int32, device=dev)
    want = da.quantized_decode_attention(q, cache, pos, 0.1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.quantized_decode_attention(q, cache, pos, 0.1)
    torch.cuda.current_stream().wait_stream(side)
    before = dict(da.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = da.quantized_decode_attention(q, cache, pos, 0.1)
    for _ in range(2):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert da.LAUNCHES == before


def test_paged_kernel_split_captures_into_a_graph():
    """One K6 call at the serving shape (8 splits of 128 ring slots),
    its scratch allocated inside the capture: replays equal the eager
    output, and neither the capture nor the replays count as
    launches."""
    dev = _card()
    gen = torch.Generator().manual_seed(9)
    pool, pt, pos = _paged_case(8, 1024, 64, 2, 128, gen, dev)
    q = torch.randn(8, 1, 8, 128, generator=gen).to(torch.bfloat16).to(dev)

    def call():
        return da.quantized_decode_attention(q, pool, pos, 0.1, ring=True,
                                             page_table=pt, page_tokens=64)

    assert da.paged_split_plan(8, 2, 1024, 64,
                               n_sm=da.sm_count(dev))[1] > 1
    want = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    before = dict(da.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call()
    for _ in range(2):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert da.LAUNCHES == before


@pytest.mark.parametrize("L", [16384, 2048])
def test_flash_fwd_bf16_at_the_prefill_shapes(L):
    """K1's bf16 kernel at the long-context and speculative prefill
    shapes (B=1, H=8 over Hkv=2, D=128, causal), held one q head at a
    time against the plain version on f32 copies."""
    dev = _card()
    gen = torch.Generator().manual_seed(L)
    q3, k3, v3 = (torch.randn(h, L, 128, generator=gen).to(torch.bfloat16)
                  .to(dev) for h in (8, 2, 2))
    o, lse = fa._fwd(q3, k3, v3, 128 ** -0.5, True, None, 4)
    for h in range(8):
        o_ref, lse_ref = fa._fwd_ref(q3[h:h + 1].float(),
                                     k3[h // 4:h // 4 + 1].float(),
                                     v3[h // 4:h // 4 + 1].float(),
                                     128 ** -0.5, True, None, 1)
        _close(o[h:h + 1], o_ref, 2e-5, f"K1 o head {h}")
        _close(lse[h:h + 1], lse_ref, 2e-5, f"K1 lse head {h}")
