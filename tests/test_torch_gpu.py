"""The port's CUDA kernels on the card, against their plain PyTorch
versions, and the routes that launch them: the decode kernels (dense K5
and paged K6) with the serving scheduler, and the flash-attention
kernels (K1-K4) with the train step; the pool on CUDA streams with
the coded GEMM over it (snapshots, stream ordering, bf16 bytes) and
its decode kernel against its plain version; and the
mixture of experts and coded transformer training on the card; the
rateless GEMM's collected set, GF(256) coding and the hierarchical
decode's batched solve on the card; and spawned worker processes that
compute on the card through both host backends (config 2's product
within its ``REL_TOL["highest"]`` of an in-process one, CUDA-tensor
payloads snapshotted at dispatch, CUDA-tensor results bit-equal); and
fused K-epoch windows as replayed CUDA graphs (``repochs`` bit-equal to
the host loop, the graph equal to the eager loop) and the folded pool
over a one-rank mesh of the card; and the sharded train step over eight
ranks of the card against eight CPU ranks, the expert-parallel step over
eight and the 1F1B pipeline with MoE stages over four; and sharded
inference on four ranks of the card (int8 generation, positional and
ring, against the dense generators; the int8 serving tick against four
CPU ranks), with exact K1 and K5 counts; and one sharded step over two
processes on the card joined by ``gloo``, bit-equal to the
single-controller step. Every test here is ``gpu``-marked and skips
without a card. This file
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


# -- the pool on CUDA streams and the coded GEMM (backends/cuda.py,
# ops/coded_gemm.py): f32 products within 1e-5 of max|C| of the f32
# reference product (TF32 off); a bf16 recvbuf holds the exact bits.


def test_cuda_sendbuf_is_snapshot_before_asyncmap_returns():
    """A worker still out (gated) reads its own copy of a CUDA sendbuf
    that the caller overwrites right after asyncmap returns."""
    import threading

    from mpistragglers_jl_tpu_torch import (AsyncPool, CUDADeviceBackend,
                                            asyncmap, waitall)

    dev = _card()
    gate = threading.Event()

    def delay(i, epoch):
        if i == 1 and not gate.wait(60):
            raise TimeoutError("gate never opened")
        return 0.0

    backend = CUDADeviceBackend(lambda i, p, e: p[-4:].clone(), 2,
                                devices=[dev], delay_fn=delay)
    try:
        pool = AsyncPool(2)
        buf = torch.ones(1 << 24, device=dev)
        asyncmap(pool, buf, backend, nwait=1)
        assert pool.active[1]
        buf.fill_(7.0)
        gate.set()
        waitall(pool, backend, timeout=60)
        assert pool.results[1].device.type == "cuda"
        assert torch.equal(pool.results[1].cpu(), torch.ones(4))
    finally:
        backend.shutdown()


def _mats_on(dev, m, c, d, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(m, c, generator=gen).to(dev),
            torch.randn(c, d, generator=gen).to(dev))


def test_enqueue_results_read_by_a_decode_on_another_stream():
    """"enqueue" arrival posts completions before the stacked product has
    run; a decode on another stream orders itself after it."""
    from mpistragglers_jl_tpu_torch import AsyncPool, CodedGemm, asyncmap

    dev = _card()
    A, B = _mats_on(dev, 1536, 1024, 2048, 1)
    want = A @ B
    cg = CodedGemm(A, 8, 6, devices=[dev], batch=True,
                   batch_arrival="enqueue")
    side = torch.cuda.Stream()
    try:
        pool = AsyncPool(8)
        for epoch in range(1, 4):
            asyncmap(pool, B * epoch, cg.backend, nwait=6)
            with torch.cuda.stream(side):
                got = cg.result_device(pool)
            torch.cuda.current_stream().wait_stream(side)
            err = (got - want * epoch).abs().max() / (want * epoch).abs().max()
            assert float(err) <= 1e-5
    finally:
        cg.backend.shutdown()


def test_bf16_recvbuf_round_trips_bit_exactly_from_the_card():
    import numpy as np

    from mpistragglers_jl_tpu_torch import AsyncPool, CUDADeviceBackend, asyncmap

    dev = _card()
    n = 4
    backend = CUDADeviceBackend(
        lambda i, p, e: (p / (i + 3)).to(torch.bfloat16), n, devices=[dev])
    try:
        pool = AsyncPool(n)
        payload = torch.linspace(-3.1, 2.9, 257, device=dev)
        recvbuf = np.zeros(257 * n, dtype=np.uint16)
        asyncmap(pool, payload, backend, recvbuf, nwait=n)
        for i in range(n):
            want = (payload / (i + 3)).to(torch.bfloat16).view(torch.int16)
            assert recvbuf.reshape(n, 257)[i].tobytes() == \
                want.cpu().numpy().tobytes()
    finally:
        backend.shutdown()


@pytest.mark.parametrize("batch", [False, True])
def test_coded_gemm_on_the_card_equals_its_cpu_result(batch):
    import numpy as np

    from mpistragglers_jl_tpu_torch import AsyncPool, CodedGemm, asyncmap, waitall

    dev = _card()
    rng = np.random.default_rng(3)
    A = rng.standard_normal((1200, 640)).astype(np.float32)
    B = rng.standard_normal((640, 384)).astype(np.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        cg = CodedGemm(A, 8, 6, devices=[d], batch=batch)
        try:
            pool = AsyncPool(8)
            asyncmap(pool, B, cg.backend, nwait=8)
            out[d.type] = cg.result(pool)
            waitall(pool, cg.backend)
        finally:
            cg.backend.shutdown()
    scale = np.max(np.abs(out["cpu"]))
    assert np.max(np.abs(out["cuda"] - out["cpu"])) <= 1e-5 * scale


# -- the coded-GEMM decode kernel (ops/csrc/decode_solve.cu) against its
# plain version (ops/decode_solve.py), both on the card from the same host
# factors, at the benchmark's shapes. The two substitute in f32 with the
# same factors, the kernel with one fmaf a term and the plain version
# with a rounded product and sum, so they differ by rounding amplified by
# at most cond(G_S): within 1e-5 x cond(G_S) of max|X|, as the decode's
# other tests. A systematic set (G_S the identity) is a bit copy.


def _decode_case(dev, G, rows, cols, seed):
    """Source blocks X (k, rows, cols) and every coded shard G X, on the
    card in f32 (the sum taken in float64 and rounded once)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    k = G.shape[1]
    X = torch.randn(k, rows, cols, generator=gen, device=dev)
    G64 = torch.from_numpy(G).to(dev, torch.float64)
    X64 = X.double()
    coded = torch.stack([torch.einsum("j,jrc->rc", G64[i], X64).float()
                         for i in range(G.shape[0])])
    return X, coded


def _check_decode_kernel(G_S, shards, X):
    import numpy as np

    from mpistragglers_jl_tpu_torch.ops import decode_solve as ds

    cond = float(np.linalg.cond(np.asarray(G_S, np.float64)))
    before = ds.LAUNCHES["decode_solve"]
    got = ds.decode_solve(shards, G_S)
    assert ds.LAUNCHES["decode_solve"] == before + 1
    want = ds.decode_solve_ref(shards, *ds.host_lu(G_S))
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * cond * scale
    assert float((got - X).abs().max()) <= 1e-5 * cond * float(
        X.abs().max())
    if np.array_equal(G_S, np.eye(len(shards))):
        assert torch.equal(got, torch.stack(shards))
    return got


def test_decode_kernel_matches_plain_version_on_every_mds_set():
    """Config 3's shards (1366 x 8192, the (8, 6) Cauchy code), every
    six-of-eight fresh set, the largest cond(G_S) (852, rows 2-7, as
    the shiftexp traffic's worst set) among them; the shards read as
    rows of one stack, where they lie."""
    import itertools

    from mpistragglers_jl_tpu_torch.ops.coding import MDSCode

    dev = _card()
    G = MDSCode(8, 6).G
    X, coded = _decode_case(dev, G, 1366, 8192, 0)
    for idx in itertools.combinations(range(8), 6):
        _check_decode_kernel(G[list(idx)], [coded[i] for i in idx], X)


def test_decode_kernel_matches_plain_version_on_the_lt_sets():
    """Config 4's shards (2048 x 16384, k=8, code seed 0): the 0/1 sets
    ``decode_rows`` picks from fresh sets that first peel in seeded
    arrival orders without the stragglers 3 and 11."""
    import numpy as np
    from types import SimpleNamespace

    from mpistragglers_jl_tpu_torch.ops.coded_gemm import LTCodedGemm

    dev = _card()
    lt = LTCodedGemm(np.zeros((8, 2), np.float32), 16, 8,
                     devices=[torch.device("cpu")], seed=0)
    lt.backend.shutdown()
    G = lt.code.generator_rows(lt.shard_ids)
    X, coded = _decode_case(dev, G, 2048, 16384, 1)
    sets = set()
    for seed in range(12):
        order = [int(i) for i in np.random.default_rng(seed).permutation(16)
                 if i not in (3, 11)]
        for m in range(8, len(order) + 1):
            fresh = np.sort(np.asarray(order[:m]))
            if lt.code.peelable([lt.shard_ids[i] for i in fresh]):
                break
        pool = SimpleNamespace(fresh_indices=lambda epoch=None: fresh,
                               epoch=1)
        sets.add(tuple(lt.decode_rows(pool)))
    assert len(sets) >= 6
    for rows in sorted(sets):
        _check_decode_kernel(G[list(rows)], [coded[i] for i in rows], X)


def test_decode_kernel_reads_shards_where_they_lie():
    """A non-contiguous selection of a fused stack's rows and the same
    shards as separate allocations at unrelated addresses decode to the
    same bits (the kernel reads values, not a layout)."""
    from mpistragglers_jl_tpu_torch.ops import decode_solve as ds
    from mpistragglers_jl_tpu_torch.ops.coding import MDSCode

    dev = _card()
    G = MDSCode(8, 6).G
    _, stacked = _decode_case(dev, G, 256, 1024, 2)
    idx = [0, 2, 3, 5, 6, 7]
    views = [stacked[i] for i in idx]
    apart = []
    for i in idx:
        torch.empty(1 + 1000 * i, device=dev)  # shift the allocator
        apart.append(stacked[i].clone())
    a = ds.decode_solve(views, G[idx])
    b = ds.decode_solve(apart, G[idx])
    assert torch.equal(a, b)


@pytest.mark.parametrize("code", ["mds", "mds_coalesced", "lt"])
def test_result_device_launches_one_decode_kernel_each(code):
    """One ``LAUNCHES["decode_solve"]`` per ``result_device`` on f32
    shards, each product within 1e-5 x cond(G_S) of the f32 product;
    f64 shards keep ``_decode`` and launch none."""
    import numpy as np

    from mpistragglers_jl_tpu_torch import AsyncPool, asyncmap, waitall
    from mpistragglers_jl_tpu_torch.ops import decode_solve as ds
    from mpistragglers_jl_tpu_torch.ops.coded_gemm import (
        CodedGemm,
        LTCodedGemm,
    )

    dev = _card()
    rng = np.random.default_rng(4)
    A = rng.standard_normal((1536, 512)).astype(np.float32)
    B = rng.standard_normal((512, 256)).astype(np.float32)
    want = A.astype(np.float64) @ B
    for dtype, launches in ((np.float32, 3), (np.float64, 0)):
        Bd = B.astype(dtype)
        if code == "lt":
            g, n = LTCodedGemm(A, 16, 8, devices=[dev], dtype=dtype), 16
        else:
            g, n = CodedGemm(A, 8, 6, devices=[dev], dtype=dtype,
                             batch=code == "mds_coalesced"), 8
        before = ds.LAUNCHES["decode_solve"]
        try:
            pool = AsyncPool(n)
            for _ in range(3):
                asyncmap(pool, Bd, g.backend, nwait=n)
                got = g.result_device(pool).cpu().double().numpy()
                err = np.abs(got - want).max() / np.abs(want).max()
                assert err <= 1e-5 * 852, err
            waitall(pool, g.backend)
        finally:
            g.backend.shutdown()
        assert ds.LAUNCHES["decode_solve"] - before == launches


@pytest.mark.parametrize("case,match", [
    ("k17", "k <= 16"),
    ("f64", "f32 shards"),
    ("transposed", "not contiguous"),
])
def test_decode_kernel_rejects_what_it_cannot_take(case, match):
    import numpy as np

    from mpistragglers_jl_tpu_torch.ops import decode_solve as ds

    dev = _card()
    k = 17 if case == "k17" else 6
    G_S = np.eye(k) + 0.1 * np.random.default_rng(0).standard_normal((k, k))
    base = torch.randn(k, 64, 64, device=dev)
    if case == "f64":
        shards = list(base.double())
    elif case == "transposed":
        shards = [s.t() for s in base]
    else:
        shards = list(base)
    before = ds.LAUNCHES["decode_solve"]
    with pytest.raises(ValueError, match=match):
        ds.decode_solve(shards, G_S)
    assert ds.LAUNCHES["decode_solve"] == before


@pytest.mark.parametrize("case", ["misaligned", "ragged", "stack_of_3x3"])
def test_decode_kernel_serves_any_shape_and_alignment(case):
    """The float instance: shards 4 bytes off 16-byte alignment, shards
    of 9 elements apart and as rows of one stack (each row 36 bytes on),
    within 1e-5 x cond(G_S) of the plain version (the tolerance of the
    float4 cases above: the same arithmetic)."""
    from mpistragglers_jl_tpu_torch.ops import decode_solve as ds
    from mpistragglers_jl_tpu_torch.ops.coding import MDSCode

    dev = _card()
    G = MDSCode(8, 6).G
    idx = [0, 2, 3, 5, 6, 7]
    rows, cols = {"misaligned": (64, 64), "ragged": (3, 3),
                  "stack_of_3x3": (3, 3)}[case]
    X, coded = _decode_case(dev, G, rows, cols, 5)
    if case == "misaligned":
        flat = torch.empty(8 * rows * cols + 1, device=dev)
        flat[1:].copy_(coded.reshape(-1))
        coded = flat[1:].view(8, rows, cols)
        shards = [coded[i] for i in idx]
    elif case == "ragged":
        shards = [coded[i].clone() for i in idx]
    else:
        shards = [coded[i] for i in idx]
    _check_decode_kernel(G[idx], shards, X)


@pytest.mark.parametrize("batch", [True, False])
def test_result_device_decodes_3x3_shards_on_the_card(batch):
    """``CodedGemm`` of an 18 x 5 A over (8, 6) times a 5 x 3 B: 3 x 3
    shards, from one fused stack or from each worker, workers 1 and 4
    left out of the fresh set so that two parity shards enter the
    solve; the kernel's float instance decodes within 1e-5 x cond(G_S)
    of the float64 product, one launch a decode."""
    import numpy as np

    from mpistragglers_jl_tpu_torch import AsyncPool, asyncmap, waitall
    from mpistragglers_jl_tpu_torch.ops import decode_solve as ds
    from mpistragglers_jl_tpu_torch.ops.coded_gemm import CodedGemm

    dev = _card()
    rng = np.random.default_rng(6)
    A = rng.standard_normal((18, 5)).astype(np.float32)
    B = rng.standard_normal((5, 3)).astype(np.float32)
    want = A.astype(np.float64) @ B
    g = CodedGemm(A, 8, 6, devices=[dev], batch=batch)
    cond = np.linalg.cond(g.code.G[[0, 2, 3, 5, 6, 7]].astype(np.float64))
    before = ds.LAUNCHES["decode_solve"]
    try:
        pool = AsyncPool(8)
        for _ in range(2):
            asyncmap(pool, B, g.backend, nwait=8)
            pool.repochs[[1, 4]] = pool.epoch - 1
            got = g.result_device(pool).cpu().double().numpy()
            assert got.shape == want.shape
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= 1e-5 * cond, err
        waitall(pool, g.backend)
    finally:
        g.backend.shutdown()
    assert ds.LAUNCHES["decode_solve"] - before == 2


# -- slice 9: the mixture of experts and coded training on the card.
# f32 with TF32 off: the MoE layer within 1e-5 of the largest value of
# the CPU result (cuBLAS and the CPU sum in other orders), gradients
# within 1e-4 of the largest value; the coded step's parameters within
# 1e-5 absolute + 1e-4 relative of the CPU step's (flash kernels against
# their plain versions, 2e-5 and 5e-5 bounds, scaled by lr).


def _max_close(got, want, tol, what):
    scale = want.abs().max().clamp_min(1e-30)
    err = ((got.cpu() - want).abs().max() / scale).item()
    assert err <= tol, f"{what}: {err} of the largest value"


def test_moe_gather_form_on_the_card_equals_the_cpu():
    """moe_ffn_dense's y, aux and gradients (x, router, experts) on the
    card against the CPU, at a capacity that drops tokens; the routing
    (experts, slots, table) bit-equal."""
    import numpy as np

    from mpistragglers_jl_tpu_torch.models import moe as tm

    dev = _card()
    rng = np.random.default_rng(5)
    mp = tm.init_moe_layer(rng, 128, 256, n_experts=4, n_layers=2,
                           dtype=torch.float32)
    mp["wg"] = torch.from_numpy(rng.standard_normal((128, 4))).float()
    mp["be1"] = torch.from_numpy(rng.standard_normal((4, 256)) * 0.1).float()
    mp["be2"] = torch.from_numpy(rng.standard_normal((4, 128)) * 0.1).float()
    x = torch.from_numpy(rng.standard_normal((2, 96, 128))).float()
    out = {}
    for d in (torch.device("cpu"), dev):
        leaves = {k: v.to(d).requires_grad_() for k, v in mp.items()}
        xd = x.to(d).requires_grad_()
        routing = tm._route_tables(xd.reshape(-1, 128).detach(),
                                   leaves["wg"].detach(), 48)
        y, aux = tm.moe_ffn_dense(xd, leaves, capacity_factor=1.0)
        grads = torch.autograd.grad((y ** 2).sum() + aux,
                                    [xd] + [leaves[k] for k in sorted(mp)])
        out[d.type] = ([r.cpu() for r in routing[:3]], y.detach().cpu(),
                       aux.detach().cpu(), [g.cpu() for g in grads])
    (rc, yc, ac, gc), (rg, yg, ag, gg) = out["cpu"], out["cuda"]
    for a, b in zip(rg, rc):
        assert torch.equal(a, b)
    assert (rc[2] >= 48).any(), "no token dropped at capacity 48"
    _max_close(yg, yc, 1e-5, "y")
    assert abs(ag.item() - ac.item()) <= 1e-6
    for name, a, b in zip(["x"] + sorted(mp), gg, gc):
        _max_close(a, b, 1e-4, f"grad {name}")


def test_coded_step_on_the_card_equals_the_cpu_step():
    """One coded step of a tiny flash transformer over 3 CUDA-stream
    workers (s = 1), against the same step on the CPU route."""
    import numpy as np

    from mpistragglers_jl_tpu_torch import AsyncPool, waitall
    from mpistragglers_jl_tpu_torch.models import coded_train as tct
    from mpistragglers_jl_tpu_torch.models.transformer import _leaves

    dev = _card()
    cfg = TransformerConfig(vocab=97, d_model=128, n_heads=2, n_layers=2,
                            d_ff=256, attn="ulysses", attn_impl="flash")

    def chunk(j):
        return np.random.default_rng((3, j)).integers(0, 97, (2, 65))

    got = {}
    for d in (torch.device("cpu"), dev):
        params = init_params(cfg, seed=1, device=d)
        tr = tct.CodedGradTrainer(tct.transformer_chunk_loss(cfg), params,
                                  chunk, 3, 1, devices=[d])
        try:
            pool = AsyncPool(3)
            new = tr.step(pool, params, lr=0.1, nwait=3)
            waitall(pool, tr.backend)
        finally:
            tr.backend.shutdown()
        got[d.type] = [p.cpu() for p in _leaves(new)]
        assert all(p.device.type == d.type for p in _leaves(new))
    for a, b in zip(got["cuda"], got["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


def test_worker_backward_runs_on_the_worker_stream():
    """Two pool workers each take a flash-attention gradient in their
    dispatcher thread: the backward (K2, K3 and a probe node) runs on
    that worker's stream, and the coordinator reads each gradient on the
    default stream through consume, equal to the CPU's."""
    import threading

    from mpistragglers_jl_tpu_torch import (AsyncPool, CUDADeviceBackend,
                                            asyncmap)
    from mpistragglers_jl_tpu_torch.backends.cuda import consume

    dev = _card()
    seen = {}
    lock = threading.Lock()

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, i):
            ctx.i = i
            return q.clone()

        @staticmethod
        def backward(ctx, g):
            with lock:
                seen[ctx.i] = torch.cuda.current_stream().cuda_stream
            return g, None

    def grad_of(x, i):
        q = x.reshape(1, 256, 2, 64)
        k, v = q * 0.5, q.flip(1)
        o = fa.flash_attention(Probe.apply(q, i) if x.is_cuda else q, k, v,
                               causal=True)
        return torch.autograd.grad((o * o).sum(), x)[0]

    def work(i, payload, epoch):
        x = (payload * (i + 1)).detach().requires_grad_(True)
        with torch.enable_grad():
            return grad_of(x, i)

    backend = CUDADeviceBackend(work, 2, devices=[dev])
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(256 * 2 * 64, generator=gen)
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    try:
        pool = AsyncPool(2)
        asyncmap(pool, x.to(dev), backend, nwait=2)
        streams = [backend.stream(i).cuda_stream for i in range(2)]
        assert seen == {0: streams[0], 1: streams[1]}
        assert torch.cuda.current_stream().cuda_stream not in streams
        assert fa.LAUNCHES["flash_bwd_dq"] == 2
        assert fa.LAUNCHES["flash_bwd_dkv"] == 2
        for i in range(2):
            got = consume(pool.results[i])
            xi = (x * (i + 1)).requires_grad_(True)
            want = grad_of(xi, i)
            torch.testing.assert_close(got.cpu(), want, atol=5e-5,
                                       rtol=5e-5)
    finally:
        backend.shutdown()


# --------------------------------------------------------------------------
# the sampling kernel (ops/csrc/sampling.cu)
# --------------------------------------------------------------------------


def _sampling_case(R, V, dtype, dev, seed=0):
    from mpistragglers_jl_tpu_torch.utils import prng

    gen = torch.Generator().manual_seed(seed)
    logits = (torch.randn(R, V, generator=gen) * 3).to(dtype).to(dev)
    keys = torch.stack([prng.key(1000 + r) for r in range(R)]).to(dev)
    pos = torch.arange(R, dtype=torch.int32, device=dev) * 37 + 5
    rows = torch.zeros(R, dtype=torch.int32, device=dev)
    return logits, pos, keys, rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k", [None, 1, 5, 50])
def test_sampling_kernel_bits_noise_and_tokens_equal_plain(dtype, top_k):
    """At the serving shape (8 rows of 32768): every entry's bits and
    Gumbel noise bit-equal to the plain chain's (on the card and on the
    CPU), the tokens equal."""
    from mpistragglers_jl_tpu_torch.ops import sampling
    from mpistragglers_jl_tpu_torch.utils import prng

    dev = _card()
    R, V = 8, 32768
    logits, pos, keys, rows = _sampling_case(R, V, getattr(torch, dtype),
                                             dev)
    bits = torch.empty(R, V, dtype=torch.int32, device=dev)
    noise = torch.empty(R, V, dtype=torch.float32, device=dev)
    got = sampling.sample_rows(logits, pos, keys, rows, 0.8, top_k,
                               bits_out=bits, noise_out=noise)
    torch.cuda.synchronize()
    k = prng.fold_in(prng.fold_in(keys, pos), rows)
    want_bits = prng.bits(k, (V,))
    assert torch.equal(bits.long() & 0xFFFFFFFF, want_bits)
    want_noise = prng.gumbel(k, (V,))
    assert torch.equal(noise.view(torch.int32), want_noise.view(torch.int32))
    cpu = prng.gumbel(k.cpu(), (V,))
    assert torch.equal(want_noise.cpu().view(torch.int32),
                       cpu.view(torch.int32))
    want = sampling.sample_rows_ref(logits, pos, keys, rows, 0.8, top_k)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if top_k == 1:  # a row's largest logit (bf16 logits may tie)
        top = logits.gather(1, got.long()[:, None])[:, 0]
        assert torch.equal(top, logits.max(dim=-1).values)


def test_sampling_kernel_captures_into_a_graph():
    """One call captured into a CUDA graph replays equal to the eager
    call; neither capture nor replays add to the count."""
    from mpistragglers_jl_tpu_torch.ops import sampling

    dev = _card()
    logits, pos, keys, rows = _sampling_case(8, 32768, torch.bfloat16, dev,
                                             seed=3)
    eager = sampling.sample_rows(logits, pos, keys, rows, 0.8, 50)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sampling.sample_rows(logits, pos, keys, rows, 0.8, 50)
    torch.cuda.current_stream().wait_stream(side)
    sampling.LAUNCHES["sample_rows"] = 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sampling.sample_rows(logits, pos, keys, rows, 0.8, 50)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert sampling.LAUNCHES["sample_rows"] == 0
    pos += 1  # the graph reads the positions from the device
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, sampling.sample_rows(logits, pos, keys, rows,
                                                 0.8, 50))


def test_sampling_op_raises_instead_of_falling_back(monkeypatch):
    """On CUDA tensors the op launches its kernel or raises: a type the
    kernel does not take, and a refused launch, never reach the plain
    chain."""
    from mpistragglers_jl_tpu_torch.ops import sampling

    dev = _card()
    logits, pos, keys, rows = _sampling_case(8, 1000, torch.float32, dev)

    def plain(*a, **k):
        raise AssertionError("fell back to the plain chain")

    monkeypatch.setattr(sampling, "sample_rows_ref", plain)
    with pytest.raises(ValueError, match="f32 or bf16"):
        sampling.sample_rows(logits.half(), pos, keys, rows, 0.8)
    lib = sampling._kernel_lib()

    class Refusing:
        sampling_error_string = lib.sampling_error_string

        @staticmethod
        def sample_rows(*args):
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(sampling, "_kernel_lib", lambda: Refusing)
    n = sampling.LAUNCHES["sample_rows"]
    with pytest.raises(RuntimeError, match="launch failed"):
        sampling.sample_rows(logits, pos, keys, rows, 0.8)
    assert sampling.LAUNCHES["sample_rows"] == n


def test_sampled_serving_launches_the_kernel_per_step():
    """A sampled int8 scheduler on the card: one sampling launch per
    inner step and one per admission, its slot stream equal to the
    card's own generate_ring_dense with the request's key."""
    from mpistragglers_jl_tpu_torch.ops import sampling
    from mpistragglers_jl_tpu_torch.utils import prng

    dev = _card()
    cfg = TransformerConfig(vocab=97, d_model=256, n_heads=2, n_kv_heads=1,
                            n_layers=2, d_ff=256, attn_window=64,
                            dtype=torch.float32)
    params = init_params(cfg, 0, device=dev)
    sched = ServingScheduler(params, cfg, slots=4, n_inner=8,
                             prompt_chunk=16, max_prompt=32,
                             quantize_kv=True, temperature=0.8, top_k=5,
                             device=dev)
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, 97, (n,), generator=gen).numpy()
               for n in (9, 20, 5, 31)]
    sampling.LAUNCHES["sample_rows"] = 0
    reqs = [sched.submit(p, 24, key=prng.key(50 + i))
            for i, p in enumerate(prompts)]
    sched.run()
    assert sampling.LAUNCHES["sample_rows"] == (
        len(reqs) + sched.decode_ticks * sched.n_inner)
    for i, r in enumerate(reqs):
        want = td.generate_ring_dense(params, r.prompt[None], 24, cfg,
                                      temperature=0.8, top_k=5,
                                      key=prng.key(50 + i),
                                      quantize_kv=True, device=dev)
        assert r.tokens == want[0].tolist(), i


def test_rateless_shard_joins_the_set_only_after_its_product(monkeypatch):
    """Worker 1's product is held back on its stream (``torch.cuda._sleep``
    before the matmul): the decodability predicate does not count its
    shard while the stream is still busy, only once its work is done."""
    import time

    import numpy as np

    from mpistragglers_jl_tpu_torch.ops import rateless as trl

    dev = _card()
    A = np.random.default_rng(0).standard_normal((2048, 2048)).astype(
        np.float32)
    B = torch.randn(2048, 2048, device=dev)
    rg = trl.RatelessLTGemm(A, 2, 1, devices=[dev])
    real = trl._block_matmul

    def held(block, payload, precision):
        if torch.cuda.current_stream(dev) == rg.backend.stream(1):
            torch.cuda._sleep(int(1e9))  # ~0.5 s of the worker's stream
        return real(block, payload, precision)

    monkeypatch.setattr(trl, "_block_matmul", held)
    try:
        rg._live_epoch = 1
        pred = rg.nwait(1)
        stream = rg.backend.stream(1)
        rg.backend.dispatch(1, B, 1)
        saw_busy, deadline = False, time.perf_counter() + 30
        while not pred(1, None):
            saw_busy |= not stream.query()
            assert time.perf_counter() < deadline
        assert stream.query(), "the shard was counted before its product"
        assert saw_busy, "the held product never showed a busy stream"
        sid, out = rg.backend.wait(1, timeout=30)
        assert sid == 1
        torch.testing.assert_close(out, torch.from_numpy(A).to(dev) @ B,
                                   rtol=1e-4, atol=1e-2)
    finally:
        rg.backend.shutdown()


@pytest.mark.parametrize("method", ["bitslice", "gather"])
def test_gf256_matmul_on_the_card_equals_the_cpu(method):
    """Byte-equal: the same torch integer ops on the card and the CPU."""
    from mpistragglers_jl_tpu_torch.ops.gf256_device import (
        DeviceRSGF256,
        gf256_matmul,
    )

    dev = _card()
    gen = torch.Generator().manual_seed(7)
    M = torch.randint(0, 256, (8, 6), generator=gen, dtype=torch.uint8)
    D = torch.randint(0, 256, (6, 100_003), generator=gen, dtype=torch.uint8)
    got = gf256_matmul(M.to(dev), D.to(dev), method=method)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), gf256_matmul(M, D, method=method))
    rs = DeviceRSGF256(8, 6, method=method, device=dev)
    coded = rs.encode(D.to(dev))
    idx = [7, 1, 2, 4, 5, 6]
    assert torch.equal(rs.decode(coded[idx], idx).cpu(), D)


def test_batched_inner_solve_equals_per_group_solves():
    """The hierarchical decode's batched LU solve (row gather by advanced
    indexing, batched triangular solves) against the 2-D solve per group
    on the card, and against the CPU: f32 with TF32 off, the two sum in
    other orders, so within 1e-5 x cond(G_g) of the largest entry."""
    from mpistragglers_jl_tpu_torch.ops.coding import _lu_solve
    from mpistragglers_jl_tpu_torch.ops.hierarchical import decode_groups

    dev = _card()
    gen = torch.Generator().manual_seed(3)
    G = torch.randn(3, 6, 6, generator=gen)
    shards = torch.randn(3, 6, 512, 1024, generator=gen)
    got = decode_groups(G.to(dev), shards.to(dev))
    cpu = decode_groups(G, shards)
    for g in range(3):
        want = _lu_solve(G[g].to(dev), shards[g].to(dev).reshape(6, -1))
        limit = 1e-5 * float(torch.linalg.cond(G[g].double()))
        for other in (want.reshape(got[g].shape), cpu[g].to(dev)):
            err = (got[g] - other).abs().max() / other.abs().max()
            assert float(err) <= limit, (g, float(err), limit)


# -- worker processes on the card (host backends) ---------------------------


def _echo(i, payload, epoch):
    return payload


class _Gate:
    """A delay_fn that holds a worker, before it reads its payload,
    until the file ``path`` exists (a gate across processes)."""

    def __init__(self, path):
        self.path = str(path)

    def __call__(self, i, epoch):
        import os
        import time

        deadline = time.monotonic() + 60.0
        while not os.path.exists(self.path):
            if time.monotonic() > deadline:
                raise TimeoutError(f"gate {self.path} never opened")
            time.sleep(0.005)
        return 0.0


def _cuda_result(i, payload, epoch):
    """A worker's tensors made on its card from a seed: the coordinator
    makes the same ones and compares bits."""
    g = torch.Generator(device="cuda").manual_seed(100 + i)
    x = torch.randn(payload["n"], generator=g, device="cuda")
    return {"f32": x, "bf16": x.to(torch.bfloat16),
            "i64": (x * 1e6).to(torch.int64)}[payload["kind"]]


def _host_backend(kind, work, n, **kw):
    from mpistragglers_jl_tpu_torch.backends.native import (
        NativeProcessBackend,
    )
    from mpistragglers_jl_tpu_torch.backends.process import ProcessBackend

    return {"process": ProcessBackend,
            "native": NativeProcessBackend}[kind](work, n, **kw)


@pytest.mark.parametrize("kind", ["process", "native"])
def test_process_workers_multiply_on_the_card(kind):
    """2 spawned workers, each with its own CUDA context, multiply row
    blocks of config 2's operands on the card (``bench/process_gemm.py``
    at m=2048): the gathered product is within config 2's
    ``REL_TOL["highest"]`` of one in-process ``torch.matmul``, and equal
    bit for bit across epochs."""
    from mpistragglers_jl_tpu_torch.bench import process_gemm

    _card()
    (res,) = process_gemm.run([kind], m=2048, n_workers=2, epochs=2,
                              chains=1)
    assert res["rel_err"] <= res["rel_tol"], res
    assert res["bit_equal_across_epochs"], res
    assert res["worker_tasks"] >= 6, res
    print(kind, "bit-equal to the in-process product:",
          res["bit_equal_to_reference"])


@pytest.mark.parametrize("kind", ["process", "native"])
@pytest.mark.parametrize("n", [64, 1 << 20])
def test_cuda_sendbuf_mutated_after_asyncmap_is_not_seen(kind, n,
                                                         tmp_path):
    """A CUDA-tensor ``sendbuf`` crosses as a host copy taken at
    dispatch: the workers are held at a gate before they read, the
    caller overwrites the tensor right after ``asyncmap`` and then opens
    the gate, and the workers still echo the values it had."""
    from mpistragglers_jl_tpu_torch import AsyncPool, asyncmap, waitall

    dev = _card()
    t = torch.arange(n, dtype=torch.float32, device=dev)
    want = t.cpu().numpy().copy()
    gate = tmp_path / "open"
    backend = _host_backend(kind, _echo, 2, delay_fn=_Gate(gate))
    try:
        pool = AsyncPool(2)
        asyncmap(pool, t, backend, nwait=0)
        t.fill_(-1.0)
        torch.cuda.synchronize()
        gate.touch()
        waitall(pool, backend)
        for r in pool.results:
            assert r.dtype == want.dtype and r.tobytes() == want.tobytes()
    finally:
        gate.touch()
        backend.shutdown()


@pytest.mark.parametrize("kind", ["process", "native"])
def test_worker_cuda_results_arrive_bit_equal(kind):
    """A worker's CUDA tensors (f32, bf16, int64; in band and through
    the result rings) arrive on the host with their bits, after the
    worker that made them has exited."""
    from mpistragglers_jl_tpu_torch import AsyncPool, asyncmap, waitall

    _card()
    backend = _host_backend(kind, _cuda_result, 2)
    got = {}
    try:
        pool = AsyncPool(2)
        for kind_, n in (("f32", 16), ("bf16", 1 << 20), ("i64", 1 << 18)):
            asyncmap(pool, {"kind": kind_, "n": n}, backend, nwait=2)
            waitall(pool, backend)
            got[kind_, n] = list(pool.results)
    finally:
        backend.shutdown()
    for (kind_, n), results in got.items():
        for i, r in enumerate(results):
            want = _cuda_result(i, {"kind": kind_, "n": n}, 0).cpu()
            have = (r.view(torch.uint8).numpy().tobytes()
                    if isinstance(r, torch.Tensor) else r.tobytes())
            assert have == want.view(torch.uint8).numpy().tobytes(), kind_


def test_train_checkpoint_bf16_round_trip_on_the_card(tmp_path):
    """bf16 parameters and an AdamW state on the card through
    ``TrainCheckpointer``: restored with the target's dtype and device,
    every leaf bit-equal, and the resumed step equal to the
    uninterrupted one bit for bit."""
    from mpistragglers_jl_tpu_torch.models.transformer import (
        _leaves,
        adamw,
        make_optax_train_step,
    )
    from mpistragglers_jl_tpu_torch.utils import TrainCheckpointer

    dev = _card()
    cfg = TransformerConfig(vocab=64, d_model=256, n_heads=2, n_layers=2,
                            d_ff=512, dtype=torch.bfloat16,
                            attn="ulysses", attn_impl="flash")
    params = init_params(cfg, seed=1, device=dev)
    tok = torch.randint(0, cfg.vocab, (2, 129),
                        generator=torch.Generator().manual_seed(2))
    inp, tgt = tok[:, :-1].to(dev), tok[:, 1:].to(dev)
    step, init_state = make_optax_train_step(cfg, tx=adamw(3e-4))
    opt = init_state(params)
    params, opt, _ = step(params, opt, inp, tgt)
    ckpt = TrainCheckpointer(tmp_path / "ck")
    ckpt.save(1, {"params": params, "opt": opt.state_dict()})
    like = init_params(cfg, seed=9, device=dev)
    state, _, _ = ckpt.restore(1)
    back, _, _ = ckpt.restore(1, target={"params": like,
                                         "opt": state["opt"]})
    for a, b in zip(_leaves(back["params"]), _leaves(params)):
        assert a.device == b.device and a.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    opt2 = init_state(back["params"])
    opt2.load_state_dict(state["opt"])
    want, _, loss_w = step(params, opt, inp, tgt)
    got, _, loss_g = step(back["params"], opt2, inp, tgt)
    assert torch.equal(loss_g, loss_w)
    for a, b in zip(_leaves(got), _leaves(want)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_qos_paged_scheduler_matches_oracle_on_the_card():
    """A two-tenant ``qos=`` paged scheduler on the card through K6:
    every greedy stream equals ``generate_ring_dense``, the first
    admissions follow the 2:1 weights and the pool checks."""
    from mpistragglers_jl_tpu_torch.qos import TenantContract, TenantRegistry

    dev = _card()
    cfg = TransformerConfig(vocab=128, d_model=512, n_heads=4,
                            n_kv_heads=2, n_layers=2, d_ff=1024,
                            attn_window=64, dtype=torch.float32)
    params = init_params(cfg, seed=3, device=dev)
    reg = TenantRegistry([TenantContract("gold", weight=2.0),
                          TenantContract("bronze", weight=1.0, pages=6)])
    sched = ServingScheduler(params, cfg, slots=4, n_inner=8,
                             prompt_chunk=16, max_prompt=48, page_tokens=8,
                             quantize_kv=True, qos=reg, device=dev)
    assert sched.use_kernel
    gen = torch.Generator().manual_seed(4)
    work = [(t, torch.randint(1, cfg.vocab, (int(n),), generator=gen)
             .numpy()) for t, n in zip(["gold"] * 4 + ["bronze"] * 4,
                                       [9, 17, 12, 20, 11, 15, 24, 8])]
    admitted, real = [], sched._admit_into

    def spy(s, req, plan, retired):
        admitted.append(req.tenant)
        return real(s, req, plan, retired)

    sched._admit_into = spy
    reqs = [sched.submit(p, max_new=12, tenant=t) for t, p in work]
    sched.run()
    for (_, p), r in zip(work, reqs):
        want = td.generate_ring_dense(params, p[None], 12, cfg,
                                      quantize_kv=True, device=dev)
        assert r.tokens == want[0].tolist()
    assert admitted[:3] == ["gold", "gold", "bronze"], admitted
    sched.pool.check()


def _small_paged(dev, **kw):
    cfg = TransformerConfig(vocab=128, d_model=512, n_heads=4,
                            n_kv_heads=2, n_layers=2, d_ff=1024,
                            attn_window=64, dtype=torch.float32)
    params = init_params(cfg, seed=5, device=dev)
    return cfg, params, dict(slots=4, n_inner=4, prompt_chunk=16,
                             max_prompt=48, page_tokens=8,
                             quantize_kv=True, device=dev, **kw)


def test_migration_on_the_card_through_k6_equals_oracle():
    """Four requests (two on one 16-token prefix) migrate from a
    PrefillWorker to a DecodeReplica at their first token, in process
    and through the migration ring: every stream equals
    ``generate_ring_dense``, the destination's ticks launch K6 and
    never K5, and both pools drain."""
    from mpistragglers_jl_tpu_torch.models.disagg import (
        DecodeReplica, MigrationPlanner, MigrationRing, MigrationRingReader,
        MigrationTicket, PrefillWorker, ticket_from_frames, ticket_to_frames)

    dev = _card()
    cfg, params, kw = _small_paged(dev)
    planner = MigrationPlanner()
    pw = PrefillWorker(ServingScheduler(params, cfg, **kw), planner=planner)
    dr = DecodeReplica(ServingScheduler(params, cfg, **kw), planner=planner)
    assert dr.use_kernel
    gen = torch.Generator().manual_seed(6)
    prefix = torch.randint(1, cfg.vocab, (16,), generator=gen)
    prompts = [torch.cat([prefix, torch.randint(1, cfg.vocab, (8,),
                                                generator=gen)]).numpy()
               for _ in range(2)]
    prompts += [torch.randint(1, cfg.vocab, (24,), generator=gen).numpy()
                for _ in range(2)]
    ring = MigrationRing(slot_bytes=1 << 16, slots=16)
    reader = MigrationRingReader(ring)
    reqs = [pw.submit(p, max_new=16) for p in prompts]
    moved, dst_k6 = set(), 0
    for c in da.LAUNCHES:
        da.LAUNCHES[c] = 0
    while not all(r.finished for r in reqs):
        pw.step()
        for r in pw.ready():
            if r.id in moved:
                continue
            moved.add(r.id)
            if len(moved) % 2:
                dr.adopt(pw.migrate_out(r))
            else:
                t = MigrationTicket(pw.sched.export_page_state(r))
                meta = ticket_to_frames(t, ring)
                dr.adopt(ticket_from_frames(meta, t.frames, reader),
                         request=r)
                t.release()
        k0 = da.LAUNCHES["paged_decode_attention"]
        dr.step()
        dst_k6 += da.LAUNCHES["paged_decode_attention"] - k0
    assert len(moved) == 4
    assert dst_k6 == cfg.n_layers * dr.n_inner * dr.decode_ticks > 0
    assert da.LAUNCHES["quantized_decode_attention"] == 0
    for p, r in zip(prompts, reqs):
        want = td.generate_ring_dense(params, p[None], 16, cfg,
                                      quantize_kv=True, device=dev)
        assert r.tokens == want[0].tolist()
    assert dr.pool.share_hits > 0
    for pool in (pw.pool, dr.pool):
        pool.check()
        assert pool.used == 0


def test_dram_fetch_on_the_card_equals_oracle():
    """Replica A serves a prompt and retires it (its prefix pages spill
    to host DRAM) and is killed; replica B fetches the pages onto the
    card and decodes through K6: B's stream equals
    ``generate_ring_dense``, with fewer prefill chunks than A."""
    from mpistragglers_jl_tpu_torch.cache import FleetPrefixCache

    dev = _card()
    hub = FleetPrefixCache(store_pages=16)
    cfg, params, kw = _small_paged(dev, cache=hub)
    gen = torch.Generator().manual_seed(7)
    prefix = torch.randint(1, cfg.vocab, (32,), generator=gen)
    prompts = [torch.cat([prefix, torch.randint(1, cfg.vocab, (8,),
                                                generator=gen)]).numpy()
               for _ in range(2)]
    a = ServingScheduler(params, cfg, **kw)
    ra = a.submit(prompts[0], max_new=12)
    a.run()
    hub.kill(a.cache_name)
    b = ServingScheduler(params, cfg, **kw)
    assert b.use_kernel
    k0 = da.LAUNCHES["paged_decode_attention"]
    rb = b.submit(prompts[1], max_new=12)
    b.run()
    assert da.LAUNCHES["paged_decode_attention"] - k0 == (
        cfg.n_layers * b.n_inner * b.decode_ticks)
    assert hub.n_fetches["dram"] == 4 and hub.n_fallbacks == 0
    assert b.prefill_chunks < a.prefill_chunks
    for p, r in zip(prompts, (ra, rb)):
        want = td.generate_ring_dense(params, p[None], 12, cfg,
                                      quantize_kv=True, device=dev)
        assert r.tokens == want[0].tolist()
    b.pool.check()
    hub.check()
    hub.close()


@pytest.mark.parametrize("policy", ["least_loaded", "prefix_affinity"])
def test_router_over_paged_replicas_on_the_card_equals_oracle(policy):
    """A router over two paged schedulers on the card: six requests
    (three on one 16-token prefix, the first given its first token
    before the others arrive) all equal ``generate_ring_dense``, every
    replica's decode ticks launch K6 and never K5, ``prefix_affinity``
    lands the sharers on the pages' replica, and both pools drain."""
    from mpistragglers_jl_tpu_torch.models.router import RequestRouter

    dev = _card()
    cfg, params, kw = _small_paged(dev)
    scheds = [ServingScheduler(params, cfg, **kw) for _ in range(2)]
    assert all(s.use_kernel for s in scheds)
    router = RequestRouter(scheds, policy=policy)
    gen = torch.Generator().manual_seed(9)
    prefix = torch.randint(1, cfg.vocab, (16,), generator=gen)
    prompts = [torch.cat([prefix, torch.randint(1, cfg.vocab, (8,),
                                                generator=gen)]).numpy()
               for _ in range(3)]
    prompts += [torch.randint(1, cfg.vocab, (24,), generator=gen).numpy()
                for _ in range(3)]
    for c in da.LAUNCHES:
        da.LAUNCHES[c] = 0
    first = router.submit(prompts[0], max_new=16)
    while not first.tokens:
        router.step()
    rrs = [first] + [router.submit(p, max_new=16) for p in prompts[1:]]
    router.drain()
    assert da.LAUNCHES["paged_decode_attention"] > 0
    assert da.LAUNCHES["quantized_decode_attention"] == 0
    for p, rr in zip(prompts, rrs):
        want = td.generate_ring_dense(params, p[None], 16, cfg,
                                      quantize_kv=True, device=dev)
        assert rr.finished and list(rr.tokens) == want[0].tolist()
    if policy == "prefix_affinity":
        assert {rr.replica for rr in rrs[:3]} == {first.replica}
        assert scheds[first.replica].pool.share_hits > 0
    for s in scheds:
        s.pool.check()
        assert s.pool.used == 0


# -- fused K-epoch windows and the mesh plane on the card -------------------


def _window_case(dev, decode):
    """A straggling (8, 6) MDS, an LT or a hierarchical workload on the
    card, its coordinator, and the host loop's repochs over SimBackend
    on the same virtual schedule."""
    import numpy as np

    from mpistragglers_jl_tpu_torch import AsyncPool, SimBackend, asyncmap
    from mpistragglers_jl_tpu_torch.ops.coded_gemm import (
        CodedGemm,
        LTCodedGemm,
    )
    from mpistragglers_jl_tpu_torch.ops.hierarchical import (
        HierarchicalCodedGemm,
    )
    from mpistragglers_jl_tpu_torch.parallel.device_coord import (
        DeviceCoordinator,
    )
    from mpistragglers_jl_tpu_torch.utils import faults

    rng = np.random.default_rng(11)
    base = faults.seeded_lognormal(0.01, 0.6, seed=3)
    if decode == "hierarchical":
        A = rng.standard_normal((2 * 3 * 8, 64)).astype(np.float32)
        g = HierarchicalCodedGemm(A, groups=3, n_inner=4, k_inner=3,
                                  devices=[dev], device_backend=False)
        n = 12

        def delay(w, e):
            return base(w, e) + (50.0 if 4 <= w < 8 else 0.0)

        coord = DeviceCoordinator.for_hierarchical(g, delay_fn=delay)
        nwait = g.nwait
    else:
        n = 8
        A = rng.standard_normal((6 * 16, 64)).astype(np.float32)

        def delay(w, e):
            return base(w, e) + (0.04 if w == 5 else 0.0)

        if decode == "mds":
            g = CodedGemm(A, 8, 6, devices=[dev])
            nwait = 6
        else:
            g = LTCodedGemm(A, 8, 6, devices=[dev], seed=1)
            nwait = 8
        coord = g.coordinator(delay_fn=delay, nwait=nwait)
    B = rng.standard_normal((64, 24)).astype(np.float32)
    be = SimBackend(lambda i, p, e: p, n, delay_fn=delay)
    pool = AsyncPool(n)
    host = np.stack([asyncmap(pool, B, be, nwait=nwait).copy()
                     for _ in range(32)])
    return g, coord, A, B, host


@pytest.mark.parametrize("decode", ["mds", "lt", "hierarchical"])
def test_fused_window_on_the_card_equals_the_host_loop(decode):
    """Two back-to-back K=16 windows on cuda:0, each a replayed CUDA
    graph: ``repochs`` bit-equal to the host loop over SimBackend, and
    every epoch's decode within 1e-5 x cond of ``A @ B`` (f32, TF32
    off; the generator rows the decode solves with are at most 852
    apart in condition for the (8, 6) Cauchy code)."""
    import numpy as np

    from mpistragglers_jl_tpu_torch import AsyncPool, asyncmap_fused
    from mpistragglers_jl_tpu_torch.parallel.device_coord import _GraphWindow

    dev = _card()
    g, coord, A, B, host = _window_case(dev, decode)
    pool = AsyncPool(host.shape[1])
    fused, decs = [], []
    for _ in range(2):
        fused.append(asyncmap_fused(pool, B, coord, epochs=16))
        decs.append(coord.last_decoded.cpu().double().numpy())
    assert all(isinstance(p, _GraphWindow) and p.graph is not None
               for p in coord._programs.values())
    assert np.array_equal(np.concatenate(fused), host)
    want = A.astype(np.float64) @ B.astype(np.float64)
    rows = want.shape[0]
    for dec in decs:
        err = np.abs(dec[:, :rows] - want).max() / np.abs(want).max()
        assert err < 1e-5 * 852, err
    if g.backend is not None:
        g.backend.shutdown()


def test_graph_window_equals_the_eager_window():
    """The same window replayed from its CUDA graph and run eagerly on
    the card: the same ``repochs`` and the same decoded bits."""
    import numpy as np

    from mpistragglers_jl_tpu_torch import AsyncPool, asyncmap_fused

    dev = _card()
    g, coord, A, B, host = _window_case(dev, "mds")
    eager = g.coordinator(delay_fn=coord.delay_fn)
    eager._graph_windows = False
    outs = []
    for c in (coord, eager):
        pool = AsyncPool(8)
        hist = np.concatenate([asyncmap_fused(pool, B, c, epochs=8)
                               for _ in range(4)])
        outs.append((hist, c.last_decoded.cpu()))
    assert np.array_equal(outs[0][0], outs[1][0])
    assert np.array_equal(outs[0][0], host)
    assert torch.equal(outs[0][1], outs[1][1])
    g.backend.shutdown()


def test_folded_pool_mesh_epoch_on_the_card_decodes_past_stragglers():
    """The folded (8, 6) pool on a one-rank mesh of cuda:0: workers 2
    and 5 stall 0.3 s before their products, the epoch returns at the
    first 6 arrivals, and the in-place masked combine decodes through
    the parity shards within 1e-5 x cond(G_S) of the f64 product."""
    import numpy as np

    from mpistragglers_jl_tpu_torch.parallel import (
        PoolMeshCodedGemm,
        make_mesh,
    )
    from mpistragglers_jl_tpu_torch.pool import AsyncPool, waitall

    dev = _card()
    rng = np.random.default_rng(5)
    A = rng.standard_normal((6 * 64, 128)).astype(np.float32)
    B = rng.standard_normal((128, 32)).astype(np.float32)
    late = (2, 5)
    fg = PoolMeshCodedGemm(
        A, make_mesh(1, devices=[dev]), 6, n_workers=8,
        delay_fn=lambda i, e: 0.3 if i in late else 0.0)
    pool = AsyncPool(8)
    try:
        decoded = fg.epoch(pool, B, timeout=30.0)
        fresh = pool.fresh_indices()
        assert not set(late) & set(fresh.tolist())
        assert decoded.local(0).device.type == "cuda"
        want = A.astype(np.float64) @ B.astype(np.float64)
        err = np.abs(fg.full(decoded) - want).max() / np.abs(want).max()
        cond = np.linalg.cond(fg.code.G.astype(np.float64)[fresh[:6]])
        assert err < 1e-5 * cond, (err, cond)
        waitall(pool, fg.backend, timeout=30.0)
    finally:
        fg.shutdown()


def test_sharded_ulysses_flash_step_on_the_card_equals_cpu_ranks():
    """The sharded train step on a (2, 2, 2) mesh of eight ranks on
    cuda:0, Ulysses over the flash kernels (f32, TF32 off; D=128, one
    head per rank after the all-to-all): its loss within 1e-5 and its
    gradients within 1e-4 + 1e-3 |want| of the same step on eight CPU
    ranks (the plain versions), each kernel launched once per rank per
    layer, and after one SGD step every replica bit-equal."""
    import numpy as np

    from mpistragglers_jl_tpu_torch.models import transformer as tt
    from mpistragglers_jl_tpu_torch.parallel import make_mesh

    dev = _card()
    cfg = TransformerConfig(vocab=256, d_model=512, n_heads=4, n_layers=2,
                            d_ff=512, attn="ulysses", attn_impl="flash")
    tok = np.random.default_rng(11).integers(0, 256, (4, 257))
    inp, tgt = tok[:, :-1], tok[:, 1:]
    params = init_params(cfg, seed=3, device="cpu")
    axes = ("dp", "sp", "tp")
    card = make_mesh((2, 2, 2), axes, devices=[dev] * 8)
    cpu = make_mesh((2, 2, 2), axes, devices=["cpu"] * 8)
    sp_card = tt.shard_params(params, cfg, card)
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    loss, grads = tt.sharded_loss_and_grads(sp_card, inp, tgt, cfg, card)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": 16, "flash_bwd_dq": 16,
                           "flash_bwd_dkv": 16, "flash_bwd_fused": 0}
    loss_c, grads_c = tt.sharded_loss_and_grads(
        tt.shard_params(params, cfg, cpu), inp, tgt, cfg, cpu)
    torch.testing.assert_close(loss.cpu(), loss_c, rtol=1e-5, atol=0)
    for i, (a, b) in enumerate(zip(tt._leaves(grads), tt._leaves(grads_c))):
        assert a.local(0).device.type == "cuda"
        torch.testing.assert_close(a.gather(), b.gather(), rtol=1e-3,
                                   atol=1e-4, msg=f"leaf {i}")
    step = tt.make_train_step(cfg, card, lr=1e-2, donate=True)
    sp_card, _ = step(sp_card, inp, tgt)
    for leaf in tt._leaves(sp_card):
        named = {a for a in leaf.spec if a is not None}
        for group in card.axis_groups([a for a in axes if a not in named]):
            assert all(torch.equal(leaf.local(r), leaf.local(group[0]))
                       for r in group)


_EP_CFG = dict(vocab=256, d_model=512, n_heads=4, n_layers=2, d_ff=512,
               attn="ulysses", attn_impl="flash", n_experts=4,
               capacity_factor=1.25, moe_aux_coef=0.01)


def _replicas_equal_on(tree, mesh):
    for leaf in _tree_leaves(tree):
        named = {a for part in leaf.spec if part is not None
                 for a in ((part,) if isinstance(part, str) else part)}
        over = [a for a in mesh.axis_names if a not in named]
        for group in mesh.axis_groups(over):
            assert all(torch.equal(leaf.local(r), leaf.local(group[0]))
                       for r in group)


def _tree_leaves(tree):
    from mpistragglers_jl_tpu_torch.models.transformer import _leaves

    return _leaves(tree)


def _close_trees(grads, grads_c):
    for i, (a, b) in enumerate(zip(_tree_leaves(grads),
                                   _tree_leaves(grads_c))):
        assert a.local(0).device.type == "cuda"
        torch.testing.assert_close(a.gather(), b.gather(), rtol=1e-3,
                                   atol=1e-4, msg=f"leaf {i}")


def test_ep_step_on_the_card_equals_cpu_ranks():
    """The expert-parallel MoE step on a (dp, sp, tp, ep) = (2, 1, 2, 2)
    mesh of eight ranks on cuda:0 (f32, TF32 off; D=128, Ulysses over the
    flash kernels; 4 experts at cf 1.25 with aux 0.01): loss within 1e-5
    and gradients within 1e-4 + 1e-3 |want| of the same step on eight CPU
    ranks, K1-K3 once per rank per layer, replicas bit-equal after an
    SGD step."""
    import numpy as np

    from mpistragglers_jl_tpu_torch.models import transformer as tt
    from mpistragglers_jl_tpu_torch.parallel import make_mesh

    dev = _card()
    cfg = TransformerConfig(**_EP_CFG)
    tok = np.random.default_rng(12).integers(0, 256, (4, 257))
    inp, tgt = tok[:, :-1], tok[:, 1:]
    params = init_params(cfg, seed=3, device="cpu")
    axes = ("dp", "sp", "tp", "ep")
    card = make_mesh((2, 1, 2, 2), axes, devices=[dev] * 8)
    cpu = make_mesh((2, 1, 2, 2), axes, devices=["cpu"] * 8)
    sp_card = tt.shard_params(params, cfg, card)
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    loss, grads = tt.sharded_loss_and_grads(sp_card, inp, tgt, cfg, card)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": 16, "flash_bwd_dq": 16,
                           "flash_bwd_dkv": 16, "flash_bwd_fused": 0}
    loss_c, grads_c = tt.sharded_loss_and_grads(
        tt.shard_params(params, cfg, cpu), inp, tgt, cfg, cpu)
    torch.testing.assert_close(loss.cpu(), loss_c, rtol=1e-5, atol=0)
    _close_trees(grads, grads_c)
    step = tt.make_train_step(cfg, card, lr=1e-2, donate=True)
    sp_card, _ = step(sp_card, inp, tgt)
    _replicas_equal_on(sp_card, card)


def test_1f1b_moe_step_on_the_card_equals_cpu_ranks():
    """The 1F1B pipeline with MoE stages on a (dp, pp) = (2, 2) mesh of
    four ranks on cuda:0, 2 microbatches (f32, TF32 off; D=128, the
    flash kernels in every stage): loss within 1e-5 and gradients within
    1e-4 + 1e-3 |want| of the same step on four CPU ranks; K1 twice per
    layer and microbatch (forward slot and recompute), K2 and K3 once;
    replicas bit-equal after an SGD step."""
    import numpy as np

    from mpistragglers_jl_tpu_torch.parallel import make_mesh
    from mpistragglers_jl_tpu_torch.parallel import pipeline as pl

    dev = _card()
    cfg = TransformerConfig(**_EP_CFG)
    tok = np.random.default_rng(13).integers(0, 256, (4, 257))
    inp, tgt = tok[:, :-1], tok[:, 1:]
    params = init_params(cfg, seed=4, device="cpu")
    card = make_mesh((2, 2), ("dp", "pp"), devices=[dev] * 4)
    cpu = make_mesh((2, 2), ("dp", "pp"), devices=["cpu"] * 4)
    sp_card = pl.shard_params_pipeline(params, cfg, card)
    grad_fn = pl._pipeline_grad_fn(cfg, card, 2, "1f1b", 2)
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    loss, grads = grad_fn(sp_card, inp, tgt)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": 16, "flash_bwd_dq": 8,
                           "flash_bwd_dkv": 8, "flash_bwd_fused": 0}
    loss_c, grads_c = pl._pipeline_grad_fn(cfg, cpu, 2, "1f1b", 2)(
        pl.shard_params_pipeline(params, cfg, cpu), inp, tgt)
    torch.testing.assert_close(loss.cpu(), loss_c, rtol=1e-5, atol=0)
    _close_trees(grads, grads_c)
    step = pl.make_pipeline_train_step(cfg, card, n_microbatch=2, lr=1e-2,
                                       donate=True)
    sp_card, _ = step(sp_card, inp, tgt)
    _replicas_equal_on(sp_card, card)


_DEC_CFG = dict(vocab=256, d_model=512, n_heads=4, n_kv_heads=2,
                n_layers=2, d_ff=512, attn="ulysses", attn_impl="flash")


def _zero_counts():
    for counts in (fa.LAUNCHES, da.LAUNCHES):
        for name in counts:
            counts[name] = 0


@pytest.mark.parametrize("ring", [False, True])
def test_sharded_int8_generate_on_the_card_equals_dense(ring):
    """``make_generate`` (``ring=False``) and ``make_ring_generate`` over
    a (dp, tp) = (2, 2) mesh of four ranks on cuda:0, int8 cache, B=8
    (4 rows a rank: AUTO routes K5), f32 with TF32 off, D=128: tokens
    equal to the dense generator's on the card and to the same program on
    four CPU ranks; K1 once per rank per layer in the positional prefill
    (the ring's quantized prefill attends the cache: no K1), K5 once per
    rank per layer per decode step."""
    import dataclasses

    import numpy as np

    from mpistragglers_jl_tpu_torch.models import transformer as tt
    from mpistragglers_jl_tpu_torch.parallel import make_mesh

    dev = _card()
    cfg = TransformerConfig(**_DEC_CFG)
    if ring:
        cfg = dataclasses.replace(cfg, attn_window=128)
    prompt = np.random.default_rng(14).integers(0, 256, (8, 200))
    n_new = 6
    params = init_params(cfg, seed=5, device="cpu")
    card = make_mesh((2, 2), ("dp", "tp"), devices=[dev] * 4)
    cpu = make_mesh((2, 2), ("dp", "tp"), devices=["cpu"] * 4)
    make = td.make_ring_generate if ring else td.make_generate
    _zero_counts()
    got = make(cfg, card, n_new, quantize_kv=True)(
        tt.shard_params(params, cfg, card), prompt)
    torch.cuda.synchronize()
    k1 = 0 if ring else cfg.n_layers * 4
    assert fa.LAUNCHES["flash_fwd"] == k1
    assert da.LAUNCHES["quantized_decode_attention"] == cfg.n_layers * 4 * (n_new - 1)
    dense = (td.generate_ring_dense if ring else td.generate_dense)(
        tt._to(params, dev), prompt, n_new, cfg, quantize_kv=True)
    assert torch.equal(got.gather(dev), dense)
    want = make(cfg, cpu, n_new, quantize_kv=True)(
        tt.shard_params(params, cfg, cpu), prompt)
    assert torch.equal(got.gather(), want.gather())


def test_sharded_int8_serving_tick_on_the_card_equals_cpu_ranks():
    """``make_serving_scan`` over (dp, tp) = (2, 2) ranks of cuda:0, an
    int8 ring of S=8 slots (4 a rank: K5's ring mode routed), 4 inner
    steps: tokens, positions and done flags equal the same tick on four
    CPU ranks and the dense per-row step; K5 once per rank per layer
    per inner step."""
    import dataclasses

    import numpy as np

    from mpistragglers_jl_tpu_torch.models import serving as sv
    from mpistragglers_jl_tpu_torch.models import transformer as tt
    from mpistragglers_jl_tpu_torch.parallel import make_mesh

    dev = _card()
    cfg = dataclasses.replace(TransformerConfig(**_DEC_CFG),
                              attn_window=256)
    S, n_inner = 8, 4
    rng = np.random.default_rng(15)
    tok = rng.integers(1, 256, S).astype(np.int32)
    pos = rng.integers(100, 600, S).astype(np.int32)
    caches = []
    for _ in range(cfg.n_layers):
        layer = {}
        for kk in ("k", "v"):
            x = torch.as_tensor(rng.standard_normal(
                (S, cfg.attn_window, cfg.kv_heads, cfg.head_dim)) * 0.5,
                dtype=torch.float32)
            layer[kk], layer[kk + "_s"] = td._kv_quantize(x)
        caches.append(layer)
    params = init_params(cfg, seed=6, device="cpu")
    outs = {}
    for name, devs in (("card", [dev] * 4), ("cpu", ["cpu"] * 4)):
        mesh = make_mesh((2, 2), ("dp", "tp"), devices=devs)
        _zero_counts()
        outs[name] = sv.make_serving_scan(cfg, mesh, n_inner,
                                          quantize_kv=True)(
            tt.shard_params(params, cfg, mesh), tok, pos,
            np.zeros(S, bool), [dict(c) for c in caches])
        if name == "card":
            torch.cuda.synchronize()
            assert da.LAUNCHES["quantized_decode_attention"] == (
                cfg.n_layers * 4 * n_inner)
    for a, b in zip(outs["card"][:3] + (outs["card"][4],),
                    outs["cpu"][:3] + (outs["cpu"][4],)):
        assert torch.equal(a.gather(), b.gather())
    dtok, dpos = torch.as_tensor(tok), torch.as_tensor(pos)
    dc = [{kk: a.clone() for kk, a in c.items()} for c in caches]
    p_cpu = tt._to(params, "cpu")
    for _ in range(n_inner):
        lg, dc = sv.serving_decode_step_dense(p_cpu, dtok, dpos, dc, cfg)
        dtok, dpos = torch.argmax(lg, dim=-1).to(torch.int32), dpos + 1
    assert torch.equal(outs["card"][0].gather(), dtok)


_GLOO_CARD_RANK = r"""
import json, sys
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from mpistragglers_jl_tpu_torch.models import transformer as tt
from mpistragglers_jl_tpu_torch.ops import flash_attention as fa
from mpistragglers_jl_tpu_torch.parallel import make_mesh
from mpistragglers_jl_tpu_torch.parallel import multihost as mh
addr, rank = sys.argv[1], int(sys.argv[2])
dev = torch.device("cuda", 0)
mh.initialize_multihost(addr, num_processes=2, process_id=rank, device=dev,
                        backend="gloo")
cfg = tt.TransformerConfig(vocab=256, d_model=512, n_heads=4, n_layers=2,
                           d_ff=512, attn="ulysses", attn_impl="flash")
tok = np.random.default_rng(11).integers(0, 256, (4, 257))
inp, tgt = tok[:, :-1], tok[:, 1:]
params = tt.init_params(cfg, seed=3, device="cpu")
axes = ("dp", "sp", "tp")
out = {}
for tag, mesh in (
        ("x", mh.make_multihost_mesh((2, 2, 2), axes, dcn_axis="dp",
                                     devices=[dev] * 4)),
        ("s", make_mesh((2, 2, 2), axes, devices=[dev] * 8))):
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    sp, loss = tt.make_train_step(cfg, mesh, lr=1e-2)(
        tt.shard_params(params, cfg, mesh), inp, tgt)
    torch.cuda.synchronize()
    out[tag] = (loss, dict(fa.LAUNCHES),
                [leaf.gather() for leaf in tt._leaves(sp)])
same = bool(torch.equal(out["x"][0], out["s"][0]) and all(
    torch.equal(a, b) for a, b in zip(out["x"][2], out["s"][2])))
print("RESULT " + json.dumps({"same": same, "launches": out["x"][1],
                              "single": out["s"][1]}))
"""


def test_gloo_step_across_two_processes_on_the_card_equals_one():
    """Two processes on cuda:0 joined over gloo (nccl refuses two ranks
    on one GPU), each driving four ranks of a (2, 2, 2) mesh with dp
    across them: one f32 SGD step's loss and leaves bit-equal to the
    single-controller step each process runs on eight ranks of the card,
    each flash kernel launched once per local rank per layer."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from mpistragglers_jl_tpu_torch.ops import _build

    _card()
    _build.build("flash_attention")  # the processes load it, never build
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = root
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_CARD_RANK, addr,
                               str(r)], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.split("RESULT ", 1)[1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for res in outs:
        assert res["same"]
        assert res["launches"] == {"flash_fwd": 8, "flash_bwd_dq": 8,
                                   "flash_bwd_dkv": 8, "flash_bwd_fused": 0}
        assert res["single"] == {"flash_fwd": 16, "flash_bwd_dq": 16,
                                 "flash_bwd_dkv": 16, "flash_bwd_fused": 0}
