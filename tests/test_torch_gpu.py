"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Every test here is ``gpu``-marked and skips without a card
(the kernels have no CPU mode). This file imports no JAX, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: f32 q within 1e-5 absolute of the plain version (the two
sum in f32 in different orders); a bf16 output within 1e-5 + 2**-8 of
the f32 plain result on the same q (one bf16 rounding of the value).
"""

import pytest
import torch

from mpistragglers_jl_tpu_torch.models import decode as td
from mpistragglers_jl_tpu_torch.models.serving import ServingScheduler
from mpistragglers_jl_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)
from mpistragglers_jl_tpu_torch.ops import decode_attention as da

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
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
