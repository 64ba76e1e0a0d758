"""The port's transformer blocks and KV-cache decode
(mpistragglers_jl_tpu_torch/models/{transformer,decode}.py) against the
JAX package on the same numpy inputs, JAX on the CPU.

Tolerances: parameters and int8 bytes are compared exactly (but for a
+-1 at an exact .5 tie of the int8 rounding); float32 logits within
1e-4 absolute (different summation orders); greedy token streams must
be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.models import decode as jd
from mpistragglers_jl_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    init_params as jax_init_params,
)
from mpistragglers_jl_tpu_torch.models import decode as td
from mpistragglers_jl_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    params_from_jax,
)

SMALL = dict(vocab=61, d_model=64, n_heads=8, n_kv_heads=2, n_layers=2,
             d_ff=128, attn_window=6)
WIDE = dict(vocab=97, d_model=256, n_heads=2, n_kv_heads=1, n_layers=2,
            d_ff=256, attn_window=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once, and timing-sensitive tests elsewhere share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(fields, seed, dtype="float32"):
    jcfg = JaxConfig(**fields, dtype=getattr(jnp, dtype))
    tcfg = TransformerConfig(**fields, dtype=getattr(torch, dtype))
    return jcfg, tcfg, jax_init_params(jcfg, seed), init_params(
        tcfg, seed, device="cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_and_carry_over_are_identical(dtype):
    jcfg, tcfg, jp, tp = _pair(SMALL, seed=3, dtype=dtype)
    carried = params_from_jax(_np_tree(jp), "cpu")
    tflat, cflat = dict(_flat(tp)), dict(_flat(carried))
    jflat = dict(_flat(_np_tree(jp)))
    assert tflat.keys() == jflat.keys() == cflat.keys()
    for name, a in tflat.items():
        assert a.dtype == getattr(torch, dtype), name
        assert torch.equal(a, cflat[name]), name
        np.testing.assert_array_equal(
            a.float().numpy(), np.asarray(jflat[name], np.float32),
            err_msg=name)


def test_kv_quantize_bytes_match_except_half_ties():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 40, 2, 64)).astype(np.float32)
    x[0, 0, 0, :4] = [127.0, 63.5, -0.5, 1.5]  # exact .5 ties
    x[0, 1] = 0.0  # all-zero rows clamp the scale
    jq, js = jd._kv_quantize(jnp.asarray(x))
    tq, ts = td._kv_quantize(torch.as_tensor(x))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    diff = tq.numpy().astype(np.int32) - np.asarray(jq, np.int32)
    assert np.abs(diff).max() <= 1
    ratio = x / np.maximum(np.abs(x).max(-1, keepdims=True) / 127.0, 1e-8)
    tie = np.isclose(np.abs(ratio) % 1.0, 0.5, atol=1e-4)
    assert not np.any(diff[~tie]), "only exact-half ties may differ"
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_one_layer_prefill_and_decode_step(quantize_kv):
    """One layer of the incremental forward on a prefill chunk, then a
    decode step against the resulting cache (f32, atol 1e-4)."""
    jcfg, tcfg, jp, tp = _pair(SMALL, seed=5)
    rng = np.random.default_rng(6)
    T = 9
    x = rng.standard_normal((2, T, SMALL["d_model"])).astype(np.float32)
    jc = jd.init_cache(jcfg, 2, 16, quantize_kv=quantize_kv)[0]
    tc = td.init_cache(tcfg, 2, 16, quantize_kv=quantize_kv,
                       device="cpu")[0]
    jx, jc = jd._incremental_layer(
        jnp.asarray(x), jp["layers"][0], jc, jnp.arange(T), jcfg,
        chunk_attn=None, kv_slice=None, tp_psum=False)
    tx, tc = td._incremental_layer(
        torch.as_tensor(x), tp["layers"][0], tc, torch.arange(T), 0, tcfg,
        chunk_attn=None)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-4)
    for k in jc:
        want = np.asarray(jc[k])
        got = tc[k].numpy()
        if k in ("k", "v") and quantize_kv:
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    x1 = rng.standard_normal((2, 1, SMALL["d_model"])).astype(np.float32)
    jy, _ = jd._incremental_layer(
        jnp.asarray(x1), jp["layers"][0], jc, jnp.asarray([T]), jcfg,
        chunk_attn=None, kv_slice=None, tp_psum=False)
    ty, _ = td._incremental_layer(
        torch.as_tensor(x1), tp["layers"][0], tc, torch.tensor([T]), T,
        tcfg, chunk_attn=None)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_ring_decode_step_logits(quantize_kv):
    """Prefill, ring handoff, then one ring decode step: whole-model
    logits within 1e-4 (f32)."""
    jcfg, tcfg, jp, tp = _pair(SMALL, seed=7)
    rng = np.random.default_rng(8)
    prompt = rng.integers(1, SMALL["vocab"], (2, 10)).astype(np.int32)
    jc = jd.init_cache(jcfg, 2, 10, quantize_kv=quantize_kv)
    tc = td.init_cache(tcfg, 2, 10, quantize_kv=quantize_kv, device="cpu")
    jl, jc = jd.prefill_dense(jp, jnp.asarray(prompt), jc, jcfg)
    tl, tc = td.prefill_dense(tp, torch.as_tensor(prompt), tc, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    jr = jd.ring_from_cache(jc, 10, jcfg)
    tr = td.ring_from_cache(tc, 10, tcfg)
    tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)
    jlg, _ = jd.decode_step_ring_dense(jp, jnp.asarray(tok), jr,
                                       jnp.int32(10), jcfg)
    tlg, _ = td.decode_step_ring_dense(tp, torch.as_tensor(tok), tr, 10,
                                       tcfg)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("fields,B,Tp,n_new,eos", [
    (SMALL, 1, 5, 12, None),
    (SMALL, 2, 9, 10, 7),
    (WIDE, 4, 7, 8, None),  # head_dim 128 at B=4: the kernel route
])
@pytest.mark.parametrize("quantize_kv", [False, True])
def test_generate_ring_dense_tokens_match_jax(fields, B, Tp, n_new, eos,
                                              quantize_kv):
    jcfg, tcfg, jp, tp = _pair(fields, seed=11)
    rng = np.random.default_rng(Tp)
    prompt = rng.integers(1, fields["vocab"], (B, Tp)).astype(np.int32)
    want = jd.generate_ring_dense(jp, jnp.asarray(prompt), n_new, jcfg,
                                  eos_id=eos, quantize_kv=quantize_kv)
    got = td.generate_ring_dense(tp, prompt, n_new, tcfg, eos_id=eos,
                                 quantize_kv=quantize_kv, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_device_defaults_to_cuda():
    """Entry points run on the card unless the caller asks for the CPU;
    here (no card) the default raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    tcfg = TransformerConfig(**SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(tcfg, 0)
    tp = init_params(tcfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.generate_ring_dense(tp, np.ones((1, 3), np.int32), 2, tcfg)


def test_sampling_and_flash_are_named_as_later_work():
    """Sampling is ported: ``temperature > 0`` needs a key, as in the
    reference, and with one it generates (its streams are held to the
    JAX package in test_torch_sampling.py); the flash prefill is
    ported, so a flash config generates the reference config's greedy
    stream."""
    from mpistragglers_jl_tpu_torch.utils import prng

    tcfg = TransformerConfig(**SMALL)
    tp = init_params(tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="needs a PRNG key"):
        td.generate_ring_dense(tp, np.ones((1, 3), np.int32), 2, tcfg,
                               temperature=0.7, device="cpu")
    got = td.generate_ring_dense(tp, np.ones((1, 3), np.int32), 2, tcfg,
                                 temperature=0.7, key=prng.key(0),
                                 device="cpu")
    assert got.shape == (1, 2)
    flash = dataclasses.replace(tcfg, attn="ulysses", attn_impl="flash")
    prompt = np.arange(1, 10, dtype=np.int32)[None]
    torch.testing.assert_close(
        td.generate_ring_dense(tp, prompt, 6, flash, device="cpu"),
        td.generate_ring_dense(tp, prompt, 6, tcfg, device="cpu"),
        rtol=0, atol=0)


@pytest.mark.parametrize("fields", [SMALL, WIDE])
def test_prefill_dense_flash_matches_jax(fields):
    """prefill_dense through the flash attention (K1's plain version on
    the CPU) against the reference's flash prefill: logits within 1e-4,
    the cache within 1e-5 (f32)."""
    fields = dict(fields, attn="ulysses", attn_impl="flash")
    jcfg, tcfg, jp, tp = _pair(fields, seed=13)
    prompt = np.random.default_rng(14).integers(
        1, fields["vocab"], (2, 11)).astype(np.int32)
    jc = jd.init_cache(jcfg, 2, 16)
    tc = td.init_cache(tcfg, 2, 16, device="cpu")
    jl, jc = jd.prefill_dense(jp, jnp.asarray(prompt), jc, jcfg)
    tl, tc = td.prefill_dense(tp, torch.as_tensor(prompt), tc, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    for jl_, tl_ in zip(jc, tc):
        for k in jl_:
            np.testing.assert_allclose(tl_[k].numpy(), np.asarray(jl_[k]),
                                       rtol=0, atol=1e-5)


def test_routing_gate_agrees_with_jax():
    """Same use_kernel decision as the reference over configs, batch
    sizes, cache lengths and every toggle setting."""
    cfgs = [
        dict(d_model=64, n_heads=8, n_kv_heads=2),
        dict(d_model=256, n_heads=2, n_kv_heads=1),
        dict(d_model=1024, n_heads=8, n_kv_heads=2),
        dict(d_model=2048, n_heads=8, n_kv_heads=1),  # g = 8
        dict(d_model=2048, n_heads=16, n_kv_heads=1),  # g = 16
        dict(d_model=512, n_heads=2, n_kv_heads=2),  # head_dim 256
    ]
    try:
        for toggle in (None, True, False):
            jd.use_decode_kernel(toggle)
            td.use_decode_kernel(toggle)
            for f in cfgs:
                jc = JaxConfig(vocab=16, n_layers=1, d_ff=16,
                               attn_window=64, **f)
                tc = TransformerConfig(vocab=16, n_layers=1, d_ff=16,
                                       attn_window=64, **f)
                for q8 in (False, True):
                    assert (td._kernel_possible(tc, q8)
                            == jd._kernel_possible(jc, q8))
                for B in (1, 2, 3, 4, 8, 16):
                    assert td._route_kernel(td._UNSET, B) == \
                        jd._route_kernel(jd._UNSET, B)
                    for L in (64, 1024, 5000, 8200):
                        Dh, Hkv = jc.head_dim, jc.kv_heads
                        jcache = jd._zero_cache_layer(
                            1, L, Hkv, Dh, jnp.float32, True)
                        tcache = td._zero_cache_layer(
                            1, L, Hkv, Dh, torch.float32, True, "cpu")
                        jq = jnp.zeros((B, 1, jc.n_heads, Dh))
                        tq = torch.zeros((B, 1, jc.n_heads, Dh))
                        assert td._kernel_viable(tq, tcache) == \
                            jd._kernel_viable(jq, jcache), (f, B, L)
    finally:
        jd.use_decode_kernel(None)
        td.use_decode_kernel(None)


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_cache_layouts_match_jax(quantize_kv):
    """init_cache / init_ring_cache: same leaves, shapes and dtypes as
    the reference, zero-filled, one buffer per leaf (writes are in
    place)."""
    jcfg, tcfg, _, _ = _pair(SMALL, seed=0)
    for jc, tc in (
        (jd.init_cache(jcfg, 3, 11, quantize_kv=quantize_kv),
         td.init_cache(tcfg, 3, 11, quantize_kv=quantize_kv, device="cpu")),
        (jd.init_ring_cache(jcfg, 3, quantize_kv=quantize_kv),
         td.init_ring_cache(tcfg, 3, quantize_kv=quantize_kv,
                            device="cpu")),
    ):
        assert len(jc) == len(tc) == SMALL["n_layers"]
        for jl, tl in zip(jc, tc):
            assert jl.keys() == tl.keys()
            for k in jl:
                assert tuple(tl[k].shape) == jl[k].shape
                assert str(tl[k].dtype).split(".")[-1] == str(jl[k].dtype)
                assert not tl[k].any()
            ptrs = {t.data_ptr() for t in tl.values()}
            assert len(ptrs) == len(tl)
