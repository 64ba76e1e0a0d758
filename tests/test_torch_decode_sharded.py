"""The port's sharded inference (mpistragglers_jl_tpu_torch/models/
decode.py: ``init_cache`` with a mesh, ``cache_specs``, ``shard_cache``,
``make_prefill``, ``make_decode_step``, ``make_extend``,
``make_generate``, ``make_ring_generate``) on CPU ranks,
``make_mesh(shape, axes, devices=["cpu"] * n)``, against the JAX
package's sharded programs on its 8 host devices: the mesh cases of the
JAX package's tests/test_decode.py, tests/test_quantized_cache.py and
tests/test_window_attention.py, parameters carried over by
``params_from_jax`` and tokens made with numpy from a seed. Also the
layout repair: ``shard_params`` over the decode meshes, block for block
against the JAX ``shard_params``.

Tolerances: tokens equal; f32 logits within 1e-5 absolute and relative
of the JAX program's (the programs sum in different orders); int8 cache
codes within one step of JAX's (a rounding tie may land on either side),
their scales within 1e-6; parameter shards bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from mpistragglers_jl_tpu.models import decode as jd
from mpistragglers_jl_tpu.models import transformer as jt
from mpistragglers_jl_tpu.parallel import make_mesh as jmake_mesh
from mpistragglers_jl_tpu_torch.models import decode as td
from mpistragglers_jl_tpu_torch.models import transformer as tt
from mpistragglers_jl_tpu_torch.parallel import PartitionSpec as P, make_mesh
from mpistragglers_jl_tpu_torch.utils import prng

CFG = dict(vocab=61, d_model=64, n_heads=8, n_kv_heads=2, n_layers=2,
           d_ff=128)
MOE = dict(CFG, n_experts=2, capacity_factor=2.0)
D128 = dict(vocab=97, d_model=256, n_heads=2, n_kv_heads=1, n_layers=2,
            d_ff=256)  # head_dim 128: the int8 kernel's gate
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(fields, seed):
    """JAX config and params, the port's config and dense params."""
    jcfg = jt.TransformerConfig(**fields)
    jp = jt.init_params(jcfg, seed)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tt.TransformerConfig(**fields), jp, tp


def _meshes(shape, axes):
    n = int(np.prod(shape))
    return jmake_mesh(shape, axes), make_mesh(shape, axes,
                                              devices=["cpu"] * n)


def _tokens(vocab, B, L, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, L),
                                                dtype=np.int32)


def _jput(mesh, x, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL, err_msg=what)


def _jkey(seed):
    return jax.random.key(seed)


# -- the layout repair: shard_params over the decode meshes -------------


@pytest.mark.parametrize("fields,shape,axes", [
    (CFG, (2, 4), ("dp", "tp")),
    (dict(CFG, n_kv_heads=4), (2, 4), ("dp", "tp")),
    (MOE, (2, 2, 2), ("dp", "ep", "tp")),
])
def test_shard_params_lays_out_as_jax(fields, shape, axes):
    """Every position's block of every leaf equals the block the JAX
    ``shard_params`` puts on the device at that mesh position, bit for
    bit (kv_heads 2 < tp 4 keeps wk and wv replicated)."""
    jcfg, tcfg, jp, tp = _pair(fields, seed=3)
    jmesh, mesh = _meshes(shape, axes)
    jsp = jt.shard_params(jp, jcfg, jmesh)
    sp = tt.shard_params(tp, tcfg, mesh)
    where = {d: int(r) for r, d in enumerate(jmesh.devices.flat)}
    for jleaf, leaf in zip(jax.tree.leaves(jsp), tt._leaves(sp)):
        assert tt._spec_key(leaf.spec) == tt._spec_key(
            tuple(jleaf.sharding.spec))
        for s in jleaf.addressable_shards:
            got = leaf.local(where[s.device]).numpy()
            np.testing.assert_array_equal(got, np.asarray(s.data))


def test_training_checks_unchanged_and_decode_meshes_refused_by_name():
    """The training program keeps its (dp, sp, tp) check; the decode
    entry points name the axes a decode mesh lacks."""
    cfg = tt.TransformerConfig(**CFG)
    mesh = make_mesh((2, 4), ("dp", "tp"), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match=r"lacks \['sp'\]"):
        tt.make_forward(cfg, mesh)
    with pytest.raises(ValueError, match=r"missing axes \['ep'\]"):
        td.make_prefill(tt.TransformerConfig(**MOE), mesh)
    with pytest.raises(ValueError, match=r"lacks \['tp'\]"):
        tt.shard_params(tt.init_params(cfg, device="cpu"), cfg,
                        make_mesh((2,), ("dp",), devices=["cpu"] * 2))
    with pytest.raises(ValueError, match=r"missing axes \['dp'\]"):
        td.make_generate(cfg, make_mesh((4,), ("tp",), devices=["cpu"] * 4),
                         2)


# -- prefill, decode step, extend --------------------------------------


def _run_prefill_decode(jcfg, tcfg, jp, tp, shape, axes, toks, Tp,
                        quantize_kv=False):
    jmesh, mesh = _meshes(shape, axes)
    bax = jd.decode_batch_axes(jcfg)
    B, L = toks.shape
    jsp = jt.shard_params(jp, jcfg, jmesh)
    jc = jd.shard_cache(jd.init_cache(jcfg, B, L, jmesh,
                                      quantize_kv=quantize_kv), jcfg, jmesh)
    jlg, jc = jd.make_prefill(jcfg, jmesh, quantize_kv=quantize_kv)(
        jsp, _jput(jmesh, toks[:, :Tp], JP(bax, None)), jc)
    sp = tt.shard_params(tp, tcfg, mesh)
    c = td.shard_cache(td.init_cache(tcfg, B, L, mesh,
                                     quantize_kv=quantize_kv, device="cpu"),
                       tcfg, mesh)
    lg, c2 = td.make_prefill(tcfg, mesh, quantize_kv=quantize_kv)(
        sp, toks[:, :Tp], c)
    assert c2 is c  # written in place
    assert lg.spec == P(bax, None) and lg.shape == (B, tcfg.vocab)
    got, want = [np.asarray(lg)], [np.asarray(jlg)]
    jstep = jd.make_decode_step(jcfg, jmesh, quantize_kv=quantize_kv)
    step = td.make_decode_step(tcfg, mesh, quantize_kv=quantize_kv)
    for t in range(Tp, L):
        jlg, jc = jstep(jsp, _jput(jmesh, toks[:, t], JP(bax)), jc,
                        jnp.int32(t))
        lg, c = step(sp, toks[:, t], c, t)
        got.append(np.asarray(lg))
        want.append(np.asarray(jlg))
    return got, want, c, jc


@pytest.mark.parametrize("shape,hkv", [
    ((2, 4), 4),  # kv heads shard over tp
    ((2, 4), 2),  # kv_heads < tp: replicated-groups cache
    ((1, 8), 1),  # MQA at tp=8
])
def test_sharded_prefill_and_decode_match_jax(shape, hkv):
    """tests/test_decode.py:103: the prefill's last-position logits and
    every decode step's, and the caches after them, against the JAX
    programs; and against the port's dense forward."""
    fields = dict(CFG, n_kv_heads=hkv)
    jcfg, tcfg, jp, tp = _pair(fields, seed=3)
    toks = _tokens(61, 4, 12, seed=3)
    got, want, c, jc = _run_prefill_decode(jcfg, tcfg, jp, tp, shape,
                                           ("dp", "tp"), toks, 6)
    dense = tt.forward_dense(tp, toks, tcfg).numpy()
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"step {i}")
        _close(g, dense[:, 5 + i], f"step {i} against forward_dense")
    for layer, jlayer in zip(c, jc):
        for kk in layer:
            _close(layer[kk].gather(), jlayer[kk], kk)


def test_moe_decode_mesh_validation():
    """tests/test_decode.py:186."""
    cfg = tt.TransformerConfig(**dict(CFG, n_experts=2))
    mesh = make_mesh((2, 4), ("dp", "tp"), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match=r"missing axes \['ep'\]"):
        td.make_prefill(cfg, mesh)


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 4)])
def test_moe_sharded_prefill_and_decode_match_jax(shape):
    """tests/test_decode.py:198: expert-parallel decode, routing sharded
    with the all-to-alls over ep, batch over (dp, ep)."""
    jcfg, tcfg, jp, tp = _pair(MOE, seed=9)
    toks = _tokens(61, 4, 12, seed=9)
    got, want, _, _ = _run_prefill_decode(jcfg, tcfg, jp, tp, shape,
                                          ("dp", "ep", "tp"), toks, 6)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"step {i}")


@pytest.mark.parametrize("hkv,chunk", [(2, 5), (1, 3)])
def test_chunked_prefill_matches_jax_and_one_shot(hkv, chunk):
    """tests/test_decode.py:395: make_extend chunk by chunk against the
    JAX extend and the port's dense forward."""
    fields = dict(CFG, n_kv_heads=hkv)
    jcfg, tcfg, jp, tp = _pair(fields, seed=14)
    jmesh, mesh = _meshes((2, 4), ("dp", "tp"))
    toks = _tokens(61, 4, 12, seed=15)
    dense = tt.forward_dense(tp, toks, tcfg).numpy()
    jsp, sp = jt.shard_params(jp, jcfg, jmesh), tt.shard_params(tp, tcfg, mesh)
    jext, ext = jd.make_extend(jcfg, jmesh), td.make_extend(tcfg, mesh)
    jc = jd.shard_cache(jd.init_cache(jcfg, 4, 12, jmesh), jcfg, jmesh)
    c = td.init_cache(tcfg, 4, 12, mesh, device="cpu")  # laid out by extend
    for i in range(0, 12, chunk):
        end = min(i + chunk, 12)
        jlg, jc = jext(jsp, _jput(jmesh, toks[:, i:end], JP("dp", None)),
                       jc, jnp.int32(i))
        lg, c = ext(sp, toks[:, i:end], c, i)
        assert lg.shape == (4, end - i, 61)
        _close(lg, jlg, f"chunk at {i}")
        _close(lg, dense[:, i:end], f"chunk at {i} against forward_dense")


def test_cache_overflow_and_n_new_guards():
    """tests/test_decode.py:260 and :292: a max_len short of the stream,
    a chunk past the cache and n_new 0 raise; the port raises where the
    reference's dynamic_update_slice would clamp."""
    _, cfg, _, params = _pair(CFG, seed=0)
    mesh = make_mesh((1, 4), ("dp", "tp"), devices=["cpu"] * 4)
    sp = tt.shard_params(params, cfg, mesh)
    prompt = _tokens(61, 1, 8, seed=0)
    with pytest.raises(ValueError, match="max_len 10 < prompt 8"):
        td.make_generate(cfg, mesh, n_new=8, max_len=10)(sp, prompt)
    with pytest.raises(ValueError, match="n_new must be >= 1"):
        td.make_generate(cfg, mesh, n_new=0)
    cache = td.init_cache(cfg, 1, 4, mesh, device="cpu")
    with pytest.raises(ValueError, match="does not fit the cache"):
        td.make_prefill(cfg, mesh)(sp, prompt, cache)
    cache = td.init_cache(cfg, 1, 8, mesh, device="cpu")
    with pytest.raises(ValueError, match=r"chunk \[6, 10\) does not fit"):
        td.make_extend(cfg, mesh)(sp, prompt[:, :4], cache, 6)
    with pytest.raises(ValueError, match="does not fit"):
        td.make_decode_step(cfg, mesh)(sp, prompt[:, 0], cache, 8)
    with pytest.raises(ValueError, match="quantize_kv=True"):
        td.make_prefill(cfg, mesh, quantize_kv=True)(sp, prompt, cache)
    with pytest.raises(ValueError, match="init_cache"):
        td.make_prefill(cfg, mesh)(sp, prompt,
                                   td.init_cache(cfg, 1, 8, device="cpu"))
    with pytest.raises(TypeError, match="shard_params"):
        td.make_prefill(cfg, mesh)(params, prompt, cache)


# -- generation ----------------------------------------------------------


def _generate_pair(jcfg, tcfg, jp, tp, shape, axes, prompt, n_new, *,
                   ring=False, jkey=None, key=None, **kw):
    jmesh, mesh = _meshes(shape, axes)
    bax = jd.decode_batch_axes(jcfg)
    jmake = jd.make_ring_generate if ring else jd.make_generate
    tmake = td.make_ring_generate if ring else td.make_generate
    jgot = jmake(jcfg, jmesh, n_new, **kw)(
        jt.shard_params(jp, jcfg, jmesh),
        _jput(jmesh, prompt, JP(bax, None)), *([] if jkey is None else [jkey]))
    got = tmake(tcfg, mesh, n_new, **kw)(
        tt.shard_params(tp, tcfg, mesh), prompt, key)
    assert got.spec == P(bax, None) and got.shape == prompt.shape[:1] + (
        n_new,)
    return got.gather().numpy(), np.asarray(jgot)


@pytest.mark.parametrize("fields,shape,axes,B,n_new,seed", [
    (CFG, (2, 4), ("dp", "tp"), 2, 6, 4),  # test_decode.py:133, kv=2
    (dict(CFG, n_kv_heads=1), (2, 4), ("dp", "tp"), 2, 6, 4),  # kv=1
    (MOE, (2, 2, 2), ("dp", "ep", "tp"), 4, 5, 10),  # test_decode.py:239
])
def test_sharded_generate_matches_jax(fields, shape, axes, B, n_new, seed):
    """Greedy make_generate: the JAX mesh program's tokens and the
    port's generate_dense's."""
    jcfg, tcfg, jp, tp = _pair(fields, seed=seed)
    prompt = _tokens(61, B, 8, seed=seed + 1)
    got, want = _generate_pair(jcfg, tcfg, jp, tp, shape, axes, prompt,
                               n_new)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, td.generate_dense(tp, prompt, n_new, tcfg, device="cpu").numpy())


@pytest.mark.parametrize("fields,shape,axes,B,seed,temp,topk", [
    (CFG, (2, 4), ("dp", "tp"), 2, 1, 0.8, 8),  # test_decode.py ~318
    (MOE, (2, 2, 2), ("dp", "ep", "tp"), 4, 12, 0.7, 8),  # :366
])
def test_sampled_sharded_generate_matches_jax(fields, shape, axes, B, seed,
                                              temp, topk):
    """One key, the same stream on the mesh as dense, in both packages:
    each rank folds its rows' GLOBAL batch index (dp-major, then ep);
    another key gives another stream."""
    jcfg, tcfg, jp, tp = _pair(fields, seed=seed)
    prompt = _tokens(61, B, 6 if B == 2 else 8, seed=seed + 1)
    n_new = 6 if B == 2 else 5
    kw = dict(temperature=temp, top_k=topk)
    got, want = _generate_pair(jcfg, tcfg, jp, tp, shape, axes, prompt,
                               n_new, jkey=_jkey(7), key=prng.key(7), **kw)
    np.testing.assert_array_equal(got, want)
    dense = td.generate_dense(tp, prompt, n_new, tcfg, key=prng.key(7),
                              device="cpu", **kw).numpy()
    np.testing.assert_array_equal(got, dense)
    other = td.generate_dense(tp, prompt, n_new, tcfg, key=prng.key(8),
                              device="cpu", **kw).numpy()
    assert not np.array_equal(dense, other)
    # with the rows folded as if each rank held the batch's first rows,
    # a dp > 1 mesh would give other streams (row0 is load-bearing)
    mesh = make_mesh(shape, axes, devices=["cpu"] * 8)
    real = td._batch_row0
    try:
        td._batch_row0 = lambda cfg, mesh, r, B: 0
        wrong = td.make_generate(tcfg, mesh, n_new, **kw)(
            tt.shard_params(tp, tcfg, mesh), prompt, prng.key(7))
    finally:
        td._batch_row0 = real
    assert not np.array_equal(wrong.gather().numpy(), dense)


def test_eos_clamp_sharded_matches_jax():
    """tests/test_decode.py:422: rows that emit the EOS id keep emitting
    it, on the mesh as on one device."""
    jcfg, tcfg, jp, tp = _pair(CFG, seed=20)
    prompt = _tokens(61, 2, 6, seed=21)
    free = td.generate_dense(tp, prompt, 8, tcfg, device="cpu").numpy()
    eos = int(free[0, 2])
    got, want = _generate_pair(jcfg, tcfg, jp, tp, (2, 4), ("dp", "tp"),
                               prompt, 8, eos_id=eos)
    np.testing.assert_array_equal(got, want)
    first = int(np.argmax(free[0] == eos))
    assert np.all(got[0, first:] == eos)
    np.testing.assert_array_equal(got, td.generate_dense(
        tp, prompt, 8, tcfg, eos_id=eos, device="cpu").numpy())


@pytest.mark.parametrize("shape,ring,window", [
    ((2, 2), False, None),  # test_quantized_cache.py:114
    ((1, 4), False, None),
    ((2, 2), True, 5),      # test_quantized_cache.py:129
])
def test_sharded_quantized_generate_matches_jax(shape, ring, window):
    """int8 caches over dp x tp, tp=4 > kv_heads=2 included; the ring
    form prefills through the per-rank aligned (quantized) prefill."""
    fields = dict(CFG, attn_window=window)
    jcfg, tcfg, jp, tp = _pair(fields, seed=3 if not ring else 5)
    prompt = _tokens(61, 2, 7 if not ring else 6, seed=4 if not ring else 6)
    n_new = 8 if not ring else 9
    got, want = _generate_pair(jcfg, tcfg, jp, tp, shape, ("dp", "tp"),
                               prompt, n_new, ring=ring, quantize_kv=True)
    np.testing.assert_array_equal(got, want)
    gen = td.generate_ring_dense if ring else td.generate_dense
    np.testing.assert_array_equal(got, gen(tp, prompt, n_new, tcfg,
                                           quantize_kv=True,
                                           device="cpu").numpy())


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_sharded_ring_generate_matches_jax(shape):
    """tests/test_window_attention.py:234: the O(W) ring over dp x tp,
    the replicated-groups layout at tp=4."""
    fields = dict(CFG, attn_window=5)
    jcfg, tcfg, jp, tp = _pair(fields, seed=10)
    prompt = _tokens(61, 2, 7, seed=11)
    got, want = _generate_pair(jcfg, tcfg, jp, tp, shape, ("dp", "tp"),
                               prompt, 9, ring=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, td.generate_ring_dense(
        tp, prompt, 9, tcfg, device="cpu").numpy())


def test_chunked_extend_quantized_matches_prefill_and_jax():
    """tests/test_quantized_cache.py:181: streaming int8 prefill against
    one-shot; layer 0's codes bit-equal, deeper layers within the
    dequantisation tolerance; the extend's logits and cache against the
    JAX extend's."""
    jcfg, tcfg, jp, tp = _pair(CFG, seed=7)
    jmesh, mesh = _meshes((1, 2), ("dp", "tp"))
    prompt = _tokens(61, 1, 8, seed=8)
    sp = tt.shard_params(tp, tcfg, mesh)
    c_one = td.init_cache(tcfg, 1, 10, mesh, quantize_kv=True, device="cpu")
    lg_one, c_one = td.make_prefill(tcfg, mesh, quantize_kv=True)(
        sp, prompt, c_one)
    extend = td.make_extend(tcfg, mesh, quantize_kv=True)
    c = td.shard_cache(td.init_cache(tcfg, 1, 10, mesh, quantize_kv=True,
                                     device="cpu"), tcfg, mesh)
    jext = jd.make_extend(jcfg, jmesh, quantize_kv=True)
    jsp = jt.shard_params(jp, jcfg, jmesh)
    jc = jd.shard_cache(jd.init_cache(jcfg, 1, 10, jmesh, quantize_kv=True),
                        jcfg, jmesh)
    for i in range(0, 8, 4):
        lg, c = extend(sp, prompt[:, i:i + 4], c, i)
        jlg, jc = jext(jsp, _jput(jmesh, prompt[:, i:i + 4], JP("dp", None)),
                       jc, jnp.int32(i))
        _close(lg, jlg, f"chunk at {i}")
    np.testing.assert_allclose(lg.gather()[:, -1].numpy(),
                               lg_one.gather().numpy(), atol=1e-2)
    for kk in ("k", "v"):
        np.testing.assert_array_equal(c[0][kk].gather().numpy(),
                                      c_one[0][kk].gather().numpy())
    for la, lb in zip(c[1:], c_one[1:]):
        for kk in ("k", "v"):
            da = la[kk].gather().float() * la[kk + "_s"].gather()[..., None]
            db = lb[kk].gather().float() * lb[kk + "_s"].gather()[..., None]
            np.testing.assert_allclose(da.numpy(), db.numpy(), atol=2e-2)
    for layer, jlayer in zip(c, jc):
        for kk in ("k", "v"):
            diff = layer[kk].gather().numpy().astype(int) - np.asarray(
                jlayer[kk]).astype(int)
            assert np.abs(diff).max() <= 1, kk
        for kk in ("k_s", "v_s"):
            np.testing.assert_allclose(layer[kk].gather().numpy(),
                                       np.asarray(jlayer[kk]), atol=1e-6)


def test_shard_cache_places_scale_leaves():
    """tests/test_quantized_cache.py:297: the int8 scales shard as their
    K/V, batch over dp, heads over tp; a mesh axis the specs do not name
    (ep, for a dense config) replicates, each position its own buffer;
    with kv_heads < tp the head axis has tp slots."""
    cfg = tt.TransformerConfig(**CFG)
    mesh = make_mesh((2, 2, 2), ("dp", "ep", "tp"), devices=["cpu"] * 8)
    c = td.shard_cache(td.init_cache(cfg, 2, 16, mesh, quantize_kv=True,
                                     device="cpu"), cfg, mesh)
    assert c[0]["k_s"].spec == P(("dp",), None, "tp")
    assert c[0]["k"].spec == P(("dp",), None, "tp", None)
    assert td.cache_specs(cfg, quantize_kv=True)[0]["k_s"] == P(
        ("dp",), None, "tp")
    assert c[0]["k"].local(0).shape == (1, 16, 1, 8)
    ptrs = {c[0]["k"].local(r).data_ptr() for r in range(8)}
    assert len(ptrs) == 8
    assert td.decode_batch_axes(cfg) == ("dp",)
    assert td.decode_batch_axes(tt.TransformerConfig(**MOE)) == ("dp", "ep")
    wide = make_mesh((1, 4), ("dp", "tp"), devices=["cpu"] * 4)
    assert td.init_cache(cfg, 1, 4, wide, device="cpu")[0]["k"].shape == (
        1, 4, 4, 8)
    jwide = jmake_mesh((1, 4), ("dp", "tp"))
    assert jd._cache_heads_global(jt.TransformerConfig(**CFG), jwide) == 4


def test_int8_kernel_routes_at_the_local_batch(monkeypatch):
    """AUTO routes the int8 kernel at each rank's LOCAL batch: B=8 over
    dp=2 serves 4 rows a rank (>= KERNEL_MIN_BATCH), so every decode
    step calls the kernel's wrapper once per rank per layer (on the CPU
    it runs its plain version), and with a cache past 2048 positions the
    length rounds up to 4096; B=4 over dp=2 (2 a rank) stays on the
    einsum route. Tokens equal the dense generator's either way."""
    from mpistragglers_jl_tpu_torch.ops import decode_attention as da

    _, cfg, _, tp = _pair(D128, seed=9)
    mesh = make_mesh((2, 2), ("dp", "tp"), devices=["cpu"] * 4)
    sp = tt.shard_params(tp, cfg, mesh)
    calls, lengths = [], []
    real, zero = da.quantized_decode_attention, td._zero_cache_layer

    def spy(q, cache_l, *a, **k):
        calls.append(tuple(q.shape))
        return real(q, cache_l, *a, **k)

    def zspy(B, L, *a):
        lengths.append(L)
        return zero(B, L, *a)

    monkeypatch.setattr(da, "quantized_decode_attention", spy)
    monkeypatch.setattr(td, "_zero_cache_layer", zspy)
    for B, n_new, Tp, want_calls, want_len in ((8, 5, 6, 4 * 2 * 4, 11),
                                               (4, 5, 6, 0, 11),
                                               (8, 3, 2047, 2 * 2 * 4, 4096)):
        calls.clear()
        lengths.clear()
        prompt = _tokens(97, B, Tp, seed=B + Tp)
        got = td.make_generate(cfg, mesh, n_new, quantize_kv=True)(sp, prompt)
        assert len(calls) == want_calls, (B, Tp, len(calls))
        assert all(s == (B // 2, 1, 1, 128) for s in calls)
        assert set(lengths) == {want_len}, lengths
        if Tp < 64:
            np.testing.assert_array_equal(got.gather().numpy(),
                                          td.generate_dense(
                                              tp, prompt, n_new, cfg,
                                              quantize_kv=True,
                                              device="cpu").numpy())


def test_models_exports_match_the_reference():
    """``models/__init__.py`` names each export's home module as the JAX
    package's does, this slice's entry points among them; every name
    resolves. The one reference name the port lacks is ``optax_step``
    (its train steps take ``make_optax_train_step``)."""
    from mpistragglers_jl_tpu import models as jm
    from mpistragglers_jl_tpu_torch import models as tm

    for name, home in tm._HOME.items():
        assert jm._HOME[name] == home, name
        assert getattr(tm, name) is not None
    assert set(jm._HOME) - set(tm._HOME) == {"optax_step"}
    for name in ("init_cache", "cache_specs", "decode_batch_axes",
                 "shard_cache", "make_prefill", "make_decode_step",
                 "make_extend", "make_generate", "make_ring_generate",
                 "make_speculative", "make_serving_scan"):
        assert name in tm.__all__
