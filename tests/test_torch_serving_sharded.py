"""The port's sharded serving tick (mpistragglers_jl_tpu_torch/models/
serving.py ``make_serving_scan``) on CPU ranks against the JAX package's
``make_serving_scan`` on its host devices and the port's dense per-row
step: the mesh cases of the JAX package's tests/test_serving.py (f32,
int8, kv_heads < tp), the dry run's (dp, sp, tp) mesh whose sp
replicates, and a sampled tick with per-slot keys; parameters carried
over by ``params_from_jax``, caches and tokens made with numpy from a
seed.

Tolerances: tokens, positions and done flags equal; the caches after
the tick within 1e-5 of the JAX tick's (int8 codes within one step,
scales 1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.models import decode as jd
from mpistragglers_jl_tpu.models import serving as js
from mpistragglers_jl_tpu.models import transformer as jt
from mpistragglers_jl_tpu.parallel import make_mesh as jmake_mesh
from mpistragglers_jl_tpu_torch.models import decode as td
from mpistragglers_jl_tpu_torch.models import serving as ts
from mpistragglers_jl_tpu_torch.models import transformer as tt
from mpistragglers_jl_tpu_torch.parallel import PartitionSpec as P, make_mesh

CFG = dict(vocab=61, d_model=64, n_heads=8, n_kv_heads=2, n_layers=2,
           d_ff=128, attn_window=5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(fields, seed):
    jcfg = jt.TransformerConfig(**fields)
    jp = jt.init_params(jcfg, seed)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tt.TransformerConfig(**fields), jp, tp


def _caches(cfg, S, heads, quantize_kv, seed):
    """Per-layer (S, W, heads, Dh) ring rows drawn with numpy, int8 with
    scales when ``quantize_kv`` (the port's quantizer)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(cfg.n_layers):
        layer = {}
        for kk in ("k", "v"):
            x = torch.as_tensor(rng.standard_normal(
                (S, cfg.attn_window, heads, cfg.head_dim)) * 0.1,
                dtype=torch.float32)
            if quantize_kv:
                layer[kk], layer[kk + "_s"] = td._kv_quantize(x)
            else:
                layer[kk] = x
        out.append(layer)
    return out


def _dense_tick(params, cfg, tok, pos, caches, n_inner):
    """n_inner greedy steps of the dense per-row step."""
    caches = [{kk: a.clone() for kk, a in c.items()} for c in caches]
    toks = []
    for _ in range(n_inner):
        lg, caches = ts.serving_decode_step_dense(params, tok, pos, caches,
                                                  cfg)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        pos = pos + 1
        toks.append(tok)
    return torch.stack(toks, dim=1), caches


@pytest.mark.parametrize("shape,axes,quantize_kv,n_inner,seed", [
    ((2, 2), ("dp", "tp"), False, 3, 0),        # tests/test_serving.py:185
    ((2, 2), ("dp", "tp"), True, 2, 3),         # :317
    ((1, 4), ("dp", "tp"), False, 2, 9),        # :352, kv_heads 2 < tp 4
    ((2, 2, 2), ("dp", "sp", "tp"), False, 2, 5),  # the dry run's mesh
])
def test_sharded_serving_tick_matches_jax(shape, axes, quantize_kv, n_inner,
                                          seed):
    """The tick's tokens, positions, done flags and caches against the
    JAX tick's, its tokens against the dense per-row step's (on the
    cache of kv_heads heads: with kv_heads < tp the tick reads the
    replicated-groups copy, slot t holding kv head t * kv_heads // tp);
    every replica of a slot over sp and tp holds the same rows."""
    jcfg, tcfg, jp, tparams = _pair(CFG, seed=1)
    S = 4
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, 61, S).astype(np.int32)
    pos = rng.integers(3, 9, S).astype(np.int32)
    done = np.zeros(S, bool)
    jmesh = jmake_mesh(shape, axes)
    mesh = make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))
    heads = td._cache_heads_global(tcfg, mesh)
    dense = _caches(tcfg, S, tcfg.kv_heads, quantize_kv, seed)
    slot = torch.arange(heads) * tcfg.kv_heads // heads
    laid = [{kk: a[:, :, slot] for kk, a in c.items()} for c in dense]
    keys = jax.random.split(jax.random.key(0), S)
    jout = js.make_serving_scan(jcfg, jmesh, n_inner,
                                quantize_kv=quantize_kv)(
        jp, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(done),
        [{kk: jnp.asarray(a.numpy()) for kk, a in c.items()} for c in laid],
        keys)
    out = ts.make_serving_scan(tcfg, mesh, n_inner, quantize_kv=quantize_kv)(
        tt.shard_params(tparams, tcfg, mesh), tok, pos, done, laid)
    assert out[4].spec == P("dp", None) and out[4].shape == (S, n_inner)
    for got, want in zip(out[:3], jout[:3]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(out[4]), np.asarray(jout[4]))
    for layer, jlayer in zip(out[3], jout[3]):
        for kk, a in layer.items():
            got, want = a.gather().numpy(), np.asarray(jlayer[kk])
            if kk in ("k", "v") and quantize_kv:
                assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
            if "sp" in axes:  # sp members hold the same rows and heads
                for group in mesh.axis_groups("sp"):
                    assert all(torch.equal(a.local(r), a.local(group[0]))
                               for r in group)
    for group in mesh.axis_groups([x for x in axes if x != "dp"]):
        for value in out[:3] + (out[4],):
            assert all(torch.equal(value.local(r), value.local(group[0]))
                       for r in group)
    want_toks, _ = _dense_tick(tparams, tcfg, torch.as_tensor(tok),
                               torch.as_tensor(pos), dense, n_inner)
    assert torch.equal(out[4].gather(), want_toks)


def test_sampled_sharded_serving_tick_matches_jax():
    """temperature 0.8, top_k 7: every slot samples as row 0 of its own
    stream with its own key, on the mesh as in the JAX tick; the keys
    are the JAX keys' data."""
    jcfg, tcfg, jp, tparams = _pair(CFG, seed=1)
    S, n_inner = 4, 3
    rng = np.random.default_rng(2)
    tok = rng.integers(1, 61, S).astype(np.int32)
    pos = rng.integers(3, 9, S).astype(np.int32)
    done = np.zeros(S, bool)
    caches = _caches(tcfg, S, 2, False, 2)
    keys = jax.random.split(jax.random.key(4), S)
    kw = dict(temperature=0.8, top_k=7)
    jout = js.make_serving_scan(jcfg, jmake_mesh((2, 2), ("dp", "tp")),
                                n_inner, **kw)(
        jp, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(done),
        [{kk: jnp.asarray(a.numpy()) for kk, a in c.items()}
         for c in caches], keys)
    mesh = make_mesh((2, 2), ("dp", "tp"), devices=["cpu"] * 4)
    f = ts.make_serving_scan(tcfg, mesh, n_inner, **kw)
    sp = tt.shard_params(tparams, tcfg, mesh)
    out = f(sp, tok, pos, done, caches, np.asarray(jax.random.key_data(keys)))
    np.testing.assert_array_equal(np.asarray(out[4]), np.asarray(jout[4]))
    with pytest.raises(ValueError, match="keys"):
        f(sp, tok, pos, done, caches)


def test_make_serving_scan_checks():
    """The reference's refusals: a window config, sampling parameters,
    no experts, kv heads and tp nesting; and a mesh without dp."""
    cfg = tt.TransformerConfig(**CFG)
    mesh = make_mesh((2, 2), ("dp", "tp"), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="ring cache"):
        ts.make_serving_scan(dataclasses.replace(cfg, attn_window=None),
                             mesh, 2)
    with pytest.raises(ValueError, match="temperature"):
        ts.make_serving_scan(cfg, mesh, 2, temperature=-1.0)
    with pytest.raises(ValueError, match="dense-FFN"):
        ts.make_serving_scan(dataclasses.replace(cfg, n_experts=2), mesh, 2)
    odd = dataclasses.replace(cfg, n_heads=6, n_kv_heads=3, d_model=48)
    with pytest.raises(ValueError, match="must nest"):
        ts.make_serving_scan(odd, make_mesh((1, 2), ("dp", "tp"),
                                            devices=["cpu"] * 2), 2)
    with pytest.raises(ValueError, match=r"lacks \['dp'\]"):
        ts.make_serving_scan(cfg, make_mesh((2,), ("tp",),
                                            devices=["cpu"] * 2), 2)
    jcfg = jt.TransformerConfig(**CFG)
    with pytest.raises(ValueError, match="dense-FFN"):
        js.make_serving_scan(dataclasses.replace(jcfg, n_experts=2),
                             jmake_mesh((2, 2), ("dp", "tp")), 2)
    assert jd._cache_heads_global(jcfg, jmake_mesh((1, 4), ("dp", "tp"))) \
        == td._cache_heads_global(cfg, make_mesh((1, 4), ("dp", "tp"),
                                                 devices=["cpu"] * 4))
