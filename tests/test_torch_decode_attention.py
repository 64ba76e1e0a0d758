"""The port's int8 decode attention (mpistragglers_jl_tpu_torch/ops/
decode_attention.py), dense and paged, against the JAX package's Pallas
kernels, run in interpret mode, and its einsum paths, on the same numpy
inputs.

On the CPU the port's wrapper runs its plain PyTorch version, which is
what these tests hold against the reference (f32, max abs 2e-5: the two
sum in different orders). The CUDA kernels against the plain versions
are in tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.models.decode import (
    _kv_quantize as jax_kv_quantize,
    _cached_attention as jax_cached_attention,
)
from mpistragglers_jl_tpu.models.serving import (
    _paged_gather as jax_paged_gather,
    _ring_attention_rows as jax_ring_rows,
)
from mpistragglers_jl_tpu.ops.decode_attention import (
    _pick_block_128,
    paged_block_viable as jax_paged_block_viable,
    quantized_decode_attention as jax_qda,
)
from mpistragglers_jl_tpu_torch.ops import decode_attention as da

ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once, and timing-sensitive tests elsewhere share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, L, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    kq, ks = jax_kv_quantize(jnp.asarray(
        rng.standard_normal((B, L, Hkv, D)), jnp.float32))
    vq, vs = jax_kv_quantize(jnp.asarray(
        rng.standard_normal((B, L, Hkv, D)), jnp.float32))
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    cache = {"k": np.array(kq), "k_s": np.array(ks),
             "v": np.array(vq), "v_s": np.array(vs)}
    return q, cache


def _jax(cache):
    return {k: jnp.asarray(v) for k, v in cache.items()}


def _torch(cache):
    return {k: torch.as_tensor(v) for k, v in cache.items()}


def _port(q, cache, pos, scale, window=None, ring=False):
    pos_t = torch.as_tensor(np.asarray(pos, np.int32))
    out = da.quantized_decode_attention(
        torch.as_tensor(q), _torch(cache), pos_t, scale, window, ring=ring
    )
    return out.numpy()


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2), (8, 2), (8, 1)])
@pytest.mark.parametrize("pos", [0, 130, 255])
def test_positional_matches_pallas_and_einsum(Hq, Hkv, pos):
    B, L, D = 2, 256, 128
    q, cache = _inputs(B, L, Hq, Hkv, D, seed=pos + Hq)
    scale = D ** -0.5
    got = _port(q, cache, pos, scale)
    want = jax_qda(jnp.asarray(q), _jax(cache), jnp.int32(pos), scale,
                   block_k=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    ein = jax_cached_attention(jnp.asarray(q), _jax(cache),
                               jnp.asarray([pos], jnp.int32), scale,
                               use_kernel=False)
    np.testing.assert_allclose(got, np.asarray(ein), rtol=0, atol=ATOL)


@pytest.mark.parametrize("window", [5, 64, 1000])
def test_window_matches_pallas_and_einsum(window):
    B, L, Hq, Hkv, D = 2, 256, 8, 2, 128
    q, cache = _inputs(B, L, Hq, Hkv, D, seed=window)
    scale = D ** -0.5
    pos = 200
    got = _port(q, cache, pos, scale, window=window)
    want = jax_qda(jnp.asarray(q), _jax(cache), jnp.int32(pos), scale,
                   window=window, block_k=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    ein = jax_cached_attention(jnp.asarray(q), _jax(cache),
                               jnp.asarray([pos], jnp.int32), scale,
                               window, use_kernel=False)
    np.testing.assert_allclose(got, np.asarray(ein), rtol=0, atol=ATOL)


@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (4, 2), (8, 2), (8, 1)])
def test_ring_per_row_positions_match_pallas_and_einsum(Hq, Hkv):
    """Per-row positions in ring mode, the serving tick's call: rows in
    warm-up, at the wrap boundary, and deep in the stream."""
    B, W, D = 4, 256, 128
    q, cache = _inputs(B, W, Hq, Hkv, D, seed=Hq * 10 + Hkv)
    scale = D ** -0.5
    pos = np.asarray([3, 255, 256, 1000], np.int32)
    got = _port(q, cache, pos, scale, ring=True)
    want = jax_qda(jnp.asarray(q), _jax(cache), jnp.asarray(pos), scale,
                   ring=True, block_k=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    ein = jax_ring_rows(jnp.asarray(q), _jax(cache), jnp.asarray(pos),
                        scale, use_kernel=False)
    np.testing.assert_allclose(got, np.asarray(ein), rtol=0, atol=ATOL)


@pytest.mark.parametrize("pos", [0, 37, 129, 1000])
def test_ring_scalar_position_matches_pallas(pos):
    B, W, Hq, Hkv, D = 2, 128, 8, 2, 128
    q, cache = _inputs(B, W, Hq, Hkv, D, seed=pos)
    scale = D ** -0.5
    got = _port(q, cache, pos, scale, ring=True)
    want = jax_qda(jnp.asarray(q), _jax(cache), jnp.int32(pos), scale,
                   ring=True, block_k=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_future_positions_never_leak():
    """Poisoned scales past pos must not reach the output."""
    B, L, Hq, Hkv, D = 1, 128, 4, 2, 128
    q, cache = _inputs(B, L, Hq, Hkv, D, seed=1)
    poisoned = {k: v.copy() for k, v in cache.items()}
    poisoned["k_s"][:, 40:] = 1e9
    poisoned["v_s"][:, 40:] = 1e9
    scale = D ** -0.5
    np.testing.assert_array_equal(_port(q, cache, 39, scale),
                                  _port(q, poisoned, 39, scale))


def test_cpu_wrapper_runs_plain_version_and_counts_nothing():
    q, cache = _inputs(2, 128, 8, 2, 128, seed=3)
    before = da.LAUNCHES["quantized_decode_attention"]
    qt = torch.as_tensor(q)
    got = da.quantized_decode_attention(qt, _torch(cache), 77, 0.1)
    ref = da.quantized_decode_attention_ref(qt, _torch(cache), 77, 0.1)
    assert torch.equal(got, ref)
    assert da.LAUNCHES["quantized_decode_attention"] == before


def test_bf16_q_keeps_its_dtype_and_tracks_f32():
    """bf16 q: f32 accumulation, bf16 out (within bf16 rounding of the
    f32 result on the same bf16-representable q)."""
    q, cache = _inputs(2, 128, 8, 2, 128, seed=4)
    q16 = torch.as_tensor(q).to(torch.bfloat16)
    out = da.quantized_decode_attention(q16, _torch(cache), 100, 0.1,
                                        ring=True)
    assert out.dtype == torch.bfloat16
    f32 = da.quantized_decode_attention(q16.float(), _torch(cache), 100,
                                        0.1, ring=True)
    np.testing.assert_allclose(out.float().numpy(), f32.numpy(),
                               rtol=1e-2, atol=1e-2)


def test_argument_errors():
    q, cache = _inputs(1, 128, 4, 2, 128, seed=5)
    qt, ct = torch.as_tensor(q), _torch(cache)
    with pytest.raises(ValueError, match="ring"):
        da.quantized_decode_attention(qt, ct, 0, 1.0, 64, ring=True)
    pt = torch.zeros(1, 1, dtype=torch.int32)
    pool = {k: v[0] for k, v in ct.items()}
    with pytest.raises(ValueError, match="ring=True"):
        da.quantized_decode_attention(qt, pool, 0, 1.0, page_table=pt,
                                      page_tokens=128)
    with pytest.raises(ValueError, match="needs page_tokens"):
        da.quantized_decode_attention(qt, pool, 0, 1.0, ring=True,
                                      page_table=pt)
    with pytest.raises(ValueError, match="not a multiple"):
        da.quantized_decode_attention(qt, pool, 0, 1.0, ring=True,
                                      page_table=pt, page_tokens=100)
    with pytest.raises(ValueError, match="page table must be"):
        da.quantized_decode_attention(qt, pool, 0, 1.0, ring=True,
                                      page_table=pt[0], page_tokens=128)
    with pytest.raises(ValueError, match="single-query"):
        da.quantized_decode_attention(qt.expand(1, 2, 4, 128), ct, 0, 1.0)


@pytest.mark.parametrize("Hkv,D", [(1, 128), (2, 128), (8, 128), (2, 256)])
def test_viability_predicate_matches_reference_block_picker(Hkv, D):
    for L in (1, 100, 128, 129, 1000, 1024, 4096, 4224, 5000, 6000, 8192,
              8200, 12800, 16384, 20000):
        want = _pick_block_128(L, da.DEFAULT_BLOCK_K, Hkv, D) is not None
        assert da.decode_kernel_viable(L, Hkv, D) == want, (L, Hkv, D)


def _paged_inputs(B, W, P, Hq, Hkv, D, seed):
    """A pool of B * W/P + 3 pages (page 0 the null page), a page table
    from a seeded permutation with two pages shared by rows 1 and 2,
    and null entries past row 0's budget (it is in warm-up)."""
    rng = np.random.default_rng(seed)
    mp = W // P
    n_pages = B * mp + 3
    kq, ks = jax_kv_quantize(jnp.asarray(
        rng.standard_normal((n_pages * P, Hkv, D)), jnp.float32))
    vq, vs = jax_kv_quantize(jnp.asarray(
        rng.standard_normal((n_pages * P, Hkv, D)), jnp.float32))
    pool = {"k": np.array(kq), "k_s": np.array(ks),
            "v": np.array(vq), "v_s": np.array(vs)}
    pt = rng.permutation(np.arange(1, n_pages))[:B * mp].reshape(B, mp)
    pt = pt.astype(np.int32)
    pt[1, :2] = pt[2, :2]
    pt[0, 1:] = 0
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    pos = np.asarray([P // 2, W - 1, W, 3 * W + 17], np.int32)[:B]
    return q, pool, pt, pos


@pytest.mark.parametrize("P", [8, 16, 64])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2), (8, 1)])
def test_paged_matches_pallas_paged_kernel(P, Hq, Hkv):
    """The paged plain version (the port's wrapper on the CPU) against
    the reference's ``_paged_kernel`` interpreted: rows in warm-up with
    null pages past their budget, at W - 1, at W and wrapped, two pages
    shared by two rows. f32, max abs 2e-5."""
    B, W, D = 4, 128, 128
    q, pool, pt, pos = _paged_inputs(B, W, P, Hq, Hkv, D, seed=P + Hq + Hkv)
    scale = D ** -0.5
    got = da.quantized_decode_attention(
        torch.as_tensor(q), _torch(pool), torch.as_tensor(pos), scale,
        ring=True, page_table=torch.as_tensor(pt), page_tokens=P)
    want = jax_qda(jnp.asarray(q), _jax(pool), jnp.asarray(pos), scale,
                   ring=True, page_table=jnp.asarray(pt), page_tokens=P,
                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_paged_equals_dense_ring_on_the_gathered_view():
    """The paged function is the ring function on each row's gathered
    view, exactly, and the gather itself is the reference's."""
    q, pool, pt, pos = _paged_inputs(4, 128, 16, 8, 2, 128, seed=9)
    args = (torch.as_tensor(q), _torch(pool), torch.as_tensor(pos), 0.1)
    ptt = torch.as_tensor(pt)
    view = {k: da.paged_ring_view(v, ptt, 16) for k, v in args[1].items()}
    want = da.quantized_decode_attention_ref(args[0], view, args[2], 0.1,
                                             ring=True)
    got = da.paged_decode_attention_ref(*args, ptt, 16)
    assert torch.equal(got, want)
    jview = jax_paged_gather(_jax(pool), jnp.asarray(pt), 128, 16)
    for k in view:
        np.testing.assert_array_equal(view[k].numpy(), np.asarray(jview[k]))


def test_paged_block_viability_matches_reference():
    """Where the parity tests run (interpret mode) both packages route
    the same page sizes."""
    for P in range(0, 200):
        assert da.paged_block_viable(P) == jax_paged_block_viable(P), P
