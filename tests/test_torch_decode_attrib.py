"""K7's plain versions (``decode_attention_attrib_ref`` in
mpistragglers_jl_tpu_torch/ops/decode_attention.py, which the wrapper
runs on CPU tensors) against the reference's attribution kernels.

The reference kernels live inside ``main()`` of
benchmarks/decode_kernel_attrib.py, which returns only timings, so the
kernel body and its ``pallas_call`` (``:149-233``) are copied here with
``interpret=True``. Same numpy inputs to both. ``dma`` is exact (integer
sums); ``dot``, ``dequant`` and ``full_nosm`` sum in f32 in other orders
and agree within 1e-5 of the largest value. The reference's 8-row
group padding must hold zeros; the port returns the rows without it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mpistragglers_jl_tpu.ops.decode_attention import (
    _LANE,
    _NEG,
    _SUB,
    _pick_block_128 as jax_pick_block_128,
)
from mpistragglers_jl_tpu.ops.flash_attention import _CompilerParams, _sds
from mpistragglers_jl_tpu_torch.ops import decode_attention as da

B, L, H, Hkv, D, BK = 2, 512, 8, 2, 128, 128
K7 = "decode_attention_attrib"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once, and timing-sensitive tests elsewhere share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_variant(mode, q, cache, scale, bk_eff):
    """benchmarks/decode_kernel_attrib.py ``variant(mode)``'s kernel and
    ``run``, copied, interpreted. Returns the (B, Hkv*8, D) f32 output,
    padding rows included."""
    B, _, H, D = q.shape
    L, Hkv = cache["k"].shape[1], cache["k"].shape[2]
    g = H // Hkv
    nk = L // bk_eff

    def kern(pos_ref, q_ref, k_ref, ks_ref, v_ref, vs_ref, o_ref,
             acc, m_sc, l_sc):
        j = pl.program_id(1)

        @pl.when(j == 0)
        def _init():
            acc[:] = jnp.zeros_like(acc)
            m_sc[:] = jnp.full_like(m_sc, _NEG)
            l_sc[:] = jnp.zeros_like(l_sc)

        kblk = k_ref[0]
        vblk = v_ref[0]
        if mode == "dma":
            acc[:1, :1] += (
                kblk[:1, :1].astype(jnp.float32)
                + vblk[:1, :1].astype(jnp.float32)
            )
        else:
            ksb = ks_ref[0].astype(jnp.float32)
            vsb = vs_ref[0].astype(jnp.float32)
            for h in range(Hkv):
                rows = slice(h * _SUB, (h + 1) * _SUB)
                qh = q_ref[0][rows]
                kb = kblk[:, h * D:(h + 1) * D].astype(qh.dtype)
                s = jax.lax.dot_general(
                    qh, kb, (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32,
                ) * scale
                if mode != "dot":
                    s = s * ksb[:, h][None, :]
                if mode == "full_nosm":
                    vb = vblk[:, h * D:(h + 1) * D].astype(jnp.float32)
                    pv = s * vsb[:, h][None, :]
                    acc[rows] += jax.lax.dot_general(
                        pv, vb, (((1,), (0,)), ((), ())),
                        preferred_element_type=jnp.float32,
                    )
                else:
                    acc[rows, :1] += s.max(axis=-1, keepdims=True)

        @pl.when(j == nk - 1)
        def _fin():
            o_ref[0] = acc[:].astype(o_ref.dtype)

    rows = Hkv * _SUB
    q3 = jnp.pad(
        q.reshape(B, Hkv, g, D), ((0, 0), (0, 0), (0, _SUB - g), (0, 0))
    ).reshape(B, rows, D)
    kf = cache["k"].reshape(B, L, Hkv * D)
    vf = cache["v"].reshape(B, L, Hkv * D)
    return pl.pallas_call(
        kern,
        grid=(B, nk),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec((1, rows, D), lambda b, j: (b, 0, 0)),
            pl.BlockSpec((1, bk_eff, Hkv * D), lambda b, j: (b, j, 0)),
            pl.BlockSpec((1, bk_eff, Hkv), lambda b, j: (b, j, 0)),
            pl.BlockSpec((1, bk_eff, Hkv * D), lambda b, j: (b, j, 0)),
            pl.BlockSpec((1, bk_eff, Hkv), lambda b, j: (b, j, 0)),
        ],
        out_specs=pl.BlockSpec((1, rows, D), lambda b, j: (b, 0, 0)),
        out_shape=_sds((B, rows, D), jnp.float32, q3),
        scratch_shapes=[
            pltpu.VMEM((rows, D), jnp.float32),
            pltpu.VMEM((rows, _LANE), jnp.float32),
            pltpu.VMEM((rows, _LANE), jnp.float32),
        ],
        compiler_params=_CompilerParams(
            dimension_semantics=("parallel", "arbitrary")
        ),
        interpret=True,
    )(jnp.full((B,), L - 1, jnp.int32), q3, kf, cache["k_s"], vf,
      cache["v_s"])


@functools.lru_cache(maxsize=1)
def _inputs():
    """The reference bench's draws, in its order, at the test's shape:
    q, int8 k and v, f32 scales."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, 1, H, D))
    cache = {
        "k": rng.integers(-127, 128, (B, L, Hkv, D)).astype(np.int8),
        "v": rng.integers(-127, 128, (B, L, Hkv, D)).astype(np.int8),
        "k_s": (rng.random((B, L, Hkv)) * 0.01).astype(np.float32),
        "v_s": (rng.random((B, L, Hkv)) * 0.01).astype(np.float32),
    }
    return q, cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", sorted(da.ATTRIB_MODES))
def test_plain_version_matches_reference_kernel(mode, dtype):
    q64, cache = _inputs()
    qj = jnp.asarray(q64, getattr(jnp, dtype))
    bk = jax_pick_block_128(L, BK, Hkv, D)
    assert bk == BK
    want = np.asarray(_reference_variant(
        mode, qj, {k: jnp.asarray(v) for k, v in cache.items()}, D ** -0.5,
        bk)).reshape(B, Hkv, _SUB, D)
    g = H // Hkv
    assert not want[:, :, g:].any(), "the reference's padding rows"
    want = want[:, :, :g].reshape(B, H, D)
    qt = torch.as_tensor(np.array(qj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    before = da.LAUNCHES[K7]
    got = da.decode_attention_attrib(
        qt, {k: torch.as_tensor(v) for k, v in cache.items()},
        torch.tensor(L - 1), D ** -0.5, mode, bk).numpy()
    assert da.LAUNCHES[K7] == before  # the plain version, not counted
    assert got.dtype == np.float32 and got.shape == (B, H, D)
    if mode == "dma":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    nonzero = np.zeros((B, H, D), bool)
    if mode == "dma":
        nonzero[:, 0, 0] = True
    elif mode in ("dot", "dequant"):
        nonzero[:, :, 0] = True
    else:
        nonzero[:] = True
    assert not got[~nonzero].any()


def test_short_last_segment():
    """L not a multiple of block_k: the last segment is what is left,
    from a direct loop over the segments."""
    q64, cache = _inputs()
    Lc, bk, g = 400, 96, H // Hkv
    c = {k: torch.as_tensor(v[:, :Lc]) for k, v in cache.items()}
    q = torch.as_tensor(q64).float()
    scale = D ** -0.5
    kf, vf = c["k"].double(), c["v"].double()
    s = torch.einsum("bhgd,blhd->bhgl", q.double().reshape(B, Hkv, g, D),
                     kf) * scale
    starts = range(0, Lc, bk)
    dma = sum(kf[:, j, 0, 0] + vf[:, j, 0, 0] for j in starts)
    for mode, sc in (("dot", s), ("dequant", s * c["k_s"].double()
                                  .permute(0, 2, 1)[:, :, None, :])):
        want = sum(sc[..., j:j + bk].amax(-1) for j in starts)
        got = da.decode_attention_attrib(q, c, 0, scale, mode, bk)
        np.testing.assert_allclose(got[:, :, 0].numpy(),
                                   want.reshape(B, H).numpy(), rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())
    got = da.decode_attention_attrib(q, c, 0, scale, "dma", bk)
    np.testing.assert_array_equal(got[:, 0, 0].numpy(), dma.numpy())


def test_argument_errors():
    q64, cache = _inputs()
    q = torch.as_tensor(q64).float()
    c = {k: torch.as_tensor(v) for k, v in cache.items()}
    with pytest.raises(ValueError, match="mode must be one of"):
        da.decode_attention_attrib(q, c, 0, 1.0, "full", 128)
    for bk in (0, 16, 100):
        with pytest.raises(ValueError, match="multiple of 32"):
            da.decode_attention_attrib(q, c, 0, 1.0, "dot", bk)
    with pytest.raises(ValueError, match="single-query"):
        da.decode_attention_attrib(q.expand(B, 2, H, D), c, 0, 1.0, "dot",
                                   128)


@pytest.mark.parametrize("Hkv_,D_", [(1, 128), (2, 128), (8, 128),
                                     (2, 256), (4, 512)])
def test_pick_block_matches_reference(Hkv_, D_):
    """The port's copy of the block picker over a grid of lengths and
    requested blocks."""
    for Lg in (1, 100, 128, 129, 1000, 1024, 2080, 4096, 4224, 5000, 8192,
               8200, 12800, 16384, 16512, 16640, 20000, 65536):
        for block in (128, 512, 4096, 8192, 16384):
            assert (da._pick_block_128(Lg, block, Hkv_, D_)
                    == jax_pick_block_128(Lg, block, Hkv_, D_)), (Lg, block)
