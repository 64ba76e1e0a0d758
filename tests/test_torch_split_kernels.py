"""The arithmetic of the two redesigned kernels, on the CPU.

The CUDA kernels themselves run only on the card (tests/test_torch_gpu.py,
chip_smoke.py). What they compute differently from their first designs
is written out here in plain PyTorch and held to the plain versions and
to the JAX package:

* K5 and K7 (``ops/csrc/decode_attention.cu``) split the key range into
  ``split_plan`` chunks and fold the splits' partial states with a
  combine step; the emulation below does the same per chunk and must
  equal ``quantized_decode_attention_ref`` (K5, within 1e-5 in f32) and
  ``decode_attention_attrib_ref`` (K7: ``dma`` exactly, the others
  within 1e-5 of the largest value plus 1e-5 relative).
* K1's bf16 kernel (``ops/csrc/flash_attention.cu``) forms Q.K^T from
  exact bf16 products and P.V from P split into two bf16 halves; the
  emulation (64-key tiles, online softmax, hi + lo) must stay within the
  forward's f32 limit, 2e-5 + 2e-5 |x|, of ``_fwd_ref`` and of the JAX
  package's ``flash_attention`` in interpret mode. P rounded to bf16
  alone must miss that limit: the control shows the limit
  discriminates.
"""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.ops import flash_attention as jfa
from mpistragglers_jl_tpu_torch.models import decode as td
from mpistragglers_jl_tpu_torch.ops import decode_attention as da
from mpistragglers_jl_tpu_torch.ops import flash_attention as tfa

NEG = -1e30
FLASH_OUT = 2e-5  # the forward's limit, atol and rtol (f32)
H100_SMS = 132  # the SM count of an H100 SXM, the plan's main card


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ P = hi + lo


def _hi_lo(p):
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


@pytest.mark.parametrize("lo_exp", [-1, -10, -30])
def test_hi_lo_split_error_is_within_2_pow_minus_17(lo_exp):
    """|P - hi - lo| <= 2^-17 P elementwise over (0, 1], down to values
    near 1e-30 (as small as an exp of a score can be and still count)."""
    rng = np.random.default_rng(-lo_exp)
    p = torch.as_tensor(10.0 ** rng.uniform(lo_exp, 0, 200_000),
                        dtype=torch.float32)
    p = torch.cat([p, torch.tensor([1.0, 1e-30, 2.0 ** -100, 0.5])])
    hi, lo = _hi_lo(p)
    err = (p - hi - lo).abs()
    assert bool((err <= 2.0 ** -17 * p).all()), (err / p).max().item()
    # a single bf16 rounding is far coarser: the split is what buys it
    assert (p - hi).abs().max().item() > 2.0 ** -17 * 0.5


# ------------------------------------------------- K5: split and combine


def _cache(B, L, Hkv, D, seed):
    gen = torch.Generator().manual_seed(seed)
    kq, ks = td._kv_quantize(torch.randn(B, L, Hkv, D, generator=gen))
    vq, vs = td._kv_quantize(torch.randn(B, L, Hkv, D, generator=gen))
    return {"k": kq, "k_s": ks, "v": vq, "v_s": vs}, gen


def _visible_range(pos, L, window, ring):
    """The kernel's per-row [lo, hi] from the positions."""
    p = pos.long()
    if ring:
        return torch.zeros_like(p), torch.where(p >= L, L - 1, p)
    hi = torch.clamp(p, max=L - 1)
    lo = torch.zeros_like(p)
    if window is not None:
        lo = torch.clamp(p - window + 1, min=0)
    return lo, hi


def _split_masks(lo, hi, L, chunk, n_split):
    """(B, n_split, L): key t belongs to split s and is visible."""
    t = torch.arange(L)
    c0 = torch.arange(n_split)[:, None] * chunk
    in_chunk = (t >= c0) & (t < c0 + chunk)  # (S, L)
    vis = (t >= lo[:, None]) & (t <= hi[:, None])  # (B, L)
    return in_chunk[None] & vis[:, None]


def _k5_split_combine(q, cache, pos, scale, window=None, ring=False):
    """K5's algebra, per split then combined, in plain torch f32."""
    B, _, H, D = q.shape
    L, Hkv = cache["k"].shape[1:3]
    g = H // Hkv
    chunk, n_split = da.split_plan(B, Hkv, L, n_sm=H100_SMS)
    lo, hi = _visible_range(pos, L, window, ring)
    vis = _split_masks(lo, hi, L, chunk, n_split)[:, None, None]  # B,1,1,S,L
    q5 = q.float().reshape(B, Hkv, g, D)
    s = torch.einsum("bhgd,blhd->bhgl", q5, cache["k"].float()) * scale
    s = (s * cache["k_s"].permute(0, 2, 1)[:, :, None, :])[:, :, :, None]
    s = torch.where(vis, s, NEG)  # (B, Hkv, g, S, L)
    m = s.amax(-1)  # an empty split keeps -1e30
    p = torch.where(vis, torch.exp(s - m[..., None]), 0.0)
    part_l = p.sum(-1)
    pv = p * cache["v_s"].permute(0, 2, 1)[:, :, None, None, :]
    part_acc = torch.einsum("bhgsl,blhd->bhgsd", pv, cache["v"].float())
    empty = ~vis.any(-1)
    assert bool((m[empty.expand_as(m)] == NEG).all())
    # the combine kernel
    M = m.amax(-1, keepdim=True)
    w = torch.exp(m - M)
    l_tot = (part_l * w).sum(-1)
    acc = (part_acc * w[..., None]).sum(-2)
    o = acc / l_tot.clamp_min(1e-20)[..., None]
    return o.reshape(B, 1, H, D), n_split, empty


K5_CASES = [
    # (B, L, kwargs, positions): positional at the end, mid-way and near
    # the start (later chunks empty), one row with nothing visible (-1)
    (4, 4096, {}, [4095, 2047, 37, -1]),
    # a window whose lower edge cuts chunks in two
    (4, 4096, {"window": 1000}, [4095, 3000, 999, 150]),
    # a ragged length: the last chunk is short
    (3, 1000, {}, [999, 500, 0]),
    (3, 1000, {"window": 77}, [999, 421, 5]),
    # the ring: warm-up, W - 1, W, wrapped, and nothing visible
    (8, 1024, {"ring": True}, [0, 7, 31, 32, 1023, 1024, 5000, -1]),
]


@pytest.mark.parametrize("B,L,kw,positions", K5_CASES)
def test_k5_split_and_combine_equal_the_plain_version(B, L, kw, positions):
    Hkv, g, D = 2, 4, 32
    cache, gen = _cache(B, L, Hkv, D, seed=L + B)
    q = torch.randn(B, 1, Hkv * g, D, generator=gen)
    pos = torch.tensor(positions, dtype=torch.int32)
    scale = D ** -0.5
    got, n_split, empty = _k5_split_combine(q, cache, pos, scale, **kw)
    want = da.quantized_decode_attention_ref(q, cache, pos, scale, **kw)
    assert n_split > 1
    assert bool(empty.any()), "the case should hold chunks with no key"
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-5)
    if -1 in positions:
        row = positions.index(-1)
        assert bool((got[row] == 0).all()) and bool((want[row] == 0).all())


# ------------------------------------------------- K7: per-mode combine


def _k7_split_combine(q, cache, scale, mode, block_k):
    """K7's per-split partials and each mode's combine, plain torch."""
    B, _, H, D = q.shape
    L, Hkv = cache["k"].shape[1:3]
    g = H // Hkv
    chunk, n_split = da.split_plan(B, Hkv, L, block_k, n_sm=H100_SMS)
    assert block_k % chunk == 0
    kf, vf = cache["k"].float(), cache["v"].float()
    out = torch.zeros(B, H, D)
    starts = torch.arange(n_split) * chunk
    if mode == "dma":
        # a split holds a segment start only at its first key
        part = torch.where(starts % block_k == 0,
                           kf[:, starts, 0, 0] + vf[:, starts, 0, 0], 0.0)
        out[:, 0, 0] = part.sum(-1)
        return out
    vis = _split_masks(torch.zeros(B, dtype=torch.long),
                       torch.full((B,), L - 1), L, chunk,
                       n_split)[:, None, None]
    q5 = q.float().reshape(B, Hkv, g, D)
    s = torch.einsum("bhgd,blhd->bhgl", q5, kf) * scale
    if mode != "dot":
        s = s * cache["k_s"].permute(0, 2, 1)[:, :, None, :]
    s = s[:, :, :, None]
    if mode == "full_nosm":
        pv = torch.where(vis, s * cache["v_s"].permute(0, 2, 1)[
            :, :, None, None, :], 0.0)
        part = torch.einsum("bhgsl,blhd->bhgsd", pv, vf)
        return part.sum(-2).reshape(B, H, D)
    part = torch.where(vis, s, NEG).amax(-1)  # (B, Hkv, g, S)
    per_seg = block_k // chunk
    seg = sum(c.amax(-1) for c in part.split(per_seg, dim=-1))
    out[:, :, 0] = seg.reshape(B, H)
    return out


@pytest.mark.parametrize("B,L,block_k", [(1, 4096, 1024), (2, 1024, 256),
                                         (4, 1000, 160), (3, 96, 32)])
@pytest.mark.parametrize("mode", list(da.ATTRIB_MODES))
def test_k7_per_mode_combine_equals_the_plain_version(B, L, block_k, mode):
    Hkv, g, D = 2, 4, 32
    cache, gen = _cache(B, L, Hkv, D, seed=block_k + B)
    q = torch.randn(B, 1, Hkv * g, D, generator=gen)
    scale = D ** -0.5
    got = _k7_split_combine(q, cache, scale, mode, block_k)
    want = da.decode_attention_attrib_ref(q, cache, L - 1, scale, mode,
                                          block_k)
    if mode == "dma":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


# ------------------------------------------------------ the split picker


@pytest.mark.parametrize("B,Hkv,L,block_k", [
    (1, 2, 16384, None), (4, 2, 16384, None), (8, 2, 16384, None),
    (8, 2, 1024, None), (8, 8, 1024, None), (1, 1, 1, None),
    (200, 8, 333, None), (1, 2, 16384, 4096), (2, 2, 1024, 256),
    (4, 2, 1000, 160), (3, 2, 96, 32), (1, 2, 2048, 512), (1, 2, 100, 4096),
])
def test_split_plan_cuts_whole_tiles(B, Hkv, L, block_k):
    chunk, n_split = da.split_plan(B, Hkv, L, block_k, n_sm=H100_SMS)
    assert isinstance(chunk, int) and isinstance(n_split, int)
    assert chunk % 32 == 0 and chunk >= 32
    assert n_split == -(-L // chunk)  # every split holds a key
    if block_k is not None:
        assert block_k % chunk == 0  # no split straddles a segment
    # at most about two blocks per SM of the card
    assert n_split == 1 or B * Hkv * n_split <= 2 * H100_SMS


def test_split_plan_reads_shapes_only():
    """The plan is a function of (B, Hkv, L, block_k) alone: no tensor,
    no positions, so a decode step never syncs; at the main path's
    shapes it gives the grids the kernel note describes."""
    params = list(inspect.signature(da.split_plan).parameters)
    assert params == ["B", "Hkv", "L", "block_k", "n_sm"]
    plan = functools.partial(da.split_plan, n_sm=H100_SMS)
    assert plan(1, 2, 16384) == (256, 64)  # 128 blocks
    assert plan(8, 2, 1024) == (128, 8)  # the serving shape
    # K7 at the attribution bench's shape takes K5's grid
    assert plan(1, 2, 16384, 4096) == plan(1, 2, 16384)


@pytest.mark.parametrize("n_sm", [78, 114, 132, 144])
@pytest.mark.parametrize("B,L", [(1, 16384), (4, 16384), (8, 1024)])
def test_split_plan_follows_the_sm_count(n_sm, B, L):
    """The grid aims at about one block per SM of the card it is given:
    never above it by more than the four-tile floor allows, and no more
    than one chunk of tiles short of it."""
    chunk, n_split = da.split_plan(B, 2, L, n_sm=n_sm)
    blocks = B * 2 * n_split
    assert blocks <= n_sm or chunk == 4 * 32
    assert B * 2 * -(-L // (chunk - 32)) > n_sm or chunk == 4 * 32


# ------------------------------------------------ K1: tensor-core numerics


def _k1_emulate(q3, k3, v3, scale, causal, window, g, split_p=True):
    """K1's bf16 kernel in plain torch: 64-key tiles, exact bf16 products
    summed in f32 for S, online softmax in f32, and P.V as hi.V + lo.V
    (``split_p``) or bf16(P).V alone."""
    q = q3.float()
    k = k3.float().repeat_interleave(g, 0)
    v = v3.float().repeat_interleave(g, 0)
    BH, Lq, D = q.shape
    Lk = k.shape[1]
    qp = torch.arange(Lq)[:, None]
    m = torch.full((BH, Lq, 1), NEG)
    l = torch.zeros(BH, Lq, 1)
    o = torch.zeros(BH, Lq, D)
    for k0 in range(0, Lk, 64):
        kp = torch.arange(k0, min(k0 + 64, Lk))[None, :]
        vis = torch.ones(Lq, kp.shape[1], dtype=torch.bool)
        if causal:
            vis &= kp <= qp
        if window is not None:
            vis &= qp - kp < window
        s = torch.matmul(q, k[:, k0:k0 + 64].transpose(1, 2)) * scale
        s = torch.where(vis, s, NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(vis, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        hi, lo = _hi_lo(p)
        vt = v[:, k0:k0 + 64]
        pv = torch.matmul(hi, vt) + (torch.matmul(lo, vt) if split_p else 0)
        o = o * corr + pv
        m = m_new
    l = l.clamp_min(1e-20)
    return o / l, m + torch.log(l)


def _share_used(got, want):
    want = torch.as_tensor(np.array(want))
    return ((got - want).abs() / (FLASH_OUT + FLASH_OUT * want.abs())
            ).max().item()


def _bf16_arrays(shapes, seed):
    """Seeded normal arrays holding bf16 values (what the kernel reads),
    as f32 numpy for both packages."""
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16).float().numpy() for s in shapes]


@pytest.mark.parametrize("L,causal,window,hkv", [
    (256, True, None, 2), (256, False, 100, 1), (256, True, 70, 4)])
def test_k1_tensor_core_arithmetic_holds_the_forward_limit(L, causal, window,
                                                           hkv):
    """The emulation against the plain version and the JAX kernel
    (interpret mode) on the same numpy inputs; with P in bf16 alone it
    misses the same limit."""
    B, H, D = 1, 4, 64
    g, scale = H // hkv, D ** -0.5
    q3, k3, v3 = _bf16_arrays([(B * H, L, D), (B * hkv, L, D),
                               (B * hkv, L, D)], seed=L + hkv)
    tq, tk, tv = map(torch.as_tensor, (q3, k3, v3))
    o, lse = _k1_emulate(tq, tk, tv, scale, causal, window, g)
    o_ref, lse_ref = tfa._fwd_ref(tq, tk, tv, scale, causal, window, g)

    def layout(x, h):  # (B*h, L, D) -> (B, L, h, D)
        return jnp.asarray(x.reshape(B, h, L, D).transpose(0, 2, 1, 3))

    jo = jfa.flash_attention(layout(q3, H), layout(k3, hkv),
                             layout(v3, hkv), causal=causal, scale=scale,
                             window=window, block_q=64, block_k=64,
                             interpret=True)
    jo = np.asarray(jo).transpose(0, 2, 1, 3).reshape(B * H, L, D)
    assert _share_used(o, o_ref) <= 1.0
    assert _share_used(lse, lse_ref) <= 1.0
    assert _share_used(o, jo) <= 1.0
    o_bf16, _ = _k1_emulate(tq, tk, tv, scale, causal, window, g,
                            split_p=False)
    assert _share_used(o_bf16, o_ref) > 1.0


def test_k1_emulation_takes_ragged_lengths():
    """A length that is no multiple of the 64-row tile, GQA and a
    window: the emulation still holds the plain version's limit."""
    q3, k3, v3 = (torch.as_tensor(a) for a in _bf16_arrays(
        [(4, 200, 64), (2, 200, 64), (2, 200, 64)], seed=3))
    for causal, window in ((True, None), (False, 40), (True, 128)):
        got = _k1_emulate(q3, k3, v3, 0.125, causal, window, 2)
        want = tfa._fwd_ref(q3, k3, v3, 0.125, causal, window, 2)
        for a, b in zip(got, want):
            assert _share_used(a, b) <= 1.0
