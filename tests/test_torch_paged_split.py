"""K6's split over the paged ring, on the CPU.

K6 (``k6_paged_decode_attention_int8`` in
``ops/csrc/decode_attention.cu``) runs K5's split kernel and combine
over the ring's W = max_pages * P slots, cut by ``paged_split_plan``.
The kernel itself runs only on the card (tests/test_torch_gpu.py,
chip_smoke.py). Here:

* the plan reads shapes only, cuts whole 32-key tiles and, where K5's
  chunk rounded up to a unit of lcm(P, 32) slots at most doubles, whole
  pages, and follows the card's SM count;
* an emulation of the kernel's arithmetic (per split: the slots of its
  chunk that the ring shows, each read through the page table, a page
  id outside the pool masked; then the combine's fold of the partial
  (m, l, acc)) equals ``paged_decode_attention_ref`` and the JAX
  package's paged kernel in interpret mode within 1e-5 (f32), with
  shared pages, null and out-of-pool page ids, rows in ring warm-up and
  pages of 8, 16, 24 and 64 rows.
"""

import functools
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.models.decode import _kv_quantize as jax_kv_quantize
from mpistragglers_jl_tpu.ops.decode_attention import (
    quantized_decode_attention as jax_qda,
)
from mpistragglers_jl_tpu_torch.ops import decode_attention as da

NEG = -1e30
ATOL = 1e-5
H100_SMS = 132  # the SM count of an H100 SXM, the plan's main card


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- the plan


def test_paged_split_plan_reads_shapes_only():
    """A function of (B, Hkv, W, P) and the SM count alone: no tensor,
    no positions, so a decode step never syncs. At the paged main path's
    shape it gives K5's grid: 8 splits of two pages, 128 blocks."""
    params = list(inspect.signature(da.paged_split_plan).parameters)
    assert params == ["B", "Hkv", "W", "P", "n_sm"]
    plan = functools.partial(da.paged_split_plan, n_sm=H100_SMS)
    assert plan(8, 2, 1024, 64) == (128, 8)
    assert plan(8, 2, 1024, 64) == da.split_plan(8, 2, 1024, n_sm=H100_SMS)
    assert plan(8, 2, 1024, 16) == (128, 8)
    assert plan(8, 2, 960, 24) == (192, 5)  # whole pages: 8 of 24 rows


@pytest.mark.parametrize("P", [1, 8, 16, 24, 48, 64, 96, 256, 1024])
@pytest.mark.parametrize("B,Hkv,max_pages", [
    (8, 2, 16), (8, 8, 4), (1, 2, 64), (4, 1, 7), (200, 8, 3)])
def test_paged_split_plan_cuts_whole_tiles_and_pages(B, Hkv, max_pages, P):
    W = max_pages * P
    chunk, n_split = da.paged_split_plan(B, Hkv, W, P, n_sm=H100_SMS)
    k5_chunk, k5_splits = da.split_plan(B, Hkv, W, n_sm=H100_SMS)
    unit = math.lcm(P, 32)
    assert chunk % 32 == 0 and chunk >= 32  # whole tiles, always
    assert n_split == -(-W // chunk)  # every split holds a slot
    if -(-k5_chunk // unit) * unit <= 2 * k5_chunk:
        # whole pages too, at most twice K5's chunk: never more splits
        assert chunk % unit == 0 and chunk % P == 0
        assert k5_chunk <= chunk <= 2 * k5_chunk
        assert n_split <= k5_splits
    else:  # pages longer than twice the chunk: K5's chunk
        assert chunk == k5_chunk


@pytest.mark.parametrize("n_sm", [78, 114, 132, 144])
def test_paged_split_plan_follows_the_sm_count(n_sm):
    """The serving shape's grid tracks the card: more SMs, at least as
    many blocks, never more than about two blocks an SM."""
    chunk, n_split = da.paged_split_plan(8, 2, 1024, 64, n_sm=n_sm)
    assert chunk % 64 == 0
    assert 16 * n_split <= 2 * n_sm
    more = da.paged_split_plan(8, 2, 1024, 64, n_sm=2 * n_sm)[1]
    assert more >= n_split


# ------------------------------------------------------ the emulation


def _paged_inputs(B, W, P, Hq, Hkv, D, seed):
    """A pool of B * W/P + 3 pages (page 0 the null page), a page table
    from a seeded permutation with two pages shared by rows 1 and 2,
    null entries past row 0's budget (it is in warm-up), and positions
    in warm-up, at W - 1, at W and wrapped."""
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
    pt[0, (P // 2) // P + 1:] = 0
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    pos = np.asarray([P // 2, W - 1, W, 3 * W + 17], np.int32)[:B]
    return q, pool, pt, pos


def _k6_split_combine(q, pool, pos, scale, pt, P):
    """K6's arithmetic: each split's partial (m, l, acc) over the ring
    slots of its chunk that the row shows, every slot read through the
    page table (an id outside the pool masks its slots), then the
    combine's fold. Plain torch f32."""
    B, _, H, D = q.shape
    n_pages, Hkv = pool["k"].shape[0] // P, pool["k"].shape[1]
    g, W = H // Hkv, pt.shape[1] * P
    chunk, n_split = da.paged_split_plan(B, Hkv, W, P, n_sm=H100_SMS)
    t = torch.arange(W)
    page = pt[:, t // P].long()  # (B, W)
    ok = (page >= 0) & (page < n_pages)
    row = torch.where(ok, page, 0) * P + t % P  # pool row of each slot
    hi = torch.where(pos >= W, W - 1, pos).long()  # ring: slots [0, hi]
    c0 = torch.arange(n_split)[:, None] * chunk
    in_split = (t >= c0) & (t < c0 + chunk)  # (S, W)
    vis = in_split[None] & (ok & (t <= hi[:, None]))[:, None]  # (B, S, W)
    kf, vf = pool["k"].float()[row], pool["v"].float()[row]  # (B,W,Hkv,D)
    ks, vs = pool["k_s"][row], pool["v_s"][row]  # (B, W, Hkv)
    q5 = q.float().reshape(B, Hkv, g, D)
    s = torch.einsum("bhgd,blhd->bhgl", q5, kf) * scale
    s = (s * ks.permute(0, 2, 1)[:, :, None])[:, :, :, None]  # B,Hkv,g,1,W
    vm = vis[:, None, None]
    s = torch.where(vm, s, NEG)
    m = s.amax(-1)  # (B, Hkv, g, S); an empty split keeps -1e30
    p = torch.where(vm, torch.exp(s - m[..., None]), 0.0)
    part_l = p.sum(-1)
    pv = p * vs.permute(0, 2, 1)[:, :, None, None]
    part_acc = torch.einsum("bhgsl,blhd->bhgsd", pv, vf)
    M = m.amax(-1, keepdim=True)
    w = torch.exp(m - M)
    acc = (part_acc * w[..., None]).sum(-2)
    o = acc / (part_l * w).sum(-1).clamp_min(1e-20)[..., None]
    return o.reshape(B, 1, H, D), n_split


@pytest.mark.parametrize("P,W", [(8, 256), (16, 512), (24, 480), (64, 512)])
@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (8, 1)])
def test_k6_split_and_combine_equal_plain_and_jax(P, W, Hq, Hkv):
    B, D = 4, 128
    q, pool, pt, pos = _paged_inputs(B, W, P, Hq, Hkv, D, seed=P + Hkv)
    scale = D ** -0.5
    tq, tpos, tpt = map(torch.as_tensor, (q, pos, pt))
    tpool = {k: torch.as_tensor(v) for k, v in pool.items()}
    got, n_split = _k6_split_combine(tq, tpool, tpos, scale, tpt, P)
    assert n_split > 1
    want = da.paged_decode_attention_ref(tq, tpool, tpos, scale, tpt, P)
    torch.testing.assert_close(got, want, rtol=0.0, atol=ATOL)
    jwant = jax_qda(jnp.asarray(q), {k: jnp.asarray(v) for k, v in
                                     pool.items()},
                    jnp.asarray(pos), scale, ring=True,
                    page_table=jnp.asarray(pt), page_tokens=P,
                    interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("P", [16, 24])
def test_k6_masks_page_ids_outside_the_pool(P):
    """A row in warm-up whose table holds ids outside the pool (-1, and
    one past the last page) past its budget: the kernel counts their
    slots as masked, so the emulation equals the plain version on the
    table with those entries at the null page."""
    B, W, D = 4, 8 * P, 64
    q, pool, pt, pos = _paged_inputs(B, W, P, 8, 2, D, seed=3 * P)
    n_pages = pool["k"].shape[0] // P
    bad = pt.copy()
    bad[0, 2] = -1
    bad[0, 3:] = n_pages
    tq, tpos = torch.as_tensor(q), torch.as_tensor(pos)
    tpool = {k: torch.as_tensor(v) for k, v in pool.items()}
    got, _ = _k6_split_combine(tq, tpool, tpos, D ** -0.5,
                               torch.as_tensor(bad), P)
    want = da.paged_decode_attention_ref(tq, tpool, tpos, D ** -0.5,
                                         torch.as_tensor(pt), P)
    torch.testing.assert_close(got, want, rtol=0.0, atol=ATOL)
