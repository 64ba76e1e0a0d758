"""The arithmetic of the tensor-core K2 and K3, on the CPU.

The bf16 routes of K2 (``flash_bwd_dq``) and K3 (``flash_bwd_dkv``) in
``ops/csrc/flash_attention.cu`` run on Hopper's tensor cores, which take
bf16 operands. They run only on the card (tests/test_torch_gpu.py,
chip_smoke.py); what they compute is written out here in plain PyTorch,
tile by tile as the kernels go:

* S = Q.K^T and dP = dO.V^T from exact bf16 products summed in f32;
* P = exp(scale S - lse) (0 where masked) and dS = P (dP - delta) in f32;
* every product that takes P or dS (dS.K in K2, P^T.dO and dS^T.Q in
  K3) runs twice, on hi = bf16(x) and on lo = bf16(x - hi).

Each emulation is held within the gradients' f32 limit, 5e-5 + 5e-5 |x|,
of the port's plain versions (``_bwd_dq_ref``, ``_bwd_dkv_ref``) and of
the JAX package's backward in interpret mode (``_bwd``, after the GQA
group sum), on the same bf16-valued numpy inputs. With P and dS rounded
to bf16 alone the same emulation must miss that limit: the control shows
that the limit tells the two apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.ops import flash_attention as jfa
from mpistragglers_jl_tpu_torch.ops import flash_attention as tfa

NEG = -1e30
GRAD = 5e-5  # the gradients' limit, atol and rtol (f32)
TILE = 64  # the kernels' query and key tile


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _halves(x, split):
    """x as the tensor cores take it: hi + lo, or bf16 alone."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float() if split else hi


def _probs_ds(q, k, v, do, lse, delta, q0, k0, scale, causal, window):
    """P and dS of the (query tile at q0, key tile at k0) pair, f32, as
    both kernels form them; rows and keys past the lengths are cut."""
    qt, kt = q[:, q0:q0 + TILE], k[:, k0:k0 + TILE]
    qp = torch.arange(q0, q0 + qt.shape[1])[:, None]
    kp = torch.arange(k0, k0 + kt.shape[1])[None, :]
    vis = torch.ones(qp.shape[0], kp.shape[1], dtype=torch.bool)
    if causal:
        vis &= kp <= qp
    if window is not None:
        vis &= qp - kp < window
    s = torch.where(vis, torch.matmul(qt, kt.transpose(1, 2)) * scale, NEG)
    p = torch.exp(s - lse[:, q0:q0 + TILE])
    dp = torch.matmul(do[:, q0:q0 + TILE], v[:, k0:k0 + TILE].transpose(1, 2))
    return p, p * (dp - delta[:, q0:q0 + TILE])


def _tile_runs(q0, k0, causal, window):
    """The band's tiles (the kernels' loop ranges)."""
    if causal and k0 > q0 + TILE - 1:
        return False
    return window is None or q0 - (k0 + TILE - 1) < window


def _widen(q3, k3, v3, do3, g):
    return (q3.float(), k3.float().repeat_interleave(g, 0),
            v3.float().repeat_interleave(g, 0), do3.float())


def _k2_emulate(q3, k3, v3, do3, lse, delta, scale, causal, window, g,
                split=True):
    """K2's tensor-core kernel: dq per 64-query tile, summed over the
    band's 64-key tiles, dS.K as hi.K + lo.K (``split``) or bf16(dS).K."""
    q, k, v, do = _widen(q3, k3, v3, do3, g)
    Lq, Lk = q.shape[1], k.shape[1]
    dq = torch.zeros_like(q)
    for q0 in range(0, Lq, TILE):
        for k0 in range(0, Lk, TILE):
            if not _tile_runs(q0, k0, causal, window):
                continue
            _, ds = _probs_ds(q, k, v, do, lse, delta, q0, k0, scale, causal,
                              window)
            dq[:, q0:q0 + TILE] += torch.matmul(_halves(ds, split),
                                                k[:, k0:k0 + TILE])
    return dq * scale


def _k3_emulate(q3, k3, v3, do3, lse, delta, scale, causal, window, g,
                split=True):
    """K3's tensor-core kernel: dk, dv per q head and 64-key tile, summed
    over the band's 64-query tiles, P^T.dO and dS^T.Q on hi + lo
    (``split``) or on P and dS in bf16 alone."""
    q, k, v, do = _widen(q3, k3, v3, do3, g)
    Lq, Lk = q.shape[1], k.shape[1]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, Lk, TILE):
        for q0 in range(0, Lq, TILE):
            if not _tile_runs(q0, k0, causal, window):
                continue
            p, ds = _probs_ds(q, k, v, do, lse, delta, q0, k0, scale, causal,
                              window)
            dv[:, k0:k0 + TILE] += torch.matmul(
                _halves(p, split).transpose(1, 2), do[:, q0:q0 + TILE])
            dk[:, k0:k0 + TILE] += torch.matmul(
                _halves(ds, split).transpose(1, 2), q[:, q0:q0 + TILE])
    return dk * scale, dv


def _share_used(got, want):
    want = torch.as_tensor(np.array(want))
    return ((got - want).abs() / (GRAD + GRAD * want.abs())).max().item()


def _bf16_arrays(shapes, seed):
    """Seeded normal arrays holding bf16 values (what the kernels read),
    as f32 numpy for both packages."""
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16).float().numpy() for s in shapes]


def _inputs(B, H, hkv, L, D, seed):
    return _bf16_arrays([(B * H, L, D), (B * hkv, L, D), (B * hkv, L, D),
                         (B * H, L, D)], seed)


def _plain(q3, k3, v3, do3, scale, causal, window, g):
    """The port's plain forward and backward: (lse, delta, dq, dk and dv
    per q head)."""
    o, lse = tfa._fwd_ref(q3, k3, v3, scale, causal, window, g)
    delta = tfa._delta(do3, o)
    args = (q3, k3, v3, do3, lse, delta, scale, causal, window, g)
    return lse, delta, tfa._bwd_dq_ref(*args), tfa._bwd_dkv_ref(*args)


CASES = [
    # (L, D, causal, window, hkv): GQA, a window, causal and not, D 64, 128
    (256, 64, True, None, 2),
    (256, 128, False, 100, 1),
    (256, 128, True, 70, 4),
    (256, 64, False, None, 4),
]


@pytest.mark.parametrize("L,D,causal,window,hkv", CASES)
def test_k2_k3_tensor_core_arithmetic_holds_the_gradient_limit(
        L, D, causal, window, hkv):
    """The emulations against the plain versions and the JAX package's
    split backward (interpret mode), on the same numpy inputs; with P
    and dS in bf16 alone they miss the same limit."""
    B, H = 1, 4
    g, scale = H // hkv, D ** -0.5
    arrays = _inputs(B, H, hkv, L, D, seed=L + D + hkv)
    tq, tk, tv, tdo = map(torch.as_tensor, arrays)
    # one forward for all three: the JAX kernel's o and lse
    jo, jlse = jfa._fwd(*map(jnp.asarray, arrays[:3]), scale, causal, window,
                        TILE, TILE, g, True)
    jdq, jdk, jdv = jfa._bwd(*map(jnp.asarray, arrays[:3]), jo, jlse,
                             jnp.asarray(arrays[3]), scale, causal, window,
                             TILE, TILE, g, True)
    lse = torch.as_tensor(np.array(jlse))
    delta = tfa._delta(tdo, torch.as_tensor(np.array(jo)))
    args = (tq, tk, tv, tdo, lse, delta, scale, causal, window, g)
    dq = _k2_emulate(*args)
    dkq, dvq = _k3_emulate(*args)
    assert _share_used(dq, tfa._bwd_dq_ref(*args)) <= 1.0
    for got, want in zip((dkq, dvq), tfa._bwd_dkv_ref(*args)):
        assert _share_used(got, want) <= 1.0
    assert _share_used(dq, jdq) <= 1.0
    assert _share_used(tfa._group_sum(dkq, g, torch.float32), jdk) <= 1.0
    assert _share_used(tfa._group_sum(dvq, g, torch.float32), jdv) <= 1.0
    # the control: P and dS in bf16 alone
    want_dk, want_dv = tfa._bwd_dkv_ref(*args)
    assert _share_used(_k2_emulate(*args, split=False),
                       tfa._bwd_dq_ref(*args)) > 1.0
    dk16, dv16 = _k3_emulate(*args, split=False)
    assert _share_used(dk16, want_dk) > 1.0
    assert _share_used(dv16, want_dv) > 1.0


@pytest.mark.parametrize("L,hkv,causal,window", [
    (200, 2, True, None), (200, 1, False, 40), (257, 4, True, 128),
    (257, 2, False, None)])
def test_k2_k3_emulation_takes_ragged_lengths(L, hkv, causal, window):
    """Lengths that are no multiple of the 64-row tile (the last query
    and key tiles are short), GQA, windows: the emulations hold the
    plain versions' limit. The JAX backward takes only whole blocks, so
    it sits these cases out."""
    B, H, D = 1, 4, 64
    g, scale = H // hkv, D ** -0.5
    tq, tk, tv, tdo = map(torch.as_tensor,
                          _inputs(B, H, hkv, L, D, seed=L + hkv))
    lse, delta, dq_ref, (dk_ref, dv_ref) = _plain(tq, tk, tv, tdo, scale,
                                                  causal, window, g)
    args = (tq, tk, tv, tdo, lse, delta, scale, causal, window, g)
    assert _share_used(_k2_emulate(*args), dq_ref) <= 1.0
    dkq, dvq = _k3_emulate(*args)
    assert _share_used(dkq, dk_ref) <= 1.0
    assert _share_used(dvq, dv_ref) <= 1.0


def test_band_ranges_equal_the_skipped_tiles():
    """K2's key-tile range and K3's query-tile range, computed from the
    band as the kernels compute them, hold exactly the tiles that
    ``_tile_runs`` keeps (the FMA kernels' test), for every tile."""
    def kernel_key_range(q0, nk, causal, window):  # K2
        hi = min(nk - 1, (q0 + TILE - 1) // TILE) if causal else nk - 1
        lo = max(0, int((q0 - window + 1) / TILE)) if window else 0
        return set(range(lo, hi + 1))

    def kernel_query_range(kt, nq, causal, window):  # K3
        lo = kt if causal else 0
        hi = nq - 1
        if window:
            hi = min(hi, (kt * TILE + TILE - 2 + window) // TILE)
        return set(range(lo, hi + 1))

    for L in (64, 200, 1000):
        n = -(-L // TILE)
        for causal in (False, True):
            for window in (None, 1, 40, 64, 65, 128, 700):
                for t in range(n):
                    keys = {kt for kt in range(n)
                            if _tile_runs(t * TILE, kt * TILE, causal, window)}
                    assert kernel_key_range(t * TILE, n, causal,
                                            window) == keys
                    queries = {qt for qt in range(n) if _tile_runs(
                        qt * TILE, t * TILE, causal, window)}
                    assert kernel_query_range(t, n, causal,
                                              window) == queries
