"""The arithmetic of the tensor-core K4, the fused backward, on the CPU.

The bf16 route of K4 (``flash_bwd_fused`` in
``ops/csrc/flash_attention.cu``, ``tc::flash_bwd_fused_wgmma_kernel``)
runs only on the card (tests/test_torch_gpu.py, chip_smoke.py). What it
computes is written out here in plain PyTorch, in the kernel's order:

* one 64-key tile of one kv row at a time, looping over the g q heads
  of its group and, for each, over the band's query tiles (the
  kernel's flattened loop and its query-tile range);
* S^T = K.Q^T and dP^T = V.dO^T formed once per tile pair, from exact
  bf16 products summed in f32; P^T and dS^T in f32;
* dv += P^T.dO, dk += dS^T.Q and dq += dS.K each on hi = bf16(x) and
  lo = bf16(x - hi) of P or dS;
* dk and dv summed over the group's q heads in the key tile's own
  accumulator (the GQA sum), dq summed in f32 across key tiles.

The emulation is held within the gradients' f32 limit, 5e-5 + 5e-5 |x|,
of the port's plain version (``_bwd_fused_ref``) and of the JAX
package's ``_bwd_fused`` in interpret mode (which group-sums its
partials), on the same bf16-valued numpy inputs. With P and dS rounded
to bf16 alone the same emulation must miss that limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.ops import flash_attention as jfa
from mpistragglers_jl_tpu_torch.ops import flash_attention as tfa

NEG = -1e30
GRAD = 5e-5  # the gradients' limit, atol and rtol (f32)
TILE = 64  # the kernel's query and key tile


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


def _query_tiles(kt, nq, causal, window):
    """The key tile's query-tile range, as the kernel computes it."""
    lo = kt if causal else 0
    hi = nq - 1
    if window:
        hi = min(hi, (kt * TILE + TILE - 2 + window) // TILE)
    return lo, hi


def _k4_emulate(q3, k3, v3, do3, lse, delta, scale, causal, window, g,
                split=True):
    """K4's tensor-core kernel, block by block: returns dq (B*H, Lq, D)
    and dk, dv (B*Hkv, Lk, D), all f32."""
    q, k, v, do = (t.float() for t in (q3, k3, v3, do3))
    BHkv, Lk, D = k.shape
    Lq = q.shape[1]
    # q row b = kv row b // g: axis 1 of a reshape is the group
    qg, dog = q.reshape(BHkv, g, Lq, D), do.reshape(BHkv, g, Lq, D)
    lseg, dlg = lse.reshape(BHkv, g, Lq), delta.reshape(BHkv, g, Lq)
    dq = torch.zeros(BHkv, g, Lq, D)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    nq = -(-Lq // TILE)
    for k0 in range(0, Lk, TILE):
        kt, vt = k[:, k0:k0 + TILE], v[:, k0:k0 + TILE]
        kp = torch.arange(k0, k0 + kt.shape[1])[:, None]
        qt_lo, qt_hi = _query_tiles(k0 // TILE, nq, causal, window)
        n_qt = qt_hi - qt_lo + 1
        dk_t = torch.zeros_like(kt)  # the block's registers
        dv_t = torch.zeros_like(vt)
        for it in range(g * n_qt if n_qt > 0 else 0):
            gi, qt = divmod(it, n_qt)
            q0 = (qt_lo + qt) * TILE
            qs = slice(q0, q0 + TILE)
            qp = torch.arange(q0, min(q0 + TILE, Lq))[None, :]
            vis = torch.ones(kp.shape[0], qp.shape[1], dtype=torch.bool)
            if causal:
                vis &= kp <= qp
            if window is not None:
                vis &= qp - kp < window
            # S^T and dP^T, once: (kv rows, keys, queries)
            st = torch.matmul(kt, qg[:, gi, qs].transpose(1, 2)) * scale
            pt = torch.exp(torch.where(vis, st, NEG)
                           - lseg[:, gi, None, qs])
            dpt = torch.matmul(vt, dog[:, gi, qs].transpose(1, 2))
            dst = pt * (dpt - dlg[:, gi, None, qs])
            dv_t += torch.matmul(_halves(pt, split), dog[:, gi, qs])
            dk_t += torch.matmul(_halves(dst, split), qg[:, gi, qs])
            dq[:, gi, qs] += torch.matmul(
                _halves(dst, split).transpose(1, 2), kt)
        dk[:, k0:k0 + TILE] = dk_t * scale
        dv[:, k0:k0 + TILE] = dv_t
    return dq.reshape(BHkv * g, Lq, D) * scale, dk, dv


def _share_used(got, want):
    want = torch.as_tensor(np.array(want)).float()
    return ((got - want).abs() / (GRAD + GRAD * want.abs())).max().item()


def _inputs(H, hkv, L, D, seed):
    """Seeded normal arrays holding bf16 values (what the kernel reads),
    as f32 numpy for both packages; B = 1."""
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16).float().numpy()
            for s in ((H, L, D), (hkv, L, D), (hkv, L, D), (H, L, D))]


CASES = [
    # (L, D, causal, window, hkv) over H = 4: g = 1, 2 and 4; causal and
    # not; windows; D 64 and 128
    (256, 64, True, None, 4),
    (256, 128, True, None, 1),
    (256, 128, False, 100, 2),
    (256, 64, True, 70, 1),
]


@pytest.mark.parametrize("L,D,causal,window,hkv", CASES)
def test_k4_tensor_core_arithmetic_holds_the_gradient_limit(
        L, D, causal, window, hkv):
    """The emulation against the plain version and the JAX package's
    fused backward (interpret mode), on the same numpy inputs; with P
    and dS in bf16 alone it misses the same limit."""
    H = 4
    g, scale = H // hkv, D ** -0.5
    arrays = _inputs(H, hkv, L, D, seed=L + D + 7 * hkv)
    tq, tk, tv, tdo = map(torch.as_tensor, arrays)
    jo, jlse = jfa._fwd(*map(jnp.asarray, arrays[:3]), scale, causal, window,
                        TILE, TILE, g, True)
    jgrads = jfa._bwd_fused(*map(jnp.asarray, arrays[:3]), jo, jlse,
                            jnp.asarray(arrays[3]), scale, causal, window,
                            TILE, TILE, g, True)
    lse = torch.as_tensor(np.array(jlse))
    delta = tfa._delta(tdo, torch.as_tensor(np.array(jo)))
    args = (tq, tk, tv, tdo, lse, delta, scale, causal, window, g)
    got = _k4_emulate(*args)
    for a, plain, jax_grad in zip(got, tfa._bwd_fused_ref(*args), jgrads):
        assert a.shape == plain.shape
        assert _share_used(a, plain) <= 1.0
        assert _share_used(a, jax_grad) <= 1.0
    # the control: P and dS in bf16 alone
    bf16_only = _k4_emulate(*args, split=False)
    assert max(_share_used(a, w) for a, w in
               zip(bf16_only, tfa._bwd_fused_ref(*args))) > 1.0


@pytest.mark.parametrize("L,hkv,causal,window", [
    (200, 4, True, None), (200, 1, False, 40), (257, 1, True, 128),
    (257, 2, False, None)])
def test_k4_emulation_takes_ragged_lengths(L, hkv, causal, window):
    """Lengths that are no multiple of the 64-row tile (short last query
    and key tiles), GQA, windows: the emulation holds the plain
    version's limit. The JAX backward takes only whole blocks, so it
    sits these cases out."""
    H, D = 4, 64
    g, scale = H // hkv, D ** -0.5
    tq, tk, tv, tdo = map(torch.as_tensor, _inputs(H, hkv, L, D, seed=L))
    o, lse = tfa._fwd_ref(tq, tk, tv, scale, causal, window, g)
    args = (tq, tk, tv, tdo, lse, tfa._delta(tdo, o), scale, causal,
            window, g)
    for a, want in zip(_k4_emulate(*args), tfa._bwd_fused_ref(*args)):
        assert _share_used(a, want) <= 1.0


def test_k4_loop_visits_each_band_pair_once_per_head():
    """The kernel's flattened loop (iteration it: q head it // n_qt of
    the group, query tile qt_lo + it % n_qt) visits, for every key tile,
    each q head's band tiles exactly once: the tiles ``tile_runs`` of
    the FMA kernels keeps."""
    def tile_runs(q0, k0, causal, window):
        if causal and k0 > q0 + TILE - 1:
            return False
        return window is None or q0 - (k0 + TILE - 1) < window

    for L in (64, 200, 1000):
        n = -(-L // TILE)
        for causal in (False, True):
            for window in (None, 1, 40, 65, 700):
                for g in (1, 4):
                    for kt in range(n):
                        lo, hi = _query_tiles(kt, n, causal, window)
                        n_qt = hi - lo + 1
                        seen = [divmod(it, n_qt) for it in
                                range(g * n_qt if n_qt > 0 else 0)]
                        seen = sorted((gi, lo + t) for gi, t in seen)
                        want = sorted(
                            (gi, qt) for gi in range(g) for qt in range(n)
                            if tile_runs(qt * TILE, kt * TILE, causal,
                                         window))
                        assert seen == want, (L, causal, window, g, kt)
