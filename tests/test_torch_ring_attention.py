"""The port's sequence parallelism (mpistragglers_jl_tpu_torch/parallel/
ring_attention.py: ring and Ulysses attention) and the collectives under
it (parallel/collectives.py ``psum``, ``ring_shift``, ``all_to_all``;
parallel/mesh.py ``Mesh.axis_index``, ``Mesh.axis_groups``) on CPU
ranks, against the JAX package's shard_map programs on its 8 host
devices and its dense ``reference_attention``, on the same numpy
inputs: the contract of the JAX package's tests/test_ring_attention.py
and the single-axis cases of tests/test_gqa.py.

On the CPU the port's flash attention runs its plain versions; the JAX
package runs its Pallas kernels in interpret mode, as its own tests do.
Tolerances (f32): outputs within 1e-5 absolute and relative (both sum
in f32 in different orders, the ring block by block), gradients within
1e-4 (the reference's own bound for the ring's gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from mpistragglers_jl_tpu.parallel import make_mesh as jmake_mesh
from mpistragglers_jl_tpu.parallel import ring_attention as jra
from mpistragglers_jl_tpu_torch.parallel import (
    PartitionSpec as P,
    all_to_all,
    make_mesh,
    psum,
    ring_shift,
    shard,
)
from mpistragglers_jl_tpu_torch.parallel import ring_attention as tra

B, L, H, D = 2, 32, 4, 8
OUT, GRAD = 1e-5, 1e-4
SEQ = P(None, "sp", None, None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(Hq=H, Hkv=H, Lq=L, seed=0, Bq=B):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((Bq, Lq, h, D)).astype(np.float32)
            for h in (Hq, Hkv, Hkv)]


def _tmesh(n, names="sp"):
    shape = (n,) if isinstance(n, int) else tuple(n)
    return make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def _jax_attention(kind, n, arrays, **kw):
    mesh = jmake_mesh(n, "sp")
    make = (jra.make_ring_attention if kind == "ring"
            else jra.make_ulysses_attention)
    sh = NamedSharding(mesh, JP(None, "sp", None, None))
    return np.asarray(make(mesh, **kw)(
        *(jax.device_put(jnp.asarray(a), sh) for a in arrays)))


def _port_attention(kind, n, arrays, **kw):
    mesh = _tmesh(n)
    make = (tra.make_ring_attention if kind == "ring"
            else tra.make_ulysses_attention)
    out = make(mesh, **kw)(*(torch.as_tensor(a) for a in arrays))
    assert out.spec == SEQ and out.shape == arrays[0].shape
    return np.asarray(out)


def _dense(arrays, **kw):
    return np.asarray(jra.reference_attention(
        *(jnp.asarray(a) for a in arrays), **kw))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n_sp", [2, 4, 8])
def test_ring_matches_jax_and_dense(causal, n_sp):
    arrays = _qkv()
    got = _port_attention("ring", n_sp, arrays, causal=causal)
    _close(got, _jax_attention("ring", n_sp, arrays, causal=causal), OUT,
           "against the JAX ring")
    _close(got, _dense(arrays, causal=causal), OUT, "against dense")


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax_and_dense(causal, impl):
    arrays = _qkv(seed=1)
    got = _port_attention("ulysses", 4, arrays, causal=causal, impl=impl)
    _close(got, _jax_attention("ulysses", 4, arrays, causal=causal,
                               impl=impl), OUT, "against the JAX Ulysses")
    _close(got, _dense(arrays, causal=causal), OUT, "against dense")


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_sliding_window_matches_jax(kind):
    arrays = _qkv(seed=6)
    got = _port_attention(kind, 4, arrays, causal=True, window=5)
    _close(got, _jax_attention(kind, 4, arrays, causal=True, window=5),
           OUT, "against the JAX program")
    _close(got, _dense(arrays, causal=True, window=5), OUT, "dense")


def test_ring_output_stays_sequence_sharded():
    mesh = _tmesh(4)
    q, k, v = (torch.as_tensor(a) for a in _qkv(seed=2))
    out = tra.make_ring_attention(mesh)(q, k, v)
    assert out.spec == SEQ
    want = tra.reference_attention(q, k, v)
    ptrs = set()
    for r in range(4):
        loc = out.local(r)
        assert loc.shape == (B, L // 4, H, D)
        torch.testing.assert_close(loc, want[:, r * 8:(r + 1) * 8],
                                   atol=OUT, rtol=OUT)
        ptrs.add(loc.data_ptr())
    assert len(ptrs) == 4


def _port_grads(kind, n, arrays, **kw):
    """d/dq, dk, dv of sum(o**2) through the port's per-rank program:
    the sum of every rank's local sum (the shards are distinct data, so
    the global sum adds them once)."""
    mesh = _tmesh(n)
    shs = [shard(torch.as_tensor(a), mesh, SEQ) for a in arrays]
    locs = [[s.local(r).requires_grad_(True) for r in range(n)]
            for s in shs]
    fn = tra.ring_self_attention if kind == "ring" else tra.ulysses_attention
    out = fn(*locs, mesh, causal=True, **kw)
    loss = sum((o.float() ** 2).sum() for o in out)
    loss.backward()
    return [torch.cat([t.grad for t in per], dim=1).numpy() for per in locs]


@pytest.mark.parametrize("kind,kw,hkv", [
    ("ring", {}, H), ("ring", {}, 2), ("ulysses", {}, H),
    ("ulysses", {"impl": "flash"}, 1)])
def test_gradients_match_dense(kind, kw, hkv):
    """The ring's hops and Ulysses' all-to-alls backpropagate: gradients
    against jax.grad of the JAX dense attention (the reference's slow
    ring-gradient test, here at a size that runs in a second)."""
    arrays = _qkv(Hkv=hkv, seed=3)

    def dense_loss(q, k, v):
        return (jra.reference_attention(q, k, v, causal=True) ** 2).sum()

    want = jax.grad(dense_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    got = _port_grads(kind, 4, arrays, **kw)
    for g, w, name in zip(got, want, "qkv"):
        _close(g, np.asarray(w), GRAD, f"d{name}")


def test_ulysses_rejects_indivisible_heads():
    arrays = _qkv(seed=4)
    with pytest.raises(ValueError, match="divisible") as want:
        _jax_attention("ulysses", 8, arrays)
    with pytest.raises(ValueError, match="divisible") as got:
        _port_attention("ulysses", 8, arrays)
    assert str(got.value) == str(want.value)


def test_long_sequence_low_memory_path():
    # 8-way ring over a longer sequence; each rank's score block is
    # (L/8)^2 = 64x64 instead of 512x512
    arrays = _qkv(Hq=2, Hkv=2, Lq=512, seed=5, Bq=1)
    got = _port_attention("ring", 8, arrays, causal=True)
    _close(got, _dense(arrays, causal=True), OUT, "against dense")


@pytest.mark.parametrize("hkv", [1, 2])
def test_ring_gqa_matches_reference(hkv):
    arrays = _qkv(Hq=4, Hkv=hkv, seed=7)
    got = _port_attention("ring", 4, arrays, causal=True)
    _close(got, _jax_attention("ring", 4, arrays, causal=True), OUT)
    _close(got, _dense(arrays, causal=True), OUT)


@pytest.mark.parametrize("hkv,sp", [
    (4, 2),  # kv heads divide sp-wise like q heads
    (2, 2),  # Hkv == sp: one kv head per rank, no replication
    (1, 2),  # MQA: sp % Hkv == 0 -> kv replication branch
    (2, 4),  # GQA replication branch: r = 2
])
def test_ulysses_gqa_matches_reference(hkv, sp):
    arrays = _qkv(Hq=8, Hkv=hkv, seed=8)
    got = _port_attention("ulysses", sp, arrays, causal=True)
    _close(got, _jax_attention("ulysses", sp, arrays, causal=True), OUT)
    _close(got, _dense(arrays, causal=True), OUT)


def test_ulysses_gqa_indivisible_rejected():
    arrays = _qkv(Hq=8, Hkv=3, seed=9)
    with pytest.raises(ValueError, match="divide one another") as want:
        _jax_attention("ulysses", 4, arrays, causal=True)
    with pytest.raises(ValueError, match="divide one another") as got:
        _port_attention("ulysses", 4, arrays, causal=True)
    assert str(got.value) == str(want.value)


def test_wrapped_attention_refuses_another_layout():
    mesh = _tmesh(4)
    q = shard(torch.zeros(B, L, H, D), mesh, P(None, None, "sp"))
    with pytest.raises(ValueError, match="laid out"):
        tra.make_ring_attention(mesh)(q, q, q)


# -- the mesh and the collectives over named axes ----------------------------

MESH3 = ((2, 2, 2), ("dp", "sp", "tp"))


def _jax_read(fn, x, spec, out_spec):
    """Run ``fn`` as a shard_map over the JAX (2, 2, 2) mesh."""
    mesh = jmake_mesh(*MESH3)
    f = jax.shard_map(fn, mesh=mesh, in_specs=(spec,), out_specs=out_spec)
    return np.asarray(jax.jit(f)(jnp.asarray(x)))


def test_axis_index_matches_jax():
    mesh = _tmesh(*MESH3)
    x = np.zeros((8, 1), np.int32)
    spec = JP(("dp", "sp", "tp"))
    for axis in MESH3[1]:
        want = _jax_read(lambda a, ax=axis: a + jax.lax.axis_index(ax), x,
                         spec, spec)[:, 0]
        assert mesh.axis_index(axis) == want.tolist(), axis


def test_axis_groups():
    mesh = _tmesh(*MESH3)
    assert mesh.axis_groups("tp") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh.axis_groups("dp") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert mesh.axis_groups(("dp", "sp")) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert mesh.axis_groups(("sp", "dp")) == mesh.axis_groups(("dp", "sp"))
    assert mesh.axis_groups(MESH3[1]) == [list(range(8))]
    with pytest.raises(ValueError, match="not in mesh axes"):
        mesh.axis_groups("ep")


@pytest.mark.parametrize("axes", ["tp", ("dp", "sp"), ("dp", "sp", "tp")])
def test_psum_matches_jax_and_is_fresh(axes):
    mesh = _tmesh(*MESH3)
    x = np.random.default_rng(10).standard_normal((8, 3)).astype(np.float32)
    spec = JP(("dp", "sp", "tp"))
    want = _jax_read(lambda a: jax.lax.psum(a, axes), x, spec, spec)
    xs = [torch.as_tensor(x[r:r + 1]).clone() for r in range(8)]
    got = psum(xs, mesh, axes)
    for r in range(8):
        np.testing.assert_allclose(got[r].numpy(), want[r:r + 1], rtol=1e-6)
    for group in mesh.axis_groups(axes):
        assert all(torch.equal(got[r], got[group[0]]) for r in group)
    ptrs = {t.data_ptr() for t in got} | {t.data_ptr() for t in xs}
    assert len(ptrs) == 16
    wide = psum(xs, mesh, axes, dtype=torch.float64)
    assert wide[0].dtype == torch.float64


def test_psum_over_one_member_groups_returns_its_inputs():
    mesh = _tmesh((1, 2, 4), MESH3[1])
    xs = [torch.full((2,), float(r)) for r in range(8)]
    got = psum(xs, mesh, "dp")
    assert all(g is x for g, x in zip(got, xs))
    wide = psum(xs, mesh, ("dp",), dtype=torch.float64)
    assert all(w.dtype == torch.float64 and torch.equal(w, x.double())
               for w, x in zip(wide, xs))


def test_ring_shift_matches_jax_ppermute():
    mesh = _tmesh(*MESH3)
    x = np.arange(8, dtype=np.float32)[:, None]
    spec = JP(("dp", "sp", "tp"))
    perm = [(0, 1), (1, 0)]
    want = _jax_read(lambda a: jax.lax.ppermute(a, "sp", perm), x, spec,
                     spec)
    xs = [torch.as_tensor(x[r:r + 1]) for r in range(8)]
    got = ring_shift(xs, mesh, "sp")
    assert [t.item() for t in got] == want[:, 0].tolist()
    assert all(g.data_ptr() != t.data_ptr() for g, t in zip(got, xs))
    back = got  # n - 1 more hops bring every tensor home
    for _ in range(mesh.shape["sp"] - 1):
        back = ring_shift(back, mesh, "sp")
    assert all(torch.equal(a, b) for a, b in zip(back, xs))


def test_all_to_all_matches_jax():
    mesh = _tmesh(*MESH3)
    x = np.random.default_rng(11).standard_normal((2, 8, 4)).astype(
        np.float32)
    spec = JP(None, "sp", "tp")

    def a2a(a):
        return jax.lax.all_to_all(a, "sp", split_axis=2, concat_axis=1,
                                  tiled=True)

    # member s of an sp pair at tp index t ends with head t*2 + s over
    # the whole sequence; laid out (tp, sp) the heads come back in order
    want = _jax_read(a2a, x, spec, JP(None, None, ("tp", "sp")))
    np.testing.assert_array_equal(want, x)
    sh = shard(torch.as_tensor(x), mesh, P(None, "sp", "tp"))
    got = all_to_all([sh.local(r) for r in range(8)], mesh, "sp", 2, 1)
    for r, (_, s, t) in enumerate(np.ndindex(2, 2, 2)):
        np.testing.assert_array_equal(got[r].numpy(),
                                      want[:, :, t * 2 + s:t * 2 + s + 1])
    inv = all_to_all(got, mesh, "sp", 1, 2)
    for r in range(8):
        assert torch.equal(inv[r], sh.local(r))


def test_collectives_are_differentiable():
    """One backward through psum, ring_shift and all_to_all gives each
    input the transposed collective of the cotangents."""
    mesh = _tmesh(*MESH3)
    rng = np.random.default_rng(12)
    xs = [torch.as_tensor(rng.standard_normal((1, 4, 2)).astype(
        np.float32)).requires_grad_(True) for _ in range(8)]
    w = [torch.as_tensor(rng.standard_normal((1, 4, 2)).astype(np.float32))
         for _ in range(8)]
    ys = all_to_all(ring_shift(psum(xs, mesh, "tp"), mesh, "sp"), mesh,
                    "dp", 1, 2)
    loss = sum((y * torch.as_tensor(np.asarray(wr).reshape(y.shape))).sum()
               for y, wr in zip(ys, w))
    loss.backward()
    # transpose by hand: inverse all-to-all, the shift back, psum
    wt = all_to_all([torch.as_tensor(np.asarray(wr).reshape(y.shape))
                     for y, wr in zip(ys, w)], mesh, "dp", 2, 1)
    for _ in range(mesh.shape["sp"] - 1):  # the shift back: n - 1 hops
        wt = ring_shift(wt, mesh, "sp")
    want = psum(wt, mesh, "tp")
    for x, g in zip(xs, want):
        torch.testing.assert_close(x.grad, g, atol=1e-6, rtol=1e-6)
