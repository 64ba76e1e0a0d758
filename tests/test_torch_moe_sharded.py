"""The port's expert-parallel MoE (mpistragglers_jl_tpu_torch/models/
moe.py ``moe_layer_specs``, ``moe_ffn_sharded``, and the MoE branch of
the sharded program in models/transformer.py) on CPU ranks,
``make_mesh(shape, ("dp", "sp", "tp", "ep"), devices=["cpu"] * n)``,
against the JAX package on its 8 host devices: the mesh cases of the JAX
package's tests/test_moe.py and leg 5 of ``dryrun_multichip``, parameters
carried over by ``params_from_jax`` and tokens made with numpy from a
seed.

Tolerances (f32; the programs sum in different orders): logits within
2e-4 absolute and relative of JAX's ``make_forward`` and of
``forward_dense`` at capacity factor 4 (nothing drops, so local and
global routing agree); losses within 1e-5 relative; gradients within
1e-4 absolute and 1e-3 relative of ``jax.grad`` of the JAX sharded loss;
parameters after three SGD steps within 1e-5 of the JAX mesh step's.
At capacity factor 1.25 tokens drop, and the oracle is the dense MoE
loss of each (dp, ep) batch shard alone, averaged over the shards.
Replicas of a leaf are compared bit for bit.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from mpistragglers_jl_tpu.models import moe as jm
from mpistragglers_jl_tpu.models import transformer as jt
from mpistragglers_jl_tpu.parallel import make_mesh as jmake_mesh
from mpistragglers_jl_tpu_torch.models import moe as tm
from mpistragglers_jl_tpu_torch.models import transformer as tt
from mpistragglers_jl_tpu_torch.parallel import PartitionSpec as P, make_mesh
from mpistragglers_jl_tpu_torch.parallel.collectives import (
    all_gather,
    all_to_all,
)
from mpistragglers_jl_tpu_torch.parallel.mesh import shard

# tests/test_moe.py's CFG: 4 experts at capacity factor 4 (no drops)
CFG = dict(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           n_experts=4, capacity_factor=4.0)
AXES = ("dp", "sp", "tp", "ep")
MESHES = [(1, 1, 1, 4), (2, 1, 2, 2), (1, 2, 2, 2)]
FWD, LOSS, GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-5, 1e-4, 1e-3
ADAM_ATOL = 1e-4  # as tests/test_torch_sharded_transformer.py


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


def _tmesh(shape, axes=AXES):
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _batch(vocab, B=8, L=16, seed=5):
    data = np.random.default_rng(seed).integers(0, vocab, (B, L + 1),
                                                dtype=np.int32)
    return data[:, :-1], data[:, 1:]


def _jplace(jmesh, jcfg, a):
    return jax.device_put(jnp.asarray(a),
                          NamedSharding(jmesh, jt.data_spec(jcfg)))


def _jax_loss_and_grads(jcfg, jp, shape, toks, tgts, axes=AXES):
    jmesh = jmake_mesh(shape, axes)
    loss_fn = jax.jit(jt._make_loss_fn(jcfg, jmesh))
    return jax.value_and_grad(loss_fn)(
        jt.shard_params(jp, jcfg, jmesh), _jplace(jmesh, jcfg, toks),
        _jplace(jmesh, jcfg, tgts))


def _replicas_equal(tree):
    """Every leaf's positions that hold the same block hold equal bits."""
    for leaf in tt._leaves(tree):
        named = {a for part in leaf.spec if part is not None
                 for a in ((part,) if isinstance(part, str) else part)}
        over = [a for a in leaf.mesh.axis_names if a not in named]
        for group in leaf.mesh.axis_groups(over):
            first = leaf.local(group[0])
            for r in group[1:]:
                assert torch.equal(leaf.local(r), first), (leaf, r)


def _close_leaves(got, want, what):
    wl = jax.tree.leaves(want)
    gl = tt._leaves(got)
    assert len(gl) == len(wl)
    for i, (a, b) in enumerate(zip(gl, wl)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"{what} leaf {i}")


def test_moe_layer_specs_match_jax():
    got = tm.moe_layer_specs()
    want = jm.moe_layer_specs()
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k]) == tuple(want[k]), k
    jcfg, tcfg, _, _ = _pair(CFG, 0)
    want = jt.param_specs(jcfg, jmake_mesh((2, 1, 2, 2), AXES))
    got = tt.param_specs(tcfg, _tmesh((2, 1, 2, 2)))
    assert [tuple(s) for s in tt._leaves(got)] == [
        tuple(s) for s in jax.tree.leaves(
            want, is_leaf=lambda x: isinstance(x, JP))]


@pytest.mark.parametrize("shape", MESHES)
def test_moe_sharded_forward_matches_jax(shape):
    jcfg, tcfg, jp, tp = _pair(CFG, seed=1)
    toks, _ = _batch(CFG["vocab"], seed=0)
    mesh = _tmesh(shape)
    out = tt.make_forward(tcfg, mesh)(tt.shard_params(tp, tcfg, mesh), toks)
    assert tuple(out.spec) == (("dp", "ep"), "sp")
    got = np.asarray(out)
    jmesh = jmake_mesh(shape, AXES)
    want = np.asarray(jt.make_forward(jcfg, jmesh)(
        jt.shard_params(jp, jcfg, jmesh), _jplace(jmesh, jcfg, toks)))
    np.testing.assert_allclose(got, want, atol=FWD, rtol=FWD)
    dense = np.asarray(jax.jit(partial(jt.forward_dense, cfg=jcfg))(
        jp, jnp.asarray(toks)))
    np.testing.assert_allclose(got, dense, atol=FWD, rtol=FWD)


@pytest.mark.parametrize("shape,aux", [
    ((2, 1, 1, 2), 0.0),   # tests/test_moe.py's gradient mesh
    ((2, 1, 1, 2), 0.01),
    ((1, 1, 1, 4), 0.01),
    ((2, 1, 2, 2), 0.01),
    ((1, 2, 2, 2), 0.01),
    ((1, 1, 2, 4), 0.01),
])
def test_moe_sharded_grads_match_jax(shape, aux):
    fields = dict(CFG, moe_aux_coef=aux)
    jcfg, tcfg, jp, tp = _pair(fields, seed=4)
    toks, tgts = _batch(CFG["vocab"])
    want_loss, want = _jax_loss_and_grads(jcfg, jp, shape, toks, tgts)
    mesh = _tmesh(shape)
    loss, grads = tt.sharded_loss_and_grads(
        tt.shard_params(tp, tcfg, mesh), toks, tgts, tcfg, mesh)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS)
    _close_leaves(grads, want, "grad")
    _replicas_equal(grads)


def test_moe_sharded_grads_match_dense_jax():
    """tests/test_moe.py's own check: at capacity factor 4 and without
    the aux term the sharded gradients are the dense loss's."""
    jcfg, tcfg, jp, tp = _pair(CFG, seed=4)
    toks, tgts = _batch(CFG["vocab"])

    def dense_loss(p):
        logits = jt.forward_dense(p, jnp.asarray(toks), jcfg).astype(
            jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(
            logp, jnp.asarray(tgts)[..., None], axis=-1).mean()

    want = jax.jit(jax.grad(dense_loss))(jp)
    mesh = _tmesh((2, 1, 1, 2))
    _, grads = tt.sharded_loss_and_grads(tt.shard_params(tp, tcfg, mesh),
                                         toks, tgts, tcfg, mesh)
    _close_leaves(grads, want, "dense grad")


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (1, 2, 1, 2)])
def test_moe_flash_ulysses_grads_match_jax(shape):
    """The reference bench's program (Ulysses over the flash attention,
    its plain versions here) on its (1, 1, 1, 1) mesh, and with sp."""
    fields = dict(CFG, attn="ulysses", attn_impl="flash", moe_aux_coef=0.01)
    jcfg, tcfg, jp, tp = _pair(fields, seed=2)
    toks, tgts = _batch(CFG["vocab"], seed=8)
    want_loss, want = _jax_loss_and_grads(jcfg, jp, shape, toks, tgts)
    mesh = _tmesh(shape)
    loss, grads = tt.sharded_loss_and_grads(
        tt.shard_params(tp, tcfg, mesh), toks, tgts, tcfg, mesh)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS)
    _close_leaves(grads, want, "grad")


def _chunk_labels(E, C, D, ep):
    """Per ep member, an (E, C, D) slot tensor whose values name the
    sender and the expert: sender * 100 + expert."""
    e = torch.arange(E, dtype=torch.float32)[:, None, None]
    return [(100.0 * m + e).expand(E, C, D).clone() for m in range(ep)]


@pytest.mark.parametrize("E,ep", [(4, 2), (4, 4), (8, 2)])
def test_ep_chunk_lands_on_the_owner_of_its_experts(E, ep):
    """Chunk j of a member's (E, C, D) slots is experts [j E/ep, (j+1)
    E/ep): the all-to-all must hand it to the member whose ``we1`` shard
    holds those experts (a swapped order is a silent wrong answer), and
    the inverse must bring each member's own slots back."""
    mesh = _tmesh((1, 1, 1, ep))
    C, D = 3, 2
    xs = _chunk_labels(E, C, D, ep)
    got = all_to_all(xs, mesh, "ep", split_dim=0, concat_dim=1)
    we1 = shard(torch.arange(E, dtype=torch.float32)[:, None, None]
                .expand(E, 4, 2).clone(), mesh, tm.moe_layer_specs()["we1"])
    ep_idx = mesh.axis_index("ep")
    El = E // ep
    for r, g in enumerate(got):
        assert g.shape == (El, ep * C, D)
        owned = we1.local(r)[:, 0, 0]  # the experts this member holds
        assert owned.tolist() == list(range(ep_idx[r] * El,
                                            (ep_idx[r] + 1) * El))
        for m in range(ep):  # sender m's seats of my experts, in order
            blk = g[:, m * C:(m + 1) * C]
            assert torch.equal(blk[:, :, 0].mean(1), 100.0 * m + owned)
    back = all_to_all(got, mesh, "ep", split_dim=1, concat_dim=0)
    for a, b in zip(back, xs):
        assert torch.equal(a, b)


def test_swapped_expert_shards_change_the_answer():
    """The control of the chunk order: the same program with two ep
    members' expert shards swapped gives other logits."""
    _, tcfg, _, tp = _pair(CFG, seed=1)
    toks, _ = _batch(CFG["vocab"], seed=0)
    mesh = _tmesh((1, 1, 1, 2))
    sp = tt.shard_params(tp, tcfg, mesh)
    right = np.asarray(tt.make_forward(tcfg, mesh)(sp, toks))
    for lp in sp["layers"]:
        for k in ("we1", "be1", "we2", "be2"):
            lp[k].shards.flat[0], lp[k].shards.flat[1] = (
                lp[k].shards.flat[1], lp[k].shards.flat[0])
    wrong = np.asarray(tt.make_forward(tcfg, mesh)(sp, toks))
    assert np.abs(wrong - right).max() > 1e-2


@pytest.mark.parametrize("shape", [(2, 1, 2, 2), (1, 1, 1, 4),
                                   (2, 2, 1, 2)])
@pytest.mark.parametrize("aux", [0.0, 0.01])
def test_cf125_loss_is_the_per_shard_dense_loss(shape, aux):
    """At capacity factor 1.25 tokens drop, and local routing is not the
    dense routing. With sp=1 the oracle is the port's dense MoE loss of
    each (dp, ep) batch shard alone (aux included), averaged over the
    shards; the dense loss of the whole batch misses it. With sp > 1
    each rank routes a piece of its rows: the JAX program decides."""
    fields = dict(CFG, capacity_factor=1.25, moe_aux_coef=aux)
    jcfg, tcfg, jp, tp = _pair(fields, seed=6)
    toks, tgts = _batch(CFG["vocab"], seed=9)
    mesh = _tmesh(shape)
    loss, grads = tt.sharded_loss_and_grads(
        tt.shard_params(tp, tcfg, mesh), toks, tgts, tcfg, mesh)
    want_loss, want = _jax_loss_and_grads(jcfg, jp, shape, toks, tgts)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS)
    _close_leaves(grads, want, "grad")
    if shape[1] > 1:
        return
    shards = shape[0] * shape[3]
    rows = toks.shape[0] // shards
    oracle = np.mean([tt.loss_and_grads(
        tp, toks[i * rows:(i + 1) * rows], tgts[i * rows:(i + 1) * rows],
        tcfg)[0].item() for i in range(shards)])
    np.testing.assert_allclose(loss.item(), oracle, rtol=LOSS)
    whole = tt.loss_and_grads(tp, toks, tgts, tcfg)[0].item()
    assert abs(whole - oracle) > LOSS * abs(oracle)  # misses the limit
    # tokens did drop at this capacity
    x = tp["emb"][torch.as_tensor(toks[:rows]).long()].reshape(-1, 32)
    C = tm._capacity(x.shape[0], 4, 1.25)
    table = tm.switch_route_indices(x, tp["layers"][0]["wg"], C)[0]
    assert (table < x.shape[0]).sum().item() < x.shape[0]


def test_moe_remat_grads_match_unremated():
    fields = dict(CFG, moe_aux_coef=0.01)
    _, tcfg, _, tp = _pair(fields, seed=1)
    toks, tgts = _batch(CFG["vocab"], seed=0)
    mesh = _tmesh((2, 1, 2, 2))
    sp = tt.shard_params(tp, tcfg, mesh)
    l0, g0 = tt.sharded_loss_and_grads(sp, toks, tgts, tcfg, mesh)
    l1, g1 = tt.sharded_loss_and_grads(
        sp, toks, tgts, dataclasses.replace(tcfg, remat=True), mesh)
    assert l0.item() == l1.item()
    for a, b in zip(tt._leaves(g0), tt._leaves(g1)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("shape", [(2, 1, 2, 2), (1, 1, 2, 2)])
def test_moe_sgd_steps_match_jax_and_keep_replicas_equal(shape):
    fields = dict(CFG, moe_aux_coef=0.01)
    jcfg, tcfg, jp, tp = _pair(fields, seed=3)
    toks, tgts = _batch(CFG["vocab"], seed=6)
    jmesh = jmake_mesh(shape, AXES)
    jstep = jt.make_train_step(jcfg, jmesh, lr=0.1)
    jparams = jt.shard_params(jp, jcfg, jmesh)
    mesh = _tmesh(shape)
    tstep = tt.make_train_step(tcfg, mesh, lr=0.1)
    sp = tt.shard_params(tp, tcfg, mesh)
    for i in range(3):
        jparams, jl = jstep(jparams, _jplace(jmesh, jcfg, toks),
                            _jplace(jmesh, jcfg, tgts))
        sp, tl = tstep(sp, toks, tgts)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS,
                                   err_msg=f"loss {i}")
    for i, (a, b) in enumerate(zip(tt._leaves(sp),
                                   jax.tree.leaves(jparams))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5,
                                   rtol=1e-5, err_msg=f"leaf {i}")
    _replicas_equal(sp)
    assert "ep" in tuple(sp["layers"][0]["we1"].spec)


def test_moe_adamw_on_mesh_matches_jax():
    fields = dict(CFG, moe_aux_coef=0.01)
    jcfg, tcfg, jp, tp = _pair(fields, seed=5)
    toks, tgts = _batch(CFG["vocab"], seed=7)
    shape = (2, 1, 2, 2)
    mesh = _tmesh(shape)
    step, init = tt.make_optax_train_step(tcfg, mesh, tx=tt.adamw(1e-2))
    sp = tt.shard_params(tp, tcfg, mesh)
    state = init(sp)
    jmesh = jmake_mesh(shape, AXES)
    jstep, jinit = jt.make_optax_train_step(jcfg, jmesh, optax.adamw(1e-2))
    jparams = jt.shard_params(jp, jcfg, jmesh)
    jstate = jinit(jparams)
    for i in range(3):
        sp, state, loss = step(sp, state, toks, tgts)
        jparams, jstate, jl = jstep(jparams, jstate,
                                    _jplace(jmesh, jcfg, toks),
                                    _jplace(jmesh, jcfg, tgts))
        np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS)
    for i, (a, b) in enumerate(zip(tt._leaves(sp),
                                   jax.tree.leaves(jparams))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=ADAM_ATOL, rtol=1e-5,
                                   err_msg=f"leaf {i}")
    _replicas_equal(sp)


def test_dryrun_leg5_moe_expert_parallel_train_step():
    """``dryrun_multichip`` leg 5 at its 8-device shapes: (dp, sp, tp, ep)
    = (2, 1, 2, 2), 4 experts, aux 0.01, two SGD steps at lr 0.1; the
    loss falls and both losses equal the JAX leg's."""
    fields = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                  n_experts=4, moe_aux_coef=0.01)
    jcfg, tcfg, jp, tp = _pair(fields, seed=2)
    data = np.random.default_rng(0).integers(0, 64, (8, 9), dtype=np.int32)
    toks, tgts = data[:, :-1], data[:, 1:]
    shape = (2, 1, 2, 2)
    jmesh = jmake_mesh(shape, AXES)
    jstep = jt.make_train_step(jcfg, jmesh, lr=0.1)
    jparams = jt.shard_params(jp, jcfg, jmesh)
    mesh = _tmesh(shape)
    step = tt.make_train_step(tcfg, mesh, lr=0.1)
    sp = tt.shard_params(tp, tcfg, mesh)
    got, want = [], []
    for _ in range(2):
        sp, loss = step(sp, toks, tgts)
        jparams, jl = jstep(jparams, _jplace(jmesh, jcfg, toks),
                            _jplace(jmesh, jcfg, tgts))
        got.append(loss.item())
        want.append(float(jl))
    assert got[1] < got[0], got
    np.testing.assert_allclose(got, want, rtol=LOSS)


def test_moe_train_step_reduces_loss_and_stays_sharded():
    """tests/test_moe.py's step test: ten SGD steps at lr 0.1 on (2, 1,
    2, 2); the experts stay ep-sharded, replicas bit-equal."""
    fields = dict(CFG, moe_aux_coef=0.01)
    _, tcfg, _, tp = _pair(fields, seed=2)
    toks, tgts = _batch(CFG["vocab"], L=16, seed=3)
    mesh = _tmesh((2, 1, 2, 2))
    params = tt.shard_params(tp, tcfg, mesh)
    step = tt.make_train_step(tcfg, mesh, lr=0.1, donate=True)
    losses = []
    for _ in range(10):
        params, loss = step(params, toks, tgts)
        losses.append(loss.item())
    assert losses[-1] < losses[0] - 0.1, losses
    assert "ep" in tuple(params["layers"][0]["we1"].spec)
    _replicas_equal(params)


@pytest.mark.parametrize("ep,dim", [(2, 0), (4, 0), (2, 1), (4, 1)])
def test_all_gather_matches_jax_and_its_transpose(ep, dim):
    """The tiled all-gather against ``jax.lax.all_gather(tiled=True)``
    inside ``shard_map``, and its gradient against JAX's (each owner
    gets the sum of its members' cotangent slices)."""
    rng = np.random.default_rng(ep + dim)
    x = rng.standard_normal((4 * ep, 6)).astype(np.float32)
    gathered = (4 * ep, 6) if dim == 0 else (4, 6 * ep)
    w = rng.standard_normal((ep * gathered[0], gathered[1])).astype(
        np.float32)
    jmesh = jmake_mesh((ep,), ("ep",))

    def local(xl, wl):
        g = jax.lax.all_gather(xl, "ep", axis=dim, tiled=True)
        return jax.lax.psum((g * wl).sum(), "ep")

    f = jax.shard_map(local, mesh=jmesh, in_specs=(JP("ep"), JP("ep")),
                      out_specs=JP())
    want, want_g = jax.value_and_grad(f)(jnp.asarray(x), jnp.asarray(w))
    mesh = _tmesh((ep,), ("ep",))
    xs = [t.clone().requires_grad_(True)
          for t in torch.as_tensor(x).split(4, dim=0)]
    ws = torch.as_tensor(w).split(gathered[0], dim=0)
    g = all_gather(xs, mesh, "ep", dim=dim)
    assert all(tuple(gi.shape) == gathered for gi in g)
    assert len({gi.data_ptr() for gi in g}) == ep  # fresh per member
    total = sum((gi * wi).sum() for gi, wi in zip(g, ws))
    total.backward()
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(torch.cat([t.grad for t in xs]).numpy(),
                               np.asarray(want_g), rtol=1e-5, atol=1e-6)


def test_moe_mesh_checks():
    moe = tt.TransformerConfig(**CFG)
    with pytest.raises(ValueError, match=r"lacks \['ep'\]"):
        tt.make_forward(moe, _tmesh((1, 2, 2), ("dp", "sp", "tp")))
    with pytest.raises(ValueError, match="n_experts 4 must divide over "
                                         "ep=8"):
        tt.make_train_step(moe, _tmesh((1, 1, 1, 8)))
    with pytest.raises(ValueError, match="d_ff 6 must divide over tp=4"):
        tt.make_train_step(dataclasses.replace(moe, d_ff=6),
                           _tmesh((1, 1, 4, 1)))
    assert tt.batch_axes(moe) == ("dp", "ep", "sp")
    assert tuple(tt.data_spec(moe)) == (("dp", "ep"), "sp")
    # a tuple spec entry splits over the axes' product, the first major
    mesh = _tmesh((2, 1, 1, 2))
    t = torch.arange(8).reshape(8, 1)
    sh = shard(t, mesh, P(("dp", "ep")))
    assert [sh.local(r).flatten().tolist() for r in range(4)] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    assert torch.equal(sh.gather(), t)
