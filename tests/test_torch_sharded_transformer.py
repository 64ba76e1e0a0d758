"""The port's sharded transformer (mpistragglers_jl_tpu_torch/models/
transformer.py: ``param_specs``, ``shard_params``, ``make_forward``,
``sharded_loss_and_grads`` and the train steps given a ``Mesh``) on CPU
ranks, ``make_mesh(shape, ("dp", "sp", "tp"), devices=["cpu"] * n)``,
against the JAX package on its 8 host devices, parameters carried over
by ``params_from_jax`` and tokens made with numpy from a seed: the mesh
cases of the JAX package's tests/test_transformer.py and tests/
test_gqa.py.

Tolerances (f32; the programs sum in different orders): logits within
2e-4 absolute and relative of JAX's ``make_forward`` and
``forward_dense`` (the reference's own bound); gradients within 1e-4
absolute and 1e-3 relative of ``jax.grad`` of the JAX dense loss (the
reference's bound for its sharded gradients); parameters after three
SGD steps within 1e-5 of the JAX mesh step's; remat within 1e-6 of no
remat; AdamW within 1e-2 lr (ADAM_ATOL). Replicas of a leaf are
compared bit for bit.
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

from mpistragglers_jl_tpu.models import transformer as jt
from mpistragglers_jl_tpu.parallel import make_mesh as jmake_mesh
from mpistragglers_jl_tpu_torch.models import transformer as tt
from mpistragglers_jl_tpu_torch.parallel import PartitionSpec as P, make_mesh

CFG = dict(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=64)
GQA = dict(CFG, n_heads=8, d_model=64, n_kv_heads=2)
AXES = ("dp", "sp", "tp")
FWD, GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-4, 1e-3
# AdamW's first steps move a weight by about lr * g / (|g| + eps), so a
# gradient near eps turns the programs' f32 rounding into a visible part
# of lr (1.9e-5 at lr 1e-2 measured here): 1% of lr
ADAM_ATOL = 1e-4


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


def _tmesh(shape):
    return make_mesh(shape, AXES, devices=["cpu"] * int(np.prod(shape)))


def _tokens(vocab, B=4, L=16, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, L),
                                                dtype=np.int32)


def _batch(vocab, seed=5):
    data = _tokens(vocab, L=17, seed=seed)
    return data[:, :-1], data[:, 1:]


def _jax_forward(jcfg, jp, shape, toks):
    mesh = jmake_mesh(shape, AXES)
    fwd = jt.make_forward(jcfg, mesh)
    return np.asarray(fwd(
        jt.shard_params(jp, jcfg, mesh),
        jax.device_put(jnp.asarray(toks), NamedSharding(mesh, JP("dp",
                                                                 "sp")))))


def _dense_jax(jcfg, jp, toks):
    return np.asarray(jax.jit(partial(jt.forward_dense, cfg=jcfg))(
        jp, jnp.asarray(toks)))


def _port_forward(tcfg, tp, shape, toks):
    mesh = _tmesh(shape)
    out = tt.make_forward(tcfg, mesh)(tt.shard_params(tp, tcfg, mesh), toks)
    assert out.spec == P("dp", "sp") and out.shape == toks.shape + (
        tcfg.vocab,)
    return np.asarray(out)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


def _replicas_equal(tree):
    """Every leaf's positions that hold the same block hold equal bits."""
    for leaf in tt._leaves(tree):
        mesh = leaf.mesh
        named = {a for a in leaf.spec if a is not None}
        over = [a for a in mesh.axis_names if a not in named]
        for group in mesh.axis_groups(over):
            first = leaf.local(group[0])
            for r in group[1:]:
                assert torch.equal(leaf.local(r), first), (leaf, r)


@pytest.mark.parametrize("shape,attn", [
    ((2, 2, 2), "ring"),
    ((1, 4, 2), "ring"),
    ((2, 4, 1), "ring"),
    ((1, 2, 2), "ulysses"),
    ((2, 2, 2), "ulysses"),
])
def test_sharded_forward_matches_jax(shape, attn):
    fields = dict(CFG, attn=attn)
    jcfg, tcfg, jp, tp = _pair(fields, seed=1)
    toks = _tokens(CFG["vocab"])
    got = _port_forward(tcfg, tp, shape, toks)
    _close(got, _jax_forward(jcfg, jp, shape, toks), FWD, "make_forward")
    _close(got, _dense_jax(jcfg, jp, toks), FWD, "forward_dense")


def test_sharded_forward_flash_ulysses_matches_reference_dense():
    # the flash attention (its plain versions here) inside Ulysses; the
    # oracle is the reference-attention dense forward
    fields = dict(CFG, attn="ulysses", attn_impl="flash")
    jcfg, tcfg, jp, tp = _pair(fields, seed=1)
    toks = _tokens(CFG["vocab"])
    got = _port_forward(tcfg, tp, (1, 2, 2), toks)
    _close(got, _jax_forward(jcfg, jp, (1, 2, 2), toks), FWD,
           "JAX make_forward with its interpreted flash kernels")
    _close(got, _dense_jax(jt.TransformerConfig(**CFG), jp, toks), FWD,
           "reference-attention forward_dense")


@pytest.mark.parametrize("shape,attn,hkv", [
    ((2, 2, 2), "ring", 2),     # kv heads shard over tp (2 % 2 == 0)
    ((2, 2, 2), "ring", 1),     # MQA: kv replicated + sliced, tp=2
    ((1, 2, 4), "ring", 2),     # kv_heads < tp: replicated + sliced
    ((2, 2, 2), "ulysses", 2),
    ((1, 2, 2), "ulysses", 1),  # MQA through the ulysses a2a
    ((1, 2, 4), "ulysses", 2),
])
def test_sharded_gqa_forward_matches_jax(shape, attn, hkv):
    fields = dict(GQA, n_kv_heads=hkv, attn=attn)
    jcfg, tcfg, jp, tp = _pair(fields, seed=1)
    toks = _tokens(GQA["vocab"])
    got = _port_forward(tcfg, tp, shape, toks)
    _close(got, _jax_forward(jcfg, jp, shape, toks), FWD, "make_forward")
    _close(got, _dense_jax(jcfg, jp, toks), FWD, "forward_dense")


def test_long_context_memory_scaling_shape():
    # sp=8: each rank's sequence chunk is L/8
    fields = dict(vocab=31, d_model=16, n_heads=2, n_layers=1, d_ff=32)
    jcfg, tcfg, jp, tp = _pair(fields, seed=0)
    toks = _tokens(31, B=1, L=256, seed=6)
    got = _port_forward(tcfg, tp, (1, 8, 1), toks)
    assert got.shape == (1, 256, 31)
    _close(got, _dense_jax(jcfg, jp, toks), FWD, "forward_dense")


def test_param_specs_match_jax():
    for fields, shape in ((CFG, (2, 2, 2)), (GQA, (1, 2, 4)),
                          (GQA, (2, 2, 2)), (dict(GQA, n_kv_heads=1),
                                             (1, 2, 2))):
        want = jt.param_specs(jt.TransformerConfig(**fields),
                              jmake_mesh(shape, AXES))
        got = tt.param_specs(tt.TransformerConfig(**fields), _tmesh(shape))
        assert [tuple(s) for s in tt._leaves(got)] == [
            tuple(s) for s in jax.tree.leaves(
                want, is_leaf=lambda x: isinstance(x, JP))]


def test_kv_spec_replicated_when_kv_heads_below_tp():
    cfg = tt.TransformerConfig(**GQA)
    specs = tt.param_specs(cfg, _tmesh((1, 2, 4)))
    assert specs["layers"][0]["wk"] == P()
    assert specs["layers"][0]["wq"] == P(None, "tp", None)
    assert tt.param_specs(cfg, _tmesh((2, 2, 2)))["layers"][0]["wk"] == P(
        None, "tp", None)
    slicer = tt.make_kv_slice(cfg, _tmesh((1, 2, 4)))
    a = torch.arange(2.0).reshape(1, 1, 2, 1)
    # tp member t reads kv head t * 2 // 4; rank r = sp * 4 + t
    assert [slicer(a, r).item() for r in range(8)] == [0, 0, 1, 1] * 2
    assert tt.make_kv_slice(cfg, _tmesh((2, 2, 2))) is None


def test_kv_tp_misaligned_rejected():
    fields = dict(GQA, n_heads=12, d_model=96, n_kv_heads=3)
    with pytest.raises(ValueError, match="divide the other") as want:
        jt.param_specs(jt.TransformerConfig(**fields),
                       jmake_mesh((1, 2, 4), AXES))
    with pytest.raises(ValueError, match="divide the other") as got:
        tt.param_specs(tt.TransformerConfig(**fields), _tmesh((1, 2, 4)))
    assert str(got.value) == str(want.value)


def test_indivisible_heads_rejected():
    fields = dict(CFG, n_heads=2, d_model=32)
    with pytest.raises(ValueError, match="must divide over tp") as want:
        jt.param_specs(jt.TransformerConfig(**fields),
                       jmake_mesh((1, 1, 4), AXES))
    with pytest.raises(ValueError, match="must divide over tp") as got:
        tt.make_forward(tt.TransformerConfig(**fields), _tmesh((1, 1, 4)))
    assert str(got.value) == str(want.value)
    # Ulysses over sp=4 with 4 heads split over tp=2: 2 local heads
    fields = dict(CFG, attn="ulysses")
    jcfg, tcfg, jp, tp = _pair(fields, seed=0)
    toks = _tokens(CFG["vocab"])
    with pytest.raises(ValueError, match="divisible") as want:
        _jax_forward(jcfg, jp, (1, 4, 2), toks)
    with pytest.raises(ValueError, match="divisible") as got:
        _port_forward(tcfg, tp, (1, 4, 2), toks)
    assert str(got.value) == str(want.value)


def _dense_grads(jcfg, jp, toks, tgts):
    def dense_loss(p):
        logits = jt.forward_dense(p, jnp.asarray(toks), jcfg).astype(
            jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(
            logp, jnp.asarray(tgts)[..., None], axis=-1).mean()

    return jax.jit(jax.value_and_grad(dense_loss))(jp)


@pytest.mark.parametrize("fields,shape", [
    (dict(CFG, attn="ring"), (2, 2, 2)),
    (dict(GQA, attn="ring"), (2, 2, 2)),
    (dict(GQA, attn="ring"), (1, 2, 4)),  # the replicated-kv slice
    (dict(GQA, n_kv_heads=1, attn="ulysses"), (2, 2, 2)),
    (dict(CFG, attn="ulysses", attn_impl="flash"), (1, 2, 2)),
    # the reference bench's mesh: every group has one member, no sums
    (dict(CFG, attn="ulysses", attn_impl="flash"), (1, 1, 1)),
    (dict(GQA, attn="ulysses", attn_impl="flash", attn_window=5),
     (1, 2, 4)),
])
def test_sharded_grads_match_dense_jax(fields, shape):
    jcfg, tcfg, jp, tp = _pair(fields, seed=4)
    toks, tgts = _batch(fields["vocab"])
    jcfg_ref = dataclasses.replace(jcfg, attn_impl="reference")
    want_loss, want = _dense_grads(jcfg_ref, jp, toks, tgts)
    mesh = _tmesh(shape)
    loss, grads = tt.sharded_loss_and_grads(
        tt.shard_params(tp, tcfg, mesh), toks, tgts, tcfg, mesh)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    got = tt._leaves(grads)
    wl = jax.tree.leaves(want)
    assert len(got) == len(wl)
    for i, (a, b) in enumerate(zip(got, wl)):
        assert a.shape == b.shape
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"leaf {i}")
    _replicas_equal(grads)


def test_nll_loss_over_axes_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((4, 8, 61)).astype(np.float32) * 3
    tgt = rng.integers(0, 61, (4, 8), dtype=np.int32)
    jmesh = jmake_mesh((2, 2, 2), AXES)
    want = jax.jit(jax.shard_map(
        partial(jt.nll_loss, axes=("dp", "sp")), mesh=jmesh,
        in_specs=(JP("dp", "sp", None), JP("dp", "sp")), out_specs=JP()))(
            jnp.asarray(logits), jnp.asarray(tgt))
    mesh = _tmesh((2, 2, 2))
    lg = tt._data_locals(torch.as_tensor(logits), tt.TransformerConfig(),
                         mesh)[0]
    tg = tt._data_locals(tgt, tt.TransformerConfig(), mesh)[0]
    got = tt.nll_loss(lg, tg, ("dp", "sp"), mesh)
    assert len(got) == 8 and all(torch.equal(g, got[0]) for g in got)
    np.testing.assert_allclose(got[0].item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("attn", ["ulysses", "ring"])
def test_remat_grads_match_unremated(attn):
    """``remat`` checkpoints each layer across every rank; the loss is
    the same and the gradients agree to 1e-6 (the reference's own
    check, sharded half)."""
    fields = dict(CFG, vocab=64, attn=attn)
    _, tcfg, _, tp = _pair(fields, seed=1)
    toks, tgts = _batch(64, seed=0)
    mesh = _tmesh((2, 2, 2))
    sp = tt.shard_params(tp, tcfg, mesh)
    l0, g0 = tt.sharded_loss_and_grads(sp, toks, tgts, tcfg, mesh)
    l1, g1 = tt.sharded_loss_and_grads(
        sp, toks, tgts, dataclasses.replace(tcfg, remat=True), mesh)
    assert l0.item() == l1.item()
    for a, b in zip(tt._leaves(g0), tt._leaves(g1)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)


def test_sgd_steps_match_jax_and_keep_replicas_equal():
    fields = dict(CFG, attn="ulysses")
    jcfg, tcfg, jp, tp = _pair(fields, seed=3)
    toks, tgts = _batch(CFG["vocab"], seed=6)
    jmesh = jmake_mesh((2, 2, 2), AXES)
    sh = NamedSharding(jmesh, JP("dp", "sp"))
    jstep = jt.make_train_step(jcfg, jmesh, lr=0.1)
    jparams = jt.shard_params(jp, jcfg, jmesh)
    mesh = _tmesh((2, 2, 2))
    tstep = tt.make_train_step(tcfg, mesh, lr=0.1)
    sp = tt.shard_params(tp, tcfg, mesh)
    for i in range(3):
        jparams, jl = jstep(jparams, jax.device_put(jnp.asarray(toks), sh),
                            jax.device_put(jnp.asarray(tgts), sh))
        sp, tl = tstep(sp, toks, tgts)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6,
                                   err_msg=f"loss {i}")
    for i, (a, b) in enumerate(zip(tt._leaves(sp),
                                   jax.tree.leaves(jparams))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5,
                                   rtol=1e-5, err_msg=f"leaf {i}")
    _replicas_equal(sp)


def test_adamw_on_mesh_matches_dense_and_keeps_replicas_equal():
    """Three AdamW steps over the (2, 2, 2) mesh against three dense
    AdamW steps of the port and the JAX mesh step with optax.adamw,
    within ADAM_ATOL; replicas bit-equal after the steps."""
    fields = dict(CFG, attn="ulysses", attn_impl="flash")
    jcfg, tcfg, jp, tp = _pair(fields, seed=5)
    toks, tgts = _batch(CFG["vocab"], seed=7)
    mesh = _tmesh((2, 2, 2))
    step, init = tt.make_optax_train_step(tcfg, mesh, tx=tt.adamw(1e-2))
    sp = tt.shard_params(tp, tcfg, mesh)
    state = init(sp)
    dstep, dinit = tt.make_optax_train_step(tcfg, tx=tt.adamw(1e-2))
    dstate = dinit(tp)
    jmesh = jmake_mesh((2, 2, 2), AXES)
    sh = NamedSharding(jmesh, JP("dp", "sp"))
    jstep, jinit = jt.make_optax_train_step(jcfg, jmesh, optax.adamw(1e-2))
    jparams = jt.shard_params(jp, jcfg, jmesh)
    jstate = jinit(jparams)
    for i in range(3):
        sp, state, loss = step(sp, state, toks, tgts)
        tp, dstate, dloss = dstep(tp, dstate, toks, tgts)
        jparams, jstate, jl = jstep(jparams, jstate,
                                    jax.device_put(jnp.asarray(toks), sh),
                                    jax.device_put(jnp.asarray(tgts), sh))
        np.testing.assert_allclose(loss.item(), dloss.item(), rtol=1e-6)
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    for i, (a, b, c) in enumerate(zip(tt._leaves(sp), tt._leaves(tp),
                                      jax.tree.leaves(jparams))):
        np.testing.assert_allclose(np.asarray(a), b.numpy(),
                                   atol=ADAM_ATOL, rtol=1e-5,
                                   err_msg=f"dense leaf {i}")
        np.testing.assert_allclose(np.asarray(a), np.asarray(c),
                                   atol=ADAM_ATOL, rtol=1e-5,
                                   err_msg=f"JAX leaf {i}")
    _replicas_equal(sp)
    with pytest.raises(ValueError, match="init_state"):
        step(tt.shard_params(tp, tcfg, mesh), state, toks, tgts)


def test_train_step_reduces_loss_and_keeps_specs():
    _, tcfg, _, tp = _pair(CFG, seed=2)
    toks, tgts = _batch(CFG["vocab"], seed=3)
    mesh = _tmesh((2, 2, 2))
    params = tt.shard_params(tp, tcfg, mesh)
    specs = tt._leaves(tt.param_specs(tcfg, mesh))
    step = tt.make_train_step(tcfg, mesh, lr=0.1)
    donated = tt.shard_params(tp, tcfg, mesh)
    dstep = tt.make_train_step(tcfg, mesh, lr=0.1, donate=True)
    before = [t.clone() for t in tt._tensors(params)]
    losses = []
    for i in range(10):
        new, loss = step(params, toks, tgts)
        if i == 0:  # the undonated step leaves its input as it was
            assert all(torch.equal(a, b) for a, b in
                       zip(tt._tensors(params), before))
        params = new
        same, dloss = dstep(donated, toks, tgts)
        assert same is donated and dloss.item() == loss.item()
        losses.append(loss.item())
    assert losses[-1] < losses[0] - 0.1, losses
    for leaf, d, spec in zip(tt._leaves(params), tt._leaves(donated),
                             specs):
        assert leaf.spec == spec and leaf.mesh is mesh
        assert torch.equal(leaf.gather(), d.gather())
    assert "tp" in tuple(params["layers"][0]["wq"].spec)
    assert not any(t.requires_grad for t in tt._tensors(params))


def test_gqa_train_step_reduces_loss():
    fields = dict(GQA, attn="ulysses", attn_impl="flash")
    _, tcfg, _, tp = _pair(fields, seed=2)
    toks, tgts = _batch(GQA["vocab"], seed=3)
    mesh = _tmesh((1, 2, 4))
    params = tt.shard_params(tp, tcfg, mesh)
    step = tt.make_train_step(tcfg, mesh, lr=0.1)
    losses = []
    for _ in range(6):
        params, loss = step(params, toks, tgts)
        losses.append(loss.item())
    assert losses[-1] < losses[0] - 0.1, losses
    _replicas_equal(params)


def test_mesh_checks():
    cfg = tt.TransformerConfig(**CFG)
    with pytest.raises(ValueError, match="lacks"):
        tt.make_forward(cfg, make_mesh((2, 2), ("dp", "tp"),
                                       devices=["cpu"] * 4))
    mesh = _tmesh((1, 2, 2))
    with pytest.raises(TypeError, match="shard_params"):
        tt.make_forward(cfg, mesh)(tt.init_params(cfg, device="cpu"),
                                   _tokens(61))
    with pytest.raises(ValueError, match=r"lacks \['ep'\]"):
        tt.make_forward(tt.TransformerConfig(**CFG, n_experts=2), mesh)
    # positions another process drives: no collective crosses processes
    from mpistragglers_jl_tpu_torch.parallel import Mesh

    spread = Mesh(mesh.devices, AXES,
                  process_index=np.arange(4).reshape(1, 2, 2) % 2)
    with pytest.raises(ValueError, match="across processes"):
        tt.make_train_step(cfg, spread)
    with pytest.raises(ValueError, match=r"lacks \['ep'\]"):
        tt.shard_params({}, tt.TransformerConfig(**CFG, n_experts=2), mesh)
    assert tt.batch_axes(cfg) == ("dp", "sp")
    assert tt.data_spec(cfg) == P("dp", "sp")
    moe = tt.TransformerConfig(**CFG, n_experts=2)
    assert tt.batch_axes(moe) == ("dp", "ep", "sp")
    assert tuple(tt.data_spec(moe)) == (("dp", "ep"), "sp")


@pytest.mark.parametrize("other", ["--pair", "--moe"])
def test_train_profile_refuses_mesh_with_other_modes(other, monkeypatch,
                                                      capsys):
    from mpistragglers_jl_tpu_torch.bench import train_profile

    monkeypatch.setattr("sys.argv",
                        ["train_profile", "--mesh", "2,2,2", other])
    with pytest.raises(SystemExit) as exc:
        train_profile.main()
    assert exc.value.code == 2
    assert "--mesh" in capsys.readouterr().err


def test_train_profile_takes_moe_with_a_four_axis_mesh(monkeypatch,
                                                      capsys):
    """``--moe --mesh`` names the four axes of the expert-parallel step:
    the arguments pass and only the missing card stops it here."""
    from mpistragglers_jl_tpu_torch.bench import train_profile

    monkeypatch.setattr("sys.argv", ["train_profile", "--moe", "--mesh",
                                     "2,1,2,2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_profile.main()
    monkeypatch.setattr("sys.argv", ["train_profile", "--mesh", "2,1,2,2"])
    with pytest.raises(SystemExit) as exc:
        train_profile.main()
    assert exc.value.code == 2
    assert "--moe" in capsys.readouterr().err
