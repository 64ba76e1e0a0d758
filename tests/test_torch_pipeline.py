"""The port's pipeline (mpistragglers_jl_tpu_torch/parallel/pipeline.py:
GPipe, circular and 1F1B with MoE stages, ``measure_bubble``, the train
steps) on CPU ranks, ``make_mesh(shape, ("dp", "pp"), devices=["cpu"] *
n)``, against the JAX package's ``parallel/pipeline.py`` on its 8 host
devices: all of the JAX package's tests/test_pipeline.py and leg 4 of
``dryrun_multichip``, parameters carried over by ``params_from_jax`` and
tokens made with numpy from a seed.

Tolerances are the reference's: ``pipeline_spmd`` within 1e-6 of the
sequential layers; losses within 1e-5; gradients within 1e-4 absolute
and 1e-3 relative of ``jax.grad`` (GPipe, circular) or of JAX's own
1F1B gradients; the ``measure_bubble`` masks exactly equal; AdamW
trajectories within 2e-4 relative; parameters after three SGD steps
within 1e-5 of the JAX step's. With MoE stages at capacity factor 1.25
tokens drop, and the 1F1B oracle is the dense loss of each microbatch
alone, averaged over the microbatches.
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
from mpistragglers_jl_tpu.parallel import pipeline as jpl
from mpistragglers_jl_tpu_torch.models import transformer as tt
from mpistragglers_jl_tpu_torch.parallel import make_mesh
from mpistragglers_jl_tpu_torch.parallel import pipeline as pl
from mpistragglers_jl_tpu_torch.parallel.mesh import PartitionSpec as P
from mpistragglers_jl_tpu_torch.parallel.mesh import shard

CFG = dict(vocab=61, d_model=32, n_heads=4, n_layers=4, d_ff=64)
MOE = dict(CFG, n_experts=4, capacity_factor=1.25, moe_aux_coef=0.01)
AXES = ("dp", "pp")
LOSS, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(fields, seed):
    jcfg = jt.TransformerConfig(**fields)
    jp = jt.init_params(jcfg, seed)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tt.TransformerConfig(**fields), jp, tp


def _tmesh(shape, axes=AXES):
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _data(vocab, B=8, L=16, seed=3):
    d = np.random.default_rng(seed).integers(0, vocab, (B, L + 1),
                                             dtype=np.int32)
    return d[:, :-1], d[:, 1:]


def _jplace(jmesh, a):
    return jax.device_put(jnp.asarray(a), NamedSharding(jmesh, JP("dp")))


def _jax_grads(jcfg, jp, shape, toks, tgts, schedule, M, v=2):
    """JAX's loss and gradients of one pipeline step (the tree of
    stacked or device-major layers)."""
    jmesh = jmake_mesh(shape, AXES)
    vs = v if schedule == "circular" else None
    sp = jpl.shard_params_pipeline(jp, jcfg, jmesh, virtual_stages=vs)
    grad_fn = jpl._pipeline_grad_fn(jcfg, jmesh, M, schedule, v)
    return jax.jit(grad_fn)(sp, _jplace(jmesh, toks), _jplace(jmesh, tgts))


def _port_grads(tcfg, tp, shape, toks, tgts, schedule, M, v=2):
    mesh = _tmesh(shape)
    vs = v if schedule == "circular" else None
    sp = pl.shard_params_pipeline(tp, tcfg, mesh, virtual_stages=vs)
    return pl._pipeline_grad_fn(tcfg, mesh, M, schedule, v)(sp, toks, tgts)


def _close_trees(got, want, what):
    gl, wl = tt._leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for i, (a, b) in enumerate(zip(gl, wl)):
        assert tuple(a.shape) == b.shape, (i, a.shape, b.shape)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"{what} leaf {i}")


def _replicas_equal(tree):
    for leaf in tt._leaves(tree):
        named = {a for a in leaf.spec if a is not None}
        over = [a for a in leaf.mesh.axis_names if a not in named]
        for group in leaf.mesh.axis_groups(over):
            first = leaf.local(group[0])
            for r in group[1:]:
                assert torch.equal(leaf.local(r), first), (leaf, r)


def _affine_stage(stacked, x):
    for i in range(stacked["w"].shape[0]):
        x = torch.tanh(x @ stacked["w"][i] + stacked["b"][i])
    return x


def _jax_affine_stage(stacked, x):
    def one(h, lp):
        return jnp.tanh(h @ lp["w"] + lp["b"]), None

    return jax.lax.scan(one, x, stacked)[0]


@pytest.mark.parametrize("pp,n_micro", [(2, 2), (4, 2), (4, 4), (8, 2)])
def test_pipeline_spmd_matches_sequential(pp, n_micro):
    rng = np.random.default_rng(0)
    n_layers, B, D = 8, 8, 6
    w = (rng.standard_normal((n_layers, D, D)) / np.sqrt(D)).astype(
        np.float32)
    b = (rng.standard_normal((n_layers, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    want = torch.as_tensor(x)
    for i in range(n_layers):
        want = torch.tanh(want @ torch.as_tensor(w[i]) + torch.as_tensor(b[i]))
    mesh = _tmesh((pp,), ("pp",))
    stacked = {"w": shard(w, mesh, P("pp")), "b": shard(b, mesh, P("pp"))}
    local = [{k: v.local(r) for k, v in stacked.items()} for r in range(pp)]
    got = pl.pipeline_spmd(_affine_stage, local, [torch.as_tensor(x)] * pp,
                           mesh=mesh, n_microbatch=n_micro)
    for g in got:  # replicated over pp
        np.testing.assert_allclose(g.numpy(), want.numpy(), atol=1e-6,
                                   rtol=1e-6)
    jmesh = jmake_mesh((pp,), ("pp",))
    f = jax.jit(jax.shard_map(
        partial(jpl.pipeline_spmd, _jax_affine_stage, axis="pp",
                n_microbatch=n_micro),
        mesh=jmesh, in_specs=({"w": JP("pp"), "b": JP("pp")}, JP()),
        out_specs=JP()))
    jgot = f({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jgot), atol=1e-6,
                               rtol=1e-6)


def _dense_loss_jax(jcfg, jp, toks, tgts):
    def loss(p):
        logits = jt.forward_dense(p, jnp.asarray(toks), jcfg).astype(
            jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(
            logp, jnp.asarray(tgts)[..., None], axis=-1).mean()

    val, g = jax.jit(jax.value_and_grad(loss))(jp)
    g = dict(g)
    g["layers"] = jpl.stack_layers(g["layers"])
    return val, g


@pytest.mark.parametrize("shape", [(2, 4), (1, 4), (4, 2)])
def test_pipeline_loss_and_grads_match_dense(shape):
    jcfg, tcfg, jp, tp = _pair(CFG, seed=1)
    toks, tgts = _data(CFG["vocab"])
    want_loss, want = _dense_loss_jax(jcfg, jp, toks, tgts)
    loss, grads = _port_grads(tcfg, tp, shape, toks, tgts, "gpipe", 2)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=LOSS,
                               rtol=LOSS)
    _close_trees(grads, want, "dense")
    jl, jg = _jax_grads(jcfg, jp, shape, toks, tgts, "gpipe", 2)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS)
    _close_trees(grads, jg, "JAX gpipe")
    _replicas_equal(grads)


def _sgd_matches_jax(fields, shape, schedule, M, v=2, steps=3, seed=2):
    jcfg, tcfg, jp, tp = _pair(fields, seed=seed)
    toks, tgts = _data(fields["vocab"], seed=5)
    jmesh = jmake_mesh(shape, AXES)
    vs = v if schedule == "circular" else None
    jparams = jpl.shard_params_pipeline(jp, jcfg, jmesh, virtual_stages=vs)
    jstep = jpl.make_pipeline_train_step(jcfg, jmesh, n_microbatch=M, lr=0.1,
                                         schedule=schedule,
                                         virtual_stages=v)
    mesh = _tmesh(shape)
    params = pl.shard_params_pipeline(tp, tcfg, mesh, virtual_stages=vs)
    step = pl.make_pipeline_train_step(tcfg, mesh, n_microbatch=M, lr=0.1,
                                       schedule=schedule, virtual_stages=v)
    got, want = [], []
    for _ in range(steps):
        params, loss = step(params, toks, tgts)
        jparams, jl = jstep(jparams, _jplace(jmesh, toks),
                            _jplace(jmesh, tgts))
        got.append(loss.item())
        want.append(float(jl))
    np.testing.assert_allclose(got, want, rtol=LOSS)
    for i, (a, b) in enumerate(zip(tt._leaves(params),
                                   jax.tree.leaves(jparams))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5,
                                   rtol=1e-5, err_msg=f"leaf {i}")
    _replicas_equal(params)
    return params, got


@pytest.mark.parametrize("schedule,shape,M", [
    ("gpipe", (2, 4), 2), ("1f1b", (2, 4), 2), ("1f1b", (2, 2), 4),
    ("circular", (2, 2), 2),
])
def test_pipeline_sgd_steps_match_jax(schedule, shape, M):
    fields = dict(CFG, n_layers=8) if schedule == "circular" else CFG
    params, _ = _sgd_matches_jax(fields, shape, schedule, M)
    assert "pp" in tuple(params["layers"]["wq"].spec)


def test_pipeline_train_step_reduces_loss_and_stays_sharded():
    _, tcfg, _, tp = _pair(CFG, seed=2)
    mesh = _tmesh((2, 4))
    params = pl.shard_params_pipeline(tp, tcfg, mesh)
    step = pl.make_pipeline_train_step(tcfg, mesh, n_microbatch=2, lr=0.1,
                                       donate=True)
    toks, tgts = _data(CFG["vocab"], seed=5)
    losses = []
    for _ in range(10):
        same, loss = step(params, toks, tgts)
        assert same is params
        losses.append(loss.item())
    assert losses[-1] < losses[0] - 0.1, losses
    assert "pp" in tuple(params["layers"]["wq"].spec)
    assert not any(t.requires_grad for t in tt._tensors(params))


def test_pipeline_validates_divisibility():
    mesh = _tmesh((1, 4))
    bad = tt.TransformerConfig(**dict(CFG, n_layers=3))
    with pytest.raises(ValueError, match="divisible"):
        pl.make_pipeline_train_step(bad, mesh, n_microbatch=2)
    pmesh = _tmesh((4,), ("pp",))
    layers = [{"w": torch.eye(4), "b": torch.zeros(4)}] * 4
    with pytest.raises(ValueError, match="microbatch"):
        pl.pipeline_spmd(_affine_stage, [pl.stack_layers(layers[:1])] * 4,
                         [torch.zeros(6, 4)] * 4, mesh=pmesh,
                         n_microbatch=4)
    with pytest.raises(ValueError, match=r"lacks \['dp'\]"):
        pl.make_pipeline_train_step(tt.TransformerConfig(**CFG), pmesh,
                                    n_microbatch=2)
    cfg = tt.TransformerConfig(**CFG)
    step = pl.make_pipeline_train_step(cfg, mesh, n_microbatch=2)
    dense = tt.init_params(cfg, device="cpu")
    with pytest.raises(TypeError, match="shard_params_pipeline"):
        step(dict(dense, layers=pl.stack_layers(dense["layers"])),
             *_data(CFG["vocab"]))
    with pytest.raises(ValueError, match="leaves"):
        step(dense, *_data(CFG["vocab"]))


# ------------------------------------------------------------------ 1F1B


@pytest.mark.parametrize("shape", [(2, 4), (1, 4), (4, 2)])
def test_1f1b_loss_and_grads_match_dense(shape):
    """The hand-written backward wavefront (ring residuals, recompute,
    cotangent hops) gives the dense oracle's loss and gradients."""
    jcfg, tcfg, jp, tp = _pair(CFG, seed=1)
    toks, tgts = _data(CFG["vocab"])
    want_loss, want = _dense_loss_jax(jcfg, jp, toks, tgts)
    loss, grads = _port_grads(tcfg, tp, shape, toks, tgts, "1f1b", 2)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=LOSS,
                               rtol=LOSS)
    _close_trees(grads, want, "dense")
    jl, jg = _jax_grads(jcfg, jp, shape, toks, tgts, "1f1b", 2)
    _close_trees(grads, jg, "JAX 1f1b")
    _replicas_equal(grads)


def _per_micro_oracle(tcfg, tp, toks, tgts, shape, M):
    """The dense MoE loss of each microbatch alone (aux included),
    averaged: every (dp, microbatch) block routes its own tokens."""
    dp = shape[0]
    rows = toks.shape[0] // (dp * M)
    return np.mean([tt.loss_and_grads(
        tp, toks[i * rows:(i + 1) * rows], tgts[i * rows:(i + 1) * rows],
        tcfg)[0].item() for i in range(dp * M)])


@pytest.mark.parametrize("shape,M", [((2, 2), 2), ((1, 4), 2), ((4, 2), 2),
                                     ((2, 2), 4)])
def test_1f1b_moe_stages_match_jax_and_the_per_microbatch_oracle(shape, M):
    """MoE stages (capacity factor 1.25: tokens drop) with the aux loss
    riding the payload: loss and gradients (the router's ``wg`` through
    the aux term included) against JAX's 1F1B, and the loss against the
    dense loss of each microbatch alone, averaged."""
    jcfg, tcfg, jp, tp = _pair(MOE, seed=3)
    toks, tgts = _data(MOE["vocab"], seed=7)
    loss, grads = _port_grads(tcfg, tp, shape, toks, tgts, "1f1b", M)
    jl, jg = _jax_grads(jcfg, jp, shape, toks, tgts, "1f1b", M)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS)
    _close_trees(grads, jg, "JAX 1f1b moe")
    oracle = _per_micro_oracle(tcfg, tp, toks, tgts, shape, M)
    np.testing.assert_allclose(loss.item(), oracle, rtol=LOSS)
    whole = tt.loss_and_grads(tp, toks, tgts, tcfg)[0].item()
    assert abs(whole - oracle) > LOSS * abs(oracle)  # misses the limit


def test_1f1b_dropped_aux_cotangent_breaks_the_router_gradient(
        monkeypatch):
    """The control of the aux term's gradient: with ``dL/d aux`` zeroed
    in every backward slot's cotangent, the loss is unchanged and the
    router's gradient leaves JAX's."""
    jcfg, tcfg, jp, tp = _pair(MOE, seed=3)
    toks, tgts = _data(MOE["vocab"], seed=7)
    _, jg = _jax_grads(jcfg, jp, (2, 2), toks, tgts, "1f1b", 2)
    right = pl._vjp

    def dropped(outputs, inputs, grad_outputs):
        if grad_outputs is not None:
            grad_outputs = (grad_outputs[0],
                            torch.zeros_like(grad_outputs[1]))
        return right(outputs, inputs, grad_outputs)

    monkeypatch.setattr(pl, "_vjp", dropped)
    _, grads = _port_grads(tcfg, tp, (2, 2), toks, tgts, "1f1b", 2)
    wg = np.asarray(grads["layers"]["wg"])
    want = np.asarray(jg["layers"]["wg"])
    assert not np.allclose(wg, want, atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("pp", [2, 4])
def test_1f1b_moe_pipeline_loss_decreases(pp):
    cfg = tt.TransformerConfig(**dict(MOE, capacity_factor=2.0))
    mesh = _tmesh((8 // pp, pp))
    params = pl.shard_params_pipeline(
        tt.init_params(cfg, seed=3, device="cpu"), cfg, mesh)
    step = pl.make_pipeline_train_step(cfg, mesh, n_microbatch=2, lr=0.1,
                                       schedule="1f1b")
    toks, tgts = _data(cfg.vocab, seed=7)
    losses = []
    for _ in range(10):
        params, loss = step(params, toks, tgts)
        losses.append(loss.item())
    assert losses[-1] < losses[0] - 0.05, losses
    assert "pp" in tuple(params["layers"]["we1"].spec)
    _replicas_equal(params)


def test_dryrun_leg4_1f1b_moe_stages():
    """``dryrun_multichip`` leg 4 at its 8-device shapes: (dp, pp) = (4,
    2), 4 layers of 2 experts, aux 0.01, two 1F1B steps at lr 0.1 over 2
    microbatches; the loss falls, both losses equal the JAX leg's, and
    the bubble is 0.5."""
    fields = dict(vocab=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
                  n_experts=2, moe_aux_coef=0.01)
    jcfg, tcfg, jp, tp = _pair(fields, seed=1)
    data = np.random.default_rng(0).integers(0, 64, (16, 9), dtype=np.int32)
    toks, tgts = data[:, :-1], data[:, 1:]
    jmesh = jmake_mesh((4, 2), AXES)
    jparams = jpl.shard_params_pipeline(jp, jcfg, jmesh)
    jstep = jpl.make_pipeline_train_step(jcfg, jmesh, n_microbatch=2, lr=0.1)
    mesh = _tmesh((4, 2))
    params = pl.shard_params_pipeline(tp, tcfg, mesh)
    step = pl.make_pipeline_train_step(tcfg, mesh, n_microbatch=2, lr=0.1)
    got, want = [], []
    for _ in range(2):
        params, loss = step(params, toks, tgts)
        jparams, jl = jstep(jparams, _jplace(jmesh, toks),
                            _jplace(jmesh, tgts))
        got.append(loss.item())
        want.append(float(jl))
    assert got[1] < got[0], got
    np.testing.assert_allclose(got, want, rtol=LOSS)
    assert pl.bubble_fraction(2, 2, "1f1b") == 0.5


def test_gpipe_schedule_rejects_moe():
    cfg = tt.TransformerConfig(**dict(CFG, n_experts=4))
    with pytest.raises(NotImplementedError, match="1f1b"):
        pl.make_pipeline_train_step(cfg, _tmesh((2, 4)), n_microbatch=2,
                                    schedule="gpipe")


def test_bubble_fraction_metric():
    for f in (pl.bubble_fraction, jpl.bubble_fraction):
        assert f(1, 4) == 0.0
        assert f(4, 4) == pytest.approx(6 / 10)
        assert f(4, 4, "gpipe") == pytest.approx(3 / 7)
        assert f(4, 32) == pytest.approx(6 / 38)
        assert f(4, 64) < f(4, 8)
        with pytest.raises(ValueError):
            f(4, 4, "pipedream")
    for args in [(4, 8, "circular:2"), (4, 8, "circular:4"),
                 (2, 4, "circular"), (8, 16, "gpipe"), (3, 5, "1f1b")]:
        assert pl.bubble_fraction(*args) == jpl.bubble_fraction(*args)


def test_gpipe_schedule_train_step_reduces_loss():
    _, tcfg, _, tp = _pair(CFG, seed=4)
    mesh = _tmesh((2, 4))
    params = pl.shard_params_pipeline(tp, tcfg, mesh)
    step = pl.make_pipeline_train_step(tcfg, mesh, n_microbatch=2, lr=0.1,
                                       schedule="gpipe")
    toks, tgts = _data(CFG["vocab"], seed=9)
    losses = []
    for _ in range(8):
        params, loss = step(params, toks, tgts)
        losses.append(loss.item())
    assert losses[-1] < losses[0] - 0.05, losses


# --------------------------------------------------------------- circular


def _undo_devmajor(a):
    """(pp, v, lpc, ...) device-major chunks back to (L, ...) layers."""
    a = np.asarray(a)
    ppx, vx, lpc = a.shape[:3]
    return np.swapaxes(a, 0, 1).reshape(vx * ppx * lpc, *a.shape[3:])


@pytest.mark.parametrize("shape,v,n_micro", [
    ((2, 4), 2, 4),
    ((4, 2), 2, 2),
    ((2, 2), 4, 4),
])
def test_circular_loss_and_grads_match_dense(shape, v, n_micro):
    fields = dict(CFG, vocab=37, n_layers=8)
    jcfg, tcfg, jp, tp = _pair(fields, seed=1)
    toks, tgts = _data(37)
    want_loss, want = _dense_loss_jax(jcfg, jp, toks, tgts)
    loss, grads = _port_grads(tcfg, tp, shape, toks, tgts, "circular",
                              n_micro, v)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=LOSS,
                               rtol=LOSS)
    for k, b in want["layers"].items():
        np.testing.assert_allclose(_undo_devmajor(grads["layers"][k]),
                                   np.asarray(b), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=k)
    for k in ("emb", "lnf_s", "lnf_b"):
        np.testing.assert_allclose(np.asarray(grads[k]), np.asarray(want[k]),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)
    _, jg = _jax_grads(jcfg, jp, shape, toks, tgts, "circular", n_micro, v)
    _close_trees(grads, jg, "JAX circular")


def test_circular_train_step_reduces_loss():
    fields = dict(CFG, n_layers=8)
    _, tcfg, _, tp = _pair(fields, seed=3)
    mesh = _tmesh((2, 4))
    params = pl.shard_params_pipeline(tp, tcfg, mesh, virtual_stages=2)
    step = pl.make_pipeline_train_step(tcfg, mesh, n_microbatch=4, lr=0.1,
                                       schedule="circular",
                                       virtual_stages=2)
    toks, tgts = _data(CFG["vocab"], seed=11)
    losses = []
    for _ in range(8):
        params, loss = step(params, toks, tgts)
        losses.append(loss.item())
    assert losses[-1] < losses[0] - 0.05, losses


def test_circular_validation_and_bubble():
    cfg = tt.TransformerConfig(**dict(CFG, n_layers=8))
    mesh = _tmesh((2, 4))
    with pytest.raises(ValueError, match=r"v\*pp"):
        pl.make_pipeline_train_step(cfg, mesh, n_microbatch=4,
                                    schedule="circular", virtual_stages=3)
    with pytest.raises(ValueError, match=r"v\*pp"):
        pl.shard_params_pipeline(tt.init_params(cfg, device="cpu"), cfg,
                                 mesh, virtual_stages=3)
    assert pl.bubble_fraction(4, 8, "circular:2") == pytest.approx(3 / 19)
    assert pl.bubble_fraction(4, 8, "circular:4") == pytest.approx(3 / 35)
    moe = tt.TransformerConfig(**dict(CFG, n_layers=8, n_experts=2))
    with pytest.raises(NotImplementedError, match="1f1b"):
        pl.make_pipeline_train_step(moe, mesh, n_microbatch=4,
                                    schedule="circular")
    # a layout of v=2 stepped with v=4 raises the reference's error
    # (an index past the layout would apply a prefix of the chunks)
    mesh = _tmesh((1, 2))
    params = pl.shard_params_pipeline(tt.init_params(cfg, device="cpu"),
                                      cfg, mesh, virtual_stages=2)
    step = pl.make_pipeline_train_step(cfg, mesh, n_microbatch=2,
                                       schedule="circular", virtual_stages=4)
    with pytest.raises(ValueError, match="virtual stages per device") as got:
        step(params, *_data(CFG["vocab"]))
    assert "v=4" in str(got.value)


def test_circular_layout_is_jax_device_major():
    cfg = tt.TransformerConfig(**dict(CFG, n_layers=8))
    jcfg = jt.TransformerConfig(**dict(CFG, n_layers=8))
    jp = jt.init_params(jcfg, 0)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    got = pl.shard_params_pipeline(tp, cfg, _tmesh((2, 2)), virtual_stages=2)
    want = jpl.shard_params_pipeline(jp, jcfg, jmake_mesh((2, 2), AXES),
                                     virtual_stages=2)
    for a, b in zip(tt._leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert [tuple(s) for s in tt._leaves(pl.pipeline_param_specs(cfg))] == [
        tuple(s) for s in jax.tree.leaves(
            jpl.pipeline_param_specs(jcfg),
            is_leaf=lambda x: isinstance(x, JP))]


# ------------------------------------------------------------ the bubble


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("pp,M", [(2, 4), (4, 8), (8, 8)])
def test_measured_bubble_matches_formula(schedule, pp, M):
    r = pl.measure_bubble(_tmesh((pp,), ("pp",)), M, schedule)
    assert r["measured"] == pytest.approx(r["formula"], abs=1e-12)
    busy = r["busy"]
    if schedule == "gpipe":
        assert busy.shape == (pp, M + pp - 1)
        assert (busy.sum(axis=1) == M).all()
    else:
        assert busy.shape == (pp, M + 2 * (pp - 1), 2)
        assert (busy[:, :, 0].sum(axis=1) == M).all()
        assert (busy[:, :, 1].sum(axis=1) == M).all()
    want = jpl.measure_bubble(jmake_mesh((pp,), ("pp",)), M, schedule)
    np.testing.assert_array_equal(busy, np.asarray(want["busy"]))
    assert {k: r[k] for k in ("schedule", "ticks", "formula")} == {
        k: want[k] for k in ("schedule", "ticks", "formula")}


@pytest.mark.parametrize("pp,M,v", [(2, 4, 2), (4, 8, 2), (4, 8, 4)])
def test_measured_bubble_circular_implementation_overhead(pp, M, v):
    r = pl.measure_bubble(_tmesh((pp,), ("pp",)), M, "circular", v=v)
    T = v * M + pp
    assert r["ticks"] == T
    assert r["measured"] == pytest.approx(pp / T, abs=1e-12)
    assert r["formula"] == pytest.approx(
        pl.bubble_fraction(pp, M, f"circular:{v}"))
    assert r["measured"] > r["formula"]  # the documented gap
    assert (r["busy"].sum(axis=1) == v * M).all()
    want = jpl.measure_bubble(jmake_mesh((pp,), ("pp",)), M, "circular", v=v)
    np.testing.assert_array_equal(r["busy"], np.asarray(want["busy"]))


def test_measured_bubble_on_a_dp_pp_mesh():
    """On a (dp, pp) mesh the mask is one pp group's (every dp replica
    runs the same schedule), as JAX's out_specs P("pp")."""
    r = pl.measure_bubble(_tmesh((2, 4)), 4, "1f1b")
    want = jpl.measure_bubble(jmake_mesh((2, 4), AXES), 4, "1f1b")
    np.testing.assert_array_equal(r["busy"], np.asarray(want["busy"]))


# --------------------------------------------------------------- optax


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe", "circular"])
def test_optax_pipeline_train_step_adamw(schedule):
    """AdamW over each schedule: the loss falls, each moment lives beside
    its stage's shard, and the trajectory equals JAX's optax.adamw run
    within 2e-4."""
    fields = dict(CFG, n_layers=8)
    vkw = {"virtual_stages": 2} if schedule == "circular" else {}
    jcfg, tcfg, jp, tp = _pair(fields, seed=3)
    mesh = _tmesh((2, 4))
    params = pl.shard_params_pipeline(
        tp, tcfg, mesh, virtual_stages=vkw.get("virtual_stages"))
    step, init = pl.make_optax_pipeline_train_step(
        tcfg, mesh, tt.adamw(1e-2), n_microbatch=4, schedule=schedule,
        **vkw)
    state = init(params)
    toks, tgts = _data(fields["vocab"], seed=11)
    losses = []
    for _ in range(6):
        params, state, loss = step(params, state, toks, tgts)
        losses.append(loss.item())
    assert losses[-1] < losses[0] - 0.02, losses
    for p_ in tt._tensors(params):
        st = state.state[p_]
        assert st["exp_avg"].device == p_.device
        assert st["exp_avg"].shape == p_.shape
    jmesh = jmake_mesh((2, 4), AXES)
    jparams = jpl.shard_params_pipeline(
        jp, jcfg, jmesh, virtual_stages=vkw.get("virtual_stages"))
    jstep, jinit = jpl.make_optax_pipeline_train_step(
        jcfg, jmesh, optax.adamw(1e-2), n_microbatch=4, schedule=schedule,
        **vkw)
    jstate = jinit(jparams)
    want = []
    for _ in range(6):
        jparams, jstate, jl = jstep(jparams, jstate, _jplace(jmesh, toks),
                                    _jplace(jmesh, tgts))
        want.append(float(jl))
    np.testing.assert_allclose(losses, want, rtol=2e-4)
    _replicas_equal(params)


def test_optax_pipeline_1f1b_matches_gpipe_trajectory():
    """1F1B computes its gradients in its own loop, GPipe by autograd
    through the schedule: the same AdamW from both gives the same loss
    curve."""
    toks, tgts = _data(CFG["vocab"], seed=5)
    curves = {}
    for schedule in ("1f1b", "gpipe"):
        _, tcfg, _, tp = _pair(CFG, seed=0)
        mesh = _tmesh((2, 2))
        params = pl.shard_params_pipeline(tp, tcfg, mesh)
        step, init = pl.make_optax_pipeline_train_step(
            tcfg, mesh, tt.adamw(1e-2), n_microbatch=4, schedule=schedule)
        state = init(params)
        losses = []
        for _ in range(4):
            params, state, loss = step(params, state, toks, tgts)
            losses.append(loss.item())
        curves[schedule] = losses
    np.testing.assert_allclose(curves["1f1b"], curves["gpipe"], rtol=2e-4)


def test_stage_attention_is_the_configs_local_attention():
    """Stages run ``_local_attention(cfg)``: with ``attn_impl="flash"``
    (its plain versions on the CPU) 1F1B matches the reference
    attention's gradients."""
    fields = dict(CFG, attn="ulysses", attn_impl="flash")
    jcfg, tcfg, jp, tp = _pair(fields, seed=1)
    toks, tgts = _data(CFG["vocab"])
    ref = dataclasses.replace(jcfg, attn_impl="reference")
    want_loss, want = _dense_loss_jax(ref, jp, toks, tgts)
    loss, grads = _port_grads(tcfg, tp, (2, 2), toks, tgts, "1f1b", 2)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS)
    _close_trees(grads, want, "flash 1f1b")
