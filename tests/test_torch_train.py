"""Single-device training of the port (mpistragglers_jl_tpu_torch/models/
transformer.py: forward_dense, nll_loss, make_train_step,
make_optax_train_step) against the JAX package on the same numpy inputs,
JAX on the CPU with its flash kernels in Pallas interpret mode. The JAX
train steps run on a (1, 1, 1) ("dp", "sp", "tp") mesh with Ulysses
attention over the flash kernel, the bench's program at one device.

Tolerances (f32; both sum in f32 in different orders): logits within
1e-5, losses within 1e-6 relative, parameters after two steps within
1e-5 absolute and relative.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from mpistragglers_jl_tpu.models import transformer as jt
from mpistragglers_jl_tpu_torch.models import transformer as tt

SMALL = dict(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             attn="ulysses", attn_impl="flash")
GQA_WINDOW = dict(SMALL, n_kv_heads=2, attn_window=5)
B, L = 2, 16
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "sp", "tp"))


def _pair(fields, seed=0):
    """JAX config and params, the port's config, and the JAX params
    carried over."""
    jcfg = jt.TransformerConfig(**fields)
    jp = jt.init_params(jcfg, seed)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tt.TransformerConfig(**fields), jp, tp


def _batch(vocab, seed=1):
    tok = np.random.default_rng(seed).integers(0, vocab, (B, L + 1),
                                               dtype=np.int32)
    return tok[:, :-1], tok[:, 1:]


def _assert_trees_close(tparams, jparams, what):
    tl = tt._leaves(tparams)
    jl = jax.tree.leaves(jparams)
    assert len(tl) == len(jl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=TOL, rtol=TOL,
                                   err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_forward_dense_logits(impl):
    fields = dict(SMALL, attn_impl=impl)
    jcfg, tcfg, jp, tp = _pair(fields, seed=2)
    inp, _ = _batch(fields["vocab"])
    want = jax.jit(partial(jt.forward_dense, cfg=jcfg))(jp, jnp.asarray(inp))
    got = tt.forward_dense(tp, inp, tcfg)
    assert got.shape == (B, L, fields["vocab"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_nll_loss():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((B, L, 61)).astype(np.float32) * 3
    tgt = rng.integers(0, 61, (B, L), dtype=np.int32)
    spec = P("dp", "sp")
    want = jax.shard_map(partial(jt.nll_loss, axes=("dp", "sp")),
                         mesh=_mesh(), in_specs=(P("dp", "sp", None), spec),
                         out_specs=P())(jnp.asarray(logits), jnp.asarray(tgt))
    got = tt.nll_loss(torch.as_tensor(logits), torch.as_tensor(tgt))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    bf = tt.nll_loss(torch.as_tensor(logits).to(torch.bfloat16), tgt)
    np.testing.assert_allclose(bf.item(), float(want), rtol=1e-2)


def _two_sgd_steps(fields, lr=0.1):
    jcfg, tcfg, jp, tp = _pair(fields, seed=3)
    inp, tgt = _batch(fields["vocab"])
    jstep = jt.make_train_step(jcfg, _mesh(), lr=lr)
    tstep = tt.make_train_step(tcfg, lr=lr)
    for i in range(2):
        jp, jl = jstep(jp, jnp.asarray(inp), jnp.asarray(tgt))
        tp, tl = tstep(tp, inp, tgt)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6,
                                   err_msg=f"loss {i}")
    _assert_trees_close(tp, jp, "params after two SGD steps")
    return tp


def test_two_sgd_steps_match_jax():
    _two_sgd_steps(SMALL)


def test_gqa_window_sgd_steps_match_jax():
    _two_sgd_steps(GQA_WINDOW)


def test_donated_step_updates_in_place():
    """donate=True writes the update into the given tensors; the default
    leaves them as they were. Both give the same parameters."""
    _, tcfg, _, tp = _pair(SMALL, seed=3)
    inp, tgt = _batch(SMALL["vocab"])
    before = [p.clone() for p in tt._leaves(tp)]
    new, loss = tt.make_train_step(tcfg, lr=0.1)(tp, inp, tgt)
    assert all(torch.equal(a, b) for a, b in zip(tt._leaves(tp), before))
    same, loss_d = tt.make_train_step(tcfg, lr=0.1, donate=True)(tp, inp,
                                                                 tgt)
    assert same is tp and loss_d.item() == loss.item()
    for a, b in zip(tt._leaves(tp), tt._leaves(new)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not any(p.requires_grad for p in tt._leaves(tp))


def test_two_adamw_steps_match_optax():
    jcfg, tcfg, jp, tp = _pair(SMALL, seed=5)
    inp, tgt = _batch(SMALL["vocab"], seed=6)
    jstep, jinit = jt.make_optax_train_step(jcfg, _mesh(), optax.adamw(1e-2))
    tstep, tinit = tt.make_optax_train_step(tcfg, tx=tt.adamw(1e-2))
    js, ts = jinit(jp), tinit(tp)
    for i in range(2):
        jp, js, jl = jstep(jp, js, jnp.asarray(inp), jnp.asarray(tgt))
        tp, ts, tl = tstep(tp, ts, inp, tgt)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6,
                                   err_msg=f"loss {i}")
    _assert_trees_close(tp, jp, "params after two AdamW steps")
    with pytest.raises(ValueError, match="init_state"):
        tstep(tt.params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), ts,
              inp, tgt)


def test_remat_matches_no_remat():
    """Recomputing every layer in the backward gives the same loss and
    gradients (1e-6)."""
    _, tcfg, _, tp = _pair(GQA_WINDOW, seed=7)
    inp, tgt = _batch(SMALL["vocab"], seed=8)
    loss, grads = tt.loss_and_grads(tp, inp, tgt, tcfg)
    loss_r, grads_r = tt.loss_and_grads(
        tp, inp, tgt, dataclasses.replace(tcfg, remat=True))
    assert loss_r.item() == loss.item()
    for a, b in zip(tt._leaves(grads_r), tt._leaves(grads)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_fused_backward_config_matches_split():
    _, tcfg, _, tp = _pair(GQA_WINDOW, seed=7)
    inp, tgt = _batch(SMALL["vocab"], seed=8)
    _, grads = tt.loss_and_grads(tp, inp, tgt, tcfg)
    _, grads_f = tt.loss_and_grads(
        tp, inp, tgt, dataclasses.replace(tcfg, flash_bwd="fused"))
    for a, b in zip(tt._leaves(grads_f), tt._leaves(grads)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_unported_configurations_raise():
    with pytest.raises(NotImplementedError, match="item 15"):
        tt.TransformerConfig(**SMALL, n_experts=4)
    with pytest.raises(NotImplementedError, match="item 18"):
        tt.make_train_step(tt.TransformerConfig(**SMALL), mesh=["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="item 18"):
        tt.make_optax_train_step(tt.TransformerConfig(**SMALL),
                                 mesh=np.array(["cpu"] * 4).reshape(2, 2, 1),
                                 tx=tt.adamw(1e-3))
    tt.make_train_step(tt.TransformerConfig(**SMALL), mesh="cpu")
    with pytest.raises(ValueError) as want:
        jt.TransformerConfig(**dict(SMALL, attn="ring"))
    with pytest.raises(ValueError) as got:
        tt.TransformerConfig(**dict(SMALL, attn="ring"))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="flash_bwd"):
        tt.TransformerConfig(**SMALL, flash_bwd="nope")
