"""The port's mixture of experts (mpistragglers_jl_tpu_torch/models/moe.py,
and the MoE branches of models/transformer.py and models/decode.py)
against the JAX package's on the same numpy inputs, JAX on the CPU.

Routing is held on inputs whose two largest router probabilities differ
by far more than f32 rounding (each test asserts a gap above 1e-4), so
both frameworks pick the same expert; its integer outputs (expert,
slot, table) must then be bit-equal. Tolerances (f32, sums in other
orders): gates, aux and ``moe_ffn_dense`` within 1e-5; gather-form
gradients against the one-hot oracle's within 2e-4 (the reference
test's bound); the train steps as tests/test_torch_train.py (losses
1e-6 relative, parameters 1e-5 absolute and relative); generation is
greedy-token equality.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from mpistragglers_jl_tpu.models import decode as jd
from mpistragglers_jl_tpu.models import moe as jm
from mpistragglers_jl_tpu.models import transformer as jt
from mpistragglers_jl_tpu_torch.models import decode as td
from mpistragglers_jl_tpu_torch.models import moe as tm
from mpistragglers_jl_tpu_torch.models import transformer as tt
from mpistragglers_jl_tpu_torch.models.serving import ServingScheduler

SMALL = dict(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             attn="ulysses", attn_impl="flash", n_experts=4,
             capacity_factor=1.25, moe_aux_coef=0.01)
B, L = 2, 16
TOL = 1e-5
GAP = 1e-4  # least top-2 router probability gap the parity inputs keep


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().float().numpy()


def _route_inputs(seed, T=64, D=16, E=4, wg_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    wg = (rng.standard_normal((D, E)) * wg_scale).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(wg)))
    top2 = np.sort(probs, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > GAP, "near-tie in the router"
    return x, wg


def _expert_params(rng, E, D, Fd):
    return {
        "we1": (rng.standard_normal((E, D, Fd)) * 0.1).astype(np.float32),
        "be1": (rng.standard_normal((E, Fd)) * 0.1).astype(np.float32),
        "we2": (rng.standard_normal((E, Fd, D)) * 0.1).astype(np.float32),
        "be2": (rng.standard_normal((E, D)) * 0.1).astype(np.float32),
    }


@pytest.mark.parametrize("seed,C", [(0, 8), (1, 16), (2, 40), (3, 1)])
def test_routing_tables_are_bit_equal_to_jax(seed, C):
    """Experts, slots and the (E, C) table bit-equal at capacities that
    drop (8, 1) and that keep every token (40); gates and aux close."""
    x, wg = _route_inputs(seed)
    want = jm._route_tables(jnp.asarray(x), jnp.asarray(wg), C)
    got = tm._route_tables(torch.from_numpy(x), torch.from_numpy(wg), C)
    for name, a, b in zip(("table", "expert", "slot"), got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               atol=TOL, rtol=TOL)
    assert got[3].dtype == torch.float32 and got[4].dtype == torch.float32
    np.testing.assert_allclose(got[4].item(), float(want[4]), rtol=TOL)
    table, expert, gate, aux = tm.switch_route_indices(
        torch.from_numpy(x), torch.from_numpy(wg), C)
    assert torch.equal(table, got[0]) and torch.equal(expert, got[1])


@pytest.mark.parametrize("seed,C", [(0, 8), (2, 40)])
def test_switch_route_one_hot_equals_jax(seed, C):
    x, wg = _route_inputs(seed)
    want = jm.switch_route(jnp.asarray(x), jnp.asarray(wg), C)
    got = tm.switch_route(torch.from_numpy(x), torch.from_numpy(wg), C)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[2].item(), float(want[2]), rtol=TOL)


@pytest.mark.parametrize("seed,C", [(0, 8), (4, 16), (2, 40)])
def test_gather_dispatch_and_combine_equal_the_oracles(seed, C):
    """The gather form equals the one-hot einsum and the scatter-add
    combine in the port, and the JAX gather form on the same inputs."""
    x, wg = _route_inputs(seed)
    T, D = x.shape
    E = wg.shape[1]
    mp = _expert_params(np.random.default_rng(seed + 10), E, D, 32)
    tmp = {k: torch.from_numpy(v) for k, v in mp.items()}
    tx = torch.from_numpy(x)
    dispatch, combine, _ = tm.switch_route(tx, torch.from_numpy(wg), C)
    xe_a = torch.einsum("td,tec->ecd", tx, dispatch)
    ye_a = tm._expert_ffn(xe_a, tmp) + tmp["be2"][:, None, :]
    y_a = torch.einsum("ecd,tec->td", ye_a, combine)
    table, expert, slot, gate, _ = tm._route_tables(
        tx, torch.from_numpy(wg), C)
    xe_b = tm._GatherDispatch.apply(tx, table, expert, slot)
    torch.testing.assert_close(xe_b, xe_a, atol=1e-6, rtol=0)
    ye_b = tm._expert_ffn(xe_b, tmp) + tmp["be2"][:, None, :]
    kg = torch.where(slot < C, gate, 0.0)
    y_b = tm._CombinePerToken.apply(ye_b, table, expert, slot) * kg[:, None]
    torch.testing.assert_close(y_b, y_a, atol=TOL, rtol=TOL)
    gate_pad = torch.cat([gate, torch.zeros(1)])
    y_c = tm._scatter_combine(ye_b * gate_pad[table][..., None], table, T)
    torch.testing.assert_close(y_b, y_c, atol=1e-6, rtol=0)
    dropped = (dispatch.sum(dim=(1, 2)) == 0).numpy()
    np.testing.assert_array_equal(dropped, (slot >= C).numpy())
    assert dropped.any() == (C < 40)  # 40 seats hold every expert's tokens
    assert np.all(y_b.numpy()[dropped] == 0.0)
    # the JAX gather form on the same inputs
    jmp = {k: jnp.asarray(v) for k, v in mp.items()}
    jt_, je, js, jg, _ = jm._route_tables(jnp.asarray(x), jnp.asarray(wg), C)
    jxe = jm._gather_dispatch(jnp.asarray(x), jt_, je, js)
    jye = jm._expert_ffn(jxe, jmp) + jmp["be2"][:, None, :]
    jy = jm._combine_per_token(jye, jt_, je, js) * jnp.where(
        js < C, jg, 0.0)[:, None]
    np.testing.assert_allclose(y_b.numpy(), np.asarray(jy), atol=TOL,
                               rtol=TOL)


def test_capacity_drops_keep_the_first_tokens():
    """All tokens to one expert at capacity 3: the first three survive
    (token order), and moe_ffn_dense's dropped rows are exactly zero."""
    x = torch.ones(10, 4)
    wg = torch.zeros(4, 2)
    wg[:, 0] = 5.0
    dispatch, _, _ = tm.switch_route(x, wg, capacity=3)
    assert dispatch.sum().item() == 3.0
    assert dispatch.sum(dim=(1, 2))[:4].tolist() == [1, 1, 1, 0]
    rng = np.random.default_rng(7)
    mp = tm.init_moe_layer(rng, 16, 32, n_experts=2, n_layers=1,
                           dtype=torch.float32)
    mp["wg"] = torch.zeros(16, 2)
    mp["wg"][:, 0] = 8.0
    xs = torch.from_numpy(np.abs(rng.standard_normal((1, 10, 16))) + 0.1)
    y, _ = tm.moe_ffn_dense(xs.float(), mp, capacity_factor=0.4)  # C = 2
    norms = y[0].norm(dim=-1)
    assert (norms[:2] > 0).all() and (norms[2:] == 0).all()


def test_router_stays_f32_and_bf16_routing_matches():
    """At bf16 the router inits f32 and the experts bf16; routing from
    bf16 activations picks the f32 router's experts and slots, gates
    within bf16-input tolerance (the reference test's 2e-2)."""
    rng = np.random.default_rng(21)
    lp = tm.init_moe_layer(rng, d_model=64, d_ff=128, n_experts=4,
                           n_layers=2, dtype=torch.bfloat16)
    assert lp["wg"].dtype == torch.float32
    assert lp["we1"].dtype == torch.bfloat16
    x = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
    e32, s32, g32, aux32 = tm._route(x, lp["wg"])
    eb, sb, gb, auxb = tm._route(x.to(torch.bfloat16), lp["wg"])
    assert torch.equal(eb, e32) and torch.equal(sb, s32)
    assert gb.dtype == torch.float32 and auxb.dtype == torch.float32
    torch.testing.assert_close(gb, g32, atol=2e-2, rtol=0)
    assert abs(auxb.item() - aux32.item()) <= 2e-2


def _gather_loss(mod, x2d, mp, C, where):
    table, expert, slot, gate, _ = mod._route_tables(x2d, mp["wg"], C)
    if mod is tm:
        xe = tm._GatherDispatch.apply(x2d, table, expert, slot)
        ye = tm._expert_ffn(xe, mp) + mp["be2"][:, None, :]
        kg = where(slot < C, gate, 0.0).to(x2d.dtype)
        y = tm._CombinePerToken.apply(ye, table, expert, slot) * kg[:, None]
    else:
        xe = jm._gather_dispatch(x2d, table, expert, slot)
        ye = jm._expert_ffn(xe, mp) + mp["be2"][:, None, :]
        kg = where(slot < C, gate, 0.0).astype(x2d.dtype)
        y = jm._combine_per_token(ye, table, expert, slot) * kg[:, None]
    return (y ** 2).sum()


@pytest.mark.parametrize("C", [6, 24])
def test_gather_form_gradients_match_one_hot_and_jax(C):
    """d/dx, d/d(expert weights) and d/d(router) of the gather form
    against the port's one-hot oracle and against the JAX gather form's
    custom VJPs, drops included at C = 6."""
    rng = np.random.default_rng(7)
    T, D, E, Fd = 48, 12, 4, 24
    x = rng.standard_normal((T, D)).astype(np.float32)
    mp = {"wg": rng.standard_normal((D, E)).astype(np.float32),
          **_expert_params(rng, E, D, Fd)}
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(mp["wg"])))
    top2 = np.sort(probs, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > GAP
    names = sorted(mp)
    leaves = [torch.from_numpy(x).requires_grad_()] + [
        torch.from_numpy(mp[k]).requires_grad_() for k in names]
    tmp = dict(zip(names, leaves[1:]))

    def onehot_loss():
        dispatch, combine, _ = tm.switch_route(leaves[0], tmp["wg"], C)
        xe = torch.einsum("td,tec->ecd", leaves[0], dispatch)
        ye = tm._expert_ffn(xe, tmp) + tmp["be2"][:, None, :]
        return (torch.einsum("ecd,tec->td", ye, combine) ** 2).sum()

    lg = _gather_loss(tm, leaves[0], tmp, C, torch.where)
    g_gather = torch.autograd.grad(lg, leaves)
    lo = onehot_loss()
    g_onehot = torch.autograd.grad(lo, leaves)
    np.testing.assert_allclose(lg.item(), lo.item(), rtol=1e-6)
    for n, a, b in zip(["x"] + names, g_gather, g_onehot):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4,
                                   rtol=2e-4, err_msg=n)
    jmp = {k: jnp.asarray(v) for k, v in mp.items()}
    jl, (gx, gp) = jax.value_and_grad(
        lambda x2d, p: _gather_loss(jm, x2d, p, C, jnp.where),
        argnums=(0, 1))(jnp.asarray(x), jmp)
    np.testing.assert_allclose(lg.item(), float(jl), rtol=1e-6)
    want = [gx] + [gp[k] for k in names]
    for n, a, b in zip(["x"] + names, g_gather, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4,
                                   rtol=2e-4, err_msg=n)


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_moe_ffn_dense_matches_jax(cf):
    """y and aux of the layer on (B, L, D) activations, f32, within 1e-5,
    at capacity factors that drop (0.5, 1.25) and that do not (4.0)."""
    rng = np.random.default_rng(11)
    lp = jm.init_moe_layer(rng, 16, 32, n_experts=4, n_layers=2,
                           dtype=jnp.float32)
    lp = {k: np.array(v) for k, v in lp.items()}
    lp["be1"] = (rng.standard_normal(lp["be1"].shape) * 0.1).astype(np.float32)
    lp["be2"] = (rng.standard_normal(lp["be2"].shape) * 0.1).astype(np.float32)
    lp["wg"] = (rng.standard_normal(lp["wg"].shape)).astype(np.float32)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    _route_check = np.asarray(jax.nn.softmax(jnp.asarray(x.reshape(48, 16))
                                             @ jnp.asarray(lp["wg"])))
    top2 = np.sort(_route_check, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > GAP
    yj, auxj = jm.moe_ffn_dense(jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in lp.items()},
                                cf)
    yt, auxt = tm.moe_ffn_dense(torch.from_numpy(x),
                                {k: torch.from_numpy(v) for k, v in lp.items()},
                                cf)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(auxt.item(), float(auxj), rtol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_leaves_are_bit_equal_to_jax(dtype):
    """init_moe_layer and init_params from one seed: every leaf bit-equal
    to the JAX package's, the router f32 at both dtypes."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jm.init_moe_layer(np.random.default_rng(3), 32, 64, 4, 3, jdt)
    got = tm.init_moe_layer(np.random.default_rng(3), 32, 64, 4, 3, tdt)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == (torch.float32 if k == "wg" else tdt), k
        np.testing.assert_array_equal(
            _np(got[k]), np.asarray(want[k]).astype(np.float32), err_msg=k)
    fields = dict(SMALL, dtype=jdt)
    jp = jt.init_params(jt.TransformerConfig(**fields), seed=4)
    tp = tt.init_params(tt.TransformerConfig(**dict(SMALL, dtype=tdt)),
                        seed=4, device="cpu")
    assert sorted(tp["layers"][0]) == sorted(jp["layers"][0])
    assert "w1" not in tp["layers"][0]
    jl = jax.tree.leaves(jp)
    tl = tt._leaves(tp)
    assert len(tl) == len(jl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert a.dtype == {jnp.dtype(jnp.float32): torch.float32,
                           jnp.dtype(jnp.bfloat16): torch.bfloat16}[b.dtype]
        np.testing.assert_array_equal(_np(a), np.asarray(b).astype(
            np.float32), err_msg=f"leaf {i}")
    # the JAX carry-over keeps the router f32 at a bf16 model dtype
    carried = tt.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert carried["layers"][1]["wg"].dtype == torch.float32
    assert carried["layers"][1]["we2"].dtype == tdt


def _pair(fields, seed):
    jcfg = jt.TransformerConfig(**fields)
    jp = jt.init_params(jcfg, seed)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tt.TransformerConfig(**fields), jp, tp


def _batch(vocab, seed=1):
    tok = np.random.default_rng(seed).integers(0, vocab, (B, L + 1),
                                               dtype=np.int32)
    return tok[:, :-1], tok[:, 1:]


@pytest.mark.parametrize("impl,remat", [("flash", False),
                                        ("reference", False),
                                        ("reference", True)])
def test_moe_forward_matches_jax(impl, remat):
    fields = dict(SMALL, attn_impl=impl, remat=remat)
    jcfg, tcfg, jp, tp = _pair(fields, seed=2)
    inp, tgt = _batch(fields["vocab"])
    want, aux_w = jax.jit(partial(jt._forward_dense_aux, cfg=jcfg))(
        jp, jnp.asarray(inp))
    got, aux_g = tt._forward_dense_aux(tp, inp, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert aux_g.dtype == torch.float32
    np.testing.assert_allclose(aux_g.item(), float(aux_w), rtol=TOL)
    if remat:  # recomputed routing gives the same gradients
        plain = dataclasses.replace(tcfg, remat=False)
        _, g_r = tt.loss_and_grads(tp, inp, tgt, tcfg)
        _, g_p = tt.loss_and_grads(tp, inp, tgt, plain)
        for a, b in zip(tt._leaves(g_r), tt._leaves(g_p)):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1, 1),
                ("dp", "ep", "sp", "tp"))


def _assert_trees_close(tparams, jparams, what):
    tl = tt._leaves(tparams)
    jl = jax.tree.leaves(jparams)
    assert len(tl) == len(jl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=TOL, rtol=TOL,
                                   err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_moe_train_steps_match_jax(opt):
    """Two SGD steps, or one AdamW step, with the aux loss (coefficient
    0.01) against the JAX train step on a (1, 1, 1, 1) ("dp", "ep",
    "sp", "tp") mesh."""
    jcfg, tcfg, jp, tp = _pair(SMALL, seed=3)
    inp, tgt = _batch(SMALL["vocab"])
    if opt == "sgd":
        jstep = jt.make_train_step(jcfg, _mesh(), lr=0.1)
        tstep = tt.make_train_step(tcfg, lr=0.1)
        steps = 2
    else:
        js_, jinit = jt.make_optax_train_step(jcfg, _mesh(),
                                              optax.adamw(3e-3))
        ts_, tinit = tt.make_optax_train_step(tcfg, tx=tt.adamw(3e-3))
        jstate, tstate = jinit(jp), tinit(tp)
        steps = 1
    for i in range(steps):
        if opt == "sgd":
            jp, jl = jstep(jp, jnp.asarray(inp), jnp.asarray(tgt))
            tp, tl = tstep(tp, inp, tgt)
        else:
            jp, jstate, jl = js_(jp, jstate, jnp.asarray(inp),
                                 jnp.asarray(tgt))
            tp, tstate, tl = ts_(tp, tstate, inp, tgt)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6,
                                   err_msg=f"loss {i}")
    _assert_trees_close(tp, jp, f"params after {steps} {opt} steps")
    # the aux term is in the loss: without it the loss is lower
    no_aux = dataclasses.replace(tcfg, moe_aux_coef=0.0)
    l_aux, _ = tt.loss_and_grads(tp, inp, tgt, tcfg)
    l_plain, _ = tt.loss_and_grads(tp, inp, tgt, no_aux)
    assert l_aux.item() > l_plain.item()


def test_moe_router_stays_f32_through_a_bf16_step():
    cfg = tt.TransformerConfig(**dict(SMALL, attn_impl="reference"),
                               dtype=torch.bfloat16)
    p = tt.init_params(cfg, seed=0, device="cpu")
    inp, tgt = _batch(cfg.vocab)
    p, loss = tt.make_train_step(cfg, lr=0.1, donate=True)(p, inp, tgt)
    assert bool(torch.isfinite(loss))
    step, init = tt.make_optax_train_step(cfg, tx=tt.adamw(1e-3))
    p, _, _ = step(p, init(p), inp, tgt)
    assert all(lp["wg"].dtype == torch.float32 for lp in p["layers"])
    assert all(lp["we1"].dtype == torch.bfloat16 for lp in p["layers"])


GEN = dict(vocab=61, d_model=64, n_heads=8, n_kv_heads=2, n_layers=2,
           d_ff=128, n_experts=4, capacity_factor=4.0)


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_moe_generation_matches_jax_and_the_teacher_forced_forward(
        quantize_kv):
    """Greedy MoE generation (prefill + decode steps, capacity factor =
    n_experts, so nothing drops) equals the JAX package's tokens, and
    the f32-cache stream is the argmax of forward_dense teacher-forced
    on prompt + stream."""
    jcfg = jt.TransformerConfig(**GEN, dtype=jnp.float32)
    tcfg = tt.TransformerConfig(**GEN, dtype=torch.float32)
    jp = jt.init_params(jcfg, 5)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    prompt = np.random.default_rng(6).integers(1, GEN["vocab"], (3, 9),
                                               dtype=np.int32)
    n_new = 7
    want = np.asarray(jd.generate_dense(jp, jnp.asarray(prompt), n_new,
                                        jcfg, quantize_kv=quantize_kv))
    got = td.generate_dense(tp, prompt, n_new, tcfg,
                            quantize_kv=quantize_kv, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    if quantize_kv:
        return
    full = np.concatenate([prompt, got.numpy()[:, :-1]], axis=1)
    with torch.no_grad():
        tf = tt.forward_dense(tp, full, tcfg)[:, prompt.shape[1] - 1:]
    np.testing.assert_array_equal(tf.argmax(-1).numpy(), got.numpy())


def test_moe_prefill_logits_match_the_forward():
    """prefill_dense's logits equal forward_dense's (capacity from the
    call's own token count: the same call shape), and one decode step
    equals the last row of the forward over one more token."""
    cfg = tt.TransformerConfig(**GEN, dtype=torch.float32)
    p = tt.init_params(cfg, seed=8, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(9).integers(
        1, GEN["vocab"], (2, 12)))
    with torch.no_grad():
        cache = td.init_cache(cfg, 2, 16, device="cpu")
        lg, cache = td.prefill_dense(p, tok[:, :11], cache, cfg)
        torch.testing.assert_close(lg, tt.forward_dense(p, tok[:, :11], cfg),
                                   atol=1e-5, rtol=1e-5)
        step, _ = td.decode_step_dense(p, tok[:, 11], cache, 11, cfg)
        torch.testing.assert_close(step, tt.forward_dense(p, tok, cfg)[:, -1],
                                   atol=1e-5, rtol=1e-5)


def test_the_mesh_path_raises_and_the_scheduler_refuses_moe():
    """The mesh path runs (its contracts are tests/test_torch_moe_sharded
    .py): the specs are the reference's and ``moe_ffn_sharded`` on a
    one-member ep axis equals ``moe_ffn_dense``; the serving scheduler
    still refuses experts."""
    from mpistragglers_jl_tpu_torch.parallel import make_mesh

    want = jm.moe_layer_specs()
    assert {k: tuple(v) for k, v in tm.moe_layer_specs().items()} == {
        k: tuple(v) for k, v in want.items()}
    mp = tm.init_moe_layer(np.random.default_rng(1), 8, 16, 2, 1,
                           torch.float32)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((1, 6, 8)),
                        dtype=torch.float32)
    mesh = make_mesh(1, "ep", devices=["cpu"])
    (y,), (bias,), (aux,) = tm.moe_ffn_sharded([x], [mp], 1.0, mesh=mesh)
    y_d, aux_d = tm.moe_ffn_dense(x, mp, 1.0)
    torch.testing.assert_close(y + bias, y_d, atol=1e-6, rtol=1e-6)
    assert aux.item() == aux_d.item()
    cfg = tt.TransformerConfig(**GEN, attn_window=8)
    p = tt.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="serving scheduler covers "
                                         "dense-FFN configs"):
        ServingScheduler(p, cfg, slots=2, device="cpu")
