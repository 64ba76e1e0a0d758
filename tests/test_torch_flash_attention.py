"""The port's flash attention (mpistragglers_jl_tpu_torch/ops/
flash_attention.py) against the JAX package's on the same numpy inputs,
JAX on the CPU with its Pallas kernels in interpret mode.

On the CPU every port kernel wrapper runs its plain version, so these
tests hold the plain versions of K1-K4 and the autograd function around
them to the reference. Tolerances (f32): outputs and logsumexp within
2e-5 absolute and relative, gradients within 5e-5 (the bounds of the
JAX package's own tests/test_flash_attention.py); both sum in f32 in
different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.ops import flash_attention as jfa
from mpistragglers_jl_tpu_torch.ops import flash_attention as tfa

OUT, GRAD = 2e-5, 5e-5
B, L, H, D = 2, 32, 4, 8
BLOCK = 16  # the JAX kernels' block: two per axis, so blocks are skipped


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want, tol, what):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), atol=tol, rtol=tol, err_msg=what)


def _three(hkv, seed):
    """(B*H, L, D) q3 and do3, (B*Hkv, L, D) k3 and v3."""
    return _arrays([(B * H, L, D), (B * hkv, L, D), (B * hkv, L, D),
                    (B * H, L, D)], seed)


CASES = [(causal, window, hkv) for causal in (False, True)
         for window in (None, 5) for hkv in (1, 2, 4)]


@pytest.mark.parametrize("causal,window,hkv", [
    (False, None, 1), (False, 5, 2), (True, None, 4), (True, 5, 2)])
def test_plain_kernels_match_jax_kernels(causal, window, hkv):
    """K1's plain version against the reference's `_fwd` (o, lse); the
    split (K2, K3) and fused (K4) backwards, plain, against `_bwd` and
    `_bwd_fused` (dq, dk, dv with the GQA group sum)."""
    q3, k3, v3, do3 = _three(hkv, seed=hkv + 10 * causal + (window or 0))
    g, scale = H // hkv, D ** -0.5
    jo, jlse = jfa._fwd(jnp.asarray(q3), jnp.asarray(k3), jnp.asarray(v3),
                        scale, causal, window, BLOCK, BLOCK, g, True)
    tq, tk, tv, tdo = map(torch.as_tensor, (q3, k3, v3, do3))
    to, tlse = tfa._fwd_ref(tq, tk, tv, scale, causal, window, g)
    _close(to, jo, OUT, "o")
    _close(tlse, jlse, OUT, "lse")
    jargs = (jnp.asarray(q3), jnp.asarray(k3), jnp.asarray(v3), jo, jlse,
             jnp.asarray(do3), scale, causal, window, BLOCK, BLOCK, g, True)
    targs = (tq, tk, tv, torch.as_tensor(np.array(jo)),
             torch.as_tensor(np.array(jlse)), tdo, scale, causal, window, g)
    for jimpl, timpl in ((jfa._bwd, tfa._bwd),
                         (jfa._bwd_fused, tfa._bwd_fused)):
        for got, want, name in zip(timpl(*targs), jimpl(*jargs), "qkv"):
            _close(got, want, GRAD, f"{timpl.__name__} d{name}")


def _jax_value_and_grads(q, k, v, w, causal, window):
    @jax.jit
    def f(q, k, v):
        def loss(q, k, v):
            o = jfa.flash_attention(q, k, v, causal=causal, window=window,
                                    block_q=BLOCK, block_k=BLOCK)
            return jnp.sum(o * w), o

        return jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            q, k, v)

    (_, o), grads = f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return o, grads


@pytest.mark.parametrize("causal,window,hkv", CASES)
def test_flash_attention_values_and_grads(causal, window, hkv):
    """flash_attention's output and the grads of sum(o * w), both
    backwards of the port against jax.grad of the reference."""
    q, k, v, w = _arrays([(B, L, H, D), (B, L, hkv, D), (B, L, hkv, D),
                          (B, L, H, D)], seed=3 + hkv)
    jo, jg = _jax_value_and_grads(q, k, v, w, causal, window)
    for impl in ("split", "fused"):
        tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        o = tfa.flash_attention(tq, tk, tv, causal=causal, window=window,
                                bwd_impl=impl)
        _close(o, jo, OUT, f"{impl} o")
        tg = torch.autograd.grad((o * torch.as_tensor(w)).sum(),
                                 (tq, tk, tv))
        for got, want, name in zip(tg, jg, "qkv"):
            _close(got, want, GRAD, f"{impl} d{name}")


def test_prime_length():
    """L = 37 (prime): the reference takes it in one block, the port's
    plain version whole; the CUDA kernels mask the ragged tail tile."""
    Lp = 37
    q, k, v, w = _arrays([(2, Lp, 2, 8), (2, Lp, 1, 8), (2, Lp, 1, 8),
                          (2, Lp, 2, 8)], seed=0)
    jo, jg = _jax_value_and_grads(q, k, v, w, True, None)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=True)
    _close(o, jo, OUT, "o")
    tg = torch.autograd.grad((o * torch.as_tensor(w)).sum(), (tq, tk, tv))
    for got, want, name in zip(tg, jg, "qkv"):
        _close(got, want, GRAD, f"d{name}")


def test_bfloat16_inputs_keep_their_type():
    """bf16 q, k, v: o and the grads come back in bf16 and match the
    reference within 3e-2 (the JAX package's bf16 bound)."""
    q, k, v = _arrays([(1, L, 2, D)] * 3, seed=5)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jo = jfa.flash_attention(jq, jk, jv, causal=True, block_q=BLOCK,
                             block_k=BLOCK)
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16).requires_grad_()
                  for a in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=True)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.detach().float().numpy(),
                               np.asarray(jo, np.float32), atol=3e-2,
                               rtol=3e-2)
    grads = torch.autograd.grad(o.float().sum(), (tq, tk, tv))
    assert all(gr.dtype == torch.bfloat16 for gr in grads)


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_errors_are_the_reference_errors(monkeypatch):
    """The same ValueError messages as the reference for a head count
    that does not divide, a window below 1 and an unknown bwd_impl; the
    default scale is D ** -0.5; "auto" is the split backward."""
    z = np.zeros((1, 16, 3, 8), np.float32)
    z2 = np.zeros((1, 16, 2, 8), np.float32)
    for kw, kv in (({}, z2), ({"window": 0}, z), ({"bwd_impl": "nope"}, z)):
        want = _message(lambda: jfa.flash_attention(
            jnp.asarray(z), jnp.asarray(kv), jnp.asarray(kv), **kw))
        got = _message(lambda: tfa.flash_attention(
            torch.as_tensor(z), torch.as_tensor(kv), torch.as_tensor(kv),
            **kw))
        assert got == want
    q, k, v = (torch.as_tensor(a) for a in _arrays([(1, 16, 2, 8)] * 3, 9))
    torch.testing.assert_close(
        tfa.flash_attention(q, k, v, causal=True),
        tfa.flash_attention(q, k, v, causal=True, scale=8 ** -0.5))
    calls = []
    split = tfa._bwd
    monkeypatch.setattr(tfa, "_bwd",
                        lambda *a: calls.append("split") or split(*a))
    q.requires_grad_()
    tfa.flash_attention(q, k, v, causal=True).sum().backward()
    assert calls == ["split"]


def test_cpu_route_launches_no_kernel():
    """On CPU tensors the wrappers run the plain versions and count no
    launch."""
    before = dict(tfa.LAUNCHES)
    q = torch.randn(1, 16, 2, 8, requires_grad=True)
    o = tfa.flash_attention(q, q, q, causal=True, bwd_impl="fused")
    o.sum().backward()
    assert tfa.LAUNCHES == before
