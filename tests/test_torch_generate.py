"""The port's positional-cache generation (``generate_dense``,
``decode_step_dense`` in mpistragglers_jl_tpu_torch/models/decode.py)
against the JAX package's, JAX on the CPU, on the same numpy weights
and prompts.

``WIDE`` has head_dim 128, so at B >= 4 (or with the kernel forced) the
JAX side routes its int8 decode kernel in Pallas interpret mode and the
port routes the same calls to K5's wrapper, which on the CPU runs the
plain version. Greedy tokens must be identical; float32 logits agree
within 1e-4 absolute (different summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.models import decode as jd
from mpistragglers_jl_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    init_params as jax_init_params,
)
from mpistragglers_jl_tpu_torch.models import decode as td
from mpistragglers_jl_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)
from mpistragglers_jl_tpu_torch.ops import decode_attention as da

SMALL = dict(vocab=61, d_model=64, n_heads=8, n_kv_heads=2, n_layers=2,
             d_ff=128)
WIDE = dict(vocab=97, d_model=256, n_heads=2, n_kv_heads=1, n_layers=2,
            d_ff=256)
K5 = "quantized_decode_attention"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once, and timing-sensitive tests elsewhere share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(fields, seed):
    jcfg = JaxConfig(**fields, dtype=jnp.float32)
    tcfg = TransformerConfig(**fields, dtype=torch.float32)
    return jcfg, tcfg, jax_init_params(jcfg, seed), init_params(
        tcfg, seed, device="cpu")


def _prompt(vocab, B, Tp, seed):
    return np.random.default_rng(seed).integers(
        1, vocab, (B, Tp)).astype(np.int32)


@pytest.mark.parametrize("fields,B,Tp,n_new,eos", [
    (SMALL, 1, 5, 12, None),
    (dict(SMALL, attn_window=6), 2, 9, 10, 7),
    (WIDE, 1, 7, 8, None),  # AUTO below KERNEL_MIN_BATCH: einsum
    (dict(WIDE, attn_window=5), 4, 7, 8, None),  # AUTO at B=4: K5
])
@pytest.mark.parametrize("quantize_kv", [False, True])
def test_generate_dense_tokens_match_jax(fields, B, Tp, n_new, eos,
                                         quantize_kv):
    jcfg, tcfg, jp, tp = _pair(fields, seed=11)
    prompt = _prompt(fields["vocab"], B, Tp, seed=Tp + B)
    want = jd.generate_dense(jp, jnp.asarray(prompt), n_new, jcfg,
                             eos_id=eos, quantize_kv=quantize_kv)
    da.LAUNCHES[K5] = 0
    got = td.generate_dense(tp, prompt, n_new, tcfg, eos_id=eos,
                            quantize_kv=quantize_kv, device="cpu")
    assert da.LAUNCHES[K5] == 0  # the CPU runs the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("toggle,B", [(True, 1), (False, 4)])
def test_generate_dense_forced_routes_match_jax(toggle, B):
    """use_decode_kernel(True) at B=1 (the JAX side interprets its
    kernel) and use_decode_kernel(False) at B=4 (einsum on both)."""
    jcfg, tcfg, jp, tp = _pair(WIDE, seed=12)
    prompt = _prompt(WIDE["vocab"], B, 6, seed=B)
    jd.use_decode_kernel(toggle)
    td.use_decode_kernel(toggle)
    try:
        want = jd.generate_dense(jp, jnp.asarray(prompt), 7, jcfg,
                                 max_len=20, quantize_kv=True)
        got = td.generate_dense(tp, prompt, 7, tcfg, max_len=20,
                                quantize_kv=True, device="cpu")
    finally:
        jd.use_decode_kernel(None)
        td.use_decode_kernel(None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_decode_step_dense_logits_match_jax(quantize_kv):
    """Prefill, then two decode steps on the positional cache at B=4
    (int8: the JAX kernel interpreted, the port's plain version):
    whole-model logits within 1e-4 (f32)."""
    jcfg, tcfg, jp, tp = _pair(dict(WIDE, attn_window=6), seed=13)
    prompt = _prompt(WIDE["vocab"], 4, 9, seed=14)
    jc = jd.init_cache(jcfg, 4, 16, quantize_kv=quantize_kv)
    tc = td.init_cache(tcfg, 4, 16, quantize_kv=quantize_kv, device="cpu")
    jl, jc = jd.prefill_dense(jp, jnp.asarray(prompt), jc, jcfg)
    _, tc = td.prefill_dense(tp, torch.as_tensor(prompt), tc, tcfg)
    tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)
    for pos in (9, 10):
        jlg, jc = jd.decode_step_dense(jp, jnp.asarray(tok), jc,
                                       jnp.int32(pos), jcfg)
        tlg, tc = td.decode_step_dense(tp, torch.as_tensor(tok), tc, pos,
                                       tcfg)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=0,
                                   atol=1e-4)
        tok = np.argmax(np.asarray(jlg), -1).astype(np.int32)


def test_generate_dense_errors_match_jax():
    jcfg, tcfg, jp, tp = _pair(SMALL, seed=0)
    prompt = _prompt(SMALL["vocab"], 1, 4, seed=0)
    for mod, p, c, kw in ((jd, jp, jcfg, {}), (td, tp, tcfg,
                                               {"device": "cpu"})):
        with pytest.raises(ValueError, match="n_new must be >= 1"):
            mod.generate_dense(p, prompt, 0, c, **kw)
        with pytest.raises(ValueError, match="max_len 7 < prompt 4"):
            mod.generate_dense(p, prompt, 4, c, max_len=7, **kw)
    # sampling is ported: the reference's key checks, in both packages
    from mpistragglers_jl_tpu_torch.utils import prng

    for mod, p, c, kw, key in ((jd, jp, jcfg, {}, jax.random.key(0)),
                               (td, tp, tcfg, {"device": "cpu"},
                                prng.key(0))):
        with pytest.raises(ValueError, match="needs a"):
            mod.generate_dense(p, prompt, 2, c, temperature=0.5, **kw)
        with pytest.raises(ValueError, match="only meaningful"):
            mod.generate_dense(p, prompt, 2, c, key=key, **kw)


def test_decode_step_past_the_cache_raises():
    """The reference clamps a write past max_len into the last slot;
    the port raises."""
    tcfg = TransformerConfig(**SMALL)
    tp = init_params(tcfg, 0, device="cpu")
    c = td.init_cache(tcfg, 1, 5, device="cpu")
    with pytest.raises(ValueError, match="does not fit the cache"):
        td.decode_step_dense(tp, torch.tensor([3]), c, 5, tcfg)


def test_generate_dense_equals_teacher_forced_argmax():
    """Within the port: the fp-cache stream is the argmax of the dense
    forward teacher-forced on prompt + stream, with and without flash
    prefill (K1's plain version on the CPU)."""
    import dataclasses

    from mpistragglers_jl_tpu_torch.models.transformer import forward_dense

    tcfg = TransformerConfig(**WIDE)
    tp = init_params(tcfg, 3, device="cpu")
    prompt = torch.as_tensor(_prompt(WIDE["vocab"], 2, 8, seed=3))
    flash = dataclasses.replace(tcfg, attn="ulysses", attn_impl="flash")
    got = td.generate_dense(tp, prompt, 6, tcfg, device="cpu")
    assert torch.equal(td.generate_dense(tp, prompt, 6, flash,
                                         device="cpu"), got)
    full = torch.cat([prompt, got[:, :-1].long()], dim=1)
    with torch.no_grad():
        want = forward_dense(tp, full, tcfg)[:, 7:].argmax(-1)
    assert torch.equal(got.long(), want)
