"""The port's speculative decoding (mpistragglers_jl_tpu_torch/models/
speculative.py) against the JAX package's ``generate_speculative_dense``
on the same numpy weights and prompts, JAX on the CPU, both drafters:
the token streams and the verify-forward counts must be identical, and
the streams must equal the port's own ``generate_dense`` (speculation
is exact greedy). The reference's argument errors are kept.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.models.speculative import (
    _bigram_draft as jax_bigram_draft,
    generate_speculative_dense as jax_spec,
)
from mpistragglers_jl_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    init_params as jax_init_params,
)
from mpistragglers_jl_tpu_torch.models import speculative as ts
from mpistragglers_jl_tpu_torch.models.decode import generate_dense
from mpistragglers_jl_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)

# tests/test_speculative.py's CFG
FIELDS = dict(vocab=61, d_model=48, n_heads=4, n_layers=2, d_ff=96)
CFG = TransformerConfig(**FIELDS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once, and timing-sensitive tests elsewhere share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompt(L, seed):
    return np.random.default_rng(seed).integers(
        0, FIELDS["vocab"], (1, L)).astype(np.int32)


def _both(prompt, n_new, k, draft_layers, seed):
    jcfg = JaxConfig(**FIELDS)
    want, want_fwd = jax_spec(jax_init_params(jcfg, seed),
                              jnp.asarray(prompt), n_new, jcfg, k=k,
                              draft_layers=draft_layers)
    params = init_params(CFG, seed, device="cpu")
    got, fwd = ts.generate_speculative_dense(
        params, prompt, n_new, CFG, k=k, draft_layers=draft_layers,
        device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert fwd == want_fwd
    greedy = generate_dense(params, prompt, n_new, CFG, device="cpu")
    np.testing.assert_array_equal(got.numpy(), greedy.numpy())
    return fwd


@pytest.mark.parametrize("draft_layers", [None, 1])
@pytest.mark.parametrize("Tp,n_new,k", [(8, 17, 4), (3, 5, 1), (12, 30, 3)])
def test_random_prompt_matches_jax(Tp, n_new, k, draft_layers):
    fwd = _both(_prompt(Tp, seed=Tp * 31 + k), n_new, k, draft_layers,
                seed=1)
    assert 0 < fwd <= n_new - 1


@pytest.mark.parametrize("draft_layers", [None, 1])
def test_repetitive_prompt_matches_jax_and_accepts(draft_layers):
    """A period-6 prompt: drafts accept, so fewer verify forwards than
    decoded tokens, the same count as the reference."""
    prompt = np.tile(_prompt(6, seed=9), (1, 4))
    fwd = _both(prompt, 24, 4, draft_layers, seed=2)
    assert fwd < 23


def test_n_new_one_needs_no_verify_forward():
    assert _both(_prompt(5, seed=4), 1, 4, None, seed=3) == 0


def test_bigram_draft_matches_jax():
    """Lookup semantics on buffers with and without an earlier bigram,
    at several cursors."""
    rng = np.random.default_rng(5)
    for buf in ([5, 7, 1, 2, 3, 5, 7, 9, 0, 0, 0, 0],
                [1, 2, 3, 4, 5, 0, 0, 0, 0, 0, 0, 0],
                rng.integers(0, 3, 12).tolist()):
        b = np.asarray(buf, np.int32)
        for cursor in range(3, 8):
            want = jax_bigram_draft(jnp.asarray(b), jnp.int32(cursor), 3)
            got = ts._bigram_draft(torch.as_tensor(b).long(), cursor, 3)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_model_draft_perfect_acceptance_when_truncation_exact():
    """With the top layer's residual contributions zeroed the 1-layer
    draft computes the full model's logits: every draft is accepted and
    the count collapses to ceil((n_new - 1) / (k + 1))."""
    params = init_params(CFG, seed=1, device="cpu")
    for name in ("wo", "w2", "b2"):
        params["layers"][1][name] = torch.zeros_like(
            params["layers"][1][name])
    prompt = _prompt(8, seed=3)
    got, fwd = ts.generate_speculative_dense(params, prompt, 40, CFG, k=4,
                                             draft_layers=1, device="cpu")
    want = generate_dense(params, prompt, 40, CFG, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert fwd == -(-39 // 5)


def test_errors():
    params = init_params(CFG, seed=0, device="cpu")
    for prompt, n_new, kw, match in (
        (np.zeros((2, 4), np.int32), 4, {}, "B=1"),
        (np.zeros((1, 1), np.int32), 4, {}, "prompt >= 2"),
        (np.zeros((1, 4), np.int32), 0, {}, "n_new"),
        (np.zeros((1, 4), np.int32), 4, {"k": 0}, "draft length"),
        (np.zeros((1, 4), np.int32), 4, {"draft_layers": 2}, "draft_layers"),
        (np.zeros((1, 4), np.int32), 4, {"draft_layers": 0}, "draft_layers"),
    ):
        with pytest.raises(ValueError, match=match):
            ts.generate_speculative_dense(params, prompt, n_new, CFG,
                                          device="cpu", **kw)
    run = ts.make_speculative_dense(CFG, 8, 5, device="cpu")
    with pytest.raises(ValueError, match="made for Tp=8"):
        run(params, _prompt(6, seed=0))
