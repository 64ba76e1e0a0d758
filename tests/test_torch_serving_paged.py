"""The port's paged serving scheduler (``ServingScheduler(page_tokens=)``
in mpistragglers_jl_tpu_torch/models/serving.py) against the JAX
package's paged scheduler and its oracle ``generate_ring_dense``, on
the configurations of tests/test_serving_paged.py, JAX on the CPU.

Greedy streams must be identical, and so must the pools' share hits,
copy-on-write copies and drained state. On the CPU the port's paged
kernel route runs the plain version of the kernel; the JAX side runs
its Pallas kernel interpreted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.models.decode import (
    generate_ring_dense as jax_generate,
)
from mpistragglers_jl_tpu.models.serving import (
    ServingScheduler as JaxScheduler,
)
from mpistragglers_jl_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    init_params as jax_init_params,
)
from mpistragglers_jl_tpu_torch.models import decode as td
from mpistragglers_jl_tpu_torch.models.serving import ServingScheduler
from mpistragglers_jl_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)
from mpistragglers_jl_tpu_torch.ops import decode_attention as da

SMALL = dict(vocab=61, d_model=64, n_heads=8, n_kv_heads=2, n_layers=2,
             d_ff=128, attn_window=6)
# head_dim 128, W=128: the paged int8 kernel routes at S >= 4
WIDE = dict(vocab=97, d_model=256, n_heads=2, n_kv_heads=1, n_layers=2,
            d_ff=256, attn_window=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once, and timing-sensitive tests elsewhere share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(fields, seed):
    jcfg, tcfg = JaxConfig(**fields), TransformerConfig(**fields)
    return (jcfg, jax_init_params(jcfg, seed), tcfg,
            init_params(tcfg, seed, device="cpu"))


S_MODELS = _models(SMALL, 11)
W_MODELS = _models(WIDE, 31)


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]


def _oracle(models, p, n, quantize_kv=False, eos_id=None):
    jcfg, jparams = models[0], models[1]
    toks = jax_generate(jparams, jnp.asarray(p)[None], n, jcfg,
                        eos_id=eos_id, quantize_kv=quantize_kv)
    out = [int(t) for t in np.asarray(toks)[0]]
    if eos_id is not None and eos_id in out:
        out = out[: out.index(eos_id) + 1]
    return out


def _both(models, **kw):
    jcfg, jparams, tcfg, tparams = models
    return (ServingScheduler(tparams, tcfg, device="cpu", **kw),
            JaxScheduler(jparams, jcfg, **kw))


def _drained(sched):
    sched.pool.check()
    assert sched.pool.used == 0 and sched.pool.reserved == 0


def _serve_both(models, work, **kw):
    """Run ``work`` [(prompt, max_new)] through both schedulers; the
    streams, share hits and COW copies must agree and both pools
    drain. Returns the port's scheduler and streams."""
    out = []
    for sched in _both(models, **kw):
        reqs = [sched.submit(p, max_new=n) for p, n in work]
        sched.run()
        assert all(r.finished for r in reqs)
        _drained(sched)
        out.append((sched, [r.tokens for r in reqs]))
    (t, got), (j, want) = out
    assert got == want
    assert (t.pool.share_hits, t.pool.cow_copies) == (
        j.pool.share_hits, j.pool.cow_copies)
    return t, got


@pytest.mark.parametrize("page_tokens", [2, 3, 6])
def test_paged_churn_matches_jax_scheduler_and_oracle(page_tokens):
    """tests/test_serving_paged.py's churn schedule: more requests than
    slots, slot reuse, wrap, varied budgets, every page size dividing
    the window."""
    work = list(zip(_prompts(1, [3, 11, 8, 1, 20, 6, 15, 9], 61),
                    [9, 6, 17, 5, 8, 12, 4, 10]))
    sched, got = _serve_both(S_MODELS, work, slots=3, n_inner=4,
                             prompt_chunk=8, max_prompt=64,
                             page_tokens=page_tokens)
    assert not sched.use_kernel
    for (p, n), toks in zip(work, got):
        assert toks == _oracle(S_MODELS, p, n)


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_shared_prefix_divergence_cow_matches_jax_and_oracle(quantize_kv):
    """Two prompts sharing a page-aligned prefix that diverge after it;
    both wrap the window, so the shared pages are copied before they
    are written, and both streams still equal their oracles."""
    sys_prompt, a, b = _prompts(2, [4, 2, 2], 61)
    work = [(np.concatenate([sys_prompt, a]), 14),
            (np.concatenate([sys_prompt, b]), 14)]
    sched, got = _serve_both(S_MODELS, work, slots=2, n_inner=3,
                             prompt_chunk=8, max_prompt=64, page_tokens=2,
                             quantize_kv=quantize_kv)
    assert sched.pool.share_hits > 0 and sched.pool.cow_copies > 0
    for (p, n), toks in zip(work, got):
        assert toks == _oracle(S_MODELS, p, n, quantize_kv)


def test_prefix_share_skips_prefill():
    """The second of two identical 40-token prompts at P=16 shares 2
    pages (the last token always prefills) and runs one 8-token chunk
    instead of five."""
    (p,) = _prompts(3, [40], 97)
    scheds = _both(W_MODELS, slots=2, n_inner=2, prompt_chunk=8,
                   max_prompt=64, page_tokens=16)
    streams = []
    for sched in scheds:
        r1 = sched.submit(p, max_new=8)
        while not r1.tokens:
            sched.step()
        r2 = sched.submit(p, max_new=8)
        sched.run()
        _drained(sched)
        assert sched.pool.share_hits == 2
        streams.append([r1.tokens, r2.tokens])
    assert scheds[0].prefill_chunks == 5 + 1
    assert streams[0] == streams[1] == [_oracle(W_MODELS, p, 8)] * 2


def test_page_capacity_defers_admission_fifo():
    """A pool that holds one request at a time: admission waits for
    pages (FIFO), every request still serves exactly, nothing leaks."""
    work = [(p, 4 + i) for i, p in
            enumerate(_prompts(4, [3, 4, 5, 6], 61))]
    sched, got = _serve_both(S_MODELS, work, slots=3, n_inner=2,
                             prompt_chunk=8, max_prompt=32, page_tokens=2,
                             cache_pages=5)
    assert [len(t) for t in got] == [4, 5, 6, 7]
    sched = ServingScheduler(S_MODELS[3], S_MODELS[2], slots=3, n_inner=2,
                             prompt_chunk=8, max_prompt=32, page_tokens=2,
                             cache_pages=5, device="cpu")
    reqs = [sched.submit(p, max_new=n) for p, n in work]
    sched.step()
    assert sched.active == 1 and sched.pending == 3  # pages, not slots
    sched.run()
    ticks = [r.admitted_tick for r in reqs]
    assert ticks == sorted(ticks)


@pytest.mark.parametrize("page_tokens", [16, 64])
@pytest.mark.parametrize("quantize_kv", [False, True])
def test_wide_page_sizes_and_kernel_route_match_jax_and_oracle(
        page_tokens, quantize_kv):
    """P in {16, 64} at head_dim 128 under slot reuse. With int8 at S=4
    both schedulers route their paged kernel (the port's plain version
    here, JAX's interpreted Pallas kernel)."""
    work = list(zip(_prompts(5, [5, 9, 3, 7, 12], 97), [8, 6, 10, 7, 5]))
    kw = dict(slots=4, n_inner=3, prompt_chunk=8, max_prompt=32,
              quantize_kv=quantize_kv, page_tokens=page_tokens)
    sched, got = _serve_both(W_MODELS, work, **kw)
    assert sched.use_kernel == quantize_kv
    for (p, n), toks in zip(work, got):
        assert toks == _oracle(W_MODELS, p, n, quantize_kv)


def test_kernel_route_equals_einsum_route_and_counts_nothing_on_cpu():
    """The same paged int8 work through the kernel route and the
    gather route (``use_decode_kernel(False)``) gives the same streams;
    on the CPU the kernel route runs the plain version, so no launch is
    counted."""
    jcfg, jparams, tcfg, tparams = W_MODELS
    work = list(zip(_prompts(6, [30, 9, 30, 4, 17], 97), [40, 6, 30, 9, 5]))
    streams = []
    for toggle in (None, False):
        td.use_decode_kernel(toggle)
        try:
            sched = ServingScheduler(tparams, tcfg, slots=4, n_inner=4,
                                     prompt_chunk=16, max_prompt=32,
                                     quantize_kv=True, page_tokens=16,
                                     device="cpu")
        finally:
            td.use_decode_kernel(None)
        assert sched.use_kernel == (toggle is None)
        before = dict(da.LAUNCHES)
        reqs = [sched.submit(p, max_new=n) for p, n in work]
        sched.run()
        assert da.LAUNCHES == before
        _drained(sched)
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_sharing_admission_past_the_arena_matches_oracle(quantize_kv):
    """The reference's clamp fault on the paged path (ROADMAP.md Queue
    3): P=16, prompt_chunk=40, max_prompt=40. The sharer starts its one
    chunk at base 32, which ends at 72, past a 40-position arena. The
    port's arena holds 79 and its install never writes shared pages:
    both streams equal the oracle, and the first request's stream is
    the one it has when served alone."""
    tcfg, tparams = W_MODELS[2], W_MODELS[3]
    (p,) = _prompts(7, [40], 97)
    kw = dict(slots=2, n_inner=2, prompt_chunk=40, max_prompt=40,
              quantize_kv=quantize_kv, page_tokens=16, device="cpu")
    alone = ServingScheduler(tparams, tcfg, **kw)
    r0 = alone.submit(p, max_new=8)
    alone.run()
    sched = ServingScheduler(tparams, tcfg, **kw)
    assert sched.L_arena == 79
    r1 = sched.submit(p, max_new=8)
    while not r1.tokens:
        sched.step()
    r2 = sched.submit(p, max_new=8)
    sched.run()
    _drained(sched)
    assert sched.pool.share_hits == 2
    want = _oracle(W_MODELS, p, 8, quantize_kv=quantize_kv)
    assert r0.tokens == r1.tokens == r2.tokens == want


def test_paged_eos_retirement_returns_pages():
    (p,) = _prompts(8, [7], 61)
    eos = _oracle(S_MODELS, p, 16)[3]
    sched, got = _serve_both(S_MODELS, [(p, 16)], slots=2, n_inner=4,
                             prompt_chunk=8, max_prompt=32, eos_id=eos,
                             page_tokens=2)
    assert got == [_oracle(S_MODELS, p, 16, eos_id=eos)]


def test_paged_cancel_at_every_stage_returns_pages():
    """Cancel while queued, while decoding on a shared prefix, and
    mid-admission (the plan's pages): the pool drains and the
    survivor's stream is its oracle."""
    tcfg, tparams = W_MODELS[2], W_MODELS[3]
    sys_prompt, a, b, c = _prompts(9, [32, 5, 40, 7], 97)
    sched = ServingScheduler(tparams, tcfg, slots=2, n_inner=2,
                             prompt_chunk=8, max_prompt=64, page_tokens=16,
                             device="cpu")
    p_keep = np.concatenate([sys_prompt, a])
    keep = sched.submit(p_keep, max_new=10)
    while not keep.tokens:
        sched.step()
    sharer = sched.submit(np.concatenate([sys_prompt, c]), max_new=10)
    long_ = sched.submit(b, max_new=4)
    queued = sched.submit(c, max_new=3)
    sched.step()
    assert sched.pool.share_hits == 2 and sharer.tokens
    assert sched.cancel(queued) and sched.cancel(sharer)
    sched.step()
    assert long_.admitted_tick is not None and not long_.tokens
    assert sched.cancel(long_)
    assert not sched.cancel(long_)
    sched.run()
    _drained(sched)
    assert keep.tokens == _oracle(W_MODELS, p_keep, 10)
