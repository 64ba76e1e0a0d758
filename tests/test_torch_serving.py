"""The port's continuous-batching scheduler
(mpistragglers_jl_tpu_torch/models/serving.py) against the JAX
package's scheduler and its serving oracle ``generate_ring_dense``, on
the configurations of tests/test_serving.py, JAX on the CPU.

Every comparison is of greedy token streams, which must be identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.models.decode import (
    generate_ring_dense as jax_generate,
)
from mpistragglers_jl_tpu.models.serving import (
    ServingScheduler as JaxScheduler,
    serving_decode_step_dense as jax_step,
)
from mpistragglers_jl_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    init_params as jax_init_params,
)
from mpistragglers_jl_tpu_torch.models import decode as td
from mpistragglers_jl_tpu_torch.models.serving import (
    Request,
    ServingScheduler,
    serving_decode_step_dense,
)
from mpistragglers_jl_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)

SMALL = dict(vocab=61, d_model=64, n_heads=8, n_kv_heads=2, n_layers=2,
             d_ff=128, attn_window=6)
# head_dim 128: at S=4 slots the AUTO gate routes the int8 kernel
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


JCFG, JPARAMS, TCFG, TPARAMS = _models(SMALL, 11)


def _prompts(seed, lens, vocab=SMALL["vocab"]):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]


def _oracle(jparams, jcfg, p, n, quantize_kv, eos_id=None):
    toks = jax_generate(jparams, jnp.asarray(p)[None], n, jcfg,
                        eos_id=eos_id, quantize_kv=quantize_kv)
    out = [int(t) for t in np.asarray(toks)[0]]
    if eos_id is not None and eos_id in out:
        out = out[: out.index(eos_id) + 1]
    return out


def _serve(cls, params, cfg, work, **kw):
    extra = {"device": "cpu"} if cls is ServingScheduler else {}
    sched = cls(params, cfg, **kw, **extra)
    reqs = [sched.submit(p, max_new=n) for p, n in work]
    sched.run()
    assert all(r.finished for r in reqs)
    return sched, [r.tokens for r in reqs]


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_batch_with_slot_reuse_matches_jax_scheduler_and_oracle(
        quantize_kv):
    """More requests than slots, varied prompts and budgets: the extras
    queue, slots are reused, every stream equals both references."""
    work = list(zip(_prompts(1, [3, 11, 8, 1, 20, 6]),
                    [9, 6, 12, 5, 8, 7]))
    kw = dict(slots=2, n_inner=3, prompt_chunk=8, max_prompt=32,
              quantize_kv=quantize_kv)
    sched, got = _serve(ServingScheduler, TPARAMS, TCFG, work, **kw)
    _, want = _serve(JaxScheduler, JPARAMS, JCFG, work, **kw)
    assert got == want
    for (p, n), toks in zip(work, got):
        assert toks == _oracle(JPARAMS, JCFG, p, n, quantize_kv)
    assert not sched.use_kernel  # head_dim 8: the einsum tick


def test_staggered_admission_mid_flight():
    """Requests arriving while others decode reuse freed slots; the
    long-running stream is unperturbed."""
    p_long, p_short, p_a, p_b = _prompts(2, [6, 3, 5, 2])
    sched = ServingScheduler(TPARAMS, TCFG, slots=2, n_inner=2,
                             prompt_chunk=8, max_prompt=32, device="cpu")
    r_long = sched.submit(p_long, max_new=16)
    r_short = sched.submit(p_short, max_new=4)
    late = []
    for _ in range(40):
        sched.step()
        if r_short.finished and not late:
            late = [(sched.submit(p_a, 6), p_a, 6),
                    (sched.submit(p_b, 3), p_b, 3)]
        if r_long.finished and late and all(r.finished for r, _, _ in late):
            break
    assert r_long.tokens == _oracle(JPARAMS, JCFG, p_long, 16, False)
    assert r_short.tokens == _oracle(JPARAMS, JCFG, p_short, 4, False)
    for r, p, n in late:
        assert r.admitted_tick >= r_short.retired_tick
        assert r.tokens == _oracle(JPARAMS, JCFG, p, n, False)


def test_eos_retirement():
    (p,) = _prompts(3, [7])
    eos = _oracle(JPARAMS, JCFG, p, 16, True)[3]
    kw = dict(slots=2, n_inner=4, prompt_chunk=8, max_prompt=32,
              eos_id=eos, quantize_kv=True)
    sched = ServingScheduler(TPARAMS, TCFG, device="cpu", **kw)
    r = sched.submit(p, max_new=16)
    sched.run()
    assert r.finished and r.reason == "eos"
    assert r.tokens == _oracle(JPARAMS, JCFG, p, 16, True, eos_id=eos)
    assert r.tokens[-1] == eos and eos not in r.tokens[:-1]
    _, want = _serve(JaxScheduler, JPARAMS, JCFG, [(p, 16)], **kw)
    assert [r.tokens] == want


def test_quantized_streams_are_chunk_size_invariant():
    work = list(zip(_prompts(4, [11, 4]), [7, 9]))
    streams = [
        _serve(ServingScheduler, TPARAMS, TCFG, work, slots=2, n_inner=3,
               prompt_chunk=c, max_prompt=32, quantize_kv=True)[1]
        for c in (2, 4, 8, 16)
    ]
    assert all(s == streams[0] for s in streams[1:])
    for (p, n), toks in zip(work, streams[0]):
        assert toks == _oracle(JPARAMS, JCFG, p, n, True)


def test_kernel_routed_tick_matches_jax_scheduler_and_oracle():
    """head_dim 128 at S=4: both schedulers route the int8 kernel (the
    port's wrapper runs its plain version on the CPU, JAX its Pallas
    kernel interpreted); streams equal each other and the oracle."""
    jcfg, jparams, tcfg, tparams = _models(WIDE, 31)
    work = list(zip(_prompts(5, [5, 9, 3, 7, 12], WIDE["vocab"]),
                    [8, 6, 10, 7, 5]))
    kw = dict(slots=4, n_inner=3, prompt_chunk=8, max_prompt=32,
              quantize_kv=True)
    sched, got = _serve(ServingScheduler, tparams, tcfg, work, **kw)
    jsched, want = _serve(JaxScheduler, jparams, jcfg, work, **kw)
    assert sched.use_kernel and jsched.use_kernel
    assert got == want
    for (p, n), toks in zip(work, got):
        assert toks == _oracle(jparams, jcfg, p, n, True)


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_prompt_overrunning_the_reference_arena_matches_oracle(
        quantize_kv):
    """prompt_chunk=8, max_prompt=30: the last chunk of a 29- or
    30-token prompt overruns a 30-position arena. The reference clamps
    that write (its streams diverge from its own oracle, ROADMAP.md
    Queue 3), so the port is held against the oracle only; the 24-token
    prompt, which fits, is held against the JAX scheduler too."""
    work = list(zip(_prompts(6, [30, 29, 24]), [6, 6, 6]))
    kw = dict(slots=3, n_inner=2, prompt_chunk=8, max_prompt=30,
              quantize_kv=quantize_kv)
    sched, got = _serve(ServingScheduler, TPARAMS, TCFG, work, **kw)
    assert sched.L_arena == 37  # max_prompt + prompt_chunk - 1
    for (p, n), toks in zip(work, got):
        assert toks == _oracle(JPARAMS, JCFG, p, n, quantize_kv)
    _, want = _serve(JaxScheduler, JPARAMS, JCFG, work[2:], **kw)
    assert got[2:] == want


def test_decode_step_matches_jax_step():
    """One batched per-row step (einsum path) from the same caches and
    positions: logits within 1e-4 (f32)."""
    rng = np.random.default_rng(7)
    S, W = 3, SMALL["attn_window"]
    tok = rng.integers(1, SMALL["vocab"], S).astype(np.int32)
    pos = np.asarray([2, 6, 11], np.int32)
    caches = [{k: (rng.standard_normal((S, W, 2, 8)) * 0.1)
               .astype(np.float32) for k in ("k", "v")}
              for _ in range(SMALL["n_layers"])]
    jl, _ = jax_step(JPARAMS, jnp.asarray(tok), jnp.asarray(pos),
                     [{k: jnp.asarray(v) for k, v in c.items()}
                      for c in caches], JCFG)
    tl, _ = serving_decode_step_dense(
        TPARAMS, torch.as_tensor(tok), torch.as_tensor(pos),
        [{k: torch.as_tensor(v.copy()) for k, v in c.items()}
         for c in caches], TCFG)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)


def test_cancel_and_admission_time_retirement():
    p1, p2, p3 = _prompts(8, [4, 5, 6])
    sched = ServingScheduler(TPARAMS, TCFG, slots=1, n_inner=2,
                             prompt_chunk=8, max_prompt=16, device="cpu")
    r1 = sched.submit(p1, max_new=1)
    r2 = sched.submit(p2, max_new=5)
    r3 = sched.submit(p3, max_new=5)
    assert sched.step() == [r1]  # max_new=1 retires at admission
    assert r1.tokens == _oracle(JPARAMS, JCFG, p1, 1, False)
    assert sched.cancel(r3) and r3.reason == "cancelled"
    assert sched.cancel(r2) and sched.active == 0
    assert not sched.cancel(r2)
    sched.run()
    assert sched.pending == 0


def test_validation_and_later_slices_named():
    sched = ServingScheduler(TPARAMS, TCFG, slots=1, n_inner=1,
                             prompt_chunk=4, max_prompt=8, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_prompt"):
        sched.submit(_prompts(9, [9])[0], max_new=2)
    with pytest.raises(ValueError, match="max_new"):
        Request(np.ones(3, np.int32), 0)
    with pytest.raises(ValueError, match="empty"):
        Request(np.zeros(0, np.int32), 3)
    with pytest.raises(ValueError, match="ring cache"):
        ServingScheduler(TPARAMS, dataclasses.replace(TCFG, attn_window=None),
                         slots=1, device="cpu")
    with pytest.raises(ValueError, match="divide the attention window"):
        ServingScheduler(TPARAMS, TCFG, slots=1, page_tokens=4,
                         device="cpu")  # W=6
    with pytest.raises(ValueError, match="cache_pages without"):
        ServingScheduler(TPARAMS, TCFG, slots=1, cache_pages=8,
                         device="cpu")
    with pytest.raises(ValueError, match="cannot hold even one"):
        ServingScheduler(TPARAMS, TCFG, slots=1, page_tokens=2,
                         cache_pages=3, device="cpu")  # needs W/P + 1 = 4
    paged = ServingScheduler(TPARAMS, TCFG, slots=2, page_tokens=3,
                             device="cpu")
    assert paged.paged and paged.pool.n_pages == 2 * 2 + 1
    assert not sched.paged and sched.pool is None
    # item 10b is ported: cache= needs the paged arena and attaches
    from mpistragglers_jl_tpu_torch.cache import FleetPrefixCache

    hub = FleetPrefixCache(store_pages=2)
    with pytest.raises(ValueError, match="needs the paged arena"):
        ServingScheduler(TPARAMS, TCFG, slots=1, device="cpu", cache=hub)
    fleet = ServingScheduler(TPARAMS, TCFG, slots=1, page_tokens=2,
                             device="cpu", cache=hub)
    assert hub.members() == [fleet.cache_name]
    hub.close()
    # items 8, 9 and 10a are ported: sampling, the observability
    # arguments and qos= construct (their behaviour:
    # test_torch_sampling.py, test_torch_obs.py, test_torch_qos.py)
    from mpistragglers_jl_tpu_torch.obs import MetricsRegistry, TraceBook
    from mpistragglers_jl_tpu_torch.qos import TenantContract, TenantRegistry

    for kw in ({"registry": MetricsRegistry()}, {"trace": TraceBook()},
               {"temperature": 0.5},
               {"qos": TenantRegistry([TenantContract("a")])}):
        ServingScheduler(TPARAMS, TCFG, slots=1, device="cpu", **kw)
    with pytest.raises(ValueError, match="greedy scheduler"):
        sched.submit(np.ones(3, np.int32), 2, key=np.zeros(2, np.uint32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingScheduler(TPARAMS, TCFG, slots=1)


def test_use_decode_kernel_toggle_resolves_at_construction():
    jcfg, jparams, tcfg, tparams = _models(WIDE, 3)
    try:
        td.use_decode_kernel(False)
        off = ServingScheduler(tparams, tcfg, slots=4, quantize_kv=True,
                               max_prompt=16, prompt_chunk=8, device="cpu")
    finally:
        td.use_decode_kernel(None)
    on = ServingScheduler(tparams, tcfg, slots=4, quantize_kv=True,
                          max_prompt=16, prompt_chunk=8, device="cpu")
    small = ServingScheduler(tparams, tcfg, slots=2, quantize_kv=True,
                             max_prompt=16, prompt_chunk=8, device="cpu")
    assert (off.use_kernel, on.use_kernel, small.use_kernel) == (
        False, True, False)
