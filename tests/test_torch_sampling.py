"""Sampled generation and serving of the port against the JAX package,
token for token, JAX on the CPU, on the same numpy weights, prompts and
key data.

The port's generator (``utils/prng.py``) is bit-equal to
``jax.random``, so a sampled stream is the reference's exactly; what
can still differ is a draw whose winner and runner-up (Gumbel noise
plus scaled logits) lie closer than the two frameworks' f32 logits do.
Every draw the port makes is recorded by (key, position, row) with
that top-two margin. A stream that differs is skipped, and counted,
only when one of its own draws had a margin under ``TIE`` (the tie
filter of the MoE routing tests); any other difference fails. Each
test prints how many streams it skipped and allows at most one.

``ops/sampling.py`` ``sample_rows`` runs its plain version here (CPU
tensors); ``tests/test_torch_gpu.py`` holds its kernel to it.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.models import decode as jd
from mpistragglers_jl_tpu.models import serving as js
from mpistragglers_jl_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    init_params as jax_init_params,
)
from mpistragglers_jl_tpu_torch.models import decode as td
from mpistragglers_jl_tpu_torch.models import serving as ts
from mpistragglers_jl_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)
from mpistragglers_jl_tpu_torch.ops import sampling
from mpistragglers_jl_tpu_torch.utils import prng

FIELDS = dict(vocab=61, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
              d_ff=128, attn_window=16)
TEMP = 0.7
TIE = 1e-5  # least top-two margin of a draw the parity holds exactly
PROMPT_LENS = (5, 12, 20, 3, 9)
MAX_NEW = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(**FIELDS, dtype=jnp.float32)
    tcfg = TransformerConfig(**FIELDS, dtype=torch.float32)
    return jcfg, jax_init_params(jcfg, 0), tcfg, init_params(tcfg, 0,
                                                              device="cpu")


class _Draws:
    """Records the top-two margin of every draw ``sample_rows`` makes,
    by (key word 0, key word 1, position, row)."""

    def __init__(self):
        self.margin: dict[tuple, float] = {}

    def __call__(self, logits, pos, keys, rows, temperature, top_k=None):
        t = torch.tensor(temperature, dtype=torch.float32)
        lg = logits.float() / t
        if top_k is not None:
            kth = torch.topk(lg, int(top_k), dim=-1).values[:, -1:]
            lg = torch.where(lg < kth, float("-inf"), lg)
        k = prng.fold_in(prng.fold_in(keys, pos), rows)
        v = prng.gumbel(k, (lg.shape[1],)) + lg
        top2 = torch.topk(v, 2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        for r, gap in enumerate(gaps):
            tag = (int(keys[r, 0]), int(keys[r, 1]), int(pos[r]),
                   int(rows[r]))
            self.margin[tag] = min(gap, self.margin.get(tag, np.inf))
        return sampling.sample_rows(logits, pos, keys, rows, temperature,
                                    top_k)

    def near_tie(self, key, first_pos, n, row) -> bool:
        """Did a draw of the stream of ``key`` from ``first_pos`` (n
        tokens, batch row ``row``) come within TIE?"""
        k0, k1 = (int(w) for w in prng.key_data(key))
        return any(self.margin.get((k0, k1, first_pos + i, row), np.inf)
                   < TIE for i in range(n))


@pytest.fixture
def draws(monkeypatch):
    rec = _Draws()
    monkeypatch.setattr(td, "sample_rows", rec)
    return rec


def _check_streams(pairs, draws, what):
    """``pairs``: (got, want, key, first_pos, row) per stream. Equal,
    or skipped (counted) where a draw of the stream was a near tie."""
    skipped = 0
    for got, want, key, first_pos, row in pairs:
        got, want = list(got), list(want)
        if got == want:
            continue
        assert draws.near_tie(key, first_pos, len(want), row), (
            f"{what}: stream differs with every draw's margin >= {TIE}: "
            f"{got} != {want}")
        skipped += 1
    print(f"{what}: {len(pairs)} streams, {skipped} skipped by the "
          f"{TIE} tie filter")
    assert skipped <= 1, f"{what}: {skipped} streams skipped"
    return skipped


def _prompts(B, Tp, seed):
    return np.random.default_rng(seed).integers(
        1, FIELDS["vocab"], (B, Tp)).astype(np.int32)


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("quantize_kv", [False, True])
@pytest.mark.parametrize("top_k", [None, 1, 5])
def test_generate_streams_equal_jax(models, draws, ring, quantize_kv,
                                    top_k):
    """B=2, so every draw also folds its batch row."""
    jcfg, jp, tcfg, tp = models
    prompt = _prompts(2, 7, seed=3)
    seed = 1234
    jfn, tfn = ((jd.generate_ring_dense, td.generate_ring_dense) if ring
                else (jd.generate_dense, td.generate_dense))
    want = np.asarray(jfn(jp, jnp.asarray(prompt), MAX_NEW, jcfg,
                          temperature=TEMP, top_k=top_k,
                          key=jax.random.key(seed),
                          quantize_kv=quantize_kv))
    got = tfn(tp, prompt, MAX_NEW, tcfg, temperature=TEMP, top_k=top_k,
              key=prng.key(seed), quantize_kv=quantize_kv, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, MAX_NEW)
    _check_streams([(got[b].tolist(), want[b].tolist(), prng.key(seed),
                     prompt.shape[1] - 1, b) for b in range(2)], draws,
                   f"generate ring={ring} int8={quantize_kv} top_k={top_k}")


def test_top_k_one_is_greedy(models):
    _, _, tcfg, tp = models
    prompt = _prompts(2, 7, seed=4)
    for q in (False, True):
        greedy = td.generate_dense(tp, prompt, MAX_NEW, tcfg,
                                   quantize_kv=q, device="cpu")
        sampled = td.generate_dense(tp, prompt, MAX_NEW, tcfg,
                                    temperature=TEMP, top_k=1,
                                    key=prng.key(9), quantize_kv=q,
                                    device="cpu")
        torch.testing.assert_close(sampled, greedy, rtol=0, atol=0)


def _serve(sched_cls, params, cfg, submit_keys, paged, quantize_kv, top_k,
           **kw):
    sched = sched_cls(params, cfg, slots=2, n_inner=4, prompt_chunk=8,
                      max_prompt=32, quantize_kv=quantize_kv,
                      temperature=TEMP, top_k=top_k, page_tokens=paged,
                      **kw)
    rng = np.random.default_rng(0)
    reqs = [sched.submit(rng.integers(1, FIELDS["vocab"], n), MAX_NEW,
                         **({} if k is None else {"key": k}))
            for n, k in zip(PROMPT_LENS, submit_keys)]
    sched.run()
    return reqs


@pytest.mark.parametrize("paged", [None, 4])
@pytest.mark.parametrize("quantize_kv", [False, True])
@pytest.mark.parametrize("explicit", [True, False])
@pytest.mark.parametrize("top_k", [None, 5])
def test_scheduler_streams_equal_jax(models, draws, monkeypatch, paged,
                                     quantize_kv, explicit, top_k):
    """Slot ring and paged (pages of 4, prompts sharing nothing), fp and
    int8, keys handed over as uint32 key data or derived from the
    request id (both packages' ids start at 0 here)."""
    jcfg, jp, tcfg, tp = models
    data = [np.asarray(jax.random.key_data(jax.random.key(100 + i)))
            for i in range(len(PROMPT_LENS))]
    monkeypatch.setattr(js.Request, "_next_id", 0)
    monkeypatch.setattr(ts.Request, "_next_id", 0)
    jr = _serve(js.ServingScheduler, jp, jcfg,
                [jax.random.wrap_key_data(d) for d in data] if explicit
                else [None] * len(data), paged, quantize_kv, top_k)
    tr = _serve(ts.ServingScheduler, tp, tcfg,
                [prng.wrap_key_data(d) for d in data] if explicit
                else [None] * len(data), paged, quantize_kv, top_k,
                device="cpu")
    assert [r.id for r in tr] == [r.id for r in jr]
    keys = ([prng.wrap_key_data(d) for d in data] if explicit
            else [prng.key(r.id + 1) for r in tr])
    assert all(r.finished and len(r.tokens) == MAX_NEW for r in tr)
    _check_streams([(t.tokens, j.tokens, k, t.prompt.size - 1, 0)
                    for t, j, k in zip(tr, jr, keys)], draws,
                   f"scheduler paged={paged} int8={quantize_kv} "
                   f"explicit={explicit} top_k={top_k}")


@pytest.mark.parametrize("paged", [None, 4])
def test_scheduler_stream_equals_the_ports_oracle(models, draws, paged):
    """A slot's sampled stream is ``generate_ring_dense`` with its
    request's key (int8: the oracle identity of greedy serving)."""
    _, _, tcfg, tp = models
    keys = [prng.key(7 + i) for i in range(len(PROMPT_LENS))]
    reqs = _serve(ts.ServingScheduler, tp, tcfg, keys, paged, True, 5,
                  device="cpu")
    pairs = []
    for r, k in zip(reqs, keys):
        want = td.generate_ring_dense(
            tp, r.prompt[None], MAX_NEW, tcfg, temperature=TEMP, top_k=5,
            key=k, quantize_kv=True, device="cpu")
        pairs.append((r.tokens, want[0].tolist(), k, r.prompt.size - 1, 0))
    _check_streams(pairs, draws, f"scheduler vs oracle paged={paged}")


def test_sample_rows_matches_pick_token():
    """The op against ``_pick_token`` row by row: per-row keys and
    positions, the global row folded (``row0``)."""
    rng = np.random.default_rng(5)
    lg = rng.standard_normal((3, 200)).astype(np.float32) * 2
    for top_k in (None, 1, 5):
        for row0 in (0, 4):
            key = jax.random.key(11)
            want = np.asarray(jd._pick_token(jnp.asarray(lg), 17, key, TEMP,
                                             top_k, jnp.int32, row0=row0))
            got = sampling.sample_rows(
                torch.from_numpy(lg), torch.full((3,), 17),
                prng.key(11).expand(3, 2),
                torch.arange(3, dtype=torch.int32) + row0, TEMP, top_k)
            np.testing.assert_array_equal(got.numpy(), want)


def test_validation_matches_the_reference(models):
    jcfg, jp, tcfg, tp = models
    prompt = _prompts(1, 4, seed=0)
    cases = [dict(temperature=-0.1), dict(temperature=TEMP, top_k=0),
             dict(key="k"), dict(temperature=TEMP)]
    for kw in cases:
        jkw = {**kw, **({"key": jax.random.key(0)} if "key" in kw else {})}
        tkw = {**kw, **({"key": prng.key(0)} if "key" in kw else {})}
        with pytest.raises(ValueError) as jerr:
            jd.generate_dense(jp, jnp.asarray(prompt), 2, jcfg, **jkw)
        with pytest.raises(ValueError) as terr:
            td.generate_dense(tp, prompt, 2, tcfg, device="cpu", **tkw)
        assert str(terr.value).split()[:2] == str(jerr.value).split()[:2]
    for kw in (dict(temperature=-1.0), dict(top_k=0), dict(max_queue=0)):
        with pytest.raises(ValueError):
            js.ServingScheduler(jp, jcfg, slots=1, **kw)
        with pytest.raises(ValueError):
            ts.ServingScheduler(tp, tcfg, slots=1, device="cpu", **kw)
    for mod, p, c, key, kw in (
            (js, jp, jcfg, jax.random.key(0), {}),
            (ts, tp, tcfg, prng.key(0), {"device": "cpu"})):
        greedy = mod.ServingScheduler(p, c, slots=1, max_queue=1, **kw)
        with pytest.raises(ValueError, match="greedy scheduler"):
            greedy.submit(prompt[0], 2, key=key)
        greedy.submit(prompt[0], 2)
        with pytest.raises(RuntimeError, match="queue ceiling"):
            greedy.submit(prompt[0], 2)


@pytest.mark.parametrize("paged", [None, 4])
@pytest.mark.parametrize("prompt_len", [5, 12])
def test_raised_first_token_pick_leaves_admission_retryable(models, paged,
                                                            prompt_len):
    """A first-token pick that raises (``top_k`` past the vocabulary)
    commits nothing of the admission: every later ``step()`` (and
    ``run()``) raises the same ``ValueError`` again, as the JAX
    scheduler does, the chunk counter and ``prefill_chunks`` stay where
    they were, and the page pool stays consistent. A 12-token prompt
    takes two chunks of 8, so its first step succeeds."""
    jcfg, jp, tcfg, tp = models
    prompt = np.arange(1, prompt_len + 1)
    first_error = {}
    for mod, p, c, kw in ((js, jp, jcfg, {}), (ts, tp, tcfg,
                                               {"device": "cpu"})):
        sched = mod.ServingScheduler(p, c, slots=2, n_inner=2,
                                     prompt_chunk=8, max_prompt=16,
                                     temperature=TEMP, top_k=80,
                                     page_tokens=paged, **kw)
        sched.submit(prompt, 4)
        if prompt_len > 8:
            sched.step()
        errors = []
        for _ in range(2):
            with pytest.raises(ValueError) as err:
                sched.step()
            errors.append(str(err.value))
        with pytest.raises(ValueError):
            sched.run()
        assert errors[0] == errors[1]
        first_error[mod] = errors[0]
        if mod is ts:
            (st,) = sched._admitting.values()
            assert st.next_chunk == st.n_chunks - 1
            assert sched.prefill_chunks == st.n_chunks - 1
            assert "top_k" in errors[0]
            if paged:
                sched.pool.check()
    # the port raises the reference scheduler's own error: the same k
    # past the same vocabulary, in the port's wording or in the one
    # `jax.lax.top_k` gives it
    assert _top_k_error(first_error[ts]) == _top_k_error(first_error[js])
    assert _top_k_error(first_error[ts]) == (80, 61)


def _top_k_error(msg: str) -> tuple[int, int] | None:
    """(k, V) named by a top_k-past-the-vocabulary error of either
    package, or None if the message is not one."""
    port = re.search(r"top_k must lie in \[1, V=(\d+)\], got (\d+)", msg)
    if port:
        return int(port[2]), int(port[1])
    ref = re.search(r"k argument to top_k must be no larger than size "
                    r"along axis; got k=(\d+) with shape=\[(?:\d+, )*"
                    r"(\d+)\]", msg)
    return (int(ref[1]), int(ref[2])) if ref else None
