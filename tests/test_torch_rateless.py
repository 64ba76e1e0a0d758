"""The rateless LT-coded GEMM of the port (``ops/rateless.py``) against
the JAX package, over ``CUDADeviceBackend(devices=[cpu])``.

The contract is ``tests/test_rateless.py``. Tolerances: shard supports
and shard ids are equal (both numpy, same seed); decodes of f64 operands
within rtol 1e-9 of ``A @ B`` (the contract's limit); the two packages'
decodes of the same collected shard set (the same ``(worker,
generation)`` draws, made in the same order) within 1e-12 relative of
each other in f64, and the port's fresh-generation blocks, summed in
support order on the device, bit-equal to its host-encoded blocks. A
permanent straggler is held by a gate (``threading.Event``) until the
test ends, so which round decodes is decided by the test, not a clock.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.ops import rateless as jrl
from mpistragglers_jl_tpu_torch import (
    AsyncPool,
    DeadWorkerError,
    LTCodedGemm,
    asyncmap,
)
from mpistragglers_jl_tpu_torch.ops import lt as tlt
from mpistragglers_jl_tpu_torch.ops import rateless as trl
from mpistragglers_jl_tpu_torch.ops.lt import LTCode
from mpistragglers_jl_tpu_torch.ops.rateless import RatelessLTGemm

CPU = [torch.device("cpu")]
K, N, SEED, STRAGGLER = 4, 6, 0, 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ab(seed, m=8, c=5, d=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, c)), rng.standard_normal((c, d))


class _Held:
    """Delay function holding worker ``who`` until the test releases it."""

    def __init__(self, who=STRAGGLER):
        self.who = who
        self.gate = threading.Event()

    def __call__(self, i, epoch):
        if i == self.who:
            self.gate.wait(60)
        return 0.0


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_witness_code_property():
    code = LTCode(K, seed=SEED)
    window = list(range(N))
    assert code.peelable(window)
    rest = [s for s in window if s != STRAGGLER]
    assert not code.peelable(rest)
    assert code.peelable(rest + [w + N for w in range(N) if w != STRAGGLER])


def test_static_window_cannot_decode_with_held_straggler():
    """The fixed-window workload: re-tasks recompute the same shard, so
    with the load-bearing worker held the wait can only time out."""
    A, B = _ab(0)
    held = _Held()
    lt = LTCodedGemm(A, N, K, seed=SEED, shard_ids=list(range(N)),
                     delay_fn=held, devices=CPU)
    try:
        with pytest.raises(DeadWorkerError):
            asyncmap(AsyncPool(N), B, lt.backend, nwait=lt.nwait,
                     timeout=0.3)
    finally:
        held.gate.set()
        lt.backend.shutdown()


def test_rateless_decodes_past_a_held_straggler():
    """Same code, same seed, same (held) straggler: round 2 draws
    generation-1 shards from the live workers and the epoch decodes."""
    A, B = _ab(1)
    held = _Held()
    rg = RatelessLTGemm(A, N, K, seed=SEED, delay_fn=held, systematic=False,
                        devices=CPU)
    try:
        pool = AsyncPool(N)
        C = rg.multiply(B, pool, round_timeout=0.3, max_rounds=6)
        assert isinstance(C, torch.Tensor)
        np.testing.assert_allclose(_np(C), A @ B, rtol=1e-9)
        assert rg.stats["max_generation"] >= 1
        assert rg.stats["shards_used"] > rg.stats["k"]
        ids = rg.collected_ids(pool.epoch)
        assert rg.shard_id(STRAGGLER, 0) not in ids
        assert len(set(ids)) == len(ids)
    finally:
        held.gate.set()
        rg.backend.shutdown()


def test_fast_path_and_repeated_epochs():
    A, B1 = _ab(2)
    B2 = np.random.default_rng(9).standard_normal(B1.shape)
    rg = RatelessLTGemm(A, N, K, seed=SEED, devices=CPU)
    try:
        pool = AsyncPool(N)
        np.testing.assert_allclose(_np(rg.multiply(B1, pool)), A @ B1,
                                   rtol=1e-9)
        assert rg.stats["max_generation"] == 0
        assert rg.stats["shards_used"] <= N
        np.testing.assert_allclose(_np(rg.multiply(B2, pool)), A @ B2,
                                   rtol=1e-9)
    finally:
        rg.backend.shutdown()
    sids = {rg.shard_id(w, g) for w in range(N) for g in range(50)}
    assert len(sids) == N * 50


def test_systematic_decodes_exactly():
    rng = np.random.default_rng(5)
    A, B = rng.standard_normal((24, 6)), rng.standard_normal((6, 5))
    rg = RatelessLTGemm(A, 4, 4, seed=5, dtype=np.float64, devices=CPU)
    try:
        assert rg.code.systematic
        C = rg.multiply(B, AsyncPool(4))
        np.testing.assert_allclose(_np(C), A @ B, rtol=1e-9)
        assert rg.stats["shards_used"] >= 4
    finally:
        rg.backend.shutdown()


@pytest.mark.parametrize("systematic", [True, False])
def test_same_draws_decode_like_the_reference(systematic):
    """Both packages draw the same (worker, generation) shards in the
    same order through ``_work`` and decode them: the collected ids, the
    stats and the products agree, and the port's device-encoded fresh
    blocks equal its host encodes bit for bit."""
    A, B = _ab(3, m=16, c=6, d=4)
    draws = [1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 1, 2]  # worker 0 never lands
    jr = jrl.RatelessLTGemm(A, N, K, seed=SEED, systematic=systematic)
    tr = RatelessLTGemm(A, N, K, seed=SEED, systematic=systematic,
                        devices=CPU)
    try:
        epoch = 1
        jr._live_epoch = tr._live_epoch = epoch
        for w in draws:
            jr._work(w, jnp.asarray(B), epoch)
            tr._work(w, torch.from_numpy(B), epoch)
            if tr.decodable(epoch):
                break
        assert tr.collected_ids(epoch) == jr.collected_ids(epoch)
        got, want = tr._decode(epoch), jr._decode(epoch)
        assert tr.stats == jr.stats
        np.testing.assert_allclose(_np(got), want, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(_np(got), A @ B, rtol=1e-9)
        for sid in tr.collected_ids(epoch):
            host = tlt.sum_support(tr._src, tr.code.shard_indices(sid))
            assert torch.equal(tr._coded_block(sid % N, sid),
                               torch.from_numpy(host))
    finally:
        jr.backend.shutdown()
        tr.backend.shutdown()


def test_systematic_prefix_and_overhead_beats_plain_lt():
    code = LTCode(8, seed=1, systematic=True)
    assert [code.shard_indices(s).tolist() for s in range(8)] == [
        [s] for s in range(8)]
    assert any(len(code.shard_indices(s)) > 1 for s in range(8, 24))

    def consumed(systematic, trials=60, k=8, n=8, straggler=3):
        used = []
        for t in range(trials):
            c = LTCode(k, seed=t, systematic=systematic)
            arrived, sid = [], 0
            while True:
                if sid % n != straggler:
                    arrived.append(sid)
                    if c.peelable(arrived):
                        break
                sid += 1
            used.append(len(arrived))
        return sum(used) / len(used)

    syst, plain = consumed(True), consumed(False)
    assert syst <= 1.3 * 8 and syst < plain


def test_stale_epoch_arrival_not_retained():
    A, B = _ab(6, m=8, c=4, d=3)
    rg = RatelessLTGemm(A, 2, 2, seed=6, dtype=np.float64, devices=CPU)
    try:
        rg.multiply(B, AsyncPool(2))
        live = rg._live_epoch
        rg._work(0, torch.from_numpy(B), live - 1)  # a pruned epoch's straggler
        assert set(rg._collected) == {live}
    finally:
        rg.backend.shutdown()


def test_device_src_single_flight():
    A = np.random.default_rng(7).standard_normal((16, 4))
    rg = RatelessLTGemm(A, 4, 4, seed=7, dtype=np.float64, devices=CPU)
    dev = rg.devices[0]
    results, barrier = [], threading.Barrier(6)

    def grab():
        barrier.wait()
        results.append(rg._device_src(dev))

    threads = [threading.Thread(target=grab) for _ in range(6)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert len(results) == 6 and all(r is results[0] for r in results)
        np.testing.assert_array_equal(_np(results[0]), rg._src)
    finally:
        rg.backend.shutdown()


def test_device_src_failed_build_is_retryable(monkeypatch):
    A = np.random.default_rng(11).standard_normal((16, 4))
    rg = RatelessLTGemm(A, 4, 4, seed=11, dtype=np.float64, systematic=False,
                        devices=CPU)
    dev = rg.devices[0]
    real, calls = trl._to_device, {"n": 0}

    def flaky(x, d):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient device memory pressure")
        return real(x, d)

    monkeypatch.setattr(trl, "_to_device", flaky)
    try:
        with pytest.raises(RuntimeError, match="memory pressure"):
            rg._device_src(dev)
        assert dev not in rg._src_dev
        src = rg._device_src(dev)
        np.testing.assert_array_equal(_np(src), rg._src)
        assert rg._device_src(dev) is src
    finally:
        rg.backend.shutdown()


def test_needs_a_card_unless_told_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RatelessLTGemm(np.zeros((4, 2)), 2, 2)
