"""The straggler latency model and the adaptive ``nwait`` controller of
the port (``utils/straggle.py``) against the JAX package.

The contract is ``tests/test_straggle.py``. Tolerance: the module is
numpy in both packages, so the same samples and seed give bit-equal
fits (count, mean, floor, variance, rate), bit-equal Monte-Carlo draws,
equal ``expected_epoch_time`` and equal ``nwait`` decisions; the
statistical checks keep the contract's own limits. Pools are fakes with
set latencies, or the port's pool where only counts are checked, so no
result rests on a sleep.
"""

import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.utils import straggle as js
from mpistragglers_jl_tpu_torch import (
    AsyncPool,
    CUDADeviceBackend,
    LocalBackend,
    asyncmap,
    waitall,
)
from mpistragglers_jl_tpu_torch.obs import MetricsRegistry
from mpistragglers_jl_tpu_torch.utils import straggle as tst
from mpistragglers_jl_tpu_torch.utils.straggle import (
    AdaptiveNwait,
    PoolLatencyModel,
    WorkerStats,
)

CPU = [torch.device("cpu")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _FakePool:
    """Minimal pool stand-in: every tick all workers 'arrive' with the
    given latencies (repochs advance together)."""

    def __init__(self, n):
        self.n_workers = n
        self.repochs = np.zeros(n, dtype=np.int64)
        self.latency = np.zeros(n)
        self.results = [None] * n

    def tick(self, latencies, arrived=None):
        arrived = range(self.n_workers) if arrived is None else arrived
        for i in arrived:
            self.repochs[i] += 1
            self.latency[i] = latencies[i]
            self.results[i] = np.zeros(1)


def _stats_state(w):
    return (w.count, w.mean, w.var, w.min, w.shift, w.rate, w.resets,
            w.to_dict())


def test_worker_stats_bit_equal_to_the_reference():
    rng = np.random.default_rng(0)
    xs = np.concatenate([0.005 + rng.exponential(0.001, 60),
                         0.075 + rng.exponential(0.001, 20),
                         [-1.0, np.nan, np.inf]])
    for cd in (False, True):
        got, want = WorkerStats(change_detect=cd), js.WorkerStats(
            change_detect=cd)
        for x in xs:
            assert got.observe(x) == want.observe(x)
            assert _stats_state(got) == _stats_state(want)
        np.testing.assert_array_equal(got.sample(np.random.default_rng(1), 50),
                                      want.sample(np.random.default_rng(1), 50))


def test_worker_stats_fit_recovers_shifted_exponential():
    rng = np.random.default_rng(0)
    w = WorkerStats()
    for x in 0.05 + rng.exponential(1.0 / 20.0, 4000):
        w.observe(x)
    assert w.shift == pytest.approx(0.05, abs=2e-3)
    assert w.rate == pytest.approx(20.0, rel=0.1)
    c = WorkerStats()
    for _ in range(10):
        c.observe(0.25)
    assert c.shift == 0.25 and not np.isfinite(c.rate)
    assert np.all(c.sample(np.random.default_rng(0), 100) == 0.25)


def _fed(mod, n=8, seed=1):
    model = mod.PoolLatencyModel(n, seed=seed)
    rng = np.random.default_rng(seed)
    for i in range(n - 1):  # the last worker never heard from
        mean = 10.0 if i == n - 2 else 0.05
        for x in 0.02 + rng.exponential(mean, 200):
            model.observe(i, x)
    return model


def test_predictions_bit_equal_to_the_reference():
    got, want = _fed(tst), _fed(js)
    np.testing.assert_array_equal(got.sample_latencies(500),
                                  want.sample_latencies(500))
    for k in range(9):
        assert got.expected_epoch_time(k) == want.expected_epoch_time(k)
    for kw in ({}, {"kmin": 3}, {"kmin": 2, "kmax": 6}, {"slo": 0.1},
               {"slo": 1e-6, "kmin": 4}, {"utility": lambda k: k * k}):
        assert got.optimal_nwait(**kw) == want.optimal_nwait(**kw), kw
    np.testing.assert_array_equal(got.proportional_shares(1001),
                                  want.proportional_shares(1001))
    assert got.summary() == want.summary()


def test_expected_epoch_time_matches_iid_order_statistic():
    n, rate, shift = 8, 10.0, 0.02
    rng = np.random.default_rng(1)
    model = PoolLatencyModel(n, seed=1)
    for i in range(n):
        for x in shift + rng.exponential(1.0 / rate, 3000):
            model.observe(i, x)
    H = np.concatenate([[0.0], np.cumsum(1.0 / np.arange(1, n + 1))])
    for k in (1, 4, 8):
        analytic = shift + (H[n] - H[n - k]) / rate
        assert model.expected_epoch_time(k, n_draws=20000) == pytest.approx(
            analytic, rel=0.08)
    assert model.expected_epoch_time(0) == 0.0
    with pytest.raises(ValueError):
        model.expected_epoch_time(n + 1)


def test_optimal_nwait_amortizes_floor_and_dodges_straggler():
    n = 8
    floor = PoolLatencyModel(n, seed=2)
    rng = np.random.default_rng(2)
    for i in range(n):
        for x in 1.0 + rng.exponential(0.01, 200):
            floor.observe(i, x)
    assert floor.optimal_nwait() == n
    strag = PoolLatencyModel(n, seed=3)
    for i in range(n):
        for x in rng.exponential(10.0 if i == n - 1 else 0.05, 200):
            strag.observe(i, x)
    assert strag.optimal_nwait() < n
    assert strag.optimal_nwait(kmin=6, kmax=7) in (6, 7)
    with pytest.raises(ValueError):
        strag.optimal_nwait(kmin=0)


def test_optimal_nwait_monotonic_in_slo_and_floor_respected():
    rng = np.random.default_rng(123)
    for trial in range(8):
        n = int(rng.integers(3, 10))
        model = PoolLatencyModel(n, seed=trial)
        for i in range(n):
            shift = float(rng.uniform(0.005, 0.2))
            tail = float(rng.uniform(0.001, 0.5))
            for x in shift + rng.exponential(tail, 25):
                model.observe(i, x)
        kmin = int(rng.integers(1, n + 1))
        slos = np.concatenate([[1e-6], np.geomspace(0.005, 5.0, 12),
                               [np.inf]])
        picks = [model.optimal_nwait(kmin=kmin, slo=s) for s in slos]
        assert all(k >= kmin for k in picks) and picks == sorted(picks)
        assert picks[-1] == model.optimal_nwait(kmin=kmin)
        assert picks[0] == kmin


def test_unheard_worker_samples_pooled_prior_not_zero():
    model = PoolLatencyModel(4, seed=5)
    for i in range(3):
        for _ in range(20):
            model.observe(i, 0.1)
    draws = model.sample_latencies(500)
    assert draws[:, 3].mean() == pytest.approx(0.1, rel=0.5)
    assert draws[:, 3].min() > 0


def _controller_trace(mod, n=8, epochs=40):
    """The nwait after every observe of a controller fed a rotating
    straggler (worker (e // 10) % n at 60 ms) on a fake pool."""
    ctl = mod.AdaptiveNwait(n, kmin=6, min_samples=2, refit_every=10, seed=0)
    pool = _FakePool(n)
    rng = np.random.default_rng(3)
    picks = []
    for e in range(epochs):
        lat = 0.004 + rng.exponential(0.0004, n)
        lat[(e // 10) % n] = 0.06
        pool.tick(lat)
        picks.append(ctl.observe(pool))
    return picks, [w.resets for w in ctl.model.workers]


def test_adaptive_decisions_equal_the_reference():
    got = _controller_trace(tst)
    assert got == _controller_trace(js)
    picks, resets = got
    assert picks[-1] <= 7  # dodging the straggler
    assert resets[1] >= 1  # the straggler moved onto worker 1


def test_adaptive_refit_survives_dead_worker():
    n = 4
    ctl = AdaptiveNwait(n, kmin=2, min_samples=2, refit_every=1, seed=0)
    pool = _FakePool(n)
    for _ in range(5):
        pool.tick([0.01, 0.02, 0.03, 0.0], arrived=range(n - 1))
        ctl.observe(pool)
    assert sum(w.count >= 2 for w in ctl.model.workers) == 3
    assert ctl.nwait <= n - 1


def test_cusum_fires_on_regime_shift_and_stays_quiet_when_stationary():
    w = WorkerStats(change_detect=True)
    rng = np.random.default_rng(0)
    for x in 0.005 + rng.exponential(0.001, 50):
        w.observe(x)
    fired = [w.observe(0.075 + rng.exponential(0.001)) for _ in range(10)]
    assert True in fired[:4] and w.mean > 0.05 and w.count <= 10
    q = WorkerStats(change_detect=True)
    for x in 0.005 + np.random.default_rng(1).exponential(0.002, 500):
        q.observe(x)
    assert q.resets <= 1


def test_model_reports_shifted_worker_only():
    n = 4
    model = PoolLatencyModel(n, change_detect=True)
    pool = _FakePool(n)
    rng = np.random.default_rng(2)
    for _ in range(30):
        pool.tick(0.005 + rng.exponential(0.0005, n))
        model.observe_pool(pool)
    assert model.shifted_last_observe == []
    lat = 0.005 + rng.exponential(0.0005, n)
    lat[2] = 0.08
    shifted = set()
    for _ in range(5):
        pool.tick(lat)
        model.observe_pool(pool)
        shifted |= set(model.shifted_last_observe)
    assert shifted == {2}
    assert model.workers[0].count >= 30 and model.workers[2].count < 6


@pytest.mark.parametrize("backend_kind", ["local", "cuda-on-cpu"])
def test_observe_pool_only_counts_advanced_workers(backend_kind):
    n = 3
    backend = (LocalBackend(lambda i, p, e: p, n) if backend_kind == "local"
               else CUDADeviceBackend(lambda i, p, e: p + i, n, devices=CPU))
    try:
        pool = AsyncPool(n)
        model = PoolLatencyModel(n)
        asyncmap(pool, np.zeros(1), backend, nwait=n)
        assert model.observe_pool(pool) == n
        assert model.observe_pool(pool) == 0  # no new epoch
        asyncmap(pool, np.zeros(1), backend, nwait=n)
        assert model.observe_pool(pool) == n
        assert all(w.count == 2 for w in model.workers)
        ctl = AdaptiveNwait(n, kmin=2, min_samples=1, refit_every=1)
        for _ in range(3):
            asyncmap(pool, np.zeros(1), backend, nwait=ctl.nwait)
            waitall(pool, backend)
            assert 2 <= ctl.observe(pool) <= n
    finally:
        backend.shutdown()


def test_publish_writes_the_ports_registry():
    model = PoolLatencyModel(3)
    for x in (0.01, 0.02, 0.03):
        model.observe(0, x)
    for _ in range(3):
        model.observe(1, 0.5)
    reg = MetricsRegistry()
    model.publish(reg)
    g = reg.snapshot()
    series = {s["labels"]["worker"]: s["value"]
              for s in g["pool_worker_latency_samples"]["series"]}
    assert series == {"0": 3, "1": 3, "2": 0}
    rate = {s["labels"]["worker"]: s["value"]
            for s in g["pool_worker_latency_tail_rate_hz"]["series"]}
    assert rate["1"] == 0.0 and rate["0"] == pytest.approx(100.0)
    assert "pool_worker_cusum_resets" in reg.to_prometheus()
