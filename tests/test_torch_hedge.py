"""Hedged requests of the port (``utils/hedge.py``) against the JAX
package: first-response-wins over subset pools of one shared backend.

The contract is ``tests/test_hedged.py``. Its ``SimBackend`` cases run
on the port's ``sim`` (virtual time: the winner's latency is an exact
clock reading), and the same virtual-time request sequence gives the
same winners, latencies and widths in both packages. In the thread
cases the slow replica is held by a gate (``threading.Event``) that the
test opens, so who wins, who is busy and which subsets form are decided
by the test, not by the clock; the same gated scenario through both
packages gives the same winners, widths and subsets.
``RequestHedge`` hands out the same entries in the same order as the
reference's under one sequence of arms, disarms and clock readings.
"""

import threading
import time

import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.backends.local import LocalBackend as RefLocal
from mpistragglers_jl_tpu.utils import hedge as jh
from mpistragglers_jl_tpu_torch import CUDADeviceBackend, LocalBackend, SimBackend
from mpistragglers_jl_tpu_torch.obs import MetricsRegistry, ObsServer
from mpistragglers_jl_tpu_torch.utils import HedgedServer, RequestHedge
from mpistragglers_jl_tpu_torch.utils import hedge as th

N = 4
SLOW, FAST = 0.25, 0.01
CPU = [torch.device("cpu")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _work(i, payload, epoch):
    return np.asarray([i, int(payload[0]), epoch], dtype=np.int64)


class _Gated:
    """A delay function holding the ranks in ``slow`` until ``open()``."""

    def __init__(self, slow=(0,)):
        self.slow = set(slow)
        self.gate = threading.Event()

    def __call__(self, i, epoch):
        if i in self.slow:
            self.gate.wait(30)
        return 0.0

    def open(self):
        self.gate.set()


def _settle(srv, busy):
    """Harvest until exactly ``busy`` ranks are still out."""
    deadline = time.perf_counter() + 10
    while srv._busy_ranks() != busy and time.perf_counter() < deadline:
        srv._harvest()
    assert srv._busy_ranks() == busy


def _scenario(server_cls, backend_cls):
    """Rank 0 held: a pinned [0, 1] request, a hedge=2 and a hedge=4
    request while rank 0 is busy losing, then the gate opens, the pool
    drains and three more hedge=2 requests rotate."""
    delay = _Gated()
    backend = backend_cls(_work, N, delay_fn=delay)
    srv = server_cls(backend)
    try:
        out = [srv.request(np.asarray([1], np.int64), replicas=[0, 1],
                           timeout=10.0)[1]]
        busy = srv._busy_ranks()
        out.append(srv.request(np.asarray([2], np.int64), hedge=2)[1])
        _settle(srv, {0})  # that request's loser is back
        out.append(srv.request(np.asarray([3], np.int64), hedge=4)[1])
        delay.open()
        srv.drain()
        for q in range(4, 7):
            out.append(srv.request(np.asarray([q], np.int64), hedge=2)[1])
            srv.drain()
        return out, busy, [h[2] for h in srv.history], sorted(srv._pools)
    finally:
        delay.open()
        backend.shutdown()


def test_gated_scenario_equals_the_reference():
    got = _scenario(HedgedServer, LocalBackend)
    want = _scenario(jh.HedgedServer, RefLocal)
    winners, busy, widths, subsets = got
    assert busy == {0}
    assert winners[0] == 1 and 0 not in winners[1:3]
    assert widths == [2, 2, 3, 2, 2, 2]  # hedge=4 narrowed to 3
    assert (widths, subsets) == (want[2], want[3])
    assert busy == want[1]
    # the three gated-free rounds rotate over the subsets the reference
    # builds; their winners race within a subset in both packages
    assert winners[0] == want[0][0]


def test_on_cuda_streams_of_the_cpu_route():
    """The same server over the port's CUDADeviceBackend (CPU route):
    the held replica loses, its rank stays out of new subsets until its
    late result is harvested, and the winner's payload is echoed."""
    delay = _Gated()
    backend = CUDADeviceBackend(
        lambda i, p, e: torch.cat([torch.tensor([float(i)]), p]), N,
        devices=CPU, delay_fn=delay)
    srv = HedgedServer(backend)
    try:
        result, rank, lat = srv.request(torch.tensor([7.0]),
                                        replicas=[0, 1], timeout=10.0)
        assert rank == 1 and result.tolist() == [1.0, 7.0] and lat >= 0
        assert srv._busy_ranks() == {0}
        _, rank2, _ = srv.request(torch.tensor([8.0]), hedge=2)
        assert rank2 != 0 and srv.last_hedge_width == 2
        assert all(0 not in k for k in srv._pools if k != (0, 1))
        delay.open()
        _settle(srv, set())
        srv.drain()
    finally:
        delay.open()
        backend.shutdown()


def test_round_robin_spreads_load_and_hedge_one_is_plain_dispatch():
    backend = LocalBackend(_work, N)
    srv = HedgedServer(backend)
    try:
        seen = set()
        for q in range(4):
            _, rank, _ = srv.request(np.asarray([q], np.int64), hedge=2)
            seen.add(rank)
            srv.drain()
        assert len(seen) >= 2
        _, rank, _ = srv.request(np.asarray([9], np.int64), hedge=1)
        assert rank in range(N) and srv.last_hedge_width == 1
        srv.drain()
        with pytest.raises(ValueError, match="hedge"):
            srv.request(np.asarray([1], np.int64), hedge=0)
    finally:
        backend.shutdown()


def test_dead_loser_does_not_poison_later_requests():
    """A replica that dies AFTER losing its hedge: the failure is
    recorded, the rank benched, and serving continues."""
    gate = threading.Event()

    def work(i, payload, epoch):
        if i == 0:
            gate.wait(30)  # lose first, then die
            raise RuntimeError("replica 0 exploded after losing")
        return _work(i, payload, epoch)

    backend = LocalBackend(work, N)
    srv = HedgedServer(backend)
    try:
        _, rank1, _ = srv.request(np.asarray([1], np.int64),
                                  replicas=[0, 1], timeout=10.0)
        assert rank1 == 1
        gate.set()
        deadline = time.perf_counter() + 10
        while not srv.failures and time.perf_counter() < deadline:
            srv._harvest()
        assert len(srv.failures) == 1 and srv.failures[0].worker == 0
        assert srv.dead_replicas == frozenset({0})
        for q in range(2, 6):
            _, rank, _ = srv.request(np.asarray([q], np.int64), hedge=2)
            assert rank != 0
        srv.drain()
        srv.reset_dead(0)
        assert 0 not in srv.dead_replicas
    finally:
        gate.set()
        backend.shutdown()


def test_all_dead_raises_immediately():
    backend = LocalBackend(_work, N)
    srv = HedgedServer(backend)
    try:
        srv._dead = {0, 1, 2, 3}
        with pytest.raises(RuntimeError, match="dead"):
            srv.request(np.asarray([1], np.int64), hedge=2)
    finally:
        backend.shutdown()


def test_one_budget_covers_pick_and_wait():
    """Every rank busy losing for the whole budget: the request gives up
    within its one budget with the pick's error."""
    delay = _Gated(slow=range(N))
    backend = LocalBackend(_work, N, delay_fn=delay)
    srv = HedgedServer(backend)
    try:
        for r in range(N):
            with pytest.raises(TimeoutError):
                srv.request(np.asarray([r], np.int64), replicas=[r],
                            timeout=0.01)
        budget = 0.2
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="request budget"):
            srv.request(np.asarray([9], np.int64), hedge=2, timeout=budget)
        assert time.perf_counter() - t0 < budget + 5.0
        delay.open()
        srv.drain()
    finally:
        delay.open()
        backend.shutdown()


def test_registry_series_and_health_check():
    delay = _Gated()
    backend = LocalBackend(_work, N, delay_fn=delay)
    reg = MetricsRegistry()
    exporter = ObsServer(registry=reg)
    srv = HedgedServer(backend, registry=reg, exporter=exporter)
    try:
        srv.request(np.asarray([1], np.int64), replicas=[0, 1], timeout=10)
        _settle(srv, {0})
        srv.request(np.asarray([2], np.int64), hedge=4)  # narrows to 3
        delay.open()
        srv.drain()
        snap = reg.snapshot()
        val = {n: sum(s["value"] for s in snap[n]["series"])
               for n in ("hedge_requests_total", "hedge_dispatches_total",
                         "hedge_narrowed_total")}
        assert val == {"hedge_requests_total": 2,
                       "hedge_dispatches_total": 5,
                       "hedge_narrowed_total": 1}
        wins = {s["labels"]["rank"]: s["value"]
                for s in snap["hedge_wins_total"]["series"]}
        assert wins["1"] >= 1 and wins["0"] == 0
        assert exporter._checks["hedge"].probe()["ok"] is True
    finally:
        delay.open()
        backend.shutdown()


def _hedge_ops(mod):
    h = mod.RequestHedge()
    objs = [object() for _ in range(6)]
    out = []
    for i, o in enumerate(objs):
        h.arm(o, 1.0 + (i % 3))
    h.disarm(objs[1])
    h.arm(objs[2], 0.5)  # re-arm: the old heap entry is a tombstone
    out.append(h.next_deadline())
    out.append([objs.index(o) for o in h.due(1.0)])
    out.append(len(h))
    out.append([objs.index(o) for o in h.due(2.5)])
    out.append(h.next_deadline())
    out.append([objs.index(o) for o in h.due(10.0)])
    out.append((len(h), h.next_deadline()))
    return out


def test_request_hedge_fires_in_the_reference_order():
    got = _hedge_ops(th)
    assert got == _hedge_ops(jh)
    assert got[1] == [2, 0, 3] and got[-1] == (0, None)
    assert RequestHedge is not jh.RequestHedge


# -- the SimBackend cases of tests/test_hedged.py ---------------------------


def _mk_sim(delay):
    return SimBackend(_work, N, delay_fn=delay)


def test_winner_is_fast_replica_and_latency_tracks_it():
    """Virtual time makes the Tail-at-Scale claim exact: the hedge pays
    the fast replica's delay, and the straggler costs the request
    nothing."""
    backend = _mk_sim(lambda i, e: SLOW if i == 0 else FAST)
    srv = HedgedServer(backend)
    t0 = backend.clock.now()
    result, rank, _ = srv.request(np.asarray([7], np.int64), replicas=[0, 1])
    assert rank == 1  # the fast one
    assert result[0] == 1 and result[1] == 7
    assert backend.clock.now() - t0 == pytest.approx(FAST, abs=1e-12)
    assert backend.last_latency[rank] == pytest.approx(FAST, abs=1e-12)
    backend.quiesce()  # let the loser land before the drain barrier
    srv.drain()


def test_loser_rank_excluded_until_harvested():
    """The busy loser's rank stays out of new subsets until its late
    result is harvested, and the harvest boundary is a clock value."""
    backend = _mk_sim(lambda i, e: SLOW if i == 0 else FAST)
    srv = HedgedServer(backend)
    srv.request(np.asarray([1], np.int64), replicas=[0, 1])
    assert srv._busy_ranks() == {0}
    _, rank2, _ = srv.request(np.asarray([2], np.int64), hedge=2)
    assert rank2 != 0
    assert srv.last_hedge_width == 2
    new_subsets = [k for k in srv._pools if k != (0, 1)]
    assert new_subsets and all(0 not in k for k in new_subsets)
    backend.clock.run_until(SLOW - 1e-9)
    srv._harvest()
    assert srv._busy_ranks() == {0}
    backend.clock.run_until(SLOW)
    srv._harvest()
    assert 0 not in srv._busy_ranks()
    srv.drain()


def _stalls(i, epoch):
    return SLOW if (epoch + i) % 4 == 0 else FAST


def test_tail_latency_win_under_random_stalls():
    """Replica r stalls on requests where (q + r) % 4 == 0; hedge=2
    (consecutive ranks never both stall) pays no stall at all."""
    backend = _mk_sim(_stalls)
    srv = HedgedServer(backend)
    hedged = []
    for q in range(8):
        t0 = backend.clock.now()
        srv.request(np.asarray([q], np.int64), hedge=2)
        hedged.append(backend.clock.now() - t0)
        srv.drain()
    assert hedged == pytest.approx([FAST] * 8, abs=1e-12), hedged
    srv.drain()


def test_hedge_width_is_observable():
    """A narrowed hedge lands in last_hedge_width and the history."""
    backend = _mk_sim(lambda i, e: SLOW if i == 0 else FAST)
    srv = HedgedServer(backend)
    srv.request(np.asarray([1], np.int64), hedge=2, replicas=[0, 1])
    assert srv.last_hedge_width == 2
    _, rank, _ = srv.request(np.asarray([2], np.int64), hedge=4)
    assert srv.last_hedge_width == 3
    assert srv.history[-1][2] == 3
    backend.quiesce()
    srv.drain()


def test_virtual_time_requests_equal_the_reference():
    """The stall schedule above, hedge 1 and 2, through both packages'
    ``HedgedServer`` on their own ``SimBackend``: the same winners,
    virtual latencies (bit for bit) and history."""
    from mpistragglers_jl_tpu.sim import SimBackend as RefSim

    def run(server_cls, sim_cls):
        backend = sim_cls(_work, N, delay_fn=_stalls)
        srv = server_cls(backend)
        out = []
        for q in range(8):
            t0 = backend.clock.now()
            _, rank, _ = srv.request(np.asarray([q], np.int64),
                                     hedge=1 + q % 2)
            out.append((rank, backend.clock.now() - t0))
            srv.drain()
        # history: (rank, real-clock latency, width)
        return out, [(h[0], h[2]) for h in srv.history], backend.clock.now()

    assert run(HedgedServer, SimBackend) == run(jh.HedgedServer, RefSim)
