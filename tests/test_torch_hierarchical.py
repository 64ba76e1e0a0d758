"""The hierarchical two-level coded GEMM of the port
(``ops/hierarchical.py``, ``ops/outer_code.py``) against the JAX
package, over ``CUDADeviceBackend(devices=[cpu])`` and ``LocalBackend``.

The contract is ``tests/test_hierarchical.py`` without its
``host_groups`` cases (partitions read off a mesh; they run in
tests/test_torch_multihost.py). Its
``SimBackend`` matrix and ``sweep_hierarchical`` cases run on the port's
``sim`` (virtual time), and the same sweep gives the same table in both
packages (tolerance: none). Elsewhere a dead host group is held by a
gate (``threading.Event``) until the test ends, so which groups arrive
is the test's choice. Tolerances:
outer generator rows, partitions and predicates equal the reference's
exactly; outer decodes within the contract's rtol 1e-5 / atol 1e-6;
products within the contract's 1e-3 (f32) and 5e-2 (bf16) of max|A @
B|; the two packages' decodes of the same fresh set within 1e-5 of
max|A @ B| (f32: the same solves summed in other orders); the batched
inner solve equal to per-group solves within 1e-6.
"""

import itertools
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu import AsyncPool as RefPool
from mpistragglers_jl_tpu.ops import HierarchicalCodedGemm as RefHier
from mpistragglers_jl_tpu.ops import outer_code as joc
from mpistragglers_jl_tpu_torch import (
    AsyncPool,
    DeadWorkerError,
    LocalBackend,
    asyncmap,
    waitall,
)
from mpistragglers_jl_tpu_torch.obs import FlightRecorder, MetricsRegistry
from mpistragglers_jl_tpu_torch.ops import HierarchicalCodedGemm
from mpistragglers_jl_tpu_torch.ops import hierarchical as thi
from mpistragglers_jl_tpu_torch.ops.coding import _lu_solve
from mpistragglers_jl_tpu_torch.ops.outer_code import (
    LTOuter,
    ParityOuter,
    make_outer,
    partition_groups,
)
from mpistragglers_jl_tpu_torch.sim import SimBackend, sweep_hierarchical
from mpistragglers_jl_tpu_torch.utils import faults
from mpistragglers_jl_tpu_torch.utils.straggle import PoolLatencyModel

CPU = [torch.device("cpu")]
TOL = {"float32": 1e-3, "bfloat16": 5e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(dtype, m=72, kdim=16, ncols=12, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, kdim)).astype(np.float32)
    B = rng.standard_normal((kdim, ncols)).astype(np.float32)
    if dtype == "bfloat16":
        A = A.astype(ml_dtypes.bfloat16).astype(np.float32)
        B = B.astype(ml_dtypes.bfloat16).astype(np.float32)
    return A, B, A @ B


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


class _Held:
    """Delay function holding every worker of ``workers`` until released:
    a dead host, whose workers never arrive while the test runs."""

    def __init__(self, workers=()):
        self.workers = {int(w) for w in workers}
        self.gate = threading.Event()

    def __call__(self, i, epoch):
        if i in self.workers:
            self.gate.wait(60)
        return 0.0


# -- outer codes (pure, no pool) ------------------------------------------


@pytest.mark.parametrize("as_torch", [False, True])
def test_parity_decodes_from_any_single_missing_group(as_torch):
    rng = np.random.default_rng(1)
    outer = ParityOuter(4)
    np.testing.assert_array_equal(outer.generator_rows(),
                                  joc.ParityOuter(4).generator_rows())
    src = rng.standard_normal((3, 5, 4)).astype(np.float32)
    coded = np.einsum("hl,lrc->hrc", outer.generator_rows(), src)
    blocks = torch.from_numpy(coded) if as_torch else coded
    for missing in range(4):
        ids = [g for g in range(4) if g != missing]
        out = outer.decode([blocks[g] for g in ids], ids)
        assert isinstance(out, torch.Tensor) == as_torch
        np.testing.assert_allclose(np.asarray(out), src, rtol=1e-5,
                                   atol=1e-6)
    assert not outer.decodable([0, 1])
    with pytest.raises(ValueError, match="outer decodability floor"):
        outer.decode([blocks[0], blocks[1]], [0, 1])
    assert outer.select([0, 1, 2, 3]) == [0, 1, 2]
    assert outer.select([0, 2, 3]) == [0, 2, 3]
    with pytest.raises(ValueError, match="outer floor"):
        outer.select([1, 3])


@pytest.mark.parametrize("as_torch", [False, True])
def test_lt_outer_survives_multi_group_loss(as_torch):
    rng = np.random.default_rng(2)
    outer, ref = LTOuter(4, 2, seed=0), joc.LTOuter(4, 2, seed=0)
    np.testing.assert_array_equal(outer.generator_rows(),
                                  ref.generator_rows())
    src = rng.standard_normal((2, 5, 4)).astype(np.float32)
    coded = np.einsum("hl,lrc->hrc", outer.generator_rows(), src)
    blocks = torch.from_numpy(coded) if as_torch else coded
    survivors = [ids for ids in itertools.combinations(range(4), 2)
                 if outer.decodable(list(ids))]
    assert survivors == [ids for ids in itertools.combinations(range(4), 2)
                         if ref.decodable(list(ids))]
    assert survivors
    for ids in survivors:
        out = outer.decode([blocks[g] for g in ids], list(ids))
        np.testing.assert_allclose(np.asarray(out), src, rtol=1e-5,
                                   atol=1e-6)
        assert outer.select(list(ids)) == ref.select(list(ids))


def test_make_outer_and_partitions_equal_the_reference():
    for H, rate in ((4, None), (4, 0.5), (5, 0.4), (2, None)):
        got, want = make_outer(H, rate=rate), joc.make_outer(H, rate=rate)
        assert (got.kind, got.L, got.H) == (want.kind, want.L, want.H)
    with pytest.raises(ValueError, match="outer decodability floor"):
        make_outer(4, rate=0.05)
    with pytest.raises(ValueError, match="L=5 > H"):
        make_outer(4, rate=1.25)
    with pytest.raises(ValueError, match="rate \\(H-1\\)/H"):
        make_outer(4, rate=0.5, kind="parity")
    assert [p.tolist() for p in partition_groups(8, 2)] == [
        [0, 1, 2, 3], [4, 5, 6, 7]]
    assert [p.tolist() for p in partition_groups(4, [[2, 3], [0, 1]])] == [
        [2, 3], [0, 1]]
    with pytest.raises(ValueError, match="evenly"):
        partition_groups(8, 3)
    with pytest.raises(ValueError, match="equal-sized"):
        partition_groups(3, [[0, 1], [2]])
    with pytest.raises(ValueError, match="exactly once"):
        partition_groups(4, [[0, 1], [1, 2]])


# -- the predicate ---------------------------------------------------------


def _hg(A=None, device_backend=False, **kw):
    A = np.zeros((36, 4), np.float32) if A is None else A
    kw = {"groups": 4, "n_inner": 4, "k_inner": 3, **kw}
    return (HierarchicalCodedGemm(A, device_backend=device_backend,
                                  devices=CPU, **kw),
            RefHier(A, device_backend=False, **kw))


def test_predicate_fires_exactly_at_the_floor_like_the_reference():
    hg, ref = _hg()
    for r in range(5):
        for up in itertools.combinations(range(4), r):
            for short in (0, 1):
                rep = np.zeros(16, dtype=np.int64)
                for g in up:
                    rep[hg.group_indices[g][: hg.k_inner - short]] = 5
                want = (len(up) >= hg.L) and not short
                assert hg.nwait(5, rep) == ref.nwait(5, rep) == want
    lt, lref = _hg(np.zeros((24, 4), np.float32), outer="lt", outer_rate=0.5)
    assert lt.L == 2
    for r in range(lt.L):
        for up in itertools.combinations(range(4), r):
            rep = np.zeros(16, dtype=np.int64)
            for g in up:
                rep[lt.group_indices[g][: lt.k_inner]] = 2
            assert not lt.nwait(2, rep) and not lref.nwait(2, rep)


def test_construction_refusals():
    A = np.zeros((12, 4), np.float32)
    kw = {"devices": CPU, "device_backend": False}
    with pytest.raises(ValueError, match="n_inner is required"):
        HierarchicalCodedGemm(A, groups=2, k_inner=2, **kw)
    with pytest.raises(ValueError, match="divide evenly"):
        HierarchicalCodedGemm(A, groups=4, n_inner=4, k_inner=3, **kw)
    with pytest.raises(ValueError, match="k_inner <= n_inner"):
        HierarchicalCodedGemm(A, groups=2, n_inner=2, k_inner=3, **kw)
    with pytest.raises(ValueError, match="contradict n_inner"):
        HierarchicalCodedGemm(A, groups=[[0, 1], [2, 3]], n_inner=3,
                              k_inner=2, **kw)
    with pytest.raises(ValueError, match="unknown inner code"):
        HierarchicalCodedGemm(A, groups=2, n_inner=2, k_inner=2,
                              inner="rs", **kw)


# -- decode identity over the pool -----------------------------------------


def _ref_result(ref, pool):
    """The reference's decode of the port pool's fresh set."""
    jp = RefPool(pool.n_workers)
    jp.epoch, jp.repochs[:] = pool.epoch, pool.repochs
    jp.results = [None if r is None else r.float().numpy()
                  for r in pool.results]
    return ref.result(jp)


@pytest.mark.parametrize("H", [2, 4])
@pytest.mark.parametrize("inner", ["mds", "lt"])
@pytest.mark.parametrize("killed", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_result_equals_plain_matmul(H, inner, killed, dtype):
    """(groups) x (inner code) x (killed groups) x dtype on CUDA streams
    of the CPU route: with the last group dead (held) the outer code
    recovers it; the decode equals the reference's on the same fresh
    set."""
    A, B, ref_c = _problem(dtype)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    kw = {"groups": H, "n_inner": 4, "k_inner": 3, "inner": inner}
    held = _Held()
    hg = HierarchicalCodedGemm(torch.from_numpy(A).to(tdt), devices=CPU,
                               delay_fn=held, **kw)
    ref = RefHier(A.astype(ml_dtypes.bfloat16) if dtype == "bfloat16"
                  else A, device_backend=False, **kw)
    if killed:
        held.workers = set(hg.group_indices[H - 1].tolist())
    try:
        pool = AsyncPool(hg.n_workers)
        payload = torch.from_numpy(B).to(tdt)
        for _ in range(2):
            asyncmap(pool, payload, hg.backend, nwait=hg.nwait)
            C = hg.result_device(pool)
            assert C.shape == ref_c.shape and C.dtype == torch.float32
            assert _rel(C, ref_c) < TOL[dtype], (H, inner, killed, dtype)
            if dtype == "float32":
                assert _rel(C, _ref_result(ref, pool)) < 1e-5
        if killed:
            assert H - 1 not in hg.arrived_groups(pool)
        held.gate.set()
        waitall(pool, hg.backend, timeout=30)
    finally:
        held.gate.set()
        hg.backend.shutdown()


def test_explicit_partition_through_the_work_function():
    """Explicit lists as groups, the math driven through ``hg.work`` on
    an external LocalBackend (``device_backend=False``)."""
    A, B, ref_c = _problem("float32")
    groups = [[4, 5, 6, 7], [0, 1, 2, 3]]
    hg = HierarchicalCodedGemm(A, groups=groups, k_inner=3, devices=CPU,
                               device_backend=False)
    assert hg.backend is None and hg.H == 2 and hg.n_inner == 4
    be = LocalBackend(hg.work, 8)
    try:
        pool = AsyncPool(8)
        asyncmap(pool, B, be, nwait=hg.nwait)
        assert _rel(hg.result(pool), ref_c) < 1e-3
        ref = RefHier(A, groups=groups, k_inner=3, device_backend=False)
        assert _rel(hg.result(pool), _ref_result(ref, pool)) < 1e-5
        waitall(pool, be)
    finally:
        be.shutdown()


def test_result_refuses_below_floor_naming_both_floors():
    A, B, _ = _problem("float32")
    hg = HierarchicalCodedGemm(A, groups=4, n_inner=4, k_inner=3,
                               devices=CPU, device_backend=False)
    held = _Held(np.concatenate(hg.group_indices[2:]))
    be = LocalBackend(hg.work, hg.n_workers, delay_fn=held)
    try:
        pool = AsyncPool(hg.n_workers)
        with pytest.raises(DeadWorkerError):
            asyncmap(pool, B, be, nwait=hg.nwait, timeout=0.3)
        with pytest.raises(ValueError, match="outer floor needs 3"):
            hg.result(pool)
    finally:
        held.gate.set()
        be.shutdown()


def test_kill_group_schedule_on_the_pool():
    """``faults.kill_group`` from epoch 2, its stall held by a gate until
    the test ends: epoch 1 decodes from all groups, epoch 2 without the
    dead one, and its workers are still out at the end."""
    A, B, ref_c = _problem("float32")
    hg = HierarchicalCodedGemm(A, groups=4, n_inner=4, k_inner=3,
                               devices=CPU, device_backend=False)
    sched = faults.kill_group(hg.group_indices, {2: 2})
    gate = threading.Event()

    def delay(i, epoch):
        if sched(i, epoch) > 0:
            gate.wait(60)
        return 0.0

    be = LocalBackend(hg.work, hg.n_workers, delay_fn=delay)
    try:
        pool = AsyncPool(hg.n_workers)
        asyncmap(pool, B, be, nwait=hg.n_workers)
        assert hg.arrived_groups(pool) == [0, 1, 2, 3]
        assert _rel(hg.result(pool), ref_c) < 1e-3
        asyncmap(pool, B, be, nwait=hg.nwait)
        assert 2 not in hg.arrived_groups(pool)
        assert _rel(hg.result(pool), ref_c) < 1e-3
        assert pool.active[hg.group_indices[2]].all()
    finally:
        gate.set()
        be.shutdown()


def test_counters_and_flight_event_on_recovery():
    A, B, _ = _problem("float32")
    reg, fl = MetricsRegistry(), FlightRecorder()
    hg = HierarchicalCodedGemm(A, groups=4, n_inner=4, k_inner=3,
                               devices=CPU, device_backend=False,
                               registry=reg, flight=fl)
    snap = reg.snapshot()
    assert snap["hier_groups"]["series"][0]["value"] == 4
    assert snap["hier_outer_floor"]["series"][0]["value"] == 3
    be = LocalBackend(hg.work, hg.n_workers)
    try:
        pool = AsyncPool(hg.n_workers)
        asyncmap(pool, B, be, nwait=16)
        hg.result(pool)
    finally:
        be.shutdown()
    snap = reg.snapshot()
    assert snap["hier_outer_recoveries_total"]["series"][0]["value"] == 0
    inner = {s["labels"]["group"]: s["value"]
             for s in snap["hier_inner_decode_total"]["series"]}
    assert inner == {"0": 1, "1": 1, "2": 1, "3": 0}
    assert len(fl) == 0
    held = _Held(hg.group_indices[1])
    be = LocalBackend(hg.work, hg.n_workers, delay_fn=held)
    try:
        pool = AsyncPool(hg.n_workers)
        asyncmap(pool, B, be, nwait=hg.nwait)
        hg.result(pool)
    finally:
        held.gate.set()
        be.shutdown()
    snap = reg.snapshot()
    assert snap["hier_outer_recoveries_total"]["series"][0]["value"] == 1
    assert snap["hier_group_losses_total"]["series"][0]["value"] == 1
    ev = next(e for e in fl.snapshot()["traceEvents"]
              if e.get("name") == "hier outer recovery")
    assert ev["args"]["missing_groups"] == [1]
    dark = HierarchicalCodedGemm(A, groups=2, n_inner=4, k_inner=3,
                                 devices=CPU, device_backend=False)
    assert dark._m is None and dark._flight is None


def test_batched_inner_solve_equals_per_group_solves():
    gen = torch.Generator().manual_seed(3)
    G = torch.randn(3, 6, 6, generator=gen)
    shards = torch.randn(3, 6, 5, 7, generator=gen)
    got = thi.decode_groups(G, shards)
    for g in range(3):
        want = _lu_solve(G[g], shards[g].reshape(6, -1)).reshape(6, 5, 7)
        torch.testing.assert_close(got[g], want, rtol=0, atol=1e-6)
        torch.testing.assert_close(
            torch.einsum("kj,jrc->krc", G[g], got[g]), shards[g],
            rtol=1e-5, atol=1e-5)


# -- the SimBackend cases of tests/test_hierarchical.py ---------------------


def _sim_problem(dtype):
    """The contract's problem with A and B as tensors of ``dtype``."""
    A, B, ref = _problem(dtype)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return torch.from_numpy(A).to(tdt), torch.from_numpy(B).to(tdt), ref


@pytest.mark.parametrize("H", [2, 4])
@pytest.mark.parametrize("inner", ["mds", "lt"])
@pytest.mark.parametrize("killed", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_result_equals_plain_matmul_on_sim(H, inner, killed, dtype):
    """(groups) x (inner code) x (killed groups) x dtype on
    SimBackend, the outer-recovery path included."""
    A, B, ref = _sim_problem(dtype)
    hg = HierarchicalCodedGemm(A, groups=H, n_inner=4, k_inner=3,
                               inner=inner, devices=CPU,
                               device_backend=False)
    delay = faults.seeded_uniform(0.001, 0.01, seed=7)
    if killed:
        delay = faults.compose(
            delay, faults.kill_group(hg.group_indices, {H - 1: 1}))
    be = SimBackend(hg.work, hg.n_workers, delay_fn=delay)
    pool = AsyncPool(hg.n_workers)
    for _ in range(2):  # the kill lands on the FIRST epoch already
        asyncmap(pool, B, be, nwait=hg.nwait)
        C = hg.result(pool)
        assert C.shape == ref.shape
        assert _rel(C, ref) < TOL[dtype], (H, inner, killed, dtype)
    if killed:
        assert H - 1 not in hg.arrived_groups(pool)


def test_result_refuses_below_floor_on_sim():
    A, B, _ = _sim_problem("float32")
    hg = HierarchicalCodedGemm(A, groups=4, n_inner=4, k_inner=3,
                               devices=CPU, device_backend=False)
    be = SimBackend(hg.work, hg.n_workers, delay_fn=faults.kill_group(
        hg.group_indices, {2: 0, 3: 0}))
    pool = AsyncPool(hg.n_workers)
    with pytest.raises(Exception):
        asyncmap(pool, B, be, nwait=hg.nwait, timeout=5.0)
    with pytest.raises(ValueError, match="outer floor needs 3"):
        hg.result(pool)


def test_kill_one_host_sim_run_is_bit_identical():
    """A kill-one-host run decodes every epoch, twice, with bit-identical
    virtual walls and decoded bytes."""
    A, B, ref = _sim_problem("float32")

    def run():
        hg = HierarchicalCodedGemm(A, groups=4, n_inner=4, k_inner=3,
                                   devices=CPU, device_backend=False)
        be = SimBackend(hg.work, hg.n_workers, delay_fn=faults.compose(
            faults.seeded_lognormal(0.01, 1.0, seed=5),
            faults.kill_group(hg.group_indices, {1: 3})))
        pool = AsyncPool(hg.n_workers)
        walls, outs = [], []
        for _ in range(6):
            t0 = be.clock.now()
            asyncmap(pool, B, be, nwait=hg.nwait)
            walls.append(be.clock.now() - t0)
            outs.append(hg.result(pool))
        return walls, outs

    w1, o1 = run()
    w2, o2 = run()
    for C in o1:
        assert _rel(C, ref) < 1e-3
    assert w1 == w2
    assert all(np.array_equal(a, b) for a, b in zip(o1, o2))


def test_counters_and_flight_event_on_recovery_on_sim():
    A, B, _ = _sim_problem("float32")
    reg, fl = MetricsRegistry(), FlightRecorder()
    hg = HierarchicalCodedGemm(A, groups=4, n_inner=4, k_inner=3,
                               devices=CPU, device_backend=False,
                               registry=reg, flight=fl)
    pool = AsyncPool(hg.n_workers)
    asyncmap(pool, B, SimBackend(hg.work, hg.n_workers), nwait=16)
    hg.result(pool)
    snap = reg.snapshot()
    assert snap["hier_outer_recoveries_total"]["series"][0]["value"] == 0
    assert len(fl) == 0
    be2 = SimBackend(hg.work, hg.n_workers, delay_fn=faults.kill_group(
        hg.group_indices, {1: 0}))
    pool2 = AsyncPool(hg.n_workers)
    asyncmap(pool2, B, be2, nwait=hg.nwait)
    hg.result(pool2)
    snap = reg.snapshot()
    assert snap["hier_outer_recoveries_total"]["series"][0]["value"] == 1
    assert snap["hier_group_losses_total"]["series"][0]["value"] == 1
    ev = next(e for e in fl.snapshot()["traceEvents"]
              if e.get("name") == "hier outer recovery")
    assert ev["args"]["missing_groups"] == [1]


def test_dark_path_stays_dark_on_sim():
    A, B, _ = _sim_problem("float32")
    hg = HierarchicalCodedGemm(A, groups=2, n_inner=4, k_inner=3,
                               devices=CPU, device_backend=False)
    assert hg._m is None and hg._flight is None
    be = SimBackend(hg.work, hg.n_workers)
    pool = AsyncPool(hg.n_workers)
    asyncmap(pool, B, be, nwait=hg.nwait)
    hg.result(pool)


def _pinned_fleet(w, e):
    """Per group of 8: six fast workers (10-16 ms, deterministic
    jitter) + two 1 s stragglers — the inner optimum is sharply 6."""
    j = w % 8
    if j >= 6:
        return 1.0
    return 0.010 + 0.001 * j + 0.005 * ((w * 7 + e) % 3) / 3


def test_sweep_refuses_below_either_floor():
    with pytest.raises(ValueError, match="inner decodability floor"):
        sweep_hierarchical(_pinned_fleet, groups=4, n_inner=8,
                           candidates=[(0.75, 1)], inner_floor=2, epochs=5)
    with pytest.raises(ValueError, match="outer decodability floor"):
        sweep_hierarchical(_pinned_fleet, groups=4, n_inner=8,
                           candidates=[(0.05, 6)], epochs=5)
    with pytest.raises(ValueError, match="survive the scheduled"):
        sweep_hierarchical(_pinned_fleet, groups=4, n_inner=8,
                           candidates=[(1.0, 6)], failures={0: 3}, epochs=5)
    with pytest.raises(ValueError, match="exceeds the 8 workers"):
        sweep_hierarchical(_pinned_fleet, groups=4, n_inner=8,
                           candidates=[(0.75, 9)], epochs=5)


def test_sweep_refusal_checks_surviving_id_set_not_count():
    assert not LTOuter(4, 2, seed=0).decodable([2, 3])
    with pytest.raises(ValueError, match="cannot\\s+clear the outer"):
        sweep_hierarchical(_pinned_fleet, groups=4, n_inner=4,
                           candidates=[(0.5, 3)], failures={0: 2, 1: 2},
                           epochs=6)


def test_sweep_kill_scheduled_beyond_the_run_leaves_survivors():
    res = sweep_hierarchical(_pinned_fleet, groups=2, n_inner=8,
                             candidates=[(0.5, 6)],
                             failures={0: 1000, 1: 1000}, epochs=5)
    assert res["surviving_groups"] == 2
    assert res["check_group"] == 0


def test_sweep_pinned_recommendation_agrees_with_latency_model():
    """On the seeded fleet with one scheduled host kill the sweep lands
    on (0.75, 6), the latency model agrees, and the JAX package's sweep
    gives the same table."""
    from mpistragglers_jl_tpu.sim import sweep_hierarchical as ref_sweep

    cands = [(r, k) for r in (0.5, 0.75) for k in (4, 6, 8)]
    kw = dict(groups=4, n_inner=8, candidates=cands, inner_floor=2,
              epochs=40, failures={2: 10}, seed=3)
    res = sweep_hierarchical(_pinned_fleet, **kw)
    assert res["best"] == (0.75, 6)
    assert res["inner_sim"] == res["inner_model"] == 6
    assert res["agree"] is True
    assert res["check_group"] == 0
    assert res["surviving_groups"] == 3
    by = {(r["outer_rate"], r["inner_nwait"]): r for r in res["entries"]}
    assert by[(0.75, 6)]["utility_per_s"] > by[(0.75, 4)]["utility_per_s"]
    assert by[(0.75, 8)]["mean_epoch_s"] >= 1.0
    assert res["entries"] == sweep_hierarchical(_pinned_fleet, **kw)[
        "entries"]
    ref = ref_sweep(_pinned_fleet, **kw)
    assert res["entries"] == ref["entries"]
    assert {k: v for k, v in res.items() if k != "best_entry"} == {
        k: v for k, v in ref.items() if k != "best_entry"}


def test_sweep_model_source_uses_group_stats_directly():
    model = PoolLatencyModel(8, seed=1)
    rng = np.random.default_rng(4)
    for w in range(8):
        base = 0.01 if w % 4 != 3 else 0.5
        for x in base + rng.exponential(0.002, 60):
            model.observe(w, x)
    res = sweep_hierarchical(model, groups=2, n_inner=4,
                             candidates=[(0.5, 2), (0.5, 3)], epochs=15,
                             seed=1)
    assert res["inner_model"] == 3
    assert res["best"][1] == 3 and res["agree"]


def test_sweep_fleet_width_mismatch_is_refused():
    with pytest.raises(ValueError, match="describes 6 workers"):
        sweep_hierarchical(PoolLatencyModel(6), groups=4, n_inner=8,
                           candidates=[(0.75, 4)])
