"""Fault injection in the port (``utils/faults.py``) against the JAX
package, and its record -> replay loop over the port's pool.

The contract is ``tests/test_utils.py`` (``TestFaults``, the trace
replay, ``TestDeadWorkerDetection``) and ``tests/test_hierarchical.py``
``TestKillGroup``. Tolerance: every schedule's delay is bit-equal to
the reference's at every (worker, epoch) of a grid (both are numpy and
blake2b); ``from_trace`` over a JSONL file written by either package's
``EpochTracer`` returns the same delays bit for bit in both packages.
Late workers are held by gates (``threading.Event``), not sleeps.
"""

import json
import pickle
import threading

import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu import AsyncPool as RefPool
from mpistragglers_jl_tpu import LocalBackend as RefLocal
from mpistragglers_jl_tpu import asyncmap as ref_asyncmap
from mpistragglers_jl_tpu import waitall as ref_waitall
from mpistragglers_jl_tpu.utils import EpochTracer as RefTracer
from mpistragglers_jl_tpu.utils import faults as jf
from mpistragglers_jl_tpu_torch import (
    AsyncPool,
    CUDADeviceBackend,
    DeadWorkerError,
    LocalBackend,
    WorkerFailure,
    asyncmap,
    waitall,
)
from mpistragglers_jl_tpu_torch.utils import EpochTracer
from mpistragglers_jl_tpu_torch.utils import faults as tf

CPU = [torch.device("cpu")]
GRID = [(w, e) for w in range(9) for e in range(40)]
PART = [[0, 1, 2], [3, 4, 5], [6, 7, 8]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _echo(worker, payload, epoch):
    return np.concatenate([[worker, epoch], payload])


def _schedules(f):
    """One of every schedule of a faults module, built the same way."""
    return {
        "no_delay": f.no_delay,
        "fixed": f.fixed(0.05),
        "per_worker_seq": f.per_worker([0.1 * w for w in range(9)]),
        "per_worker_map": f.per_worker({1: 0.2, 7: 0.3}),
        "seeded_uniform": f.seeded_uniform(0.01, 0.2, seed=3),
        "seeded_lognormal": f.seeded_lognormal(0.01, 1.0, seed=3),
        "straggler": f.straggler([2, 5], 0.5, every=3, offset=1),
        "intermittent": f.intermittent(0.3, 1.0, seed=4),
        "dead_from": f.dead_from(0, epoch=5, delay=99.0),
        "kill_group": f.kill_group(PART, {1: 3, 2: 7}),
        "correlated_kill": f.correlated_kill(PART, epicenter=1,
                                             at_epoch=4, span=5),
        "partition": f.partition([PART[0]], 10, 16, epoch_s=0.1),
        "compose": f.compose(f.fixed(0.01),
                             f.seeded_uniform(0.0, 0.1, seed=9)),
        "schedule": (f.FaultSchedule(seed=7).jitter(0.0, 0.001)
                     .lognormal(0.002).straggler(1, 0.3)
                     .intermittent(0.2, 0.05).dead_from(3, epoch=2)
                     .kill_group(PART, {2: 9})
                     .correlated_kill(PART, epicenter=0, at_epoch=30)
                     .partition([PART[1]], 5, 8, epoch_s=0.5)).delay_fn,
    }


@pytest.mark.parametrize("name", list(_schedules(tf)))
def test_schedule_bit_equal_to_the_reference(name):
    got, want = _schedules(tf)[name], _schedules(jf)[name]
    for w, e in GRID:
        assert got(w, e) == want(w, e), (name, w, e)


def test_seeded_schedules_are_deterministic_and_spread():
    for fn in (tf.seeded_uniform(0.0, 1.0, seed=3),
               tf.seeded_lognormal(0.01, 1.0, seed=3),
               tf.intermittent(0.5, 1.0, seed=3)):
        assert [fn(w, e) for w, e in GRID] == [fn(w, e) for w, e in GRID]
    vals = [tf.seeded_uniform(0.1, 0.2)(w, e) for w, e in GRID]
    assert all(0.1 <= v < 0.2 for v in vals) and np.std(vals) > 0.01


def test_schedule_conventions():
    fn = tf.straggler(2, 0.5, every=3, offset=1)
    assert fn(2, 1) == 0.5 and fn(2, 4) == 0.5
    assert fn(2, 2) == 0.0 and fn(1, 1) == 0.0
    fn = tf.compose(tf.per_worker({1: 0.2}), tf.fixed(0.05))
    assert fn(1, 0) == pytest.approx(0.25) and fn(0, 0) == pytest.approx(0.05)
    fn = tf.dead_from(0, epoch=5, delay=99.0)
    assert fn(0, 4) == 0.0 and fn(0, 5) == 99.0 and fn(1, 9) == 0.0
    sched = (tf.FaultSchedule(seed=7).jitter(0.0, 0.001).straggler(1, 0.3)
             .dead_from(3, epoch=2))
    assert sched.delay_fn(1, 0) >= 0.3 and sched.delay_fn(3, 2) >= 3600.0
    assert repr(sched) == repr(jf.FaultSchedule(seed=7).jitter(0.0, 0.001)
                               .straggler(1, 0.3).dead_from(3, epoch=2))


def test_kill_group_conventions():
    part = [[0, 1], [2, 3]]
    k = tf.kill_group(part, {1: 3})
    assert k(2, 2) == 0.0 and k(2, 3) == 3600.0 and k(3, 9) == 3600.0
    assert k(0, 100) == 0.0 and k.killed_groups == [1]
    assert pickle.loads(pickle.dumps(k))(3, 5) == 3600.0
    assert tf.kill_group([[0], [0]], {0: 5, 1: 2})(0, 2) == 3600.0
    with pytest.raises(ValueError, match="names group 7"):
        tf.kill_group(part, {7: 1})
    c = tf.correlated_kill(PART, epicenter=2, at_epoch=1, span=3)
    assert c.killed_groups == [2]  # clamped at the partition's end
    with pytest.raises(ValueError, match="epicenter"):
        tf.correlated_kill(PART, epicenter=3, at_epoch=1)
    with pytest.raises(ValueError, match="span"):
        tf.correlated_kill(PART, epicenter=0, at_epoch=1, span=0)
    p = tf.partition([[1]], 2, 4, epoch_s=0.5)
    assert [p(1, e) for e in range(5)] == [0.0, 0.0, 1.0, 0.5, 0.0]
    with pytest.raises(ValueError, match="from_epoch"):
        tf.partition([[1]], 4, 4)
    sched = tf.FaultSchedule(seed=3).jitter(0.001, 0.002)
    sched.kill_group(part, {0: 4})
    assert "kill_group({0: 4})" in repr(sched)
    assert sched.delay_fn(1, 4) > 3600.0


def test_failing_raises_worker_failure():
    work = tf.failing(_echo, workers=1, epochs=2)
    backend = LocalBackend(work, 3)
    try:
        pool = AsyncPool(3)
        asyncmap(pool, np.zeros(2), backend, epoch=1)
        with pytest.raises(WorkerFailure) as ei:
            asyncmap(pool, np.zeros(2), backend, epoch=2)
            waitall(pool, backend)
        assert ei.value.worker == 1 and ei.value.epoch == 2
    finally:
        backend.shutdown()


def _records():
    """Two epoch records in the tracer's dict form: worker 2 dispatched
    in epoch 1 arrives in epoch 2's record (a cross-epoch straggle,
    priced from the record's latency snapshot)."""
    def ev(kind, w, t, e):
        return {"kind": kind, "worker": w, "t": t, "epoch": e}

    return [
        {"call": "asyncmap", "epoch": 1, "latency_s": [0.01, 0.02, 0.0],
         "events": [ev("dispatch", 0, 0.0, 1), ev("dispatch", 1, 0.0, 1),
                    ev("dispatch", 2, 0.0, 1), ev("arrival", 0, 0.010, 1),
                    ev("arrival", 1, 0.020, 1)]},
        {"call": "asyncmap", "epoch": 2, "latency_s": [0.011, 0.02, 0.25],
         "events": [ev("dispatch", 0, 1.0, 2), ev("retask", 1, 1.0, 2),
                    ev("drain", 2, 1.05, 1), ev("arrival", 0, 1.011, 2),
                    ev("arrival", 1, 1.03, 2)]},
    ]


def test_from_records_prices_every_arrival_like_the_reference():
    got = tf.from_trace.from_records(_records())
    want = jf.from_trace.from_records(_records())
    for w, e in GRID:
        assert got(w, e) == want(w, e)
    assert got(0, 1) == 0.010 and got(1, 2) == pytest.approx(0.03)
    assert got(2, 1) == 0.25  # the cross-epoch arrival's snapshot
    assert got(2, 999) == 0.25  # unknown epoch: the worker's median
    assert got(7, 1) == 2.5  # never heard from: 10x the longest
    assert tf.from_trace.from_records(_records(), missing=4.0)(7, 1) == 4.0


def _gated_trace(tracer_cls, pool_cls, backend_cls, am, wa, path):
    """Record 4 epochs with worker 2 held by a gate until each epoch's
    fast pair is back, then dump the trace."""
    gates = [threading.Event() for _ in range(5)]

    def delay(i, epoch):
        if i == 2:
            gates[epoch].wait(30)
        return 0.0

    backend = backend_cls(_echo, 3, delay_fn=delay)
    tracer = tracer_cls()
    try:
        pool = pool_cls(3)
        for e in range(1, 5):
            am(pool, np.zeros(1), backend, nwait=2, tracer=tracer)
            gates[e].set()
        wa(pool, backend, tracer=tracer)
    finally:
        for g in gates:
            g.set()
        backend.shutdown()
    tracer.dump_jsonl(path)
    return tracer


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_trace_from_either_package_replays_identically(writer, tmp_path):
    """A JSONL trace dumped by either package's EpochTracer: both
    packages' ``from_trace`` give the same delay at every (worker,
    epoch), and the gated worker is the straggler of the replay."""
    path = tmp_path / "trace.jsonl"
    if writer == "jax":
        tracer = _gated_trace(RefTracer, RefPool, RefLocal, ref_asyncmap,
                              ref_waitall, path)
    else:
        tracer = _gated_trace(EpochTracer, AsyncPool, LocalBackend,
                              asyncmap, waitall, path)
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["call"] for r in lines] == ["asyncmap"] * 4 + ["waitall"]
    got, want = tf.from_trace(path), jf.from_trace(path)
    for w, e in GRID:
        assert got(w, e) == want(w, e)
    # the gated worker answered after the fast pair in every epoch, so
    # its round trips were recorded from later records or the drain
    assert all((0, e) in got._by_key and (1, e) in got._by_key
               for e in range(1, 5))
    assert got(7, 1) >= 1.0  # unknown workers replay as long stalls
    assert tracer.summary()["straggler_rate"] > 0


def test_replay_through_the_cuda_backend_on_the_cpu(tmp_path):
    """The replayed schedule drives the port's CUDADeviceBackend: the
    traced straggler is never fresh inside its epoch."""
    recs = _records()
    recs[1]["latency_s"][2] = 1.0  # 50x the fast pair
    replay = tf.from_trace.from_records(recs)
    backend = CUDADeviceBackend(lambda i, p, e: p + i, 3, devices=CPU,
                                delay_fn=replay)
    tracer = EpochTracer()
    try:
        pool = AsyncPool(3)
        for _ in range(2):
            asyncmap(pool, torch.zeros(1), backend, nwait=2, tracer=tracer)
            assert pool.fresh_indices().tolist() == [0, 1]
        waitall(pool, backend, tracer=tracer)
    finally:
        backend.shutdown()
    assert tracer.records[-1].call == "waitall"


def test_waitall_timeout_with_injected_death():
    gate = threading.Event()

    def dead(i, epoch):
        if i == 2:
            gate.wait(30)
        return 0.0

    backend = LocalBackend(_echo, 3, delay_fn=dead)
    try:
        pool = AsyncPool(3)
        repochs = asyncmap(pool, np.zeros(1), backend, nwait=2, epoch=1)
        assert (repochs[:2] == 1).all()
        tracer = EpochTracer()
        with pytest.raises(DeadWorkerError) as ei:
            waitall(pool, backend, timeout=0.2, tracer=tracer)
        assert ei.value.dead == [2]
        assert tracer.records[-1].call == "waitall"
        assert tracer.records[-1].nwait == 1
    finally:
        gate.set()
        backend.shutdown()
