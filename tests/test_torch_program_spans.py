"""The port's program spans on the coded-GEMM path, on the CPU route
(``devices=[torch.device("cpu")]``): ``asyncmap(..., tracer=)`` and
``result_device(..., tracer=)`` under ``torch.profiler`` with every
thread profiled, per-worker MDS, coalesced MDS and LT.

With a tracer made with ``spans=True``, every ``mp.*`` span of the pool,
the backend and the decode appears, all on the coordinator's thread,
while the products' operations sit on the dispatcher threads (a trace
reader ties them to their worker by thread id). Without a tracer, or
with one that does not ask for spans, none is opened and
``obs.timeline.annotate`` is never entered. Which worker arrives late is
decided by a gate the test opens, not by a race.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from mpistragglers_jl_tpu_torch import AsyncPool, asyncmap, waitall
from mpistragglers_jl_tpu_torch.obs import timeline
from mpistragglers_jl_tpu_torch.ops.coded_gemm import CodedGemm, LTCodedGemm
from mpistragglers_jl_tpu_torch.utils.trace import EpochTracer

CPU = torch.device("cpu")
GATE_S = 30.0  # a gate that never opens fails the test, it does not hang
STALL_S = 0.3
EPOCHS = 3

COORDINATOR = {"mp.pool.drain", "mp.pool.dispatch", "mp.backend.copy",
               "mp.pool.flush", "mp.pool.wait", "mp.pool.retask"}
DECODE = {"mp.decode.select", "mp.decode.stack", "mp.decode.factor",
          "mp.decode.gather", "mp.decode.solve"}
ALL = COORDINATOR | DECODE

# the spans each route opens: the three together open every one (a
# re-task, forced in per-worker MDS, may happen in the others too)
EXPECTED = {
    "mds": ALL - {"mp.pool.flush"},
    "mds_coalesced": ALL - {"mp.pool.retask"},
    "lt": ALL - {"mp.pool.flush", "mp.pool.retask"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Stalls:
    """``delay_fn`` that waits inside the call and returns 0, as the
    benchmark's stall gate does. Per-worker MDS: worker 3's epoch-1 task
    waits on a gate that worker 0 opens at epoch 2, while every fast
    worker's epoch-2 task stalls ``STALL_S``; so worker 3 arrives stale
    inside epoch 2's wait and is re-tasked. LT: worker 1 stalls briefly."""

    def __init__(self, route: str):
        self.route = route
        self.gate = threading.Event()

    def __call__(self, i: int, epoch: int) -> float:
        if self.route == "lt":
            if i == 1:
                time.sleep(0.01)
        elif i == 3 and epoch == 1:
            assert self.gate.wait(GATE_S)
        elif epoch == 2:
            if i == 0:
                self.gate.set()
            time.sleep(STALL_S)
        return 0.0


def _program(route: str, delay_fn):
    rng = np.random.default_rng(7)
    if route == "lt":
        A = rng.standard_normal((24, 8)).astype(np.float32)
        gemm = LTCodedGemm(A, 8, 4, devices=[CPU], delay_fn=delay_fn)
        return A, gemm, AsyncPool(8), gemm.nwait
    A = rng.standard_normal((24, 8)).astype(np.float32)
    batch = route == "mds_coalesced"
    gemm = CodedGemm(A, 4, 2, devices=[CPU], batch=batch,
                     delay_fn=None if batch else delay_fn)
    return A, gemm, AsyncPool(4), 2


def _run(route: str, tracer):
    """``EPOCHS`` epochs and their decodes, then the drain; the names of
    the worker threads' native ids, and the products."""
    stalls = _Stalls(route)
    A, gemm, pool, nwait = _program(route, stalls)
    B = np.random.default_rng(8).standard_normal((8, 5)).astype(np.float32)
    try:
        products = []
        for _ in range(EPOCHS):
            asyncmap(pool, B, gemm.backend, nwait=nwait, tracer=tracer)
            products.append(gemm.result_device(pool, tracer=tracer))
        stalls.gate.set()
        waitall(pool, gemm.backend, timeout=GATE_S)
        tids = {t.native_id: i for i, t in enumerate(gemm.backend._threads)}
    finally:
        gemm.backend.shutdown()
    for C in products:
        np.testing.assert_allclose(C.numpy(), A @ B, rtol=1e-4, atol=1e-4)
    return tids


def _profiled(tmp_path, fn):
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    # the program's spans are torch's fast record function: cpu_op events
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("name", "").startswith("mp.")]
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op"]
    return out, spans, ops


def _base(name: str) -> str:
    return name.split("/")[0]


def test_the_three_routes_open_every_span():
    assert set().union(*EXPECTED.values()) == ALL
    assert len(ALL) == 11


@pytest.mark.parametrize("route", sorted(EXPECTED))
def test_spans_with_a_tracer(tmp_path, route):
    tracer = EpochTracer(spans=True)
    tids, spans, ops = _profiled(tmp_path, lambda: _run(route, tracer))
    names = {_base(s["name"]) for s in spans}
    assert EXPECTED[route] <= names, sorted(EXPECTED[route] - names)
    assert names - EXPECTED[route] <= {"mp.pool.retask"}, sorted(names)
    # every span is the coordinator's: a dispatcher thread opens none
    main = threading.get_native_id()
    assert {s["tid"] for s in spans} == {main}

    records = [r for r in tracer.records if r.call == "asyncmap"]
    events = [e for r in records for e in r.events]
    arrivals = sum(e.kind == "arrival" for e in events)
    count = {b: sum(_base(s["name"]) == b for s in spans) for b in ALL}
    assert count["mp.pool.wait"] == arrivals  # one per arrival
    assert count["mp.pool.dispatch"] == count["mp.pool.drain"] == EPOCHS
    assert count["mp.decode.solve"] == EPOCHS
    assert count["mp.pool.retask"] == sum(e.kind == "retask" for e in events)
    # the epoch tags are the calls' epochs
    epochs = sorted(int(s["name"].rsplit("/e", 1)[1]) for s in spans
                    if _base(s["name"]) == "mp.pool.dispatch")
    assert epochs == sorted(r.epoch for r in records)
    if route == "mds_coalesced":
        assert count["mp.pool.flush"] == EPOCHS
        return
    # each worker's product runs on its own dispatcher thread, found in
    # the trace by the thread's native id
    mm = {o["tid"] for o in ops if o["name"] in ("aten::mm", "aten::matmul")}
    assert mm and mm <= set(tids), (sorted(mm), tids)
    if route == "mds":
        # worker 3 arrived stale in epoch 2's wait and was re-tasked
        assert any(s["name"] == "mp.pool.retask/w3/e2" for s in spans)


@pytest.mark.parametrize("route", sorted(EXPECTED))
def test_no_tracer_opens_no_span(tmp_path, monkeypatch, route):
    """The dark path enters no profiler range of any kind."""
    entered = []

    def counting(real):
        def enter(name, *args, **kwargs):
            entered.append(name)
            return real(name, *args, **kwargs)
        return enter

    monkeypatch.setattr(timeline, "annotate", counting(timeline.annotate))
    monkeypatch.setattr(torch.profiler, "record_function",
                        counting(torch.profiler.record_function))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counting(torch._C._profiler._RecordFunctionFast))
    # no tracer, and a tracer that does not ask for spans (the
    # benchmark's traced window passes one for its dispatch count)
    for tracer in (None, EpochTracer()):
        _, spans, _ = _profiled(tmp_path, lambda: _run(route, tracer))
        assert spans == []
        assert entered == []
    _run(route, EpochTracer(spans=True))  # the counter sees the spans
    assert entered
