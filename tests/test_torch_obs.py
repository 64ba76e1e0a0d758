"""The port's observability plane (mpistragglers_jl_tpu_torch/obs/,
utils/trace.py, and the instrumented scheduler, coded GEMM and coded
trainer) against the JAX package's, JAX on the CPU.

* Scripted events, with every timestamp passed in (or the clock
  replaced by one fake sequence for the pool tracer), go to both
  packages' copies; Prometheus text, JSON, Chrome-trace dicts, TraceBook
  waterfalls, audit results and SLO alert timelines must be identical.
* Both schedulers serve one seeded workload with a registry and a
  TraceBook: every counter that does not read the clock ends equal, and
  so do each request's event kinds.
* The ObsServer routes are compared over loopback (port 0, bounded
  timeouts, no sleeps).
* ``CodedGemm(registry=)`` and ``CodedGradTrainer(registry=, spans=)``
  give the reference's series at ``nwait = n``.
"""

import json
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpistragglers_jl_tpu.obs as jobs
import mpistragglers_jl_tpu_torch.obs as tobs
from mpistragglers_jl_tpu import AsyncPool as RefPool
from mpistragglers_jl_tpu import asyncmap as ref_asyncmap
from mpistragglers_jl_tpu import waitall as ref_waitall
from mpistragglers_jl_tpu.models import coded_train as jct
from mpistragglers_jl_tpu.models import serving as js
from mpistragglers_jl_tpu.models import transformer as jt
from mpistragglers_jl_tpu.ops import coded_gemm as jcg
from mpistragglers_jl_tpu.utils import trace as jtrace
from mpistragglers_jl_tpu_torch import AsyncPool, asyncmap, waitall
from mpistragglers_jl_tpu_torch.models import coded_train as tct
from mpistragglers_jl_tpu_torch.models import serving as ts
from mpistragglers_jl_tpu_torch.models import transformer as tt
from mpistragglers_jl_tpu_torch.ops import coded_gemm as tcg
from mpistragglers_jl_tpu_torch.utils import trace as ttrace

CPU = [torch.device("cpu")]
PKGS = ((jobs, jtrace), (tobs, ttrace))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# scripted events: byte-identical outputs
# --------------------------------------------------------------------------


def _registry(obs):
    reg = obs.MetricsRegistry()
    reg.counter("serving_tokens_total", help="tokens").inc(17)
    reg.counter("serving_retired_total", reason="eos").inc(2)
    reg.counter("serving_retired_total", reason="length").inc(5)
    g = reg.gauge("serving_queue_depth", help='depth "now"\nsecond line')
    g.set(3)
    g.dec(1)
    h = reg.histogram("serving_ttft_seconds", help="ttft")
    for v in (1e-7, 3e-4, 0.02, 0.5, 7.0, 250.0):
        h.observe(v)
    reg.histogram("custom_seconds", buckets=(0.1, 1.0, 10.0),
                  route="kernel").observe(0.3)
    reg.gauge("label_escape", path='a\\b"c').set(-2.5)
    return reg


def _spans(obs):
    rec = obs.SpanRecorder("serving")
    rec.add("tick 1", 10.0, 0.25, track="scheduler", queue=2, tokens=8)
    rec.add("admit", 10.0, 0.05, track="scheduler")
    rec.add("decode", 10.05, 0.2, track="scheduler")
    rec.count("queue_depth", 2, t=10.25)
    rec.count("active_slots", 1, t=10.25)
    rec.add("negative", 11.0, -1.0, track="other")  # clamps at 0
    return rec


def _book(obs):
    book = obs.TraceBook()
    a, b, c = book.mint(), book.mint(), book.mint()
    book.event(a, "submitted", 1.0, tenant=None, prompt=12)
    book.event(a, "admitted", 1.1, tick=1)
    book.event(a, "prefill_chunk", 1.2, tick=1)
    book.event(a, "first_token", 1.3, tick=1)
    book.event(a, "retired", 2.0, outcome="length", tokens=8)
    book.event(b, "submitted", 1.5, prompt=3)
    book.event(b, "cancelled", 1.9, tick=2)
    d = book.mint(parent=b)
    book.event(d, "submitted", 2.1, prompt=3)
    book.event(d, "first_token", 2.4, tick=3)
    book.event(d, "retired", 3.0, outcome="eos", tokens=2)
    book.event(c, "submitted", 2.2, prompt=5)
    return book


def _flight(obs):
    fl = obs.FlightRecorder(capacity=4)  # small: eviction is exercised
    fl.span("tick 1", 1.0, 0.5, src="scheduler", track="scheduler",
            queue=1)
    fl.event("respawn", src="pool", t=1.2, rank=3)
    fl.counter("serving_ticks_total", 1, src="scheduler", t=1.5)
    fl.counter("serving_ticks_total", 4, src="scheduler", t=2.5)
    fl.span("tick 2", 2.0, 0.5, src="scheduler", track="scheduler")
    fl.event("deadline", t=3.0)
    return fl


def _fake_clock(monkeypatch):
    """A perf_counter that steps 1 ms per read from 100 s."""
    state = {"t": 100.0}

    def now():
        state["t"] += 1e-3
        return state["t"]

    monkeypatch.setattr(time, "perf_counter", now)
    return state


class _Pool:
    repochs = np.array([3, 2, 3])
    latency = np.array([0.1, 0.2, 0.3])


def _tracer(trace_mod):
    tr = trace_mod.EpochTracer()
    tr.begin("asyncmap", 3, 2)
    for i in range(3):
        tr.dispatch(i, 3)
    tr.arrival(0, 3, fresh=True)
    tr.arrival(1, 2, fresh=False)
    tr.dispatch(1, 3, retask=True)
    tr.arrival(2, 3, fresh=True)
    tr.end(_Pool())
    tr.begin("waitall", 3, 1)
    tr.arrival(1, 3, fresh=True)
    tr.end(_Pool())
    return tr


def test_metrics_exports_are_byte_identical():
    regs = [_registry(obs) for obs, _ in PKGS]
    assert regs[0].to_prometheus() == regs[1].to_prometheus()
    assert regs[0].to_json() == regs[1].to_json()
    assert regs[0].to_json(indent=2) == regs[1].to_json(indent=2)
    assert regs[0].snapshot() == regs[1].snapshot()


def test_chrome_traces_waterfalls_and_audits_are_identical(monkeypatch):
    docs, tracers = [], []
    for obs, trace_mod in PKGS:
        state = _fake_clock(monkeypatch)
        tracers.append(_tracer(trace_mod))
        state["t"] = 100.0
        docs.append(obs.merged_chrome_trace(
            tracers=[tracers[-1]], recorders=[_spans(obs)]))
    monkeypatch.undo()
    assert docs[0] == docs[1]
    assert json.dumps(docs[0][0]) == json.dumps(docs[1][0])
    assert tracers[0].summary() == tracers[1].summary()
    books = [_book(obs) for obs, _ in PKGS]
    for tid in books[0].ids():
        assert books[0].waterfall(tid) == books[1].waterfall(tid)
        assert books[0].cohort(tid) == books[1].cohort(tid)
    assert list(books[0].iter_events()) == list(books[1].iter_events())
    assert books[0].chrome_events() == books[1].chrome_events()
    assert books[0].audit_view() == books[1].audit_view()
    regs = [obs.MetricsRegistry() for obs, _ in PKGS]
    for reg in regs:
        reg.counter("serving_tokens_total").inc(10)  # = 8 + 2 retired
    results = [obs.audit(book, None, reg)
               for (obs, _), book, reg in zip(PKGS, books, regs)]
    assert results[0].to_dict() == results[1].to_dict()
    assert results[0].ok
    for reg in regs:
        reg.counter("serving_tokens_total").inc(1)  # drift
    results = [obs.audit(book, None, reg)
               for (obs, _), book, reg in zip(PKGS, books, regs)]
    assert results[0].to_dict() == results[1].to_dict()
    assert not results[0].ok
    flights = [_flight(obs) for obs, _ in PKGS]
    assert flights[0].snapshot() == flights[1].snapshot()
    assert flights[0].evicted == flights[1].evicted == 2


def test_slo_alert_timelines_are_identical():
    """tests/test_series_slo.py's blip-then-burn day on both copies."""
    timelines = []
    for obs, _ in PKGS:
        reg = obs.MetricsRegistry()
        series = obs.SeriesStore(reg, window_s=1.0, max_windows=64)
        fl = obs.FlightRecorder(capacity=256)
        slo = obs.SloPolicy(series, [
            obs.SloObjective("ttft-p99", "latency", 0.5, q=0.99,
                             fast_s=2.0, slow_s=6.0, fire_burn=2.0),
            obs.SloObjective("avail", "availability", 0.99, fast_s=2.0,
                             slow_s=6.0, fire_burn=2.0)], flight=fl)
        h = reg.histogram("router_ttft_seconds")
        served = reg.counter("router_requests_total", policy="p",
                             replica="0", outcome="ok")
        shed = reg.counter("router_shed_total", reason="overload")
        slo.maybe_roll(0.0)
        for t, bad, good in [(1.0, 0, 100), (2.0, 0, 100), (3.0, 5, 95),
                             (4.0, 50, 50), (5.0, 50, 50), (6.0, 50, 50),
                             (7.0, 0, 100), (8.0, 0, 100)]:
            for _ in range(bad):
                h.observe(5.0)
            for _ in range(good):
                h.observe(0.01)
            served.inc(good)
            shed.inc(bad // 10)
            slo.maybe_roll(t)
        timelines.append((slo.timeline, slo.to_doc(), series.to_doc(),
                          fl.snapshot(), slo.ledger()))
    assert timelines[0] == timelines[1]
    assert any(e["phase"] == "fire" for e in timelines[0][0])


# --------------------------------------------------------------------------
# the instrumented schedulers: clock-free counters and event kinds
# --------------------------------------------------------------------------

FIELDS = dict(vocab=61, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
              d_ff=128, attn_window=16)
CLOCK_FREE = ("serving_slots", "serving_ticks_total", "serving_tokens_total",
              "serving_admitted_total", "serving_retired_total",
              "serving_prefill_chunks_total", "serving_kernel_route_total",
              "serving_prefix_share_hits_total", "serving_cow_copies_total",
              "serving_cache_pages_free", "serving_cache_pages_used",
              "serving_queue_depth", "serving_active_slots")


def _clock_free(reg) -> dict:
    snap = reg.snapshot()
    out = {k: v for k, v in snap.items() if k in CLOCK_FREE}
    for name in ("serving_ttft_seconds", "serving_intertoken_seconds",
                 "serving_tick_seconds"):  # counts only, not the times
        out[name] = [s["value"]["count"] for s in snap[name]["series"]]
    return out


def _workload(mod, params, cfg, paged, temperature, keys, **kw):
    reg, book = mod_obs(mod).MetricsRegistry(), mod_obs(mod).TraceBook()
    rec = mod_obs(mod).SpanRecorder("serving")
    sched = mod.ServingScheduler(
        params, cfg, slots=2, n_inner=4, prompt_chunk=8, max_prompt=32,
        quantize_kv=True, temperature=temperature, page_tokens=paged,
        registry=reg, spans=rec, trace=book, **kw)
    rng = np.random.default_rng(1)
    system = rng.integers(1, FIELDS["vocab"], 8)
    reqs = []
    for i, n in enumerate((4, 6, 2, 9, 3)):
        p = np.concatenate([system, rng.integers(1, FIELDS["vocab"], n)])
        reqs.append(sched.submit(p, 6 + 3 * i, **(
            {} if keys is None else {"key": keys[i]})))
        sched.step()
    doomed = sched.submit(system, 4)
    sched.step()
    sched.cancel(doomed)
    sched.run()
    kinds = [book.kinds(t) for t in book.ids()]
    return reg, book, rec, sched, [r.tokens for r in reqs], kinds


def mod_obs(mod):
    return jobs if mod is js else tobs


@pytest.mark.parametrize("paged,temperature", [(None, 0.0), (4, 0.0),
                                               (4, 0.7)])
def test_instrumented_schedulers_count_alike(paged, temperature,
                                             monkeypatch):
    jcfg = jt.TransformerConfig(**FIELDS, dtype=jnp.float32)
    tcfg = tt.TransformerConfig(**FIELDS, dtype=torch.float32)
    monkeypatch.setattr(js.Request, "_next_id", 0)
    monkeypatch.setattr(ts.Request, "_next_id", 0)
    want = _workload(js, jt.init_params(jcfg, 0), jcfg, paged, temperature,
                     None)
    got = _workload(ts, tt.init_params(tcfg, 0, device="cpu"), tcfg, paged,
                    temperature, None, device="cpu")
    assert got[4] == want[4]  # the streams
    assert got[5] == want[5]  # each request's event kinds, in order
    assert _clock_free(got[0]) == _clock_free(want[0])
    reg, book, rec, sched = got[:4]
    assert reg.counter("serving_tokens_total").value == sum(
        len(t) for t in got[4])
    if paged:
        assert sched.pool.share_hits > 0 and sched.pool.cow_copies > 0
        assert any("cow_copy" in k for k in got[5])
    assert "cancelled" in got[5][-1]
    res = tobs.audit(book, None, reg)
    assert res.ok, res.to_dict()
    assert res.to_dict() == jobs.audit(want[1], None, want[0]).to_dict()
    names = [s[1] for s in rec.spans]
    assert names == [s[1] for s in want[2].spans]
    assert sched.last_tick_at is not None


def test_dark_scheduler_reads_no_clock(monkeypatch):
    tcfg = tt.TransformerConfig(**FIELDS, dtype=torch.float32)
    params = tt.init_params(tcfg, 0, device="cpu")
    sched = ts.ServingScheduler(params, tcfg, slots=2, n_inner=4,
                                prompt_chunk=8, max_prompt=32,
                                device="cpu")
    sched.submit(np.arange(1, 6), 5)

    def boom():
        raise AssertionError("a dark tick read the clock")

    monkeypatch.setattr(time, "perf_counter", boom)
    sched.run()
    assert sched.last_tick_at is None and sched._obs is None


def test_flight_and_exporter_stamp_ticks():
    tcfg = tt.TransformerConfig(**FIELDS, dtype=torch.float32)
    params = tt.init_params(tcfg, 0, device="cpu")
    fl = tobs.FlightRecorder(capacity=64)
    srv = tobs.ObsServer()
    sched = ts.ServingScheduler(params, tcfg, slots=2, n_inner=4,
                                prompt_chunk=8, max_prompt=32, flight=fl,
                                exporter=srv, device="cpu")
    sched.submit(np.arange(1, 6), 5)
    sched.run()
    assert sched.last_tick_at is not None
    ticks = [e for e in fl.snapshot()["traceEvents"]
             if e.get("name", "").startswith("tick ")]
    assert len(ticks) == sched.tick_count
    ok, doc = srv.healthz()
    assert ok and "scheduler" in doc["checks"]


# --------------------------------------------------------------------------
# the HTTP routes over loopback
# --------------------------------------------------------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_obs_server_routes_match_over_loopback():
    bodies = []
    for obs, _ in PKGS:
        srv = obs.ObsServer(_registry(obs), flight=_flight(obs))
        srv.add_recorder(_spans(obs))
        srv.add_tracebook(_book(obs))
        srv.add_health("always", lambda: (True, "fine"))
        with srv:
            out = {}
            for path in ("/metrics", "/metrics.json", "/trace",
                         "/trace/0", "/trace/3", "/trace/99", "/audit",
                         "/flight", "/nowhere"):
                out[path] = _get(srv.url + path)
            code, body = _get(srv.url + "/healthz")
            checks = json.loads(body)["checks"]
            out["/healthz"] = (code, {n: c["ok"] for n, c in
                                      checks.items()})
        bodies.append(out)
    assert bodies[0] == bodies[1]
    assert bodies[0]["/metrics"][0] == 200
    assert bodies[0]["/audit"][0] == 503  # the scripted book is broken


# --------------------------------------------------------------------------
# coded GEMM and the coded trainer
# --------------------------------------------------------------------------


def _series(reg, skip=()):
    return {k: v for k, v in reg.snapshot().items() if k not in skip}


def test_coded_gemm_registry_matches_the_reference():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((24, 8)).astype(np.float32)
    B = rng.standard_normal((8, 4)).astype(np.float32)
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    ref = jcg.CodedGemm(A, 8, 6, registry=jreg)
    cg = tcg.CodedGemm(A, 8, 6, devices=CPU, registry=treg)
    try:
        jpool, tpool = RefPool(8), AsyncPool(8)
        for _ in range(2):
            ref_asyncmap(jpool, B, ref.backend, nwait=8)
            ref.result(jpool)
            asyncmap(tpool, B, cg.backend, nwait=8)
            cg.result(tpool)
        ref_waitall(jpool, ref.backend)
        waitall(tpool, cg.backend)
    finally:
        ref.backend.shutdown()
        cg.backend.shutdown()
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert treg.counter("coded_gemm_decodes_total").value == 2


TRAIN = dict(vocab=37, d_model=32, n_heads=4, n_layers=2, d_ff=64)


def _chunk(j):
    rng = np.random.default_rng((13, j))
    return rng.integers(0, TRAIN["vocab"], (4, 13)).astype(np.int32)


def test_coded_trainer_registry_and_spans_match_the_reference():
    jcfg = jt.TransformerConfig(**TRAIN)
    tcfg = tt.TransformerConfig(**TRAIN)
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jrec, trec = jobs.SpanRecorder("train"), tobs.SpanRecorder("train")
    jtr, ttr = jtrace.EpochTracer(), ttrace.EpochTracer()
    ref = jct.CodedGradTrainer(
        jct.transformer_chunk_loss(jcfg), jt.init_params(jcfg, seed=1),
        _chunk, 6, 2, tracer=jtr, registry=jreg, spans=jrec)
    tr = tct.CodedGradTrainer(
        tct.transformer_chunk_loss(tcfg), tt.init_params(tcfg, 1, "cpu"),
        _chunk, 6, 2, devices=CPU, tracer=ttr, registry=treg, spans=trec)
    try:
        jp, tp = jt.init_params(jcfg, seed=1), tt.init_params(tcfg, 1,
                                                              "cpu")
        jpool, tpool = RefPool(6), AsyncPool(6)
        for _ in range(2):
            jp = ref.step(jpool, jp, lr=0.1, nwait=6)
            tp = tr.step(tpool, tp, lr=0.1, nwait=6)
        ref_waitall(jpool, ref.backend)
        waitall(tpool, tr.backend)
    finally:
        ref.backend.shutdown()
        tr.backend.shutdown()
    hist = "train_step_seconds"
    assert _series(treg, (hist,)) == _series(jreg, (hist,))
    assert treg.histogram(hist).count == jreg.histogram(hist).count == 2
    assert treg.counter("train_steps_total").value == 2
    strip = [(s[0], s[1], s[4]) for s in trec.spans]  # not the times
    assert strip == [(s[0], s[1], s[4]) for s in jrec.spans]
    # the merged trace carries the pool's worker tracks beside the steps
    doc, n = tobs.merged_chrome_trace(tracers=[ttr], recorders=[trec])
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "thread_name"}
    assert {"train", "worker 0", "worker 5"} <= names, names
    assert n > 0
