"""Cross-process telemetry in the port (``obs/aggregate.py``): the port's
copy of ``tests/test_obs.py`` ``TestAggregation`` and
``TestLiveTelemetryPlane.test_live_scrape_roundtrip``.

The unit cases run the same frames through the port's and the JAX
package's aggregators and require the same merged series (counter and
histogram values are exact; clock offsets and translated span starts
within the reference's 2 ms and 5 ms). The live case is the reference's
acceptance run on the CPU: an ``ObsServer`` over the port's instrumented
``ServingScheduler`` and a straggling ``ProcessBackend`` whose spawned
workers report worker-labelled series; ``/healthz`` flips to 503 when a
worker is killed and back after ``respawn``; ``/trace`` and the
watchdog's flight dump hold one pid per worker process. This module
imports no torch at the top: the spawned workers import it to unpickle
their work function, and stay light.
"""

import json
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import mpistragglers_jl_tpu.obs as jobs
import mpistragglers_jl_tpu_torch.obs as tobs
from mpistragglers_jl_tpu_torch.backends.process import ProcessBackend
from mpistragglers_jl_tpu_torch.pool import AsyncPool, asyncmap, waitall

PKGS = [pytest.param(tobs, id="port"), pytest.param(jobs, id="jax")]


def echo_work(i, payload, epoch):
    return payload * (i + 1)


def _get(url, timeout=10.0):
    """(status, body bytes) for a GET, 4xx/5xx included."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class PerWorkerDelay:
    """Picklable per-worker delay (spawned process workers need a
    module-level class)."""

    def __init__(self, delays):
        self.delays = list(delays)

    def __call__(self, i, epoch):
        return self.delays[i]


class TestAggregation:
    @pytest.mark.parametrize("obs", PKGS)
    def test_counter_deltas_across_respawns(self, obs):
        """Counters stay monotonic across worker restarts: same-boot
        frames add deltas, a new boot's full value adds on top (never
        double-counted, never reset)."""
        reg = obs.MetricsRegistry()
        agg = obs.TelemetryAggregator(reg)
        w = obs.WorkerTelemetry(3)
        w.registry.counter("worker_tasks_total").inc(3)
        agg.merge(3, w.snapshot())
        w.registry.counter("worker_tasks_total").inc(2)
        agg.merge(3, w.snapshot())      # cumulative 5 -> delta 2
        merged = reg.counter("worker_tasks_total", worker="3")
        assert merged.value == 5
        w2 = obs.WorkerTelemetry(3)     # the respawn: fresh boot id
        assert w2.boot != w.boot
        w2.registry.counter("worker_tasks_total").inc(4)
        agg.merge(3, w2.snapshot())
        assert merged.value == 9        # 5 + 4, not 4, not 5
        agg.merge(3, w2.snapshot())     # replayed cumulative: nothing
        assert merged.value == 9

    @pytest.mark.parametrize("obs", PKGS)
    def test_histogram_merges_bucketwise_without_double_count(self, obs):
        reg = obs.MetricsRegistry()
        agg = obs.TelemetryAggregator(reg)
        w = obs.WorkerTelemetry(0)
        for v in (1e-4, 2e-3, 0.3):
            w.registry.histogram("worker_task_seconds").observe(v)
        agg.merge(0, w.snapshot())
        agg.merge(0, w.snapshot())      # same cumulative state: no-op
        h = reg.histogram("worker_task_seconds", worker="0")
        assert h.count == 3
        assert h.sum == pytest.approx(0.3021)
        w.registry.histogram("worker_task_seconds").observe(0.5)
        agg.merge(0, w.snapshot())
        assert h.count == 4

    @pytest.mark.parametrize("obs", PKGS)
    def test_clock_offset_translates_worker_spans(self, obs):
        """A worker whose clock runs 5 s ahead: the min-delay offset
        estimate recovers the skew and its spans land on the
        coordinator axis in the merged recorder; a respawn drops the
        dead incarnation's offset."""
        agg = obs.TelemetryAggregator(obs.MetricsRegistry())
        skew = 5.0
        w = obs.WorkerTelemetry(1)
        agg.note_dispatch(1, seq=7, t=10.0)
        w.span("task e1", 15.002, 0.018)
        frame = w.snapshot(pair=(7, 10.001 + skew, 10.021 + skew))
        agg.merge(1, frame, t_recv_c=10.022)
        assert agg.clock_offset(1) == pytest.approx(skew, abs=2e-3)
        (rec,) = agg.recorders()
        assert rec.process == "worker 1"
        (span,) = rec.spans
        _, name, t0, dur, _ = span
        assert name == "task e1"
        assert t0 == pytest.approx(10.002, abs=5e-3)  # coord axis
        assert dur == pytest.approx(0.018)
        agg.merge(1, obs.WorkerTelemetry(1).snapshot())
        assert agg.clock_offset(1) is None

    @pytest.mark.parametrize("obs", PKGS)
    def test_malformed_frames_are_dropped(self, obs):
        agg = obs.TelemetryAggregator(obs.MetricsRegistry())
        agg.merge(0, {"v": 999})        # wrong version
        agg.merge(0, "not a dict")
        agg.merge(0, {"v": 1, "boot": "b", "spans": [("bad",)]})
        assert agg.frames_merged == 1   # only the version-1 frame
        assert agg.recorders() == []

    def test_frames_cross_between_the_packages(self):
        """A frame of either package's ``WorkerTelemetry`` merges in the
        other's aggregator into the same Prometheus text."""
        frames = []
        for obs in (tobs, jobs):
            w = obs.WorkerTelemetry(2)
            w.boot = "fixed-boot"
            w.task_done(4, 1.0, 1.25, stall=0.5)
            w.task_done(5, 2.0, 2.5, error=True)
            w.registry.gauge("worker_queue", lane="a").set(3)
            frames.append(w.snapshot())
        assert frames[0] == frames[1]
        texts = []
        for obs in (tobs, jobs):
            for frame in frames:
                reg = obs.MetricsRegistry()
                obs.TelemetryAggregator(reg).merge(2, frame)
                texts.append(reg.to_prometheus())
        assert len(set(texts)) == 1
        assert 'worker_tasks_total{worker="2"} 2' in texts[0]


@pytest.fixture(scope="module")
def tiny_serving():
    import torch

    from mpistragglers_jl_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )

    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several test processes
    cfg = TransformerConfig(vocab=37, d_model=32, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=64, attn_window=6,
                            dtype=torch.float32)
    yield cfg, init_params(cfg, 3, device="cpu")
    torch.set_num_threads(n)


def _sched(cfg, params, **kw):
    from mpistragglers_jl_tpu_torch.models.serving import ServingScheduler

    return ServingScheduler(params, cfg, slots=2, n_inner=4, prompt_chunk=8,
                            max_prompt=32, device="cpu", **kw)


def _by_worker(prom: str) -> dict:
    return {
        m.group(1): float(m.group(2))
        for m in re.finditer(
            r'worker_tasks_total\{worker="(\d)"\} ([0-9.]+)', prom)
    }


class TestLiveTelemetryPlane:
    def test_live_scrape_roundtrip(self, tiny_serving, tmp_path):
        """The acceptance run, on the CPU: /metrics mid-run carries
        worker-labelled series that originated in the worker processes;
        /healthz flips 503 when a worker process is killed and recovers
        after respawn; /trace and the watchdog-triggered /flight dump
        load as Chrome/Perfetto JSON with one pid per worker process."""
        cfg, params = tiny_serving
        reg = tobs.MetricsRegistry()
        rec = tobs.SpanRecorder("serving")
        fl = tobs.FlightRecorder()
        srv = tobs.ObsServer(reg, flight=fl).start()
        backend = ProcessBackend(
            echo_work, 3, delay_fn=PerWorkerDelay([0.001, 0.001, 0.25]),
            registry=reg, flight=fl, exporter=srv,
        )
        sched = _sched(cfg, params, registry=reg, spans=rec, flight=fl,
                       exporter=srv)
        try:
            assert srv.port != 0  # port 0 bind resolved
            r = sched.submit(np.arange(1, 6, dtype=np.int32), 6)
            sched.run()
            assert r.finished
            pool = AsyncPool(3)
            # warm-up: every spawned worker has imported torch and
            # answered once, so spawn time is out of the race below and
            # worker 2's delay is the only thing that makes it slow
            asyncmap(pool, np.ones(4), backend, nwait=3, flight=fl)
            waitall(pool, backend, flight=fl)
            assert (pool.repochs == pool.epoch).all()
            warm = _by_worker(_get(srv.url + "/metrics")[1].decode())
            assert set(warm) == {"0", "1", "2"}
            for _ in range(4):
                asyncmap(pool, np.ones(4), backend, nwait=2, flight=fl)
            # mid-run: the straggler is still grinding its last
            # dispatch, yet the fast workers' frames are merged
            status, body = _get(srv.url + "/metrics")
            assert status == 200
            prom = body.decode()
            by_worker = _by_worker(prom)
            assert set(by_worker) >= {"0", "1"}
            assert all(v >= 1 for v in by_worker.values())
            assert all(by_worker[w] > warm[w] for w in ("0", "1"))
            assert "serving_ticks_total" in prom  # coordinator series
            waitall(pool, backend, flight=fl)
            status, body = _get(srv.url + "/metrics")
            assert set(_by_worker(body.decode())) == {"0", "1", "2"}
            status, body = _get(srv.url + "/metrics.json")
            assert status == 200
            assert "worker_tasks_total" in json.loads(body)

            # /healthz: healthy -> kill -> 503 -> respawn -> healthy
            status, body = _get(srv.url + "/healthz")
            assert status == 200 and json.loads(body)["ok"]
            backend._procs[1].terminate()
            deadline = time.perf_counter() + 30.0
            while (1 not in backend.dead_workers()
                   and time.perf_counter() < deadline):
                time.sleep(0.02)
            assert 1 in backend.dead_workers(), (
                "worker 1 death not detected within 30s")
            status, body = _get(srv.url + "/healthz")
            doc = json.loads(body)
            assert status == 503 and not doc["ok"]
            assert "1" in doc["checks"]["pool"]["detail"]
            assert doc["checks"]["pool"]["age_s"] >= 0
            backend.respawn(1)
            status, body = _get(srv.url + "/healthz")
            assert status == 200 and json.loads(body)["ok"]
            asyncmap(pool, np.ones(4), backend, nwait=3)
            waitall(pool, backend)

            # /trace: valid Chrome JSON, one pid per worker process
            status, body = _get(srv.url + "/trace")
            assert status == 200
            trace = json.loads(body)
            procs = {
                e["args"]["name"]: e["pid"] for e in trace["traceEvents"]
                if e.get("ph") == "M" and e["name"] == "process_name"
            }
            workers = {n for n in procs if n.startswith("worker ")}
            assert workers == {"worker 0", "worker 1", "worker 2"}
            assert len({procs[n] for n in workers}) == 3
            assert "serving" in procs
            spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
            assert all(e["dur"] >= 0 for e in spans)
            assert any(e["name"].startswith("task e") for e in spans)

            # the scheduler goes quiet: the watchdog dumps the ring
            dump_path = tmp_path / "flight.json"
            wd = fl.watchdog("scheduler", lambda: sched.last_tick_at,
                             stall_s=0.15, path=str(dump_path))
            deadline = time.perf_counter() + 30.0
            while wd.fired == 0 and time.perf_counter() < deadline:
                time.sleep(0.02)
            assert wd.fired >= 1, "flight watchdog did not fire in 30s"
            fdoc = json.loads(dump_path.read_text())
            fprocs = {
                e["args"]["name"]: e["pid"] for e in fdoc["traceEvents"]
                if e.get("ph") == "M" and e["name"] == "process_name"
            }
            fworkers = {n for n in fprocs if n.startswith("worker ")}
            assert len(fworkers) == 3
            assert len({fprocs[n] for n in fworkers}) == 3
            assert any("watchdog" in e["name"]
                       for e in fdoc["traceEvents"] if e.get("ph") == "I")
            status, body = _get(srv.url + "/flight")
            assert status == 200
            assert json.loads(body)["traceEvents"]
        finally:
            fl.close()
            backend.shutdown()
            srv.close()
