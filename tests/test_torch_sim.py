"""Virtual-time simulation of the port (``sim/``): clock, SimBackend,
replay, tuning.

The contract is ``tests/test_sim.py``: its 30 cases run here on the
port's copies (the pool, ``ProcessBackend``, ``EpochTracer``, ``faults``,
``PoolLatencyModel``, ``obs``), with the same bounds. Then the same
traces go through both packages' ``sim``: a JSONL trace written by
either package's ``EpochTracer`` gives equal ``compare`` dicts, equal
``NwaitSweep`` tables and equal ``recommend_nwait`` results in the JAX
package's ``sim`` and the port's (tolerance: none; both are numpy on
the same virtual timeline). The JAX package is imported only inside
those tests, so the spawned workers of the ``ProcessBackend`` case,
which import this module, load neither it nor jax.
"""

import json
import threading
import time

import numpy as np
import pytest

from mpistragglers_jl_tpu_torch import (
    AsyncPool,
    DeadWorkerError,
    ProcessBackend,
    SimBackend,
    VirtualClock,
    WorkerFailure,
    asyncmap,
    waitall,
)
from mpistragglers_jl_tpu_torch.sim import (
    ReplayTrace,
    compare,
    model_delay_fn,
    recommend_nwait,
    replay,
    sweep_code_rate,
    sweep_hedge,
    sweep_nwait,
)
from mpistragglers_jl_tpu_torch.utils import EpochTracer, faults
from mpistragglers_jl_tpu_torch.utils.straggle import PoolLatencyModel


def _echo(i, payload, epoch):
    return np.asarray([i, epoch], dtype=np.int64)


# --------------------------------------------------------------------------
# VirtualClock
# --------------------------------------------------------------------------


class TestVirtualClock:
    def test_time_only_moves_when_advanced(self):
        clock = VirtualClock()
        assert clock.now() == 0.0
        clock.advance(2.5)
        assert clock.now() == 2.5
        clock.run_until(1.0)  # never backwards
        assert clock.now() == 2.5

    def test_events_fire_in_time_then_schedule_order(self):
        clock = VirtualClock()
        fired = []
        clock.call_at(2.0, lambda: fired.append("b"))
        clock.call_at(1.0, lambda: fired.append("a"))
        clock.call_at(2.0, lambda: fired.append("c"))  # ties: schedule order
        clock.call_later(3.0, lambda: fired.append("d"))
        clock.run_until(2.0)
        assert fired == ["a", "b", "c"]
        assert clock.next_event() == 3.0
        clock.run_all()
        assert fired == ["a", "b", "c", "d"] and clock.now() == 3.0

    def test_callback_may_schedule_earlier_followup(self):
        clock = VirtualClock()
        fired = []
        clock.call_at(1.0, lambda: clock.call_later(
            0.5, lambda: fired.append(("follow", clock.now()))
        ))
        clock.call_at(10.0, lambda: fired.append(("late", clock.now())))
        clock.run_all()
        assert fired == [("follow", 1.5), ("late", 10.0)]

    def test_thread_rendezvous_is_deterministic(self):
        """Two registered threads sleeping different cadences interleave
        identically on every run: wake order is virtual-time order, not
        the OS scheduler's mood."""

        def run_once():
            clock = VirtualClock()
            log = []

            def worker(name, period, n):
                clock.register()
                try:
                    for k in range(n):
                        clock.sleep(period)
                        log.append((name, round(clock.now(), 9)))
                finally:
                    clock.unregister()

            ts = [
                threading.Thread(target=worker, args=("a", 0.3, 4)),
                threading.Thread(target=worker, args=("b", 0.5, 3)),
            ]
            clock.expect(2)  # don't advance before both have parked
            for t in ts:
                t.start()
            clock.run_until(2.0)
            for t in ts:
                t.join(timeout=5.0)
            return log

        first = run_once()
        assert first == run_once()  # bit-identical interleaving
        assert first == sorted(first, key=lambda x: x[1])
        assert ("a", 0.3) in first and ("b", 0.5) in first
        assert ("a", 1.2) in first and ("b", 1.5) in first

    def test_unadvanced_sleep_diagnoses_instead_of_hanging(self):
        clock = VirtualClock(stall_timeout=0.05)
        with pytest.raises(RuntimeError, match="never"):
            clock.sleep(1.0)  # nobody will advance: error, not a hang


# --------------------------------------------------------------------------
# SimBackend protocol + determinism
# --------------------------------------------------------------------------


class TestSimBackend:
    def test_protocol_error_contract_matches_slot_backend(self):
        be = SimBackend(_echo, 2, delay_fn=faults.fixed(1.0))
        be.dispatch(0, np.zeros(1), 1)
        with pytest.raises(RuntimeError, match="outstanding"):
            be.dispatch(0, np.zeros(1), 1)
        with pytest.raises(RuntimeError, match="no outstanding"):
            be.wait(1)
        with pytest.raises(ValueError, match="empty"):
            be.wait_any([])
        with pytest.raises(ValueError, match="align"):
            be.wait_any([0], tags=[0, 1])
        with pytest.raises(RuntimeError, match="block forever"):
            be.wait_any([1])  # nothing in flight, unbounded wait
        assert be.test(0) is None  # not yet arrived at vnow=0
        assert be.wait(0, timeout=0.25) is None  # virtual timeout
        assert be.clock.now() == 0.25
        out = be.wait(0)
        assert out.tolist() == [0, 1] and be.clock.now() == 1.0
        be.shutdown()
        with pytest.raises(RuntimeError, match="shut down"):
            be.dispatch(0, np.zeros(1), 2)

    def test_payload_snapshot_survives_caller_mutation(self):
        got = []
        be = SimBackend(
            lambda i, p, e: got.append(p.copy()) or p.sum(), 1
        )
        buf = np.ones(4)
        be.dispatch(0, buf, 1)
        buf[:] = 99.0  # in-flight send must not see this
        be.wait(0)
        assert got[0].tolist() == [1.0, 1.0, 1.0, 1.0]

    def test_wait_any_breaks_ties_by_dispatch_order(self):
        be = SimBackend(_echo, 3, delay_fn=faults.fixed(0.5))
        for i in (2, 0, 1):  # dispatch order != index order
            be.dispatch(i, np.zeros(1), 1)
        winners = []
        for _ in range(3):
            i, _r = be.wait_any([0, 1, 2])
            winners.append(i)
        assert winners == [2, 0, 1]  # identical done_at: dispatch order

    def test_interrupts_abort_instead_of_masquerading_as_faults(self):
        """work_fn runs eagerly on the CALLING thread (unlike the
        thread/process backends), so KeyboardInterrupt must propagate
        out of dispatch — not be swallowed into a WorkerError that
        later blames an innocent simulated worker."""

        def interrupted(i, payload, epoch):
            raise KeyboardInterrupt

        be = SimBackend(interrupted, 2)
        with pytest.raises(KeyboardInterrupt):
            be.dispatch(0, np.zeros(1), 1)

    def test_worker_exception_surfaces_as_worker_failure(self):
        work = faults.failing(_echo, workers=1, epochs=2)
        be = SimBackend(work, 3)
        pool = AsyncPool(3)
        asyncmap(pool, np.zeros(1), be, nwait=3, epoch=1)
        with pytest.raises(WorkerFailure, match="worker 1"):
            asyncmap(pool, np.zeros(1), be, nwait=3, epoch=2)
        # the pool stays recoverable, reference contract
        asyncmap(pool, np.zeros(1), be, nwait=3, epoch=3)
        waitall(pool, be)

    def test_bit_reproducible_arrival_orders(self):
        def run():
            be = SimBackend(
                _echo, 8,
                delay_fn=faults.seeded_lognormal(0.02, 1.0, seed=7),
            )
            pool = AsyncPool(8)
            reps = [
                asyncmap(pool, np.zeros(1), be, nwait=5).copy()
                for _ in range(50)
            ]
            waitall(pool, be)
            order = [(e.worker, e.epoch, e.t_done) for e in be.events]
            return reps, order, be.clock.now()

        r1, o1, t1 = run()
        r2, o2, t2 = run()
        assert all((a == b).all() for a, b in zip(r1, r2))
        assert o1 == o2 and t1 == t2

    def test_virtual_latency_feeds_latency_model(self):
        be = SimBackend(
            _echo, 4, delay_fn=faults.per_worker([0.01, 0.02, 0.03, 0.4])
        )
        pool = AsyncPool(4)
        model = PoolLatencyModel(4)
        for _ in range(3):
            asyncmap(pool, np.zeros(1), be, nwait=4)
            be.observe_into(model)
        means = [w.mean for w in model.workers]
        assert means == pytest.approx([0.01, 0.02, 0.03, 0.4], rel=1e-9)

    def test_model_delay_fn_deterministic_and_prior_for_silent(self):
        model = PoolLatencyModel(3, seed=0)
        rng = np.random.default_rng(0)
        for x in 0.05 + rng.exponential(0.02, 200):
            model.observe(0, x)
        for x in 0.10 + rng.exponential(0.01, 200):
            model.observe(1, x)
        # worker 2 silent
        fn = model_delay_fn(model, seed=3)
        draws = [[fn(w, e) for e in range(50)] for w in range(3)]
        again = [[fn(w, e) for e in range(50)] for w in range(3)]
        assert draws == again  # pure in (seed, worker, epoch)
        assert min(draws[0]) >= 0.05 and min(draws[1]) >= 0.10
        # silent worker draws the pooled prior, not zero
        assert min(draws[2]) >= 0.05
        assert np.mean(draws[2]) == pytest.approx(
            np.mean([np.mean(draws[0]), np.mean(draws[1])]), rel=0.6
        )

    def test_instrumentation_lands_in_shared_obs_plane(self):
        from mpistragglers_jl_tpu_torch.obs import (
            MetricsRegistry,
            SpanRecorder,
            merged_chrome_trace,
        )

        reg = MetricsRegistry()
        spans = SpanRecorder("sim")
        be = SimBackend(
            _echo, 4, delay_fn=faults.per_worker([0.01, 0.02, 0.03, 0.2]),
            registry=reg, spans=spans,
        )
        pool = AsyncPool(4)
        for _ in range(3):
            asyncmap(pool, np.zeros(1), be, nwait=3)
        waitall(pool, be)
        snap = reg.snapshot()

        def val(name):
            return snap[name]["series"][0]["value"]

        assert val("sim_tasks_dispatched_total") == be.n_dispatched
        assert val("sim_tasks_delivered_total") == be.n_delivered
        assert val("sim_virtual_time_seconds") == pytest.approx(
            be.clock.now()
        )
        # simulated worker spans merge into the same Perfetto documents
        # as live fleets (virtual seconds on the time axis)
        doc, n = merged_chrome_trace(recorders=[spans])
        assert n == be.n_delivered
        names = {
            e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"
        }
        assert any(name.startswith("task e") for name in names)


# --------------------------------------------------------------------------
# replay
# --------------------------------------------------------------------------


def _recorded_local_run(tmp_path=None):
    """A small REAL thread-backend run with distinct per-worker speeds
    and one hard straggler, traced; returns (tracer, delays)."""
    from mpistragglers_jl_tpu_torch.backends.local import LocalBackend

    delays = faults.compose(
        faults.per_worker([0.02, 0.05, 0.08, 0.0]),
        faults.straggler(3, 0.6),
    )
    backend = LocalBackend(_echo, 4, delay_fn=delays)
    tracer = EpochTracer()
    pool = AsyncPool(4)
    try:
        for _ in range(5):
            asyncmap(pool, np.zeros(1), backend, nwait=3, tracer=tracer)
        waitall(pool, backend, tracer=tracer)
    finally:
        backend.shutdown()
    return tracer


class TestReplay:
    def test_same_policy_replay_reproduces_fresh_sets(self):
        tracer = _recorded_local_run()
        trace = ReplayTrace.from_tracer(tracer)
        assert trace.n_workers == 4 and len(trace.epochs) == 5
        res = replay(trace)  # recorded nwait
        drift = compare(trace, res)
        assert drift["fresh_exact_rate"] == 1.0
        assert drift["wall_drift_max_s"] < 0.05  # thread-sched overhead
        for snap in trace.epochs:
            assert snap.fresh == frozenset({0, 1, 2})

    def test_jsonl_roundtrip_equals_in_memory(self, tmp_path):
        tracer = _recorded_local_run()
        path = tmp_path / "trace.jsonl"
        tracer.dump_jsonl(path)
        a = replay(ReplayTrace.from_tracer(tracer))
        b = replay(ReplayTrace.from_jsonl(path))
        assert [r["fresh"] for r in a.epochs] == [
            r["fresh"] for r in b.epochs
        ]
        assert a.walls.tolist() == b.walls.tolist()

    def test_chrome_doc_replay_per_label_contract(self, tmp_path):
        tracer = _recorded_local_run()
        path = tmp_path / "trace.json"
        tracer.dump_chrome_trace(path)
        trace = ReplayTrace.from_chrome(str(path))
        res = replay(trace, nwait=3)
        assert compare(trace, res)["fresh_exact_rate"] == 1.0

    def test_chrome_dead_worker_needs_explicit_width(self, tmp_path):
        """Chrome docs only draw ARRIVED tasks, so a worker dead for
        the whole recording has no track and the inferred fleet comes
        up one short — the documented caveat; n_workers= restores the
        true width and the dead rank replays as a missing-stall."""
        be = SimBackend(
            _echo, 3, delay_fn=faults.dead_from(2, 0, delay=100.0)
        )
        tracer = EpochTracer()
        pool = AsyncPool(3)
        for _ in range(2):
            asyncmap(pool, np.zeros(1), be, nwait=2, tracer=tracer)
        path = tmp_path / "dead.json"
        tracer.dump_chrome_trace(path)
        inferred = ReplayTrace.from_chrome(str(path))
        assert inferred.n_workers == 2  # rank 2 invisible: the caveat
        full = ReplayTrace.from_chrome(str(path), n_workers=3)
        assert full.n_workers == 3
        res = replay(full, nwait=2, drain=False)
        assert all(2 not in r["fresh"] for r in res.epochs)

    def test_chrome_doc_without_pool_spans_is_rejected(self):
        doc = {"traceEvents": [
            {"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": "serving"}},
        ]}
        with pytest.raises(ValueError, match="pool"):
            ReplayTrace.from_chrome(doc)

    def test_counterfactual_nwait_changes_the_story(self):
        """The point of the plane: the same incident priced under a
        different policy. nwait=4 must wait out the 0.6 s straggler
        every epoch; the recorded nwait=3 never does."""
        trace = ReplayTrace.from_tracer(_recorded_local_run())
        fast = replay(trace)  # recorded nwait=3
        slow = replay(trace, nwait=4)
        assert fast.summary()["wall_mean_s"] < 0.12
        assert slow.summary()["wall_mean_s"] > 0.5
        assert all(r["fresh"] == frozenset(range(4)) for r in slow.epochs)

    def test_empty_and_callable_nwait_traces_are_refused(self):
        with pytest.raises(ValueError, match="empty"):
            ReplayTrace([])
        rec = {
            "epoch": 1, "call": "asyncmap", "nwait": "<callable>",
            "wall_s": 0.1, "repochs": [1, 1], "latency_s": [0.1, 0.1],
            "events": [],
        }
        trace = ReplayTrace([rec])
        with pytest.raises(ValueError, match="callable"):
            replay(trace)
        # explicit nwait unblocks it
        res = replay(trace, nwait=2)
        assert len(res.epochs) == 1


# --------------------------------------------------------------------------
# tune
# --------------------------------------------------------------------------


class TestTune:
    def test_sweep_dodges_designated_straggler(self):
        sweep = sweep_nwait(
            faults.compose(
                faults.per_worker([0.01] * 7 + [0.0]),
                faults.straggler(7, 1.0),
            ),
            n_workers=8, epochs=30, floor=2,
        )
        assert sweep.best == 7  # everyone but the straggler
        assert sweep.entry(8)["mean_epoch_s"] == pytest.approx(1.0)
        assert sweep.entry(7)["mean_epoch_s"] == pytest.approx(0.01)
        assert "<- best" in sweep.table()

    def test_floor_is_enforced_not_clamped(self):
        delay = faults.fixed(0.01)
        with pytest.raises(ValueError, match="decodability floor"):
            sweep_nwait(
                delay, n_workers=4, floor=3, nwait_values=[2, 3, 4],
            )
        sweep = sweep_nwait(delay, n_workers=4, floor=3, epochs=5)
        assert sweep.best >= 3
        assert all(r["nwait"] >= 3 for r in sweep.entries)

    def test_code_rate_sweep_prices_recovered_work(self):
        """6 fast workers + 2 slow: k=6 recovers the most work per
        virtual second; k=8 pays the stragglers, k=2 wastes capacity."""
        sweep = sweep_code_rate(
            faults.compose(
                faults.per_worker([0.01] * 6 + [0.0] * 2),
                faults.straggler((6, 7), 0.8),
            ),
            n_workers=8, k_values=[2, 4, 6, 8], epochs=20,
        )
        assert sweep.best == 6

    def test_hedge_sweep_recommends_narrowest_tail_free_width(self):
        res = sweep_hedge(
            lambda i, e: 0.3 if (e + i) % 4 == 0 else 0.01,
            n_workers=4, widths=[1, 2, 3], requests=16,
        )
        by_w = {r["width"]: r for r in res["entries"]}
        assert by_w[1]["p95_latency_s"] > 0.25  # eats stalls
        assert by_w[2]["p95_latency_s"] == pytest.approx(0.01)
        assert res["recommended_width"] == 2  # width 3 buys nothing

    def test_trace_source_resolves_pool_size(self):
        trace = ReplayTrace.from_tracer(_recorded_local_run())
        # floor 3 = an (n=4, k=3) code: the sweep prices nwait 3 vs 4
        # on the recorded incident and dodges the 0.6 s straggler
        sweep = sweep_nwait(trace, epochs=5, floor=3)
        assert sweep.best == 3
        assert sweep.entry(4)["mean_epoch_s"] > 5 * (
            sweep.entry(3)["mean_epoch_s"]
        )
        with pytest.raises(TypeError, match="latency source"):
            sweep_nwait(object(), n_workers=4)


# --------------------------------------------------------------------------
# straggle.py contract the tuner leans on (determinism fix)
# --------------------------------------------------------------------------


def test_optimal_nwait_is_deterministic_across_calls():
    """The fixed failure: a shared RNG advanced across calls, so two
    identical ``optimal_nwait`` calls could disagree near a utility
    tie. Predictions are now pure functions of (fitted state, seed)."""
    model = PoolLatencyModel(6, seed=11)
    rng = np.random.default_rng(1)
    for i in range(6):
        for x in 0.01 * (i + 1) + rng.exponential(0.02, 40):
            model.observe(i, x)
    draws = model.sample_latencies(256)
    assert (draws == model.sample_latencies(256)).all()
    picks = {model.optimal_nwait() for _ in range(5)}
    assert len(picks) == 1
    times = {model.expected_epoch_time(4) for _ in range(5)}
    assert len(times) == 1


# --------------------------------------------------------------------------
# acceptance: the end-to-end chain
# --------------------------------------------------------------------------


class _AcceptanceDelays:
    """Picklable (module-level class) for ProcessBackend workers:
    distinct fast speeds + one hard straggler on rank 3."""

    BASE = (0.05, 0.08, 0.11, 0.0)

    def __call__(self, i, epoch):
        return 0.6 if i == 3 else self.BASE[i]


def _proc_work(i, payload, epoch):
    return np.asarray([i, epoch], dtype=np.int64)


class TestEndToEnd:
    def test_process_backend_record_replay_fresh_sets_exact(self):
        """Record a 4-worker straggling ProcessBackend run via
        EpochTracer; replay through SimBackend with the same nwait;
        per-epoch fresh-worker sets reproduce EXACTLY and epoch
        latencies land within tolerance of the recorded walls."""
        backend = ProcessBackend(
            _proc_work, 4, delay_fn=_AcceptanceDelays()
        )
        tracer = EpochTracer()
        pool = AsyncPool(4)
        try:
            # one untraced round first, drained: every spawned worker
            # has imported this module and answered once before the
            # traced epochs, so start-up cannot reorder their arrivals
            asyncmap(pool, np.zeros(1), backend, nwait=4, timeout=60.0)
            for _ in range(4):
                asyncmap(
                    pool, np.zeros(1), backend, nwait=3, tracer=tracer
                )
            waitall(pool, backend, tracer=tracer, timeout=30.0)
        finally:
            backend.shutdown()
        trace = ReplayTrace.from_tracer(tracer)
        # the trace starts after the warm-up: replay keys on the
        # recorded epoch numbers, whatever the first one is
        assert [s.epoch for s in trace.epochs] == [2, 3, 4, 5]
        res = replay(trace)  # same (recorded) nwait
        drift = compare(trace, res)
        assert drift["epochs"] == 4
        assert drift["fresh_exact_rate"] == 1.0, (trace.epochs, res.epochs)
        # recorded walls carry real process/pickle overhead the
        # injected delays cannot; the drift bound is the honest claim
        assert drift["wall_drift_max_s"] < 0.12, drift

    def test_autotuner_agrees_with_model_optimal_nwait(self):
        """A seeded-lognormal fleet (6 fast workers, 2 heavy
        stragglers) is fitted into a PoolLatencyModel; the sim
        autotuner — running the REAL pool loop on virtual time —
        recommends the same nwait as the model's analytic
        ``optimal_nwait``, and so does a sweep over the RAW lognormal
        fleet (not the fitted model), so the agreement is not an
        artifact of sharing distributions."""
        n = 8
        # a pronounced service floor (tight lognormal around 50 ms)
        # makes the utility landscape sharply peaked at k=6: waiting
        # for all six fast workers amortizes the floor, the two 1 s
        # stragglers poison anything deeper — every estimator must
        # land on 6, regardless of its tail family
        fleet = faults.compose(
            faults.seeded_lognormal(0.05, 0.05, seed=5),
            faults.straggler((6, 7), 1.0),
        )
        model = PoolLatencyModel(n, seed=2)
        for e in range(150):
            for i in range(n):
                model.observe(i, fleet(i, e))
        rec = recommend_nwait(model, floor=2, epochs=200, seed=9)
        assert rec["agree"], rec
        assert rec["sim_nwait"] == model.optimal_nwait(kmin=2) == 6
        raw = sweep_nwait(fleet, n_workers=n, epochs=120, floor=2)
        assert raw.best == 6

    # The virtual-to-wall speedup claim IS a wall-clock measurement
    # (the sanctioned kind: a GROSS ceiling on how much real time the
    # simulator may burn — the old < 2.0 s bound had ~6% headroom over
    # the ~1.9 s baseline on a loaded dev box, i.e. it was itself the
    # flake class GC008 exists to kill).
    # graftcheck: real-smoke
    def test_1k_epochs_wall_bounded_bit_identical(self):
        """Real pool.py code on the virtual clock: 1k epochs of a
        16-worker lognormal fleet well inside a 10 s gross wall
        ceiling, repochs bit-identical across two runs."""

        def run():
            be = SimBackend(
                _echo, 16,
                delay_fn=faults.seeded_lognormal(0.01, 1.0, seed=3),
            )
            pool = AsyncPool(16)
            reps = [
                asyncmap(pool, np.zeros(1), be, nwait=12).copy()
                for _ in range(1000)
            ]
            waitall(pool, be)
            return np.stack(reps), be.clock.now()

        t0 = time.perf_counter()
        reps1, v1 = run()
        wall = time.perf_counter() - t0
        assert wall < 10.0, f"1k sim epochs took {wall:.2f}s wall"
        reps2, v2 = run()
        assert (reps1 == reps2).all()
        assert v1 == v2
        assert v1 > 10.0  # simulated far more virtual than wall time


# --------------------------------------------------------------------------
# across the packages: one trace, both sims
# --------------------------------------------------------------------------


def _packages(which):
    """(pool module, LocalBackend, EpochTracer, faults, sim, straggle) of
    the port or the JAX package."""
    import importlib

    root = {"port": "mpistragglers_jl_tpu_torch",
            "jax": "mpistragglers_jl_tpu"}[which]
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return (mod("pool"), mod("backends.local").LocalBackend,
            mod("utils.trace").EpochTracer, mod("utils.faults"), mod("sim"),
            mod("utils.straggle"))


def _record_jsonl(which, path):
    """A traced 4-worker thread run in package ``which``, dumped as
    JSONL: three speeds, one hard straggler, nwait 3 then 2."""
    pool_mod, local, tracer_cls, flt, _, _ = _packages(which)
    delays = flt.compose(flt.per_worker([0.01, 0.03, 0.05, 0.0]),
                         flt.straggler(3, 0.15))
    backend = local(_echo, 4, delay_fn=delays)
    tracer = tracer_cls()
    pool = pool_mod.AsyncPool(4)
    try:
        for e in range(5):
            pool_mod.asyncmap(pool, np.zeros(1), backend,
                              nwait=3 if e < 3 else 2, tracer=tracer)
        pool_mod.waitall(pool, backend, tracer=tracer)
    finally:
        backend.shutdown()
    tracer.dump_jsonl(str(path))


def _decisions(which, path):
    """Everything the sim decides from one JSONL trace: replays at the
    recorded and two counterfactual nwaits with their ``compare``
    dicts, an ``NwaitSweep`` table, and ``recommend_nwait`` over a
    latency model fitted to the trace."""
    *_, sim, straggle = _packages(which)
    trace = sim.ReplayTrace.from_jsonl(str(path))
    out = {"n_workers": trace.n_workers,
           "recorded": trace.recorded_nwaits()}
    for nw in (None, 1, 4):
        res = sim.replay(trace, nwait=nw)
        out[f"replay_{nw}"] = [(r["epoch"], r["nwait"], r["wall"],
                                sorted(r["fresh"]), r["n_stale"])
                               for r in res.epochs]
        out[f"compare_{nw}"] = sim.compare(trace, res)
    sweep = sim.sweep_nwait(trace, epochs=60, floor=1)
    out["sweep"] = (sweep.entries, sweep.best)
    model = straggle.PoolLatencyModel(trace.n_workers, seed=2)
    delay = trace.delay_fn()
    for snap in trace.epochs:
        for i in range(trace.n_workers):
            model.observe(i, delay(i, snap.epoch))
    rec = sim.recommend_nwait(model, floor=1, epochs=80, seed=3)
    out["recommend"] = (rec["sim_nwait"], rec["model_nwait"], rec["agree"],
                        rec["sweep"].entries, rec["sweep"].best)
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_one_trace_gives_equal_decisions_in_both_sims(tmp_path, writer):
    path = tmp_path / f"{writer}.jsonl"
    _record_jsonl(writer, path)
    port, ref = _decisions("port", path), _decisions("jax", path)
    assert port["compare_None"]["fresh_exact_rate"] == 1.0
    assert port == ref


def test_router_half_raises_naming_item_12b():
    """The router-day half of ``sim/`` once raised naming item 12b (see
    :func:`test_router_half_runs` for the calls that run now): no source
    file of the port names that item any more, and, with the port's
    plan of work done, no raise in the port names a ROADMAP item."""
    import ast
    import pathlib

    import mpistragglers_jl_tpu_torch as port

    later = []
    for path in pathlib.Path(port.__file__).parent.rglob("*.py"):
        assert "12b" not in path.read_text(), path
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Raise) and node.exc is not None:
                text = " ".join(
                    c.value for c in ast.walk(node.exc)
                    if isinstance(c, ast.Constant)
                    and isinstance(c.value, str))
                if "ROADMAP" in text or "item " in text:
                    later.append((path.name, text))
    assert later == [], later


def test_router_half_runs(tmp_path):
    """Every name of the router-day half runs: ``replay_router_day``
    over a JSONL day (scalar and fast, one digest) and the router,
    tenant-weight, tier-split and spill-capacity sweeps, each returning
    a recommendation."""
    from mpistragglers_jl_tpu_torch import sim
    from mpistragglers_jl_tpu_torch.models.router import RequestRouter
    from mpistragglers_jl_tpu_torch.qos import TenantContract

    path = tmp_path / "day.jsonl"
    sim.dump_arrivals_jsonl(
        sim.poisson_arrivals(60.0, n=300, seed=2, prompt_len=64,
                             max_new=16), path)
    digests = set()
    for fast in ("never", "auto"):
        clock = sim.VirtualClock()
        router = RequestRouter(
            [sim.SimReplica(clock, slots=4, n_inner=8, tick_s=0.02)
             for _ in range(3)], policy="least_loaded", clock=clock)
        rep = sim.replay_router_day(router, path, fast=fast)
        assert rep.n == 300 and rep.dropped == 0
        digests.add(rep.digest())
    assert len(digests) == 1
    assert sim.sweep_router_policy(requests=200, seed=1)["best"] in (
        "round_robin", "least_loaded", "prefix_affinity")
    contracts = [TenantContract("lat", cls="latency", rate=800.0,
                                ttft_slo=2.0),
                 TenantContract("bat", cls="batch", rate=800.0)]
    cands = [{"lat": 1.0, "bat": 1.0}, {"lat": 4.0, "bat": 1.0}]
    assert sim.sweep_tenant_weights(contracts=contracts, candidates=cands,
                                    requests=200)["best"] in cands
    assert sim.sweep_tier_split(splits=[(2, 2)], requests=200)["best"][
        0] == (2, 2)
    assert sim.sweep_spill_capacity(store_groups_candidates=[0, 16],
                                    requests=200)["best"] in (0, 16)
