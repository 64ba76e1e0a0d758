"""The chaos injector: runs an episode with its invariants armed.

A copy of ``mpistragglers_jl_tpu/chaos/injector.py``, not an import of
it (the port never imports the JAX package). Stdlib and numpy, no torch,
and no OS clock: the same seeded inputs give the same records in either
package.

The injector is the piece that makes a scenario an EPISODE: it builds
the scenario's day on a fresh :class:`~..sim.clock.VirtualClock`,
installs the pinned survival invariants as clock-scheduled probes that
check INSIDE the run (a violation raises
:class:`~.report.InvariantViolation` at the virtual instant it is
seen, while the flight recorder still holds the story), drives the day
through the real :func:`~..sim.workload.run_router_day`, runs the
scenario's own post-checks, and assembles the
:class:`~.report.ChaosReport` whose digest is the replay witness.

In-run invariants (the probe chain, every ``probe_every_s`` virtual
seconds):

* **no deadlock** — completions (or named sheds) must advance within
  ``stall_s`` of virtual time whenever requests are in flight;
* **no unbounded queue** — fleet queued depth stays at or under the
  scenario's pinned ceiling, sampled independently of the shed logic
  that enforces it.

Post-run invariants (battery + scenario ``post``):

* **shed-by-name** — every shed request carries a non-empty reason
  (tests/test_torch_imports.py pins the same contract statically);
* **zero drops** — shed is the only sanctioned loss;
* **flight capture** — with ``flight=`` attached, the episode's
  shed/partition instants are ON the ring at episode end
  (:meth:`~..obs.flight.FlightRecorder.instants`).

Observability is strictly opt-in (the package-wide opt-in contract):
``registry=`` exports ``chaos_episodes_total{scenario}``,
``chaos_invariant_probes_total{scenario}``, and a per-scenario
``chaos_max_queue_depth`` gauge; ``flight=`` stamps "chaos episode"
begin/end instants around the run. Both are also handed to the
scenario's router so the episode's shed/partition/hedge instants land
on the same ring. Dark, the injector pays only ``is None`` checks.
"""

from __future__ import annotations

from .report import ChaosReport, InvariantViolation
from .scenarios import ChaosScenario

__all__ = ["ChaosInjector"]


class ChaosInjector:
    """Runs :class:`~.scenarios.ChaosScenario` episodes
    (module docstring for the invariant battery).

    >>> inj = ChaosInjector()
    >>> report = inj.run(get_scenario("retry_storm", seed=7))
    >>> report.digest()     # the replay witness
    """

    def __init__(self, *, registry=None, flight=None, trace=None,
                 series=None, slo=None):
        self.registry = registry
        self.flight = flight
        self.trace = trace
        # windowed SLO plane: series/slo ride the day's
        # drive loop (digest-neutral rollover), and an attached slo
        # arms the alert-timeline invariant — every fired fast-burn
        # alert must clear by episode end (the storm recovers), and
        # the alert counts fold into the report digest
        self.series = series
        self.slo = slo

    # -- episode drive ----------------------------------------------------

    def run(self, scenario: ChaosScenario) -> ChaosReport:
        if not isinstance(scenario, ChaosScenario):
            raise TypeError(
                f"run() takes a ChaosScenario, got {type(scenario)!r}"
                " — build one via chaos.get_scenario(name, seed=...)"
            )
        if scenario.kind == "pool":
            return self._run_pool(scenario)
        return self._run_day(scenario)

    def _run_pool(self, scenario: ChaosScenario) -> ChaosReport:
        from ..sim.clock import VirtualClock

        clock = VirtualClock()  # pool episodes never read a clock;
        # built for interface symmetry (and future paced variants)
        built = scenario.build(
            clock, registry=self.registry, flight=self.flight
        )
        if self.flight is not None:
            self.flight.event(
                "chaos episode", src="chaos", t=0.0,
                scenario=scenario.name, phase="begin",
            )
        probes = [0]

        def check(step: int) -> None:
            probes[0] += 1

        extras = built["pool_run"](check)
        report = ChaosReport(
            scenario.name, scenario.seed, n_probes=probes[0],
            invariants=(
                "allocator_invariants", "drains_to_baseline",
            ),
            extras=extras,
        )
        self._emit(scenario, report)
        return report

    def _run_day(self, scenario: ChaosScenario) -> ChaosReport:
        from ..sim.clock import VirtualClock
        from ..sim.workload import run_router_day

        clock = VirtualClock()
        built = scenario.build(
            clock, registry=self.registry, flight=self.flight
        )
        router = built["router"]
        if self.trace is not None:
            # arm request-scoped causal tracing for the whole episode:
            # the post-run battery then runs the conservation audit
            # over every trace the day minted
            router.attach_trace(self.trace)
        if self.flight is not None:
            self.flight.event(
                "chaos episode", src="chaos", t=clock.now(),
                scenario=scenario.name, phase="begin",
            )

        # the in-run probe chain: queue ceiling + progress, sampled on
        # the virtual clock every probe_every_s (the chain reschedules
        # itself; entries left pending when the day drains are
        # abandoned with the clock)
        state = {
            "max_depth": 0, "probes": 0,
            "last_done": 0, "last_progress_t": 0.0,
        }
        ceiling = scenario.queue_ceiling
        stall_s = scenario.stall_s
        every = scenario.probe_every_s

        def probe():
            now = clock.now()
            d = router.queue_depth
            if d > state["max_depth"]:
                state["max_depth"] = d
            if ceiling is not None and d > ceiling:
                raise InvariantViolation(
                    f"unbounded queue: fleet depth {d} over the "
                    f"pinned ceiling {ceiling} at t={now:.3f} "
                    f"({scenario.name})"
                )
            done = router.n_completed
            if done != state["last_done"]:
                state["last_done"] = done
                state["last_progress_t"] = now
            elif (
                router.in_flight > 0
                and now - state["last_progress_t"] > stall_s
            ):
                raise InvariantViolation(
                    f"deadlock: {router.in_flight} requests in "
                    f"flight with no completion for {stall_s:.0f} "
                    f"virtual seconds at t={now:.3f} "
                    f"({scenario.name})"
                )
            state["probes"] += 1
            clock.call_at(now + every, probe)

        clock.call_at(every, probe)

        workload = run_router_day(
            router, built["arrivals"],
            events=built.get("events", ()),
            retry=built.get("retry"),
            series=self.series, slo=self.slo,
        )

        # post-run battery: shed-by-name, zero "silent" loss, flight
        # capture, then the scenario's own expectations
        invariants = ["no_deadlock", "shed_by_name"]
        if ceiling is not None:
            invariants.append("bounded_queue")
        for r in workload.requests:
            if r.outcome == "shed" and not r.shed_reason:
                raise InvariantViolation(
                    f"shed request {r.id} carries no reason (bare "
                    "drop) — every shed must be named"
                )
        if self.flight is not None:
            invariants.append("flight_captured")
            if workload.n_shed and not (
                self.flight.instants("qos shed")
                or self.flight.instants("request shed")
            ):
                raise InvariantViolation(
                    "the episode shed requests but the flight ring "
                    "holds no shed instants: the postmortem story is "
                    "incomplete"
                )
            if workload.n_partitions and not (
                self.flight.instants("replica partitioned")
                and self.flight.instants("partition healed")
            ):
                raise InvariantViolation(
                    "the episode partitioned replicas but the flight "
                    "ring holds no partition instants"
                )
        if self.trace is not None:
            # conservation audit over the episode's traces: every
            # submitted id resolved exactly once, hedge/migration
            # arithmetic closed, report reconciliation exact
            from ..obs.audit import audit as _trace_audit

            res = _trace_audit(
                self.trace, workload, self.registry
            )
            if not res.ok:
                raise InvariantViolation(
                    "trace conservation audit failed: "
                    + "; ".join(
                        f"{f.invariant}: {f.detail}"
                        for f in res.failures
                    )
                )
            invariants.append("trace_conservation")
        extras = {}
        post = built.get("post")
        if post is not None:
            invariants.append("scenario_post")
            extras = post(workload, router) or {}
        if self.slo is not None:
            # alert-timeline invariant: an episode that fired a
            # fast-burn alert must also have cleared it — the storm
            # RECOVERS, and the timeline (pure virtual time) says so
            invariants.append("alert_timeline")
            still = self.slo.fast_burn_firing()
            if still:
                raise InvariantViolation(
                    f"episode ended with fast-burn alert(s) {still} "
                    "still firing: the storm never recovered "
                    f"({scenario.name})"
                )
            counts = self.slo.alert_counts()
            extras = dict(extras)
            extras["slo_alerts_fired"] = counts["fired"]
            extras["slo_alerts_cleared"] = counts["cleared"]
        report = ChaosReport(
            scenario.name, scenario.seed, workload=workload,
            max_queue_depth=state["max_depth"],
            n_probes=state["probes"],
            invariants=tuple(invariants), extras=extras,
        )
        self._emit(scenario, report)
        return report

    # -- observability (opt-in, ``is None`` guards) ----------------------

    def _emit(self, scenario: ChaosScenario,
              report: ChaosReport) -> None:
        if self.registry is not None:
            self.registry.counter(
                "chaos_episodes_total", scenario=scenario.name,
                help="chaos episodes completed with all invariants "
                "held",
            ).inc()
            self.registry.counter(
                "chaos_invariant_probes_total",
                scenario=scenario.name,
                help="in-run invariant probes fired",
            ).inc(report.n_probes)
            self.registry.gauge(
                "chaos_max_queue_depth", scenario=scenario.name,
                help="peak fleet queue depth seen by the probes",
            ).set(report.max_queue_depth)
        if self.flight is not None:
            self.flight.event(
                "chaos episode", src="chaos",
                t=(
                    report.workload.virtual_s
                    if report.workload is not None else 0.0
                ),
                scenario=scenario.name, phase="end",
                digest=report.digest(),
            )
