"""FleetController: closed-loop autoscaling with sim-in-the-loop re-coding.

A copy of ``mpistragglers_jl_tpu/fleet/controller.py``, not an import of
it (the port never imports the JAX package). Stdlib and numpy, no torch,
and no OS clock: the same seeded inputs give the same records in either
package.

Every control-plane decision in the system used to be static — fleet
size, (outer rate, inner nwait), router policy were all picked before
the run (ROADMAP item 2). This module closes the loop: a
:class:`FleetController` watches the signals the codebase already
publishes (:mod:`.signals` — the router's queue-depth gauges, the
diurnal arrival-rate estimate, :class:`~..utils.straggle.
PoolLatencyModel` fits) and acts on three planes:

* **autoscale** — grow/shrink the scheduler-replica set against
  hysteresis bands (grow when utilization holds above ``high`` for
  ``dwell_s``, shrink below ``low``; ``cooldown_s`` between resizes).
  Shrink drains through the router's zero-drop eject/re-route path
  (``mark_down`` -> ``_evacuate``): in-flight requests restart on the
  survivors, never drop. Grow restores controller-drained replicas
  (``mark_up``). The worker-pool half of the elastic pair —
  ``pool.reset_worker`` + backend respawn/reap — is
  :class:`~.failover.PoolScaler`.
* **re-code on resize** — each accepted resize re-derives the
  hierarchical code's ``(outer rate, inner nwait)`` via
  :func:`~..sim.tune.sweep_hierarchical` and the router policy via
  :func:`~..sim.tune.sweep_router_policy`, both on VirtualClock twins
  seeded from live fits (:func:`~.signals.resized_model`) — the sim
  plane as the ONLINE decision procedure. A **decision budget**
  (``decision_budget``, in candidate-epochs) bounds the sweep: a
  candidate grid that would overrun falls back to the analytic
  cross-check, ``PoolLatencyModel.optimal_nwait`` (recorded as
  ``fallback=True``). Sweeps REFUSE infeasible candidates by name (the
  ``sweep_nwait`` contract) — the refusal propagates, it is never
  clamped away.
* **survive the coordinator** — :meth:`state_dict` /
  :meth:`load_state` round-trip the whole decision state (active set,
  rate-estimator state, chip-time books, code pair, policy, router
  book summary) through :class:`~.failover.FleetCheckpointer`
  (``utils/coded_checkpoint.py``) on a cadence; a standby adopts via
  :class:`~.failover.ControllerSupervisor`.

Every actioned decision lands in the :class:`~..obs.flight.
FlightRecorder` (trigger signal, candidate set, chosen action, sweep
digest) and, opt-in, in the registry: ``fleet_resizes_total
{direction,reason}``, ``fleet_size`` / ``fleet_target_size`` gauges,
``fleet_decision_seconds``, ``fleet_failovers_total``.

Wall-clock purity (tests/test_torch_imports.py covers ``fleet/``): the
controller reads ONLY its injected ``clock`` — a
:class:`~..sim.clock.VirtualClock` in sim and tier-1, any ``.now()``
object live (pass ``timer=time.perf_counter`` from the call site to put
real seconds in the decision histogram; the controller itself never
imports the OS clock).
"""

from __future__ import annotations

import hashlib
import json
import math
from typing import Any, Callable

import numpy as np

from .signals import (
    ArrivalRateEstimator,
    FleetSignals,
    fleet_signals,
    resized_model,
)

__all__ = ["FleetController", "FleetDecision"]

_EPS = 1e-12


def _sweep_digest(entries) -> str:
    """Content hash of a sweep's entry table (floats rounded so the
    digest is stable across platforms' repr choices) — the decision
    record's pointer back to the evidence."""

    def clean(v):
        if isinstance(v, float):
            return round(v, 9)
        if isinstance(v, dict):
            return {k: clean(x) for k, x in sorted(v.items())}
        if isinstance(v, (list, tuple)):
            return [clean(x) for x in v]
        return v

    payload = json.dumps(clean(list(entries)), sort_keys=True,
                         default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:12]


class FleetDecision:
    """One actioned control-plane decision: what triggered it, what the
    signals read, the candidate set considered, what was chosen, and
    the sweep evidence digest. ``to_dict`` is the flight-recorder /
    postmortem form."""

    __slots__ = (
        "seq", "t", "action", "reason", "signal", "size_before",
        "size_after", "target_size", "moved", "recode", "policy",
        "decision_s",
    )

    def __init__(self, seq, t, action, reason, signal: FleetSignals,
                 size_before, size_after, target_size, moved):
        self.seq = int(seq)
        self.t = float(t)
        self.action = str(action)       # "grow" | "shrink" | "failover"
        self.reason = str(reason)
        self.signal = signal
        self.size_before = int(size_before)
        self.size_after = int(size_after)
        self.target_size = int(target_size)
        self.moved = list(moved)        # replica indices acted on
        self.recode: dict | None = None
        self.policy: dict | None = None
        self.decision_s = 0.0

    def to_dict(self) -> dict:
        d = {
            "seq": self.seq, "t": round(self.t, 9),
            "action": self.action, "reason": self.reason,
            "signal": self.signal.to_dict(),
            "size": [self.size_before, self.size_after],
            "target_size": self.target_size, "moved": self.moved,
        }
        if self.recode is not None:
            d["recode"] = self.recode
        if self.policy is not None:
            d["policy"] = self.policy
        return d

    def __repr__(self) -> str:
        return (
            f"FleetDecision(#{self.seq} t={self.t:.3f} {self.action} "
            f"{self.size_before}->{self.size_after} [{self.reason}])"
        )


class _FleetObs:
    """Instrument bundle resolved once at construction (the _RouterObs
    discipline): the decision path only increments. Dark controllers
    pay only ``is None`` checks (opt-in)."""

    def __init__(self, registry, flight):
        self.flight = flight
        self._r = registry is not None
        if not self._r:
            self.registry = None
            return
        self.registry = registry
        self._resizes: dict[tuple[str, str], Any] = {}
        self.m_size = registry.gauge(
            "fleet_size",
            help="replicas currently provisioned by the controller",
        )
        self.m_target = registry.gauge(
            "fleet_target_size",
            help="controller's most recent sizing target",
        )
        self.m_decision_s = registry.histogram(
            "fleet_decision_seconds",
            help="controller-timer cost of one actioned decision "
                 "(sweeps included)",
        )
        self.m_failovers = registry.counter(
            "fleet_failovers_total",
            help="coordinator takeovers adopted by a standby",
        )
        self.m_grow_blocked = registry.counter(
            "fleet_grow_blocked_total",
            help="hysteresis grows with no restorable replica "
                 "(onset-counted, not per-cadence)",
        )

    def resized(self, decision: FleetDecision) -> None:
        if self._r:
            key = (decision.action, decision.reason)
            c = self._resizes.get(key)
            if c is None:
                c = self._resizes[key] = self.registry.counter(
                    "fleet_resizes_total",
                    help="accepted fleet resizes",
                    direction=key[0], reason=key[1],
                )
            c.inc()
            self.m_decision_s.observe(decision.decision_s)
        if self.flight is not None:
            # to_dict carries "t" for the postmortem record; the event
            # stamp takes it explicitly, so drop it from the kwargs
            detail = {
                k: v for k, v in decision.to_dict().items() if k != "t"
            }
            self.flight.event(
                "fleet decision", src="fleet", t=decision.t, **detail,
            )

    def sizes(self, size: int, target: int) -> None:
        if self._r:
            self.m_size.set(size)
            self.m_target.set(target)

    def grow_blocked(self, t: float, target: int, size: int) -> None:
        if self._r:
            self.m_grow_blocked.inc()
        if self.flight is not None:
            self.flight.event(
                "fleet grow blocked", src="fleet", t=t,
                target=target, size=size,
                detail=(
                    f"sizing wants {target} replicas but no "
                    "controller-drained replica is restorable from "
                    f"size {size} (a replica dead at construction is "
                    "not the controller's to bring back)"
                ),
            )

    def failover(self, t: float, detail: str) -> None:
        if self._r:
            self.m_failovers.inc()
        if self.flight is not None:
            self.flight.event(
                "coordinator takeover", src="fleet", t=t, detail=detail,
            )


class FleetController:
    """Closed-loop autoscaler over a :class:`~..models.router.
    RequestRouter` fleet (module docstring: planes, budget, purity).

    >>> ctl = FleetController(router, clock=clock,
    ...     capacity_rps=replica_capacity_rps(...),
    ...     min_replicas=2, decision_interval_s=30.0)
    >>> # driver loop (run_router_day does this when controller= is
    >>> # passed): feed arrivals, step on the cadence
    >>> ctl.observe_arrival(t)
    >>> ctl.step()

    ``recode=`` arms the pool-plane re-code on resize::

        recode=dict(model=fitted_pool_model, n_inner=4,
                    candidates=[(1.0, 2), (1.0, 3), (0.75, 3)],
                    inner_floor=2, epochs=40)

    ``policy_sweep=`` arms the router-policy re-derivation (stateless
    placement policies only; a hedge_p99/two_tier router keeps its
    structural policy and the controller records that refusal).
    """

    def __init__(
        self,
        router,
        *,
        clock,
        capacity_rps: float,
        min_replicas: int = 1,
        max_replicas: int | None = None,
        high: float = 0.85,
        low: float = 0.45,
        target_util: float | None = None,
        depth_high: float | None = None,
        dwell_s: float = 0.0,
        cooldown_s: float = 0.0,
        decision_interval_s: float = 1.0,
        rate_tau_s: float | None = None,
        recode: dict | None = None,
        policy_sweep: dict | None = None,
        decision_budget: int | None = None,
        checkpointer=None,
        checkpoint_every_s: float | None = None,
        timer: Callable[[], float] | None = None,
        registry=None,
        flight=None,
        trace=None,
        slo=None,
    ):
        self.router = router
        self.clock = clock
        self._now = clock.now
        # SLO plane: a bound SloPolicy makes burn-rate an
        # additional grow trigger (step()); slo=None keeps the
        # decision procedure byte-for-byte the burn-free one
        self.slo = slo
        if trace is not None:
            # arm causal tracing fleet-wide: the router (and through
            # it every replica) stamps onto this one book
            router.attach_trace(trace)
        n = len(router.replicas)
        self.capacity_rps = float(capacity_rps)
        if self.capacity_rps <= 0.0:
            raise ValueError("capacity_rps must be > 0")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(
            n if max_replicas is None else max_replicas
        )
        if not (1 <= self.min_replicas <= self.max_replicas <= n):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas <= "
                f"{n} replicas, got [{min_replicas}, {max_replicas}]"
            )
        if not (0.0 < low < high):
            raise ValueError(
                f"hysteresis bands need 0 < low < high, got "
                f"low={low}, high={high}"
            )
        self.high = float(high)
        self.low = float(low)
        self.target_util = float(
            (high + low) / 2.0 if target_util is None else target_util
        )
        self.depth_high = (
            None if depth_high is None else float(depth_high)
        )
        self.dwell_s = float(dwell_s)
        self.cooldown_s = float(cooldown_s)
        self.decision_interval_s = float(decision_interval_s)
        if self.decision_interval_s <= 0.0:
            raise ValueError("decision_interval_s must be > 0")
        t0 = self._now()
        self.estimator = ArrivalRateEstimator(
            float(rate_tau_s) if rate_tau_s is not None
            else 10.0 * self.decision_interval_s,
            t0=t0,
        )
        self.recode = dict(recode) if recode else None
        self.policy_sweep = dict(policy_sweep) if policy_sweep else None
        if self.policy_sweep is not None:
            reserved = {"load", "n_replicas"} & self.policy_sweep.keys()
            if reserved:
                raise ValueError(
                    f"policy_sweep keys {sorted(reserved)} are "
                    "computed by the controller at each resize (the "
                    "post-resize operating point); passing them here "
                    "would raise at the first accepted resize, "
                    "mid-run — drop them from the config"
                )
        self.decision_budget = (
            None if decision_budget is None else int(decision_budget)
        )
        self.checkpointer = checkpointer
        if checkpoint_every_s is not None and checkpointer is None:
            raise ValueError(
                "checkpoint_every_s without a checkpointer: the "
                "cadence would raise at its first due step, mid-run "
                "— pass checkpointer= (fleet.FleetCheckpointer) or "
                "drop the cadence"
            )
        self.checkpoint_every_s = (
            None if checkpoint_every_s is None
            else float(checkpoint_every_s)
        )
        self._timer = self._now if timer is None else timer
        # provisioned = the CONTROLLER's intent; seeded from the
        # router's initial routable set (a replica dead at construction
        # is not the controller's to bring back)
        up0 = set(router.routable_replicas)
        self._provisioned = [i in up0 for i in range(n)]
        # replicas the CONTROLLER drained — the only ones a grow may
        # restore (a replica dead at construction is not the
        # controller's to bring back; the comment below states the
        # invariant, this set enforces it)
        self._drained: set[int] = set()
        self._up_since = [
            t0 if self._provisioned[i] else math.nan for i in range(n)
        ]
        self._chip_seconds = [0.0] * n
        self._high_since: float | None = None
        self._low_since: float | None = None
        self._cooldown_until = -math.inf
        self._next_decision_at = t0
        self._next_checkpoint_at = (
            t0 + self.checkpoint_every_s
            if self.checkpoint_every_s is not None else None
        )
        self.target_size = self.size
        self.code_pair: tuple[float, int] | None = None
        self.decisions: list[FleetDecision] = []
        self.n_resizes = 0
        self.n_failovers = 0
        self.n_grow_blocked = 0
        # flap detector (chaos plane): a resize REVERSING the previous
        # one's direction is the hysteresis failure signature — a
        # retry storm that whipsaws the controller grow/shrink/grow
        # shows up here even when each individual resize looked
        # justified. The adversarial no-flap test pins this counter
        # under a storm; dwell_s/cooldown_s are the knobs that keep it
        # low.
        self.n_direction_flips = 0
        self._last_action: str | None = None
        self._grow_blocked = False
        self._seq = 0
        self._obs = (
            _FleetObs(registry, flight)
            if registry is not None or flight is not None else None
        )
        if self._obs is not None:
            self._obs.sizes(self.size, self.target_size)

    # -- signals ----------------------------------------------------------

    @property
    def size(self) -> int:
        return sum(self._provisioned)

    def observe_arrival(self, t: float) -> None:
        """One arrival at clock time ``t`` — the driver feeds every
        submit through here (run_router_day does when ``controller=``
        is passed)."""
        self.estimator.observe(t)

    def signals(self) -> FleetSignals:
        return fleet_signals(
            self.router, self.estimator, self._now(),
            provisioned=self.size, capacity_rps=self.capacity_rps,
        )

    def chip_seconds(self, t: float | None = None) -> float:
        """Chip-time consumed so far: one chip-second per provisioned
        replica per clock second — the quantity the elastic fleet
        saves against static peak provisioning (docs/PERF.md round
        18)."""
        now = self._now() if t is None else float(t)
        total = sum(self._chip_seconds)
        for up_at in self._up_since:
            if not math.isnan(up_at):
                total += max(now - up_at, 0.0)
        return total

    def next_event_at(self) -> float | None:
        """Earliest clock time the controller needs to run: its
        decision cadence, or the checkpoint cadence if sooner (the
        virtual-time driver advances here between steps)."""
        t = self._next_decision_at
        if (
            self._next_checkpoint_at is not None
            and self._next_checkpoint_at < t
        ):
            t = self._next_checkpoint_at
        return t

    # -- the decision procedure -------------------------------------------

    def step(self) -> FleetDecision | None:
        """Run the decision procedure if due (a not-yet-due step is a
        no-op, the SimReplica discipline). Returns the actioned
        :class:`FleetDecision`, or None."""
        now = self._now()
        if (
            self._next_checkpoint_at is not None
            and now + _EPS >= self._next_checkpoint_at
        ):
            self.checkpoint()
            self._next_checkpoint_at = now + self.checkpoint_every_s
        if now + _EPS < self._next_decision_at:
            return None
        self._next_decision_at = now + self.decision_interval_s
        sig = self.signals()
        # dwell trackers: continuous time above/below the bands
        breach_high = sig.utilization > self.high or (
            self.depth_high is not None
            and sig.depth_per_replica > self.depth_high
        )
        # SLO burn as a grow trigger: a firing fast-burn
        # alert joins the high-pressure signal — it rides the same
        # dwell/cooldown machinery, and the decision record names the
        # alert. Evaluated on the policy's windows (virtual time), so
        # a controller day with slo= replays bit-identically.
        slo_alert = None
        if self.slo is not None:
            firing = self.slo.fast_burn_firing()
            if firing:
                slo_alert = firing[0]
                breach_high = True
        if breach_high:
            if self._high_since is None:
                self._high_since = now
        else:
            self._high_since = None
        if sig.utilization < self.low:
            if self._low_since is None:
                self._low_since = now
        else:
            self._low_since = None
        target = self._target_size(sig)
        if (
            slo_alert is not None and target <= self.size
            and self.size < self.max_replicas
        ):
            # the rate/capacity model says steady but the SLO is
            # burning budget: grow one replica per decision until the
            # fast window recovers
            target = self.size + 1
        self.target_size = target
        if self._obs is not None:
            self._obs.sizes(self.size, target)
        action = reason = None
        if now < self._cooldown_until - _EPS:
            return None
        if (
            self._high_since is not None
            and now - self._high_since + _EPS >= self.dwell_s
            and target > self.size
        ):
            action = "grow"
            reason = (
                "util_high" if sig.utilization > self.high
                else "depth_high" if (
                    self.depth_high is not None
                    and sig.depth_per_replica > self.depth_high
                )
                else f"slo_burn:{slo_alert}"
            )
            # only controller-drained replicas are restorable (a
            # replica dead at construction is not the controller's to
            # bring back); grow as far as the drained pool allows, and
            # when that is nowhere, name the stall ONCE per onset
            # instead of silently retrying every cadence
            achievable = self.size + len(self._drained)
            if target > achievable:
                target = achievable
            if target <= self.size:
                if not self._grow_blocked:
                    self._grow_blocked = True
                    self.n_grow_blocked += 1
                    if self._obs is not None:
                        self._obs.grow_blocked(
                            now, self.target_size, self.size,
                        )
                return None
        elif (
            self._low_since is not None
            and now - self._low_since + _EPS >= self.dwell_s
            and target < self.size
        ):
            action, reason = "shrink", "util_low"
        if action is None:
            return None
        return self._act(now, sig, action, reason, target)

    def resize_to(
        self, target: int, *, reason: str = "operator"
    ) -> FleetDecision | None:
        """Operator-forced resize (the sim plane's ``FleetResize``
        event drives this): bypasses the hysteresis/dwell/cooldown
        gate but NOT the range contract — a target outside
        ``[min_replicas, max_replicas]`` is refused by name, never
        clamped — and still re-derives the code pair and router policy
        like any accepted resize."""
        target = int(target)
        if not (self.min_replicas <= target <= self.max_replicas):
            raise ValueError(
                f"resize to {target} replicas refused: the elastic "
                f"range is [{self.min_replicas}, {self.max_replicas}] "
                "(the fleet has exactly max_replicas replicas; grow "
                "the fleet, don't overdrive the controller)"
            )
        if target == self.size:
            return None
        if target > self.size:
            restorable = len(self._drained)
            if target - self.size > restorable:
                raise ValueError(
                    f"grow to {target} replicas refused: only "
                    f"{restorable} controller-drained replicas are "
                    f"restorable from size {self.size} (a replica "
                    "dead at construction is not the controller's to "
                    "bring back — revive it at the backend, then "
                    "resize)"
                )
        now = self._now()
        sig = self.signals()
        action = "grow" if target > self.size else "shrink"
        return self._act(now, sig, action, reason, target)

    def _act(
        self, now: float, sig: FleetSignals, action: str, reason: str,
        target: int,
    ) -> FleetDecision | None:
        """Commit one accepted resize: move the provisioned set,
        re-derive (code pair, policy) — the sweeps ARE the decision
        procedure — and record the decision everywhere it lands."""
        t_dec = self._timer()
        moved = self._apply_resize(target)
        if not moved:
            return None
        decision = FleetDecision(
            self._seq, now, action, reason, sig,
            sig.provisioned, self.size, target, moved,
        )
        self._seq += 1
        self.n_resizes += 1
        if (self._last_action is not None
                and action in ("grow", "shrink")
                and self._last_action in ("grow", "shrink")
                and action != self._last_action):
            self.n_direction_flips += 1
        if action in ("grow", "shrink"):
            self._last_action = action
        self._grow_blocked = False
        self._cooldown_until = now + self.cooldown_s
        self._high_since = self._low_since = None
        # re-code on resize: the sweeps are the decision procedure
        decision.recode = self._recode(self.size)
        decision.policy = self._repolicy(self.size, sig.rate_rps)
        if decision.recode is not None:
            self.code_pair = tuple(decision.recode["pair"])
        decision.decision_s = max(self._timer() - t_dec, 0.0)
        self.decisions.append(decision)
        if self._obs is not None:
            self._obs.resized(decision)
            self._obs.sizes(self.size, decision.target_size)
        return decision

    def _target_size(self, sig: FleetSignals) -> int:
        want = math.ceil(
            sig.rate_rps / (self.target_util * self.capacity_rps)
        ) if sig.rate_rps > 0.0 else self.min_replicas
        return max(self.min_replicas, min(self.max_replicas, want))

    def _apply_resize(self, target: int) -> list[int]:
        """Move the provisioned set to ``target`` replicas: grow from
        the lowest-index controller-drained replicas, shrink from the
        highest-index provisioned (the router's eject/re-route path
        drains them with zero drops). Returns the indices moved."""
        now = self._now()
        moved: list[int] = []
        size = self.size
        if target > size:
            for i in range(len(self._provisioned)):
                if size + len(moved) >= target:
                    break
                if self._provisioned[i] or i not in self._drained:
                    continue
                self._provisioned[i] = True
                self._drained.discard(i)
                self._up_since[i] = now
                self._provision(i)
                moved.append(i)
        elif target < size:
            tb = getattr(self.router, "_trace", None)
            for i in reversed(range(len(self._provisioned))):
                if size - len(moved) <= target:
                    break
                if not self._provisioned[i]:
                    continue
                self._provisioned[i] = False
                self._drained.add(i)
                up_at = self._up_since[i]
                if not math.isnan(up_at):
                    self._chip_seconds[i] += max(now - up_at, 0.0)
                self._up_since[i] = math.nan
                if tb is not None:
                    # stamp the CAUSE before mark_down's evacuate
                    # records the mechanics (evacuated/rerouted)
                    for rr in self.router.inflight_on(i):
                        if rr.trace is not None:
                            tb.event(rr.trace, "evacuated_on_resize",
                                     now, replica=i)
                self.router.mark_down(i)
                moved.append(i)
        return moved

    def _provision(self, i: int) -> None:
        """Put replica ``i`` back in rotation: the ONE re-provision
        protocol (the grow arm and the failover-adoption path both
        route here) — mark it routable, and revive it only when it
        exposes the verb and is actually down."""
        self.router.mark_up(i)
        rep = self.router.replicas[i]
        revive = getattr(rep, "revive", None)
        if revive is not None and not getattr(rep, "alive", True):
            revive()

    # -- re-coding (sim-in-the-loop) --------------------------------------

    def _recode(self, new_size: int) -> dict | None:
        """Re-derive (outer rate, inner nwait) for the resized fleet:
        ``sweep_hierarchical`` on a VirtualClock twin seeded from the
        live fits, unless the candidate grid overruns the decision
        budget — then the analytic ``optimal_nwait`` cross-check
        decides the inner nwait (``fallback=True``). Infeasible
        candidates are REFUSED by the sweep, by name; the refusal
        propagates."""
        cfg = self.recode
        if cfg is None:
            return None
        from ..sim.tune import sweep_hierarchical

        n_inner = int(cfg["n_inner"])
        candidates = [(float(r), int(k)) for r, k in cfg["candidates"]]
        epochs = int(cfg.get("epochs", 40))
        inner_floor = int(cfg.get("inner_floor", 1))
        seed = int(cfg.get("seed", 0))
        cost = len(candidates) * epochs
        groups = int(new_size)
        if (
            self.decision_budget is not None
            and cost > self.decision_budget
        ):
            # budget overrun: the model cross-check IS the decision
            sub = resized_model(cfg["model"], n_inner)
            k = int(sub.optimal_nwait(kmin=inner_floor, kmax=n_inner))
            rate = (
                self.code_pair[0] if self.code_pair is not None
                else max(r for r, _ in candidates)
            )
            return {
                "pair": (float(rate), k), "fallback": True,
                "agree": None, "inner_model": k,
                "budget_cost": cost, "budget": self.decision_budget,
            }
        model = resized_model(cfg["model"], groups * n_inner)
        res = sweep_hierarchical(
            model, groups=groups, n_inner=n_inner,
            candidates=candidates, inner_floor=inner_floor,
            epochs=epochs, seed=seed,
        )
        return {
            "pair": (float(res["best"][0]), int(res["best"][1])),
            "fallback": False,
            "agree": bool(res["agree"]),
            "inner_sim": int(res["inner_sim"]),
            "inner_model": int(res["inner_model"]),
            "budget_cost": cost,
            "sweep_digest": _sweep_digest(res["entries"]),
        }

    def _repolicy(self, new_size: int, rate_rps: float) -> dict | None:
        """Re-derive the routing policy at the post-resize operating
        point via ``sweep_router_policy`` on a VirtualClock twin. A
        structural policy (hedge_p99 / two_tier) is never switched —
        the refusal is recorded, not clamped."""
        cfg = self.policy_sweep
        if cfg is None:
            return None
        if self.router.policy in ("hedge_p99", "two_tier"):
            return {
                "kept": self.router.policy,
                "refused": (
                    f"policy {self.router.policy!r} is structural "
                    "(set at construction); the controller does not "
                    "switch it mid-run"
                ),
            }
        from ..sim.tune import sweep_router_policy

        kw = dict(cfg)
        # online decisions default to the vectorized day engine — same
        # digest, same pick, more of the decision budget left for grid
        kw.setdefault("fast", "auto")
        policies = kw.pop(
            "policies",
            ("round_robin", "least_loaded", "prefix_affinity"),
        )
        # the operating point: post-resize utilization, kept inside
        # the sweep's open-loop feasibility interval — at >= 1 the
        # sweep rightly refuses (saturation), and the controller's
        # answer to saturation is the grow decision, not this sweep
        load = rate_rps / (new_size * self.capacity_rps)
        load = min(max(load, 0.05), 0.95)
        res = sweep_router_policy(
            n_replicas=int(new_size), policies=list(policies),
            load=load, **kw,
        )
        best = str(res["best"])
        out = {
            "best": best, "load": round(load, 6),
            "sweep_digest": _sweep_digest(res["entries"]),
        }
        if best != self.router.policy:
            self.router.set_policy(best)
            out["applied"] = True
        return out

    # -- checkpoint / adoption --------------------------------------------

    def state_dict(self) -> dict:
        """The whole decision state as a flat dict of arrays/scalars —
        the payload :class:`~.failover.FleetCheckpointer` codes across
        shards. Includes the coordinator-visible router book summary
        (per-replica awaiting/streaming depths + in-flight ids) for
        the postmortem round-trip; live books re-derive from the
        surviving router at adoption."""
        now = self._now()
        r = self.router
        inflight: list[int] = []
        awaiting = []
        streaming = []
        for i in range(len(r.replicas)):
            a = getattr(r, "_awaiting", None)
            s = getattr(r, "_streaming", None)
            awaiting.append(len(a[i]) if a is not None else 0)
            streaming.append(len(s[i]) if s is not None else 0)
            if a is not None:
                inflight.extend(rr.id for rr in a[i])
            if s is not None:
                inflight.extend(rr.id for rr in s[i])
        est = self.estimator.state_dict()
        return {
            "t": float(now),
            "next_decision_at": float(self._next_decision_at),
            "next_checkpoint_at": float(
                self._next_checkpoint_at
                if self._next_checkpoint_at is not None else math.nan
            ),
            "cooldown_until": float(self._cooldown_until),
            "high_since": float(
                math.nan if self._high_since is None
                else self._high_since
            ),
            "low_since": float(
                math.nan if self._low_since is None
                else self._low_since
            ),
            "provisioned": np.asarray(self._provisioned, bool),
            "drained": np.asarray(
                [i in self._drained
                 for i in range(len(self._provisioned))], bool,
            ),
            "up_since": np.asarray(self._up_since, np.float64),
            "chip_seconds": np.asarray(self._chip_seconds, np.float64),
            "target_size": int(self.target_size),
            "n_resizes": int(self.n_resizes),
            "n_failovers": int(self.n_failovers),
            "n_direction_flips": int(self.n_direction_flips),
            # -1 none / 0 shrink / 1 grow: the flap detector's memory
            # rides the checkpoint so a takeover keeps counting
            "last_action": int(
                -1 if self._last_action is None
                else (1 if self._last_action == "grow" else 0)
            ),
            "seq": int(self._seq),
            "code_rate": float(
                math.nan if self.code_pair is None
                else self.code_pair[0]
            ),
            "code_nwait": int(
                -1 if self.code_pair is None else self.code_pair[1]
            ),
            "policy": str(self.router.policy),
            "rate_count": float(est["count"]),
            "rate_last_t": float(est["last_t"]),
            "rate_t0": float(est["t0"]),
            "rate_tau_s": float(est["tau_s"]),
            "rate_n": int(est["n_observed"]),
            "book_awaiting": np.asarray(awaiting, np.int64),
            "book_streaming": np.asarray(streaming, np.int64),
            "inflight_ids": np.asarray(sorted(inflight), np.int64),
        }

    def checkpoint(self) -> None:
        if self.checkpointer is None:
            raise ValueError(
                "no checkpointer attached (checkpointer=)"
            )
        self.checkpointer.save(self.state_dict())

    def load_state(self, state: dict, *, adopted: bool = False) -> None:
        """Restore the decision state (the standby-adoption path when
        ``adopted=True``: the failover counter advances and the
        restored active set is re-asserted onto the router — the
        controller's intent survives the coordinator, which is the
        zero-drop failover contract)."""
        n = len(self.router.replicas)
        prov = np.asarray(state["provisioned"], bool)
        if prov.size != n:
            raise ValueError(
                f"checkpoint describes {prov.size} replicas, the "
                f"adopting router has {n}"
            )
        self._provisioned = [bool(b) for b in prov]
        self._drained = {
            int(i)
            for i in np.flatnonzero(np.asarray(state["drained"], bool))
        }
        self._up_since = [
            float(v) for v in np.asarray(state["up_since"], np.float64)
        ]
        self._chip_seconds = [
            float(v)
            for v in np.asarray(state["chip_seconds"], np.float64)
        ]
        self._next_decision_at = float(state["next_decision_at"])
        nca = float(state["next_checkpoint_at"])
        if not math.isnan(nca) and self.checkpoint_every_s is not None:
            self._next_checkpoint_at = nca
        self._cooldown_until = float(state["cooldown_until"])
        hs = float(state["high_since"])
        ls = float(state["low_since"])
        self._high_since = None if math.isnan(hs) else hs
        self._low_since = None if math.isnan(ls) else ls
        self.target_size = int(state["target_size"])
        self.n_resizes = int(state["n_resizes"])
        self.n_failovers = int(state["n_failovers"])
        self.n_direction_flips = int(state.get("n_direction_flips", 0))
        la = int(state.get("last_action", -1))
        self._last_action = (
            None if la < 0 else ("grow" if la == 1 else "shrink")
        )
        self._seq = int(state["seq"])
        cr, ck = float(state["code_rate"]), int(state["code_nwait"])
        self.code_pair = None if math.isnan(cr) else (cr, ck)
        self.estimator.load_state_dict({
            "tau_s": float(state["rate_tau_s"]),
            "t0": float(state["rate_t0"]),
            "count": float(state["rate_count"]),
            "last_t": float(state["rate_last_t"]),
            "n_observed": int(state["rate_n"]),
        })
        if adopted:
            now = self._now()
            self.n_failovers += 1
            # re-assert the restored intent onto the living router
            for i, up in enumerate(self._provisioned):
                if up:
                    self._provision(i)
                else:
                    self.router.mark_down(i)
            pol = str(state["policy"])
            if pol != self.router.policy:
                self.router.set_policy(pol)
            # decisions never fire in the dead window's past
            self._next_decision_at = max(
                self._next_decision_at, now
            )
            if self._next_checkpoint_at is not None:
                self._next_checkpoint_at = max(
                    self._next_checkpoint_at, now
                )
            if self._obs is not None:
                self._obs.failover(
                    now,
                    f"standby adopted at t={now:.6f}: size "
                    f"{self.size}, {int(state['rate_n'])} arrivals "
                    "in the restored rate estimate",
                )
                self._obs.sizes(self.size, self.target_size)

    def __repr__(self) -> str:
        return (
            f"FleetController(size={self.size}/"
            f"[{self.min_replicas},{self.max_replicas}], "
            f"target={self.target_size}, resizes={self.n_resizes}, "
            f"failovers={self.n_failovers})"
        )
