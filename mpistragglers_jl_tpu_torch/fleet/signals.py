"""Fleet signals: what the controller watches, reduced to numbers.

A copy of ``mpistragglers_jl_tpu/fleet/signals.py``, not an import of it
(the port never imports the JAX package). Stdlib and numpy, no torch,
and no OS clock: the same seeded inputs give the same records in either
package.

The codebase already publishes everything a scaling decision needs —
the router's queue-depth/tier-depth gauges, per-worker
:class:`~..utils.straggle.PoolLatencyModel` fits, and the arrival
stream itself. This module turns those into the three inputs
:class:`~.controller.FleetController` consumes:

* :class:`ArrivalRateEstimator` — the diurnal arrival-rate estimate: a
  decayed-count (EWMA) estimator on the CONTROLLER's clock, debiased
  over its warmup so the first minutes of a day do not read as idle.
  Deterministic: the estimate is a pure function of the observed
  arrival times, which is what lets a controller day replay
  bit-identically.
* :func:`replica_capacity_rps` — mean service capacity of one
  scheduler replica in requests/second, the same slot-holding-ticks
  arithmetic ``sweep_router_policy`` sizes offered load with (ONE
  formula, not two copies drifting).
* :func:`fleet_signals` — one snapshot (rate, depths, utilization)
  read straight off a live :class:`~..models.router.RequestRouter`.
* :func:`resized_model` — extrapolate a fitted
  :class:`~..utils.straggle.PoolLatencyModel` onto a resized fleet by
  cycling the per-worker fits, so a post-resize sweep is seeded from
  live fits even when the new fleet is larger than the fitted one.

Wall-clock purity (tests/test_torch_imports.py covers ``fleet/``): nothing here
reads the OS clock — every timestamp is handed in by the caller.
"""

from __future__ import annotations

import copy
import math

__all__ = [
    "ArrivalRateEstimator",
    "FleetSignals",
    "fleet_signals",
    "replica_capacity_rps",
    "resized_model",
]


class ArrivalRateEstimator:
    """Decayed-count arrival-rate estimate: each arrival adds 1 to a
    count that decays with time constant ``tau_s``; in steady state at
    rate r the count settles at ``r * tau_s``, so ``rate(t) = count /
    tau_s`` — an EWMA over the arrival process that tracks a diurnal
    swing with lag ~``tau_s``. The warmup bias (the count has only had
    ``t - t0`` seconds to fill) is divided out, so the estimate is
    usable from the first few arrivals."""

    def __init__(self, tau_s: float, *, t0: float = 0.0):
        if tau_s <= 0.0:
            raise ValueError(f"tau_s must be > 0, got {tau_s}")
        self.tau_s = float(tau_s)
        self.t0 = float(t0)
        self.count = 0.0
        self.last_t = float(t0)
        self.n_observed = 0

    def observe(self, t: float) -> None:
        """One arrival at clock time ``t`` (non-decreasing; an earlier
        stamp decays nothing)."""
        t = float(t)
        dt = t - self.last_t
        if dt > 0.0:
            self.count *= math.exp(-dt / self.tau_s)
            self.last_t = t
        self.count += 1.0
        self.n_observed += 1

    def rate(self, t: float) -> float:
        """Requests/second estimate at clock time ``t``."""
        t = float(t)
        c = self.count
        if t > self.last_t:
            c *= math.exp(-(t - self.last_t) / self.tau_s)
        raw = c / self.tau_s
        # debias the warmup window: after `age` seconds the decayed
        # count of a constant-rate stream has only reached
        # (1 - exp(-age/tau)) of its settled value
        age = t - self.t0
        if age <= 0.0:
            return raw
        fill = 1.0 - math.exp(-age / self.tau_s)
        return raw / fill if fill > 1e-9 else raw

    def state_dict(self) -> dict:
        return {
            "tau_s": self.tau_s, "t0": self.t0, "count": self.count,
            "last_t": self.last_t, "n_observed": self.n_observed,
        }

    def load_state_dict(self, state: dict) -> None:
        self.tau_s = float(state["tau_s"])
        self.t0 = float(state["t0"])
        self.count = float(state["count"])
        self.last_t = float(state["last_t"])
        self.n_observed = int(state["n_observed"])

    def __repr__(self) -> str:
        return (
            f"ArrivalRateEstimator(tau={self.tau_s:.3g}s, "
            f"count={self.count:.2f}, n={self.n_observed})"
        )


def replica_capacity_rps(
    *,
    slots: int,
    n_inner: int,
    tick_s: float,
    prompt_len: int,
    prompt_chunk: int,
    max_new: int,
) -> float:
    """Mean service capacity of one replica, requests/second: a request
    holds a slot for its prefill chunks plus its decode ticks, each
    tick costing ``tick_s`` — THE shared arithmetic
    (:func:`~..sim.workload.service_ticks_per_request`), the same call
    ``sweep_router_policy`` sizes offered load with: one formula, so
    the controller's utilization signal can never drift from the
    sweep it cross-checks."""
    from ..sim.workload import service_ticks_per_request

    if min(slots, n_inner, prompt_len, prompt_chunk, max_new) < 1:
        raise ValueError("slots/n_inner/prompt dims must be >= 1")
    if tick_s <= 0.0:
        raise ValueError(f"tick_s must be > 0, got {tick_s}")
    ticks_per_req = service_ticks_per_request(
        prompt_len=prompt_len, prompt_chunk=prompt_chunk,
        max_new=max_new, n_inner=n_inner,
    )
    return int(slots) / (ticks_per_req * float(tick_s))


class FleetSignals:
    """One controller-visible snapshot: the trigger inputs and the
    numbers every decision record carries."""

    __slots__ = (
        "t", "rate_rps", "provisioned", "routable", "queue_depth",
        "depth_per_replica", "utilization",
    )

    def __init__(self, t, rate_rps, provisioned, routable, queue_depth,
                 capacity_rps):
        self.t = float(t)
        self.rate_rps = float(rate_rps)
        self.provisioned = int(provisioned)
        self.routable = int(routable)
        self.queue_depth = int(queue_depth)
        self.depth_per_replica = (
            self.queue_depth / self.provisioned if self.provisioned
            else float("inf")
        )
        cap = self.provisioned * float(capacity_rps)
        self.utilization = (
            self.rate_rps / cap if cap > 0.0 else float("inf")
        )

    def to_dict(self) -> dict:
        return {
            "t": self.t, "rate_rps": round(self.rate_rps, 6),
            "provisioned": self.provisioned, "routable": self.routable,
            "queue_depth": self.queue_depth,
            "utilization": round(self.utilization, 6),
        }

    def __repr__(self) -> str:
        return (
            f"FleetSignals(t={self.t:.3f}, rate={self.rate_rps:.2f}/s, "
            f"size={self.provisioned}, util={self.utilization:.2f}, "
            f"depth={self.queue_depth})"
        )


def fleet_signals(
    router, estimator: ArrivalRateEstimator, t: float, *,
    provisioned: int, capacity_rps: float,
) -> FleetSignals:
    """Snapshot the router's live gauges + the rate estimate at ``t``.
    ``provisioned`` is the CONTROLLER's intent (its chip-time book),
    which can momentarily differ from ``routable_replicas`` while a
    health flip or drain is still propagating."""
    depth = sum(
        router.replicas[i].pending + router.replicas[i].active
        for i in router.routable_replicas
    )
    return FleetSignals(
        t, estimator.rate(t), provisioned,
        len(router.routable_replicas), depth, capacity_rps,
    )


def resized_model(model, n_workers: int):
    """A :class:`~..utils.straggle.PoolLatencyModel` of ``n_workers``
    whose per-worker fits are the live model's, cycled — the seed for
    a post-resize sweep: a grown fleet's new ranks are priced like the
    ranks already fitted (a fresh worker has no samples of its own and
    must not simulate as infinitely fast, the ``model_delay_fn`` prior
    argument applied to resize)."""
    from ..utils.straggle import PoolLatencyModel

    src = list(model.workers)
    if not src:
        raise ValueError("resized_model needs a fitted source model")
    n = int(n_workers)
    if n < 1:
        raise ValueError(f"n_workers must be >= 1, got {n}")
    out = PoolLatencyModel(n)
    # deep-copied: the extrapolated model is independent of the live
    # one (and of itself — cycling aliases the same fit at several
    # indices), so observing into it never corrupts the live fits
    out.workers = [copy.deepcopy(src[i % len(src)]) for i in range(n)]
    return out
