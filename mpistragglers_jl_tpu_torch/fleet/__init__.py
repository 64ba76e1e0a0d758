"""Elastic fleet control: the closed-loop control plane.

A copy of ``mpistragglers_jl_tpu/fleet/``, not an import of it. The
control plane is numpy and stdlib: importing it imports no torch
(deciding how to run a GPU fleet never needs a GPU, exactly like
``sim/``), and ``tests/test_torch_imports.py`` pins it.

Every control-plane decision used to be static — fleet size,
(outer rate, inner nwait), router policy were all picked before the
run, and the coordinator was a single point of failure (ROADMAP item
2). This package closes the loop over the signals the codebase already
publishes:

* :mod:`.signals` — the inputs, reduced to numbers: a deterministic
  diurnal arrival-rate estimator, the one replica-capacity formula
  shared with ``sweep_router_policy``, live router gauge snapshots,
  and fleet-resize extrapolation of fitted
  :class:`~..utils.straggle.PoolLatencyModel` s.
* :mod:`.controller` — :class:`FleetController`: hysteresis-banded
  autoscaling over a :class:`~..models.router.RequestRouter` fleet
  (shrink drains through the router's zero-drop eject/re-route path),
  with SIM-IN-THE-LOOP re-coding on every accepted resize:
  ``sweep_hierarchical`` re-derives (outer rate, inner nwait) and
  ``sweep_router_policy`` the routing policy on VirtualClock twins
  seeded from live fits, under a decision budget whose overrun falls
  back to the analytic ``PoolLatencyModel.optimal_nwait`` cross-check.
* :mod:`.failover` — coordinator HA: controller/coordinator state
  through the (n, k)-coded checkpoint channel
  (:class:`FleetCheckpointer` over ``utils/coded_checkpoint.py``), an
  active/standby :class:`ControllerSupervisor` whose standby adopts
  after a coordinator kill, pool-plane capture/adopt
  (``repochs`` history continuous across the handoff), and the
  :class:`PoolScaler` worker-pool elastic pair
  (``backend.reap``/``respawn`` + ``pool.carry``).

Wall-clock purity (tests/test_torch_imports.py covers ``fleet/`` like
``sim/``): decision code reads only its injected clock, so a full
controller day — resizes, a coordinator kill, the failover — replays
bit-identically under tier-1 (:func:`~..sim.workload.run_router_day`
drives it).
"""

from .controller import FleetController, FleetDecision
from .failover import (
    ControllerSupervisor,
    FleetCheckpointer,
    PoolScaler,
    adopt_pool,
    capture_pool,
    restore_pool,
)
from .signals import (
    ArrivalRateEstimator,
    FleetSignals,
    fleet_signals,
    replica_capacity_rps,
    resized_model,
)

__all__ = [
    "FleetController",
    "FleetDecision",
    "ControllerSupervisor",
    "FleetCheckpointer",
    "PoolScaler",
    "adopt_pool",
    "capture_pool",
    "restore_pool",
    "ArrivalRateEstimator",
    "FleetSignals",
    "fleet_signals",
    "replica_capacity_rps",
    "resized_model",
]
