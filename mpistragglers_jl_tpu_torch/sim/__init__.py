"""Virtual-time straggler simulation: the *decide* plane.

A copy of the JAX package's ``sim/``: a
:class:`VirtualClock` (event-heap time) under a :class:`SimBackend`
(the full :class:`~..backends.base.Backend` protocol) lets the REAL
``asyncmap``/``waitall``, ``HedgedServer``, and anything else written
against the Backend contract run on virtual time — a 10k-epoch
straggling run completes in milliseconds, bit-reproducibly. On top:

* :mod:`.replay` — recorded :class:`~..utils.trace.EpochTracer` traces
  (live, JSONL, or Chrome/Perfetto documents) become counterfactual
  testbeds ("what would that incident have cost under nwait=5?");
* :mod:`.tune` — sweep (nwait, hedge width, code rate, harvest k, the
  hierarchical code) against a trace, a fitted
  :class:`~..utils.straggle.PoolLatencyModel`, or any
  :mod:`..utils.faults` schedule, honoring the decodability floor and
  cross-checking ``PoolLatencyModel.optimal_nwait``; and the router,
  tenant-weight, tier-split and spill-capacity sweeps over simulated
  fleet days;
* :mod:`.workload` — open-loop arrivals (Poisson, diurnal, JSONL),
  fault and control events, the simulated fleet (:class:`SimReplica`,
  :class:`SimFleetCache`) and :func:`run_router_day`, whose
  :class:`WorkloadReport` carries a sha256 digest of the day;
* :mod:`.fastpath` — the vectorized router-day engine:
  :func:`run_router_day_fast` reproduces the scalar driver's
  ``digest()`` bit for bit on the day shapes it accepts and falls back
  to the scalar loop elsewhere.

stdlib + numpy only, and no OS clock: simulating a GPU fleet never
needs a GPU, and importing this package imports no torch
(``tests/test_torch_imports.py`` pins it).
"""

from .backend import SimBackend, SimEvent, model_delay_fn
from .clock import VirtualClock
from .fastpath import (
    ArrivalBatch,
    diurnal_arrival_batch,
    fastpath_supported,
    poisson_arrival_batch,
    run_router_day_fast,
)
from .replay import (
    ReplayResult,
    ReplayTrace,
    compare,
    replay,
    replay_router_day,
)
from .tune import (
    NwaitSweep,
    recommend_nwait,
    recovered_work_per_s,
    sweep_code_rate,
    sweep_harvest_k,
    sweep_hedge,
    sweep_hierarchical,
    sweep_nwait,
    sweep_router_policy,
    sweep_spill_capacity,
    sweep_tenant_weights,
    sweep_tier_split,
)
from .workload import (
    Arrival,
    CoordinatorKill,
    FleetResize,
    ReplicaPartition,
    RetryPolicy,
    SimFleetCache,
    SimPrompt,
    SimReplica,
    SimRequest,
    SimTicket,
    WorkloadReport,
    arrivals_from_jsonl,
    diurnal_arrivals,
    dump_arrivals_jsonl,
    lognormal_ticks,
    poisson_arrivals,
    run_router_day,
    service_ticks_per_request,
)

__all__ = [
    "VirtualClock",
    "SimBackend",
    "SimEvent",
    "model_delay_fn",
    "ReplayTrace",
    "ReplayResult",
    "replay",
    "compare",
    "replay_router_day",
    "ArrivalBatch",
    "poisson_arrival_batch",
    "diurnal_arrival_batch",
    "fastpath_supported",
    "run_router_day_fast",
    "NwaitSweep",
    "sweep_nwait",
    "sweep_code_rate",
    "sweep_harvest_k",
    "sweep_hedge",
    "sweep_hierarchical",
    "sweep_router_policy",
    "sweep_spill_capacity",
    "sweep_tenant_weights",
    "sweep_tier_split",
    "recommend_nwait",
    "recovered_work_per_s",
    "Arrival",
    "CoordinatorKill",
    "FleetResize",
    "ReplicaPartition",
    "RetryPolicy",
    "SimFleetCache",
    "SimPrompt",
    "SimRequest",
    "SimReplica",
    "SimTicket",
    "WorkloadReport",
    "poisson_arrivals",
    "diurnal_arrivals",
    "arrivals_from_jsonl",
    "dump_arrivals_jsonl",
    "lognormal_ticks",
    "run_router_day",
    "service_ticks_per_request",
]
