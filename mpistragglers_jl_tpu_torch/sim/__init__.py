"""Virtual-time straggler simulation: the *decide* plane.

A copy of the pool half of the JAX package's ``sim/``: a
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
  cross-checking ``PoolLatencyModel.optimal_nwait``.

The router-day half (``workload.py``, ``fastpath.py``,
:func:`replay_router_day` and the router, tenant, tier and spill
sweeps) runs over ``models/router.py`` and is ROADMAP.md Queue 1 item
12b: those names raise ``NotImplementedError`` naming it.

stdlib + numpy only, and no OS clock: simulating a GPU fleet never
needs a GPU, and importing this package imports no torch
(``tests/test_torch_imports.py`` pins it).
"""

from .backend import SimBackend, SimEvent, model_delay_fn
from .clock import VirtualClock
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
]
