"""Chaos plane: correlated faults, retry storms, overload shedding,
and pinned survival invariants over sim/.

A copy of ``mpistragglers_jl_tpu/chaos/``, not an import of it.
Adversarial testing of the fleet never needs torch or a card: episodes
run on :class:`~..sim.clock.VirtualClock`, and importing this package
imports no torch.

Every headline claim before this package was fair-weather-plus-one-
fault — one straggler, one dead host, one coordinator kill. The
north-star fleet serves millions of users through CORRELATED failures,
retry amplification, and sustained overload, and the platform must
state — then prove bit-identically — what it guarantees when many
things go wrong at once (ROADMAP item 5; arxiv 2605.28426's framing
of fault tolerance as a stated contract, not an aspiration):

* :mod:`.scenarios` — the catalog of named, seeded, replayable
  episodes (:data:`SCENARIOS`): correlated host-group kills,
  router<->replica partitions (distinct from death: the replica keeps
  ticking and must rejoin without double-retiring),
  retry-amplification clients (the classic metastable-failure
  generator), overload beyond load=1 where the router sheds by name
  (batch class first, per the QoS sheddability contract), and
  adversarial prefix/COW churn against the real paged cache.
* :mod:`.injector` — :class:`ChaosInjector` arms the pinned
  invariants INSIDE the run (no deadlock: bounded virtual-time
  progress; no unbounded queue: a hard depth ceiling; every shed
  named; flight recorder captures the episode) and drives the day
  through the real :func:`~..sim.workload.run_router_day`.
* :mod:`.report` — :class:`ChaosReport` with a sha256 digest witness
  like ``WorkloadReport``'s: two runs of the same seeded episode must
  agree on one short string, which is what lets the whole episode
  suite gate the tests (tests/test_torch_chaos.py).

Static enforcement rides along: tests/test_torch_imports.py holds the
shed-by-name rule (no code path of the router drops a request without a
string reason) and the clock rule over ``chaos/`` and ``fleet/``
(episodes never read the OS clock; the scenario is the only source of
time).
"""

from .injector import ChaosInjector
from .report import ChaosReport, InvariantViolation
from .scenarios import (
    SCENARIOS,
    ChaosScenario,
    ReplicaKill,
    get_scenario,
)

__all__ = [
    "SCENARIOS",
    "ChaosInjector",
    "ChaosReport",
    "ChaosScenario",
    "InvariantViolation",
    "ReplicaKill",
    "get_scenario",
]
