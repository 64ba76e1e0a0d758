"""Multi-tenant QoS: SLO classes, fair admission, and priced isolation.

A copy of the JAX package's ``qos/`` (stdlib only: importing it imports
neither torch nor numpy, and nothing here reads an OS clock; buckets
refill from the ``now`` the caller injects).

* :mod:`.tenancy` — :class:`TenantContract` (SLO class ``latency`` |
  ``throughput`` | ``batch``, DRR ``weight``, token-rate budget with
  refill via :class:`TokenBucket`, KV page-pool quota, TTFT-hedge
  entitlement) and the :class:`TenantRegistry` every plane shares.
* :mod:`.drr` — :class:`DeficitScheduler`: weighted deficit-round-
  robin over per-tenant admission queues, work-conserving by
  construction (idle capacity always serves whoever is queued) with
  deficit counters that carry, so a starved tenant catches up
  *exactly*.

Consumer: :class:`~..models.serving.ServingScheduler` (``qos=``)
replaces FIFO admission with the DRR pick and enforces page quotas at
plan time with COW-aware cold-page reclaim. The router's token buckets
and hedge entitlements (``models/router.py``) and the simulated
replicas (``sim/workload.py``) read the same registry.
"""

from .drr import DeficitScheduler
from .tenancy import (
    SHED_ORDER,
    SLO_CLASSES,
    TenantContract,
    TenantRegistry,
    TokenBucket,
    shed_rank,
)

__all__ = [
    "SHED_ORDER",
    "SLO_CLASSES",
    "DeficitScheduler",
    "TenantContract",
    "TenantRegistry",
    "TokenBucket",
    "shed_rank",
]
