"""Fleet-wide tiered prefix cache: HBM -> host-DRAM -> peer fetch.

Counterpart of ``mpistragglers_jl_tpu/cache/``, copied and not
imported. The four modules do host work only (bookkeeping and bytes); the
device side of a page move (the payload gather, the in-place install)
lives in the port's ``models/serving.py``. The simulator's
counterpart, ``SimFleetCache``, lives in ``sim/workload.py``.

The r19 prefix plane made each replica's KV pages shareable WITHIN the
replica (chained-sha256 digests, cold-page retention, COW). This
package promotes that namespace to the FLEET: a digest evicted from
one replica's device arena spills to a host-DRAM page store, and a
digest resident on replica B is fetched by replica A over the r16
migration-ring frame format instead of being re-prefilled — the
straggler-tolerance thesis applied to memory: never redo work a
sibling already finished.

The moving parts:

* :class:`~.directory.FleetPageDirectory` — digest -> locations with
  per-replica generations (crash consistency), residency leases, and
  eviction notifications;
* :class:`~.store.PageStore` — the T2 host-DRAM tier on
  ``native/rings.py`` regions, pin-count lifetimes, zero-copy reads,
  tenant ``spill_pages`` quotas;
* :class:`~.planner.SpillFetchPlanner` — page movements batched per
  link and priced ``alpha + bytes/rate`` (the PERF byte model the sim
  plane charges to its virtual clock);
* :class:`~.client.FleetPrefixCache` — the hub schedulers attach to:
  pool-mirror hooks, admission probe/fetch, spill, partition/kill
  handling, opt-in counters.

Correctness posture: the cache can only SAVE prefill work, never be
required for it. Every failure — partition, kill, eviction, geometry
mismatch mid-flight — degrades to re-prefilling the chunk, and
token streams served off spilled-then-fetched pages are bit-identical
to never-spilled ones (tests/test_fleet_cache.py holds the oracle).
"""

# name -> module that defines it, imported on first use (PEP 562): the
# client imports models/disagg.py and with it torch, and the simulator's
# SimFleetCache needs only the planner, so ``from ..cache import
# SpillFetchPlanner`` in sim/ must load no torch
_LAZY = {
    "FleetPrefixCache": ".client",
    "FleetPageDirectory": ".directory",
    "Lease": ".directory",
    "TIERS": ".directory",
    "PageMove": ".planner",
    "SpillFetchPlanner": ".planner",
    "PageStore": ".store",
}

__all__ = list(_LAZY)


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(mod, __name__), name)
    globals()[name] = value
    return value
