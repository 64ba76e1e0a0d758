"""Fleet-level prefix-page namespace: digest -> where the bytes live.

Counterpart of ``mpistragglers_jl_tpu/cache/directory.py``, copied
and not imported (stdlib only).

Every :class:`~..models.paging.PagePool` keeps a per-replica table
mapping chained prefix digests to resident pages. This module promotes
that table to a FLEET namespace: one :class:`FleetPageDirectory` maps
each digest to its current locations across three tiers —

* ``hbm``  — resident in some replica's device page arena (T1);
* ``dram`` — spilled to the host-DRAM :class:`~.store.PageStore` (T2);
* ``peer`` is not a stored tier but a *lookup outcome*: an ``hbm``
  location on a replica other than the asker (T3 — the page crosses
  on the migration-ring frame format instead of being re-prefilled).

The directory is pure host bookkeeping (stdlib only), deterministic
(insertion-ordered books, no clocks, no randomness — sim days through
it replay bit-identically), and crash-consistent by generation: every
replica registers with :meth:`register_replica` and gets a generation
number; a kill/respawn bumps the generation and drops the dead
incarnation's locations eagerly, and :meth:`locate` re-validates the
generation on every read, so a location published by a dead
incarnation can never be served even if an eager drop was missed.

Residency leases pin a location against eviction for the duration of
a fetch (:meth:`lease` / :meth:`Lease.release`, idempotent); eviction
notifications (:meth:`subscribe`) let the scheduler-side clients react
to a withdrawal — e.g. stop advertising a spilled page a store evicted.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["FleetPageDirectory", "Lease", "TIERS"]

#: Stored tiers, fetch-preference order: a digest resident in host
#: DRAM is served from there before a peer replica's HBM is disturbed
#: (a dram fetch is one memcpy off the local host; a peer fetch costs
#: the owner a device gather plus a ring hop).
TIERS = ("dram", "hbm")


class Lease:
    """One residency pin on a (digest, replica, tier) location: while
    held, the location must not be evicted (the store checks
    :meth:`FleetPageDirectory.leased` before choosing victims).
    ``release()`` is idempotent — fetch fallback paths may release on
    every exit without double-counting."""

    __slots__ = ("directory", "digest", "replica", "tier", "_live")

    def __init__(self, directory: "FleetPageDirectory", digest: bytes,
                 replica: str, tier: str):
        self.directory = directory
        self.digest = digest
        self.replica = replica
        self.tier = tier
        self._live = True

    def release(self) -> None:
        if not self._live:
            return
        self._live = False
        self.directory._drop_lease(self.digest)

    def __enter__(self) -> "Lease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class FleetPageDirectory:
    """The fleet prefix-page namespace (module docstring). All
    mutators are cheap dict operations; the optional ``registry=``
    publishes the directory-size gauge (GC004: dark by default)."""

    def __init__(self, *, registry=None):
        # digest -> {(replica, tier): generation}, both dicts
        # insertion-ordered (determinism: locate() scans in publish
        # order within a tier)
        self._locs: dict[bytes, dict[tuple[str, str], int]] = {}
        self._gen: dict[str, int] = {}
        self._leases: dict[bytes, int] = {}
        self._subs: list[Callable] = []
        self.n_published = 0
        self.n_withdrawn = 0
        self.n_replica_drops = 0
        self._registry = registry
        self._m_size = (
            registry.gauge(
                "cache_directory_size",
                help="digests with at least one live location in the "
                "fleet page directory",
            )
            if registry is not None else None
        )

    # -- membership -----------------------------------------------------

    def register_replica(self, replica: str) -> int:
        """A replica (or the page store) joins the namespace; returns
        its generation. Re-registering an existing name is the
        RESPAWN case: the generation bumps and every location the dead
        incarnation published is dropped — publications made before a
        crash must not survive it."""
        if not replica or not isinstance(replica, str):
            raise ValueError(
                f"replica name must be a non-empty str, got {replica!r}"
            )
        if replica in self._gen:
            self._purge(replica)
            self.n_replica_drops += 1
        self._gen[replica] = self._gen.get(replica, 0) + 1
        return self._gen[replica]

    def generation(self, replica: str) -> int:
        """Current generation of ``replica`` (0 = never registered)."""
        return self._gen.get(replica, 0)

    def drop_replica(self, replica: str) -> None:
        """Crash handling: invalidate every location ``replica``
        published (any tier) — the dead incarnation's HBM pages are
        gone with its process; its next :meth:`register_replica` is a
        fresh generation. Unknown names are a no-op (a replica that
        never published has nothing to drop)."""
        if replica not in self._gen:
            return
        self._purge(replica)
        self._gen[replica] += 1  # leases/locations of the old gen die
        self.n_replica_drops += 1

    def _purge(self, replica: str) -> None:
        dead = []
        for d, locs in self._locs.items():
            for (rep, tier) in list(locs):
                if rep == replica:
                    locs.pop((rep, tier))
                    self._notify(d, rep, tier)
            if not locs:
                dead.append(d)
        for d in dead:
            self._locs.pop(d, None)
        self._set_size()

    # -- publication ----------------------------------------------------

    def publish(self, digest: bytes, *, replica: str,
                tier: str) -> None:
        """Record that ``replica`` holds ``digest`` in ``tier``. The
        replica must be registered (its generation stamps the entry —
        that stamp is what :meth:`locate` re-validates). Idempotent
        per (digest, replica, tier): re-publishing refreshes the
        generation stamp."""
        if tier not in ("hbm", "dram"):
            raise ValueError(
                f"unknown tier {tier!r}: stored tiers are hbm/dram "
                "(peer is a lookup outcome, not a stored tier)"
            )
        gen = self._gen.get(replica)
        if gen is None:
            raise ValueError(
                f"publish from unregistered replica {replica!r}: call "
                "register_replica first (the generation stamp is the "
                "crash-consistency witness)"
            )
        self._locs.setdefault(digest, {})[(replica, tier)] = gen
        self.n_published += 1
        self._set_size()

    def withdraw(self, digest: bytes, *, replica: str,
                 tier: str) -> bool:
        """The location is gone (page freed, store evicted, content
        overwritten). Returns True when an entry was removed;
        subscribers are notified either way only on actual removal."""
        locs = self._locs.get(digest)
        if locs is None or locs.pop((replica, tier), None) is None:
            return False
        if not locs:
            self._locs.pop(digest, None)
        self.n_withdrawn += 1
        self._notify(digest, replica, tier)
        self._set_size()
        return True

    # -- lookup ---------------------------------------------------------

    def locate(self, digest: bytes, *,
               exclude: str | None = None) -> list[tuple[str, str]]:
        """Live locations of ``digest`` as ``(replica, tier)`` pairs,
        dram first then hbm (:data:`TIERS`), ``exclude`` (the asking
        replica — its own HBM residency is a LOCAL hit, not a fleet
        one) filtered out. Generation-checked: entries whose stamp no
        longer matches the replica's current generation are stale
        (published before a crash the eager purge missed) and are
        pruned here, never served."""
        locs = self._locs.get(digest)
        if not locs:
            return []
        out = []
        stale = []
        for (rep, tier), gen in locs.items():
            if self._gen.get(rep) != gen:
                stale.append((rep, tier))
                continue
            if rep == exclude:
                continue
            out.append((rep, tier))
        for key in stale:
            locs.pop(key, None)
        if stale and not locs:
            self._locs.pop(digest, None)
            self._set_size()
        out.sort(key=lambda rt: TIERS.index(rt[1]))
        return out

    def __contains__(self, digest: bytes) -> bool:
        return digest in self._locs

    def has(self, digest: bytes, *, replica: str, tier: str) -> bool:
        locs = self._locs.get(digest)
        return bool(locs) and (replica, tier) in locs

    @property
    def size(self) -> int:
        """Digests with at least one location."""
        return len(self._locs)

    # -- leases ---------------------------------------------------------

    def lease(self, digest: bytes, replica: str, tier: str) -> Lease:
        """Pin a location for the duration of a fetch. The lease does
        not validate residency (the fetch path already did via
        :meth:`locate`); it only guarantees that a cooperating evictor
        (:meth:`leased`) will pass over the digest while it is held."""
        self._leases[digest] = self._leases.get(digest, 0) + 1
        return Lease(self, digest, replica, tier)

    def leased(self, digest: bytes) -> bool:
        return self._leases.get(digest, 0) > 0

    def _drop_lease(self, digest: bytes) -> None:
        n = self._leases.get(digest, 0) - 1
        if n > 0:
            self._leases[digest] = n
        else:
            self._leases.pop(digest, None)

    # -- eviction notifications ------------------------------------------

    def subscribe(self, callback: Callable) -> None:
        """``callback(digest, replica, tier)`` fires on every location
        removal (withdraw, replica drop, stale prune). Callbacks must
        not mutate the directory reentrantly for the same digest."""
        self._subs.append(callback)

    def _notify(self, digest: bytes, replica: str, tier: str) -> None:
        for cb in self._subs:
            cb(digest, replica, tier)

    def _set_size(self) -> None:
        if self._m_size is not None:
            self._m_size.set(len(self._locs))

    # -- invariants -----------------------------------------------------

    def check(self) -> None:
        """Structural invariants: no empty location maps, every entry
        names a registered replica, every generation stamp is at most
        the replica's current one, lease counts positive."""
        for d, locs in self._locs.items():
            if not locs:
                raise AssertionError(f"digest {d.hex()} has no locations")
            for (rep, tier), gen in locs.items():
                if rep not in self._gen:
                    raise AssertionError(
                        f"location names unregistered replica {rep!r}"
                    )
                if gen > self._gen[rep]:
                    raise AssertionError(
                        f"location generation {gen} is from the future "
                        f"(replica {rep!r} at {self._gen[rep]})"
                    )
                if tier not in ("hbm", "dram"):
                    raise AssertionError(f"unknown stored tier {tier!r}")
        for d, n in self._leases.items():
            if n < 1:
                raise AssertionError(f"non-positive lease count {n}")

    def stats(self) -> dict:
        by_tier = {"hbm": 0, "dram": 0}
        for locs in self._locs.values():
            for (_rep, tier) in locs:
                by_tier[tier] += 1
        return {
            "digests": len(self._locs),
            "locations": by_tier,
            "replicas": len(self._gen),
            "published": self.n_published,
            "withdrawn": self.n_withdrawn,
            "replica_drops": self.n_replica_drops,
        }

    def __repr__(self) -> str:
        return (
            f"FleetPageDirectory(digests={len(self._locs)}, "
            f"replicas={len(self._gen)})"
        )
