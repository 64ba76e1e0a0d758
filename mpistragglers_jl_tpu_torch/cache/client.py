"""FleetPrefixCache: the hub that ties the three tiers together.

Counterpart of ``mpistragglers_jl_tpu/cache/client.py``, copied
and not imported. A payload here is a flat host ``uint8`` array: the
scheduler's ``_page_payload`` copies a page off the card explicitly,
and ``_install_page_payload`` copies it back onto the card in place.

One hub per fleet. Every participating
:class:`~..models.serving.ServingScheduler` attaches
(:meth:`FleetPrefixCache.attach`) and from then on:

* its :class:`~..models.paging.PagePool` registrations are MIRRORED
  into the shared :class:`~.directory.FleetPageDirectory` (the pool's
  ``register_hook``/``unregister_hook`` — volatile registrations stay
  local: a wrapped page's bytes are only meaningful under the owner's
  ring phase, so advertising it fleet-wide would serve garbage);
* admission misses probe the directory (:meth:`probe`) and, when a
  plan commits, :meth:`fetch` pulls the page — host-DRAM store first
  (zero-copy view), then a peer replica's HBM over the r16
  migration-ring frame format (``page_to_frames``/``page_from_frames``)
  — instead of re-prefilling the tokens;
* cold pages the arena reclaims are offered to the T2 store
  (:meth:`spill`), priced through the
  :class:`~.planner.SpillFetchPlanner` byte model.

Failure behavior is fail-to-prefill everywhere: a partitioned peer
(:meth:`partition` — the router's partition hook notifies the hub), a
killed replica (:meth:`kill` — directory generations invalidate its
advertisements), an evicted store page, a mid-fetch surprise — every
one makes :meth:`fetch` return None and the scheduler falls back to
prefilling the chunk it was going to prefill anyway. The cache can
only ever SAVE work; it can never be needed for correctness.

Observability (opt-in, GC004): ``registry=`` publishes
``cache_fetch_bytes_total{src="dram"|"peer"}``, the store's spill
counters, the directory-size gauge, and ``cache_fetch_seconds`` (the
planner's priced cost per fetch — the sim plane charges the same
number to its virtual clock, so live and swept fetch latencies are
the same scale); ``flight=`` records fetch/fallback instants.
"""

from __future__ import annotations

from ..models.disagg import (MigrationRing, MigrationRingReader,
                             page_from_frames, page_to_frames)
from .directory import FleetPageDirectory
from .planner import SpillFetchPlanner
from .store import PageStore

__all__ = ["FleetPrefixCache"]


class FleetPrefixCache:
    """The fleet cache hub (module docstring).

    ``store_pages`` sizes the host-DRAM tier in pages; the byte size
    is fixed lazily at first :meth:`attach` from that scheduler's
    page-row geometry (every later attach must match — refused by
    name otherwise). ``store_pages=0`` disables T2: the hub then only
    brokers peer fetches.
    """

    def __init__(self, *, store_pages: int = 256, qos=None,
                 planner: "SpillFetchPlanner | None" = None,
                 slot_bytes: int = 1 << 20, ring_slots: int = 4,
                 registry=None, flight=None,
                 name: str = "fleet-cache"):
        if store_pages < 0:
            raise ValueError(
                f"store_pages must be >= 0 (0 disables the DRAM "
                f"tier), got {store_pages}"
            )
        self.name = name
        self.store_pages = int(store_pages)
        self.directory = FleetPageDirectory(registry=registry)
        self.planner = planner if planner is not None \
            else SpillFetchPlanner(batch_bytes=slot_bytes)
        self.store: PageStore | None = None  # lazy: needs page_bytes
        self.page_bytes: int | None = None
        self._qos = qos
        self._registry = registry
        self._flight = flight
        self._slot_bytes = int(slot_bytes)
        self._ring_slots = int(ring_slots)
        self._ring: MigrationRing | None = None
        self._reader: MigrationRingReader | None = None
        self._members: dict[str, object] = {}  # name -> scheduler
        self._unreachable: set[str] = set()
        self._n_auto = 0
        self.n_fetches = {"dram": 0, "peer": 0}
        self.n_fallbacks = 0
        self.n_spills = 0
        self.fetch_seconds_modeled = 0.0
        self.spill_seconds_modeled = 0.0
        self._m_fetch: dict[str, object] = {}
        self._m_fetch_s = (
            registry.histogram(
                "cache_fetch_seconds",
                help="modeled seconds per fetched page "
                "(planner byte model)",
            )
            if registry is not None else None
        )

    # -- membership ------------------------------------------------------

    def attach(self, sched, name: str | None = None) -> str:
        """A scheduler joins the fleet namespace; returns its replica
        name (auto ``"r<n>"`` when not given). Fixes the page-byte
        geometry on first attach, builds the T2 store and the peer
        migration ring, and installs the pool mirror hooks."""
        pb = int(sched._page_row_bytes())
        if self.page_bytes is None:
            self.page_bytes = pb
            if self.store_pages > 0:
                self.store = PageStore(
                    pb, self.store_pages, directory=self.directory,
                    registry=self._registry, flight=self._flight,
                    qos=self._qos, name=f"{self.name}-store",
                )
            self._ring = MigrationRing(
                slot_bytes=max(self._slot_bytes, pb),
                slots=self._ring_slots, name=f"{self.name}-ring",
            )
            self._reader = MigrationRingReader(self._ring)
        elif pb != self.page_bytes:
            raise ValueError(
                f"page geometry mismatch: fleet pages are "
                f"{self.page_bytes} bytes, attaching scheduler has "
                f"{pb} (page_tokens / quantize_kv / config drift?)"
            )
        if name is None:
            name = f"r{self._n_auto}"
            self._n_auto += 1
        if name in self._members:
            raise ValueError(
                f"replica name {name!r} already attached; a respawn "
                "calls kill() first (directory generations are the "
                "crash-consistency witness)"
            )
        self.directory.register_replica(name)
        self._members[name] = sched
        pool = sched.pool

        def _mirror_register(digest, pid, _pool=pool, _name=name):
            if not _pool.is_volatile(pid):
                self.directory.publish(digest, replica=_name,
                                       tier="hbm")

        def _mirror_unregister(digest, _name=name):
            self.directory.withdraw(digest, replica=_name, tier="hbm")

        pool.register_hook = _mirror_register
        pool.unregister_hook = _mirror_unregister
        # pages registered BEFORE attach (warm adoption) are mirrored
        # now, same volatility rule
        for d, pid in list(pool._digest_to_page.items()):
            _mirror_register(d, pid)
        return name

    def kill(self, name: str) -> None:
        """The replica's process is gone: drop its directory entries
        (generation bump — stale advertisements can never be served),
        unhook its pool, forget it. Its spilled DRAM pages SURVIVE:
        the store is host-side state, which is the whole point of the
        spill tier."""
        sched = self._members.pop(name, None)
        if sched is not None:
            sched.pool.register_hook = None
            sched.pool.unregister_hook = None
        self.directory.drop_replica(name)
        self._unreachable.discard(name)

    def partition(self, name: str) -> None:
        """``name`` is network-partitioned: peer fetches from or to it
        fail (fail-to-prefill) until :meth:`heal`. Its DRAM spills
        stay readable by everyone else — the store is host-local to
        the fleet, not to the replica."""
        if name in self._members:
            self._unreachable.add(name)

    def heal(self, name: str) -> None:
        self._unreachable.discard(name)

    def members(self) -> list[str]:
        return list(self._members)

    # -- lookup / fetch --------------------------------------------------

    def probe(self, digest: bytes, *,
              exclude: str | None = None) -> str | None:
        """Best reachable tier holding ``digest`` (``"dram"`` before
        ``"peer"``), or None — the admission planner's cheap question
        before it commits budget. Reachability honors partitions: a
        partitioned asker sees only nothing (it cannot reach the
        store host either); a partitioned owner's HBM is invisible."""
        if exclude is not None and exclude in self._unreachable:
            return None
        for rep, tier in self.directory.locate(digest, exclude=exclude):
            if tier == "dram":
                return "dram"
            if rep not in self._unreachable:
                return "peer"
        return None

    def fetch(self, digest: bytes, *,
              exclude: str | None = None) -> "tuple[str, object] | None":
        """Pull one page: ``("dram" | "peer", flat-uint8 payload)`` or
        None (fall back to prefill). DRAM is a zero-copy store view;
        peer rides the migration ring. The source location is leased
        for the duration — the store will not evict it mid-read — and
        every failure path degrades to the next location, then to
        None, never to an error: the bytes are always reproducible by
        prefill."""
        if exclude is not None and exclude in self._unreachable:
            return None
        for rep, tier in self.directory.locate(digest, exclude=exclude):
            if tier == "hbm" and rep in self._unreachable:
                continue
            with self.directory.lease(digest, rep, tier):
                got = (
                    self._fetch_dram(digest) if tier == "dram"
                    else self._fetch_peer(digest, rep)
                )
            if got is not None:
                src, payload = got
                self.n_fetches[src] += 1
                cost = self.planner.price(
                    self.page_bytes,
                    "fetch_dram" if src == "dram" else "fetch_peer",
                )
                self.fetch_seconds_modeled += cost
                if self._registry is not None:
                    m = self._m_fetch.get(src)
                    if m is None:
                        m = self._registry.counter(
                            "cache_fetch_bytes_total",
                            help="bytes of prefix pages served by "
                            "the fleet cache instead of re-prefill",
                            src=src,
                        )
                        self._m_fetch[src] = m
                    m.inc(self.page_bytes)
                if self._m_fetch_s is not None:
                    self._m_fetch_s.observe(cost)
                return got
        self.n_fallbacks += 1
        if self._flight is not None:
            self._flight.event(
                "cache fetch fallback", src="cache",
                digest=digest.hex()[:12],
            )
        return None

    def _fetch_dram(self, digest: bytes):
        if self.store is None:
            return None
        payload = self.store.get(digest)
        return None if payload is None else ("dram", payload)

    def _fetch_peer(self, digest: bytes, rep: str):
        sched = self._members.get(rep)
        if sched is None:
            return None
        pid = sched.pool.lookup(digest)
        if pid is None:  # withdrawn between locate and here
            return None
        payload = sched._page_payload(pid)
        frames = page_to_frames(self._ring, payload)
        flat = page_from_frames(self._reader, frames, ring=self._ring)
        return ("peer", flat)

    # -- spill -----------------------------------------------------------

    def wants(self, digest: bytes, *,
              exclude: str | None = None) -> bool:
        """Would a spill of ``digest`` be useful? False when T2 is
        disabled or the digest is already somewhere ELSE in the fleet
        namespace (``exclude`` is the would-be spiller, whose own
        about-to-die HBM entry must not count) — re-spilling a page a
        sibling still holds wastes the eviction bandwidth the planner
        is there to budget."""
        if self.store is None:
            return False
        return len(self.directory.locate(digest, exclude=exclude)) == 0

    def spill(self, digest: bytes, payload, *,
              tenant: str | None = None, src: str = "device") -> bool:
        """Offer one evicted page to the T2 store; True when it is
        resident after the call. The movement is priced through the
        planner (the modeled device→host cost the PERF byte model and
        the sim plane both charge)."""
        if self.store is None:
            return False
        ok = self.store.put(digest, payload, tenant=tenant)
        if ok:
            self.n_spills += 1
            self.spill_seconds_modeled += self.planner.price(
                self.page_bytes, "spill"
            )
        return ok

    # -- bookkeeping -----------------------------------------------------

    def check(self) -> None:
        self.directory.check()
        if self.store is not None:
            self.store.check()

    def stats(self) -> dict:
        return {
            "members": list(self._members),
            "unreachable": sorted(self._unreachable),
            "page_bytes": self.page_bytes,
            "fetches": dict(self.n_fetches),
            "fallbacks": self.n_fallbacks,
            "spills": self.n_spills,
            "fetch_seconds_modeled": self.fetch_seconds_modeled,
            "spill_seconds_modeled": self.spill_seconds_modeled,
            "directory": self.directory.stats(),
            "store": None if self.store is None else self.store.stats(),
            "planner": self.planner.stats(),
        }

    def close(self) -> None:
        for name in list(self._members):
            self.kill(name)
        if self.store is not None:
            self.store.close()
        if self._ring is not None:
            self._ring.close()
        if self._reader is not None:
            self._reader.close()

    def __repr__(self) -> str:
        return (
            f"FleetPrefixCache({len(self._members)} members, "
            f"dir={self.directory.size}, "
            f"store={None if self.store is None else self.store.pages})"
        )
