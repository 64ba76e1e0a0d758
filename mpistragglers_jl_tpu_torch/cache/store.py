"""Host-DRAM page store: the T2 tier that absorbs cold evictions.

Counterpart of ``mpistragglers_jl_tpu/cache/store.py``, copied and
not imported, over the port's ``native/rings.py``.

When a replica's :meth:`~..models.serving.ServingScheduler._free_slot`
retires the last reference to a registered prefix page, r19 keeps the
page COLD in HBM until arena pressure reclaims it. This store catches
the next step of that lifecycle: the reclaimed page's KV bytes land in
one host-DRAM region (``native/rings.py`` — a memfd region where the
platform has ``memfd_create``, the heap twin elsewhere), divided into
page-sized slots under the established :class:`~..native.rings.
RingAlloc` pin discipline:

* every resident page holds a ``"store"`` pin on its slot;
* :meth:`get` serves the page as a ZERO-COPY ``memoryview`` over the
  region, adding one ``("view", n)`` pin released by
  :func:`~..native.rings.track_release` when the last derived view
  dies — eviction of a viewed page frees the directory entry at once
  but the slot's bytes survive until every reader is gone (the same
  keep-window semantics result rings give transport consumers);
* eviction is oldest-first in insertion order, skipping digests the
  :class:`~.directory.FleetPageDirectory` holds a residency lease on
  (a fetch in progress must not watch its source evaporate).

QoS extends here (r19 page quotas → spill tier): a tenant's
``spill_pages`` contract bounds how many of ITS evicted pages the
store keeps; at the bound the tenant's own oldest spilled page is
evicted first — one tenant's eviction storm cannot flush another
tenant's warm prefixes out of DRAM. ``spill_pages=0`` means the store
refuses that tenant's pages outright.

All observability is opt-in (GC004): ``registry=`` publishes
``cache_spill_bytes_total``, ``cache_store_evictions_total`` and the
``cache_store_pages`` gauge; ``flight=`` records spill/evict instants.
"""

from __future__ import annotations

import numpy as np

from ..native.rings import RingAlloc, as_u8, region_create, track_release

__all__ = ["PageStore"]


class PageStore:
    """Fixed-capacity host-DRAM page store (module docstring).

    ``page_bytes`` must match the arena's
    :meth:`~..models.serving.ServingScheduler._page_row_bytes` — the
    store is a byte-level cache, so every participating replica must
    share one page geometry; :meth:`put` refuses mismatched payloads
    by name rather than serving torn pages later.
    """

    def __init__(self, page_bytes: int, capacity_pages: int, *,
                 name: str = "fleet-page-store", directory=None,
                 registry=None, flight=None, qos=None):
        if page_bytes < 1 or capacity_pages < 1:
            raise ValueError(
                f"need page_bytes >= 1 and capacity_pages >= 1, got "
                f"({page_bytes}, {capacity_pages})"
            )
        self.page_bytes = int(page_bytes)
        self.capacity_pages = int(capacity_pages)
        self.name = name
        self._region = region_create(
            self.page_bytes * self.capacity_pages, name
        )
        self._ring = RingAlloc(self.capacity_pages)
        # digest -> (slot, gen); insertion order IS eviction age
        self._slots: dict[bytes, tuple[int, int]] = {}
        self._tenant_of: dict[bytes, str | None] = {}
        self._tenant_count: dict[str, int] = {}
        self._vclock = 0  # unique ("view", n) pin tokens
        self._directory = directory
        self._qos = qos
        self._flight = flight
        self.n_puts = 0
        self.n_hits = 0
        self.n_evictions = 0
        self.n_refused = 0
        self.spilled_bytes = 0
        if directory is not None:
            directory.register_replica(name)
        self._m_spill = self._m_evict = self._m_pages = None
        if registry is not None:
            self._m_spill = registry.counter(
                "cache_spill_bytes_total",
                help="bytes of evicted prefix pages absorbed by the "
                "host-DRAM page store",
            )
            self._m_evict = registry.counter(
                "cache_store_evictions_total",
                help="pages evicted from the host-DRAM store "
                "(capacity or tenant spill quota)",
            )
            self._m_pages = registry.gauge(
                "cache_store_pages",
                help="prefix pages resident in the host-DRAM store",
            )

    # -- write side ------------------------------------------------------

    def put(self, digest: bytes, payload, *,
            tenant: str | None = None) -> bool:
        """Absorb one evicted page. True when the digest is resident
        after the call (already present counts); False when the store
        refused it — tenant spill quota exhausted with nothing of its
        own to evict, or every slot pinned by live views. A refusal is
        never an error: the page's bytes are reproducible by prefill,
        the store only saves the work."""
        if digest in self._slots:
            return True
        buf = as_u8(payload)
        if buf.size != self.page_bytes:
            raise ValueError(
                f"payload is {buf.size} bytes, store pages are "
                f"{self.page_bytes}: page geometry must match across "
                "the fleet (quantize_kv / page_tokens / config drift?)"
            )
        if not self._make_room_for(tenant):
            self.n_refused += 1
            return False
        got = self._ring.acquire(("store",))
        while got is None:
            # every slot pinned: evict an unleased resident (its slot
            # may itself stay view-pinned — keep going) or give up
            if not self._evict_one(protect=digest):
                self.n_refused += 1
                return False
            got = self._ring.acquire(("store",))
        slot, gen = got
        off = slot * self.page_bytes
        self._region.view[off:off + self.page_bytes] = buf
        self._slots[digest] = (slot, gen)
        self._tenant_of[digest] = tenant
        if tenant is not None:
            self._tenant_count[tenant] = \
                self._tenant_count.get(tenant, 0) + 1
        self.n_puts += 1
        self.spilled_bytes += self.page_bytes
        if self._directory is not None:
            self._directory.publish(
                digest, replica=self.name, tier="dram"
            )
        if self._m_spill is not None:
            self._m_spill.inc(self.page_bytes)
        if self._m_pages is not None:
            self._m_pages.set(len(self._slots))
        if self._flight is not None:
            self._flight.event(
                "page spilled", src="cache", tenant=tenant,
                digest=digest.hex()[:12],
            )
        return True

    def _make_room_for(self, tenant: str | None) -> bool:
        """Enforce the tenant's ``spill_pages`` quota BEFORE the slot
        acquire: over the bound, the tenant's own oldest page goes
        first (mirror of r19 cold-page reclaim). False = this tenant
        may not spill at all right now."""
        if self._qos is None or tenant is None or tenant not in self._qos:
            return True
        quota = self._qos.get(tenant).spill_pages
        if quota is None:
            return True
        if quota == 0:
            return False
        while self._tenant_count.get(tenant, 0) >= quota:
            if not self._evict_one(tenant=tenant):
                return False
        return True

    def _evict_one(self, *, tenant: str | None = None,
                   protect: bytes | None = None) -> bool:
        """Evict the oldest unleased resident page — ``tenant``'s own
        oldest when given (quota path), any tenant's otherwise
        (capacity path). False when nothing is evictable."""
        for d in self._slots:
            if d == protect:
                continue
            if tenant is not None and self._tenant_of.get(d) != tenant:
                continue
            if self._directory is not None and self._directory.leased(d):
                continue
            reason = (
                "tenant_spill_quota" if tenant is not None
                else "store_capacity"
            )
            self._drop(d, reason)
            return True
        return False

    def _drop(self, digest: bytes, reason: str) -> None:
        slot, gen = self._slots.pop(digest)
        self._ring.release(slot, gen, "store")
        t = self._tenant_of.pop(digest, None)
        if t is not None:
            n = self._tenant_count.get(t, 0) - 1
            if n > 0:
                self._tenant_count[t] = n
            else:
                self._tenant_count.pop(t, None)
        self.n_evictions += 1
        if self._directory is not None:
            self._directory.withdraw(
                digest, replica=self.name, tier="dram"
            )
        if self._m_evict is not None:
            self._m_evict.inc()
        if self._m_pages is not None:
            self._m_pages.set(len(self._slots))
        if self._flight is not None:
            self._flight.event(
                "page evicted", src="cache", reason=reason,
                digest=digest.hex()[:12],
            )

    # -- read side -------------------------------------------------------

    def get(self, digest: bytes) -> "memoryview | None":
        """The page's bytes as a zero-copy ``memoryview`` over the
        region, or None on miss. The view pins its slot
        (``track_release``): even if the page is evicted while the
        caller still reads, the bytes stay put until the last derived
        view dies — the caller never copies defensively and never
        reads a torn page."""
        entry = self._slots.get(digest)
        if entry is None:
            return None
        slot, gen = entry
        off = slot * self.page_bytes
        view = self._region.view[off:off + self.page_bytes]
        self._vclock += 1
        holder = ("view", self._vclock)
        self._ring.add_holder(slot, gen, holder)
        track_release(view, self._ring.release, slot, gen, holder)
        self.n_hits += 1
        return memoryview(view)

    def __contains__(self, digest: bytes) -> bool:
        return digest in self._slots

    # -- bookkeeping -----------------------------------------------------

    @property
    def pages(self) -> int:
        return len(self._slots)

    def tenant_pages(self, tenant: str) -> int:
        return self._tenant_count.get(tenant, 0)

    def drop_tenant(self, tenant: str) -> int:
        """Evict every page ``tenant`` spilled (contract teardown);
        returns the count."""
        mine = [d for d, t in self._tenant_of.items() if t == tenant]
        for d in mine:
            self._drop(d, "tenant_teardown")
        return len(mine)

    def check(self) -> None:
        """Structural invariants: resident count within capacity,
        tenant counts consistent with the per-digest book, every
        resident slot still store-pinned (generation live)."""
        if len(self._slots) > self.capacity_pages:
            raise AssertionError(
                f"{len(self._slots)} resident > {self.capacity_pages} "
                "capacity"
            )
        counts: dict[str, int] = {}
        for d, t in self._tenant_of.items():
            if d not in self._slots:
                raise AssertionError("tenant book names a missing digest")
            if t is not None:
                counts[t] = counts.get(t, 0) + 1
        if counts != self._tenant_count:
            raise AssertionError(
                f"tenant counts drifted: {counts} != {self._tenant_count}"
            )
        for d, (slot, gen) in self._slots.items():
            if not self._ring.add_holder(slot, gen, "store"):
                raise AssertionError(
                    f"resident digest {d.hex()[:12]} lost its slot "
                    f"(slot {slot} gen {gen} stale)"
                )

    def stats(self) -> dict:
        return {
            "pages": len(self._slots),
            "capacity": self.capacity_pages,
            "page_bytes": self.page_bytes,
            "puts": self.n_puts,
            "hits": self.n_hits,
            "evictions": self.n_evictions,
            "refused": self.n_refused,
            "spilled_bytes": self.spilled_bytes,
            "pinned_slots": self._ring.pinned,
        }

    def close(self) -> None:
        """Withdraw every advertisement and release the region. Live
        served views keep their slots' bytes alive (heap twin) or the
        mapping pinned (memfd) — the established close discipline."""
        for d in list(self._slots):
            self._drop(d, "store_close")
        self._region.close()

    def __repr__(self) -> str:
        return (
            f"PageStore({len(self._slots)}/{self.capacity_pages} pages"
            f" x {self.page_bytes}B)"
        )
