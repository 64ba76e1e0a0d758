"""Host-side page-pool allocator for the paged serving KV cache.

Counterpart of ``mpistragglers_jl_tpu/models/paging.py``, copied and
not imported (the port never imports the JAX package). The pool is
host bookkeeping only, numpy and ``hashlib``: the device page arrays,
gathers and copies live in :mod:`.serving`.

* **Free-list allocation.** Pages are interchangeable fixed-size
  blocks of ``page_tokens`` ring slots; allocation is a stack pop.
* **Refcounts and copy-on-write.** A page may back several slots (a
  shared prompt prefix). Writers never change a shared page: the
  scheduler's pre-tick pass copies any page a slot is about to write
  while its refcount is above 1.
* **Prefix table.** Page j of a prompt is keyed by a CHAINED digest of
  ``prompt[:(j+1) * page_tokens]`` (K/V at a position depend on every
  earlier token). Registration is first-wins; a page leaves the table
  when it is freed or its sole owner is about to overwrite it.
* **COW reservations.** Every share that can end in a write (the
  sharer wraps its ring, or a current holder does) attaches one
  reserved page to the shared page; whichever holder writes first
  consumes it, so :class:`PagePoolExhausted` cannot happen mid-decode.

``NULL_PAGE`` (page 0) is reserved: page-table entries no valid ring
slot can reach point at it, so writes of retired rows land in bytes
nothing reads unmasked.

The fleet-cache hooks of the reference (``register_hook``,
``digest_of``) belong to ``ROADMAP.md`` Queue 1 item 10b and are not
copied; ``registered``, the QoS cold-page query, is.
"""

from __future__ import annotations

import hashlib

import numpy as np

__all__ = [
    "NULL_PAGE",
    "PagePool",
    "PagePoolExhausted",
    "prefix_page_digests",
]

NULL_PAGE = 0


class PagePoolExhausted(RuntimeError):
    """No free page satisfies the allocation. Admission treats this as
    "wait for retirements"; raised mid-decode it means the admission
    budget is wrong."""


def prefix_page_digests(prompt, page_tokens: int,
                        max_pages: int | None = None) -> list[bytes]:
    """Chained page-aligned prefix digests of an int token sequence:
    ``digests[j]`` covers ``prompt[:(j+1) * page_tokens]`` (sha256 over
    the int32 bytes, byte-identical to the reference). Only fully
    covered pages get a digest; ``max_pages`` caps the walk."""
    toks = np.ascontiguousarray(np.asarray(prompt, np.int32).reshape(-1))
    n = toks.size // int(page_tokens)
    if max_pages is not None:
        n = min(n, int(max_pages))
    out: list[bytes] = []
    h = hashlib.sha256()
    for j in range(n):
        h.update(toks[j * page_tokens:(j + 1) * page_tokens].tobytes())
        out.append(h.digest())
    return out


class PagePool:
    """Free-list page allocator with refcounts, per-page wrapper counts,
    page-attached COW reservations and a first-wins prefix table.
    Single-threaded: it lives inside the scheduler's tick loop."""

    def __init__(self, n_pages: int, page_tokens: int):
        if n_pages < 2:
            raise ValueError(
                f"n_pages must be >= 2 (page 0 is the reserved null "
                f"page), got {n_pages}"
            )
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        self.n_pages = int(n_pages)
        self.page_tokens = int(page_tokens)
        # LIFO free list: recently freed pages are reused first
        self._free: list[int] = list(range(self.n_pages - 1, 0, -1))
        self._ref = np.zeros(self.n_pages, np.int64)
        self._ref[NULL_PAGE] = 1  # permanently held, never allocatable
        self._digest_to_page: dict[bytes, int] = {}
        self._page_digest: dict[int, bytes] = {}
        # per-page count of current holders whose request wraps its
        # ring (and will overwrite the page)
        self._wrappers: dict[int, int] = {}
        # per-page attached COW reservations and their total
        self._page_reserved: dict[int, int] = {}
        self._reserved = 0
        self.share_hits = 0
        self.cow_copies = 0

    # -- capacity -------------------------------------------------------

    @property
    def free(self) -> int:
        """Pages on the free list (null page excluded)."""
        return len(self._free)

    @property
    def used(self) -> int:
        """Allocated pages (null page excluded)."""
        return self.n_pages - 1 - len(self._free)

    @property
    def reserved(self) -> int:
        """Pages promised to admitted requests for future COW copies."""
        return self._reserved

    def can_alloc(self, n: int, *, reserve: int = 0) -> bool:
        """Would ``n`` allocations plus ``reserve`` new reservations
        fit without eating into existing reservations?"""
        return n + reserve + self._reserved <= len(self._free)

    # -- alloc / refcount ----------------------------------------------

    def alloc(self) -> int:
        """Pop a free page (refcount 1); never a reserved one."""
        if self._reserved >= len(self._free):
            raise PagePoolExhausted(
                f"no unreserved free pages ({len(self._free)} free, "
                f"{self._reserved} reserved, {self.used} used of "
                f"{self.n_pages - 1})"
            )
        pid = self._free.pop()
        self._ref[pid] = 1
        return pid

    def incref(self, pid: int) -> None:
        if self._ref[pid] < 1 or pid == NULL_PAGE:
            raise ValueError(f"incref of unallocated page {pid}")
        self._ref[pid] += 1

    def decref(self, pid: int, *, wrapper: bool = False) -> bool:
        """Drop one reference; True when the page was freed (and left
        the prefix table). ``wrapper=True``: the leaving holder's
        request wraps its ring, so the page's wrapper count drops with
        it. Reservations the drop strands (a page carries at most
        ``refcount - 1``) release."""
        if pid == NULL_PAGE or self._ref[pid] < 1:
            raise ValueError(f"decref of unallocated page {pid}")
        self._ref[pid] -= 1
        if wrapper:
            n = self._wrappers.get(pid, 0)
            if n > 1:
                self._wrappers[pid] = n - 1
            else:
                self._wrappers.pop(pid, None)
        if self._ref[pid] > 0:
            self._clamp_reservation(pid)
            return False
        self._reserved -= self._page_reserved.pop(pid, 0)
        self._wrappers.pop(pid, None)
        d = self._page_digest.pop(pid, None)
        if d is not None:
            self._digest_to_page.pop(d, None)
        self._free.append(pid)
        return True

    def refcount(self, pid: int) -> int:
        return int(self._ref[pid])

    def _clamp_reservation(self, pid: int) -> None:
        cap = int(self._ref[pid]) - 1
        have = self._page_reserved.get(pid, 0)
        if have > cap:
            self._reserved -= have - cap
            if cap:
                self._page_reserved[pid] = cap
            else:
                self._page_reserved.pop(pid, None)

    # -- prefix sharing + copy-on-write ---------------------------------

    def lookup(self, digest: bytes) -> int | None:
        """Resident page holding this prefix digest, or None."""
        return self._digest_to_page.get(digest)

    def registered(self, pid: int) -> bool:
        """Is ``pid`` published in the prefix table? The validity
        witness the QoS cold-page cache keys on: registration drops
        the moment a page's bytes stop matching its digest
        (:meth:`note_write`, COW retarget, free), so a registered
        sole-held page is safe to keep resident for future sharers."""
        return pid in self._page_digest

    def is_volatile(self, pid: int) -> bool:
        """Will a current holder eventually overwrite this page?"""
        return self._wrappers.get(pid, 0) > 0

    def share_needs_reserve(self, pid: int, sharer_wraps: bool) -> bool:
        """Sharing ``pid`` needs a COW reservation when any party can
        ever write it: the sharer wraps, or a current holder does."""
        return sharer_wraps or self.is_volatile(pid)

    def share(self, pid: int, *, reserve: bool,
              wrapper: bool = False) -> None:
        """Take a reference on a prefix page (the admission hit path);
        ``reserve=True`` attaches one COW reservation to the page;
        ``wrapper=True`` adds the sharer to the page's wrapper count."""
        self.incref(pid)
        if wrapper:
            self._wrappers[pid] = self._wrappers.get(pid, 0) + 1
        if reserve:
            if self._reserved >= len(self._free):
                raise PagePoolExhausted(
                    "cannot attach a COW reservation: all free pages "
                    "are already reserved"
                )
            self._page_reserved[pid] = self._page_reserved.get(pid, 0) + 1
            self._reserved += 1
        self.share_hits += 1

    def cow_alloc(self, pid: int) -> int:
        """Allocate the destination page of a copy-on-write of ``pid``,
        consuming the page's attached reservation when it has one (the
        caller copies the bytes, retargets its table entry and decrefs
        ``pid``)."""
        have = self._page_reserved.get(pid, 0)
        if have:
            if have == 1:
                self._page_reserved.pop(pid)
            else:
                self._page_reserved[pid] = have - 1
            self._reserved -= 1
        elif self._reserved >= len(self._free):
            raise PagePoolExhausted(
                f"COW of page {pid} has no reservation and all free "
                "pages are reserved (admission accounting bug)"
            )
        if not self._free:
            raise PagePoolExhausted(
                f"no free pages ({self.used} used of {self.n_pages - 1})"
            )
        new = self._free.pop()
        self._ref[new] = 1
        self.cow_copies += 1
        return new

    def register(self, digest: bytes, pid: int, *,
                 volatile: bool = False) -> None:
        """Publish ``pid`` as the resident page for ``digest``,
        first-wins: an existing mapping, or an existing key of the
        page, is kept. ``volatile=True``: the registering owner wraps
        (it joins the page's wrapper count)."""
        if self._ref[pid] < 1:
            raise ValueError(f"register of unallocated page {pid}")
        if digest in self._digest_to_page or pid in self._page_digest:
            return
        self._digest_to_page[digest] = pid
        self._page_digest[pid] = digest
        if volatile:
            self._wrappers[pid] = self._wrappers.get(pid, 0) + 1

    def note_write(self, pid: int) -> None:
        """A sole owner is about to overwrite ``pid``: its prefix
        digest no longer describes its bytes, so it leaves the table."""
        d = self._page_digest.pop(pid, None)
        if d is not None:
            self._digest_to_page.pop(d, None)

    # -- invariants -----------------------------------------------------

    def check(self) -> None:
        """Structural invariants: free + used == n_pages - 1, free pages
        at refcount 0, registered and volatile pages live, per-page
        reservations within ``refcount - 1`` summing to the total,
        which never exceeds the free list."""
        if len(self._free) + self.used != self.n_pages - 1:
            raise AssertionError("free/used accounting drifted")
        if len(set(self._free)) != len(self._free):
            raise AssertionError("double-free: duplicate page on free list")
        for pid in self._free:
            if self._ref[pid] != 0:
                raise AssertionError(f"free page {pid} has refcount "
                                     f"{self._ref[pid]}")
        for d, pid in self._digest_to_page.items():
            if self._ref[pid] < 1:
                raise AssertionError(f"registered page {pid} is free")
            if self._page_digest.get(pid) != d:
                raise AssertionError("digest tables disagree")
        for pid, n in self._wrappers.items():
            if self._ref[pid] < 1:
                raise AssertionError(f"volatile page {pid} is free")
            if n < 1 or n > self._ref[pid]:
                raise AssertionError(
                    f"page {pid} counts {n} wrappers at refcount "
                    f"{self._ref[pid]}"
                )
        for pid, n in self._page_reserved.items():
            if n < 1 or n > self._ref[pid] - 1:
                raise AssertionError(
                    f"page {pid} carries {n} reservations at refcount "
                    f"{self._ref[pid]}"
                )
        if self._reserved != sum(self._page_reserved.values()):
            raise AssertionError("reservation totals drifted")
        if self._reserved > len(self._free):
            raise AssertionError("reservations exceed the free list")

    def stats(self) -> dict:
        return {
            "n_pages": self.n_pages - 1,
            "free": self.free,
            "used": self.used,
            "reserved": self._reserved,
            "registered_prefix_pages": len(self._digest_to_page),
            "share_hits": self.share_hits,
            "cow_copies": self.cow_copies,
        }
