"""Slot-ring bookkeeping for the zero-copy transports (stdlib + numpy).

A copy of the JAX package's ``native/rings.py``.

The transport moves bulk tensor bytes onto PERSISTENT shared
memory — a broadcast arena on the coordinator side and per-worker result
rings on the worker side (native/transport.py), plus a
``multiprocessing.shared_memory`` twin for :class:`~..backends.process.
ProcessBackend`. All three share the same discipline, factored here:

* a region is mapped ONCE per peer (fd / name passed once), then reused
  across epochs — the per-epoch memfd + 2 mmaps + fd-pass setup the old
  ``isend_shm`` path paid disappears;
* the region is divided into fixed **slots**; a producer acquires a
  slot, writes the payload bytes, and ships only a small control frame
  (slot, length, generation);
* consumers read the bytes **in place** (``np.frombuffer`` views) and a
  slot is only reclaimed once every consumer has RELEASED it — the
  pin-count generalization of the keep-window semantics: a held view
  defers reuse, it never dangles;
* when no slot is free (every one still pinned), the producer FALLS
  BACK to the copying transport for that payload — correctness never
  waits on a consumer's garbage collector.

Release detection rides CPython destruction: served views are numpy
arrays registered with :func:`track_release`; when the last derived
view dies, the finalizer fires and the slot's pin drops. A consumer
that holds a view forever simply keeps that slot pinned (and the
high-water gauge honest).
"""

from __future__ import annotations

import mmap as _mmap
import os as _os
import weakref as _weakref

import numpy as np

__all__ = [
    "next_pow2",
    "RingAlloc",
    "MemfdRegion",
    "HeapRegion",
    "region_create",
    "track_release",
    "as_u8",
]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def as_u8(buf) -> np.ndarray:
    """Any contiguous readable buffer as a flat uint8 view (no copy for
    contiguous ndarrays/bytes; a copy only for non-contiguous input)."""
    if isinstance(buf, np.ndarray):
        a = buf if buf.flags.c_contiguous else np.ascontiguousarray(buf)
        return a.reshape(-1).view(np.uint8)
    mv = memoryview(buf)
    if not mv.c_contiguous:  # pragma: no cover - codec always gives C
        mv = memoryview(bytes(mv))
    return np.frombuffer(mv.cast("B"), np.uint8)


class RingAlloc:
    """Generation-counted slot states for one ring.

    A slot is FREE when it has no holders. ``acquire`` hands out the
    next free slot with a fresh generation; ``add_holder``/``release``
    manage the pin set (holders are opaque hashables: consumer ranks
    for the broadcast arena, the literal ``"view"`` token — one per
    served view — for result rings). Stale releases (old generation)
    are ignored: an ack that raced a slot's reuse must not free the new
    occupant. Not thread-safe by itself; callers serialize (the
    transport's callers all do — see transport.py)."""

    __slots__ = ("slots", "_gen", "_holders", "_clock")

    def __init__(self, slots: int):
        self.slots = int(slots)
        self._gen = [0] * self.slots
        self._holders: list[set] = [set() for _ in range(self.slots)]
        self._clock = 0

    def acquire(self, holders) -> "tuple[int, int] | None":
        """Next free slot as ``(slot, gen)`` with ``holders`` installed
        as its pin set, or None when every slot is pinned."""
        for s in range(self.slots):
            if not self._holders[s]:
                self._clock += 1
                self._gen[s] = self._clock
                self._holders[s] = set(holders)
                return s, self._clock
        return None

    def add_holder(self, slot: int, gen: int, holder) -> bool:
        if self._gen[slot] != gen:
            return False
        self._holders[slot].add(holder)
        return True

    def release(self, slot: int, gen: int, holder) -> None:
        if 0 <= slot < self.slots and self._gen[slot] == gen:
            self._holders[slot].discard(holder)

    def release_holder_everywhere(self, holder) -> None:
        """Drop ``holder`` from every slot (a dead/replaced consumer
        will never ack; its pins must not strand slots forever)."""
        for hs in self._holders:
            hs.discard(holder)

    @property
    def pinned(self) -> int:
        return sum(1 for hs in self._holders if hs)


class MemfdRegion:
    """One anonymous shared-memory region: memfd + a writable mapping
    (+ a flat uint8 numpy view). ``fd`` is what crosses the socket via
    SCM_RIGHTS; the receiving side maps the same pages read-only.
    ``MemfdRegion.create`` returns None where ``memfd_create`` is
    unavailable (callers fall back to the copying transport)."""

    __slots__ = ("fd", "nbytes", "mm", "view")

    def __init__(self, fd: int, nbytes: int):
        self.fd = fd
        self.nbytes = int(nbytes)
        self.mm = _mmap.mmap(fd, self.nbytes, _mmap.MAP_SHARED,
                             _mmap.PROT_READ | _mmap.PROT_WRITE)
        self.view = np.frombuffer(self.mm, np.uint8)
        # np.frombuffer over a writable mmap yields a READ-ONLY array
        # (mmap's buffer export is const on some Python builds); get a
        # writable alias explicitly
        if not self.view.flags.writeable:  # pragma: no cover - build dep
            self.view = np.frombuffer(
                memoryview(self.mm), np.uint8
            )

    @classmethod
    def create(cls, nbytes: int, name: str = "msgt-ring"):
        if not hasattr(_os, "memfd_create"):  # pragma: no cover
            return None
        try:
            fd = _os.memfd_create(name)
            _os.ftruncate(fd, int(nbytes))
            return cls(fd, nbytes)
        except OSError:  # pragma: no cover - exotic kernel/limits
            return None

    def close(self) -> None:
        """Release the producer-side mapping and fd. Pages live on
        while any consumer mapping (or in-flight SCM_RIGHTS fd) exists.
        A mapping pinned by live local views is left in place (same
        BufferError discipline as the worker's shm keep-window)."""
        self.view = None
        try:
            self.mm.close()
        except BufferError:  # views alive; drop our refs, GC finishes
            pass
        if self.fd >= 0:
            _os.close(self.fd)
            self.fd = -1


class HeapRegion:
    """The copy-fallback twin of :class:`MemfdRegion`: one anonymous
    heap-backed buffer with the same ``nbytes``/``view``/``close``
    surface but no ``fd`` — nothing can cross a process boundary
    zero-copy, which is exactly the degradation the callers already
    handle (``MemfdRegion.create`` returning None routes here instead
    of forcing every consumer to grow a second code path). In-process
    consumers still get zero-copy ``view`` slices; cross-process ones
    see ``fd is None`` and fall back to copying frames."""

    __slots__ = ("nbytes", "view")

    fd = None

    def __init__(self, nbytes: int):
        self.nbytes = int(nbytes)
        self.view = np.zeros(self.nbytes, np.uint8)

    def close(self) -> None:
        self.view = None


def region_create(nbytes: int, name: str = "msgt-ring"):
    """A shared-memory region where the platform has ``memfd_create``,
    the heap twin everywhere else — the one-call spelling of the
    fallback dance every ring consumer performs."""
    region = MemfdRegion.create(nbytes, name)
    return HeapRegion(nbytes) if region is None else region


def track_release(view: np.ndarray, callback, *args) -> None:
    """Fire ``callback(*args)`` once, when ``view`` (and every derived
    view keeping it alive) has been destroyed. This is the pin-release
    hook: decoders build ``np.frombuffer`` chains whose base is
    ``view``, so the finalizer fires exactly when no live array can
    read the slot anymore. Callbacks run wherever the last reference
    dies (any thread, possibly interpreter shutdown) — they must be
    exception-safe and lock-free or self-locking."""
    _weakref.finalize(view, callback, *args)
