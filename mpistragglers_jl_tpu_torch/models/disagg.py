"""Disaggregated prefill/decode serving: live KV-page migration.

Counterpart of ``mpistragglers_jl_tpu/models/disagg.py``, copied and
not imported. What differs is where bytes live: a captured ring view
is a set of CUDA tensors (fresh ones: the capture gathers by index),
:func:`ticket_to_frames` copies each leaf to the host explicitly, and
:func:`ticket_from_frames` rebuilds leaves as CPU tensors over the
frames' bytes, which the adopting scheduler copies to its device.
A bfloat16 leaf crosses as its raw 2-byte payload under the dtype name
``"bfloat16"``, the name the JAX package writes, so tickets cross
between the two packages both ways. The PRNG state crosses as the two
``uint32`` words of the request's key (``utils/prng.py``).

A unified fleet makes compute-bound, bursty PREFILL and memory-
bandwidth-bound, steady DECODE contend for the same chips: one
long-prompt burst inflates every tick it shares a scheduler with, and
decode p99 — the inter-token latency users feel — collapses (ROADMAP
item 1; docs/PERF.md round 16 prices it). This module splits the
serving tier in two and moves a request's KV state between the tiers as
a portable page-layout transfer, in the spirit of memory-efficient
array redistribution (arXiv 2112.01075): plan the layout, move pages,
never materialize an intermediate.

Three layers, bottom-up:

* **Scheduler hooks** (models/serving.py): ``export_page_state`` pulls
  one decoding slot's page set out of the pool as a ``(1, W, ...)``
  ring view per layer (fresh device tensors) plus the row's
  token/position/PRNG-key state, freeing the slot;
  ``adopt_page_state`` re-plans the page budget in the destination
  pool — sharing resident prefix-digest pages with COW reservations
  exactly like admission and RE-REGISTERING the request's own chain,
  so copy-on-write sharing survives the move — then scatters the view
  through the new table. A migrated stream equals the never-migrated
  oracle token-for-token (tests/test_disagg.py pins it across fp/int8,
  COW-shared prefixes, and every decode step offset; the port's
  copy, tests/test_torch_disagg.py, holds the same against both
  packages).
* **The planner** (:class:`MigrationPlanner`): owns the window where a
  request is resident NOWHERE — capture on the source, completion on
  the destination, and the cancellation contract in between (a
  ``cancel()`` arriving mid-migration releases planner-held frames and
  any partial destination adoption, never double-frees). The
  in-process fast path hands the captured device arrays straight to
  the destination scatter (no host serialization); cross-process,
  :func:`ticket_to_frames` serializes the page payload into ring-sized
  transfer frames over a :class:`MigrationRing` — the
  ``native/rings.py`` pin-count discipline end-to-end (slots stay
  pinned while any consumer view lives; an all-pinned ring falls back
  to copying frames, never waits).
* **Tier wrappers** (:class:`PrefillWorker` / :class:`DecodeReplica`):
  scheduler-shaped replicas (the router protocol) tagged with a
  ``tier`` attribute and the migration verbs ``migrate_out`` /
  ``can_adopt`` / ``adopt`` / ``migration_nbytes``. In the reference
  a ``RequestRouter`` with ``policy="two_tier"`` is the
  placement brain: fresh requests land on the prefill tier, streams
  past their first token migrate to the decode tier (subject to the
  migration-size threshold). The router and its tier-split sweep are
  ``ROADMAP.md`` Queue 1 item 12b and not in the port yet.
"""

from __future__ import annotations

import mmap as _mmap
import warnings
from typing import Any

import numpy as np
import torch

from ..native.rings import MemfdRegion, RingAlloc, as_u8, track_release

__all__ = [
    "MigrationTicket",
    "MigrationPlanner",
    "MigrationRing",
    "MigrationRingReader",
    "PrefillWorker",
    "DecodeReplica",
    "ticket_to_frames",
    "ticket_from_frames",
    "page_to_frames",
    "page_from_frames",
]


# --------------------------------------------------------------------------
# tickets: the portable request image
# --------------------------------------------------------------------------


class MigrationTicket:
    """One captured request in flight between schedulers: the exported
    page state (models/serving.py ``export_page_state``), the byte/page
    accounting the router's threshold and the PERF byte model price,
    and the release contract — :meth:`release` drops every resource the
    ticket still holds (device arrays, ring-frame pins) and is
    idempotent, so cancel paths can never double-free."""

    __slots__ = ("state", "reason", "pages", "nbytes", "frames",
                 "_ring", "_released", "_owner", "trace")

    def __init__(self, state: dict, *, reason: str = "prefill_done"):
        self.state = state
        self.reason = reason
        self.pages = int(state["n_pages"])
        # bytes actually moved: the request's page set across every
        # layer and leaf (W rows are gathered, but only pages rows are
        # live content — the byte model prices pages, docs/PERF.md)
        per_page = 0
        for cl in state["ring"]:
            for a in cl.values():
                per_page += a.nbytes * state["P"] // a.shape[1]
        self.nbytes = self.pages * per_page
        self.frames: list[list] | None = None
        self._ring: "MigrationRing | None" = None
        self._released = False
        self._owner: "MigrationPlanner | None" = None
        # causal-trace id riding WITH the pages (round 22): set from
        # the captured request so the destination can rejoin a rebuilt
        # request to its trace after a frame-serialized hop
        self.trace = None

    @property
    def request(self):
        """The in-process request object (None when the ticket was
        rebuilt from frames — adoption constructs a fresh one)."""
        return self.state.get("request")

    def release(self) -> None:
        """Drop everything the ticket holds: the captured ring view
        (device buffers) and, when the payload was framed through a
        :class:`MigrationRing`, the sender-side slot pins. Idempotent —
        the mid-migration cancel path and post-adoption cleanup can
        both call it."""
        if self._released:
            return
        self._released = True
        self.state["ring"] = None
        if self.frames is not None and self._ring is not None:
            for seg in self.frames:
                self._ring.release_frames(seg)
        self.frames = None

    def __repr__(self) -> str:
        return (
            f"MigrationTicket({self.reason}, pages={self.pages}, "
            f"{self.nbytes / 1e6:.2f} MB"
            f"{', released' if self._released else ''})"
        )


# --------------------------------------------------------------------------
# leaves between host bytes and tensors
# --------------------------------------------------------------------------

# the dtype names a ticket's meta carries (numpy's, and the JAX
# package's "bfloat16"), and the torch dtype each leaf rebuilds as
_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _leaf_host(a: torch.Tensor) -> tuple[np.ndarray, str]:
    """A cache leaf (a tensor on any device) as a contiguous host array
    plus its dtype name, copied to the host explicitly; bfloat16, which
    numpy lacks, goes as its raw 2-byte payload."""
    t = a.detach().contiguous().cpu()
    name = _NAMES.get(t.dtype)
    if name is None:
        raise TypeError(f"cache leaf of unsupported dtype {t.dtype}")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy(), name


def _leaf_tensor(seg: np.ndarray, shape, dtype: str) -> torch.Tensor:
    """A CPU tensor of ``shape``/``dtype`` over the segment's bytes,
    without a copy: the tensor holds the segment, so a ring slot stays
    pinned until adoption's device copy has consumed it. The frames
    are read-only, and nothing writes through the tensor."""
    if dtype not in _DTYPES:
        raise TypeError(f"ticket leaf of unsupported dtype {dtype!r}")
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given buffer is not writable")
        t = torch.frombuffer(seg, dtype=_DTYPES[dtype])
    return t.reshape(shape)


# --------------------------------------------------------------------------
# ring-sized transfer frames (native/rings.py discipline)
# --------------------------------------------------------------------------


class SlotFrame:
    """One payload chunk resident in a migration-ring slot: the control
    marker that crosses to the consumer, who acks by letting its served
    views die (``track_release`` finalizers drop the pins)."""

    __slots__ = ("slot", "gen", "nbytes")

    def __init__(self, slot: int, gen: int, nbytes: int):
        self.slot = slot
        self.gen = gen
        self.nbytes = nbytes


class CopyFrame:
    """The all-pinned fallback: payload bytes carried in the control
    channel itself. Correctness never waits on a consumer's GC —
    rings.py's contract, inherited wholesale."""

    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = data


class MigrationRing:
    """Sender side of the cross-process migration transport: one memfd
    region divided into fixed slots, :class:`~..native.rings.RingAlloc`
    pin-counting slot lifetimes. ``fd`` is what crosses to the consumer
    once (SCM_RIGHTS on the native transport; inheritance in tests);
    payload bytes cross zero-copy — the consumer maps the same pages
    and reads frames in place. Where ``memfd_create`` is unavailable
    the ring degrades to all-:class:`CopyFrame` transport.

    Pin model: the sender holds one pin per in-flight
    :class:`SlotFrame` (dropped by :meth:`release_frames`, which
    :meth:`MigrationTicket.release` calls); each consumer view adds its
    own holder released by its ``track_release`` finalizer. A slot
    recycles only when both are gone; when every slot is pinned,
    :meth:`send_segment` falls back to copying frames and counts the
    stall."""

    def __init__(self, *, slot_bytes: int = 1 << 20, slots: int = 4,
                 name: str = "disagg-migrate"):
        if slot_bytes < 1 or slots < 1:
            raise ValueError("slot_bytes and slots must be >= 1")
        self.slot_bytes = int(slot_bytes)
        self.slots = int(slots)
        self.region = MemfdRegion.create(self.slots * self.slot_bytes,
                                         name)
        self.alloc = RingAlloc(self.slots)
        self.stalls = 0
        self.zero_copy_bytes = 0
        self.copied_bytes = 0

    @property
    def fd(self) -> int | None:
        return None if self.region is None else self.region.fd

    def send_segment(self, buf) -> list:
        """Stage one payload segment as a frame list: ring-slot frames
        while slots are free, copying frames when every slot is pinned
        (the stall counter records each fallback chunk)."""
        data = as_u8(buf)
        frames: list = []
        n = data.nbytes
        off = 0
        while True:
            take = min(self.slot_bytes, n - off)
            got = None
            if self.region is not None:
                got = self.alloc.acquire(("sender",))
            if got is None:
                if self.region is not None:
                    self.stalls += 1
                frames.append(
                    CopyFrame(data[off:off + take].tobytes())
                )
                self.copied_bytes += take
            else:
                slot, gen = got
                base = slot * self.slot_bytes
                self.region.view[base:base + take] = data[off:off + take]
                frames.append(SlotFrame(slot, gen, take))
                self.zero_copy_bytes += take
            off += take
            if off >= n:
                return frames

    def release_frames(self, frames: list) -> None:
        """Drop the SENDER pin of every slot frame (stale generations
        are ignored by the allocator, so a double release is a no-op).
        Consumer-view pins are untouched — those die with the views."""
        for f in frames:
            if isinstance(f, SlotFrame):
                self.alloc.release(f.slot, f.gen, "sender")

    @property
    def pinned(self) -> int:
        return self.alloc.pinned

    def close(self) -> None:
        if self.region is not None:
            self.region.close()
            self.region = None


class MigrationRingReader:
    """Consumer side: its OWN read-only mapping of the sender's region
    (in-process: built from the ring; cross-process: from the fd that
    crossed once). Frame payloads are served as ``memoryview``s of
    ``track_release``-registered views — the slot stays pinned exactly
    as long as any derived buffer lives, and a stale generation (the
    sender reclaimed and reused the slot before this read) is served as
    a copy rather than a torn view.

    ``add_holder`` / ``release`` default to the sender allocator's
    methods (in-process adoption, the tests); a cross-process consumer
    passes callables that ship ``(slot, gen, token)`` acks back over
    its control channel — the result-ring ack shape of
    native/transport.py."""

    def __init__(self, ring: MigrationRing | None = None, *,
                 fd: int | None = None, slots: int | None = None,
                 slot_bytes: int | None = None, add_holder=None,
                 release=None):
        if ring is not None:
            fd = ring.fd
            slots = ring.slots
            slot_bytes = ring.slot_bytes
            if add_holder is None:
                add_holder = ring.alloc.add_holder
            if release is None:
                release = ring.alloc.release
        self.slot_bytes = int(slot_bytes)
        self._add_holder = add_holder
        self._release = release
        self._n = 0
        if fd is None:
            self._mm = None
            self._view = None
        else:
            self._mm = _mmap.mmap(fd, int(slots) * self.slot_bytes,
                                  _mmap.MAP_SHARED, _mmap.PROT_READ)
            self._view = np.frombuffer(self._mm, np.uint8)

    def frame_payload(self, frame) -> memoryview:
        """One frame's bytes. Slot frames pin their slot for the
        view's lifetime; copy frames are already private bytes."""
        if isinstance(frame, CopyFrame):
            return memoryview(frame.data)
        base = frame.slot * self.slot_bytes
        if self._view is not None and self._add_holder is not None:
            token = ("view", self._n)
            self._n += 1
            if self._add_holder(frame.slot, frame.gen, token):
                v = self._view[base:base + frame.nbytes]
                track_release(v, self._release, frame.slot, frame.gen,
                              token)
                return memoryview(v)
        # stale generation or no ack channel: a private copy is the
        # only view that cannot tear
        return memoryview(
            bytes(self._view[base:base + frame.nbytes])
        )

    def read_segment(self, frames: list) -> np.ndarray:
        """Reassemble one segment as a flat uint8 array — zero-copy
        (memoryview-backed, slot pinned) when the segment fits one
        frame, a private copy when it was chunked."""
        views = [self.frame_payload(f) for f in frames]
        if len(views) == 1:
            return np.frombuffer(views[0], np.uint8)
        return np.frombuffer(b"".join(bytes(v) for v in views),
                             np.uint8)

    def close(self) -> None:
        self._view = None
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:  # served views alive; GC finishes
                pass
            self._mm = None


# --------------------------------------------------------------------------
# frame (de)serialization
# --------------------------------------------------------------------------


def page_to_frames(ring: MigrationRing, payload) -> list:
    """Stage ONE prefix page's KV bytes on the migration ring — the
    cache plane's T3 (peer-fetch) wire unit. A page is a single flat
    segment (the concatenated sorted-leaf row slices the serving
    scheduler's ``_page_payload`` produces), so it rides the same
    frames a ticket leaf does: slot frames while the ring has room,
    copying frames under pin pressure. The caller owns the sender
    pins until :func:`page_from_frames` (or ``release_frames``)."""
    return ring.send_segment(payload)


def page_from_frames(reader: MigrationRingReader, frames: list, *,
                     ring: MigrationRing | None = None) -> np.ndarray:
    """Read one page back off its frames as a flat uint8 array, then
    (when ``ring`` is given — the in-process adoption shape) drop the
    sender pins; consumer-view pins keep the bytes alive until the
    returned array dies, so the destination can device-scatter from
    it without a defensive copy."""
    out = reader.read_segment(frames)
    if ring is not None:
        ring.release_frames(frames)
    return out


def ticket_to_frames(ticket: MigrationTicket,
                     ring: MigrationRing) -> dict:
    """Serialize a ticket's page payload into ring-sized transfer
    frames: one segment per cache leaf (plus the prompt and PRNG-key
    segments), each staged through ``ring``. Returns the JSON-able
    meta dict; the frame lists land on ``ticket.frames`` (the ticket
    now holds the sender pins — :meth:`MigrationTicket.release` frees
    them). The meta + frames pair is everything the receiving process
    needs (:func:`ticket_from_frames`); shipping them is the caller's
    control channel's job."""
    if ticket.state.get("ring") is None:
        raise ValueError("ticket already released or framed")
    st = ticket.state
    segs: list[np.ndarray] = [
        np.ascontiguousarray(np.asarray(st["prompt"], np.int32)),
        np.ascontiguousarray(np.asarray(st["key_data"])),
    ]
    layers_meta = []
    for cl in st["ring"]:
        leaf_meta = []
        for kk in sorted(cl):
            a, dtype = _leaf_host(cl[kk])
            leaf_meta.append([kk, list(a.shape), dtype])
            segs.append(a)
        layers_meta.append(leaf_meta)
    ticket.frames = [ring.send_segment(s) for s in segs]
    ticket._ring = ring
    st["ring"] = None  # the frames are the payload now
    meta = {
        "reason": ticket.reason,
        "tokens": list(st["tokens"]),
        "max_new": int(st["max_new"]),
        "tok": int(st["tok"]),
        "pos": int(st["pos"]),
        "digests": [d.hex() for d in st["digests"]],
        "n_cover": int(st["n_cover"]),
        "n_pages": int(st["n_pages"]),
        "P": int(st["P"]),
        "W": int(st["W"]),
        "quantize_kv": bool(st["quantize_kv"]),
        "temperature": float(st["temperature"]),
        "top_k": st["top_k"],
        "eos_id": st["eos_id"],
        "key_dtype": str(np.asarray(st["key_data"]).dtype),
        "layers": layers_meta,
    }
    return meta


def ticket_from_frames(meta: dict, frames: list[list],
                       reader: MigrationRingReader) -> MigrationTicket:
    """Rebuild a ticket on the consumer side: segments read through
    ``reader`` (zero-copy views where whole, the slots staying pinned
    until adoption's device copy consumed them), leaf arrays rewrapped
    at their recorded shapes/dtypes. The rebuilt ticket carries no
    request object — ``adopt`` constructs a fresh one. Leaves come back
    as CPU tensors over the frames (bfloat16 by its bytes)."""
    it = iter(frames)
    # prompt and key state are copied out: they outlive adoption (the
    # rebuilt Request keeps its prompt for the stream's whole life, and
    # a zero-copy view there would pin its ring slot forever). The
    # LEAVES below stay zero-copy — they are the payload bulk and die
    # with the adoption scatter.
    prompt = np.frombuffer(
        reader.read_segment(next(it)), np.int32
    ).copy()
    key_data = np.frombuffer(
        reader.read_segment(next(it)), np.dtype(meta["key_dtype"])
    ).copy()
    ring = []
    for leaf_meta in meta["layers"]:
        cl = {}
        for kk, shape, dtype in leaf_meta:
            seg = reader.read_segment(next(it))
            cl[kk] = _leaf_tensor(seg, shape, dtype)
        ring.append(cl)
    state = {
        "request": None,
        "prompt": prompt,
        "tokens": list(meta["tokens"]),
        "max_new": int(meta["max_new"]),
        "tok": int(meta["tok"]),
        "pos": int(meta["pos"]),
        "key_data": key_data,
        "ring": ring,
        "digests": tuple(bytes.fromhex(d) for d in meta["digests"]),
        "n_cover": int(meta["n_cover"]),
        "n_pages": int(meta["n_pages"]),
        "P": int(meta["P"]),
        "W": int(meta["W"]),
        "quantize_kv": bool(meta["quantize_kv"]),
        "temperature": float(meta["temperature"]),
        "top_k": meta["top_k"],
        "eos_id": meta["eos_id"],
    }
    return MigrationTicket(state, reason=meta.get("reason",
                                                  "prefill_done"))


# --------------------------------------------------------------------------
# the planner
# --------------------------------------------------------------------------


class MigrationPlanner:
    """Owns in-flight migrations: capture on the source scheduler,
    completion on the destination, and the cancel contract for the
    window in between, where the request is resident nowhere.

    The books are keyed on the captured request object's ``id`` (the
    scheduler-global request counter), so ``cancel(req)`` finds a
    mid-migration request no scheduler knows anymore — the losing-
    hedge-leg/cancelled-stream case the router relies on. Cancelling
    releases the ticket (device arrays, ring-frame pins) and marks the
    request cancelled; a ticket already landed is no longer here
    (completion removed it), so the destination's ordinary
    ``cancel()`` takes over and nothing double-frees — pinned by the
    drains-to-baseline tests in tests/test_disagg.py."""

    def __init__(self, *, ring: MigrationRing | None = None):
        self.ring = ring
        self._inflight: dict[int, MigrationTicket] = {}
        self.n_captured = 0
        self.n_landed = 0
        self.n_cancelled = 0

    def capture(self, src, req, *,
                reason: str = "prefill_done") -> MigrationTicket:
        """Export ``req`` from ``src`` (a paged scheduler or a tier
        wrapper) into a ticket; the source slot and pages are freed
        before this returns."""
        sched = getattr(src, "sched", src)
        state = sched.export_page_state(req)
        ticket = MigrationTicket(state, reason=reason)
        ticket.trace = getattr(req, "trace", None)
        ticket._owner = self
        self._inflight[req.id] = ticket
        self.n_captured += 1
        return ticket

    def complete(self, dst, ticket: MigrationTicket,
                 request=None) -> Any:
        """Land ``ticket`` on ``dst``; returns the continued request
        (the captured object in-process, a rebuilt one from frames).
        The ticket leaves the in-flight book first — a cancel racing
        this call either wins (the adopt below never runs: the ticket
        is released and raises) or loses (the book is empty, cancel
        falls through to the destination scheduler)."""
        if ticket._released:
            raise ValueError("cannot adopt a released ticket")
        sched = getattr(dst, "sched", dst)
        req = ticket.request
        # the in-flight entry lives on the planner that CAPTURED the
        # ticket (per-replica planners: the destination's planner may
        # be a different object — popping only our own book would leak
        # the owner's entry forever)
        owner = ticket._owner if ticket._owner is not None else self
        if req is not None:
            owner._inflight.pop(req.id, None)
        try:
            out = sched.adopt_page_state(ticket.state, request=request)
        except Exception:
            # adoption refused (capacity race, config mismatch): the
            # ticket is still in flight and must stay cancellable
            if req is not None:
                owner._inflight[req.id] = ticket
            raise
        self.n_landed += 1
        if ticket.trace is not None \
                and getattr(out, "trace", None) is None:
            # a request rebuilt from frames rejoins its trace here
            out.trace = ticket.trace
        ticket.state["request"] = out
        ticket.release()
        return out

    def cancel(self, req) -> bool:
        """Withdraw a request captured but not yet landed: release the
        ticket's resources and retire the request as cancelled.
        False when no migration of ``req`` is in flight here."""
        ticket = self._inflight.pop(getattr(req, "id", None), None)
        if ticket is None:
            return False
        ticket.release()
        req.finished = True
        req.reason = "cancelled"
        self.n_cancelled += 1
        return True

    @property
    def in_flight(self) -> int:
        return len(self._inflight)


# --------------------------------------------------------------------------
# tier wrappers (the router's replica protocol + migration verbs)
# --------------------------------------------------------------------------


class _TierReplica:
    """Shared half of the tier wrappers: a paged
    :class:`~.serving.ServingScheduler` plus a (shareable)
    :class:`MigrationPlanner`, delegating the whole replica protocol
    to the scheduler and adding the migration verbs the two-tier
    router drives. ``cancel`` covers all three residencies — the
    scheduler's books, then the planner's mid-migration window."""

    tier = "unified"

    def __init__(self, sched, *, planner: MigrationPlanner | None = None):
        if not getattr(sched, "paged", False):
            raise ValueError(
                f"{type(self).__name__} needs a paged scheduler "
                "(page_tokens=): migration is a page-layout transfer"
            )
        self.sched = sched
        self.planner = planner if planner is not None \
            else MigrationPlanner()

    # -- replica protocol (delegated) -----------------------------------
    def submit(self, prompt, max_new: int, key=None, trace=None):
        if trace is None:
            return self.sched.submit(prompt, max_new, key=key)
        return self.sched.submit(prompt, max_new, key=key,
                                 trace=trace)

    def step(self):
        return self.sched.step()

    def cancel(self, req) -> bool:
        return self.sched.cancel(req) or self.planner.cancel(req)

    @property
    def pending(self) -> int:
        return self.sched.pending

    @property
    def active(self) -> int:
        return self.sched.active

    def __getattr__(self, name):
        # pool/P/max_pages/paged/S/last_tick_at/...: the scheduler's
        # surface IS this replica's surface. __dict__ access keeps a
        # half-constructed instance an AttributeError, not recursion.
        sched = self.__dict__.get("sched")
        if sched is None:
            raise AttributeError(name)
        return getattr(sched, name)

    # -- migration verbs -------------------------------------------------
    def migration_nbytes(self, req) -> int:
        return self.sched.migration_nbytes(req)

    def migrate_out(self, req, *,
                    reason: str = "prefill_done") -> MigrationTicket:
        return self.planner.capture(self.sched, req, reason=reason)

    def can_adopt(self, ticket: MigrationTicket) -> bool:
        return (
            not ticket._released
            and self.sched.can_adopt_state(ticket.state)
        )

    def could_adopt(self, ticket: MigrationTicket) -> bool:
        """Could this replica EVER adopt ``ticket`` (page budget fits
        an empty pool, config compatible)? The router's park-vs-bounce
        signal — see :meth:`~.serving.ServingScheduler.could_adopt_state`."""
        return (
            not ticket._released
            and self.sched.could_adopt_state(ticket.state)
        )

    def adopt(self, ticket: MigrationTicket, request=None):
        return self.planner.complete(self.sched, ticket,
                                     request=request)

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(active={self.active}, "
            f"pending={self.pending})"
        )


class PrefillWorker(_TierReplica):
    """The prefill tier: runs admission + chunked prefill into pages
    and hands streams off at their first token (``ready()`` lists
    them; the two-tier router drives ``migrate_out`` itself). Still a
    complete scheduler — requests under the migration-size threshold
    (or with no adoptable decode replica) simply keep decoding here,
    so the tier degrades gracefully instead of wedging."""

    tier = "prefill"

    def ready(self) -> list:
        """Requests past their first token and migratable right now —
        decoding slots, admission complete, stream unfinished."""
        sched = self.sched
        return [
            r for s, r in enumerate(sched._slot_req)
            if r is not None and s not in sched._admitting
            and r.tokens and not r.finished
        ]


class DecodeReplica(_TierReplica):
    """The decode tier: adopts migrated page sets (``adopt`` — pages
    landed via :class:`~.paging.PagePool` adoption, prefix chains
    re-registered) and runs the existing paged decode tick. Fresh
    submits still work (the router only sends them here when the
    prefill tier is gone — availability over purity)."""

    tier = "decode"
