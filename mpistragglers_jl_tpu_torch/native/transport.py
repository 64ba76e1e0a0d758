"""ctypes bindings for the native message transport (transport.cpp).

A copy of the JAX package's ``native/transport.py``, loading the port's
own build of ``transport.cpp`` (``native/_build/``).

The C++ library supplies the MPI-shaped primitives (isend / test / waitany
/ dead-rank detection over Unix-domain sockets with an epoll progress
thread — the reference's libmpi role, SURVEY component C8); this module
wraps them in two small classes:

* :class:`Coordinator` — rank-indexed non-blocking sends, completion
  polls, waitany, payload harvest.
* :class:`Worker` — blocking receive/send loop primitives for worker
  processes.

Payloads are opaque bytes at this layer; the backend above
(:mod:`..backends.native`) owns serialization. No fallback exists here on
purpose — consumers (the backend) catch :class:`NativeBuildError` and use
the pure-Python :class:`~..backends.process.ProcessBackend` instead.
"""

from __future__ import annotations

import ctypes
import itertools as _itertools
import mmap as _mmap
import os as _os
import struct as _struct
import threading as _threading
import time as _time
from dataclasses import dataclass

import numpy as np

from . import rings as _rings

KIND_DATA = 0
KIND_CONTROL = 1
KIND_HELLO = 2
KIND_DEATH = 3
KIND_ERROR = 4
KIND_SHM = 5  # transport-internal: body rides shared memory, not the wire
# Persistent zero-copy paths (transport-internal kinds; both
# resolve to KIND_DATA messages with out-of-band bodies):
KIND_ARENA = 6  # body in the coordinator's persistent broadcast arena
KIND_RING = 7   # body in the sending worker's persistent result ring
KIND_ACK = 8    # slot-release acknowledgements (either direction)

# Bodies below these ride the legacy copying paths (tiny frames are
# cheaper through the socket than a shm slot + control frame + ack).
ARENA_MIN = 1 << 20
RING_MIN = 1 << 16
ARENA_SLOTS = 4  # double-buffering generalized: in-flight + harvest +
RING_SLOTS = 4   # one retained view + one spare before fallback

# Control-frame headers for the persistent paths (little-endian):
# (object id, region capacity, slot count, slot, generation, body len)
_RING_HDR = _struct.Struct("<6q")
# One ack record: (object id, slot, generation). id == -1 is a
# worker->coordinator ring-full stall report (count rides in `slot`).
_ACK_REC = _struct.Struct("<3q")


class _Header(ctypes.Structure):
    _fields_ = [
        ("len", ctypes.c_int64),
        ("seq", ctypes.c_int64),
        ("epoch", ctypes.c_int64),
        ("tag", ctypes.c_int64),
        ("kind", ctypes.c_int64),
    ]


@dataclass(frozen=True)
class Message:
    """One received frame: bookkeeping header + raw payload bytes.

    ``payload`` is a ``bytearray`` (or ``bytes``): the receive path
    copies the frame exactly once, socket -> this buffer, and decoders
    (``np.frombuffer``, ``pickle.loads``) consume it without further
    copies."""

    seq: int
    epoch: int
    tag: int
    kind: int
    payload: "bytes | bytearray"
    # out-of-band body (shared-memory broadcasts, arena frames, result
    # rings): the codec prefix is in ``payload`` and the bytes live in
    # a mapped region. Holding the view PINS its backing: keep-window
    # eviction of one-shot shm regions defers until the view is
    # released (mmap.close() raises BufferError while buffers are
    # exported), and a persistent arena/ring SLOT is not reused until
    # the release ack fires (weakref finalizer on the served view) —
    # the view never dangles and never tears; it just keeps memory
    # resident. Release or copy when done.
    body: "memoryview | np.ndarray | None" = None


def _addr_len(buf) -> tuple[int, int, object]:
    """(address, nbytes, keepalive) of any contiguous readable buffer.

    ``keepalive`` is whatever object OWNS the memory behind ``address``
    (a temporary copy for non-contiguous/readonly inputs) — the caller
    must hold it until the native call returns, or the address dangles.
    """
    if isinstance(buf, np.ndarray):
        if not buf.flags.c_contiguous:
            buf = np.ascontiguousarray(buf)
        return buf.ctypes.data, buf.nbytes, buf
    if isinstance(buf, bytes):
        return ctypes.cast(buf, ctypes.c_void_p).value or 0, len(buf), buf
    if isinstance(buf, bytearray):
        if not buf:
            return 0, 0, buf
        addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
        return addr, len(buf), buf
    mv = memoryview(buf)
    if not mv.c_contiguous:
        mv = memoryview(bytes(mv))
    if mv.nbytes == 0:
        return 0, 0, mv
    if mv.readonly:
        b = bytes(mv)
        return ctypes.cast(b, ctypes.c_void_p).value or 0, len(b), b
    export = (ctypes.c_char * mv.nbytes).from_buffer(mv)
    return ctypes.addressof(export), mv.nbytes, export


def _configure(lib):
    lib.msgt_coord_create.restype = ctypes.c_void_p
    lib.msgt_coord_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int
    ]
    lib.msgt_coord_port.restype = ctypes.c_int
    lib.msgt_coord_port.argtypes = [ctypes.c_void_p]
    lib.msgt_coord_accept.restype = ctypes.c_int
    lib.msgt_coord_accept.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.msgt_coord_isend.restype = ctypes.c_int
    lib.msgt_coord_isend.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.msgt_coord_poll.restype = ctypes.c_int
    lib.msgt_coord_poll.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_Header)
    ]
    lib.msgt_coord_take.restype = ctypes.c_int64
    lib.msgt_coord_take.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.msgt_coord_waitany.restype = ctypes.c_int
    lib.msgt_coord_waitany.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.c_int64,
    ]
    lib.msgt_coord_is_dead.restype = ctypes.c_int
    lib.msgt_coord_is_dead.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.msgt_coord_reaccept.restype = ctypes.c_int
    lib.msgt_coord_reaccept.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    ]
    lib.msgt_coord_error.restype = ctypes.c_int
    lib.msgt_coord_error.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
    ]
    lib.msgt_coord_destroy.restype = None
    lib.msgt_coord_destroy.argtypes = [ctypes.c_void_p]
    lib.msgt_worker_connect.restype = ctypes.c_void_p
    lib.msgt_worker_connect.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int
    ]
    lib.msgt_hmac_sha256.restype = None
    lib.msgt_hmac_sha256.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.msgt_worker_recv_hdr.restype = ctypes.c_int
    lib.msgt_worker_recv_hdr.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_Header)
    ]
    lib.msgt_worker_recv_payload.restype = ctypes.c_int
    lib.msgt_worker_recv_payload.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64
    ]
    lib.msgt_worker_send.restype = ctypes.c_int
    lib.msgt_worker_send.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
    ]
    # zero-copy path: two-buffer sends + shared broadcast payloads. The
    # buffer args are c_void_p (NOT c_char_p) so writable buffers and
    # raw ndarray memory pass without a bytes conversion copy.
    lib.msgt_coord_isend2.restype = ctypes.c_int
    lib.msgt_coord_isend2.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.msgt_payload_create.restype = ctypes.c_void_p
    lib.msgt_payload_create.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.msgt_payload_release.restype = None
    lib.msgt_payload_release.argtypes = [ctypes.c_void_p]
    lib.msgt_coord_isend_shared.restype = ctypes.c_int
    lib.msgt_coord_isend_shared.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.msgt_worker_send2.restype = ctypes.c_int
    lib.msgt_worker_send2.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64,
    ]
    lib.msgt_worker_close.restype = None
    lib.msgt_worker_close.argtypes = [ctypes.c_void_p]
    # shared-memory broadcast payloads (same-host zero-copy)
    lib.msgt_payload_create_shm.restype = ctypes.c_void_p
    lib.msgt_payload_create_shm.argtypes = [
        ctypes.c_void_p, ctypes.c_int64
    ]
    lib.msgt_payload_release_shm.restype = None
    lib.msgt_payload_release_shm.argtypes = [ctypes.c_void_p]
    lib.msgt_coord_isend_shm.restype = ctypes.c_int
    lib.msgt_coord_isend_shm.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.msgt_worker_take_fd.restype = ctypes.c_int
    lib.msgt_worker_take_fd.argtypes = [ctypes.c_void_p]
    # persistent zero-copy paths: fd-carrying sends + the
    # coordinator-side fd queue for worker result rings
    lib.msgt_coord_isend_fd.restype = ctypes.c_int
    lib.msgt_coord_isend_fd.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.msgt_coord_take_fd.restype = ctypes.c_int
    lib.msgt_coord_take_fd.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.msgt_worker_send_fd.restype = ctypes.c_int
    lib.msgt_worker_send_fd.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
    ]


def load_lib():
    """Compile (if stale) and load the transport library; success and
    failure both memoized process-wide by :func:`..native.load`."""
    from . import load

    return load("transport", _configure)


class TransportError(RuntimeError):
    pass


def hmac_sha256(key: bytes, msg: bytes) -> bytes:
    """The native HMAC-SHA256 the hello handshake authenticates with,
    exposed so tests can check conformance against :mod:`hmac`."""
    lib = load_lib()
    out = (ctypes.c_uint8 * 32)()
    lib.msgt_hmac_sha256(key, len(key), msg, len(msg), out)
    return bytes(out)


class Coordinator:
    """Coordinator endpoint: owns the listening socket and the native
    progress thread; one connection per worker rank."""

    def __init__(
        self, path: str, n_workers: int, *, token: bytes = b"",
        zero_copy: bool = True,
    ):
        """``path`` is a Unix-socket filesystem path (single host) or
        ``tcp://host:port`` (multi-host; port 0 binds an ephemeral port,
        see :attr:`port`). A non-empty ``token`` turns on hello
        authentication: every worker must present the same secret
        (proved by HMAC-SHA256 challenge-response; the secret never
        crosses the wire) before its rank is admitted. An empty token
        admits any connector — acceptable only on trusted networks.

        ``zero_copy=False`` disables every shared-memory path (the
        persistent broadcast arena, worker result rings, AND the legacy
        per-epoch shm payloads) — the copying socket transport only,
        for baselines and debugging. Shared memory is same-host only;
        TCP transports are copying regardless."""
        self._lib = load_lib()
        self.n_workers = int(n_workers)
        self.path = path
        self.token = bytes(token)
        self._h = self._lib.msgt_coord_create(
            path.encode(), self.n_workers, self.token, len(self.token)
        )
        if not self._h:
            raise TransportError(f"could not bind coordinator socket {path}")
        self.port = int(self._lib.msgt_coord_port(self._h))
        self.zero_copy = bool(zero_copy) and not path.startswith("tcp://")
        # persistent zero-copy state. RLock, not Lock: slot releases
        # fire from weakref finalizers, which can run via GC on a
        # thread that already holds the lock.
        self._zlock = _threading.RLock()
        self._arena: "_BroadcastArena | None" = None       # current
        self._arenas: dict[int, _BroadcastArena] = {}      # id -> live
        self._arena_ids = _itertools.count(1)
        self._arena_fd_sent: set[tuple[int, int]] = set()  # (rank, id)
        self._rings: dict[tuple[int, int], _mmap.mmap] = {}
        self._ring_orphans: list[_mmap.mmap] = []
        # transport-level telemetry, sampled by the backend's opt-in
        # registry wiring (backends/native.py): bytes served without a
        # userspace copy, allocation stalls (every slot pinned), and
        # the pinned-slot gauge/high-water for harvested ring views
        self.stats = {
            "arena_bytes": 0, "ring_bytes": 0, "arena_stalls": 0,
            "ring_stalls": 0, "ring_pinned": 0, "pinned_peak": 0,
        }

    @property
    def address(self) -> str:
        """The address workers should connect to (ephemeral TCP ports
        resolved to the actual bound port)."""
        if self.path.startswith("tcp://"):
            host = self.path[6:].rsplit(":", 1)[0]
            return f"tcp://{host}:{self.port}"
        return self.path

    def _handle(self):
        # a NULL handle into the C ABI would segfault, not raise
        if not self._h:
            raise TransportError("coordinator is closed")
        return self._h

    def accept(self, timeout: float = 30.0) -> None:
        """Wait for all workers to connect and complete the hello
        handshake, then start the progress engine. ``timeout`` bounds
        the whole handshake, stalled hellos included."""
        rc = self._lib.msgt_coord_accept(self._handle(), int(timeout * 1000))
        if rc != 0:
            raise TransportError(
                f"workers failed to connect within {timeout}s"
            )

    def isend(
        self, rank: int, payload: bytes, *,
        seq: int = 0, epoch: int = 0, tag: int = 0, kind: int = KIND_DATA,
    ) -> bool:
        """Non-blocking send; payload is snapshotted into the native send
        queue. Returns False if the rank is dead."""
        if not isinstance(payload, bytes):
            payload = bytes(payload)  # c_char_p wants immutable bytes
        rc = self._lib.msgt_coord_isend(
            self._handle(), int(rank), seq, epoch, tag, kind, payload,
            len(payload),
        )
        return rc == 0

    def isend2(
        self, rank: int, prefix: bytes, body, *,
        seq: int = 0, epoch: int = 0, tag: int = 0, kind: int = KIND_DATA,
    ) -> bool:
        """Two-buffer non-blocking send: ``prefix`` (small codec header)
        and ``body`` (any contiguous buffer — ndarray memory passes
        directly) are snapshotted as separate segments; the wire frame
        is header+prefix+body with no Python-side concatenation."""
        paddr, plen, pkeep = _addr_len(prefix)
        baddr, blen, bkeep = _addr_len(body)
        rc = self._lib.msgt_coord_isend2(
            self._handle(), int(rank), seq, epoch, tag, kind,
            paddr, plen, baddr, blen,
        )
        del pkeep, bkeep  # held across the (synchronously copying) call
        return rc == 0

    def payload(self, body) -> "SharedPayload | ShmPayload":
        """Snapshot ``body`` ONCE for a broadcast; pass to
        :meth:`isend_shared` for each rank (the pool's per-epoch
        pattern). On same-host (Unix-socket) transports the snapshot is
        a shared-memory region: workers map the SAME pages, so the
        body's bytes never cross the sockets at all — one memcpy per
        broadcast, total. TCP transports snapshot into a native buffer
        shared across the n send queues (one memcpy instead of n)."""
        _, n, _keep = _addr_len(body)
        # shm pays a fixed per-epoch setup (memfd + 2 mmaps + fd pass);
        # it wins when the broadcast is wide and the body large, loses
        # for single workers / small frames where socket copies are cheap.
        # (The PERSISTENT broadcast arena — arena_payload — removes that
        # per-epoch setup entirely; this one-shot path remains the
        # fallback when every arena slot is pinned.)
        if self.zero_copy and self.n_workers >= 2 and n >= ARENA_MIN:
            shm = ShmPayload(self._lib, body)
            if shm._h is not None:  # memfd unavailable -> socket path
                return shm
        return SharedPayload(self._lib, body)

    def arena_payload(self, body) -> "ArenaPayload | None":
        """Stage ``body`` in the persistent broadcast arena: one memcpy
        into a slot of a memfd region that every worker maps ONCE (the
        fd crosses the socket a single time per worker, on the first
        arena frame that rank sees) — the per-epoch memfd + 2 mmaps +
        fd-pass setup of the one-shot :class:`ShmPayload` path is gone.

        Returns None when the arena path does not apply (TCP/single
        worker/small body/no memfd) or when every slot is still pinned
        by unreleased worker views — callers fall back to
        :meth:`payload`, so correctness never waits on a consumer's
        garbage collector. A slot is reclaimed only after every rank it
        was sent to acks release (worker-side weakref finalizers on the
        served views, piggybacked on the worker's next send), the
        pin-count generalization of the keep-window discipline."""
        if not self.zero_copy or self.n_workers < 2:
            return None
        u8 = _rings.as_u8(body)
        n = u8.nbytes
        if n < ARENA_MIN:
            return None
        with self._zlock:
            arena = self._arena
            if arena is None or arena.slot_bytes < n:
                region = _rings.MemfdRegion.create(
                    _rings.next_pow2(n) * ARENA_SLOTS, "msgt-arena"
                )
                if region is None:  # no memfd on this kernel
                    return None
                arena = _BroadcastArena(
                    next(self._arena_ids), region, ARENA_SLOTS
                )
                self._arena = arena
                self._arenas[arena.id] = arena
                self._gc_arenas_locked()
            got = arena.alloc.acquire(("coord",))
            if got is None:
                # dead ranks never ack: reap their pins, then retry
                for r in range(self.n_workers):
                    if self._h and self._lib.msgt_coord_is_dead(
                        self._h, r
                    ):
                        arena.alloc.release_holder_everywhere(r)
                got = arena.alloc.acquire(("coord",))
            if got is None:
                self.stats["arena_stalls"] += 1
                return None
            slot, gen = got
        off = slot * arena.slot_bytes
        arena.region.view[off:off + n] = u8  # slot exclusively ours
        return ArenaPayload(self, arena, slot, gen, n)

    def _isend_arena(
        self, rank: int, prefix: bytes, p: "ArenaPayload", *,
        seq: int, epoch: int, tag: int,
    ) -> bool:
        arena = p.arena
        data = _RING_HDR.pack(
            arena.id, arena.region.nbytes, arena.slots, p.slot, p.gen,
            p.nbytes,
        ) + (prefix if isinstance(prefix, bytes) else bytes(prefix))
        with self._zlock:
            arena.alloc.add_holder(p.slot, p.gen, int(rank))
            first = (int(rank), arena.id) not in self._arena_fd_sent
            if first:
                self._arena_fd_sent.add((int(rank), arena.id))
        if first:
            rc = self._lib.msgt_coord_isend_fd(
                self._handle(), int(rank), seq, epoch, tag, KIND_ARENA,
                data, len(data), arena.region.fd,
            )
            if rc == -2:  # fd table full: copying send, same semantics
                with self._zlock:
                    self._arena_fd_sent.discard((int(rank), arena.id))
                    arena.alloc.release(p.slot, p.gen, int(rank))
                off = p.slot * arena.slot_bytes
                return self.isend2(
                    rank, prefix, arena.region.view[off:off + p.nbytes],
                    seq=seq, epoch=epoch, tag=tag,
                )
        else:
            rc = self._lib.msgt_coord_isend(
                self._handle(), int(rank), seq, epoch, tag, KIND_ARENA,
                data, len(data),
            )
        with self._zlock:
            if rc != 0:
                arena.alloc.release(p.slot, p.gen, int(rank))
                return False
            self.stats["arena_bytes"] += p.nbytes
        return True

    def _gc_arenas_locked(self) -> None:
        """Close superseded arenas once fully drained (caller holds
        ``_zlock``). Worker-side mappings are independent and follow
        their own keep-window eviction."""
        for aid in list(self._arenas):
            a = self._arenas[aid]
            if a is not self._arena and a.alloc.pinned == 0:
                a.region.close()
                del self._arenas[aid]
                self._arena_fd_sent = {
                    k for k in self._arena_fd_sent if k[1] != aid
                }

    def _handle_ack(self, rank: int, payload) -> None:
        """Worker ack frame: release arena slots this rank held, and
        absorb its ring-full stall reports."""
        mv = memoryview(payload)
        usable = len(mv) - len(mv) % _ACK_REC.size
        with self._zlock:
            for off in range(0, usable, _ACK_REC.size):
                oid, slot, gen = _ACK_REC.unpack_from(mv, off)
                if oid == -1:
                    self.stats["ring_stalls"] += int(slot)
                    continue
                arena = self._arenas.get(oid)
                if arena is not None:
                    arena.alloc.release(int(slot), int(gen), int(rank))
            self._gc_arenas_locked()

    def isend_shared(
        self, rank: int, prefix: bytes, payload, *,
        seq: int = 0, epoch: int = 0, tag: int = 0, kind: int = KIND_DATA,
    ) -> bool:
        if payload._h is None:
            raise TransportError("shared payload already released")
        if isinstance(payload, ArenaPayload):
            if kind != KIND_DATA:
                raise ValueError("arena payloads carry data frames only")
            return self._isend_arena(
                rank, prefix, payload, seq=seq, epoch=epoch, tag=tag
            )
        paddr, plen, pkeep = _addr_len(prefix)
        if isinstance(payload, ShmPayload):
            if kind != KIND_DATA:
                raise ValueError("shm payloads carry data frames only")
            rc = self._lib.msgt_coord_isend_shm(
                self._handle(), int(rank), seq, epoch, tag,
                paddr, plen, payload._h,
            )
            return rc == 0
        rc = self._lib.msgt_coord_isend_shared(
            self._handle(), int(rank), seq, epoch, tag, kind,
            paddr, plen, payload._h,
        )
        return rc == 0

    def poll(self, rank: int) -> Message | None:
        """Non-blocking probe-and-take (``MPI.Test!``): returns the next
        completed message for ``rank`` (a ``KIND_DEATH`` message if the
        rank died), or None. Transport-internal frames (slot-release
        acks) are consumed here, invisibly; result-ring frames resolve
        to ``KIND_DATA`` messages whose body is a zero-copy view into
        the worker's ring."""
        while True:
            hdr = _Header()
            if not self._lib.msgt_coord_poll(
                self._handle(), int(rank), ctypes.byref(hdr)
            ):
                return None
            msg = self._take(rank, hdr)
            if msg.kind == KIND_ACK:
                self._handle_ack(rank, msg.payload)
                continue
            if msg.kind == KIND_RING:
                out = self._resolve_ring(rank, msg)
                if out is None:
                    continue  # announce fd lost to a death race; the
                    # sticky death marker surfaces on a later poll
                return out
            return msg

    def _resolve_ring(self, rank: int, msg: Message) -> Message | None:
        """Resolve a result-ring control frame to a message whose body
        is a read-only zero-copy view into the worker's ring, adopting
        the ring fd (SCM_RIGHTS) on first sight. The view is tracked:
        when the last derived array dies, a release ack flows back so
        the worker can reuse the slot."""
        rid, cap, slots, slot, gen, blen = _RING_HDR.unpack_from(
            msg.payload, 0
        )
        prefix = bytes(memoryview(msg.payload)[_RING_HDR.size:])
        key = (int(rank), int(rid))
        with self._zlock:
            mm = self._rings.get(key)
            if mm is None:
                fd = self._lib.msgt_coord_take_fd(self._handle(), int(rank))
                if fd < 0:
                    # the fd rides the announcing frame's first byte, so
                    # it can only be missing if the rank died and its fd
                    # queue was reaped
                    if self._lib.msgt_coord_is_dead(self._h, int(rank)):
                        return None
                    raise TransportError(
                        f"ring {rid} of rank {rank}: announce carried "
                        "no fd"
                    )
                try:
                    mm = _mmap.mmap(
                        fd, int(cap), _mmap.MAP_SHARED, _mmap.PROT_READ
                    )
                finally:
                    _os.close(fd)
                self._rings[key] = mm
                self._evict_rings_locked(int(rank), int(rid))
            view = np.frombuffer(mm, np.uint8)[
                slot * (cap // slots): slot * (cap // slots) + blen
            ]
            self.stats["ring_bytes"] += int(blen)
            self.stats["ring_pinned"] += 1
            if self.stats["ring_pinned"] > self.stats["pinned_peak"]:
                self.stats["pinned_peak"] = self.stats["ring_pinned"]
        _rings.track_release(
            view, self._ring_released, int(rank), int(rid), int(slot),
            int(gen),
        )
        # served as a MEMORYVIEW of the tracked slice, not the slice
        # itself: np.frombuffer(ndarray) does NOT keep the ndarray
        # object in its base chain (only the root buffer), so a
        # consumer re-wrapping the raw slice would let the finalizer
        # fire — and the slot recycle — while its view was still live.
        # A memoryview's managed buffer holds the slice strongly, and
        # every derived buffer (numpy or memoryview) shares it.
        return Message(
            seq=int(msg.seq), epoch=int(msg.epoch), tag=int(msg.tag),
            kind=KIND_DATA, payload=prefix, body=memoryview(view),
        )

    def _ring_released(self, rank: int, rid: int, slot: int, gen: int):
        """Finalizer for a served ring view (any thread, possibly at
        interpreter teardown): ack the slot back to the worker."""
        try:
            with self._zlock:
                self.stats["ring_pinned"] -= 1
            if self._h:
                self._lib.msgt_coord_isend(
                    self._h, rank, 0, 0, 0, KIND_ACK,
                    _ACK_REC.pack(rid, slot, gen), _ACK_REC.size,
                )
        except Exception:  # pragma: no cover - teardown ordering
            pass

    def _evict_rings_locked(self, rank: int, keep_rid: int) -> None:
        """A rank's superseded rings (it grew into a bigger one, or it
        reconnected) move to the orphan list and close once no served
        view pins them (caller holds ``_zlock``)."""
        for key in [
            k for k in self._rings if k[0] == rank and k[1] != keep_rid
        ]:
            self._ring_orphans.append(self._rings.pop(key))
        self._sweep_orphans_locked()

    def _sweep_orphans_locked(self) -> None:
        still = []
        for mm in self._ring_orphans:
            try:
                mm.close()
            except BufferError:  # a served view is alive; retry later
                still.append(mm)
        self._ring_orphans = still

    def pinned_slots(self) -> int:
        """Currently pinned zero-copy slots: harvested ring views still
        alive coordinator-side plus arena slots awaiting worker acks."""
        with self._zlock:
            n = self.stats["ring_pinned"]
            n += sum(a.alloc.pinned for a in self._arenas.values())
            return n

    def _take(self, rank: int, hdr: _Header) -> Message:
        n = int(hdr.len)
        buf = bytearray(n)
        cbuf = (
            (ctypes.c_uint8 * n).from_buffer(buf) if n
            else (ctypes.c_uint8 * 1)()
        )
        got = self._lib.msgt_coord_take(self._handle(), int(rank), cbuf, n)
        del cbuf  # release the buffer export
        if got < 0:
            raise TransportError(f"take({rank}) raced: nothing available")
        return Message(
            seq=int(hdr.seq), epoch=int(hdr.epoch), tag=int(hdr.tag),
            kind=int(hdr.kind),
            payload=buf if got == n else bytes(buf[:got]),
        )

    def waitany(
        self, ranks, timeout: float | None = None
    ) -> tuple[int, Message] | None:
        """Block until any rank in ``ranks`` has a message (or died);
        returns ``(rank, message)``, or None on timeout
        (``MPI.Waitany!``). Frames consumed internally by :meth:`poll`
        (slot-release acks) re-arm the wait instead of surfacing."""
        arr = (ctypes.c_int32 * len(ranks))(*[int(r) for r in ranks])
        deadline = (
            None if timeout is None
            else _time.perf_counter() + max(timeout, 0.0)
        )
        while True:
            if deadline is None:
                t = -1
            else:
                t = max(
                    int((deadline - _time.perf_counter()) * 1000), 0
                )
            rank = self._lib.msgt_coord_waitany(
                self._handle(), arr, len(ranks), t
            )
            if rank < 0:
                return None
            msg = self.poll(rank)
            if msg is None:
                # the ready frame was transport-internal (ack) or a
                # concurrent prober took it; re-arm on the remaining
                # deadline
                if (
                    deadline is not None
                    and _time.perf_counter() >= deadline
                ):
                    return None
                continue
            return rank, msg

    def is_dead(self, rank: int) -> bool:
        return bool(self._lib.msgt_coord_is_dead(self._handle(), int(rank)))

    def reaccept(self, rank: int, timeout: float = 30.0) -> None:
        """Accept a reconnect for a dead rank (elastic recovery): a
        respawned worker sends a fresh hello with the same rank and
        the progress engine picks its socket back up."""
        rc = self._lib.msgt_coord_reaccept(
            self._handle(), int(rank), int(timeout * 1000)
        )
        if rc != 0:
            raise TransportError(
                f"rank {rank} did not reconnect within {timeout}s "
                "(or was not dead)"
            )
        self._forget_rank(int(rank))

    def _forget_rank(self, rank: int) -> None:
        """A rank reconnected as a fresh process: re-announce arena fds
        to it, reap the old incarnation's arena pins (it will never
        ack), and orphan its result-ring mappings (new incarnation ring
        ids start over, so stale mappings must not shadow them; held
        views keep the old pages alive until released)."""
        with self._zlock:
            self._arena_fd_sent = {
                k for k in self._arena_fd_sent if k[0] != rank
            }
            for a in self._arenas.values():
                a.alloc.release_holder_everywhere(rank)
            for key in [k for k in self._rings if k[0] == rank]:
                self._ring_orphans.append(self._rings.pop(key))
            self._sweep_orphans_locked()
            self._gc_arenas_locked()

    def error(self) -> str:
        """First fatal progress-engine error, or ''. When non-empty,
        every rank has been marked dead with this as the cause."""
        buf = ctypes.create_string_buffer(1024)
        n = self._lib.msgt_coord_error(self._handle(), buf, len(buf))
        return buf.raw[:n].decode(errors='replace')

    def close(self) -> None:
        if self._h:
            self._lib.msgt_coord_destroy(self._h)
            self._h = None
            with self._zlock:
                for a in self._arenas.values():
                    a.region.close()
                self._arenas.clear()
                self._arena = None
                for key in list(self._rings):
                    self._ring_orphans.append(self._rings.pop(key))
                self._sweep_orphans_locked()  # pinned mappings linger
                # until their views die (finalizers guard on _h)

    def __del__(self):  # pragma: no cover - GC ordering dependent
        try:
            self.close()
        except Exception:
            pass


class _BroadcastArena:
    """Coordinator side of the persistent broadcast arena: one memfd
    region of ``slots`` equal slots, allocator holders = the ranks a
    slot's broadcast was sent to (plus the transient ``"coord"`` hold
    between :meth:`Coordinator.arena_payload` and the payload's
    release)."""

    __slots__ = ("id", "region", "alloc", "slots", "slot_bytes")

    def __init__(self, aid: int, region, slots: int):
        self.id = int(aid)
        self.region = region
        self.slots = int(slots)
        self.slot_bytes = region.nbytes // self.slots
        self.alloc = _rings.RingAlloc(self.slots)


class ArenaPayload:
    """One staged broadcast body in the persistent arena. Pass to
    :meth:`Coordinator.isend_shared` per rank, then :meth:`release` —
    the slot itself is reclaimed only after every receiving rank acks
    its views released (see ``native/rings.py``). ``_h`` mirrors the
    Shared/ShmPayload handle convention (None = released)."""

    __slots__ = ("_coord", "arena", "slot", "gen", "nbytes", "_h")

    def __init__(self, coord, arena, slot: int, gen: int, nbytes: int):
        self._coord = coord
        self.arena = arena
        self.slot = int(slot)
        self.gen = int(gen)
        self.nbytes = int(nbytes)
        self._h = arena.id  # non-None marker for isend_shared's guard

    def release(self) -> None:
        if self._h is None:
            return
        self._h = None
        with self._coord._zlock:
            self.arena.alloc.release(self.slot, self.gen, "coord")

    def __del__(self):  # pragma: no cover - GC ordering dependent
        try:
            self.release()
        except Exception:
            pass


class Worker:
    """Worker endpoint: blocking framed recv/send on one socket.

    The constructor is a round trip: it sends the hello and then blocks
    until the coordinator's ``accept``/``reaccept`` admits the rank
    (answering the auth challenge when one is issued). Construct it on
    a thread/process other than the one that will call ``accept`` —
    which is how workers run anyway (worker.py)."""

    def __init__(
        self, path: str, rank: int, *, token: bytes = b"",
        ring_min: "int | None" = RING_MIN,
    ):
        """``ring_min``: result bodies of at least this many bytes ride
        the persistent shared-memory result ring (``send_result``);
        None disables the ring (copying ``send2`` only — TCP workers
        disable it automatically, SCM_RIGHTS being unix-only)."""
        self._lib = load_lib()
        self.rank = int(rank)
        token = bytes(token)
        self._h = self._lib.msgt_worker_connect(
            path.encode(), self.rank, token, len(token)
        )
        if not self._h:
            raise TransportError(
                f"worker {rank} could not connect to {path} (refused, "
                "or the coordinator rejected the auth token)"
            )
        # shm broadcast regions, id -> mmap, insertion-ordered. Owned
        # HERE (not in C++) so eviction can be REFUSED while numpy views
        # of a region are still alive: mmap.close() raises BufferError
        # when buffers are exported, which downgrades "use-after-unmap
        # segfault" to "old region stays mapped a little longer".
        self._shm_regions: dict[int, _mmap.mmap] = {}
        self._shm_keep = 4
        # persistent broadcast-arena mappings (id -> mmap): mapped once,
        # reused every epoch; a superseded arena is evicted with the
        # same BufferError pin discipline as the one-shot regions
        self._arena_regions: dict[int, _mmap.mmap] = {}
        # slot-release acks owed to the coordinator, appended by view
        # finalizers (single-threaded worker: no lock needed) and
        # flushed as one KIND_ACK frame at the next recv/send boundary
        self._pending_acks: list[tuple[int, int, int]] = []
        self._stall_count = 0
        if path.startswith("tcp://"):
            ring_min = None
        self._ring_min = ring_min if ring_min is None else int(ring_min)
        self._ring: "_WorkerRing | None" = None
        self._ring_ids = _itertools.count(1)

    def _shm_view(self, sid: int, blen: int) -> "memoryview | None":
        """Resolve a shm region id to a read-only view, adopting the fd
        that rode in with the frame (SCM_RIGHTS) on first sight."""
        region = self._shm_regions.get(sid)
        if region is not None:
            fd = self._lib.msgt_worker_take_fd(self._h)
            if fd >= 0:
                _os.close(fd)  # duplicate announce of a known region
        else:
            fd = self._lib.msgt_worker_take_fd(self._h)
            if fd < 0:
                return None
            try:
                region = _mmap.mmap(
                    fd, blen, _mmap.MAP_SHARED, _mmap.PROT_READ
                )
            except (OSError, ValueError):
                return None
            finally:
                _os.close(fd)  # mmap holds its own reference
            self._shm_regions[sid] = region
            self._evict_shm()
        return memoryview(region)[:blen]

    def _evict_shm(self) -> None:
        """Bound the region dict to the keep window, oldest first. A
        region whose views are still referenced raises ``BufferError``
        from ``mmap.close()`` and is RETAINED — payload views can never
        dangle; eviction of a pinned region simply defers to a later
        resolve (every new region triggers another sweep, so the dict
        shrinks back to the window as soon as the views are released).
        Pinned regions do not shield newer closable ones: the sweep
        walks every over-window candidate, not just the first."""
        excess = len(self._shm_regions) - self._shm_keep
        if excess <= 0:
            return
        # the newest `keep` regions stay regardless; everything older
        # is a candidate, evicted unless a live view pins it
        for old_sid in list(self._shm_regions)[:excess]:
            old = self._shm_regions[old_sid]
            try:
                old.close()
            except BufferError:
                continue  # views alive; keep the mapping, retry later
            del self._shm_regions[old_sid]

    def recv(self) -> Message | None:
        """Block for the next frame; None means the coordinator is gone.
        Transport-internal frames (result-ring slot acks) are consumed
        invisibly; arena frames resolve to ``KIND_DATA`` messages with
        zero-copy bodies."""
        self._flush_acks()
        while True:
            hdr = _Header()
            if self._lib.msgt_worker_recv_hdr(
                self._h, ctypes.byref(hdr)
            ) != 0:
                return None
            n = int(hdr.len)
            buf = bytearray(n)
            if n > 0:
                cbuf = (ctypes.c_uint8 * n).from_buffer(buf)
                ok = self._lib.msgt_worker_recv_payload(self._h, cbuf, n)
                del cbuf
                if ok != 0:
                    return None
            kind = int(hdr.kind)
            if kind == KIND_ACK:
                self._handle_ring_acks(buf)
                continue
            if kind == KIND_ARENA:
                msg = self._resolve_arena(hdr, buf)
                if msg is None:
                    return None  # region lost; coordinator sees death
                return msg
            if kind == KIND_SHM:
                # wire payload = [shm_id, body_len, codec prefix...]; the
                # body lives in a mapped region — zero bytes on the wire
                sid, blen = _struct.unpack_from("<qq", buf, 0)
                view = self._shm_view(sid, blen)
                if view is None:
                    return None  # region lost; coordinator sees the death
                return Message(
                    seq=int(hdr.seq), epoch=int(hdr.epoch),
                    tag=int(hdr.tag), kind=KIND_DATA,
                    payload=bytes(memoryview(buf)[16:]), body=view,
                )
            return Message(
                seq=int(hdr.seq), epoch=int(hdr.epoch), tag=int(hdr.tag),
                kind=kind, payload=buf,
            )

    def _resolve_arena(self, hdr: _Header, buf) -> Message | None:
        """Resolve a broadcast-arena frame: adopt the arena fd on first
        sight (mapped ONCE; every later epoch is a tiny fd-less control
        frame), serve a read-only zero-copy slot view, and register its
        release so the coordinator can reuse the slot."""
        aid, cap, slots, slot, gen, blen = _RING_HDR.unpack_from(buf, 0)
        mm = self._arena_regions.get(aid)
        if mm is None:
            fd = self._lib.msgt_worker_take_fd(self._h)
            if fd < 0:
                return None
            try:
                mm = _mmap.mmap(
                    fd, int(cap), _mmap.MAP_SHARED, _mmap.PROT_READ
                )
            except (OSError, ValueError):
                return None
            finally:
                _os.close(fd)  # mmap holds its own reference
            self._arena_regions[aid] = mm
            self._evict_arenas(keep=aid)
        off = slot * (cap // slots)
        view = np.frombuffer(mm, np.uint8)[off:off + blen]
        _rings.track_release(
            view, self._pending_acks.append, (int(aid), int(slot), int(gen))
        )
        # memoryview-wrapped for the same reason as the coordinator's
        # ring serve: every derived buffer must hold the tracked slice
        return Message(
            seq=int(hdr.seq), epoch=int(hdr.epoch), tag=int(hdr.tag),
            kind=KIND_DATA,
            payload=bytes(memoryview(buf)[_RING_HDR.size:]),
            body=memoryview(view),
        )

    def _evict_arenas(self, keep: int) -> None:
        """Superseded arena mappings close unless a live slot view pins
        them (BufferError), in which case they retry on the next arena
        handoff — the keep-window discipline, window = the current
        arena."""
        for aid in [a for a in self._arena_regions if a != keep]:
            try:
                self._arena_regions[aid].close()
            except BufferError:
                continue  # views alive; keep the mapping, retry later
            del self._arena_regions[aid]

    def _flush_acks(self) -> None:
        """Ship owed slot releases (and ring-full stall reports) as one
        KIND_ACK frame. Called at frame boundaries on the worker's own
        thread — finalizers only append to the pending list, so there
        is no I/O interleaving hazard."""
        if not self._pending_acks and not self._stall_count:
            return
        if not self._h:
            return
        # drain IN PLACE: view finalizers were registered with this
        # exact list object bound into their callbacks (rings.py), so
        # rebinding the attribute would strand every finalizer created
        # before the flush on a detached list — acks would silently
        # stop and slots pin forever (the bug the first cut had)
        recs = self._pending_acks[:]
        del self._pending_acks[:len(recs)]
        parts = [_ACK_REC.pack(*r) for r in recs]
        if self._stall_count:
            parts.append(_ACK_REC.pack(-1, self._stall_count, 0))
            self._stall_count = 0
        payload = b"".join(parts)
        self._lib.msgt_worker_send(
            self._h, 0, 0, 0, KIND_ACK, payload, len(payload)
        )

    def _handle_ring_acks(self, buf) -> None:
        """Coordinator released result-ring slots: free them for reuse.
        Acks for a superseded ring are ignored (its slots died with
        it)."""
        usable = len(buf) - len(buf) % _ACK_REC.size
        for off in range(0, usable, _ACK_REC.size):
            rid, slot, gen = _ACK_REC.unpack_from(buf, off)
            ring = self._ring
            if ring is not None and ring.id == rid:
                ring.alloc.release(int(slot), int(gen), "coord")

    def send(
        self, payload: bytes, *,
        seq: int = 0, epoch: int = 0, tag: int = 0, kind: int = KIND_DATA,
    ) -> bool:
        self._flush_acks()
        if not isinstance(payload, bytes):
            payload = bytes(payload)  # c_char_p wants immutable bytes
        rc = self._lib.msgt_worker_send(
            self._h, seq, epoch, tag, kind, payload, len(payload)
        )
        return rc == 0

    def send2(
        self, prefix: bytes, body, *,
        seq: int = 0, epoch: int = 0, tag: int = 0, kind: int = KIND_DATA,
    ) -> bool:
        """Two-buffer blocking send; ``body`` is written straight from
        the caller's buffer (zero-copy in user space for ndarrays)."""
        self._flush_acks()
        paddr, plen, pkeep = _addr_len(prefix)
        baddr, blen, bkeep = _addr_len(body)
        rc = self._lib.msgt_worker_send2(
            self._h, seq, epoch, tag, kind, paddr, plen, baddr, blen
        )
        del pkeep, bkeep  # held until the blocking write finished
        return rc == 0

    def send_result(
        self, prefix: bytes, body, *,
        seq: int = 0, epoch: int = 0, tag: int = 0, kind: int = KIND_DATA,
    ) -> bool:
        """Result send, zero-copy where it pays: bodies of at least
        ``ring_min`` bytes are written into this worker's persistent
        result ring (one memcpy into shared pages the coordinator maps
        once; only a tiny control frame crosses the socket) — the
        coordinator serves ``np.frombuffer`` views straight off the
        ring. Smaller bodies, non-buffer bodies, error frames, and a
        fully pinned ring (every slot's coordinator view still alive)
        fall back to :meth:`send2`, so delivery never waits on the
        coordinator's garbage collector."""
        if kind == KIND_DATA and self._ring_min is not None:
            try:
                u8 = _rings.as_u8(body)
            except (TypeError, ValueError):
                u8 = None
            if u8 is not None and u8.nbytes >= self._ring_min:
                if self._send_ring(
                    prefix, u8, seq=seq, epoch=epoch, tag=tag
                ):
                    return True
        return self.send2(
            prefix, body, seq=seq, epoch=epoch, tag=tag, kind=kind
        )

    def _send_ring(self, prefix, u8, *, seq, epoch, tag) -> bool:
        n = u8.nbytes
        ring = self._ring
        if ring is None or ring.slot_bytes < n:
            region = _rings.MemfdRegion.create(
                _rings.next_pow2(n) * RING_SLOTS, "msgt-result-ring"
            )
            if region is None:  # no memfd: stop probing on every send
                self._ring_min = None
                return False
            old, ring = ring, _WorkerRing(
                next(self._ring_ids), region, RING_SLOTS
            )
            self._ring = ring
            if old is not None:
                # worker-side mapping only; the coordinator's mapping
                # (and any held views) keep the old pages alive
                old.region.close()
        got = ring.alloc.acquire(("coord",))
        if got is None:
            self._stall_count += 1  # every slot pinned: socket fallback
            return False
        slot, gen = got
        off = slot * ring.slot_bytes
        ring.region.view[off:off + n] = u8
        data = _RING_HDR.pack(
            ring.id, ring.region.nbytes, ring.slots, slot, gen, n
        ) + (prefix if isinstance(prefix, bytes) else bytes(prefix))
        self._flush_acks()
        if not ring.announced:
            rc = self._lib.msgt_worker_send_fd(
                self._h, seq, epoch, tag, KIND_RING, data, len(data),
                ring.region.fd,
            )
            if rc == 0:
                ring.announced = True
        else:
            rc = self._lib.msgt_worker_send(
                self._h, seq, epoch, tag, KIND_RING, data, len(data)
            )
        if rc != 0:
            ring.alloc.release(slot, gen, "coord")
            return False
        return True

    def close(self) -> None:
        if self._h:
            self._lib.msgt_worker_close(self._h)
            self._h = None
            if self._ring is not None:
                self._ring.region.close()
                self._ring = None
            for aid in list(self._arena_regions):
                try:
                    self._arena_regions.pop(aid).close()
                except BufferError:  # held view outlives the worker
                    pass

    def __del__(self):  # pragma: no cover - GC ordering dependent
        try:
            self.close()
        except Exception:
            pass


class _WorkerRing:
    """Worker side of a persistent result ring: one memfd region of
    ``slots`` equal slots; the coordinator holds each slot (holder
    ``"coord"``) from send until its served view's release ack."""

    __slots__ = ("id", "region", "alloc", "slots", "slot_bytes",
                 "announced")

    def __init__(self, rid: int, region, slots: int):
        self.id = int(rid)
        self.region = region
        self.slots = int(slots)
        self.slot_bytes = region.nbytes // self.slots
        self.alloc = _rings.RingAlloc(self.slots)
        self.announced = False  # fd passed with the first control frame


class ShmPayload:
    """A broadcast payload in a memfd region: every worker maps the same
    physical pages, so broadcasting n ways moves the bytes zero times
    over the sockets. ``_h`` is None when memfd creation failed (caller
    falls back to :class:`SharedPayload`)."""

    __slots__ = ("_lib", "_h", "nbytes")

    def __init__(self, lib, body):
        addr, n, keep = _addr_len(body)
        self._lib = lib
        self.nbytes = n
        self._h = lib.msgt_payload_create_shm(addr, n)
        del keep  # create copies synchronously

    def release(self) -> None:
        if self._h is not None:
            self._lib.msgt_payload_release_shm(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC ordering dependent
        try:
            self.release()
        except Exception:
            pass


class SharedPayload:
    """A broadcast payload snapshotted once in native memory; frames
    enqueue shared references instead of copies. Frames still in a send
    queue keep the bytes alive after :meth:`release`."""

    __slots__ = ("_lib", "_h", "nbytes")

    def __init__(self, lib, body):
        addr, n, keep = _addr_len(body)
        self._lib = lib
        self.nbytes = n
        self._h = lib.msgt_payload_create(addr, n)
        del keep  # create copies synchronously

    def release(self) -> None:
        if self._h is not None:
            self._lib.msgt_payload_release(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC ordering dependent
        try:
            self.release()
        except Exception:
            pass
