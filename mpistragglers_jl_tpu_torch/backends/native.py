"""Process workers over the native C++ transport (native/transport.cpp).

A copy of the JAX package's ``backends/native.py`` over the port's own
transport sources; the wire is one protocol, so a coordinator of either
package serves the other's workers. Torch tensors cross as their host
bytes (:mod:`..native.codec`).

Functionally the twin of :class:`~.process.ProcessBackend` — n spawned
OS worker processes, real serialization boundary, dead-worker detection —
but the coordinator side is the native runtime instead of Python pipes
and reader threads: framed messages over Unix-domain sockets, an epoll
progress thread doing all partial I/O (the libmpi progress-engine role,
SURVEY component C8), and ``wait_any`` blocking in native
``msgt_coord_waitany`` rather than a Python condition variable. The pool
above is unchanged; this backend exists so the hot host-side wait loop
(reference ``MPI.Waitany!``, src/MPIAsyncPools.jl:161) runs in native
code with zero Python threads on the coordinator.

Construction falls back with :class:`~..native.NativeBuildError` if no
compiler is available; callers wanting automatic degradation should
catch it and build a :class:`~.process.ProcessBackend` instead.
"""

from __future__ import annotations

import multiprocessing as mp
import secrets
import tempfile
import time as _time
import uuid
from collections import deque
from pathlib import Path
from typing import Sequence

from ..native import codec
from ..native import transport as T
from ..obs.aggregate import OBS_TAG as _OBS_TAG  # stdlib-only module
from .base import Backend, Deadline, DeadWorkerError, DelayFn, WorkerError
from .process import RemoteWorkerError, WorkerProcessDied, WorkFn

__all__ = ["NativeProcessBackend"]


def _straggle_exhausted(ranks, deadline: Deadline, timeout):
    """Every awaited rank is dead under ``on_dead="straggle"``: burn the
    caller's remaining timeout and report a timeout (an early None would
    be indistinguishable from one anyway), or — with no timeout — raise
    instead of hanging forever the way the reference's Waitall! does."""
    if timeout is None:
        raise DeadWorkerError(sorted({int(r) for r in ranks}), None)
    left = deadline.remaining()
    if left:
        _time.sleep(left)
    return None


def _native_worker_main(
    rank: int, path: str, work_fn: WorkFn, delay_fn: DelayFn | None,
    token: bytes, telemetry: bool = False, zero_copy: bool = True,
) -> None:
    """Spawned-process entry: the shared worker loop (worker.py — the
    reference's receive -> stall -> compute -> send convention, SURVEY
    §3.2) with errors swallowed (the coordinator sees the disconnect)."""
    from ..worker import run_worker

    try:
        run_worker(path, rank, work_fn, delay_fn, token=token,
                   telemetry=telemetry, zero_copy=zero_copy)
    except (KeyboardInterrupt, Exception):
        pass


class NativeProcessBackend(Backend):
    """n worker processes; all coordinator-side I/O in the C++ runtime.

    Same contract as :class:`~.process.ProcessBackend` (picklable
    ``work_fn(i, payload, epoch)`` / ``delay_fn``). Payloads travel via
    the zero-copy codec (native/codec.py): plain ndarrays go as raw
    bytes — ONE snapshot copy into the native send queue, shared across
    the epoch's whole broadcast — so in-flight sends survive caller
    mutation (the reference's ``isendbuf`` discipline,
    src/MPIAsyncPools.jl:130) at memcpy cost, not pickle cost.
    """

    def __init__(
        self,
        work_fn: WorkFn | None,
        n_workers: int,
        *,
        delay_fn: DelayFn | None = None,
        mp_context: str = "spawn",
        connect_timeout: float = 60.0,
        join_timeout: float = 5.0,
        address: str | None = None,
        spawn: bool = True,
        accept: bool = True,
        auth: bytes | str | None = None,
        on_dead: str = "error",
        zero_copy: bool = True,
        registry=None,
        flight=None,
        exporter=None,
    ):
        """``address``: Unix-socket path (default: a fresh temp path) or
        ``tcp://host:port`` for multi-host (port 0 = ephemeral; the
        resolved address is ``self.address``). ``spawn=False`` starts no
        local processes — external workers (e.g. remote hosts running
        ``python -m mpistragglers_jl_tpu_torch.worker``) must connect within
        ``connect_timeout``; ``work_fn`` may then be None (it runs on
        the workers' side). ``accept=False`` defers the handshake: the
        constructor returns immediately after binding so ``address``
        (with its resolved ephemeral port) can be handed to workers
        first; call :meth:`accept` before the first dispatch.

        ``auth``: shared secret every connecting worker must prove (via
        HMAC challenge-response in the hello; the secret never crosses
        the wire). With ``spawn=True`` a random per-backend secret is
        generated automatically, so locally spawned pools are always
        authenticated. With ``spawn=False`` the default is open —
        SECURITY: an unauthenticated TCP listener admits *any* process
        that can reach the port, and payloads are unpickled (arbitrary
        code execution); either pass an ``auth`` secret (give workers
        the same one via ``MSGT_AUTH`` / ``--auth-file``) or bind only
        on a trusted network.

        ``zero_copy`` (default True) enables the persistent
        shared-memory paths on same-host transports: broadcast bodies
        >= 1 MiB stage in an arena every worker maps once, and worker
        result bodies >= 64 KiB come back through per-worker result
        rings served as ``np.frombuffer`` views — see the JAX package's docs/API.md
        "Zero-copy transport". ``False`` forces the copying socket
        transport for everything this backend controls — the
        coordinator's broadcast paths and any workers it SPAWNS
        (baselines/debugging). External ``spawn=False`` workers own
        their result-ring choice: launch them with ``--no-zero-copy``
        for a fully copying baseline. TCP transports are copying
        regardless.

        ``registry`` / ``flight`` / ``exporter`` follow the obs/
        contract (None = dark, zero cost): ``registry`` turns on
        cross-process telemetry — spawned workers run with
        ``telemetry=True`` (external ``spawn=False`` workers opt in
        with ``--telemetry``) and their frames, arriving on the
        reserved OBS tag, merge into the registry under
        ``worker="<rank>"`` labels — plus the transport's zero-copy
        counters (bytes moved without a userspace copy, ring-full
        stalls, pinned-slot gauge/high-water); ``flight`` mirrors
        merged worker spans into the ring; ``exporter`` registers the
        pool health check + trace sources on an
        :class:`~..obs.ObsServer`."""
        if on_dead not in ("error", "straggle"):
            raise ValueError(f"on_dead must be 'error'|'straggle', got {on_dead!r}")
        self.on_dead = on_dead
        self.n_workers = int(n_workers)
        self.work_fn = work_fn
        self.delay_fn = delay_fn
        self._join_timeout = join_timeout
        self._connect_timeout = connect_timeout
        self._closed = False
        self._spawn = bool(spawn)
        if self._spawn and work_fn is None:
            raise ValueError("work_fn is required when spawning workers")
        # seq numbers are allocated per RANK (unique across tags) so a
        # frame identifies its dispatch unambiguously; per-channel state
        # is keyed (rank, tag) — tags multiplex independent message
        # streams over one connection, like MPI tags on a communicator
        # (reference test/kmap2.jl:11-12)
        self._seq_counter = [0] * self.n_workers
        self._cur: dict[tuple[int, int], int] = {}     # (rank, tag) -> seq
        self._epochs: dict[tuple[int, int], int] = {}  # epoch in flight
        # frames that arrived for a channel other than the one being
        # awaited; at most one live frame per channel (slot discipline)
        self._stash: dict[tuple[int, int], deque] = {}
        # per-epoch payload encoding cache (see _encode): the codec
        # prefix plus a SHARED native snapshot of the body, taken once
        # per broadcast instead of once per worker
        self._pick_src = None
        self._pick_epoch = None
        self._pick_prefix = b""
        self._pick_shared: T.SharedPayload | None = None
        # dispatch that failed instantly (dead worker): surfaced at the
        # next test/wait instead of raising inside the pool's send phase
        self._synthetic: dict[tuple[int, int], WorkerError] = {}
        if address is None:
            address = str(
                Path(tempfile.gettempdir())
                / f"msgt-{uuid.uuid4().hex[:12]}.sock"
            )
        if auth is None:
            # spawned workers inherit the secret through the process args,
            # so authentication costs nothing — default it on. External
            # workers need the secret delivered out-of-band, so open is
            # the only workable spawn=False default (documented above).
            auth = secrets.token_bytes(16) if self._spawn else b""
        self._token = auth.encode() if isinstance(auth, str) else bytes(auth)
        self._mp_context = mp_context
        self._zero_copy = bool(zero_copy)
        self.aggregator = None
        if registry is not None or flight is not None:
            from ..obs.aggregate import TelemetryAggregator

            self.aggregator = TelemetryAggregator(
                registry, flight=flight
            )
        # opt-in transport telemetry (obs/ contract: None = dark, the
        # hot path pays one is-None check per dispatch)
        self._registry = registry
        self._tstats_last = {
            "arena_bytes": 0, "ring_bytes": 0,
            "arena_stalls": 0, "ring_stalls": 0,
        }
        if registry is not None:
            self._m_arena_bytes = registry.counter(
                "transport_zero_copy_bytes_total",
                help="payload bytes served without a userspace copy",
                path="arena",
            )
            self._m_ring_bytes = registry.counter(
                "transport_zero_copy_bytes_total",
                help="payload bytes served without a userspace copy",
                path="ring",
            )
            self._m_stalls_c = registry.counter(
                "transport_ring_full_stalls_total",
                help="allocations that fell back to the copying "
                "transport because every slot was pinned",
                side="coordinator",
            )
            self._m_stalls_w = registry.counter(
                "transport_ring_full_stalls_total",
                help="allocations that fell back to the copying "
                "transport because every slot was pinned",
                side="worker",
            )
            self._m_pinned = registry.gauge(
                "transport_pinned_slots",
                help="zero-copy slots currently pinned by live views",
            )
            self._m_pinned_peak = registry.gauge(
                "transport_pinned_slots_peak",
                help="high-water mark of pinned zero-copy slots",
            )
        self._coord = T.Coordinator(
            address, self.n_workers, token=self._token,
            zero_copy=self._zero_copy,
        )
        self._sock_path = self._coord.address  # ephemeral port resolved
        self._procs: list = [None] * self.n_workers
        self._accepted = False
        if self._spawn:
            for i in range(self.n_workers):
                self._spawn_worker(i)
        if accept:
            self.accept(timeout=connect_timeout)
        if exporter is not None:
            exporter.register_backend(self)

    def accept(self, timeout: float | None = None) -> None:
        """Complete the worker handshake (no-op if already done)."""
        if self._accepted:
            return
        try:
            self._coord.accept(
                timeout=self._connect_timeout if timeout is None else timeout
            )
        except T.TransportError:
            self.shutdown()
            raise
        self._accepted = True

    @property
    def address(self) -> str:
        """The address workers connect to (give this to remote workers
        in ``spawn=False`` mode)."""
        return self._sock_path

    def _spawn_worker(self, i: int) -> None:
        """Start (or restart) the worker process for rank i."""
        ctx = mp.get_context(self._mp_context)
        proc = ctx.Process(
            target=_native_worker_main,
            args=(i, self._sock_path, self.work_fn, self.delay_fn,
                  self._token, self.aggregator is not None,
                  self._zero_copy),
            daemon=True,
            name=f"pool-native-worker-{i}",
        )
        proc.start()
        self._procs[i] = proc

    # -- Backend interface -------------------------------------------------
    def begin_epoch(self, epoch: int) -> None:
        # arm the payload encoding cache for this epoch and drop the
        # previous epoch's entry. The cache is ONLY active for an epoch
        # announced via begin_epoch (i.e. inside asyncmap, where the
        # coordinator is single-threaded and the sendbuf cannot mutate
        # between the phase-2/phase-3 dispatches of one call); direct
        # Backend-API dispatches never hit it, so their payloads are
        # snapshotted at every dispatch as the class docstring promises.
        self._drop_cache()
        self._pick_epoch = int(epoch)

    def end_epoch(self) -> None:
        # disarm: a direct dispatch AFTER asyncmap returns (e.g. manual
        # re-task of a mutated buffer at the same epoch number) must
        # re-encode, preserving snapshot-at-dispatch semantics
        self._drop_cache()
        self._pick_epoch = None

    def _drop_cache(self) -> None:
        self._pick_src = None
        self._pick_prefix = b""
        if self._pick_shared is not None:
            self._pick_shared.release()  # queued frames keep their refs
            self._pick_shared = None

    def _send_payload(self, i: int, sendbuf, epoch: int, tag: int) -> bool:
        """Encode + enqueue one dispatch, zero-copy where possible.

        asyncmap broadcasts ONE stable sendbuf to every idle worker per
        epoch (reference src/MPIAsyncPools.jl:118-139), so inside an
        epoch the body is snapshotted once — preferentially into a slot
        of the PERSISTENT broadcast arena (one memcpy, fd-less
        control frames to workers that already map the arena), falling
        back to a one-shot shared payload when the arena does not apply
        or every slot is still pinned — and the n dispatches (and
        phase-3 re-tasks) enqueue references. No pickling for plain
        ndarrays (native/codec.py). Direct Backend-API dispatches
        always re-encode, so in-place payload mutation between
        dispatches is always observed."""
        cacheable = epoch == self._pick_epoch
        if not (cacheable and sendbuf is self._pick_src):
            prefix, body = codec.encode(sendbuf)
            if cacheable:
                self._drop_cache()
                self._pick_src = sendbuf
                self._pick_prefix = prefix
                self._pick_shared = (
                    self._coord.arena_payload(body)
                    or self._coord.payload(body)
                )
                self._pick_epoch = epoch  # _drop_cache left it intact
            else:
                return self._coord.isend2(
                    i, prefix, body,
                    seq=self._seq_counter[i], epoch=epoch, tag=tag,
                )
        return self._coord.isend_shared(
            i, self._pick_prefix, self._pick_shared,
            seq=self._seq_counter[i], epoch=epoch, tag=tag,
        )

    def _check_ready(self) -> None:
        if self._closed:
            raise RuntimeError("backend has been shut down")
        if not self._accepted:
            # dispatching before the handshake would queue frames on
            # fd-less peers and then hang the wait forever
            raise RuntimeError(
                "worker handshake incomplete: call backend.accept() "
                "before dispatching (accept=False mode)"
            )

    def dispatch(self, i: int, sendbuf, epoch: int, *, tag: int = 0) -> None:
        self._check_ready()
        key = (i, int(tag))
        self._seq_counter[i] += 1
        self._cur[key] = self._seq_counter[i]
        self._epochs[key] = int(epoch)
        if self.aggregator is not None:
            # half of a clock-offset sample; the worker's matching
            # stamps ride back on its telemetry frame (same seq)
            self.aggregator.note_dispatch(
                i, self._seq_counter[i], _time.perf_counter()
            )
        ok = self._send_payload(i, sendbuf, int(epoch), int(tag))
        if self._registry is not None:
            self._publish_transport()
        if not ok:
            # rank already dead. "error": fail the task at the next
            # harvest instead of hanging the pool. "straggle": the task
            # is silently lost — the rank is an infinite straggler and
            # simply never freshens (reference SURVEY §5 semantics).
            if self.on_dead == "error":
                self._synthetic[key] = WorkerError(
                    i, epoch, WorkerProcessDied(i)
                )

    def _publish_transport(self) -> None:
        """Mirror the transport's zero-copy stats into the opt-in
        registry (counter deltas; the coordinator's dict is the source
        of truth). Callers guard on ``self._registry is not None``."""
        s = self._coord.stats
        last = self._tstats_last
        d = s["arena_bytes"] - last["arena_bytes"]
        if d:
            self._m_arena_bytes.inc(d)
            last["arena_bytes"] = s["arena_bytes"]
        d = s["ring_bytes"] - last["ring_bytes"]
        if d:
            self._m_ring_bytes.inc(d)
            last["ring_bytes"] = s["ring_bytes"]
        d = s["arena_stalls"] - last["arena_stalls"]
        if d:
            self._m_stalls_c.inc(d)
            last["arena_stalls"] = s["arena_stalls"]
        d = s["ring_stalls"] - last["ring_stalls"]
        if d:
            self._m_stalls_w.inc(d)
            last["ring_stalls"] = s["ring_stalls"]
        self._m_pinned.set(self._coord.pinned_slots())
        self._m_pinned_peak.set(s["pinned_peak"])

    def _consume_obs(self, j: int, msg: T.Message) -> bool:
        """Absorb a telemetry frame (the reserved OBS tag): merge it
        into the aggregator when one is attached, drop it otherwise.
        Returns True iff the frame was telemetry — callers skip it and
        keep waiting for real completions either way. (The tag test is
        one int compare, so dark wait loops stay at is-None cost.)"""
        if int(msg.tag) != _OBS_TAG or msg.kind != T.KIND_DATA:
            return False
        if self.aggregator is not None:
            try:
                frame = codec.decode(msg.payload, msg.body)
            except Exception:
                return True  # malformed telemetry never kills a wait
            self.aggregator.merge(
                j, frame, t_recv_c=_time.perf_counter()
            )
        return True

    def _drain_obs(self, i: int, timeout: float = 2.0) -> None:
        """Pull queued telemetry frames for rank ``i`` (the
        shutdown-drain frame workers flush before exiting). The worker
        process has already been joined, but the frame still has to
        travel socket buffer -> epoll progress thread -> queue, so an
        empty poll retries briefly instead of declaring the queue
        drained (a single non-blocking pass raced the progress thread
        and lost end-of-run deltas). Non-telemetry DATA frames (an
        unharvested straggler's late result) are dropped and skipped —
        the backend is shutting down and no channel will be read again,
        but the telemetry frames queued BEHIND them must still merge.
        The loop ends at the sticky KIND_DEATH marker the dead rank's
        poll synthesizes once its real frames are out — the
        "everything drained" signal; ``timeout`` only bounds the
        pathological no-death case."""
        deadline = _time.perf_counter() + timeout
        while True:
            msg = self._coord.poll(i)
            if msg is None:
                if _time.perf_counter() >= deadline:
                    return
                _time.sleep(0.002)
                continue
            if msg.kind == T.KIND_DEATH:
                return  # queue fully drained (marker fires last)
            self._consume_obs(i, msg)  # telemetry merged; stale
            # results dropped — keep going for the frames behind them

    def _decode(self, i: int, msg: T.Message, tag: int):
        if msg.kind == T.KIND_DEATH:
            return WorkerError(
                i, self._epochs.get((i, tag), 0), WorkerProcessDied(i)
            )
        if msg.kind == T.KIND_ERROR:
            exc_type, text, tb = codec.decode(msg.payload)
            return WorkerError(
                i, msg.epoch, RemoteWorkerError(exc_type, text, tb)
            )
        # result-ring frames carry the codec prefix in-frame and the
        # body out-of-band (a zero-copy view into the worker's ring);
        # holding the decoded array pins the slot until released
        return codec.decode(msg.payload, msg.body)

    def _route(self, j: int, msg: T.Message, want_tag: int):
        """Classify an arriving frame against channel ``(j, want_tag)``:
        return the frame if it is this channel's current completion,
        stash it if it belongs to another live channel, drop it if its
        dispatch was superseded. DEATH frames always surface (they are
        rank-wide, and the native marker is sticky — every channel that
        waits on a dead rank sees one)."""
        if msg.kind == T.KIND_DEATH:
            return msg
        mtag = int(msg.tag)
        if msg.seq != self._cur.get((j, mtag), -1):
            return None  # superseded dispatch; drop
        if mtag != int(want_tag):
            self._stash.setdefault((j, mtag), deque()).append(msg)
            return None
        return msg

    def _stash_pop(self, key: tuple[int, int]) -> T.Message | None:
        st = self._stash.get(key)
        while st:
            msg = st.popleft()
            # re-verify: the channel may have re-dispatched (direct
            # Backend-API use) while the frame sat stashed
            if msg.seq == self._cur.get(key, -1):
                return msg
        return None

    def _next(
        self, i: int, *, block: bool, timeout: float | None = None,
        tag: int = 0,
    ):
        """Fetch the completion for channel ``(i, tag)``'s current
        dispatch, skipping frames from superseded dispatches (stale seq)
        and parking frames that belong to other tags."""
        self._check_ready()
        key = (i, int(tag))
        syn = self._synthetic.pop(key, None)
        if syn is not None:
            return syn
        stashed = self._stash_pop(key)
        if stashed is not None:
            return self._decode(i, stashed, key[1])
        deadline = Deadline(timeout)
        while True:
            if block:
                got = self._coord.waitany([i], timeout=deadline.remaining())
                if got is None:
                    return None  # timeout
                _, msg = got
            else:
                msg = self._coord.poll(i)
                if msg is None:
                    return None
            if msg.kind == T.KIND_DEATH and self.on_dead == "straggle":
                # infinite-straggler semantics: a dead rank never
                # completes; it does not error either. (Real frames a
                # worker delivered before dying were already drained —
                # the native poll only synthesizes the death marker on
                # an empty queue.)
                if not block:
                    return None
                return _straggle_exhausted([i], deadline, timeout)
            if self._consume_obs(i, msg):
                continue  # piggybacked telemetry, not a completion
            msg = self._route(i, msg, key[1])
            if msg is not None:
                return self._decode(i, msg, key[1])

    def test(self, i: int, *, tag: int = 0):
        return self._next(i, block=False, tag=tag)

    def wait_any(
        self,
        indices: Sequence[int],
        timeout: float | None = None,
        *,
        tags: Sequence[int] | None = None,
    ) -> tuple[int, object] | None:
        self._check_ready()
        idx = [int(j) for j in indices]
        if not idx:
            raise ValueError("wait_any over an empty index set would hang")
        tgs = [0] * len(idx) if tags is None else [int(t) for t in tags]
        if len(tgs) != len(idx):
            raise ValueError("tags must align one-to-one with indices")
        # the same worker may be awaited on several channels at once
        # (wait_any([0, 0], tags=[0, 1]) — SlotBackend honors this, so
        # must we): route against the full awaited-pair set per rank
        awaited: dict[int, list[int]] = {}
        for j, t in zip(idx, tgs):
            awaited.setdefault(j, []).append(t)
        for j, t in zip(idx, tgs):
            syn = self._synthetic.pop((j, t), None)
            if syn is not None:  # already complete
                return j, syn
            stashed = self._stash_pop((j, t))
            if stashed is not None:
                return j, self._decode(j, stashed, t)
        deadline = Deadline(timeout)
        live = list(idx)
        while True:
            got = self._coord.waitany(live, timeout=deadline.remaining())
            if got is None:
                return None  # timed out
            j, msg = got
            if msg.kind == T.KIND_DEATH:
                if self.on_dead == "straggle":
                    # infinite-straggler semantics. The marker only
                    # surfaces once the rank's real frames drained (the
                    # native poll synthesizes it on an empty queue), so
                    # dropping the rank HERE — not via an is_dead
                    # pre-filter — never loses a delivered result.
                    live = [r for r in live if r != j]
                    if not live:
                        return _straggle_exhausted(idx, deadline, timeout)
                    continue  # keep waiting on the survivors
                # rank-wide: surface on this rank's first awaited channel
                # (the sticky native marker re-fires for the others)
                return j, self._decode(j, msg, awaited[j][0])
            if self._consume_obs(j, msg):
                continue  # piggybacked telemetry, not a completion
            mtag = int(msg.tag)
            if msg.seq != self._cur.get((j, mtag), -1):
                continue  # superseded dispatch; drop
            if mtag in awaited[j]:
                return j, self._decode(j, msg, mtag)
            self._stash.setdefault((j, mtag), deque()).append(msg)

    def wait(self, i: int, timeout: float | None = None, *, tag: int = 0):
        return self._next(i, block=True, timeout=timeout, tag=tag)

    def dead_workers(self) -> list[int]:
        """Ranks the transport currently marks dead (not yet
        respawned/reaccepted) — the ``/healthz`` pool check reads
        this."""
        if self._closed:
            return list(range(self.n_workers))
        return [
            i for i in range(self.n_workers) if self._coord.is_dead(i)
        ]

    def respawn(self, i: int, *, connect_timeout: float = 60.0) -> None:
        """Elastic recovery: replace a dead worker process with a fresh
        one on the same rank (the reference has no such capability — a
        dead rank is permanent and hangs ``Waitall!``, SURVEY §5). The
        new process reconnects through the transport's reaccept path;
        pool state is untouched — the rank simply becomes dispatchable
        again, and any frames from the old incarnation are dropped by
        the seq guard."""
        if self._closed:
            raise RuntimeError("backend has been shut down")
        if not self._spawn:
            raise RuntimeError(
                "respawn() needs locally spawned workers; for external "
                "workers restart the remote process and call reaccept()"
            )
        if not self._coord.is_dead(i) and self._procs[i].is_alive():
            raise RuntimeError(f"worker {i} is alive; nothing to respawn")
        if self._procs[i].is_alive():  # pragma: no cover - zombie socket
            self._procs[i].terminate()
        self._procs[i].join(timeout=self._join_timeout)
        self._spawn_worker(i)
        # reaccept tolerates a not-yet-drained HUP within its timeout
        self._coord.reaccept(i, timeout=connect_timeout)
        # synthetic failures for rank i, if set, stay: they record
        # dispatches the old incarnation never received — the pool must
        # still see them fail

    def reaccept(self, i: int, *, timeout: float = 60.0) -> None:
        """External-worker recovery (``spawn=False``): after the remote
        worker process for rank ``i`` is restarted out-of-band, accept
        its reconnect so the rank becomes dispatchable again."""
        if self._closed:
            raise RuntimeError("backend has been shut down")
        self._coord.reaccept(i, timeout=timeout)

    def reap(self, i: int) -> None:
        """Elastic shrink: deliberately retire worker process ``i`` —
        the pair of :meth:`respawn`, and the verb the fleet
        controller's pool scaler uses (the JAX package's
        ``fleet/failover.py``). The
        process is terminated; the transport's native progress thread
        sees the HUP and sets the sticky dead marker, so the rank
        reads as dead (:meth:`dead_workers`) until :meth:`respawn`
        reconnects a fresh incarnation. Reap at an epoch boundary
        (after ``waitall``) to retire a rank with nothing outstanding.
        Idempotent while already dead."""
        if self._closed:
            raise RuntimeError("backend has been shut down")
        if not self._spawn:
            raise RuntimeError(
                "reap() needs locally spawned workers; stop external "
                "workers out-of-band (the transport marks the rank "
                "dead on its HUP)"
            )
        if self._coord.is_dead(i):
            return
        proc = self._procs[i]
        if proc.is_alive():
            proc.terminate()
        proc.join(timeout=self._join_timeout)
        # the native epoll thread stamps the sticky marker on the HUP;
        # wait for it so dead_workers() is truthful on return
        deadline = _time.monotonic() + self._join_timeout
        while not self._coord.is_dead(i):
            if _time.monotonic() >= deadline:  # pragma: no cover
                raise RuntimeError(
                    f"worker {i} terminated but the transport never "
                    "marked the rank dead"
                )
            _time.sleep(0.005)

    def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        # don't pin the last payload + its native snapshot for the
        # backend object's remaining lifetime
        self._drop_cache()
        self._pick_epoch = None
        if not self._accepted:
            # handshake never completed: there is no connection to send a
            # control frame on and nothing graceful to wait for — a
            # join-first drain would burn join_timeout per blocked worker
            for p in self._procs:
                if p is not None and p.is_alive():
                    p.terminate()
            for p in self._procs:
                if p is not None:
                    p.join(timeout=self._join_timeout)
                    if not p.is_alive():
                        p.close()
            self._coord.close()
            return
        for i in range(self.n_workers):
            # control-channel broadcast (reference test/kmap2.jl:14-18)
            self._coord.isend(i, b"", kind=T.KIND_CONTROL)
        for p in self._procs:
            if p is not None:
                p.join(timeout=self._join_timeout)
        if self.aggregator is not None:
            # the workers flushed a final telemetry frame before
            # exiting; nothing polls the queues after this point, so
            # drain them here or the end-of-run deltas are lost. A
            # rank whose process is still alive (wedged in work_fn —
            # about to be terminated below) never sent a drain frame
            # and never will: poll it non-blockingly for whatever is
            # already queued instead of burning the retry window per
            # stuck rank
            for i in range(self.n_workers):
                p = self._procs[i]
                alive = p is not None and p.is_alive()
                self._drain_obs(i, timeout=0.0 if alive else 2.0)
        for p in self._procs:
            if p is not None and p.is_alive():  # pragma: no cover
                p.terminate()
                p.join(timeout=self._join_timeout)  # reap before close
        for p in self._procs:
            if p is not None and not p.is_alive():
                p.close()  # release the spawn sentinel fds deterministically
        self._coord.close()
