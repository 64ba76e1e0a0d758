"""Standalone worker entry point for multi-host pools.

A copy of the JAX package's ``worker.py``; it imports no torch, so a
worker whose ``work_fn`` stays on the host starts light, and one that
computes on the card imports torch itself. Its frames are the JAX
package's, so either package's workers serve either coordinator.

The reference's multi-process story is ``mpiexec`` launching every rank
on hosts listed in a hostfile (test/runtests.jl:17); the equivalent here
is one coordinator binding the native transport on TCP and each remote
host launching workers against it:

    # on the coordinator host
    backend = NativeProcessBackend(work_fn, n, spawn=False,
                                   address="tcp://0.0.0.0:5555")

    # on each worker host
    python -m mpistragglers_jl_tpu_torch.worker \
        --address tcp://coordinator-host:5555 --rank 3 \
        --work mypkg.mymod:work_fn

The worker loop is the reference's receive -> stall -> compute -> send
convention (SURVEY §3.2, examples/iterative_example.jl:55-82) made a
first-class program: frames in, pickled payloads through ``work_fn``,
results (or captured exceptions) back, shutdown on the control frame.
``--work`` takes ``module:attribute``; the module must be importable on
the worker host (install your package or set PYTHONPATH).
"""

from __future__ import annotations

import argparse
import importlib
import os
import time
import traceback

from .backends.base import DelayFn
from .native import codec
from .native import transport as T

__all__ = ["run_worker", "resolve_callable", "main"]


def run_worker(
    address: str,
    rank: int,
    work_fn,
    delay_fn: DelayFn | None = None,
    *,
    token: bytes = b"",
    connect_timeout: float = 30.0,
    telemetry: bool = False,
    zero_copy: bool = True,
) -> None:
    """Connect to the coordinator and serve until shutdown.

    ``work_fn(rank, payload, epoch) -> result`` with picklable results;
    exceptions are captured and shipped back as failures, not lost the
    way reference worker assertions die inside mpiexec (SURVEY §4).

    Array payloads arrive as **read-only zero-copy views** of transport
    memory (socket frame, shared-memory region, or a broadcast-arena
    slot — native/codec.py); copy before mutating in place. Views may
    be retained indefinitely: a shared-memory region stays mapped (and
    an arena/ring slot stays unreclaimed) for as long as any view of it
    is alive — eviction and slot reuse are deferred, never dangling.
    ``zero_copy=False`` turns off both the result ring and (on the
    coordinator side, via the backend's matching flag) the arena.

    The connect retries with backoff until ``connect_timeout``: a worker
    that races the coordinator's bind, or whose hello lands while the
    coordinator is busy reaccepting a different rank, re-attempts
    instead of exiting and permanently losing the rank. ``token`` is the
    shared auth secret (must match the coordinator's, if it has one).

    ``telemetry=True`` (coordinator-requested via
    ``NativeProcessBackend(registry=...)``, or ``--telemetry`` on the
    CLI) keeps a worker-local
    :class:`~.obs.aggregate.WorkerTelemetry`; its snapshot follows each
    result as a standalone frame on the reserved
    :data:`~.obs.aggregate.OBS_TAG` channel (plus one final frame
    before shutdown), which an aggregating coordinator merges and a
    dark one drops by the tag's seq guard — the frames are invisible to
    the pool either way.
    """
    tele = None
    if telemetry:
        from .obs.aggregate import OBS_TAG, WorkerTelemetry

        tele = WorkerTelemetry(rank)
    w = _connect_retry(
        address, rank, token, connect_timeout,
        ring_min=T.RING_MIN if zero_copy else None,
    )
    try:
        while True:
            msg = w.recv()
            t_recv_w = time.perf_counter() if tele is not None else 0.0
            if msg is None or msg.kind == T.KIND_CONTROL:
                if tele is not None and msg is not None:
                    # shutdown drain: flush the last telemetry frame
                    p, b = codec.encode(tele.snapshot())
                    w.send2(p, b, seq=-1, tag=OBS_TAG)
                break  # coordinator gone, or shutdown broadcast
            failed = False
            t0 = 0.0
            stall = 0.0
            # routing echo saved up front so the frame itself can be
            # dropped the moment its payload is decoded
            seq_, epoch_, tag_ = msg.seq, msg.epoch, msg.tag
            try:
                # decoding is inside the capture: an undecodable payload
                # (e.g. a class not importable on this host — the common
                # multi-host failure) must ship back as an error, not
                # kill the worker without a diagnostic. Raw ndarray
                # payloads decode as zero-copy views (native/codec.py).
                payload = codec.decode(msg.payload, msg.body)
                msg = None  # the view chain roots in the payload now
                if delay_fn is not None:
                    d = float(delay_fn(rank, epoch_))
                    if d > 0:
                        stall = d
                        time.sleep(d)
                t0 = time.perf_counter()
                prefix, body = codec.encode(
                    work_fn(rank, payload, epoch_)
                )
                kind = T.KIND_DATA
            except BaseException as e:
                failed = True
                prefix, body = codec.encode(
                    (type(e).__name__, str(e), traceback.format_exc())
                )
                kind = T.KIND_ERROR
            # drop the payload view before sending: an arena slot is
            # only reclaimable once its views die. (For an echo-style
            # work_fn the RESULT may itself be the payload view, so the
            # chain fully dies only at `body = None` below — either
            # way, before the next recv, whose first act is to flush
            # the queued release acks.)
            payload = None
            msg = None
            # echo seq AND tag: the coordinator routes completions to
            # the (rank, tag) channel the dispatch was posted on. Data
            # results >= RING_MIN ride this worker's persistent result
            # ring (one memcpy into shared pages; only a control frame
            # crosses the socket); everything else is a two-buffer
            # socket send written straight from its buffer.
            if not w.send_result(
                prefix, body, seq=seq_, epoch=epoch_, tag=tag_,
                kind=kind,
            ):
                break
            prefix = body = None  # release NOW: the next recv's ack
            # flush ships the slot release in this same frame boundary
            if tele is not None:
                t1 = time.perf_counter()
                tele.task_done(
                    epoch_, t0 or t_recv_w, t1, error=failed,
                    stall=stall,
                )
                try:
                    p, b = codec.encode(
                        tele.snapshot(pair=(seq_, t_recv_w, t1))
                    )
                except Exception:
                    # span args are sanitized at record time, so this
                    # is belt-and-braces: a pathological frame must
                    # drop ITSELF, never kill a worker whose every
                    # task computed fine
                    continue
                if not w.send2(
                    p, b, seq=seq_, epoch=epoch_, tag=OBS_TAG
                ):
                    break
    finally:
        w.close()


def _connect_retry(
    address: str, rank: int, token: bytes, timeout: float,
    ring_min: int | None = T.RING_MIN,
) -> T.Worker:
    deadline = time.perf_counter() + timeout
    delay = 0.05
    while True:
        try:
            return T.Worker(address, rank, token=token, ring_min=ring_min)
        except T.TransportError:
            left = deadline - time.perf_counter()
            if left <= 0:
                raise
            time.sleep(min(delay, left))
            delay = min(delay * 2, 1.0)


def resolve_callable(spec: str):
    """Import ``module.path:attribute`` and return the attribute."""
    if ":" not in spec:
        raise ValueError(
            f"callable spec must be 'module:attribute', got {spec!r}"
        )
    mod_name, attr = spec.split(":", 1)
    obj = importlib.import_module(mod_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    if not callable(obj):
        raise TypeError(f"{spec} resolved to non-callable {obj!r}")
    return obj


def parse_ranks(spec: str) -> list[int]:
    """Parse a rank spec: ``3``, ``0-7``, or ``0,2,5-7``."""
    out: list[int] = []
    for part in spec.split(","):
        part = part.strip()
        if "-" in part:
            lo, hi = part.split("-", 1)
            lo, hi = int(lo), int(hi)
            if hi < lo:
                raise ValueError(f"descending rank range {part!r}")
            out.extend(range(lo, hi + 1))
        else:
            out.append(int(part))
    if len(set(out)) != len(out):
        raise ValueError(f"duplicate ranks in {spec!r}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m mpistragglers_jl_tpu_torch.worker",
        description="Serve pool worker(s) over the native transport.",
    )
    ap.add_argument(
        "--address", required=True,
        help="coordinator address: tcp://host:port or a unix socket path",
    )
    ap.add_argument(
        "--rank", "--ranks", dest="ranks", required=True,
        help="pool index, range, or list: '3', '0-7', '0,2,5-7' — one "
        "worker process per rank (a host serving several ranks needs "
        "only one command)",
    )
    ap.add_argument(
        "--work", required=True,
        help="work function as module:attribute, "
        "signature (rank, payload, epoch) -> result",
    )
    ap.add_argument(
        "--delay", default=None,
        help="optional delay_fn as module:attribute (straggler injection)",
    )
    ap.add_argument(
        "--auth-file", default=None,
        help="file holding the shared auth secret (the coordinator's "
        "`auth=` bytes); the MSGT_AUTH environment variable is the "
        "argv-invisible alternative. No flag/env = unauthenticated",
    )
    ap.add_argument(
        "--telemetry", action="store_true",
        help="keep a worker-local metrics registry and piggyback its "
        "snapshots on result frames (merged by a coordinator built "
        "with registry=; dropped harmlessly otherwise)",
    )
    ap.add_argument(
        "--no-zero-copy", action="store_true",
        help="disable this worker's shared-memory result ring (the "
        "copying socket sends only) — pair with the coordinator's "
        "zero_copy=False for a fully copying baseline; TCP workers "
        "are copying regardless",
    )
    args = ap.parse_args(argv)
    ranks = parse_ranks(args.ranks)
    token = _resolve_token(args.auth_file)
    # resolve in the parent too: a typo'd spec fails fast, before spawn
    work_fn = resolve_callable(args.work)
    delay_fn = resolve_callable(args.delay) if args.delay else None
    if len(ranks) == 1:
        run_worker(args.address, ranks[0], work_fn, delay_fn,
                   token=token, telemetry=args.telemetry,
                   zero_copy=not args.no_zero_copy)
        return
    # one OS process per rank (ranks must not share a Python process:
    # work_fn may hold the GIL, and per-rank crash isolation is the
    # point). Children get the SPEC STRINGS and re-resolve — resolved
    # callables may not survive spawn's pickle round-trip (bound
    # methods, decorated functions), and the strings always do.
    import multiprocessing as mp
    import signal

    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(
            target=_spawned_rank_main,
            args=(args.address, r, args.work, args.delay, token,
                  args.telemetry, not args.no_zero_copy),
            name=f"pool-cli-worker-{r}",
        )
        for r in ranks
    ]

    def _terminate(signum, frame):  # pragma: no cover - signal path
        for p in procs:
            if p.is_alive():
                p.terminate()

    # killing the one-command-per-host parent must not orphan the
    # per-rank children (a replacement command would find duplicate
    # live ranks)
    signal.signal(signal.SIGTERM, _terminate)
    signal.signal(signal.SIGINT, _terminate)
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join()
    finally:
        for p in procs:
            if p.is_alive():  # pragma: no cover - abnormal exit
                p.terminate()
    failed = [p.name for p in procs if p.exitcode not in (0, None)]
    if failed:
        raise SystemExit(
            f"worker processes exited nonzero: {', '.join(failed)}"
        )


def _resolve_token(auth_file: str | None) -> bytes:
    """Auth secret from ``--auth-file`` (wins) or ``MSGT_AUTH``.

    The file is read verbatim except for one trailing newline (the
    editor artifact): secrets are arbitrary bytes, and a broad strip
    would corrupt any token that happens to start or end with a
    whitespace byte — HMAC then never matches and the worker is
    refused with no hint why.
    """
    if auth_file is not None:
        with open(auth_file, "rb") as f:
            data = f.read()
        if data.endswith(b"\n"):
            data = data[:-1]
        if data.endswith(b"\r"):
            data = data[:-1]
        return data
    env = os.environ.get("MSGT_AUTH")
    return env.encode() if env else b""


def _spawned_rank_main(
    address: str, rank: int, work_spec: str, delay_spec: str | None,
    token: bytes = b"", telemetry: bool = False, zero_copy: bool = True,
) -> None:
    """Child entry for multi-rank mode: resolve specs locally, serve."""
    run_worker(
        address,
        rank,
        resolve_callable(work_spec),
        resolve_callable(delay_spec) if delay_spec else None,
        token=token,
        telemetry=telemetry,
        zero_copy=zero_copy,
    )


if __name__ == "__main__":
    main()
