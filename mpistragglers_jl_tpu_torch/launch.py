"""``mpiexec``-equivalent one-shot SPMD launcher.

A copy of the JAX package's ``launch.py`` (stdlib only).

The reference's whole topology comes up with one command —
``mpiexec -n N julia script.jl`` (test/runtests.jl:17): N OS processes
run the *same* script, rank 0 is the coordinator by convention and ranks
1..N-1 are workers. This module reproduces that experience:

.. code-block:: console

    python -m mpistragglers_jl_tpu_torch.launch -n 8 my_script.py [args...]

launches 8 copies of ``my_script.py``; inside the script,

.. code-block:: python

    from mpistragglers_jl_tpu_torch import launch
    ctx = launch.init()
    if ctx.is_coordinator:
        backend = ctx.coordinator_backend()   # all workers connected
        ...asyncmap(pool, payload, backend)...
        backend.shutdown()
    else:
        ctx.serve(work_fn)                    # blocks until shutdown

mirrors the reference's ``if rank == root: coordinator_main() else:
worker_main()`` split (examples/iterative_example.jl), with the library
owning everything the reference left to convention: the rendezvous
address, the shared auth secret, the worker loop, the shutdown
broadcast, and non-zero-exit propagation (a failed rank fails the
launch, like mpiexec).

Implementation notes. The launcher picks a fresh Unix-socket address
(or ``--address tcp://host:port`` for multi-host-style runs) and a
random auth token, and hands both to every rank through the
environment (``MSGT_ADDRESS`` / ``MSGT_AUTH`` / ``MSGT_RANK`` /
``MSGT_NRANKS``). Rank 0 binds the socket; workers' connect loop
retries until it is up (worker.py), so start order does not matter.

**Multi-host** (``mpiexec --hostfile`` equivalent, reference
test/runtests.jl:17 via libmpi):

.. code-block:: console

    python -m mpistragglers_jl_tpu_torch.launch -n 16 --hosts hostA,hostB my_script.py
    python -m mpistragglers_jl_tpu_torch.launch -n 16 --hostfile hosts.txt my_script.py

Ranks are block-assigned to hosts in order (``hostA:slots`` caps a
host's share; a hostfile holds one ``host[:slots]`` per line, ``#``
comments allowed). The first host gets rank 0 and should be the
launching machine (or reachable at the ``--address`` host). Each
remote host gets ONE ssh session running this module in span mode
(``--_span A:B``), which forks its rank processes locally and exits
with the span's worst code — so a failed remote rank fails the launch
exactly like a local one. Assumptions are mpiexec's: passwordless ssh
and the same filesystem layout (script path + package importable) on
every host. ``--launcher`` substitutes the ssh command (the e2e test
fakes two hosts as two local process groups with separate tmpdirs
this way).
"""

from __future__ import annotations

import argparse
import os
import secrets
import signal
import subprocess
import sys
import tempfile
import time
import uuid
from dataclasses import dataclass

__all__ = ["LaunchContext", "init", "main"]

_ENV_RANK = "MSGT_RANK"
_ENV_NRANKS = "MSGT_NRANKS"
_ENV_ADDRESS = "MSGT_ADDRESS"
_ENV_AUTH = "MSGT_AUTH"


@dataclass(frozen=True)
class LaunchContext:
    """This rank's view of a launched job (reference analog: the
    ``MPI.Comm_rank``/``Comm_size`` pair every script starts with)."""

    rank: int
    n_ranks: int
    address: str
    token: bytes

    @property
    def is_coordinator(self) -> bool:
        """Rank 0 is the coordinator, the reference's root convention
        (examples/iterative_example.jl:10)."""
        return self.rank == 0

    @property
    def n_workers(self) -> int:
        """Pool size: every rank except the coordinator."""
        return self.n_ranks - 1

    @property
    def worker_index(self) -> int:
        """This rank's pool index (valid on worker ranks only)."""
        if self.rank == 0:
            raise RuntimeError("rank 0 is the coordinator, not a worker")
        return self.rank - 1

    def coordinator_backend(self, *, connect_timeout: float = 60.0, **kw):
        """The connected :class:`~.backends.native.NativeProcessBackend`
        over this job's workers (coordinator rank only)."""
        if not self.is_coordinator:
            raise RuntimeError(
                "coordinator_backend() is for rank 0; workers call serve()"
            )
        from .backends.native import NativeProcessBackend

        return NativeProcessBackend(
            None,
            self.n_workers,
            spawn=False,
            address=self.address,
            auth=self.token,
            connect_timeout=connect_timeout,
            **kw,
        )

    def serve(self, work_fn, delay_fn=None, *,
              connect_timeout: float = 60.0) -> None:
        """Run this rank's worker loop until the coordinator's shutdown
        broadcast (worker ranks only). ``work_fn(i, payload, epoch)``."""
        from .worker import run_worker

        run_worker(
            self.address,
            self.worker_index,
            work_fn,
            delay_fn,
            token=self.token,
            connect_timeout=connect_timeout,
        )


def init() -> LaunchContext:
    """Read this process's launch environment (set by ``main``).

    Raises ``RuntimeError`` when not running under the launcher — a
    script can catch that to fall back to single-process mode.
    """
    rank = os.environ.get(_ENV_RANK)
    if rank is None:
        raise RuntimeError(
            "not launched via `python -m mpistragglers_jl_tpu_torch.launch`; "
            f"{_ENV_RANK} is unset"
        )
    token = os.environ.get(_ENV_AUTH, "")
    return LaunchContext(
        rank=int(rank),
        n_ranks=int(os.environ[_ENV_NRANKS]),
        address=os.environ[_ENV_ADDRESS],
        token=token.encode(),
    )


def parse_hosts(hosts_arg: str | None, hostfile: str | None
                ) -> list[tuple[str, int | None]]:
    """``--hosts a,b:4`` / hostfile lines ``host[:slots]`` (or mpiexec's
    ``host slots=K``) -> [(host, slots-or-None), ...]."""
    entries: list[str] = []
    if hosts_arg:
        entries.extend(h.strip() for h in hosts_arg.split(",") if h.strip())
    if hostfile:
        with open(hostfile) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line:
                    entries.append(line.replace(" slots=", ":"))
    out: list[tuple[str, int | None]] = []
    for e in entries:
        if e.startswith("["):  # bracketed IPv6 literal: [addr][:slots]
            addr, _, rest = e[1:].partition("]")
            if rest.startswith(":"):
                out.append((addr, int(rest[1:])))
            elif not rest:
                out.append((addr, None))
            else:
                raise ValueError(f"malformed host entry {e!r}")
        elif e.count(":") > 1:
            # a bare IPv6 literal is ambiguous with host:slots —
            # rsplit would silently eat the last address group
            raise ValueError(
                f"ambiguous host entry {e!r}: bracket IPv6 literals "
                "([fe80::1] or [fe80::1]:4)"
            )
        elif ":" in e:
            host, slots = e.rsplit(":", 1)
            out.append((host, int(slots)))
        else:
            out.append((e, None))
    return out


def assign_ranks(n: int, hosts: list[tuple[str, int | None]]
                 ) -> list[tuple[str, range]]:
    """Block-assign ranks 0..n-1 to hosts in order (mpiexec fill
    semantics): capped hosts take their slot count, uncapped hosts split
    the remainder evenly (earlier hosts take the extra)."""
    caps = [s for _, s in hosts]
    free = [i for i, s in enumerate(caps) if s is None]
    fixed = sum(s for s in caps if s is not None)
    rest = n - fixed
    if free:
        if rest < 0:
            raise ValueError(f"host slots sum to {fixed} > -n {n}")
        share, extra = divmod(max(rest, 0), len(free))
        for j, i in enumerate(free):
            caps[i] = share + (1 if j < extra else 0)
    elif fixed != n:
        raise ValueError(
            f"host slots sum to {fixed} but -n is {n}; they must match "
            "(or leave a host uncapped to absorb the remainder)"
        )
    spans, start = [], 0
    for (host, _), c in zip(hosts, caps):
        if c:
            spans.append((host, range(start, start + c)))
            start += c
    if start != n:
        raise ValueError(f"assigned {start} ranks for -n {n}")
    return spans


def _is_local(host: str) -> bool:
    import socket

    return host in (
        "localhost", "127.0.0.1", socket.gethostname(),
        socket.getfqdn(),
    )


def _spawn_rank(r: int, base_env: dict, script: str,
                script_args: list[str]) -> subprocess.Popen:
    env = dict(base_env)
    env[_ENV_RANK] = str(r)
    return subprocess.Popen(
        [sys.executable, script, *script_args], env=env
    )


def _remote_cmd(launcher: str, host: str, span: range, base_env: dict,
                grace: float, script: str, script_args: list[str]
                ) -> list[str]:
    """One ssh(-like) invocation running this module in span mode on
    ``host``. The rendezvous env rides explicit ``env`` assignments
    (ssh does not forward the environment); cwd is re-entered so the
    same relative script path resolves (mpiexec's same-layout
    assumption)."""
    import shlex

    exports = " ".join(
        f"{k}={shlex.quote(base_env[k])}"
        for k in (_ENV_NRANKS, _ENV_ADDRESS)
    )
    # the auth secret is deliberately NOT in the exports: anything on
    # the ssh command line lands in `ps` output on BOTH hosts for the
    # job's lifetime. It rides the already-open stdin pipe instead
    # (first line; see the span-mode reader in main)
    remote = (
        f"cd {shlex.quote(os.getcwd())} && env {exports} "
        f"{shlex.quote(sys.executable)} -m mpistragglers_jl_tpu_torch.launch "
        f"--_span {span.start}:{span.stop} --grace {grace} "
        f"-n {base_env[_ENV_NRANKS]} "
        + " ".join(shlex.quote(a) for a in [script, *script_args])
    )
    return [*shlex.split(launcher), host, remote]


def _span_stdin_watchdog(
    procs: list[subprocess.Popen], verdict: dict
) -> None:
    """Tie a span runner's life to its ssh channel: when the launcher
    dies or aborts the job, the ssh client goes away, this process's
    stdin hits EOF, and the watchdog kills the span's rank processes
    instead of orphaning them on the remote host (ssh without a pty
    delivers no signal on channel close — EOF on stdin is the only
    portable death notice). Before killing, it records the span's
    worst *already observed* rank code in ``verdict`` and the main
    thread exits with THAT — an early rank failure must survive the
    teardown of a hung sibling, and the main thread's own waits would
    otherwise race to report the watchdog's SIGTERM instead.

    Armed only when stdin is a pipe or socket (what sshd and the
    launcher's stdin=PIPE provide): a manual span-mode run with a tty
    or /dev/null stdin must not see instant EOF and kill its ranks at
    startup."""
    import stat
    import threading

    try:
        mode = os.fstat(0).st_mode
    except OSError:  # pragma: no cover - no stdin at all
        return
    if not (stat.S_ISFIFO(mode) or stat.S_ISSOCK(mode)):
        return

    def watch():
        try:
            # raw os.read, NOT sys.stdin.buffer: a daemon thread
            # blocked in a buffered read holds the buffer lock through
            # interpreter shutdown and CPython aborts with a fatal
            # _enter_buffered_busy error when the span exits normally
            while os.read(0, 4096):
                pass  # the launcher never writes; wait for EOF
        except OSError:  # pragma: no cover - stdin already closed
            pass
        codes = [
            rc for p in procs if (rc := p.poll()) is not None
        ]
        worst = max(codes, key=abs) if any(codes) else 0
        verdict["worst"] = abs(worst) if worst else 0
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + 5.0
        for p in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:  # pragma: no cover
                p.kill()
        # last resort: if a child is unreapable even after SIGKILL
        # (D-state), the main thread's unbounded wait would hang the
        # span and the launcher would misreport the failure as cleanup;
        # exiting here carries the SAME code the main thread would use,
        # so whichever side wins the race reports identically
        os._exit(verdict["worst"])

    threading.Thread(target=watch, daemon=True, name="span-watchdog").start()


def _wait_span(procs: list[subprocess.Popen], ranks: list[int],
               grace: float) -> list[int]:
    """Wait a group of rank processes: if rank 0 is in the group it
    finishes first (it owns the shutdown broadcast), then the rest get
    ``grace`` seconds before termination; a group without rank 0 waits
    for the broadcast-driven exits unboundedly (mpiexec semantics)."""
    codes: list[int] = []
    rest = list(zip(ranks, procs))
    if 0 in ranks:
        i0 = ranks.index(0)
        p0 = procs[i0]
        rest = [rp for rp in rest if rp[0] != 0]
        # Poll ALL procs while the coordinator runs: a sibling (local
        # rank or whole remote span) that dies nonzero early must abort
        # the job promptly, mpiexec-style — otherwise a span that died
        # before serving (bad host, ssh crash after the token write)
        # leaves the coordinator waiting for workers that will never
        # connect and the launch hangs unboundedly.
        while True:
            rc0 = p0.poll()
            if rc0 is not None:
                codes.append(rc0)
                break
            failed = next(
                ((r, p, p.poll()) for r, p in rest
                 if p.poll() not in (None, 0)),
                None,
            )
            if failed is not None:
                r, _, rc = failed
                what = f"rank {r}" if r >= 0 else "remote span"
                print(
                    f"launch: {what} exited {rc} before the job "
                    "finished; aborting", file=sys.stderr,
                )
                _teardown(procs)
                return [rc]
            time.sleep(0.05)
        deadline = time.monotonic() + grace
        for _, p in rest:
            try:
                codes.append(
                    p.wait(timeout=max(0.0, deadline - time.monotonic()))
                )
            except subprocess.TimeoutExpired:
                if p.stdin is not None:
                    # remote span: closing the ssh channel EOFs the
                    # remote watchdog, which kills its ranks and exits
                    # with the span's worst already-observed code —
                    # collect THAT, so an early remote rank failure is
                    # not masked by a hung sibling
                    try:
                        p.stdin.close()
                    except OSError:  # pragma: no cover
                        pass
                    try:
                        codes.append(p.wait(timeout=15.0))
                        continue
                    except subprocess.TimeoutExpired:  # pragma: no cover
                        pass
                # the launcher is killing this rank itself (grace
                # expired after a clean coordinator exit) — that is
                # cleanup, not a rank failure, so it must not mask a
                # real failure code from another rank
                p.terminate()
                try:
                    p.wait(timeout=5.0)
                except subprocess.TimeoutExpired:  # pragma: no cover
                    p.kill()
                    p.wait()
                codes.append(0)
    else:
        for _, p in rest:
            codes.append(p.wait())
    return codes


def _teardown(procs: list[subprocess.Popen]) -> None:
    """Tear the whole job down: EOF remote liveness channels (the span
    watchdog reaps its ranks — a signal to the ssh client never
    crosses), SIGINT local ranks, then wait/kill."""
    for p in procs:
        if p.stdin is not None:
            try:
                p.stdin.close()
            except OSError:
                pass
        if p.poll() is None:
            p.send_signal(signal.SIGINT)
    for p in procs:
        try:
            p.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            p.kill()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m mpistragglers_jl_tpu_torch.launch",
        description="Run one script on N processes: rank 0 coordinates, "
        "ranks 1..N-1 serve as pool workers (the mpiexec experience, "
        "reference test/runtests.jl:17).",
    )
    ap.add_argument("-n", "--nranks", type=int, required=True,
                    help="total ranks incl. the coordinator (pool size n-1)")
    ap.add_argument(
        "--address", default=None,
        help="rendezvous address (default: fresh Unix socket, or "
        "tcp://<this-host>:<random port> under --hosts)",
    )
    ap.add_argument(
        "--hosts", default=None,
        help="comma-separated host[:slots] list; ranks are block-"
        "assigned in order, the first host takes rank 0 (mpiexec "
        "hostfile semantics over ssh)",
    )
    ap.add_argument(
        "--hostfile", default=None,
        help="file of host[:slots] lines (mpiexec 'host slots=K' "
        "accepted); combined after --hosts",
    )
    ap.add_argument(
        "--launcher", default="ssh -o BatchMode=yes",
        help="command prefix to reach a remote host (default "
        "'ssh -o BatchMode=yes'; the e2e test substitutes a local "
        "fake to model two hosts as two process groups)",
    )
    ap.add_argument(
        "--grace", type=float, default=10.0,
        help="seconds workers get to exit after the coordinator returns "
        "before being terminated",
    )
    ap.add_argument(
        "--_span", default=None, help=argparse.SUPPRESS,
    )  # internal: 'A:B' — run ranks A..B-1 locally (remote side of ssh)
    ap.add_argument("script", help="Python script every rank executes")
    ap.add_argument("script_args", nargs=argparse.REMAINDER,
                    help="arguments passed through to the script")
    args = ap.parse_args(argv)
    if args.nranks < 2:
        ap.error("-n must be >= 2 (one coordinator + at least one worker)")

    if args._span is not None:
        # span mode: this process IS one host's share of the job; the
        # rendezvous env was injected by the launching side
        a, b = (int(x) for x in args._span.split(":"))
        base_env = dict(os.environ)
        if _ENV_AUTH not in base_env:
            # the secret arrives as the FIRST stdin line (never on the
            # ssh command line — argv is world-readable via ps); read
            # it before the watchdog takes over the pipe
            line = sys.stdin.buffer.readline()
            if not line.strip():
                ap.error(
                    f"span mode needs {_ENV_AUTH} in the environment or "
                    "the secret on the first stdin line"
                )
            base_env[_ENV_AUTH] = line.strip().decode()
        for key in (_ENV_NRANKS, _ENV_ADDRESS):
            if key not in base_env:
                ap.error(f"span mode requires {key} in the environment")
        procs = [
            _spawn_rank(r, base_env, args.script, args.script_args)
            for r in range(a, b)
        ]
        verdict: dict = {}
        _span_stdin_watchdog(procs, verdict)
        codes = _wait_span(procs, list(range(a, b)), args.grace)
        if "worst" in verdict:
            # channel EOF tore the span down: report the failure the
            # watchdog observed BEFORE killing, not the kill signals
            sys.exit(verdict["worst"])
        sys.exit(max(codes, key=abs) if any(codes) else 0)

    hosts = parse_hosts(args.hosts, args.hostfile)
    if hosts:
        spans = assign_ranks(args.nranks, hosts)
        if args.address is None:
            import socket

            port = 20000 + secrets.randbelow(40000)
            # rank 0 binds on the FIRST host, so the address host must
            # be that machine's name as the OTHER hosts resolve it: the
            # first --hosts entry verbatim when it is remote, this
            # machine's hostname when the first entry is a local alias
            # ("localhost" would make remote workers dial themselves)
            first = hosts[0][0]
            host0 = socket.gethostname() if _is_local(first) else first
            address = f"tcp://{host0}:{port}"
        else:
            address = args.address
        if not address.startswith("tcp://"):
            ap.error("--hosts requires a tcp:// --address")
    else:
        spans = [("localhost", range(args.nranks))]
        address = args.address or os.path.join(
            tempfile.gettempdir(), f"msgt-launch-{uuid.uuid4().hex[:12]}.sock"
        )
    token = secrets.token_hex(16)
    base_env = dict(os.environ)
    base_env[_ENV_NRANKS] = str(args.nranks)
    base_env[_ENV_ADDRESS] = address
    base_env[_ENV_AUTH] = token

    procs: list[subprocess.Popen] = []
    ranks_of: list[list[int]] = []  # local rank lists; [-1] = remote span
    try:
        for host, span in spans:
            if _is_local(host):
                for r in span:
                    procs.append(
                        _spawn_rank(r, base_env, args.script,
                                    args.script_args)
                    )
                    ranks_of.append([r])
            else:
                # stdin=PIPE, held open for the job's life: the remote
                # span runner's watchdog treats EOF on this channel as
                # the launch dying and tears its ranks down (no orphaned
                # remote processes on abort — see _span_stdin_watchdog)
                p = subprocess.Popen(
                    _remote_cmd(
                        args.launcher, host, span, base_env, args.grace,
                        args.script, args.script_args,
                    ),
                    stdin=subprocess.PIPE,
                )
                # first stdin line = the auth secret (see _remote_cmd);
                # the pipe then stays open as the job-liveness channel
                procs.append(p)
                ranks_of.append([-1] if 0 not in span else [0])
                try:
                    p.stdin.write((token + "\n").encode())
                    p.stdin.flush()
                except OSError as e:
                    # ssh died immediately (bad host, ssh not on PATH):
                    # the token write hits a broken pipe. Treat it as a
                    # failed span — reap this proc's code and tear the
                    # rest of the job down via the shared cleanup below
                    # instead of escaping with a raw traceback that
                    # orphans already-spawned ranks.
                    code = p.wait()
                    print(
                        f"launch: span on {host!r} failed before start "
                        f"(exit {code}): {e}",
                        file=sys.stderr,
                    )
                    _teardown(procs)
                    sys.exit(code if code else 1)
        flat_ranks = [r for rs in ranks_of for r in rs]
        codes = _wait_span(procs, flat_ranks, args.grace)
    except KeyboardInterrupt:  # forward ^C to the whole job, mpiexec-style
        _teardown(procs)
        raise
    finally:
        if (
            args.address is None
            and not address.startswith("tcp://")
            and os.path.exists(address)
        ):
            try:
                os.unlink(address)
            except OSError:  # pragma: no cover
                pass
    # a failed rank (local or remote span) fails the launch, like mpiexec
    sys.exit(max(codes, key=abs) if any(codes) else 0)


if __name__ == "__main__":
    main()
