"""One-shot SPMD launcher, the port's copy of ``tests/test_launch.py``.

Reference bar: the whole topology up with one command,
``mpiexec -n N julia script.jl`` (test/runtests.jl:17). The launcher is
exercised end-to-end as a subprocess, the way a user runs it. The JAX
package's example scripts are replaced by the port's: ``_SPMD`` (its
``examples/spmd_launch_example.py`` over the port, written to a
temporary file) and ``bench/launch_gemm.py`` (config 2's row-block GEMM
at a small size on the CPU); multi-host is faked with ``--launcher``.
"""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_GEMM = os.path.join(REPO, "mpistragglers_jl_tpu_torch", "bench",
                           "launch_gemm.py")

# the JAX package's examples/spmd_launch_example.py over the port: a
# 10-epoch nwait=1 loop over the worker ranks, each stalling a rotating
# deterministic amount
_SPMD = textwrap.dedent("""
    import sys

    import numpy as np

    from mpistragglers_jl_tpu_torch import AsyncPool, asyncmap, launch, waitall


    def work(i, payload, epoch):
        return np.array([float(i), float(payload[0]), float(epoch)])


    def stall(i, epoch):
        return 0.02 * ((i + epoch) % 4)


    def main():
        ctx = launch.init()
        if not ctx.is_coordinator:
            ctx.serve(work, stall)
            return
        backend = ctx.coordinator_backend()
        try:
            pool = AsyncPool(ctx.n_workers, nwait=1)
            for epoch in range(1, 11):
                repochs = asyncmap(pool, np.array([np.pi * epoch]), backend,
                                   epoch=epoch)
                fresh = np.flatnonzero(repochs == epoch)
                print(f"epoch {epoch}: fresh={fresh.tolist()}")
            waitall(pool, backend)
            print(f"done: epochs={pool.epoch} workers={ctx.n_workers}")
        finally:
            backend.shutdown()


    if __name__ == "__main__":
        sys.exit(main())
""")


@pytest.fixture
def spmd_script(tmp_path):
    path = tmp_path / "spmd_launch_example.py"
    path.write_text(_SPMD)
    return str(path)


def _run_launcher(nranks, script, *extra, timeout=120, script_args=()):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "mpistragglers_jl_tpu_torch.launch",
         "-n", str(nranks), *extra, script, *script_args],
        capture_output=True, text=True, timeout=timeout, env=env,
    )


@pytest.mark.slow
def test_spmd_example_end_to_end(spmd_script):
    """The example runs to completion under the launcher: the
    coordinator's 10-epoch nwait=1 loop over launcher-started workers."""
    proc = _run_launcher(3, spmd_script)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "done: epochs=10 workers=2" in proc.stdout
    assert proc.stdout.count("epoch ") == 10


@pytest.mark.slow
def test_failed_rank_fails_the_launch(tmp_path):
    """mpiexec semantics: any rank exiting non-zero fails the job."""
    script = tmp_path / "boom.py"
    script.write_text(textwrap.dedent("""
        import sys
        from mpistragglers_jl_tpu_torch import launch
        ctx = launch.init()
        if ctx.is_coordinator:
            backend = ctx.coordinator_backend(connect_timeout=30)
            backend.shutdown()
            sys.exit(3)   # coordinator fails after a clean shutdown
        ctx.serve(lambda i, p, e: p)
    """))
    proc = _run_launcher(3, str(script), timeout=90)
    assert proc.returncode == 3


def test_init_outside_launcher_raises():
    from mpistragglers_jl_tpu_torch import launch

    env_backup = os.environ.pop("MSGT_RANK", None)
    try:
        import pytest

        with pytest.raises(RuntimeError, match="MSGT_RANK"):
            launch.init()
    finally:
        if env_backup is not None:
            os.environ["MSGT_RANK"] = env_backup


def test_parse_hosts_and_assign_ranks():
    from mpistragglers_jl_tpu_torch.launch import assign_ranks, parse_hosts

    hosts = parse_hosts("a:2,b", None)
    assert hosts == [("a", 2), ("b", None)]
    spans = assign_ranks(6, hosts)
    assert spans == [("a", range(0, 2)), ("b", range(2, 6))]
    # uncapped hosts split the remainder, earlier hosts take the extra
    spans = assign_ranks(5, [("a", None), ("b", None)])
    assert spans == [("a", range(0, 3)), ("b", range(3, 5))]
    import pytest

    with pytest.raises(ValueError, match="must match"):
        assign_ranks(5, [("a", 2), ("b", 2)])


def test_parse_hostfile_mpiexec_style(tmp_path):
    from mpistragglers_jl_tpu_torch.launch import parse_hosts

    hf = tmp_path / "hosts.txt"
    hf.write_text("# cluster\nnode1 slots=4\nnode2:2\nnode3\n")
    assert parse_hosts(None, str(hf)) == [
        ("node1", 4), ("node2", 2), ("node3", None)
    ]


@pytest.mark.slow
def test_multihost_two_process_groups(tmp_path, spmd_script):
    """The 'one command' bar: --hosts with a faked ssh
    models two hosts as two local process groups with separate tmpdirs
    over TCP; the whole 1-coordinator + 4-worker topology comes up from
    ONE launcher invocation and the epochs complete."""
    import socket

    fake = tmp_path / "fake_ssh.py"
    fake.write_text(textwrap.dedent("""
        import os, subprocess, sys
        # argv: [prog, host, remote-shell-command] — like `ssh host cmd`
        host, cmd = sys.argv[1], sys.argv[2]
        d = os.path.join(os.environ["FAKE_HOST_ROOT"], host)
        os.makedirs(d, exist_ok=True)
        env = dict(os.environ)
        env["TMPDIR"] = d                      # separate 'filesystem'
        sys.exit(subprocess.call(["bash", "-c", cmd], env=env))
    """))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["FAKE_HOST_ROOT"] = str(tmp_path / "hosts")
    proc = subprocess.run(
        [sys.executable, "-m", "mpistragglers_jl_tpu_torch.launch",
         "-n", "5", "--hosts", "localhost:1,hostB",
         "--address", f"tcp://127.0.0.1:{port}",
         "--launcher", f"{sys.executable} {fake}", spmd_script],
        capture_output=True, text=True, timeout=180, env=env,
    )
    assert proc.returncode == 0, (proc.stdout[-1500:], proc.stderr[-2000:])
    assert "done: epochs=10 workers=4" in proc.stdout
    # the remote group really ran under the fake host's tmpdir
    assert (tmp_path / "hosts" / "hostB").is_dir()


@pytest.mark.slow
def test_multihost_remote_rank_failure_propagates(tmp_path):
    """A non-zero exit inside the REMOTE span fails the launch (ssh
    span runner exits with the span's worst code, mpiexec-style)."""
    import socket

    fake = tmp_path / "fake_ssh.py"
    fake.write_text(textwrap.dedent("""
        import subprocess, sys
        sys.exit(subprocess.call(["bash", "-c", sys.argv[2]]))
    """))
    script = tmp_path / "boom.py"
    script.write_text(textwrap.dedent("""
        import sys
        from mpistragglers_jl_tpu_torch import launch
        ctx = launch.init()
        if ctx.is_coordinator:
            try:
                backend = ctx.coordinator_backend(connect_timeout=15)
                backend.shutdown()
            except Exception:
                pass  # the dead remote never connects; rank 2's code wins
            sys.exit(0)
        if ctx.rank == 2:
            sys.exit(7)   # remote worker dies before serving
        ctx.serve(lambda i, p, e: p)
    """))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "mpistragglers_jl_tpu_torch.launch",
         "-n", "3", "--hosts", "localhost:2,hostB",
         "--address", f"tcp://127.0.0.1:{port}",
         "--launcher", f"{sys.executable} {fake}",
         "--grace", "5", str(script)],
        capture_output=True, text=True, timeout=180, env=env,
    )
    assert proc.returncode == 7, (proc.returncode, proc.stderr[-2000:])


def test_parse_hosts_ipv6():
    import pytest

    from mpistragglers_jl_tpu_torch.launch import parse_hosts

    assert parse_hosts("[fe80::1]:4,[::1]", None) == [
        ("fe80::1", 4), ("::1", None)
    ]
    with pytest.raises(ValueError, match="bracket IPv6"):
        parse_hosts("fe80::1", None)


def test_remote_cmd_keeps_secret_off_argv():
    """The auth token must never appear on the ssh command line (argv
    is world-readable via ps on both hosts); it rides stdin."""
    from mpistragglers_jl_tpu_torch.launch import _remote_cmd

    env = {"MSGT_NRANKS": "4", "MSGT_ADDRESS": "tcp://h:1", 
           "MSGT_AUTH": "topsecret123"}
    cmd = _remote_cmd("ssh", "hostB", range(1, 4), env, 5.0,
                      "job.py", [])
    assert not any("topsecret123" in part for part in cmd)
    assert any("MSGT_ADDRESS" in part for part in cmd)


@pytest.mark.slow
def test_multihost_spmd_example_single_host():
    """The port's SPMD workload (``bench/launch_gemm.py``: rank 0
    coordinates, ranks 1-2 multiply row blocks) also runs single-host
    under the launcher — same script, no --hosts."""
    proc = _run_launcher(
        3, LAUNCH_GEMM, timeout=150,
        script_args=("--m", "64", "--epochs", "2", "--device", "cpu"),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert '"ok": true' in proc.stdout


@pytest.mark.slow
def test_span_watchdog_reaps_on_stdin_eof(tmp_path):
    """The remote-side guarantee: when the launch channel (stdin pipe)
    EOFs — launcher death or abort — the span runner kills its rank
    processes instead of orphaning them, and exits with the worst
    ALREADY-OBSERVED rank code so an early failure survives teardown."""
    import signal

    import pytest
    import time

    script = tmp_path / "mixed.py"
    script.write_text(textwrap.dedent("""
        import os, sys, time
        from mpistragglers_jl_tpu_torch import launch
        ctx = launch.init()
        open(os.environ["PIDDIR"] + f"/rank{ctx.rank}.pid", "w").write(
            str(os.getpid()))
        if ctx.rank == 1:
            sys.exit(5)       # early failure, must survive teardown
        time.sleep(300)       # hang: only the watchdog can end this
    """))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["MSGT_NRANKS"] = "3"
    env["MSGT_ADDRESS"] = "tcp://127.0.0.1:1"  # never dialed here
    env["PIDDIR"] = str(tmp_path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpistragglers_jl_tpu_torch.launch",
         "--_span", "1:3", "-n", "3", "--grace", "2", str(script)],
        stdin=subprocess.PIPE, env=env,
    )
    proc.stdin.write(b"secret\n")  # the auth line the span expects
    proc.stdin.flush()
    # wait until rank 2 is up AND rank 1 has fully exited with its
    # failure code — the watchdog must OBSERVE the failure before the
    # channel dies, which is the scenario this test pins
    deadline = time.monotonic() + 30
    while True:
        if time.monotonic() >= deadline:
            proc.kill()
            pytest.fail(
                "span never reached the armed state (rank files: "
                f"{sorted(p.name for p in tmp_path.iterdir())})"
            )
        if (tmp_path / "rank2.pid").exists() and (
            tmp_path / "rank1.pid"
        ).exists():
            pid1 = int((tmp_path / "rank1.pid").read_text())
            try:
                os.kill(pid1, 0)
            except ProcessLookupError:
                break  # rank 1 is gone (exit 5 recorded)
        time.sleep(0.1)
    pid2 = int((tmp_path / "rank2.pid").read_text())
    proc.stdin.close()  # the launch channel dies
    rc = proc.wait(timeout=30)
    assert rc == 5, rc  # rank 1's observed failure, not a kill code
    # the hung rank was reaped, not orphaned
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            os.kill(pid2, 0)
        except ProcessLookupError:
            break
        time.sleep(0.2)
    else:
        os.kill(pid2, signal.SIGKILL)
        raise AssertionError(f"rank 2 (pid {pid2}) survived stdin EOF")


def test_remote_span_broken_pipe_fails_clean(monkeypatch, capsys):
    """An ssh process that dies before reading the auth
    token (bad host, ssh missing) breaks the stdin pipe; the launcher
    must tear down already-spawned ranks and exit with a clean nonzero
    code — not escape with a BrokenPipeError traceback that orphans
    them."""
    import pytest

    from mpistragglers_jl_tpu_torch import launch

    events = []

    class FakeLocal:
        stdin = None

        def __init__(self):
            self.signaled = False

        def poll(self):
            return 0 if self.signaled else None

        def send_signal(self, sig):
            self.signaled = True
            events.append(("signal", sig))

        def wait(self, timeout=None):
            events.append("local-reaped")
            return 0

        def kill(self):  # pragma: no cover
            events.append("local-killed")

    class FakeStdin:
        def write(self, b):
            raise BrokenPipeError("Broken pipe")

        def flush(self):  # pragma: no cover
            pass

        def close(self):
            pass

    class FakeRemote:
        def __init__(self, *a, **kw):
            self.stdin = FakeStdin()

        def poll(self):
            return 255

        def wait(self, timeout=None):
            return 255

        def send_signal(self, sig):  # pragma: no cover
            pass

        def kill(self):  # pragma: no cover
            pass

    local = FakeLocal()
    monkeypatch.setattr(launch, "_spawn_rank", lambda *a, **kw: local)
    monkeypatch.setattr(launch.subprocess, "Popen", FakeRemote)
    with pytest.raises(SystemExit) as ei:
        launch.main(
            ["-n", "2", "--hosts", "localhost:1,deadhost",
             "--address", "tcp://127.0.0.1:1", "script.py"]
        )
    assert ei.value.code == 255  # the dead span's exit code wins
    # the already-spawned local rank was interrupted and reaped
    assert ("signal", __import__("signal").SIGINT) in events
    assert "local-reaped" in events
    err = capsys.readouterr().err
    assert "span on 'deadhost' failed before start" in err


@pytest.mark.slow
def test_remote_span_dying_after_token_aborts_promptly(tmp_path,
                                                     spmd_script):
    """The sibling of the broken-pipe case: the ssh process consumes the
    auth token, THEN crashes. The job must abort with the span's code
    promptly — not hang until the coordinator's own timeout while it
    waits for workers that will never connect."""
    import socket
    import time

    fake = tmp_path / "fake_ssh_die.py"
    fake.write_text(
        "import sys, time\n"
        "sys.stdin.readline()\n"
        "time.sleep(0.5)\n"
        "sys.exit(9)\n"
    )
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "mpistragglers_jl_tpu_torch.launch",
         "-n", "3", "--hosts", "localhost:2,deadhost",
         "--address", f"tcp://127.0.0.1:{port}",
         "--launcher", f"{sys.executable} {fake}", spmd_script],
        capture_output=True, text=True, timeout=120, env=env,
    )
    took = time.monotonic() - t0
    assert proc.returncode == 9, (proc.returncode, proc.stderr[-2000:])
    assert "remote span exited 9" in proc.stderr
    # prompt: well under the coordinator's connect timeout
    assert took < 30, took
