"""ThreadSanitizer run of the native transport (SURVEY §5 'race
detection / sanitizers' — the reference has none; an earlier version shipped a
state-machine fuzzer, this adds the real thing).

The transport's epoll progress thread races caller threads on peer
state, send queues, completion deques, and payload handles by design;
one such race was a review finding. This test compiles
transport.cpp together with a C++ harness under ``-fsanitize=thread``
and drives the hot paths (auth handshake, 200 mixed-payload epochs with
a concurrent prober thread, mid-run death + reaccept, shm fd passing,
shutdown — plus the ring phase: the persistent result-ring
protocol with worker->coordinator SCM_RIGHTS announces, concurrent
producer/consumer access to one shared mapping, ack-frame slot
reclamation, and a deliberately pinned slot the producer must wrap
around). TSAN runs with ``halt_on_error=1``: any detected race exits
non-zero and fails the test with the report attached.

TSAN must own the whole process, so this is a standalone binary, not a
.so in the pytest interpreter.
"""

import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE = os.path.join(_REPO, "mpistragglers_jl_tpu_torch", "native")


# The probe exercises the sync primitives the transport actually uses:
# threads, a shared mutex, and a TIMED condition-variable wait
# (msgt_coord_waitany's timeout path). A trivial `int main` is not
# enough — some glibc/libtsan combinations run it cleanly yet emit a
# bogus "double lock of a mutex" on any pthread_cond_timedwait (seen
# on one Linux box with an unchanged tree, at a nondeterministic
# report site), which would fail the harness without any real finding.
_PROBE_SRC = """
#include <condition_variable>
#include <chrono>
#include <mutex>
#include <thread>
std::mutex mu;
std::condition_variable cv;
bool flag = false;
int counter = 0;
int main() {
  std::thread w([] {
    for (int i = 0; i < 100; i++) {
      std::unique_lock<std::mutex> lk(mu);
      cv.wait_until(lk,
          std::chrono::steady_clock::now() + std::chrono::milliseconds(1),
          [] { return flag; });
      counter++;
    }
  });
  for (int i = 0; i < 100; i++) {
    { std::lock_guard<std::mutex> lk(mu); counter++; }
    cv.notify_all();
  }
  w.join();
  return counter == 200 ? 0 : 1;
}
"""


def _sanitizer_usable(flag: str, env_opts=None) -> bool:
    import shutil
    import tempfile

    gxx = shutil.which("g++")
    if gxx is None:
        return False
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "t.cpp")
        with open(src, "w") as f:
            f.write(_PROBE_SRC)
        probe = os.path.join(d, "t")
        r = subprocess.run(
            [gxx, "-std=c++17", flag, src, "-o", probe, "-lpthread"],
            capture_output=True,
        )
        if r.returncode != 0:
            return False
        # the runtime itself can be unusable (high-entropy ASLR kernels
        # vs older libtsan abort at startup; timed-condvar interceptor
        # mismatches report phantom mutex bugs): require a clean RUN of
        # the real primitive mix under the same halt-on-error options
        env = dict(os.environ)
        env.update(env_opts or {})
        r = subprocess.run(
            [probe], capture_output=True, timeout=60, env=env
        )
        return r.returncode == 0


@pytest.mark.slow
@pytest.mark.parametrize(
    "flag,env_opts",
    [
        ("-fsanitize=thread", {"TSAN_OPTIONS": "halt_on_error=1 exitcode=66"}),
        # ASAN implies LeakSanitizer: frame/payload buffers, payload
        # handles, shm regions, and peer state must all be released by
        # destroy/close — a leak or heap error fails the run
        ("-fsanitize=address", {"ASAN_OPTIONS": "halt_on_error=1 exitcode=66 detect_leaks=1"}),
        # ASan+UBSan combined: the frame codec does the pointer-cast /
        # length-arithmetic work (size headers, offset math into
        # payload buffers, enum kinds off the wire) where undefined
        # behavior hides without corrupting memory — shift overflows,
        # misaligned loads, out-of-range enums. One combined binary
        # (the probe compiles the joint flag, skipping cleanly where
        # either runtime is absent); UBSan halts like ASan so a UB
        # report is a test failure, not a stderr footnote.
        (
            "-fsanitize=address,undefined",
            {
                "ASAN_OPTIONS": "halt_on_error=1 exitcode=66 detect_leaks=1",
                "UBSAN_OPTIONS": "halt_on_error=1 exitcode=66 print_stacktrace=1",
            },
        ),
    ],
    ids=["tsan", "asan+lsan", "asan+ubsan"],
)
def test_transport_under_sanitizer(tmp_path, flag, env_opts):
    if not _sanitizer_usable(flag, env_opts):
        pytest.skip(f"g++ {flag} not usable on this host")
    binary = str(tmp_path / "san_harness")
    build = subprocess.run(
        [
            "g++", "-std=c++17", "-O1", "-g", flag,
            os.path.join(_NATIVE, "tsan_harness.cpp"),
            os.path.join(_NATIVE, "transport.cpp"),
            "-o", binary, "-lpthread",
        ],
        capture_output=True, text=True, timeout=300,
    )
    assert build.returncode == 0, build.stderr[-3000:]
    env = dict(os.environ)
    env.update(env_opts)
    run = subprocess.run(
        [binary], capture_output=True, text=True, timeout=600, env=env,
    )
    sys.stderr.write(run.stderr[-4000:])
    assert run.returncode == 0, (
        f"{flag}-instrumented transport run failed "
        f"(rc={run.returncode}):\n{run.stderr[-4000:]}"
    )
    assert "reaccept ok" in run.stdout
    # ring phase: fd-passing announce, concurrent
    # producer/consumer on shared pages, ack-driven slot reclaim with
    # a deliberately pinned slot — must have completed, not bailed
    assert "ring ok" in run.stdout
