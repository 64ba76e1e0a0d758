"""Native (C++) host runtime, compiled on demand.

A copy of the JAX package's ``native/`` with its own sources: the
message transport under :class:`~..backends.native.NativeProcessBackend`
(``transport.cpp``), the LT peeling decoder (``lt_peel.cpp``), the
GF(256) Reed-Solomon codec (``rs_gf256.cpp``) and the race-detector
harness of the transport (``tsan_harness.cpp``). Host code only: no
kernel of the card lives here.

Libraries are compiled with ``g++ -O3 -shared -fPIC -std=c++17`` at
first use (never at import) into ``native/_build/`` (git-ignored),
under a name that carries a hash of the source, so an edited source is
never served from a stale library. Consumers fall back to a pure numpy
route when no compiler is available (``RSGF256``, ``LTCode``), so the
package never hard-fails on import; the transport has no fallback and
raises :class:`NativeBuildError`.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")
_LOCK = threading.Lock()

__all__ = ["NativeBuildError", "build", "lib_path", "load"]


class NativeBuildError(RuntimeError):
    pass


_loaded: dict[str, object] = {}
_load_lock = threading.Lock()


def load(name: str, configure=None):
    """Build + ``ctypes.CDLL``-load the library of ``<name>.cpp`` once
    per process.

    Success *and* failure are memoized: a broken toolchain is probed
    exactly once, not re-probed with a fresh (120 s-timeout) g++
    subprocess on every call from a hot path. ``configure(lib)``, if
    given, sets up argtypes/restypes on first load.
    """
    import ctypes

    with _load_lock:
        cached = _loaded.get(name)
        if cached is not None:
            if isinstance(cached, Exception):
                raise cached
            return cached
        try:
            lib = ctypes.CDLL(build(name))
            if configure is not None:
                configure(lib)
        except Exception as e:
            _loaded[name] = e
            raise
        _loaded[name] = lib
        return lib


def lib_path(name: str) -> str:
    """Where the library of ``<name>.cpp`` lives, by source hash."""
    with open(os.path.join(_DIR, f"{name}.cpp"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(name: str, *, force: bool = False) -> str:
    """Compile ``<name>.cpp`` unless its library exists; return the
    library path. Safe across threads and processes: each build writes
    a pid-suffixed temporary and renames it into place atomically, so
    many workers calling ``load("transport")`` at once never read half
    a library."""
    src = os.path.join(_DIR, f"{name}.cpp")
    out = lib_path(name)
    with _LOCK:
        if not force and os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [
            "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
            "-o", tmp, src,
        ]
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=120
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"g++ unavailable or hung: {e}") from e
        if proc.returncode != 0:
            raise NativeBuildError(
                f"g++ failed for {src}:\n{proc.stderr}"
            )
        os.replace(tmp, out)
    return out
