"""Build and load the port's CUDA kernels.

Each source ``ops/csrc/<name>.cu`` compiles with ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries land in
``ops/csrc/_build/`` (git-ignored) under a name that carries a hash of
the source, so an edited kernel is never served from a stale library.
Nothing builds at import: the first :func:`load` builds what it needs;
:func:`build` starts one ``nvcc`` per missing source, all at once, and
waits for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.RLock()
_loaded: dict[str, ctypes.CDLL] = {}
# name -> compiler output of the build this process ran (ptxas -v)
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
        "build only where the CUDA toolkit is installed"
    )


def _lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives, by source hash."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(*names: str) -> None:
    """Compile every named source whose library does not exist yet: one
    ``nvcc`` each, all started together, then wait for them all."""
    with _lock:
        procs = {}
        for name in names:
            out = _lib_path(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            build_logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu:\n"
                              f"{build_logs[name]}")
            else:
                os.replace(tmp, out)  # atomic: readers never see half
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if
    needed."""
    with _lock:
        if name not in _loaded:
            build(name)
            _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
        return _loaded[name]
