"""Build and load the port's CUDA kernels.

Each source ``ops/csrc/<name>.cu`` compiles with ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries land in
``ops/csrc/_build/`` (git-ignored) under a name that carries a hash of
the source, so an edited kernel is never served from a stale library.
Nothing builds at import: the first :func:`load` builds what it needs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
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


def _build(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, compiled unless it exists."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    build_logs[name] = proc.stdout
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if
    needed."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_build(name)))
        return _loaded[name]
