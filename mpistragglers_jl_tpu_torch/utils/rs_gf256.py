"""Byte-exact systematic Reed-Solomon erasure codec over GF(2^8).

A copy of the JAX package's ``utils/rs_gf256.py`` over the port's own
build of ``native/rs_gf256.cpp``: the same Cauchy generator and the same
tables, so shards coded by either package, on either route, decode bit
for bit in the other.

The complement to the float-field MDS code in ops/coding.py: that one
is exact only to float precision; this one is bit-exact for arbitrary
byte payloads — checkpoint shards, serialized host buffers, control
messages. The pool's ``repochs`` arrival mask selects which k of the n
coded shards feed the decoder, exactly as in the float path (SURVEY
§2.1: repochs is the per-shard freshness oracle).

Backed by the native C++ codec (native/rs_gf256.cpp, compiled on first
use via ctypes); a pure-NumPy table-lookup implementation is the
automatic fallback when no compiler is available, selected at
construction and exposed as ``RSGF256.impl``.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Sequence

import numpy as np

__all__ = ["RSGF256"]

_PRIM = 0x11D


def _tables():
    """(exp[512], log[256], mul[256,256]) for GF(256), poly 0x11D."""
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.uint8)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _PRIM
    exp[255:510] = exp[:255]
    ia, ib = np.meshgrid(
        np.arange(256, dtype=np.int32), np.arange(256, dtype=np.int32),
        indexing="ij",
    )
    mul = exp[(log[ia].astype(np.int32) + log[ib].astype(np.int32))]
    mul[0, :] = 0
    mul[:, 0] = 0
    return exp, log, mul


_EXP, _LOG, _MUL = _tables()


def _gf_inv(a: int) -> int:
    return int(_EXP[255 - int(_LOG[a])])


def _np_matmul(M: np.ndarray, data: np.ndarray) -> np.ndarray:
    """(rows, k) x (k, len) over GF(256), via the 64 KiB product table."""
    rows, k = M.shape
    out = np.zeros((rows, data.shape[1]), dtype=np.uint8)
    for i in range(rows):
        for j in range(k):
            c = int(M[i, j])
            if c:
                out[i] ^= _MUL[c][data[j]]
    return out


def _np_invert(A: np.ndarray) -> np.ndarray:
    k = A.shape[0]
    work = A.astype(np.uint8).copy()
    inv = np.eye(k, dtype=np.uint8)
    for col in range(k):
        piv = next((r for r in range(col, k) if work[r, col]), None)
        if piv is None:
            raise np.linalg.LinAlgError("singular over GF(256)")
        if piv != col:
            work[[col, piv]] = work[[piv, col]]
            inv[[col, piv]] = inv[[piv, col]]
        ip = _gf_inv(int(work[col, col]))
        work[col] = _MUL[ip][work[col]]
        inv[col] = _MUL[ip][inv[col]]
        for r in range(k):
            if r == col:
                continue
            c = int(work[r, col])
            if c:
                work[r] ^= _MUL[c][work[col]]
                inv[r] ^= _MUL[c][inv[col]]
    return inv


def _configure(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.rs_make_generator.argtypes = [ctypes.c_int, ctypes.c_int, u8p]
    lib.rs_make_generator.restype = ctypes.c_int
    lib.rs_encode.argtypes = [
        ctypes.c_int, ctypes.c_int, u8p, u8p, u8p, ctypes.c_long,
    ]
    lib.rs_encode.restype = ctypes.c_int
    lib.rs_decode.argtypes = [
        ctypes.c_int, ctypes.c_int, u8p, i32p, u8p, u8p, ctypes.c_long,
    ]
    lib.rs_decode.restype = ctypes.c_int


def _load_native():
    """Memoized (success and failure) via :func:`..native.load`."""
    from .. import native

    return native.load("rs_gf256", _configure)


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class RSGF256:
    """Systematic (n, k) Cauchy-RS codec over bytes.

    >>> rs = RSGF256(n=8, k=6)
    >>> coded = rs.encode(data)            # (6, L) uint8 -> (8, L)
    >>> back = rs.decode(coded[idx], idx)  # any 6 distinct rows -> (6, L)

    ``impl`` is ``"native"`` (C++ via ctypes) or ``"numpy"`` (fallback).
    The generator is identical for both, so shards encoded by one decode
    bit-exactly under the other.
    """

    def __init__(self, n: int, k: int, *, prefer_native: bool = True):
        if not 0 < k <= n or n > 256:
            raise ValueError(
                f"need 0 < k <= n <= 256, got n={n}, k={k}"
            )
        self.n, self.k = int(n), int(k)
        self._lib = None
        if prefer_native:
            try:
                self._lib = _load_native()
            except Exception as e:  # no compiler / bad toolchain
                warnings.warn(
                    f"native rs_gf256 unavailable ({e}); using numpy "
                    "fallback",
                    RuntimeWarning,
                    stacklevel=2,
                )
        self.G = self._make_generator()

    @property
    def impl(self) -> str:
        return "native" if self._lib is not None else "numpy"

    def _make_generator(self) -> np.ndarray:
        n, k = self.n, self.k
        if self._lib is not None:
            G = np.zeros((n, k), dtype=np.uint8)
            rc = self._lib.rs_make_generator(n, k, _u8p(G))
            if rc != 0:
                raise RuntimeError(f"rs_make_generator failed rc={rc}")
            return G
        G = np.zeros((n, k), dtype=np.uint8)
        G[:k] = np.eye(k, dtype=np.uint8)
        for i in range(n - k):
            for j in range(k):
                G[k + i, j] = _gf_inv((k + i) ^ j)
        return G

    def _check_data(self, data, rows: int) -> np.ndarray:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.ndim != 2 or data.shape[0] != rows:
            raise ValueError(
                f"expected ({rows}, L) uint8 array, got {data.shape}"
            )
        return data

    def encode(self, data) -> np.ndarray:
        """(k, L) source bytes -> (n, L) coded shards (first k = source)."""
        data = self._check_data(data, self.k)
        L = data.shape[1]
        if self._lib is not None:
            coded = np.empty((self.n, L), dtype=np.uint8)  # rs_encode memsets
            rc = self._lib.rs_encode(
                self.n, self.k, _u8p(self.G), _u8p(data), _u8p(coded), L
            )
            if rc != 0:
                raise RuntimeError(f"rs_encode failed rc={rc}")
            return coded
        return _np_matmul(self.G, data)

    def decode(self, shards, indices: Sequence[int]) -> np.ndarray:
        """Any k distinct coded rows -> the (k, L) source bytes, exactly."""
        idx = np.asarray(indices, dtype=np.int32)
        if idx.shape[0] != self.k or len(set(idx.tolist())) != self.k:
            raise ValueError(
                f"need exactly k={self.k} distinct indices, got {idx}"
            )
        if idx.min() < 0 or idx.max() >= self.n:
            raise ValueError(f"indices out of range [0, {self.n}): {idx}")
        shards = self._check_data(shards, self.k)
        L = shards.shape[1]
        if self._lib is not None:
            out = np.zeros((self.k, L), dtype=np.uint8)
            rc = self._lib.rs_decode(
                self.n, self.k, _u8p(self.G),
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                _u8p(shards), _u8p(out), L,
            )
            if rc != 0:
                raise RuntimeError(f"rs_decode failed rc={rc}")
            return out
        inv = _np_invert(self.G[idx])
        return _np_matmul(inv, shards)

    def encode_bytes(self, payload: bytes) -> tuple[np.ndarray, int]:
        """Pad+split a byte string into k source rows and encode.
        Returns (coded (n, L), original length) for :meth:`decode_bytes`."""
        raw = np.frombuffer(payload, dtype=np.uint8)
        L = -(-max(raw.size, 1) // self.k)
        data = np.zeros((self.k, L), dtype=np.uint8)
        data.reshape(-1)[: raw.size] = raw
        return self.encode(data), raw.size

    def decode_bytes(self, shards, indices, length: int) -> bytes:
        """Inverse of :meth:`encode_bytes`."""
        return self.decode(shards, indices).reshape(-1)[:length].tobytes()
