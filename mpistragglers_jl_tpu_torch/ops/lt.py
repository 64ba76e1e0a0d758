"""LT (Luby transform) rateless codes over the reals, with peeling decode.

A copy of the JAX package's ``ops/lt.py``, with its native C++ peel
(the port's build of ``native/lt_peel.cpp``) for host arrays; its
peeling decode also takes torch tensors, which it peels where they lie
with the numpy peel's subtractions in the same order (so a peel on the
card gives the numpy peel's bits).

BASELINE config 4: LT-coded GEMM on 16 workers with a *variable*
``nwait(epoch, repochs)`` predicate — return not after a fixed count but
as soon as the arrived shard set is actually decodable. This exercises
the reference's functional-``nwait`` mechanism
(src/MPIAsyncPools.jl:152-154) with a real decoder in the loop, which is
exactly what it exists for: the predicate sees the live ``repochs``
vector after every arrival.

Rateless-ness: shard ids are unbounded — shard ``s`` is a deterministic
pseudo-random sum of a few source blocks (degree drawn from the robust
soliton distribution, then that many blocks chosen uniformly), so any
number of workers can each take a distinct shard id and more shards only
help. Over the reals the XOR of classical LT becomes a sum, and peeling
subtracts instead of XORs; releases are numerically benign (coefficients
are 0/1, no amplification beyond degree-many subtractions).
"""

from __future__ import annotations

import ctypes
import warnings

import numpy as np
import torch

__all__ = ["LTCode", "nwait_lt_decodable"]


def _configure(lib):
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for name, fltp in (
        ("lt_peel_f32", ctypes.POINTER(ctypes.c_float)),
        ("lt_peel_f64", ctypes.POINTER(ctypes.c_double)),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_long,
            i32p, i32p, fltp, fltp, u8p,
        ]
        fn.restype = ctypes.c_long


def _load_native():
    """The C++ peeling decoder (native/lt_peel.cpp), compiled on first
    use; raises if no toolchain — callers fall back to NumPy. Success
    and failure are both memoized by :func:`..native.load`."""
    from .. import native

    return native.load("lt_peel", _configure)


def _is_torch(blocks) -> bool:
    return isinstance(blocks, torch.Tensor) or (
        isinstance(blocks, (list, tuple)) and len(blocks) > 0
        and isinstance(blocks[0], torch.Tensor))


def _copy(x):
    """A private copy of a block (numpy array or torch tensor)."""
    return x.clone() if isinstance(x, torch.Tensor) else np.array(x, copy=True)


def _stack(blocks):
    """Stack blocks of one kind: torch tensors stay torch, where they lie."""
    if _is_torch(blocks):
        return torch.stack(list(blocks))
    return np.stack([np.asarray(b) for b in blocks])


def sum_support(blocks, support):
    """The real-field sum of ``blocks[j]`` over a 0/1 code's support, in
    support order (a host array or a device stack alike; no index
    tensor crosses to the device)."""
    acc = _copy(blocks[int(support[0])])
    for j in support[1:]:
        acc += blocks[int(j)]
    return acc


def patch_distribution(k: int) -> np.ndarray:
    """Degree distribution for the coded tail of a SYSTEMATIC LT code:
    uniform over degrees ceil(k/4)+1 .. ceil(k/2).

    Classic LT needs the soliton shape because peeling must
    bootstrap itself from degree-1 shards; a systematic stream's
    identity prefix already resolves every delivered block, so coded
    shards exist to PATCH the few missing ones — the optimal patch has
    moderate degree (cover a missing block with high probability
    without binding several missing blocks together and stalling the
    peel). Measured over the straggler ensembles in docs/PERF.md:
    beats the robust-soliton tail at every k/straggler count tried
    (e.g. k=16, 2 stragglers: 1.13x vs 1.29x shards consumed) and
    degrades gracefully when half the workers are lost."""
    import math

    if k == 1:  # degree-1 is the only degree; an empty [lo, hi) slice
        return np.ones(1)  # here would yield 0/0 = NaN probabilities
    lo = min(math.ceil(k / 4) + 1, k)
    hi = max(math.ceil(k / 2), lo)
    mu = np.zeros(k)
    mu[lo - 1 : hi] = 1.0
    return mu / mu.sum()


def robust_soliton(k: int, c: float = 0.1, delta: float = 0.5) -> np.ndarray:
    """Robust soliton degree distribution over degrees 1..k."""
    d = np.arange(1, k + 1)
    rho = np.zeros(k)
    rho[0] = 1.0 / k
    rho[1:] = 1.0 / (d[1:] * (d[1:] - 1.0))
    R = c * np.log(k / delta) * np.sqrt(k)
    tau = np.zeros(k)
    kR = int(np.floor(k / R)) if R > 0 else k
    kR = max(1, min(kR, k))
    for i in range(1, kR):
        tau[i - 1] = R / (i * k)
    tau[kR - 1] = R * np.log(R / delta) / k if R > delta else 0.0
    mu = rho + tau
    return mu / mu.sum()


class LTCode:
    """Rateless LT code over k source blocks.

    ``shard_indices(s)`` is the deterministic support of shard ``s``;
    workers compute real-field sums of those source blocks.

    ``systematic=True`` makes shards ``0..k-1`` the source blocks
    themselves (degree-1, support ``{s}``) and draws soliton supports
    only from shard ``k`` on. In the common deployment — the first
    window of shard ids is ``0..n-1`` with ``n >= k`` — a straggler-free
    epoch then peels trivially from the k systematic arrivals, and with
    a straggler only the *missing* block must be covered by a coded
    shard whose other neighbors are already resolved, dropping expected
    shards-consumed from ~1.6k toward ~1.25k at k=8 (VERDICT r2 item 4;
    standard systematic-fountain construction, cf. Raptor/RFC 5053's
    systematic design goal — implemented here as plain LT with an
    identity prefix, not a copy of any implementation)."""

    def __init__(self, k: int, *, seed: int = 0, c: float = 0.1,
                 delta: float = 0.5, systematic: bool = False):
        self.k = int(k)
        self.seed = int(seed)
        self.systematic = bool(systematic)
        # systematic streams draw their coded tail from the patch
        # distribution (see patch_distribution); classic streams keep
        # the robust soliton peeling needs to bootstrap
        self._mu = (
            patch_distribution(self.k) if self.systematic
            else robust_soliton(self.k, c, delta)
        )

    def shard_indices(self, s: int) -> np.ndarray:
        """Deterministic support (sorted source-block ids) of shard s."""
        if self.systematic and s < self.k:
            return np.asarray([int(s)])
        rng = np.random.default_rng((self.seed, int(s)))
        d = 1 + rng.choice(self.k, p=self._mu)
        return np.sort(rng.choice(self.k, size=d, replace=False))

    def generator_rows(self, shard_ids) -> np.ndarray:
        """0/1 generator rows (len(shard_ids) × k) for the given shards."""
        G = np.zeros((len(shard_ids), self.k), dtype=np.float32)
        for r, s in enumerate(shard_ids):
            G[r, self.shard_indices(s)] = 1.0
        return G

    # -- decodability (pure graph logic, no data) ------------------------
    def peelable(self, shard_ids) -> bool:
        """True iff peeling decodes all k source blocks from these shards."""
        supports = [set(self.shard_indices(s).tolist()) for s in shard_ids]
        resolved: set[int] = set()
        progress = True
        while progress and len(resolved) < self.k:
            progress = False
            for sup in supports:
                live = sup - resolved
                if len(live) == 1:
                    resolved.add(next(iter(live)))
                    progress = True
        return len(resolved) == self.k

    # -- decode ----------------------------------------------------------
    def decode(self, shards, shard_ids, *, prefer_native: bool = True):
        """Peel: recover the k source blocks from arrived shards.

        ``shards``: (m, rows, cols) arrived coded sums, ``shard_ids``:
        their shard ids. Raises ``ValueError`` if peeling stalls (use
        :meth:`peelable` / the nwait predicate to avoid). Host arrays
        peel in the native C++ decoder (native/lt_peel.cpp) when a
        toolchain is available — one in-place pass per release, no
        per-release Python/alloc overhead — falling back to the NumPy
        loop otherwise. Release order may differ between the two
        (worklist vs rescan), so results agree to float rounding, not
        bitwise. Torch tensors take the NumPy loop's order where they
        lie, on the card or the host, and a tensor comes back.
        """
        if prefer_native and not _is_torch(shards):
            try:
                lib = _load_native()
            except Exception as e:  # no compiler / bad toolchain
                warnings.warn(
                    f"native lt_peel unavailable ({e}); using numpy "
                    "fallback",
                    RuntimeWarning,
                    stacklevel=2,
                )
            else:
                return self._decode_native(lib, shards, shard_ids)
        shards = [_copy(s) for s in (
            shards if _is_torch(shards) else np.asarray(shards))]
        supports = [set(self.shard_indices(s).tolist()) for s in shard_ids]
        out = [None] * self.k
        nresolved = 0
        progress = True
        while progress and nresolved < self.k:
            progress = False
            for sh, sup in zip(shards, supports):
                if len(sup) != 1:
                    continue
                j = next(iter(sup))
                if out[j] is None:
                    out[j] = _copy(sh)
                    nresolved += 1
                sup.clear()
                progress = True
                # release: subtract the resolved block everywhere
                for sh2, sup2 in zip(shards, supports):
                    if j in sup2:
                        sh2 -= out[j]
                        sup2.discard(j)
        if nresolved < self.k:
            raise ValueError(
                f"peeling stalled at {nresolved}/{self.k} blocks; "
                "shard set not decodable"
            )
        return _stack(out)

    def _decode_native(self, lib, shards, shard_ids) -> np.ndarray:
        shards = np.asarray(shards)
        m = shards.shape[0]
        block_shape = shards.shape[1:]
        orig_dtype = shards.dtype
        if orig_dtype == np.float32:
            fn, cty, dtype = lib.lt_peel_f32, ctypes.c_float, np.float32
        elif orig_dtype == np.float64:
            fn, cty, dtype = lib.lt_peel_f64, ctypes.c_double, np.float64
        else:  # ints etc.: exactness in f64 up to 2^53, then cast back
            fn, cty, dtype = lib.lt_peel_f64, ctypes.c_double, np.float64
        # exactly one owned working copy, peeled in place (astype with
        # copy=True covers the dtype == orig_dtype case too)
        shards = np.ascontiguousarray(
            shards.reshape(m, -1).astype(dtype, copy=True)
        )
        supports = [self.shard_indices(s) for s in shard_ids]
        off = np.zeros(m + 1, dtype=np.int32)
        off[1:] = np.cumsum([len(s) for s in supports])
        sup = np.concatenate(supports).astype(np.int32)
        out = np.zeros((self.k, shards.shape[1]), dtype=dtype)
        resolved = np.zeros(self.k, dtype=np.uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        fltp = ctypes.POINTER(cty)
        n = fn(
            m, self.k, shards.shape[1],
            sup.ctypes.data_as(i32p), off.ctypes.data_as(i32p),
            shards.ctypes.data_as(fltp), out.ctypes.data_as(fltp),
            resolved.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)
            ),
        )
        if n < self.k:
            raise ValueError(
                f"peeling stalled at {n}/{self.k} blocks; "
                "shard set not decodable"
            )
        if dtype != orig_dtype:
            out = out.astype(orig_dtype)
        return out.reshape(self.k, *block_shape)

    def decode_array(self, shards, shard_ids) -> np.ndarray:
        blocks = self.decode(shards, shard_ids)
        return blocks.reshape(-1, *blocks.shape[2:])


def nwait_lt_decodable(code: LTCode, shard_of_worker):
    """Predicate factory: True once the fresh workers' shards peel.

    ``shard_of_worker[i]`` maps pool worker i to its shard id. The
    predicate runs after every arrival (reference
    src/MPIAsyncPools.jl:152-154), so the pool returns at the *first*
    decodable arrival set — the variable-nwait behavior of BASELINE
    config 4.
    """
    shard_of_worker = np.asarray(shard_of_worker)

    def pred(epoch: int, repochs: np.ndarray) -> bool:
        fresh = np.flatnonzero(repochs == epoch)
        if fresh.size == 0:
            return False
        return code.peelable(shard_of_worker[fresh].tolist())

    return pred
