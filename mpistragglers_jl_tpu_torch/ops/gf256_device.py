"""Device-resident GF(2^8) Reed-Solomon: byte-exact coding on the card.

The port of the JAX package's ``ops/gf256_device.py``.
:class:`~..utils.rs_gf256.RSGF256` runs on the host; this is the same
code — identical Cauchy generator, byte-identical shards — executed
where the bytes lie, so payloads already on the card (packed
checkpoints, quantized weights, serialized buffers) encode and decode
without a host round trip. On CPU tensors the same torch code runs on
the CPU.

GF(256) has no tensor-core path, so the product over the field is built
from integer ops: ``C[i, l] = XOR_j M[i, j] * D[j, l]``, one XOR
accumulation per contraction step j, over column chunks of ``D`` so the
temporaries stay bounded. Two ways to form the field products:

* ``"bitslice"``: shift-and-add over the bits of the data byte, the
  coefficient doubled (``xtime``: shift, then reduce by the primitive
  polynomial 0x11D) between bits; uint8 shifts, masks and XORs only;
* ``"gather"``: lookups in the 64 KiB product table
  (``index_select`` of the coefficient's row by the data bytes).

Decode inverts the k×k generator submatrix on the host (tiny, exact GF
arithmetic, as the reference does) and applies it the same way; which
k rows is driven by the pool's ``repochs`` arrival mask like every other
decoder here (SURVEY §2.1).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..utils.rs_gf256 import _MUL, RSGF256, _np_invert

__all__ = ["DeviceRSGF256", "gf256_matmul"]

METHODS = ("bitslice", "gather")
# columns of D per pass: bounds the (rows, chunk) uint8 temporaries
_CHUNK = 1 << 24

_PRIM_LOW = 0x1D  # x^8 = x^4 + x^3 + x^2 + 1 (mod 0x11D)


def _gf_mul_bitslice(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise GF(256) product of uint8 tensors (broadcast): for each
    bit t of ``b``, XOR in ``a * x^t``, where ``a * x^(t+1)`` is
    ``a * x^t`` shifted left once and, when its top bit fell off,
    reduced by 0x1D. Exact: every partial product is already reduced.
    Cheapest with ``a`` the small operand (the coefficients): its
    doublings then cost next to nothing."""
    a = a.to(torch.uint8)
    b = b.to(torch.uint8)
    prod = torch.zeros(torch.broadcast_shapes(a.shape, b.shape),
                       dtype=torch.uint8, device=b.device)
    for t in range(8):
        prod ^= a & (((b >> t) & 1) * 255)
        a = (a << 1) ^ (((a >> 7) & 1) * _PRIM_LOW)
    return prod


_MUL_ON: dict = {}  # device -> the product table there (64 KiB each)


def _mul_table(device) -> torch.Tensor:
    table = _MUL_ON.get(device)
    if table is None:
        table = _MUL_ON[device] = torch.from_numpy(_MUL).to(device)
    return table


def _as_u8(x, device=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(x, dtype=np.uint8))
    if t.dtype != torch.uint8:
        raise ValueError(f"expected a uint8 array, got {t.dtype}")
    return t if device is None else t.to(device)


def gf256_matmul(M, D, *, method: str = "bitslice",
                 device=None) -> torch.Tensor:
    """GF(256) matrix product of uint8 arrays ``(r, k) x (k, L)``.

    It runs on ``device`` when one is named; else a tensor ``D`` stays
    where it lies, and a numpy ``D`` goes to the card (as the reference's
    ``jnp.asarray`` puts it on the accelerator): pass ``device="cpu"`` to
    run numpy inputs on the CPU. ``method`` is ``"bitslice"`` (integer
    shifts, masks and XORs) or ``"gather"`` (product-table lookups); both
    give the same bytes."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if device is not None or not isinstance(D, torch.Tensor):
        device = resolve_device(device)
    D = _as_u8(D, device)
    M = _as_u8(M, D.device)
    r, k = M.shape
    if D.ndim != 2 or D.shape[0] != k:
        raise ValueError(f"shapes {tuple(M.shape)} x {tuple(D.shape)} "
                         "do not contract")
    L = D.shape[1]
    out = torch.zeros((r, L), dtype=torch.uint8, device=D.device)
    if method == "gather":
        # each coefficient's row of the table, looked up by the bytes
        rows = _mul_table(D.device).index_select(0, M.reshape(-1).int())
        rows = rows.reshape(r, k, 256)
    for c0 in range(0, L, _CHUNK):
        acc = out[:, c0:c0 + _CHUNK]
        for j in range(k):
            Dj = D[j, c0:c0 + _CHUNK]
            if method == "bitslice":
                acc ^= _gf_mul_bitslice(M[:, j:j + 1], Dj[None, :])
            else:
                idx = Dj.int()
                for i in range(r):
                    acc[i] ^= rows[i, j].index_select(0, idx)
    return out


class DeviceRSGF256:
    """Systematic (n, k) Cauchy-RS over bytes, encode/decode on a device.

    Byte-identical to :class:`~..utils.rs_gf256.RSGF256` (the generator
    is shared), so shards may be produced on the card and decoded on the
    host or vice versa.

    >>> rs = DeviceRSGF256(n=8, k=6)                 # on the card
    >>> coded = rs.encode(data)          # (6, L) uint8 -> (8, L)
    >>> back = rs.decode(coded[idx], idx)    # any 6 distinct rows
    """

    def __init__(self, n: int, k: int, *, method: str = "bitslice",
                 device=None):
        self.n, self.k = int(n), int(k)
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}")
        self.method = method
        self.device = resolve_device(device)
        self._host = RSGF256(n, k)
        self.G = self._host.G  # (n, k) uint8, systematic
        self._G_dev = torch.from_numpy(self.G).to(self.device)
        self._inv_cache: dict[tuple, torch.Tensor] = {}

    def _check(self, x, what: str) -> torch.Tensor:
        x = _as_u8(x, self.device)
        if x.ndim != 2 or x.shape[0] != self.k:
            raise ValueError(
                f"expected ({self.k}, L) uint8 array, got {tuple(x.shape)}"
                f" ({what})"
            )
        return x

    def encode(self, data) -> torch.Tensor:
        """(k, L) uint8 source -> (n, L) coded shards (first k = source)."""
        return gf256_matmul(self._G_dev, self._check(data, "source"),
                            method=self.method)

    def _inverse(self, indices) -> torch.Tensor:
        idx = tuple(int(i) for i in indices)
        if len(idx) != self.k or len(set(idx)) != self.k:
            raise ValueError(
                f"need exactly k={self.k} distinct indices, got {idx}"
            )
        if min(idx) < 0 or max(idx) >= self.n:
            raise ValueError(f"indices out of range [0, {self.n}): {idx}")
        inv = self._inv_cache.get(idx)
        if inv is None:
            # tiny k x k GF inversion, exact, host-side. Bounded: churning
            # arrival patterns would otherwise grow toward C(n, k) entries
            if len(self._inv_cache) >= 4096:
                self._inv_cache.clear()
            inv = torch.from_numpy(_np_invert(self.G[list(idx)])).to(
                self.device)
            self._inv_cache[idx] = inv
        return inv

    def decode(self, shards, indices) -> torch.Tensor:
        """Any k distinct coded rows -> the (k, L) source bytes, exactly."""
        shards = self._check(shards, "shards")
        return gf256_matmul(self._inverse(indices), shards,
                            method=self.method)
