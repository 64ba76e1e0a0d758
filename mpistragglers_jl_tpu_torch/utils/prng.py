"""Counter-based random numbers in torch integer ops, bit-equal to
``jax.random``'s default generator (Threefry-2x32, partitionable).

The reference samples tokens with ``jax.random``
(``mpistragglers_jl_tpu/models/decode.py`` ``_pick_token``). Threefry
is pure 32-bit integer arithmetic, so the port draws the SAME numbers
from the same key: a sampled stream of the port equals the JAX
package's token for token. A key is a ``(..., 2)`` int64 tensor holding
two uint32 words (``jax.random.key_data``'s pair); every function takes
a batch of keys along the leading dims and runs on any device.

Each function keeps JAX's order of f32 operations:

* :func:`key` is ``threefry_seed``: ``[seed >> 32, seed & 0xFFFFFFFF]``
  of the seed as a 64-bit integer (JAX with x64 on; a seed in
  ``[0, 2**31)`` gives the same key either way);
* :func:`fold_in` hashes the counter pair ``(0, data)`` under the key;
* :func:`bits` hashes ``(0, j)`` for the flat index ``j`` and returns
  ``x0 ^ x1`` (the partitionable counters, ``jax_threefry_partitionable``
  on, JAX's default);
* :func:`uniform` sets the top 23 bits as a mantissa in [1, 2), takes
  1, scales and adds ``minval`` in one fused multiply-add, and clamps
  with ``max(minval, .)``;
* :func:`gumbel` is ``-log(-log(u))`` over ``uniform(tiny, 1)``, with
  XLA's own CPU logarithm (:func:`_log`), not libm's: the reference's
  draws are computed by it;
* :func:`categorical` is ``argmax(gumbel + logits)``, the first index
  among ties.

:func:`_log` is the Cephes polynomial XLA's CPU backend emits for
``log`` on f32, with its multiply-adds fused as the CPU's FMA unit
fuses them. A fused multiply-add is computed here in f64 and rounded
once to f32; the tests hold :func:`gumbel` bit-equal to
``jax.random.gumbel`` over every one of the 2**23 values ``uniform`` can
give. ``ops/csrc/sampling.cu`` computes the same polynomial with
``__fmaf_rn``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "bits",
    "categorical",
    "fold_in",
    "gumbel",
    "key",
    "key_data",
    "threefry2x32",
    "uniform",
    "wrap_key_data",
]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
TINY = float(np.finfo(np.float32).tiny)  # 2**-126, the least normal f32


def _f32(x: float) -> float:
    """``x`` rounded to f32, as XLA rounds a literal constant."""
    return float(np.float32(x))


# XLA's f32 log (Cephes): p0..p8, q1, q2 and sqrt(1/2), each an f32
_LOG_P = tuple(_f32(p) for p in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = _f32(-2.12194440e-4)
_LOG_Q2 = _f32(0.693359375)
_SQRTHF = _f32(0.707106781186547524)


def key(seed: int, device=None) -> torch.Tensor:
    """The key of an int64 seed: ``jax.random.key(seed)``'s data."""
    s = int(seed)
    if not -2 ** 63 <= s < 2 ** 63:
        raise ValueError(f"seed must be an int64, got {seed}")
    s &= 2 ** 64 - 1  # two's complement, as JAX's logical shift reads it
    return torch.tensor([s >> 32, s & _M32], dtype=torch.int64,
                        device=device)


def wrap_key_data(data, device=None) -> torch.Tensor:
    """A key (or a batch of keys, ``(..., 2)``) from uint32 key data,
    as ``jax.random.key_data`` gives it."""
    arr = np.asarray(data)
    if arr.shape[-1:] != (2,):
        raise ValueError(f"key data must end in a pair, got {arr.shape}")
    return torch.as_tensor(arr.astype(np.uint32).astype(np.int64),
                           device=device)


def key_data(k: torch.Tensor) -> np.ndarray:
    """The uint32 key data of a key, on the host."""
    return k.detach().cpu().numpy().astype(np.uint32)


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pair ``(x0, x1)`` under
    the key ``(k0, k1)``: int64 tensors (or ints) holding uint32 words,
    broadcast together. Returns the pair ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``k`` (``(..., 2)``) and
    ``data`` (an int or an integer tensor broadcasting against
    ``k[..., 0]``, taken mod 2**32 as JAX's uint32 cast takes it)."""
    d = torch.as_tensor(data, device=k.device).to(torch.int64) & _M32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def bits(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(k, shape, jnp.uint32)``: int64 holding uint32,
    shaped ``k.shape[:-1] + shape`` (one draw of ``shape`` per key)."""
    shape = tuple(int(n) for n in shape)
    n = int(np.prod(shape, dtype=np.int64))
    j = torch.arange(n, dtype=torch.int64, device=k.device).reshape(shape)
    lead = k.shape[:-1] + (1,) * len(shape)
    k0, k1 = k[..., 0].reshape(lead), k[..., 1].reshape(lead)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(j), j)
    return y0 ^ y1


def uniform(k: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, jnp.float32, minval, maxval)``."""
    b = bits(k, shape)
    one = (b >> 9) | 0x3F800000  # mantissa bits under the exponent of 1
    u = one.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = (torch.tensor(v, dtype=torch.float32, device=k.device)
              for v in (minval, maxval))
    return torch.maximum(_fma(u, hi - lo, lo), lo)


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32: the product of two f32 is
    exact in f64, and the tests hold the one rounding of the sum to
    the CPU's fused multiply-add over the inputs :func:`gumbel` gives."""
    a = a.double() if torch.is_tensor(a) else a
    b = b.double() if torch.is_tensor(b) else b
    return (a * b + c).float()


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU ``log`` on f32, for positive finite ``x``: the
    exponent and a mantissa in [sqrt(1/2), sqrt(2)) by bit
    operations, then the Cephes polynomial in the fused order."""
    x = torch.clamp_min(x, TINY)
    b = x.view(torch.int32)
    e = 1.0 + ((b >> 23) - 0x7F).to(torch.float32)
    m = ((b & ~0x7F800000) | 0x3F000000).view(torch.float32)
    low = m < _SQRTHF
    t = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.to(torch.float32)
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _LOG_Q1 * e)
    t = t - 0.5 * x2  # exact product: fused or not, one rounding
    t = t + y
    return t + _LOG_Q2 * e  # q2 * e is exact: 9 bits times an integer


def gumbel(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(k, shape, jnp.float32)`` (mode "low")."""
    return -_log(-_log(uniform(k, shape, TINY, 1.0)))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(k, logits)`` over the last axis for one
    key ``k`` (2,): the noise is drawn over ``logits.shape`` with flat
    counters, as JAX draws it. Returns int64 indices."""
    if k.shape != (2,):
        raise ValueError(f"one key of shape (2,), got {tuple(k.shape)}")
    g = gumbel(k, logits.shape)
    return torch.argmax(g + logits.float(), dim=-1)
