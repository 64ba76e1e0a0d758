"""The flagship decoder-only transformer: configuration, parameters and
the per-token blocks the serving path runs.

Counterpart of ``mpistragglers_jl_tpu/models/transformer.py``. Slice 1
ports what serving reads: the config, ``init_params`` (the same numpy
draws in the same order, so both packages hold identical weights from
one seed), the JAX-to-torch parameter carry-over, and the LayerNorm,
RoPE and MLP blocks. The parameter layout is the reference's nested
dict: projections ``(d_model, heads, head_dim)``, out-projection
``(heads, head_dim, d_model)``, tied embedding ``(vocab, d_model)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device

__all__ = ["TransformerConfig", "init_params", "params_from_jax"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The fields the serving path reads. ``attn`` and ``attn_impl``
    are kept for parity with the reference config but are inert in
    this slice: the only per-device attention is ``"reference"``
    (``parallel/ring_attention.py``). ``dtype`` is a torch dtype."""

    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    # grouped-query attention: q head h reads kv head h // (n_heads //
    # n_kv_heads); None = n_heads (MHA)
    n_kv_heads: int | None = None
    n_layers: int = 2
    d_ff: int = 256
    attn: str = "ring"
    attn_impl: str = "reference"
    # sliding window (each position attends the previous attn_window
    # positions); the serving ring cache is this window
    attn_window: int | None = None
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.d_model % self.n_heads != 0:
            raise ValueError(
                f"d_model {self.d_model} not divisible by n_heads "
                f"{self.n_heads}"
            )
        if (self.d_model // self.n_heads) % 2 != 0:
            raise ValueError(
                f"RoPE requires even head_dim, got "
                f"{self.d_model // self.n_heads}"
            )
        if self.attn_window is not None and self.attn_window < 1:
            raise ValueError(
                f"attn_window must be >= 1, got {self.attn_window}"
            )
        if self.n_kv_heads is not None and (
            self.n_kv_heads < 1 or self.n_heads % self.n_kv_heads != 0
        ):
            raise ValueError(
                f"n_kv_heads {self.n_kv_heads} must divide n_heads "
                f"{self.n_heads}"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_heads if self.n_kv_heads is None else self.n_kv_heads


def init_params(cfg: TransformerConfig, seed: int = 0,
                device=None) -> dict:
    """Random parameters from ``np.random.default_rng(seed)``, drawn
    in the reference's order (per layer wq, wk, wv, wo, w1, w2; then
    the embedding) and rounded to ``cfg.dtype`` the same way, so the
    port and the JAX package hold identical weights from one seed.
    ``device`` defaults to ``cuda``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    D, H, Dh, Fd = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    Hkv = cfg.kv_heads
    dt = cfg.dtype

    def sd(*s):
        return torch.as_tensor(
            rng.standard_normal(s) / np.sqrt(s[0]), dtype=dt
        )

    def const(fill, n):
        return torch.full((n,), fill, dtype=dt)

    # JAX rounds a Python scalar to the array's dtype before dividing
    depth = torch.tensor(float(np.sqrt(cfg.n_layers)), dtype=dt)

    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "ln1_s": const(1.0, D),
            "ln1_b": const(0.0, D),
            "wq": sd(D, H, Dh),
            "wk": sd(D, Hkv, Dh),
            "wv": sd(D, Hkv, Dh),
            "wo": sd(H, Dh, D) / depth,
            "ln2_s": const(1.0, D),
            "ln2_b": const(0.0, D),
            "w1": sd(D, Fd),
            "b1": const(0.0, Fd),
            "w2": sd(Fd, D) / depth,
            "b2": const(0.0, D),
        }
        layers.append(layer)
    params = {
        "emb": torch.as_tensor(
            rng.standard_normal((cfg.vocab, D)) * 0.02, dtype=dt
        ),
        "layers": layers,
        "lnf_s": const(1.0, D),
        "lnf_b": const(0.0, D),
    }
    return _to(params, dev)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def params_from_jax(np_params, device, dtype=None) -> dict:
    """Carry a reference parameter pytree over: ``np_params`` is the
    JAX package's ``init_params`` dict with every leaf converted to
    numpy (``jax.tree.map(np.asarray, params)``). Leaves whose numpy
    dtype torch does not know (bfloat16 from ``ml_dtypes``) pass
    through float32, which holds them exactly. ``dtype`` recasts every
    leaf; None keeps the leaf's own type."""
    dev = torch.device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
            t = torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.as_tensor(np.array(a))
        if dtype is not None:
            t = t.to(dtype)
        return t.to(dev)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v) for v in tree]
        return leaf(tree)

    return walk(np_params)


def _ln(x, s, b, eps=1e-5):
    """LayerNorm in float32 (population variance), cast back to the
    parameter dtype before the affine, as the reference does."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return ((x - mu) * torch.rsqrt(var + eps)).to(s.dtype) * s + b


def _rope_freqs(half: int, device) -> torch.Tensor:
    return 1.0 / (
        10000.0 ** (torch.arange(half, dtype=torch.float32, device=device)
                    / half)
    )


def _rope(x, pos):
    """Rotary embedding; ``pos`` carries GLOBAL token positions (L,)."""
    Dh = x.shape[-1]
    half = Dh // 2
    ang = pos.float()[:, None] * _rope_freqs(half, x.device)[None, :]
    cos = torch.cos(ang)[None, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _mlp(x, lp):
    # jax.nn.gelu defaults to the tanh approximation
    a = F.gelu(torch.einsum("bld,df->blf", x, lp["w1"]) + lp["b1"],
               approximate="tanh")
    return torch.einsum("blf,fd->bld", a, lp["w2"])
