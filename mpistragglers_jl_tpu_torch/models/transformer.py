"""The flagship decoder-only transformer: configuration, parameters,
the dense forward and the single-device train steps.

Counterpart of ``mpistragglers_jl_tpu/models/transformer.py``. Slice 1
ported what serving reads: the config, ``init_params`` (the same numpy
draws in the same order, so both packages hold identical weights from
one seed), the JAX-to-torch parameter carry-over, and the LayerNorm,
RoPE and MLP blocks. Slice 3 adds training on one device:
``forward_dense``, ``nll_loss`` and the SGD and optimizer train steps.
The parameter layout is the reference's nested dict: projections
``(d_model, heads, head_dim)``, out-projection ``(heads, head_dim,
d_model)``, tied embedding ``(vocab, d_model)``.

The reference trains through one ``shard_map`` program over a
``("dp", "sp", "tp")`` mesh; on one device (sp = tp = 1) that program is
``forward_dense`` with the configured per-device attention, which is
what the port runs. Sharded training is ``ROADMAP.md`` Queue 1 item 18,
the mixture of experts item 15.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..parallel.ring_attention import resolve_attention_impl

__all__ = [
    "TransformerConfig",
    "adamw",
    "forward_dense",
    "init_params",
    "loss_and_grads",
    "make_optax_train_step",
    "make_train_step",
    "nll_loss",
    "params_from_jax",
]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's config, dense FFN only. ``attn`` names the
    sharded attention of the reference's mesh program (inert on one
    device, where ``forward_dense`` runs ``attn_impl``: ``"reference"``
    or ``"flash"``). ``flash_bwd`` is the port's own field: the
    ``bwd_impl`` the ``"flash"`` attention runs (the reference always
    takes ``"auto"``). ``dtype`` is a torch dtype."""

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
    # the reference's mixture-of-experts fields; n_experts > 0 raises
    # (ROADMAP.md Queue 1 item 15)
    n_experts: int = 0
    capacity_factor: float = 2.0
    moe_aux_coef: float = 0.0
    # remat=True recomputes every layer's activations in the backward
    # (torch.utils.checkpoint per layer) instead of keeping them
    remat: bool = False
    flash_bwd: str = "auto"
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.attn == "ring" and self.attn_impl == "flash":
            # as the reference: flash is the per-device full-sequence
            # kernel, which ring attention does not have
            raise ValueError(
                'attn_impl="flash" requires attn="ulysses" (ring '
                "attention has no per-device full-sequence kernel)"
            )
        if self.n_experts:
            raise NotImplementedError(
                "n_experts > 0 (the mixture of experts, models/moe.py) is "
                "ROADMAP.md Queue 1 item 15, not yet ported"
            )
        if self.flash_bwd not in ("auto", "split", "fused"):
            raise ValueError(
                f"flash_bwd must be 'auto'|'split'|'fused', got "
                f"{self.flash_bwd!r}"
            )
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


# --------------------------------------------------------------------------
# dense forward and single-device training
# --------------------------------------------------------------------------


def _attn_block(x, lp, pos, attn_fn):
    """Attention half-block on (B, L, D) activations: LayerNorm, the
    QKV projections, RoPE at positions ``pos``, ``attn_fn`` and the
    out-projection."""
    h = _ln(x, lp["ln1_s"], lp["ln1_b"])
    q = torch.einsum("bld,dhk->blhk", h, lp["wq"])
    k = torch.einsum("bld,dhk->blhk", h, lp["wk"])
    v = torch.einsum("bld,dhk->blhk", h, lp["wv"])
    q, k = _rope(q, pos), _rope(k, pos)
    o = attn_fn(q, k, v)
    return torch.einsum("blhk,hkd->bld", o, lp["wo"])


def _local_attention(cfg: TransformerConfig):
    """The per-device (unsharded) attention selected by config: causal,
    the config's window and, for ``"flash"``, its backward."""
    kw = {"causal": True, "window": cfg.attn_window}
    if cfg.attn_impl == "flash":
        kw["bwd_impl"] = cfg.flash_bwd
    return partial(resolve_attention_impl(cfg.attn_impl), **kw)


def forward_dense(params: dict, tokens, cfg: TransformerConfig):
    """Single-device forward: (B, L) int tokens -> (B, L, vocab) logits
    in ``cfg.dtype``."""
    return _forward_dense_aux(params, tokens, cfg)[0]


def _forward_dense_aux(params, tokens, cfg: TransformerConfig):
    """Dense forward returning (logits, summed MoE aux loss); the aux
    loss is 0, since the dense FFN is the only one ported."""
    dev = params["emb"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    pos = torch.arange(tokens.shape[1], device=dev)
    x = params["emb"][tokens]
    attn_fn = _local_attention(cfg)

    def one_layer(x, lp):
        x = x + _attn_block(x, lp, pos, attn_fn)
        h = _ln(x, lp["ln2_s"], lp["ln2_b"])
        return x + _mlp(h, lp) + lp["b2"]

    for lp in params["layers"]:
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(one_layer, x, lp, use_reentrant=False)
        else:
            x = one_layer(x, lp)
    x = _ln(x, params["lnf_s"], params["lnf_b"])
    logits = torch.einsum("bld,vd->blv", x, params["emb"])  # tied head
    return logits, torch.zeros((), dtype=torch.float32, device=dev)


def nll_loss(logits, targets):
    """Mean token NLL in logsumexp form (``lse - logits[target]``), in
    f32: the same value and gradient as ``log_softmax`` + gather, but no
    normalised (B, L, V) array is kept. One device, so no psum."""
    logits = logits.float()
    targets = torch.as_tensor(targets, device=logits.device).long()
    lse = torch.logsumexp(logits, dim=-1)
    tl = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = lse - tl
    return nll.sum() / nll.numel()


def _leaves(tree) -> list:
    """Tensors of a parameter tree, in the reference's pytree order
    (dict keys sorted, list items in order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    """``tree`` with its leaves replaced, in :func:`_leaves` order, by
    the items of iterator ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def _check_mesh(mesh) -> None:
    """One device only: ``None``, a device, or a collection holding one
    device."""
    if mesh is None or isinstance(mesh, (str, torch.device)):
        return
    n = int(np.asarray(mesh, dtype=object).size)
    if n != 1:
        raise NotImplementedError(
            f"a mesh of {n} devices needs the sharded train step, "
            "ROADMAP.md Queue 1 item 18 (not yet ported); pass mesh=None "
            "or one device"
        )


def loss_and_grads(params: dict, tokens, targets, cfg: TransformerConfig):
    """(loss, grads) of the mean token NLL at ``params``: ``grads`` has
    the structure of ``params``. The parameters' ``requires_grad`` flags
    are restored on return."""
    leaves = _leaves(params)
    flags = [p.requires_grad for p in leaves]
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            logits, _ = _forward_dense_aux(params, tokens, cfg)
            loss = nll_loss(logits, targets)
            del logits
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for p, f in zip(leaves, flags):
            p.requires_grad_(f)
    return loss.detach(), _rebuild(params, iter(grads))


def make_train_step(cfg: TransformerConfig, mesh=None, *, lr: float = 1e-2,
                    donate: bool = False):
    """(params, tokens, targets) -> (params, loss) SGD step on one
    device: ``p - lr * g`` for every leaf.

    ``donate=True`` updates the given parameter tensors in place under
    ``torch.no_grad()`` and returns the same tree (the caller must not
    expect the old values); otherwise new tensors are returned and the
    input is left as it was. ``mesh`` is None or one device; a larger
    mesh raises (ROADMAP.md item 18)."""
    _check_mesh(mesh)

    def step(params, tokens, targets):
        loss, grads = loss_and_grads(params, tokens, targets, cfg)
        pairs = zip(_leaves(params), _leaves(grads))
        with torch.no_grad():
            if donate:
                for p, g in pairs:
                    p.sub_(lr * g.to(p.dtype))
                return params, loss
            new = [p - lr * g.to(p.dtype) for p, g in pairs]
        return _rebuild(params, iter(new)), loss

    return step


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4):
    """An optimizer factory with ``optax.adamw``'s defaults: takes the
    list of parameter tensors, returns the ``torch.optim.AdamW`` that
    updates them in place (decoupled weight decay, bias-corrected
    moments, ``eps`` outside the square root, as optax)."""

    def tx(leaves):
        return torch.optim.AdamW(leaves, lr=lr, betas=(b1, b2), eps=eps,
                                 weight_decay=weight_decay)

    return tx


def make_optax_train_step(cfg: TransformerConfig, mesh=None, tx=None):
    """Like :func:`make_train_step` but stepping a torch optimizer.
    ``tx`` is a factory such as :func:`adamw`. Returns ``(step,
    init_state)``: ``init_state(params)`` builds the optimizer over the
    tree's tensors, and ``step(params, opt_state, tokens, targets) ->
    (params, opt_state, loss)`` updates those tensors in place.

    >>> step, init_state = make_optax_train_step(cfg, tx=adamw(3e-4))
    >>> opt_state = init_state(params)
    >>> params, opt_state, loss = step(params, opt_state, inp, tgt)
    """
    _check_mesh(mesh)
    if tx is None:
        raise ValueError("tx is required, e.g. tx=adamw(3e-4)")

    def init_state(params):
        return tx(_leaves(params))

    def step(params, opt_state, tokens, targets):
        leaves = _leaves(params)
        held = opt_state.param_groups[0]["params"]
        if len(held) != len(leaves) or any(
                a is not b for a, b in zip(held, leaves)):
            raise ValueError("opt_state was built over other tensors than "
                             "params: build it with init_state(params)")
        loss, grads = loss_and_grads(params, tokens, targets, cfg)
        for p, g in zip(leaves, _leaves(grads)):
            p.grad = g
        opt_state.step()
        for p in leaves:
            p.grad = None
        return params, opt_state, loss

    return step, init_state
