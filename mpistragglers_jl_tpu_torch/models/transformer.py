"""The flagship decoder-only transformer: configuration, parameters,
the dense forward, and the train steps on one device and over a
``("dp", "sp", "tp")`` mesh.

Counterpart of ``mpistragglers_jl_tpu/models/transformer.py``. Slice 1
ported what serving reads: the config, ``init_params`` (the same numpy
draws in the same order, so both packages hold identical weights from
one seed), the JAX-to-torch parameter carry-over, and the LayerNorm,
RoPE and MLP blocks. Slice 3 adds training on one device:
``forward_dense``, ``nll_loss`` and the SGD and optimizer train steps.
Slice 9 adds the top-1 mixture of experts (``n_experts > 0``,
``models/moe.py``) in place of every layer's MLP, with its Switch
load-balance loss. The parameter layout is the reference's nested dict:
projections ``(d_model, heads, head_dim)``, out-projection ``(heads,
head_dim, d_model)``, tied embedding ``(vocab, d_model)``.

Slice 17 adds the sharded program (``param_specs``, ``shard_params``,
``make_forward``, and the train steps given a ``parallel.mesh.Mesh``):

* **dp**: the batch is split over ``dp``;
* **sp**: the sequence is split over ``sp``; attention is ring or
  Ulysses (``parallel/ring_attention.py``, ``cfg.attn``), RoPE reads
  the global positions ``sp_index * Lc + arange(Lc)``;
* **tp**: the Megatron split, heads and ``d_ff`` over ``tp``, one
  ``psum`` after the attention out-projection and one after the MLP
  (``b2`` added outside it). With GQA and ``kv_heads < tp``, ``wk`` and
  ``wv`` stay replicated and each tp member slices the one kv head its
  q heads read (``make_kv_slice``).

The reference runs this as one ``shard_map``. The port's mesh is
single-controller (``parallel/mesh.py``): each parameter is a
``ShardedTensor`` holding one tensor per mesh position, and the program
is a per-rank loop with explicit, differentiable collectives
(``parallel/collectives.py``). Without a mesh (``mesh=None`` or one
device) the train steps run ``forward_dense``, that program's
one-device form.

With experts (``n_experts > 0``) the mesh is ``("dp", "sp", "tp",
"ep")``: the batch is split over ``(dp, ep)`` and each layer's MoE runs
expert-parallel (``models/moe.py`` ``moe_ffn_sharded``: an all-to-all
over ``ep`` each way, the experts' hidden dim over ``tp``), its
output summed over ``tp`` with ``be2``'s term outside the sum; the loss
adds ``moe_aux_coef`` times the mean of the ranks' aux losses over the
batch axes, as the reference.

**The single-controller autograd rule.** ``shard_map`` transposes a
replicated input's gradient into a sum over the devices that hold it.
Here every replica is its own tensor, so the port does it by hand:

1. the loss is one scalar equal to the dense mean NLL: every rank
   computes a copy (``psum`` over the batch axes), and the step takes
   flat rank 0's, never a sum of copies;
2. one ``autograd.grad`` runs over every rank's graph through the
   collectives, from every rank's loss copy, seeded 1 on flat rank 0's
   copy and 0 on every other (a ``psum``'s backward sums its members'
   cotangents, so the zeros add nothing);
3. each leaf's gradient is summed over the mesh axes that its
   ``param_specs`` entry does not name (dp and sp for every leaf, tp
   for the replicated ones, ep for all but the experts; an axis of
   size 1 has nothing to add), in rank order and in float32, and the one
   sum is written to every replica, so replicas stay bit-equal after
   any number of SGD or AdamW steps.

``remat=True`` checkpoints a whole layer across all ranks
(``torch.utils.checkpoint``, non-reentrant), since the collectives
cross ranks inside a layer.

**Across processes.** Over a mesh from ``make_multihost_mesh`` that
spans processes each process runs the per-rank program on its own
positions (``Mesh.local_ranks``; every per-rank list is indexed by
position in it) and the collectives cross processes
(``parallel/collectives.py``). Rule 2 is one ``autograd.grad`` per
process over its local ranks' loss copies: every process then enters
every backward collective, in the same order (``crossing_chain``
orders them), and the gradients are the single-controller ones. Rule
3's replica sum crosses processes in rank order, in float32. The
experts run across processes too: ``moe_ffn_sharded``'s all-to-alls
and ``be2`` gather cross processes where ``ep`` does.
"""

from __future__ import annotations

import contextlib
import dataclasses
from functools import partial
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..parallel.collectives import crossing_chain, psum
from ..parallel.mesh import (
    Mesh,
    PartitionSpec as P,
    ShardedTensor,
    from_local,
    shard,
)
from ..parallel.ring_attention import (
    resolve_attention_impl,
    ring_self_attention,
    ulysses_attention,
)
from .moe import (
    init_moe_layer,
    moe_ffn_dense,
    moe_ffn_sharded,
    moe_layer_specs,
)

__all__ = [
    "TransformerConfig",
    "adamw",
    "batch_axes",
    "data_spec",
    "forward_dense",
    "init_params",
    "loss_and_grads",
    "make_forward",
    "make_kv_slice",
    "make_optax_train_step",
    "make_train_step",
    "nll_loss",
    "param_specs",
    "params_from_jax",
    "shard_params",
    "sharded_loss_and_grads",
]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's config. ``attn`` names the
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
    # n_experts > 0 replaces every layer's MLP with a top-1-routed
    # mixture of experts (models/moe.py), all resident on the device;
    # moe_aux_coef weighs the Switch load-balance loss in the train step
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
    in the reference's order (per layer wq, wk, wv, wo, then w1, w2 or,
    with experts, wg, we1, we2; then the embedding) and rounded to
    ``cfg.dtype`` the same way (the router ``wg`` stays f32), so the
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
        }
        if cfg.n_experts:
            layer.update(init_moe_layer(rng, D, Fd, cfg.n_experts,
                                        cfg.n_layers, dt))
        else:
            layer.update({
                "w1": sd(D, Fd),
                "b1": const(0.0, Fd),
                "w2": sd(Fd, D) / depth,
                "b2": const(0.0, D),
            })
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


def _qkv(x, lp, pos, kv_slice=None, rope=_rope):
    """LayerNorm, the QKV projections (``kv_slice`` picks kv heads out
    of tp-replicated K/V projections) and ``rope`` at positions ``pos``
    (the serving step passes its per-row RoPE)."""
    h = _ln(x, lp["ln1_s"], lp["ln1_b"])
    q = torch.einsum("bld,dhk->blhk", h, lp["wq"])
    k = torch.einsum("bld,dhk->blhk", h, lp["wk"])
    v = torch.einsum("bld,dhk->blhk", h, lp["wv"])
    if kv_slice is not None:
        k, v = kv_slice(k), kv_slice(v)
    return rope(q, pos), rope(k, pos), v


def _attn_block(x, lp, pos, attn_fn):
    """Attention half-block on (B, L, D) activations: :func:`_qkv`,
    ``attn_fn`` and the out-projection. The sharded program runs
    :func:`_qkv` per rank and its attention across ranks."""
    o = attn_fn(*_qkv(x, lp, pos))
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


def _layer(x, lp, pos, attn_fn, cfg: TransformerConfig):
    """One layer on (B, L, D) activations with every weight local:
    ``(x, the layer's MoE aux loss in f32)``, the aux None without
    experts. The dense forward and the pipeline's stages run it."""
    x = x + _attn_block(x, lp, pos, attn_fn)
    h = _ln(x, lp["ln2_s"], lp["ln2_b"])
    if cfg.n_experts:
        y, a = moe_ffn_dense(h, lp, cfg.capacity_factor)
        return x + y, a
    return x + _mlp(h, lp) + lp["b2"], None


def _forward_dense_aux(params, tokens, cfg: TransformerConfig):
    """Dense forward returning (logits, the layers' summed MoE aux loss
    in f32; 0 without experts). Under ``remat`` the backward recomputes
    each layer, routing included (it is deterministic)."""
    dev = params["emb"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    pos = torch.arange(tokens.shape[1], device=dev)
    x = params["emb"][tokens]
    one_layer = partial(_layer, pos=pos, attn_fn=_local_attention(cfg),
                        cfg=cfg)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for lp in params["layers"]:
        if cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(one_layer, x, lp, use_reentrant=False)
        else:
            x, a = one_layer(x, lp)
        if cfg.n_experts:
            aux = aux + a
    x = _ln(x, params["lnf_s"], params["lnf_b"])
    logits = torch.einsum("bld,vd->blv", x, params["emb"])  # tied head
    return logits, aux


def _nll(logits, targets):
    logits = logits.float()
    targets = torch.as_tensor(targets, device=logits.device).long()
    lse = torch.logsumexp(logits, dim=-1)
    tl = torch.gather(logits, -1, targets[..., None])[..., 0]
    return lse - tl


def nll_loss(logits, targets, axes=None, mesh: Mesh | None = None):
    """Mean token NLL in logsumexp form (``lse - logits[target]``), in
    f32: the same value and gradient as ``log_softmax`` + gather, but no
    normalised (B, L, V) array is kept.

    On one device (``axes`` None) ``logits`` and ``targets`` are
    tensors. With ``axes`` and ``mesh`` they hold one tensor per mesh
    position this process drives, and each position gets the mean over
    all positions of its group over ``axes`` (the reference's psum of
    the sums over the count)."""
    if axes is None:
        nll = _nll(logits, targets)
        return nll.sum() / nll.numel()
    sums = psum([_nll(lg, t).sum() for lg, t in zip(logits, targets)],
                mesh, axes)
    # every member of a group holds an equal block of the batch
    members = len(mesh.axis_groups(axes)[0])
    return [s_ / float(lg[..., 0].numel() * members)
            for s_, lg in zip(sums, logits)]


def _leaves(tree) -> list:
    """Tensors of a parameter tree, in the reference's pytree order
    (dict keys sorted, list items in order; a ``PartitionSpec`` is a
    leaf)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    """``tree`` with its leaves replaced, in :func:`_leaves` order, by
    the items of iterator ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def _grads_fn(cfg: TransformerConfig, mesh):
    """The train steps' ``(params, tokens, targets) -> (loss, grads)``:
    ``mesh`` None (or one device, a ``str`` or ``torch.device``) runs the
    dense program, a :class:`Mesh` the sharded one."""
    if mesh is None or isinstance(mesh, (str, torch.device)):
        return partial(loss_and_grads, cfg=cfg)
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a parallel.mesh.Mesh (make_mesh(shape, "
            f"('dp', 'sp', 'tp'), devices=...)), one device or None; got "
            f"{type(mesh).__name__}")
    _check_sharded(cfg, mesh)
    return partial(sharded_loss_and_grads, cfg=cfg, mesh=mesh)


def loss_and_grads(params: dict, tokens, targets, cfg: TransformerConfig):
    """(loss, grads) of the mean token NLL at ``params``, plus
    ``moe_aux_coef`` times the summed aux loss when the config has
    experts and a nonzero coefficient (the reference's one-member
    ``_loss_local``): ``grads`` has the structure of ``params``. The
    parameters' ``requires_grad`` flags are restored on return."""
    leaves = _leaves(params)
    flags = [p.requires_grad for p in leaves]
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            logits, aux = _forward_dense_aux(params, tokens, cfg)
            loss = nll_loss(logits, targets)
            del logits
            if cfg.n_experts and cfg.moe_aux_coef:
                loss = loss + cfg.moe_aux_coef * aux
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for p, f in zip(leaves, flags):
            p.requires_grad_(f)
    return loss.detach(), _rebuild(params, iter(grads))


# --------------------------------------------------------------------------
# the sharded program over a ("dp", "sp", "tp") mesh
# --------------------------------------------------------------------------


def _kv_tp_sharded(cfg: TransformerConfig, mesh: Mesh | None) -> bool:
    """Whether the K/V projections shard their (narrower) head dim over
    ``tp``. With GQA/MQA the kv-head count can drop below the tp degree;
    then wk/wv stay replicated and each tp member slices the one kv head
    its q-head shard reads (:func:`make_kv_slice`). Requires kv_heads %
    tp == 0 or tp % kv_heads == 0 — anything else has no aligned
    grouping."""
    if mesh is None or "tp" not in mesh.axis_names:
        return True
    tp = mesh.shape["tp"]
    if cfg.n_heads % tp != 0:
        raise ValueError(
            f"n_heads {cfg.n_heads} must divide over tp={tp}"
        )
    if cfg.kv_heads % tp == 0:
        return True
    if tp % cfg.kv_heads == 0:
        return False
    raise ValueError(
        f"kv_heads {cfg.kv_heads} and tp={tp} need one to divide the "
        "other (grouped q-head shards must align to whole kv heads)"
    )


def param_specs(cfg: TransformerConfig, mesh: Mesh | None = None) -> dict:
    """PartitionSpecs matching :func:`init_params`: heads and d_ff over
    ``tp`` (Megatron split), everything else replicated. Pass ``mesh``
    so GQA configs whose kv_heads < tp degree fall back to replicated
    K/V projections (see :func:`_kv_tp_sharded`)."""
    kv = P(None, "tp", None) if _kv_tp_sharded(cfg, mesh) else P()
    layer = {
        "ln1_s": P(), "ln1_b": P(),
        "wq": P(None, "tp", None),
        "wk": kv,
        "wv": kv,
        "wo": P("tp", None, None),
        "ln2_s": P(), "ln2_b": P(),
    }
    if cfg.n_experts:
        layer.update(moe_layer_specs())
    else:
        layer.update({
            "w1": P(None, "tp"),
            "b1": P("tp"),
            "w2": P("tp", None),
            "b2": P(),
        })
    return {
        "emb": P(),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
        "lnf_s": P(),
        "lnf_b": P(),
    }


def make_kv_slice(cfg: TransformerConfig, mesh: Mesh):
    """GQA with kv_heads < tp: wk/wv arrive tp-REPLICATED
    (:func:`_kv_tp_sharded`); the q-head shard [t*H/tp, (t+1)*H/tp) of
    tp member t reads exactly one kv head, t*kv_heads // tp. Returns
    ``kv_slice(a, rank)``, which slices that head out of rank
    ``rank``'s (B, L, kv_heads, D) tensor, so the attention sees the
    aligned local grouping (all local q heads -> local kv head 0); or
    None when kv heads shard evenly (nothing to slice)."""
    tp = mesh.shape["tp"]
    if cfg.kv_heads % tp == 0:
        return None
    t = mesh.axis_index("tp")

    def kv_slice(a, rank):
        idx = t[rank] * cfg.kv_heads // tp
        return a[:, :, idx:idx + 1]

    return kv_slice


def batch_axes(cfg: TransformerConfig) -> tuple[str, ...]:
    """Mesh axes the batch/sequence is sharded over: MoE adds ``ep`` as
    an extra batch-sharding axis so every ep member routes distinct
    tokens (GShard layout)."""
    return ("dp", "ep", "sp") if cfg.n_experts else ("dp", "sp")


def data_spec(cfg: TransformerConfig) -> P:
    """PartitionSpec of global (B, L) token arrays."""
    return P(("dp", "ep"), "sp") if cfg.n_experts else P("dp", "sp")


def _check_sharded(cfg: TransformerConfig, mesh: Mesh) -> None:
    """The training program's checks: its mesh axes, its attention kind,
    then :func:`_check_layout`."""
    need = ("dp", "sp", "tp") + (("ep",) if cfg.n_experts else ())
    missing = [a for a in need if a not in mesh.axis_names]
    if missing:
        what = "expert-parallel" if cfg.n_experts else "sharded"
        raise ValueError(
            f"the {what} program runs over {need} mesh axes; mesh "
            f"{dict(mesh.shape)} lacks {missing}")
    if cfg.attn not in ("ring", "ulysses"):
        raise ValueError(f"unknown sharded attention kind {cfg.attn!r}")
    _check_layout(cfg, mesh)


def _check_layout(cfg: TransformerConfig, mesh: Mesh) -> None:
    """What :func:`param_specs` needs of a mesh, whatever program runs
    over it: a ``tp`` axis (and ``ep`` with experts), the experts and
    ``d_ff`` divisible over them, the tp and kv-head alignment, and
    every process of the mesh in the job. The decode meshes (``("dp",
    "tp")``, ``("dp", "ep", "tp")``) pass it."""
    need = ("tp",) + (("ep",) if cfg.n_experts else ())
    missing = [a for a in need if a not in mesh.axis_names]
    if missing:
        raise ValueError(
            f"the parameters lay out over {need} mesh axes; mesh "
            f"{dict(mesh.shape)} lacks {missing}")
    if cfg.n_experts:
        ep, tp = mesh.shape["ep"], mesh.shape["tp"]
        if cfg.n_experts % ep:
            raise ValueError(
                f"n_experts {cfg.n_experts} must divide over ep={ep}")
        if cfg.d_ff % tp:
            raise ValueError(f"d_ff {cfg.d_ff} must divide over tp={tp}")
    mesh.local_ranks()  # every process of the mesh in the job
    param_specs(cfg, mesh)  # the tp and kv-head alignment checks


def _spec_key(spec) -> tuple:
    """A spec's layout: trailing Nones dropped, a one-axis tuple as its
    name (``P(("dp",))`` splits as ``P("dp")``)."""
    spec = tuple(part[0] if isinstance(part, tuple) and len(part) == 1
                 else part for part in spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _tensors(tree) -> list:
    """Every tensor of a parameter tree in :func:`_leaves` order; a
    :class:`ShardedTensor` leaf gives this process's shards in
    ``local_ranks`` order."""
    out = []
    for leaf in _leaves(tree):
        if isinstance(leaf, ShardedTensor):
            out.extend(leaf.locals())
        else:
            out.append(leaf)
    return out


def _rebuild_tensors(tree, it):
    """``tree`` with the tensors of :func:`_tensors` replaced by the
    items of ``it``, each sharded leaf keeping its mesh and spec."""
    new = []
    for leaf in _leaves(tree):
        if isinstance(leaf, ShardedTensor):
            new.append(from_local(
                leaf.mesh, leaf.spec,
                [next(it) for _ in leaf.mesh.local_ranks()], leaf.shape))
        else:
            new.append(next(it))
    return _rebuild(tree, iter(new))


def _sharded_leaves(params, cfg, mesh) -> list:
    return _laid_out(params, param_specs(cfg, mesh), mesh,
                     "shard_params(params, cfg, mesh)")


def _laid_out(params, spec_tree, mesh, how: str) -> list:
    """``params``' leaves, each checked to be a ShardedTensor on
    ``mesh`` laid out by its entry of ``spec_tree`` (``how`` names the
    function that lays them out)."""
    leaves = _leaves(params)
    specs = _leaves(spec_tree)
    if len(leaves) != len(specs):
        raise ValueError(
            f"params hold {len(leaves)} leaves, the config {len(specs)}")
    for leaf, spec in zip(leaves, specs):
        if not isinstance(leaf, ShardedTensor) or leaf.mesh is not mesh:
            raise TypeError(
                "over a mesh the parameters are ShardedTensors on that "
                f"mesh: lay them out with {how}")
        if _spec_key(leaf.spec) != _spec_key(spec):
            raise ValueError(
                f"a parameter laid out as {leaf.spec}, param_specs says "
                f"{spec}")
    return leaves


def _data_locals(x, cfg, mesh) -> tuple[list, tuple]:
    """Each local rank's block of a (B, L) token array, and the global
    shape."""
    spec = data_spec(cfg)
    if isinstance(x, ShardedTensor):
        if x.mesh is not mesh or _spec_key(x.spec) != _spec_key(spec):
            raise ValueError(f"tokens must be laid out as {spec} on the "
                             "mesh")
        return x.locals(), x.shape
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    sh = shard(t, mesh, spec)
    return sh.locals(), sh.shape


def _sharded_attention(cfg: TransformerConfig, mesh: Mesh):
    """The sequence-parallel attention over ``sp``, list in, list out."""
    if cfg.attn == "ring":
        return partial(ring_self_attention, mesh=mesh, axis="sp",
                       causal=True, window=cfg.attn_window)
    return partial(ulysses_attention, mesh=mesh, axis="sp", causal=True,
                   impl=cfg.attn_impl, window=cfg.attn_window,
                   bwd_impl=cfg.flash_bwd)


def _forward_local(lparams: list, ltokens: list, cfg: TransformerConfig,
                   mesh: Mesh) -> tuple[list, list]:
    """The per-rank program: ``lparams[i]`` is the tree of local shards
    of the i-th position this process drives (``mesh.local_ranks()``),
    ``ltokens[i]`` its (B', Lc) block of tokens. Returns each such
    position's local (B', Lc, vocab) logits and its layers' summed MoE
    aux loss (f32; 0 without experts)."""
    sp = mesh.axis_index("sp")
    ranks = mesh.local_ranks()
    devs = [lp["emb"].device for lp in lparams]
    toks = [torch.as_tensor(t, device=d).long()
            for t, d in zip(ltokens, devs)]
    Lc = toks[0].shape[1]
    pos = [sp[r] * Lc + torch.arange(Lc, device=d)
           for r, d in zip(ranks, devs)]
    attn = _sharded_attention(cfg, mesh)
    kv = make_kv_slice(cfg, mesh)
    slices = [None if kv is None else partial(kv, rank=r) for r in ranks]

    def one_layer(xs, lps):
        qkv = [_qkv(x, lp, pos[r], slices[r])
               for r, (x, lp) in enumerate(zip(xs, lps))]
        os_ = attn(*(list(t) for t in zip(*qkv)))
        # tp combine: heads were a shard, the out-projection partial-sums
        a = psum([torch.einsum("blhk,hkd->bld", o, lp["wo"])
                  for o, lp in zip(os_, lps)], mesh, "tp")
        xs = [x + ai for x, ai in zip(xs, a)]
        hs = [_ln(x, lp["ln2_s"], lp["ln2_b"]) for x, lp in zip(xs, lps)]
        if cfg.n_experts:
            # the experts' hidden dims are tp shards; be2's term rides
            # outside the psum (moe_ffn_sharded)
            y, bias, a = moe_ffn_sharded(hs, lps, cfg.capacity_factor,
                                         mesh=mesh)
            y = psum(y, mesh, "tp")
            return [x + yi + bi for x, yi, bi in zip(xs, y, bias)], a
        y = psum([_mlp(h, lp) for h, lp in zip(hs, lps)], mesh,
                 "tp")  # d_ff shards
        return [x + yi + lp["b2"]  # b2 replicated, outside the psum
                for x, yi, lp in zip(xs, y, lps)], None

    xs = [lp["emb"][t] for lp, t in zip(lparams, toks)]
    aux = [torch.zeros((), dtype=torch.float32, device=d) for d in devs]
    for i in range(cfg.n_layers):
        lps = [lp["layers"][i] for lp in lparams]
        # remat checkpoints the layer across every rank: its collectives
        # cross ranks, so no rank's layer can be replayed alone
        if cfg.remat and torch.is_grad_enabled():
            xs, a = checkpoint(one_layer, xs, lps, use_reentrant=False)
        else:
            xs, a = one_layer(xs, lps)
        if a is not None:
            aux = [s_ + ai for s_, ai in zip(aux, a)]
    logits = [torch.einsum("bld,vd->blv", _ln(x, lp["lnf_s"], lp["lnf_b"]),
                           lp["emb"]) for x, lp in zip(xs, lparams)]
    return logits, aux


def _loss_local(lparams, ltokens, ltargets, cfg, mesh) -> list:
    """Each position's copy of the mean token NLL over the whole batch,
    plus ``moe_aux_coef`` times the mean of the positions' aux losses
    over the batch axes when the config has experts."""
    logits, aux = _forward_local(lparams, ltokens, cfg, mesh)
    axes = batch_axes(cfg)
    loss = nll_loss(logits, ltargets, axes, mesh)
    if cfg.n_experts and cfg.moe_aux_coef:
        members = len(mesh.axis_groups(axes)[0])
        loss = [lo + cfg.moe_aux_coef * a / members
                for lo, a in zip(loss, psum(aux, mesh, axes))]
    return loss


def shard_params(params: dict, cfg: TransformerConfig, mesh: Mesh) -> dict:
    """Lay a dense parameter tree out over ``mesh`` by
    :func:`param_specs`: a tree of :class:`ShardedTensor`, each position
    holding its own copy of its block on its device. Any local mesh
    with a ``tp`` axis (and ``ep`` with experts) will do: the training
    program's ``("dp", "sp", "tp")`` and the decode meshes alike."""
    _check_layout(cfg, mesh)
    return _rebuild(params, iter(
        shard(x, mesh, spec)
        for x, spec in zip(_leaves(params), _leaves(param_specs(cfg,
                                                                mesh)))))


def make_forward(cfg: TransformerConfig, mesh: Mesh):
    """``fwd(params, tokens)``: the sharded forward over
    :func:`shard_params`' tree and a global (B, L) token array (or one
    laid out by :func:`data_spec`); returns the (B, L, vocab) logits as
    a :class:`ShardedTensor` laid out by :func:`data_spec` (``gather()``
    or ``np.asarray`` assembles them)."""
    _check_sharded(cfg, mesh)

    def fwd(params, tokens):
        leaves = _sharded_leaves(params, cfg, mesh)
        lparams = [_rebuild(params, iter(leaf.local(r) for leaf in leaves))
                   for r in mesh.local_ranks()]
        toks, (B, L) = _data_locals(tokens, cfg, mesh)
        logits, _ = _forward_local(lparams, toks, cfg, mesh)
        return from_local(mesh, data_spec(cfg), logits, (B, L, cfg.vocab))

    return fwd


def sharded_loss_and_grads(params: dict, tokens, targets,
                           cfg: TransformerConfig, mesh: Mesh):
    """(loss, grads) of the sharded program: ``params`` is
    :func:`shard_params`' tree, ``tokens`` and ``targets`` global (B, L)
    arrays or values laid out by :func:`data_spec`. ``loss`` is flat
    rank 0's copy of the mean NLL (a 0-d tensor; across processes, this
    process's first copy, which holds the same bits); ``grads`` is a
    tree of
    :class:`ShardedTensor` laid out as ``params``, each leaf's gradient
    summed over the mesh axes of size > 1 that its spec does not name
    (in float32, in rank order) and written to every replica (the
    module docstring's
    rule). The shards' ``requires_grad`` flags are restored on
    return."""
    _check_sharded(cfg, mesh)
    leaves = _sharded_leaves(params, cfg, mesh)
    toks, _ = _data_locals(tokens, cfg, mesh)
    tgts, _ = _data_locals(targets, cfg, mesh)
    return _replica_loss_and_grads(
        params, leaves, mesh,
        lambda lparams: _loss_local(lparams, toks, tgts, cfg, mesh))


@contextlib.contextmanager
def _shards_requiring_grad(leaves, mesh):
    """Context manager over this process's shards of ``leaves``: yields
    the per-leaf lists of shards with ``requires_grad`` set, and
    restores the flags on exit."""
    shards = [leaf.locals() for leaf in leaves]
    flat = [t for per_leaf in shards for t in per_leaf]
    if len({id(t) for t in flat}) != len(flat):
        raise ValueError("two positions share one parameter tensor: lay "
                         "the parameters out with shard_params")
    flags = [t.requires_grad for t in flat]
    try:
        for t in flat:
            t.requires_grad_(True)
        yield shards
    finally:
        for t, f in zip(flat, flags):
            t.requires_grad_(f)


def _replica_loss_and_grads(params, leaves, mesh: Mesh, loss_local):
    """The single-controller autograd rule (module docstring) over any
    per-rank program: ``loss_local(lparams)`` takes one tree of local
    shards per position this process drives and returns each such
    position's copy of the loss. Returns flat rank 0's copy (across
    processes this process's first copy, the same bits) and the gradient
    tree of :class:`ShardedTensor`, each leaf summed over the mesh axes
    of size > 1 that its spec does not name. The pipeline's autodiff
    schedules share it."""
    ranks = mesh.local_ranks()
    n = len(ranks)
    chain = crossing_chain(mesh) if mesh.spans_processes else \
        contextlib.nullcontext()
    with _shards_requiring_grad(leaves, mesh) as shards:
        flat = [t for per_leaf in shards for t in per_leaf]
        with torch.enable_grad():
            with chain as ends:  # the forward only: a remat replay's
                # collectives in the backward join no chain
                lparams = [_rebuild(params, iter(s_[i] for s_ in shards))
                           for i in range(n)]
                losses = loss_local(lparams)
            loss = losses[0]
            # one backward over every local copy, seeded 1 on flat rank
            # 0's and 0 elsewhere, and across processes from the end of
            # the crossing chain to its start: every process then enters
            # every backward collective, in one order
            roots = [(lo, torch.ones_like(lo) if r == 0 else
                      torch.zeros_like(lo))
                     for lo, r in zip(losses, ranks) if lo.requires_grad]
            chained = ends is not None and ends[1] is not ends[0]
            if chained:
                roots.append((ends[1], torch.zeros(())))
            grads = torch.autograd.grad(
                [lo for lo, _ in roots], flat + ([ends[0]] if chained
                                                 else []),
                allow_unused=True, grad_outputs=[g for _, g in roots])
    it = iter(grads)
    out = []
    with torch.no_grad():
        for leaf, per_leaf in zip(leaves, shards):
            parts = [g if g is not None else torch.zeros_like(t)
                     for g, t in zip((next(it) for _ in range(n)),
                                     per_leaf)]
            named = {a for part in leaf.spec if part is not None
                     for a in ((part,) if isinstance(part, str) else part)}
            over = [a for a in mesh.axis_names
                    if a not in named and mesh.shape[a] > 1]
            if over:
                parts = [g.to(leaf.dtype) for g in
                         psum(parts, mesh, over, dtype=torch.float32)]
            out.append(from_local(mesh, leaf.spec, parts, leaf.shape))
    return loss.detach(), _rebuild(params, iter(out))


def make_train_step(cfg: TransformerConfig, mesh=None, *, lr: float = 1e-2,
                    donate: bool = False):
    """(params, tokens, targets) -> (params, loss) SGD step: ``p - lr *
    g`` for every leaf.

    ``mesh`` None (or one device) steps a dense parameter tree; a
    :class:`Mesh` steps the tree of :class:`ShardedTensor` that
    :func:`shard_params` lays out, through the sharded program
    (:func:`sharded_loss_and_grads`), with ``tokens`` and ``targets``
    global ``(B, L)`` arrays or values laid out by :func:`data_spec`.
    ``donate=True`` updates the given tensors (every rank's) in place
    under ``torch.no_grad()`` and returns the same tree (the caller must
    not expect the old values); otherwise new tensors are returned and
    the input is left as it was."""
    return _sgd_step(_grads_fn(cfg, mesh), lr, donate)


def _sgd_step(grads_of, lr: float, donate: bool):
    """The SGD update over any ``grads_of(params, tokens, targets) ->
    (loss, grads)``: :func:`make_train_step`'s and the pipeline's."""

    def step(params, tokens, targets):
        loss, grads = grads_of(params, tokens, targets)
        pairs = zip(_tensors(params), _tensors(grads))
        with torch.no_grad():
            if donate:
                for p, g in pairs:
                    p.sub_(lr * g.to(p.dtype))
                return params, loss
            new = iter([p - lr * g.to(p.dtype) for p, g in pairs])
        return _rebuild_tensors(params, new), loss

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
    tree's tensors (over a :class:`Mesh`, every rank's shard: each
    moment then lives beside its shard, laid out as its parameter), and
    ``step(params, opt_state, tokens, targets) -> (params, opt_state,
    loss)`` updates those tensors in place.

    >>> step, init_state = make_optax_train_step(cfg, tx=adamw(3e-4))
    >>> opt_state = init_state(params)
    >>> params, opt_state, loss = step(params, opt_state, inp, tgt)
    """
    return _optax_step(_grads_fn(cfg, mesh), tx)


def _optax_step(grads_of, tx):
    """``(step, init_state)`` of a torch optimizer over any
    ``grads_of``: :func:`make_optax_train_step`'s and the pipeline's."""
    if tx is None:
        raise ValueError("tx is required, e.g. tx=adamw(3e-4)")

    def init_state(params):
        return tx(_tensors(params))

    def step(params, opt_state, tokens, targets):
        leaves = _tensors(params)
        held = opt_state.param_groups[0]["params"]
        if len(held) != len(leaves) or any(
                a is not b for a, b in zip(held, leaves)):
            raise ValueError("opt_state was built over other tensors than "
                             "params: build it with init_state(params)")
        loss, grads = grads_of(params, tokens, targets)
        for p, g in zip(leaves, _tensors(grads)):
            p.grad = g
        opt_state.step()
        for p in leaves:
            p.grad = None
        return params, opt_state, loss

    return step, init_state
