"""Mixture-of-experts FFN: top-1 Switch routing with static capacity.

Counterpart of ``mpistragglers_jl_tpu/models/moe.py``, the single-device
(dense) path: every expert resident on one device, the reference's
correctness oracle and its single-chip execution mode.

* **Top-1 routing with static capacity.** Each token picks the argmax of
  its router probabilities (ties to the first expert) and takes a slot
  among that expert's ``capacity`` slots, counted by a cumsum in token
  order; tokens past capacity are dropped and ride the residual
  connection. The router weight ``wg`` is f32 at any model dtype, and
  the logits are ``x.float() @ wg`` (bf16 widens to f32 exactly).
* **Dispatch and combine as gathers.** Routing builds an ``(E, C)``
  table of token indices (sentinel ``T`` for an empty seat) by a stable
  sort of the tokens by expert, so a token's place in its group is its
  cumsum slot. Dispatch and combine apply the same bijection between
  kept tokens and seats in opposite directions, so both directions of
  both are gathers: two ``torch.autograd.Function`` s whose backward is
  the inverse gather, not a scatter-add. The gate multiply stays outside
  them, so the router's gradient flows through it.
* :func:`switch_route` (the one-hot formulation) and
  :func:`_scatter_combine` (the scatter-add combine) are the oracles the
  gather form is tested against; no path of the port runs them.
* **Expert parallelism over ``"ep"``** (:func:`moe_layer_specs`,
  :func:`moe_ffn_sharded`). The experts are split over the ``ep`` mesh
  axis and each expert's hidden dim over ``tp``; the batch is split
  over ``(dp, ep)``, so every ep member routes its own tokens (GShard:
  routing and capacity over the member's local tokens). One tiled
  all-to-all ships each member's ``(E, C, D)`` slots to the experts'
  owners, each owner runs its ``E/ep`` experts on its ``d_ff/tp``
  shard, and the inverse all-to-all ships the results home. The caller
  sums the result over ``tp``; ``be2`` rides outside that sum. The
  reference runs it inside ``shard_map``; here it is a per-rank loop
  over the collectives of ``parallel/collectives.py``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.collectives import all_gather, all_to_all
from ..parallel.mesh import PartitionSpec as P

__all__ = [
    "init_moe_layer",
    "moe_layer_specs",
    "switch_route",
    "switch_route_indices",
    "moe_ffn_dense",
    "moe_ffn_sharded",
]


def init_moe_layer(rng: np.random.Generator, d_model: int, d_ff: int,
                   n_experts: int, n_layers: int, dtype) -> dict:
    """Per-layer MoE parameters from ``rng``, drawn in the reference's
    order (``wg``, ``we1``, ``we2``) and rounded as it rounds them: the
    router ``wg`` (D, E) always f32, the experts' weights (E, D, F) and
    (E, F, D) in ``dtype`` with zero biases ``be1`` (E, F), ``be2`` (E,
    D)."""
    E, D, Fd = n_experts, d_model, d_ff

    def sd(*s):
        return torch.as_tensor(rng.standard_normal(s) / np.sqrt(s[-2]),
                               dtype=dtype)

    wg = torch.as_tensor(rng.standard_normal((D, E)) * 0.02,
                         dtype=torch.float32)
    we1 = sd(E, D, Fd)
    # JAX rounds a Python scalar to the array's dtype before dividing
    depth = torch.tensor(float(np.sqrt(n_layers)), dtype=dtype)
    we2 = sd(E, Fd, D) / depth
    return {
        "wg": wg,
        "we1": we1,
        "be1": torch.zeros((E, Fd), dtype=dtype),
        "we2": we2,
        "be2": torch.zeros((E, D), dtype=dtype),
    }


def moe_layer_specs() -> dict:
    """PartitionSpecs for :func:`init_moe_layer`: experts over ``ep``,
    the expert hidden dim over ``tp``, router replicated."""
    return {
        "wg": P(),
        "we1": P("ep", None, "tp"),
        "be1": P("ep", "tp"),
        "we2": P("ep", "tp", None),
        "be2": P("ep", None),
    }


def moe_ffn_sharded(xs: list, mps: list, capacity_factor: float, *,
                    mesh):
    """Expert-parallel MoE FFN, per rank: ``xs[r]`` is flat position r's
    (B', L', D) activations (batch split over (dp, ep), sequence over
    sp), ``mps[r]`` its expert shards laid out by
    :func:`moe_layer_specs`. Returns per-rank lists ``(y_partial,
    ybias, aux)`` with ``y = psum(y_partial, "tp") + ybias``: ``be2`` is
    replicated over tp, so its per-token term ``kept_gate * be2[expert]``
    stays outside the caller's tp sum.

    Routing and capacity are over each rank's local tokens. Chunk ``j``
    of a rank's (E, C, D) slots is experts ``[j E/ep, (j+1) E/ep)``, the
    experts whose ``we1`` shard sits at ep coordinate ``j``: the
    all-to-all (split dim 0, concat dim 1) hands it there, the owner's
    FFN runs on (E/ep, ep*C, D), and the inverse (split dim 1, concat
    dim 0) returns each member's (E, C, D). Over a mesh that spans
    processes the lists hold this process's positions
    (``mesh.local_ranks()``) and the all-to-alls and the gather cross
    processes where ``ep`` does."""
    ep = mesh.shape["ep"]
    routes, xes, auxes = [], [], []
    for x, mp in zip(xs, mps):
        B, L, D = x.shape
        E = mp["we1"].shape[0] * ep
        T = B * L
        C = _capacity(T, E, capacity_factor)
        x2d = x.reshape(T, D)
        table, expert, slot, gate, aux = _route_tables(x2d, mp["wg"], C)
        xes.append(_GatherDispatch.apply(x2d, table, expert, slot))
        routes.append((table, expert, slot, gate, C))
        auxes.append(aux)
    # my tokens for your experts, then each owner's experts on its shard
    xes = all_to_all(xes, mesh, "ep", split_dim=0, concat_dim=1)
    yes = [_expert_ffn(xe, mp) for xe, mp in zip(xes, mps)]
    yes = all_to_all(yes, mesh, "ep", split_dim=1, concat_dim=0)
    be2s = all_gather([mp["be2"] for mp in mps], mesh, "ep", dim=0)
    ys, biases = [], []
    for x, ye, be2, (table, expert, slot, gate, C) in zip(xs, yes, be2s,
                                                         routes):
        yt = _CombinePerToken.apply(ye, table, expert, slot)
        kg = torch.where(slot < C, gate, 0.0).to(x.dtype)  # dropped -> 0
        ys.append((yt * kg[:, None]).reshape(x.shape))
        # kg[t] * be2[expert[t]] as a (T, E) @ (E, D) product: one term
        # is nonzero, so the value is the elementwise product's, and the
        # backward is a product too where the row gather's would be a
        # scatter-add of T rows onto E
        sel = F.one_hot(expert, be2.shape[0]).to(x.dtype) * kg[:, None]
        biases.append((sel @ be2).reshape(x.shape))
    return ys, biases, auxes


def _route(x2d: torch.Tensor, wg: torch.Tensor):
    """The router core of both routing forms: ``(expert (T,) int64,
    slot (T,) int64, gate (T,) f32, aux f32)``. ``slot`` is the token's
    place among its expert's tokens in token order (>= capacity drops);
    ``aux`` the Switch load-balance loss ``E * sum_e frac_e * p_e``."""
    E = wg.shape[1]
    logits = x2d.float() @ wg  # (T, E) f32; wg is never downcast
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)  # ties to the first index
    gate = torch.gather(probs, 1, expert[:, None])[:, 0]
    # one-hot laid out (E, T), so the cumsum in token order runs along
    # the contiguous dim (a scan over dim 0 of (T, E) has only E columns
    # to spread over the card)
    onehot = torch.arange(E, device=x2d.device)[:, None] == expert[None, :]
    oh = onehot.long()
    slot = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(dim=0)  # (T,)
    frac = onehot.float().mean(dim=1)
    aux = E * torch.sum(frac * probs.mean(dim=0))
    return expert, slot, gate, aux


def switch_route(x2d: torch.Tensor, wg: torch.Tensor, capacity: int):
    """The one-hot formulation: ``(dispatch, combine, aux)`` with
    ``dispatch`` (T, E, C) 0/1 f32 (token t in slot c of expert e;
    dropped tokens' rows all zero) and ``combine`` = ``dispatch`` times
    the token's gate. The oracle of the gather form."""
    E = wg.shape[1]
    expert, slot, gate, aux = _route(x2d, wg)
    dev = x2d.device
    onehot = (expert[:, None] == torch.arange(E, device=dev)).float()
    seat = (slot[:, None] == torch.arange(capacity, device=dev)).float()
    dispatch = onehot[:, :, None] * seat[:, None, :]
    combine = dispatch * gate[:, None, None].float()
    return dispatch, combine, aux


def switch_route_indices(x2d: torch.Tensor, wg: torch.Tensor,
                         capacity: int):
    """Top-1 routing as an index table: ``(table, expert, gate, aux)``,
    ``table[e, c]`` the token in slot c of expert e or ``T`` for an
    empty seat."""
    table, expert, _, gate, aux = _route_tables(x2d, wg, capacity)
    return table, expert, gate, aux


def _route_tables(x2d: torch.Tensor, wg: torch.Tensor, capacity: int):
    """:func:`switch_route_indices` plus the per-token ``slot``, the
    inverse seating map of the gather-form backward. The table comes
    from a stable sort of the tokens by expert: order within a group is
    token order, so sorted position equals the cumsum slot."""
    T = x2d.shape[0]
    E = wg.shape[1]
    expert, slot, gate, aux = _route(x2d, wg)
    sorted_tok = torch.sort(expert, stable=True).indices
    dev = x2d.device
    counts = (torch.arange(E, device=dev)[:, None] == expert[None, :]).sum(
        dim=1)
    start = torch.cumsum(counts, dim=0) - counts  # exclusive prefix
    c_idx = torch.arange(capacity, device=dev)[None, :]  # (1, C)
    flat = start[:, None] + c_idx  # (E, C) positions in sorted_tok
    seated = sorted_tok[flat.clamp(max=T - 1)]
    table = torch.where(c_idx < counts[:, None], seated, T)
    return table, expert, slot, gate, aux


def _seat_gather(x2d, table):
    """(T, D) rows -> (E, C, D) seats; empty seats are zeros."""
    T = x2d.shape[0]
    safe = table.clamp(max=T - 1)
    return x2d[safe] * (table < T)[..., None].to(x2d.dtype)


def _token_gather(w_ecd, expert, slot):
    """(E, C, D) seats -> (T, D) rows: each token reads its own seat;
    dropped tokens read zeros."""
    E, C, D = w_ecd.shape
    kept = (slot < C)[:, None].to(w_ecd.dtype)
    idx = expert * C + slot.clamp(max=C - 1)
    return w_ecd.reshape(E * C, D)[idx] * kept


class _GatherDispatch(torch.autograd.Function):
    """(T, D) tokens -> (E, C, D) expert slots; the backward gathers
    each kept token's seat back (``expert``/``slot`` are the inverse
    seating map)."""

    @staticmethod
    def forward(ctx, x2d, table, expert, slot):
        ctx.save_for_backward(expert, slot)
        return _seat_gather(x2d, table)

    @staticmethod
    def backward(ctx, g):
        expert, slot = ctx.saved_tensors
        return _token_gather(g, expert, slot), None, None, None


class _CombinePerToken(torch.autograd.Function):
    """(E, C, D) slots -> (T, D): each token reads its seat. Equal to
    the scatter-add combine because the seating is a bijection; the
    backward is the dispatch gather applied to the cotangent."""

    @staticmethod
    def forward(ctx, w_ecd, table, expert, slot):
        ctx.save_for_backward(table)
        return _token_gather(w_ecd, expert, slot)

    @staticmethod
    def backward(ctx, g):
        (table,) = ctx.saved_tensors
        return _seat_gather(g, table), None, None, None


def _scatter_combine(weighted, table, T: int):
    """Scatter-add oracle of the per-token combine (tests only)."""
    E, C, D = weighted.shape
    y = torch.zeros((T + 1, D), dtype=weighted.dtype,
                    device=weighted.device)
    y.index_add_(0, table.reshape(-1), weighted.reshape(E * C, D))
    return y[:T]


def _expert_ffn(xe, mp):
    """Every expert's FFN on its dispatched slots (E, C, D): two batched
    products, ``be1`` and tanh-GELU (``jax.nn.gelu``'s default)."""
    a = F.gelu(torch.bmm(xe, mp["we1"]) + mp["be1"][:, None, :],
               approximate="tanh")
    return torch.bmm(a, mp["we2"])


def moe_ffn_dense(x: torch.Tensor, mp: dict, capacity_factor: float):
    """MoE FFN on (B, L, D) with every expert resident: ``(y, aux)``.
    Dropped tokens give zero rows (the caller's residual carries them);
    ``be2`` is added before the combine, so a dropped token sees no
    bias. The capacity comes from this call's token count."""
    B, L, D = x.shape
    E = mp["wg"].shape[1]
    T = B * L
    C = _capacity(T, E, capacity_factor)
    x2d = x.reshape(T, D)
    table, expert, slot, gate, aux = _route_tables(x2d, mp["wg"], C)
    xe = _GatherDispatch.apply(x2d, table, expert, slot)
    ye = _expert_ffn(xe, mp) + mp["be2"][:, None, :]
    yt = _CombinePerToken.apply(ye, table, expert, slot)
    kg = torch.where(slot < C, gate, 0.0).to(x.dtype)  # dropped -> 0
    y = yt * kg[:, None]
    return y.reshape(B, L, D), aux


def _capacity(tokens: int, n_experts: int, capacity_factor: float) -> int:
    return max(1, int(np.ceil(tokens / n_experts * capacity_factor)))
