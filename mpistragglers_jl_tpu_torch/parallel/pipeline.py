"""Pipeline parallelism over a ``("dp", "pp")`` mesh, single-controller.

The port of the JAX package's ``parallel/pipeline.py``. The model's
layers are stacked along a leading axis and split over ``pp`` (each
stage holds ``n_layers / pp`` contiguous layers, or, for the circular
schedule, ``v`` interleaved chunks); the batch is split over ``dp`` and
each replica's batch into ``M`` microbatches. Three schedules:

* **GPipe** (:func:`pipeline_spmd`): ``M + pp - 1`` ticks; at tick t
  stage 0 takes microbatch t, every stage applies its layers to the
  payload it holds and hands it to the next stage. The backward is one
  autograd pass through the whole schedule (the handoffs are
  :func:`.collectives.ring_shift`, the output's replication a
  :func:`.collectives.psum`), so activation memory grows with ``M``.
* **circular** (:func:`pipeline_circular`): ``v`` chunks per stage,
  device-major (stage d holds chunks d, pp+d, ...); a stage counter
  rides with each payload, microbatches lap the ring ``v`` times, and
  the fill/drain bubble shrinks by about ``v``. Dense stages only.
* **1F1B** (:func:`pipeline_1f1b`): the loss head sits on the last
  stage, so a microbatch's backward starts the tick its forward leaves
  the pipeline; each tick runs one forward and one backward slot per
  stage. The backward slot recomputes the stage from a ring of ``2 pp
  - 1`` saved inputs and takes ``torch.autograd.grad`` of the stage
  with the incoming cotangent, so no graph outlives its tick (the 1F1B
  memory property). The payload is ``(activation, aux)``: an MoE
  stage's load-balance loss rides it to the head, and every backward
  slot passes ``dL/d aux`` along with ``dL/dy``.

The reference runs each schedule as one ``lax.scan`` inside
``shard_map``, every stage applying its layers on every tick and the
bubble masked by ``where``. Here each tick is a loop over the mesh's
ranks that runs only the slots the schedule marks live (the same
values, fewer launches); the live flags are the schedule's own state,
carried around the ring with the payloads, and :func:`measure_bubble`
returns them: masks equal to JAX's. A tick's handoffs move after every
rank's slot has run, so no stage reads a buffer written in the same
tick.

Gradients: GPipe and circular take the single-controller rule of
``models/transformer.py`` (one rank's loss copy, one backward, each
leaf summed over the axes its spec does not name). 1F1B takes the
reference's sums instead (stage gradients over dp, head gradients and
the embedding's over dp and pp, divided by the token count), in f32.

**Across processes.** Over a mesh that spans processes (``pp`` or
``dp`` crossing them) the schedule's state, which slots are live and
which stage counter rides where, is kept for every flat rank on every
process: it is Python state that follows from the tick alone, so every
process computes the same copy and decides nothing from its own ranks.
Tensors (payloads, outputs, gradients) are kept for this process's
positions only (``Mesh.local_ranks``). A hop names its senders from
that state (``ring_shift``'s ``sends``) and the payload's shape and
dtype from the microbatch, so a process whose ranks send nothing at a
tick still enters the exchange that another process's ranks need, and
a hop in which no rank sends moves nothing anywhere. The autodiff
schedules take their backward inside ``crossing_chain`` (the one
backward of ``models/transformer.py``), so a stage whose own loss copy
does not reach its hops still runs their backward exchanges, in the
forward's order. 1F1B's slots are local: each backward slot's
``torch.autograd.grad`` crosses no process, and every process runs its
ranks' slots tick by tick in flat-rank order.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..models.transformer import (
    _laid_out,
    _layer,
    _leaves,
    _ln,
    _local_attention,
    _nll,
    _optax_step,
    _rebuild,
    _replica_loss_and_grads,
    _sgd_step,
    _shards_requiring_grad,
    nll_loss,
)
from .collectives import psum, ring_shift
from .mesh import PartitionSpec as P
from .mesh import from_local, shard

__all__ = [
    "pipeline_spmd",
    "pipeline_1f1b",
    "pipeline_circular",
    "pipeline_param_specs_circular",
    "bubble_fraction",
    "measure_bubble",
    "stack_layers",
    "make_pipeline_train_step",
    "make_optax_pipeline_train_step",
    "pipeline_param_specs",
    "shard_params_pipeline",
]


def _micro(x, M: int):
    """(B, ...) -> (M, B/M, ...), or the reference's ValueError."""
    B = x.shape[0]
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by n_microbatch {M}")
    return x.reshape(M, B // M, *x.shape[1:])


def _hop_flags(flags, mesh) -> list:
    """Per-rank Python values, one per flat rank of the mesh, moved one
    hop along ``pp`` (the schedule's state riding the ring beside its
    payloads; every process holds all of it)."""
    out = list(flags)
    for group in mesh.axis_groups("pp"):
        for c, r in enumerate(group):
            out[r] = flags[group[c - 1]]
    return out


def _replicate(outs, idx, owner, mesh, micro):
    """The stacked (M, ...) output of the ranks at coordinate ``owner``
    psummed over ``pp`` (zeros elsewhere, of the microbatches' (M, ...)
    form ``micro``, which every stage's output keeps): every stage gets
    it. ``outs`` holds this process's positions."""
    ranks = mesh.local_ranks()
    return psum([torch.stack(o) if idx[r] == owner else
                 torch.zeros_like(micro, device=mesh.devices.flat[r])
                 for r, o in zip(ranks, outs)], mesh, "pp")


def pipeline_spmd(stage_fn, stage_params: list, x: list, *, mesh,
                  n_microbatch: int, return_busy: bool = False):
    """Run each rank's local batch ``x[r]`` through the pp stages of
    ``stage_fn(stage_params[r], micro) -> micro`` (GPipe; the output
    keeps the microbatch's shape and dtype). The lists hold this
    process's positions (``mesh.local_ranks()``). ``x`` is identical
    over a pp group (only stage 0 reads it). Returns each rank's
    full-batch output, replicated over ``pp``, and with ``return_busy``
    every flat rank's (T,) busy mask, ``T = M + pp - 1``."""
    p, idx, n = mesh.shape["pp"], mesh.axis_index("pp"), mesh.size
    ranks = mesh.local_ranks()
    M = int(n_microbatch)
    micro = [_micro(xr, M) for xr in x]
    like = micro[0][0]
    buf, live = [None] * len(ranks), [False] * n
    outs = [[None] * M for _ in ranks]
    busy = [[] for _ in range(n)]
    for t in range(M + p - 1):
        for r in range(n):
            if idx[r] == 0:  # stage 0 ingests microbatch t
                live[r] = t < M
        for i, r in enumerate(ranks):
            if idx[r] == 0:
                buf[i] = micro[i][min(t, M - 1)]
        y = [stage_fn(stage_params[i], buf[i]) if live[r] else None
             for i, r in enumerate(ranks)]
        for i, r in enumerate(ranks):
            if idx[r] == p - 1 and live[r]:
                # the last stage emits microbatch t - (p - 1)
                outs[i][t - (p - 1)] = y[i]
                y[i] = None  # the wrap hop is overwritten by injection
        for r in range(n):
            busy[r].append(live[r])
        sends = [live[r] and idx[r] != p - 1 for r in range(n)]
        buf = ring_shift(y, mesh, "pp", sends=sends, like=like)
        live = _hop_flags(live, mesh)
    out = [o.reshape(xr.shape[0], *o.shape[2:]) for o, xr in
           zip(_replicate(outs, idx, p - 1, mesh, micro[0]), x)]
    if return_busy:
        return out, [np.asarray(b, dtype=bool) for b in busy]
    return out


def stack_layers(layers: list[dict]) -> dict:
    """A list of per-layer dicts -> one dict of stacked tensors (the
    leading dim is the layer)."""
    return {k: torch.stack([lp[k] for lp in layers]) for k in layers[0]}


def bubble_fraction(pp: int, n_microbatch: int,
                    schedule: str = "1f1b") -> float:
    """Fraction of pipeline ticks that are bubble (no useful work).

    * ``"1f1b"``: ``2(pp-1) / (M + 2(pp-1))`` (M forward and M backward
      slots per stage over ``M + 2(pp-1)`` ticks);
    * ``"gpipe"``: ``(pp-1) / (M + pp - 1)``, the same each way;
    * ``"circular:v"``: ``(pp-1) / (v M + pp - 1)`` (``"circular"``
      is v = 2).
    """
    p, M = int(pp), int(n_microbatch)
    if schedule == "1f1b":
        return 2 * (p - 1) / (M + 2 * (p - 1))
    if schedule == "gpipe":
        return (p - 1) / (M + p - 1)
    if schedule == "circular" or (
        schedule.startswith("circular:")
        and schedule.split(":", 1)[1].isdigit()
    ):
        v = int(schedule.split(":", 1)[1]) if ":" in schedule else 2
        return (p - 1) / (v * M + p - 1)
    raise ValueError(f"unknown schedule {schedule!r}")


def measure_bubble(mesh, n_microbatch: int, schedule: str = "1f1b", *,
                   v: int = 2) -> dict:
    """Run a schedule on a tiny payload and return its measured idle
    fraction beside :func:`bubble_fraction`: ``{"schedule", "pp",
    "n_microbatch", "ticks", "measured", "formula", "busy"}``, ``busy``
    the (pp, T[, 2]) mask of one pp group (the schedule's live state,
    as it ran), ``measured`` = 1 - mean(busy). The circular engine
    spends one emission hop past ``v M + pp - 1`` ticks, so its measured
    value exceeds the formula by that gap."""
    p, M = mesh.shape["pp"], int(n_microbatch)
    devs = mesh.local_devices()
    x = [torch.arange(M * 2, dtype=torch.float32, device=d).reshape(M, 2)
         for d in devs]

    def w(value):
        return [{"w": torch.tensor(value, device=d, requires_grad=True)}
                for d in devs]

    if schedule == "1f1b":
        *_, busy = pipeline_1f1b(
            lambda sp, pl: (pl[0] * sp["w"], pl[1]),
            lambda hp, pl, t: (pl[0] * hp["w"]).sum(),
            w(1.001), w(1.0), x, x, mesh=mesh, n_microbatch=M,
            return_busy=True)
        name = "1f1b"
    elif schedule == "gpipe":
        with torch.no_grad():
            _, busy = pipeline_spmd(
                lambda sp, m: m * sp["w"], w(1.001), x, mesh=mesh,
                n_microbatch=M, return_busy=True)
        name = "gpipe"
    elif schedule == "circular":
        with torch.no_grad():
            _, busy = pipeline_circular(
                lambda cp, j, m: m * cp["w"], w(1.001), x, mesh=mesh,
                n_microbatch=M, v=v, return_busy=True)
        name = f"circular:{v}"
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    group = mesh.axis_groups("pp")[0]  # coordinate order along pp
    busy = np.stack([busy[r] for r in group])
    return {
        "schedule": name,
        "pp": p,
        "n_microbatch": M,
        "ticks": int(busy.shape[1]),
        "measured": float(1.0 - busy.mean()),
        "formula": bubble_fraction(p, M, name),
        "busy": busy,
    }


def pipeline_circular(chunk_fn, chunk_params: list, x: list, *, mesh,
                      n_microbatch: int, v: int = 2,
                      return_busy: bool = False):
    """Interleaved virtual stages: each rank holds ``v`` chunks
    (device-major: its local chunk ``j`` is global chunk ``j pp + d``)
    and ``chunk_fn(chunk_params[r], j, micro) -> micro`` applies its
    ``j``-th (keeping the microbatch's shape and dtype). The lists hold
    this process's positions. A payload's stage counter ``s`` rides with
    it (``s < v pp`` live, next chunk ``s``; ``v pp`` finished; ``v pp
    + 1`` an empty slot); stage 0 emits a finished arrival and refills
    the freed slot, so each rank hosts one microbatch a tick.
    ``n_microbatch`` must divide the batch and be a multiple of pp.
    Returns the outputs replicated over ``pp`` and, with
    ``return_busy``, every flat rank's (T,) mask, ``T = v M + pp``."""
    p, idx, n = mesh.shape["pp"], mesh.axis_index("pp"), mesh.size
    ranks = mesh.local_ranks()
    M = int(n_microbatch)
    micro = [_micro(xr, M) for xr in x]
    if M % p != 0:
        raise ValueError(
            f"n_microbatch {M} must be a multiple of the pipeline size "
            f"{p} (seamless circular waves need full ring occupancy)")
    C = v * p
    like = micro[0][0]
    buf, s = [None] * len(ranks), [C + 1] * n
    inj, emit = [0] * n, [0] * n  # only stage 0's advance (FIFO ids)
    outs = [[None] * M for _ in ranks]
    at = {r: i for i, r in enumerate(ranks)}
    busy = [[] for _ in range(n)]
    for _ in range(v * M + p):
        for r in range(n):
            if idx[r] != 0:
                continue
            # stage 0: emit a finished arrival, refill the freed slot
            i = at.get(r)
            done = s[r] == C
            if done and emit[r] < M:
                if i is not None:
                    outs[i][emit[r]] = buf[i]
                emit[r] += 1
            if s[r] >= C and inj[r] < M:
                if i is not None:
                    buf[i] = micro[i][inj[r]]
                s[r] = 0
                inj[r] += 1
            elif done:  # a consumed finished slot parks as empty
                if i is not None:
                    buf[i] = None
                s[r] = C + 1
        live = [s_ < C for s_ in s]
        for r in range(n):
            busy[r].append(live[r])
        for i, r in enumerate(ranks):
            if live[r]:
                buf[i] = chunk_fn(chunk_params[i], s[r] // p, buf[i])
        for r in range(n):
            if live[r]:
                s[r] += 1
        # a slot holds a payload (live, finished or not) unless empty
        buf = ring_shift(buf, mesh, "pp", sends=[s_ <= C for s_ in s],
                         like=like)
        s = _hop_flags(s, mesh)
    out = [o.reshape(xr.shape[0], *o.shape[2:]) for o, xr in
           zip(_replicate(outs, idx, 0, mesh, micro[0]), x)]
    if return_busy:
        return out, [np.asarray(b, dtype=bool) for b in busy]
    return out


def _vjp(outputs, inputs, grad_outputs):
    """One backward slot's ``torch.autograd.grad`` (unused inputs get
    None)."""
    return torch.autograd.grad(outputs, inputs, grad_outputs=grad_outputs,
                               allow_unused=True)


def _f32_zeros(leaves) -> list:
    return [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for t in leaves]


def _add(acc, grads) -> None:
    """Accumulate ``grads`` (None for an unused input) into the f32
    list ``acc``."""
    for a, g in zip(acc, grads):
        if g is not None:
            a += g.float()


def _detached_requiring_grad(payload):
    return tuple(a.detach().requires_grad_(True) for a in payload)


def pipeline_1f1b(stage_fn, head_fn, stage_params: list, head_params: list,
                  x: list, targets: list, *, mesh, n_microbatch: int,
                  return_busy: bool = False):
    """One-forward-one-backward pipeline step over per-rank lists.

    ``stage_fn(stage_params[r], payload) -> payload``, the payload a
    tuple (here ``(activation, aux)``); ``head_fn(head_params[r],
    payload, tgt_micro) -> scalar`` (summed over the microbatch, not
    meaned). ``x[r]`` is the rank's local batch of activations,
    ``targets[r]`` its targets; the lists hold this process's positions
    (``mesh.local_ranks()``). Every leaf of the parameter trees must
    require grad, and a stage's payload keeps the shapes and dtypes of
    ``(microbatch, f32 scalar)``. On stage d at tick t, ``T = M +
    2(pp-1)`` ticks:

    * forward slot: microbatch ``f = t - d``; stage 0 injects
      ``(x[f], 0)``, the input goes to the ring, the stage runs without
      a graph; the last stage runs the head and takes its loss, head
      gradients and ``(dL/dy, dL/d aux)``;
    * backward slot: microbatch ``b = t - (2 pp - 2 - d)``: the stage is
      recomputed from the ring's input and differentiated with the
      incoming cotangent (the last stage's own, else the one handed
      back from stage d+1); stage 0 keeps ``dL/dx`` of its microbatch.

    Activations then hop to d+1 and cotangents to d-1. Returns lists
    over this process's positions ``(loss_sum, stage_grads, head_grads,
    dx)``: local f32 sums (loss and head gradients nonzero on the last
    stage, ``dx`` (M, ...) on stage 0, else None), gradients as lists in
    the trees' leaf order; with ``return_busy`` also every flat rank's
    (T, 2) mask of live forward and backward slots."""
    p, idx, n = mesh.shape["pp"], mesh.axis_index("pp"), mesh.size
    ranks = mesh.local_ranks()
    M = int(n_microbatch)
    micro = [_micro(xr, M) for xr in x]
    tgt = [_micro(tr, M) for tr in targets]
    R = 2 * p - 1  # the residual ring covers the in-flight window
    s_leaves = [_leaves(sp) for sp in stage_params]
    h_leaves = [_leaves(hp) for hp in head_params]
    ring = [[None] * R for _ in ranks]
    buf_f, buf_b = [None] * len(ranks), [None] * len(ranks)
    loss = [torch.zeros((), dtype=torch.float32, device=xr.device)
            for xr in x]
    like = (micro[0][0], loss[0])  # the payload's and cotangent's form
    g_stage = [_f32_zeros(ls) for ls in s_leaves]
    g_head = [_f32_zeros(lh) for lh in h_leaves]
    dx = [torch.zeros(micro[i].shape, dtype=torch.float32,
                      device=x[i].device) if idx[r] == 0 else None
          for i, r in enumerate(ranks)]

    def slots(t, r):
        d = idx[r]
        f, b = t - d, t - (2 * p - 2 - d)
        return f, b, 0 <= f < M, 0 <= b < M

    busy = [[slots(t, r)[2:] for t in range(M + 2 * (p - 1))]
            for r in range(n)]
    for t in range(M + 2 * (p - 1)):
        ys, gxs = [None] * len(ranks), [None] * len(ranks)
        for i, r in enumerate(ranks):
            d = idx[r]
            f, b, f_live, b_live = slots(t, r)
            dy = None
            if f_live:
                p_in = ((micro[i][f], torch.zeros_like(loss[i])) if d == 0
                        else buf_f[i])
                ring[i][f % R] = p_in
                with torch.no_grad():
                    y = stage_fn(stage_params[i], p_in)
                if d == p - 1:  # the head: loss and dL/dy this tick
                    with torch.enable_grad():
                        y_in = _detached_requiring_grad(y)
                        lf = head_fn(head_params[i], y_in, tgt[i][f])
                        g = _vjp(lf, h_leaves[i] + list(y_in), None)
                    loss[i] = loss[i] + lf.detach().float()
                    nh = len(h_leaves[i])
                    _add(g_head[i], g[:nh])
                    dy = tuple(torch.zeros_like(a) if ga is None else ga
                               for ga, a in zip(g[nh:], y_in))
                else:
                    ys[i] = y
            if b_live:
                g_in = dy if d == p - 1 else buf_b[i]
                with torch.enable_grad():
                    x_in = _detached_requiring_grad(ring[i][b % R])
                    out = stage_fn(stage_params[i], x_in)
                    g = _vjp(out, s_leaves[i] + list(x_in), g_in)
                ns = len(s_leaves[i])
                _add(g_stage[i], g[:ns])
                g_x = tuple(torch.zeros_like(a) if ga is None else ga
                            for ga, a in zip(g[ns:], x_in))
                if d == 0:  # the embedding's cotangent of microbatch b
                    dx[i][b] = g_x[0]
                else:
                    gxs[i] = g_x
        # who sends, from the schedule: forward slots short of the head,
        # backward slots past stage 0
        fwd = [slots(t, r)[2] and idx[r] != p - 1 for r in range(n)]
        bwd = [slots(t, r)[3] and idx[r] != 0 for r in range(n)]
        buf_f = _hop_payloads(ys, mesh, 1, fwd, like)
        buf_b = _hop_payloads(gxs, mesh, -1, bwd, like)
    out = (loss, g_stage, g_head, dx)
    if return_busy:
        return out + ([np.asarray(b_, dtype=bool) for b_ in busy],)
    return out


def _hop_payloads(payloads, mesh, shift, sends, like) -> list:
    """Tuples of tensors (None: nothing to send) one hop along ``pp``
    (``shift`` 1 forward, -1 back), element by element. ``sends`` (per
    flat rank) and ``like`` (the tuple's form) come from the schedule,
    so every process makes the same hops: none when no rank sends."""
    if not any(sends):
        return [None] * len(payloads)
    parts = [ring_shift([None if pl is None else pl[i] for pl in payloads],
                        mesh, "pp", shift=shift, sends=sends, like=lk)
             for i, lk in enumerate(like)]
    return [None if parts[0][i] is None else tuple(pt[i] for pt in parts)
            for i in range(len(payloads))]


# ---------------------------------------------------------------- model


def _stage_apply_payload(stacked_local, payload, cfg):
    """This stage's layers on one microbatch's ``(activation, aux)``:
    each layer of the stacked local dict in turn; an MoE layer runs its
    experts dense inside the stage and adds its load-balance loss to the
    payload's aux, which rides to the head."""
    x, aux = payload
    pos = torch.arange(x.shape[1], device=x.device)
    attn_fn = _local_attention(cfg)
    for i in range(next(iter(stacked_local.values())).shape[0]):
        lp = {k: a[i] for k, a in stacked_local.items()}
        x, a = _layer(x, lp, pos, attn_fn, cfg)
        if a is not None:
            aux = aux + a
    return x, aux


def _stage_apply(stacked_local, x, cfg):
    """The activation-only view of :func:`_stage_apply_payload` (the
    autodiff schedules)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return _stage_apply_payload(stacked_local, (x, zero), cfg)[0]


def _head_loss_sum(head_params, payload, tgt, cfg):
    """Final LayerNorm, tied logits and the SUMMED token NLL of one
    microbatch (normalised once, outside), plus the MoE aux term: the
    aux weighted by the microbatch's token count, so it normalises like
    the NLL sum."""
    y, aux = payload
    h = _ln(y, head_params["lnf_s"], head_params["lnf_b"])
    nll = _nll(torch.einsum("bld,vd->blv", h, head_params["emb"]), tgt)
    loss = nll.sum()
    if cfg.n_experts and cfg.moe_aux_coef:
        loss = loss + cfg.moe_aux_coef * aux * nll.numel()
    return loss


def pipeline_param_specs(cfg) -> dict:
    """Specs of the stacked tree: every layer leaf split over ``pp`` on
    its leading (layer) axis, the experts' tables included; the
    embedding and final LayerNorm replicated."""
    layer_keys = ["ln1_s", "ln1_b", "wq", "wk", "wv", "wo", "ln2_s",
                  "ln2_b"]
    if cfg.n_experts:
        layer_keys += ["wg", "we1", "be1", "we2", "be2"]
    else:
        layer_keys += ["w1", "b1", "w2", "b2"]
    return {
        "emb": P(),
        "layers": {k: P("pp") for k in layer_keys},
        "lnf_s": P(),
        "lnf_b": P(),
    }


def _check_dense(cfg):
    if cfg.n_experts:
        raise NotImplementedError(
            'the fill/drain "gpipe" schedule runs dense stages only; '
            'MoE stages are pipeline-legal under schedule="1f1b" '
            "(expert aux loss rides the 1F1B payload to the head)"
        )


def _chunk_apply(local_chunks, j, x, cfg, v):
    """The circular schedule's chunk ``j`` of a rank's local chunks,
    laid out (1, v, layers_per_chunk, ...)."""
    leaf = next(iter(local_chunks.values()))
    if leaf.shape[1] != v:
        # an index past the layout would apply a prefix of the chunks
        raise ValueError(
            f"params are laid out with {leaf.shape[1]} virtual stages "
            f"per device but the schedule runs v={v}; pass the same "
            "virtual_stages to shard_params_pipeline and "
            "make_pipeline_train_step"
        )
    return _stage_apply({k: a[0, j] for k, a in local_chunks.items()}, x,
                        cfg)


def pipeline_param_specs_circular(cfg) -> dict:
    """Specs of the circular layout: the stacked layers reorganised
    device-major to ``(pp, v, layers_per_chunk, ...)`` and split on the
    leading axis. Dense stages only."""
    _check_dense(cfg)
    return pipeline_param_specs(cfg)


def _pipeline_loss_local(lparams, ltokens, ltargets, cfg, mesh,
                         n_microbatch, engine=None):
    """Each rank's copy of the dp-mean NLL: embed, the pipeline engine
    (GPipe by default), LayerNorm, tied logits."""
    xs = [lp["emb"][t] for lp, t in zip(lparams, ltokens)]
    layers = [lp["layers"] for lp in lparams]
    if engine is None:
        xs = pipeline_spmd(partial(_stage_apply, cfg=cfg), layers, xs,
                           mesh=mesh, n_microbatch=n_microbatch)
    else:
        xs = engine(layers, xs)
    logits = [torch.einsum("bld,vd->blv", _ln(x, lp["lnf_s"], lp["lnf_b"]),
                           lp["emb"]) for x, lp in zip(xs, lparams)]
    return nll_loss(logits, ltargets, ("dp",), mesh)


def _circular_loss_local(lparams, ltokens, ltargets, cfg, mesh,
                         n_microbatch, v):
    return _pipeline_loss_local(
        lparams, ltokens, ltargets, cfg, mesh, n_microbatch,
        engine=lambda layers, xs: pipeline_circular(
            partial(_chunk_apply, cfg=cfg, v=v), layers, xs, mesh=mesh,
            n_microbatch=n_microbatch, v=v))


def _1f1b_loss_grads_local(lparams, ltokens, ltargets, cfg, mesh,
                           n_microbatch):
    """Per-rank 1F1B step: (each rank's copy of the mean loss, each
    rank's gradient tree in the leaves' dtypes). Stage gradients are
    summed over dp, the head's and the embedding's over (dp, pp), all
    divided by the dp-summed token count, in f32."""
    head = [{"emb": lp["emb"], "lnf_s": lp["lnf_s"], "lnf_b": lp["lnf_b"]}
            for lp in lparams]
    with torch.no_grad():  # the embedding's gradient is dx's index_add
        xs = [lp["emb"][t] for lp, t in zip(lparams, ltokens)]
    loss_sum, g_stage, g_head, dx = pipeline_1f1b(
        partial(_stage_apply_payload, cfg=cfg),
        partial(_head_loss_sum, cfg=cfg),
        [lp["layers"] for lp in lparams], head, xs, ltargets, mesh=mesh,
        n_microbatch=n_microbatch)
    # tokens are pp-replicated: each position's count is its dp group's
    # (every dp member holds an equal block of the batch)
    total = float(ltargets[0].numel() * mesh.shape["dp"])
    both = ("dp", "pp")
    loss = [s_ / total for s_ in psum(loss_sum, mesh, both)]
    # the embedding: the head's part plus the lookup's (dx on stage 0)
    hk = sorted(head[0])
    e = hk.index("emb")
    for i, lp in enumerate(lparams):
        if dx[i] is not None:
            D = lp["emb"].shape[-1]
            g_head[i][e].index_add_(0, ltokens[i].reshape(-1).long(),
                                    dx[i].reshape(-1, D))
    heads = [psum([g[j] for g in g_head], mesh, both)
             for j in range(len(hk))]
    stages = [psum([g[j] for g in g_stage], mesh, "dp")
              for j in range(len(g_stage[0]))]
    out = []
    for i, lp in enumerate(lparams):
        grads = {k: h[i] / total for k, h in zip(hk, heads)}
        grads["layers"] = _rebuild(lp["layers"], iter(
            st[i] / total for st in stages))
        out.append(_rebuild(lp, iter(
            g.to(p_.dtype) for g, p_ in zip(_leaves(grads), _leaves(lp)))))
    return loss, out


def _pipeline_grad_fn(cfg, mesh, n_microbatch: int, schedule: str,
                      virtual_stages: int):
    """``(params, tokens, targets) -> (loss, grads)`` over the (dp, pp)
    mesh for any schedule: the gradient half of both train steps.
    ``loss`` is flat rank 0's copy; ``grads`` a tree of ShardedTensor
    laid out as ``params``."""
    if schedule == "circular":
        _check_dense(cfg)
        v = int(virtual_stages)
        if cfg.n_layers % (v * mesh.shape["pp"]) != 0:
            raise ValueError(
                f"n_layers {cfg.n_layers} not divisible by v*pp = "
                f"{v * mesh.shape['pp']}")
        specs = pipeline_param_specs_circular(cfg)
        local = partial(_circular_loss_local, v=v)
    elif schedule == "gpipe":
        _check_dense(cfg)
        specs, local = pipeline_param_specs(cfg), _pipeline_loss_local
    elif schedule == "1f1b":
        specs, local = pipeline_param_specs(cfg), None
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    how = "shard_params_pipeline(params, cfg, mesh)"

    def grad_fn(params, tokens, targets):
        leaves = _laid_out(params, specs, mesh, how)
        toks = _data_locals(tokens, mesh)
        tgts = _data_locals(targets, mesh)
        if local is not None:
            return _replica_loss_and_grads(
                params, leaves, mesh,
                lambda lp: local(lp, toks, tgts, cfg, mesh, n_microbatch))
        with _shards_requiring_grad(leaves, mesh) as shards:
            lparams = [_rebuild(params, iter(s_[i] for s_ in shards))
                       for i in range(len(mesh.local_ranks()))]
            loss, grads = _1f1b_loss_grads_local(lparams, toks, tgts, cfg,
                                                 mesh, n_microbatch)
        per_rank = [_leaves(g) for g in grads]
        out = [from_local(mesh, leaf.spec, [g[i] for g in per_rank],
                          leaf.shape) for i, leaf in enumerate(leaves)]
        return loss[0], _rebuild(params, iter(out))

    return grad_fn


def _data_locals(x, mesh) -> list:
    """Each local position's block of a (B, L) token array split over
    dp."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return [b.long() for b in shard(t, mesh, P("dp")).locals()]


def _check_mesh(cfg, mesh):
    missing = [a for a in ("dp", "pp") if a not in mesh.axis_names]
    if missing:
        raise ValueError(
            f"the pipeline runs over ('dp', 'pp') mesh axes; mesh "
            f"{dict(mesh.shape)} lacks {missing}")
    pp = mesh.shape["pp"]
    if cfg.n_layers % pp != 0:
        raise ValueError(
            f"n_layers {cfg.n_layers} not divisible by pp size {pp}")
    mesh.local_ranks()  # every process of the mesh in the job


def make_pipeline_train_step(cfg, mesh, *, n_microbatch: int,
                             lr: float = 1e-2, schedule: str = "1f1b",
                             virtual_stages: int = 2, donate: bool = False):
    """``(params, tokens, targets) -> (params, loss)`` SGD step over a
    (dp, pp) mesh: the batch over ``dp``, the layer stack over ``pp``.
    ``schedule`` is ``"1f1b"`` (MoE stages legal), ``"gpipe"`` or
    ``"circular"`` (``virtual_stages`` chunks per stage; dense).
    ``params`` come from :func:`shard_params_pipeline` (with the same
    ``virtual_stages`` for ``"circular"``); ``tokens`` and ``targets``
    are global (B, L) arrays. Attention runs per stage over the whole
    sequence (``cfg.attn_impl``: ``"flash"`` launches K1-K3 in every
    stage). ``donate`` as :func:`..models.transformer.make_train_step`."""
    _check_mesh(cfg, mesh)
    return _sgd_step(_pipeline_grad_fn(cfg, mesh, n_microbatch, schedule,
                                       virtual_stages), lr, donate)


def make_optax_pipeline_train_step(cfg, mesh, tx, *, n_microbatch: int,
                                   schedule: str = "1f1b",
                                   virtual_stages: int = 2):
    """The pipeline step driving a torch optimizer (``tx`` a factory
    such as ``models.transformer.adamw``). Returns ``(step,
    init_state)`` as :func:`..models.transformer.make_optax_train_step`:
    each moment lives beside its stage's shard."""
    _check_mesh(cfg, mesh)
    return _optax_step(_pipeline_grad_fn(cfg, mesh, n_microbatch, schedule,
                                         virtual_stages), tx)


def shard_params_pipeline(params: dict, cfg, mesh, *,
                          virtual_stages: int | None = None) -> dict:
    """Stack the per-layer parameters and lay them out over the mesh.

    ``virtual_stages=None``: the contiguous stage layout, the layer axis
    over ``pp`` (GPipe and 1F1B). ``virtual_stages=v`` (circular): the
    stacked layers reorganised to ``(pp, v, layers_per_chunk, ...)`` so
    stage d holds chunks ``d, pp + d, ..., (v-1) pp + d``."""
    stacked = dict(params)
    stacked["layers"] = stack_layers(params["layers"])
    specs = pipeline_param_specs(cfg)
    if virtual_stages is not None:
        v = int(virtual_stages)
        pp = mesh.shape["pp"]
        L = cfg.n_layers
        if L % (v * pp) != 0:
            raise ValueError(
                f"n_layers {L} not divisible by v*pp = {v * pp}")
        lpc = L // (v * pp)

        def devmajor(a):
            # (L, ...) -> (v, pp, lpc, ...) -> (pp, v, lpc, ...): chunk
            # j*pp + d lands at [d, j]
            a = a.reshape(v, pp, lpc, *a.shape[1:])
            return a.transpose(0, 1).contiguous()

        stacked["layers"] = {k: devmajor(a)
                             for k, a in stacked["layers"].items()}
        specs = pipeline_param_specs_circular(cfg)
    return _rebuild(stacked, iter(
        shard(x, mesh, s_) for x, s_ in zip(_leaves(stacked),
                                            _leaves(specs))))
