"""Gradient-coded training of any parameter tree through the async pool.

Counterpart of ``mpistragglers_jl_tpu/models/coded_train.py``: the
fastest-k pool (``pool.py`` over ``backends/cuda.py``, a worker = a CUDA
stream) and the cyclic gradient code (``ops/gradcode.py``), lifted from
a flat weight vector (``models/logreg.py``, BASELINE config 5) to a
parameter tree such as the flagship transformer's:

* the per-epoch payload is the parameters raveled into one flat f32
  tensor, in the port's ``_leaves`` order (sorted dict keys, the order
  of ``ravel_pytree``);
* worker ``i`` holds its ``s+1`` cyclic data chunks on its device and,
  in its dispatcher thread under its stream, unravels the payload (each
  slice cast back to its leaf's dtype) and takes each chunk's gradient
  with ``torch.autograd.grad``, one chunk at a time, adding
  ``coeff_c * ravel(g_c)`` into one f32 vector. The chunks are not
  batched together: a mixture of experts sizes its capacity from the
  call's token count, so a batch of chunks would route differently;
* the coordinator decodes over the workers that arrived
  (``pool.fresh_indices()``) and applies plain SGD, or a torch
  optimizer built by ``tx`` (e.g. ``models.transformer.adamw``) that
  steps on the decoded gradient written into ``.grad``.

Under stragglers the trajectory is that of bulk-synchronous full-batch
training, up to the decode's float sums.

Observability is opt-in, as in the reference: ``tracer=`` (an
``utils/trace.py`` ``EpochTracer``) is passed to every
``asyncmap``/``waitall``; ``registry=`` records per-step wall clock,
which k of n workers each decode recovered from, and the tracer's
stale and re-task totals; ``spans=`` draws one span per step beside the
tracer's worker tracks in the merged Perfetto timeline.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..backends.base import DelayFn
from ..backends.cuda import CUDADeviceBackend, consume
from ..ops.gemm import resolve_devices
from ..ops.gradcode import GradientCode
from ..pool import AsyncPool, asyncmap, waitall
from .transformer import (
    TransformerConfig,
    _leaves,
    _rebuild,
    forward_dense,
    nll_loss,
)

__all__ = ["CodedGradTrainer", "transformer_chunk_loss"]


class _TrainObs:
    """Instrument bundle for one trainer, resolved once at construction
    (the reference's series and span): a dark trainer's step pays only
    ``is None`` checks."""

    def __init__(self, trainer: "CodedGradTrainer", registry, spans):
        self.registry = registry
        self.spans = spans
        self._r = registry is not None
        if not self._r:
            return
        registry.gauge(
            "train_workers", help="pool size n of the gradient code"
        ).set(trainer.n)
        registry.gauge(
            "train_code_tolerance",
            help="stragglers s the cyclic code absorbs",
        ).set(trainer.s)
        self.m_steps = registry.counter("train_steps_total")
        self.m_step_s = registry.histogram(
            "train_step_seconds",
            help="asyncmap -> decode -> update wall clock",
        )
        self.m_fresh_k = registry.gauge(
            "train_decode_fresh_k",
            help="fresh arrivals the last decode recovered from",
        )
        self.m_stale = registry.counter(
            "train_stale_arrivals_total",
            help="stale pool arrivals (bridged from the EpochTracer)",
        )
        self.m_retask = registry.counter(
            "train_retasks_total",
            help="immediate re-dispatches (bridged from the EpochTracer)",
        )
        self.m_recovered = [
            registry.counter(
                "train_worker_recovered_total",
                help="steps whose decode consumed this worker's shard",
                worker=str(i),
            )
            for i in range(trainer.n)
        ]

    def step_done(self, trainer: "CodedGradTrainer", fresh, t0: float,
                  epoch_rec) -> None:
        t1 = time.perf_counter()
        if self._r:
            self.m_steps.inc()
            self.m_step_s.observe(t1 - t0)
            self.m_fresh_k.set(len(fresh))
            for i in fresh:
                self.m_recovered[int(i)].inc()
            if epoch_rec is not None:
                self.m_stale.inc(epoch_rec.n_stale)
                self.m_retask.inc(epoch_rec.n_retask)
        if self.spans is not None:
            args = {"fresh_k": len(fresh)}
            if epoch_rec is not None:
                args["epoch"] = epoch_rec.epoch
                args["n_stale"] = epoch_rec.n_stale
                args["n_retask"] = epoch_rec.n_retask
            self.spans.add(
                f"coded step ({len(fresh)}/{trainer.n})", t0, t1 - t0,
                track="train", **args,
            )


def transformer_chunk_loss(cfg: TransformerConfig) -> Callable:
    """``loss(params, tokens)`` for :class:`CodedGradTrainer` chunks:
    next-token NLL of ``forward_dense`` over a ``(B, L+1)`` int token
    block (inputs ``[:, :-1]``, targets ``[:, 1:]``), in logsumexp form.
    As in the reference, no MoE aux loss is added."""

    def loss(params, tokens):
        tokens = torch.as_tensor(tokens, device=params["emb"].device)
        logits = forward_dense(params, tokens[:, :-1], cfg)
        return nll_loss(logits, tokens[:, 1:])

    return loss


def _tree_to(tree, device):
    """A chunk (a tensor, an array, or a dict/list of them) on
    ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return torch.as_tensor(tree).to(device)


class _Flat:
    """Ravel and unravel of one parameter tree's layout: leaves in
    ``_leaves`` order, one flat f32 vector."""

    def __init__(self, tree):
        leaves = _leaves(tree)
        self.skeleton = _rebuild(tree, iter(range(len(leaves))))
        self.shapes = [t.shape for t in leaves]
        self.dtypes = [t.dtype for t in leaves]
        self.sizes = [t.numel() for t in leaves]

    def ravel(self, tree, device) -> torch.Tensor:
        return torch.cat([t.detach().reshape(-1).to(device, torch.float32)
                          for t in _leaves(tree)])

    def split(self, flat: torch.Tensor) -> list:
        """Views of ``flat``, one per leaf, in the leaves' shapes."""
        return [v.view(s) for v, s in
                zip(torch.split(flat, self.sizes), self.shapes)]

    def leaves(self, flat: torch.Tensor) -> list:
        """The leaves of ``flat``, each cast back to its dtype (a view
        where the dtype is f32)."""
        return [v.to(dt) for v, dt in zip(self.split(flat), self.dtypes)]

    def tree(self, leaves) -> dict:
        return _rebuild(self.skeleton, iter(leaves))


class CodedGradTrainer:
    """Straggler-resilient exact-gradient training of a parameter tree.

    ``loss_fn(params, batch) -> scalar`` defines the model;
    ``chunk_fn(j) -> batch`` yields global data chunk ``j`` (equal shapes
    across chunks; one step optimizes the mean of the ``n`` chunk
    losses). Worker ``i`` holds chunks ``code.support(i)`` on its device
    from construction; epochs move only the flat parameters.

    >>> tr = CodedGradTrainer(loss, params0, chunk_fn, n_workers=8, s=2)
    >>> params, losses = tr.fit(epochs=20, lr=0.1)

    ``devices`` defaults to the card (``[resolve_device()]``, an error
    without one); ``[torch.device("cpu")]`` runs the workers' gradients
    in their dispatcher threads. ``tx`` (an optimizer factory such as
    ``models.transformer.adamw``) replaces plain SGD: the optimizer is
    built over the trainer's own copy of ``params0``'s tensors on the
    first device, and :meth:`step` copies the given parameters into
    them, steps, and returns them (updated in place).

    Observability (opt-in, no cost when omitted): ``tracer=`` (an
    ``EpochTracer``) threads through every ``asyncmap``/``waitall``;
    ``registry=`` and ``spans=`` as the module docstring says.
    """

    def __init__(
        self,
        loss_fn: Callable,
        params0,
        chunk_fn: Callable[[int], object],
        n_workers: int,
        s: int,
        *,
        devices: Sequence | None = None,
        delay_fn: DelayFn | None = None,
        tx=None,
        seed: int = 0,
        tracer=None,
        registry=None,
        spans=None,
    ):
        devices = resolve_devices(devices)
        self.n, self.s = int(n_workers), int(s)
        self.code = GradientCode(self.n, self.s, seed=seed)
        self.tx = tx
        self._loss_fn = loss_fn
        self._flat = _Flat(params0)
        self._flat0 = self._flat.ravel(params0, devices[0])

        # per-worker device-resident chunks and f32 code coefficients
        self._chunks = []
        for i in range(self.n):
            sup = self.code.support(i)
            dev = devices[i % len(devices)]
            chunks = [_tree_to(chunk_fn(j), dev) for j in sup]
            coeffs = [float(c) for c in
                      np.asarray(self.code.B[i, sup], np.float32)]
            self._chunks.append((chunks, coeffs))
        self.backend = CUDADeviceBackend(
            self._work, self.n, devices=devices, delay_fn=delay_fn
        )
        self.tracer = tracer
        self.last_fresh: np.ndarray = np.array([], dtype=np.int64)
        self._obs = (_TrainObs(self, registry, spans)
                     if registry is not None or spans is not None
                     else None)
        if tx is not None:
            self._held = [t.detach().to(devices[0], copy=True)
                          for t in _leaves(params0)]
            self.opt_state = tx(self._held)

    def _work(self, i: int, flat_w: torch.Tensor, epoch: int):
        """Worker ``i``'s coded gradient ``sum_c coeff_c * ravel(g_c)``
        (f32), one chunk's gradient at a time."""
        chunks, coeffs = self._chunks[i]
        leaves = [t.detach().requires_grad_(True)
                  for t in self._flat.leaves(flat_w)]
        params = self._flat.tree(leaves)
        out = torch.zeros_like(flat_w)
        parts = self._flat.split(out)
        for c, batch in zip(coeffs, chunks):
            with torch.enable_grad():
                grads = torch.autograd.grad(self._loss_fn(params, batch),
                                            leaves, allow_unused=True)
            with torch.no_grad():
                for o, g in zip(parts, grads):
                    if g is not None:
                        o.add_(g, alpha=c)
        return out

    def _decode(self, pool: AsyncPool, dev) -> torch.Tensor:
        """The exact mean-of-chunks gradient from the arrived workers.
        Records which of the n workers it came from in ``last_fresh``."""
        fresh = pool.fresh_indices()
        self.last_fresh = fresh
        a = torch.as_tensor(self.code.decode_weights(fresh),
                            dtype=torch.float32, device=dev)
        G = torch.stack([consume(pool.results[i]).to(dev) for i in fresh])
        return (a @ G) / self.n

    def step(self, pool: AsyncPool, params, *, lr: float | None = None,
             epoch: int | None = None, nwait: int | None = None):
        """One coded step: asyncmap, decode, update. Returns the updated
        parameter tree on the first device. ``nwait`` defaults to the
        code's tolerance ``n - s``; pass ``n`` for a bulk-synchronous
        baseline epoch."""
        if nwait is None:
            nwait = self.n - self.s
        if (lr is None) == (self.tx is None):
            raise ValueError(
                "pass lr for plain SGD, or construct with tx= for optax "
                "(exactly one of the two)"
            )
        obs = self._obs
        t0 = time.perf_counter() if obs is not None else 0.0
        dev = self.backend.devices[0]
        flat_w = self._flat.ravel(params, dev)
        asyncmap(pool, flat_w, self.backend, nwait=nwait, epoch=epoch,
                 tracer=self.tracer)
        g_flat = self._decode(pool, dev)
        if self.tx is None:
            out = self._flat.tree(self._flat.leaves(flat_w - lr * g_flat))
        else:
            with torch.no_grad():
                for p, src in zip(self._held, _leaves(params)):
                    if p is not src:
                        p.copy_(src)
            for p, g in zip(self._held, self._flat.leaves(g_flat)):
                p.grad = g
            self.opt_state.step()
            for p in self._held:
                p.grad = None
            out = self._flat.tree(self._held)
        if obs is not None:
            obs.step_done(
                self, self.last_fresh, t0,
                self.tracer.records[-1]
                if self.tracer is not None and self.tracer.records
                else None,
            )
        return out

    def full_batch_loss(self, params) -> float:
        """Mean chunk loss over all n chunks, each counted once (worker
        i's first chunk is chunk i), on the first device."""
        dev = self.backend.devices[0]
        params = _tree_to(params, dev)
        total = 0.0
        with torch.no_grad():
            for chunks, _ in self._chunks:
                total += float(self._loss_fn(params,
                                             _tree_to(chunks[0], dev)))
        return total / self.n

    def fit(self, epochs: int, params=None, *, lr: float | None = None,
            eval_every: int | None = 1):
        """Run coded training; returns (params, loss history). The
        history records :meth:`full_batch_loss` every ``eval_every``
        epochs (None disables it). Ends by draining the stragglers
        (``waitall``), so the backend can be used again."""
        pool = AsyncPool(self.n)
        if params is None:
            params = self._flat.tree(self._flat.leaves(self._flat0))
        history = []
        for e in range(1, epochs + 1):
            params = self.step(pool, params, lr=lr)
            if eval_every is not None and e % eval_every == 0:
                history.append(self.full_batch_loss(params))
        waitall(pool, self.backend, tracer=self.tracer)
        return params, history
