"""Gradient-coded mini-batch SGD on logistic regression.

The port of the JAX package's ``models/logreg.py``. BASELINE config 5:
logistic regression on synthetic data, gradient-coded ``asyncmap``,
convergence vs wall-clock under injected stragglers. Every epoch is one
``asyncmap`` call with ``nwait = n - s``, and the update uses the
gradient-code decoder (ops/gradcode.py) over whichever workers arrived,
giving the *exact* full-batch gradient despite stragglers.

Worker layout: worker i holds its s+1 cyclic data chunks device-resident
(placed once at setup); the per-epoch payload is just the weight vector.
The per-worker work is the forward, the gradient and the coded linear
combination of its chunk gradients, batched over the s+1 chunks.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..backends.base import DelayFn
from ..backends.cuda import CUDADeviceBackend, consume
from ..ops.gemm import resolve_devices
from ..ops.gradcode import GradientCode
from ..pool import AsyncPool, asyncmap, waitall

__all__ = ["LogisticRegression", "CodedSGD"]


def _chunk_rows(N: int, n_workers: int) -> int:
    if N % n_workers != 0:
        raise ValueError(
            f"samples {N} must divide evenly into {n_workers} chunks"
        )
    return N // n_workers


class LogisticRegression:
    """Binary logistic regression with L2; pure-functional loss/grad."""

    def __init__(self, dim: int, l2: float = 1e-4):
        self.dim = dim
        self.l2 = l2

    def init(self, device="cpu") -> torch.Tensor:
        return torch.zeros(self.dim, dtype=torch.float32, device=device)

    def loss(self, w, X, y):
        logits = X @ w
        # numerically stable BCE-with-logits
        nll = torch.mean(
            torch.clamp(logits, min=0) - logits * y
            + torch.log1p(torch.exp(-logits.abs()))
        )
        return nll + 0.5 * self.l2 * torch.sum(w * w)

    def grad(self, w, X, y):
        return torch.func.grad(self.loss)(w, X, y)


def _coded_grad(w, Xc, yc, coeffs):
    """Coded sum of per-chunk gradients on one worker.

    Xc: (s+1, rows, dim), yc: (s+1, rows), coeffs: (s+1,).
    Gradient of mean-BCE per chunk, combined with the code coefficients;
    the s+1 chunks in one batched pass (the reference's ``vmap``).
    """
    p = torch.sigmoid(Xc @ w)                          # (s+1, rows)
    grads = torch.einsum("crd,cr->cd", Xc, p - yc) / Xc.shape[1]
    return coeffs @ grads


class CodedSGD:
    """Straggler-resilient SGD: one ``asyncmap`` per step, exact decode.

    >>> sgd = CodedSGD(X, y, n_workers=8, s=2)
    >>> w, history = sgd.fit(epochs=50, lr=0.5)
    """

    def __init__(
        self,
        X: np.ndarray,
        y: np.ndarray,
        n_workers: int,
        s: int,
        *,
        devices: Sequence | None = None,
        delay_fn: DelayFn | None = None,
        l2: float = 1e-4,
        seed: int = 0,
    ):
        N, dim = X.shape
        rows = _chunk_rows(N, n_workers)
        Xb = torch.as_tensor(np.asarray(X, dtype=np.float32)).reshape(
            n_workers, rows, dim)
        yb = torch.as_tensor(np.asarray(y, dtype=np.float32)).reshape(
            n_workers, rows)

        def chunk_data(sup, dev):
            return Xb[sup].to(dev), yb[sup].to(dev)

        self._setup(dim, n_workers, s, devices, delay_fn, l2, seed,
                    chunk_data)

    @classmethod
    def synthetic(
        cls,
        N: int,
        dim: int,
        n_workers: int,
        s: int,
        *,
        devices: Sequence | None = None,
        delay_fn: DelayFn | None = None,
        l2: float = 1e-4,
        seed: int = 0,
    ) -> "CodedSGD":
        """BASELINE-config-5 scale without host data: every worker's
        chunks are *generated on its device* with an explicit
        ``torch.Generator``, deterministic per chunk id, so a 1e6 x 1024
        dataset never crosses the host-device edge. Labels come from a
        hidden ``w*`` through a sigmoid, so the problem is learnable
        and convergence is measurable. (The reference draws with
        ``jax.random``; the two streams differ.)"""
        rows = _chunk_rows(N, n_workers)

        def gen(dev, stream_id: int) -> torch.Generator:
            g = torch.Generator(device=dev)
            g.manual_seed(seed * 1_000_003 + stream_id)
            return g

        def chunk_data(sup, dev):
            wstar = torch.randn(dim, generator=gen(dev, 0), device=dev)
            wstar = wstar * dim ** -0.5
            Xc = torch.empty(len(sup), rows, dim, device=dev)
            yc = torch.empty(len(sup), rows, device=dev)
            for c, j in enumerate(sup):
                g = gen(dev, 1 + int(j))
                Xc[c].normal_(generator=g)
                torch.bernoulli(torch.sigmoid(Xc[c] @ wstar), generator=g,
                                out=yc[c])
            return Xc, yc

        self = cls.__new__(cls)
        self._setup(dim, n_workers, s, devices, delay_fn, l2, seed,
                    chunk_data)
        return self

    def _setup(self, dim, n_workers, s, devices, delay_fn, l2, seed,
               chunk_data) -> None:
        """Shared construction: code, model, per-worker device chunk
        placement (via ``chunk_data(support, device)``), backend."""
        devices = resolve_devices(devices)
        self.n = n_workers
        self.s = s
        self.code = GradientCode(n_workers, s, seed=seed)
        self.model = LogisticRegression(dim, l2)
        self.l2 = l2
        self._chunks = []
        for i in range(n_workers):
            sup = self.code.support(i)
            dev = devices[i % len(devices)]
            Xc, yc = chunk_data(sup, dev)
            coeffs = torch.as_tensor(self.code.B[i, sup],
                                     dtype=torch.float32).to(dev)
            self._chunks.append((Xc, yc, coeffs))
        self.backend = CUDADeviceBackend(
            self._work, n_workers, devices=devices, delay_fn=delay_fn
        )

    def eval_data(self, worker: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
        """The first data chunk held by ``worker``, as a device-resident
        ``(X, y)`` pair — for loss evaluation in examples/benchmarks
        without reaching into the internal chunk layout."""
        Xc, yc, _ = self._chunks[worker]
        return Xc[0], yc[0]

    def _work(self, i: int, payload: torch.Tensor, epoch: int):
        Xc, yc, coeffs = self._chunks[i]
        return _coded_grad(payload, Xc, yc, coeffs)

    def step(self, pool: AsyncPool, w, lr: float,
             epoch: int | None = None,
             nwait: int | None = None) -> torch.Tensor:
        """One coded-SGD step: asyncmap, decode + update *on device*.

        Accepts host or device ``w`` and returns the updated weights on
        the decode device — feed them straight back in, so nothing but
        the tiny decode-weight solve touches the host between epochs.
        ``nwait`` defaults to ``n - s`` (the code's tolerance); pass
        ``n`` to force a bulk-synchronous epoch (benchmark baselines).
        """
        if nwait is None:
            nwait = self.n - self.s
        dev = self.backend.devices[0]  # decode device
        w = torch.as_tensor(w, dtype=torch.float32).to(dev)
        asyncmap(pool, w, self.backend, nwait=nwait, epoch=epoch)
        fresh = pool.fresh_indices()
        a = torch.as_tensor(self.code.decode_weights(fresh),
                            dtype=torch.float32).to(dev)
        G = torch.stack([consume(pool.results[i]).to(dev) for i in fresh])
        # chunk gradients are per-chunk means; full-batch mean over n
        # chunks, plus the L2 term applied coordinator-side
        g = (a @ G) / self.n + self.l2 * w
        return w - lr * g

    def fit(self, epochs: int, lr: float = 0.5, w0=None,
            X_eval=None, y_eval=None):
        """Run coded SGD; returns (w, history of per-epoch loss)."""
        if (X_eval is None) != (y_eval is None):
            raise ValueError("X_eval and y_eval must be provided together")
        pool = AsyncPool(self.n)
        dev = self.backend.devices[0]
        w = self.model.init(dev) if w0 is None else w0
        history = []
        if X_eval is not None:  # device-resident once, not per epoch
            X_eval = torch.as_tensor(X_eval).to(dev)
            y_eval = torch.as_tensor(y_eval).to(dev)
        for _ in range(epochs):
            w = self.step(pool, w, lr)
            if X_eval is not None:
                history.append(float(self.model.loss(w, X_eval, y_eval)))
        # drain in-flight stragglers so the shared backend is reusable
        # (a second fit() would otherwise find their slots occupied)
        waitall(pool, self.backend)
        return w.cpu().numpy(), history
