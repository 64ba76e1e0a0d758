"""The one general generator: a cell's inputs and traffic from ``--seed``.

Everything a run feeds the program is drawn here, and nothing else in
the benchmark draws: the same seed gives the same operands, payloads,
probe vector, stall tables and check sample.

* Operands: ``A`` (m, kdim), ``payloads`` payload matrices of (kdim,
  ncols) and the probe vector ``v`` (ncols,), standard normal, drawn on
  the run's device by one ``torch.Generator`` in three calls.
* Logistic-regression data: ``X`` (rows, dim) standard normal, labels
  ``y`` (rows,) drawn as Bernoulli(sigmoid(X w*)) from a hidden ``w*``
  of N(0, 1/dim) entries (the program's ``CodedSGD.synthetic`` law), and
  ``payloads`` weight vectors ``W`` (payloads, dim) of N(0, 1/dim)
  entries, drawn on the run's device by one ``torch.Generator``.
* Stalls: a traffic file's ``stall`` group is the seconds a worker's
  dispatcher thread waits before it enqueues each task (the program's
  ``delay_fn``): ``stall_s`` on every task of the ``stragglers`` (a
  list, or ``"config"`` for the configuration's own), plus a draw from
  an exponential of mean ``exp_mean_s`` on every worker, one independent
  draw for each of a worker's first ``EXP_DRAWS`` tasks (a later task
  takes the draws again from the first).
* The check sample: a reservoir of ``size`` epochs, uniform over the
  window's epochs, drawn from the seed.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

# sub-streams of one seed
_OPERANDS, _STALLS, _SAMPLE = 0, 1, 2
# exponential stalls drawn per worker: a 51 s window of 3 ms tasks
# takes under 17,000
EXP_DRAWS = 32768


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of the run's ``seed``."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, stream])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def operands(m: int, kdim: int, ncols: int, payloads: int, seed: int,
             device, dtype=torch.float32):
    """``(A, B, v)``: A (m, kdim), B (payloads, kdim, ncols), v (ncols,)."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, _OPERANDS))
    A = torch.randn(m, kdim, generator=g, device=device, dtype=dtype)
    B = torch.randn(payloads, kdim, ncols, generator=g, device=device,
                    dtype=dtype)
    v = torch.randn(ncols, generator=g, device=device, dtype=dtype)
    return A, B, v


def logreg(rows: int, dim: int, payloads: int, seed: int, device):
    """``(X, y, W)``: X (rows, dim), y (rows,) in {0, 1}, W (payloads,
    dim), all float32."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, _OPERANDS))
    X = torch.randn(rows, dim, generator=g, device=device)
    wstar = torch.randn(dim, generator=g, device=device) * dim ** -0.5
    y = torch.bernoulli(torch.sigmoid(X @ wstar), generator=g)
    W = torch.randn(payloads, dim, generator=g, device=device) * dim ** -0.5
    return X, y, W


def stall_table(stall: dict, cfg: dict, n: int, seed: int) -> np.ndarray:
    """(n, T) seconds: row i is worker i's stall before its task j at
    ``[i, j % T]``."""
    fixed = np.zeros(n)
    workers = stall.get("stragglers", [])
    stall_s = stall.get("stall_s", 0.0)
    if workers == "config":
        workers, stall_s = cfg["stragglers"], cfg["straggler_stall_s"]
    fixed[list(workers)] = float(stall_s)
    mean = float(stall.get("exp_mean_s", 0.0))
    if mean <= 0:
        return fixed[:, None]
    rng = np.random.default_rng(sub_seed(seed, _STALLS))
    return fixed[:, None] + rng.exponential(mean, (n, EXP_DRAWS))


class StallGate:
    """The program's ``delay_fn`` over a stall table.

    Worker i's j-th call waits ``table[i, j % T]`` seconds in the
    worker's own dispatcher thread, before the task is enqueued, and
    returns 0. :meth:`release` ends every wait at once, so that a run's
    close waits out no stall."""

    def __init__(self, table: np.ndarray):
        self.table = table
        self.calls = [0] * table.shape[0]  # each touched by its worker only
        self._open = threading.Event()

    def __call__(self, worker: int, epoch: int) -> float:
        j = self.calls[worker]
        self.calls[worker] = j + 1
        wait = float(self.table[worker, j % self.table.shape[1]])
        if wait > 0:
            self._open.wait(wait)
        return 0.0

    def release(self) -> None:
        self._open.set()


class Reservoir:
    """A uniform sample of ``size`` epochs out of however many a window
    runs: :meth:`slot` says where epoch ``i`` goes, or None."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.epochs = [-1] * size
        self._rng = np.random.default_rng(sub_seed(seed, _SAMPLE))

    def slot(self, i: int):
        j = i if i < self.size else int(self._rng.integers(0, i + 1))
        if j >= self.size:
            return None
        self.epochs[j] = i
        return j
