"""The plain reference of the gradient-coded SGD cells: one full-batch
gradient step of L2-regularised logistic regression, in float64.

Plain PyTorch, imported by nothing of the program and importing nothing
of it: it takes the data and weights the benchmark drew from the seed
and works out the step itself, over all rows at once (no code, chunk,
worker or decode of the program's), in blocks of rows so that it fits
beside what the run holds. A coded step is right or wrong by what it
says: the full-batch step from the weights it was given.

* :func:`step` is ``W - lr * (X^T (sigmoid(X W) - y) / rows + l2 W)``
  for each column of ``W``: the loss is the mean binary cross-entropy
  of the logits ``X w`` plus ``l2 / 2 |w|^2``.
* :func:`step_tf32` is the same step one precision below the float32
  the configurations state: every operand of the two products rounded
  to TF32 (10 bits of mantissa, to nearest even) and the sums in
  float32, the tensor cores' TF32 mode; the control of the check.
"""

from __future__ import annotations

import torch

ROW_BLOCK = 65536


def _exact():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def step(X: torch.Tensor, y: torch.Tensor, W: torch.Tensor, lr: float,
         l2: float) -> torch.Tensor:
    """One full-batch step from each column of ``W`` (dim, c), in
    float64: a (dim, c) tensor."""
    _exact()
    W64 = W.double()
    g = torch.zeros_like(W64)
    for r in range(0, X.shape[0], ROW_BLOCK):
        Xb = X[r:r + ROW_BLOCK].double()
        p = torch.sigmoid(Xb @ W64)
        g += Xb.T @ (p - y[r:r + ROW_BLOCK, None].double())
        del Xb, p
    return W64 - lr * (g / X.shape[0] + l2 * W64)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 bits of mantissa, to nearest
    even, as float32."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def step_tf32(X_tf32: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
              lr: float, l2: float) -> torch.Tensor:
    """One full-batch step from ``w`` (dim,) in TF32: ``X_tf32`` is
    :func:`tf32` of the data; the products of TF32 operands are exact in
    float32, and summed in float32."""
    _exact()
    p = torch.sigmoid(X_tf32 @ tf32(w))
    g = X_tf32.T @ tf32(p - y)
    return w - lr * (g / X_tf32.shape[0] + l2 * w)
