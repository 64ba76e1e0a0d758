"""The port's gradient-coded training of the transformer
(mpistragglers_jl_tpu_torch/models/coded_train.py) on the CPU, over the
pool and ``CUDADeviceBackend(devices=[cpu])``, against the JAX package's
``CodedGradTrainer`` and a direct full-batch SGD, at
tests/test_coded_train.py's shape: vocab 37, d_model 32, 4 heads, 2
layers, d_ff 64, n = 6 workers tolerating s = 2, chunks of (4, 13)
tokens.

Late workers are held by ``threading.Event`` gates, not sleeps, so they
are out at every return however the host schedules the threads.
Tolerance: the reference test's, atol 2e-4 and rtol 2e-3 on every
parameter after the epochs (the decode's f32 sums and the chunk
gradients' orders differ).
"""

import sys
import threading

import jax
import numpy as np
import optax
import pytest
import torch

from mpistragglers_jl_tpu.models import coded_train as jct
from mpistragglers_jl_tpu.models import transformer as jt
from mpistragglers_jl_tpu.pool import AsyncPool as RefPool
from mpistragglers_jl_tpu.pool import waitall as ref_waitall
from mpistragglers_jl_tpu_torch import AsyncPool, waitall
from mpistragglers_jl_tpu_torch.models import coded_train as tct
from mpistragglers_jl_tpu_torch.models import transformer as tt
from mpistragglers_jl_tpu_torch.ops import flash_attention as fa

FIELDS = dict(vocab=37, d_model=32, n_heads=4, n_layers=2, d_ff=64)
MOE = dict(FIELDS, n_experts=4, capacity_factor=1.25)
N, S = 6, 2
ROWS, L = 4, 12  # tokens per chunk: (ROWS, L+1)
LATE = (0, 3)
CPU = [torch.device("cpu")]
ATOL, RTOL = 2e-4, 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chunk(j, vocab=FIELDS["vocab"]):
    rng = np.random.default_rng((13, j))
    return rng.integers(0, vocab, (ROWS, L + 1)).astype(np.int32)


def _gate():
    """(event, delay_fn): the LATE workers wait on the event before each
    task."""
    gate = threading.Event()

    def delay(i, epoch):
        if i in LATE and not gate.wait(60.0):
            raise TimeoutError("gate never opened")
        return 0.0

    return gate, delay


def _trainer(fields=FIELDS, **kw):
    cfg = tt.TransformerConfig(**fields)
    return tct.CodedGradTrainer(
        tct.transformer_chunk_loss(cfg), tt.init_params(cfg, 1, "cpu"),
        _chunk, N, S, devices=CPU, **kw)


def _direct_full_batch_sgd(fields, lr, epochs):
    """Oracle: bulk-synchronous SGD on the mean of the n chunk losses."""
    cfg = tt.TransformerConfig(**fields)
    loss_fn = tct.transformer_chunk_loss(cfg)
    params = tt.init_params(cfg, 1, "cpu")
    for _ in range(epochs):
        leaves = [p.detach().requires_grad_(True)
                  for p in tt._leaves(params)]
        tree = tt._rebuild(params, iter(leaves))
        total = sum(loss_fn(tree, _chunk(j)) for j in range(N)) / N
        grads = torch.autograd.grad(total, leaves)
        params = tt._rebuild(params, iter(
            p.detach() - lr * g for p, g in zip(leaves, grads)))
    return params


def _assert_close(got, want, what):
    gl = tt._leaves(got)
    wl = want if isinstance(want, list) else tt._leaves(want)
    assert len(gl) == len(wl)
    for i, (a, b) in enumerate(zip(gl, wl)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=ATOL, rtol=RTOL,
                                   err_msg=f"{what}: leaf {i}")


def _gated_epochs(tr, gate, epochs, **kw):
    """``epochs`` coded steps with the LATE workers gated out of every
    one; then the gate opens and the pool drains."""
    pool = AsyncPool(N)
    params = tr._flat.tree(tr._flat.leaves(tr._flat0))
    try:
        for _ in range(epochs):
            params = tr.step(pool, params, **kw)
            assert sorted(tr.last_fresh.tolist()) == sorted(
                set(range(N)) - set(LATE))
            assert all(pool.active[i] for i in LATE)
    finally:
        gate.set()
        waitall(pool, tr.backend, timeout=60.0)
    return params


def test_gated_steps_equal_jax_and_direct_full_batch_sgd():
    """3 coded epochs with workers 0 and 3 gated out == the JAX trainer
    at nwait = n == direct full-batch SGD, leaf for leaf."""
    gate, delay = _gate()
    tr = _trainer(delay_fn=delay)
    try:
        got = _gated_epochs(tr, gate, 3, lr=0.1)
    finally:
        tr.backend.shutdown()
    _assert_close(got, _direct_full_batch_sgd(FIELDS, 0.1, 3),
                  "against direct full-batch SGD")
    jcfg = jt.TransformerConfig(**FIELDS)
    ref = jct.CodedGradTrainer(jct.transformer_chunk_loss(jcfg),
                               jt.init_params(jcfg, seed=1), _chunk, N, S)
    pool = RefPool(N)
    params = jt.init_params(jcfg, seed=1)
    try:
        for _ in range(3):
            params = ref.step(pool, params, lr=0.1, nwait=N)
        ref_waitall(pool, ref.backend)
    finally:
        ref.backend.shutdown()
    _assert_close(got, [np.asarray(x) for x in jax.tree.leaves(params)],
                  "against the JAX trainer")


def test_moe_config_through_the_trainer_equals_full_batch_sgd():
    """A mixture-of-experts transformer (4 experts, capacity factor
    1.25: each chunk routes and drops on its own tokens, as the oracle's
    per-chunk forwards do) trains exactly under gated stragglers."""
    gate, delay = _gate()
    tr = _trainer(MOE, delay_fn=delay)
    try:
        got = _gated_epochs(tr, gate, 2, lr=0.1)
    finally:
        tr.backend.shutdown()
    assert "wg" in got["layers"][0]
    _assert_close(got, _direct_full_batch_sgd(MOE, 0.1, 2),
                  "MoE against direct full-batch SGD")


class _OpensAfterEvals(tct.CodedGradTrainer):
    """Opens the gate after the ``open_after``-th full-batch evaluation,
    so the gated workers are out through every epoch of the first fit
    and fit's closing drain can finish."""

    def full_batch_loss(self, params) -> float:
        loss = super().full_batch_loss(params)
        self.evals += 1
        if self.evals == self.open_after:
            self.gate.set()
        return loss


def test_fit_decreases_the_loss_drains_and_reuses_the_backend():
    cfg = tt.TransformerConfig(**FIELDS)
    gate, delay = _gate()
    tr = _OpensAfterEvals(tct.transformer_chunk_loss(cfg),
                          tt.init_params(cfg, 1, "cpu"), _chunk, N, S,
                          devices=CPU, delay_fn=delay)
    tr.gate, tr.evals, tr.open_after = gate, 0, 4
    try:
        params, hist = tr.fit(epochs=4, lr=0.1)
        assert len(hist) == 4 and hist[-1] < hist[0]
        params, hist2 = tr.fit(epochs=2, lr=0.1, params=params)
        assert hist2[-1] < hist[0]
    finally:
        gate.set()
        tr.backend.shutdown()


def test_adamw_matches_optax_over_two_epochs():
    """``tx=adamw(3e-3)`` against the JAX trainer with
    ``optax.adamw(3e-3)``, two epochs, every worker fresh."""
    tr = _trainer(tx=tt.adamw(3e-3))
    try:
        got, hist = tr.fit(epochs=2, eval_every=None)
    finally:
        tr.backend.shutdown()
    assert hist == []
    jcfg = jt.TransformerConfig(**FIELDS)
    ref = jct.CodedGradTrainer(jct.transformer_chunk_loss(jcfg),
                               jt.init_params(jcfg, seed=1), _chunk, N, S,
                               tx=optax.adamw(3e-3))
    try:
        want, _ = ref.fit(epochs=2, eval_every=None)
    finally:
        ref.backend.shutdown()
    _assert_close(got, [np.asarray(x) for x in jax.tree.leaves(want)],
                  "AdamW against optax")


def test_lr_and_tx_are_exclusive():
    tr = _trainer()
    params = tt.init_params(tt.TransformerConfig(**FIELDS), 1, "cpu")
    try:
        with pytest.raises(ValueError, match="exactly one"):
            tr.step(AsyncPool(N), params)  # neither lr nor tx
    finally:
        tr.backend.shutdown()
    tr2 = _trainer(tx=tt.adamw(0.1))
    try:
        with pytest.raises(ValueError, match="exactly one"):
            tr2.step(AsyncPool(N), params, lr=0.1)  # both
    finally:
        tr2.backend.shutdown()


@pytest.mark.parametrize("kw", [{"registry": object()}, {"spans": object()}])
def test_observability_arguments_raise_naming_item_9(kw):
    with pytest.raises(NotImplementedError, match="item 9"):
        _trainer(**kw)


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    cfg = tt.TransformerConfig(**FIELDS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tct.CodedGradTrainer(tct.transformer_chunk_loss(cfg),
                             tt.init_params(cfg, 1, "cpu"), _chunk, N, S)


def test_flash_launch_counts_survive_concurrent_workers():
    """Pool workers launch the flash kernels from their own threads: 8
    threads adding 5000 launches each, with a short switch interval, lose
    none of them."""
    saved, interval = dict(fa.LAUNCHES), sys.getswitchinterval()
    fa.LAUNCHES["flash_fwd"] = 0

    def launches():
        for _ in range(5000):
            fa._count("flash_fwd")

    threads = [threading.Thread(target=launches) for _ in range(8)]
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
        assert fa.LAUNCHES["flash_fwd"] == 8 * 5000
    finally:
        sys.setswitchinterval(interval)
        fa.LAUNCHES.update(saved)
