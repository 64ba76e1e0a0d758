"""The port's gradient-coded SGD (mpistragglers_jl_tpu_torch/models/
logreg.py) on the CPU against the JAX package's models/logreg.py.

Tolerances: loss and gradient of ``LogisticRegression`` within 1e-6
relative; one ``CodedSGD.step`` from the same ``w`` on the same numpy
data within 1e-5 of the reference's (f32 sums in other orders). The
synthetic data cannot match across frameworks (``jax.random`` against a
``torch.Generator``), so ``synthetic`` is pinned inside the port: its
labels come from a hidden ``w*``, its chunks are deterministic per seed,
and its loss falls.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu import AsyncPool as RefPool
from mpistragglers_jl_tpu import waitall as ref_waitall
from mpistragglers_jl_tpu.models import logreg as jlr
from mpistragglers_jl_tpu_torch import AsyncPool, waitall
from mpistragglers_jl_tpu_torch.models import logreg as tlr

CPU = [torch.device("cpu")]
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=0, N=480, dim=12):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, dim)).astype(np.float32)
    wstar = rng.standard_normal(dim).astype(np.float32)
    y = (rng.random(N) < 1 / (1 + np.exp(-X @ wstar))).astype(np.float32)
    return X, y


def test_loss_and_grad_match_the_reference():
    X, y = _data()
    w = np.random.default_rng(1).standard_normal(12).astype(np.float32)
    got = tlr.LogisticRegression(12, l2=1e-3)
    want = jlr.LogisticRegression(12, l2=1e-3)
    tX, ty, tw = map(torch.from_numpy, (X, y, w))
    lt, lj = float(got.loss(tw, tX, ty)), float(want.loss(w, X, y))
    assert abs(lt - lj) <= 1e-6 * abs(lj)
    gt = got.grad(tw, tX, ty).numpy()
    gj = np.asarray(want.grad(jnp.asarray(w), jnp.asarray(X),
                              jnp.asarray(y)))
    assert np.max(np.abs(gt - gj)) <= 1e-6 * np.max(np.abs(gj))


@pytest.mark.parametrize("n,s", [(8, 2), (6, 1)])
def test_coded_step_matches_the_reference(n, s):
    X, y = _data(seed=n)
    w0 = np.random.default_rng(2).standard_normal(12).astype(np.float32)
    ref = jlr.CodedSGD(X, y, n, s, seed=3)
    pool = RefPool(n)
    want = np.asarray(ref.step(pool, w0, 0.5, nwait=n))
    ref_waitall(pool, ref.backend)
    ref.backend.shutdown()

    sgd = tlr.CodedSGD(X, y, n, s, devices=CPU, seed=3)
    assert sgd.code.B.tobytes() == ref.code.B.tobytes()
    try:
        pool = AsyncPool(n)
        got = sgd.step(pool, w0, 0.5, nwait=n).numpy()
        assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want))
        waitall(pool, sgd.backend)
    finally:
        sgd.backend.shutdown()


def test_coded_step_is_exact_despite_gated_stragglers():
    """nwait = n - s with s workers gated: the decoded gradient is the
    full-batch gradient, so the step equals an uncoded full-batch step
    from the same w."""
    n, s = 8, 2
    X, y = _data(seed=4)
    late = {2, 5}
    gate = threading.Event()

    def delay(i, epoch):
        if i in late and not gate.wait(30.0):
            raise TimeoutError("gate never opened")
        return 0.0

    sgd = tlr.CodedSGD(X, y, n, s, devices=CPU, delay_fn=delay, l2=1e-3)
    w0 = torch.from_numpy(
        np.random.default_rng(5).standard_normal(12).astype(np.float32))
    try:
        pool = AsyncPool(n)
        got = sgd.step(pool, w0, 0.5)
        assert sorted(pool.fresh_indices().tolist()) == \
            sorted(set(range(n)) - late)
        full = sgd.model.grad(w0, torch.from_numpy(X), torch.from_numpy(y))
        want = w0 - 0.5 * full
        assert torch.max(torch.abs(got - want)) <= TOL * torch.max(
            torch.abs(want))
        gate.set()
        waitall(pool, sgd.backend, timeout=30.0)
    finally:
        sgd.backend.shutdown()


def test_fit_matches_the_reference_history():
    n, s = 6, 1
    X, y = _data(seed=6, N=360)
    ref = jlr.CodedSGD(X, y, n, s, seed=1)
    w_ref, h_ref = ref.fit(4, lr=0.5, X_eval=X, y_eval=y)
    ref.backend.shutdown()
    sgd = tlr.CodedSGD(X, y, n, s, devices=CPU, seed=1)
    try:
        w, h = sgd.fit(4, lr=0.5, X_eval=X, y_eval=y)
    finally:
        sgd.backend.shutdown()
    assert isinstance(w, np.ndarray)
    # every fit step is exact, so the fastest n - s set does not matter
    np.testing.assert_allclose(h, h_ref, rtol=TOL)
    assert np.max(np.abs(w - w_ref)) <= TOL * np.max(np.abs(w_ref))
    assert h[-1] < h[0]


def test_synthetic_is_deterministic_learnable_and_its_loss_falls():
    N, dim, n, s = 1600, 16, 8, 2
    a = tlr.CodedSGD.synthetic(N, dim, n, s, devices=CPU, seed=3)
    b = tlr.CodedSGD.synthetic(N, dim, n, s, devices=CPU, seed=3)
    c = tlr.CodedSGD.synthetic(N, dim, n, s, devices=CPU, seed=4)
    try:
        for (Xa, ya, _), (Xb, yb, _) in zip(a._chunks, b._chunks):
            assert torch.equal(Xa, Xb) and torch.equal(ya, yb)
        assert not torch.equal(a._chunks[0][0], c._chunks[0][0])
        # chunk j is the same data on each of the s + 1 workers holding it
        assert torch.equal(a._chunks[0][0][1], a._chunks[1][0][0])
        X_eval, y_eval = a.eval_data()
        assert set(torch.unique(y_eval).tolist()) == {0.0, 1.0}
        w, hist = a.fit(15, lr=0.5, X_eval=X_eval, y_eval=y_eval)
        # logits of w* are N(0, 1), so the best loss is near 0.58
        assert hist[-1] < hist[0] - 0.02
        assert all(b < a for a, b in zip(hist, hist[1:]))
        assert all(np.isfinite(hist))
        # labels carry the hidden w*: the fitted w predicts them
        pred = (X_eval @ torch.from_numpy(w) > 0).float()
        assert (pred == y_eval).float().mean() > 0.6
    finally:
        for sgd in (a, b, c):
            sgd.backend.shutdown()


def test_init_defaults_to_the_card_and_cpu_is_asked_for():
    """``LogisticRegression.init`` follows the port's device rule: the
    card unless the caller names another device, and a raise (not the
    CPU) when there is no card; the reference's ``jnp.zeros`` lands on
    the default accelerator the same way. The weights equal the JAX
    package's initial weights."""
    m = tlr.LogisticRegression(12)
    w = m.init("cpu")
    assert w.device.type == "cpu" and w.dtype == torch.float32
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jlr.LogisticRegression(12).init()))
    if torch.cuda.is_available():
        assert m.init().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            m.init()
