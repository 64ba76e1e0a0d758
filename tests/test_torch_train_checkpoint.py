"""Training checkpoints of the port (``utils/train_checkpoint.py``)
against the JAX package, both ways.

The contract is ``tests/test_train_checkpoint.py`` (its five cases run
here on the port; the 1F1B pipeline case waits for ROADMAP.md item 18).
Tolerance: none. Leaves, losses and pool state are held bit-equal: a
step written by the port restores in the JAX package (its npz route,
taken whenever ``state/`` is not a directory) and one written by the JAX
package's npz route restores in the port, f32 and bf16 parameters and
``pool.json`` included; an optimizer resumed from its ``state_dict``
continues the uninterrupted run bit for bit. Late workers are held by
gates.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu import AsyncPool as RefPool
from mpistragglers_jl_tpu import LocalBackend as RefLocal
from mpistragglers_jl_tpu import asyncmap as ref_asyncmap
from mpistragglers_jl_tpu import waitall as ref_waitall
from mpistragglers_jl_tpu.models import transformer as jt
from mpistragglers_jl_tpu.utils import load_state_dict as ref_load
from mpistragglers_jl_tpu.utils.train_checkpoint import (
    TrainCheckpointer as RefCheckpointer,
)
from mpistragglers_jl_tpu_torch import AsyncPool, LocalBackend, asyncmap, waitall
from mpistragglers_jl_tpu_torch.models import transformer as tt
from mpistragglers_jl_tpu_torch.utils import TrainCheckpointer, load_state_dict
from mpistragglers_jl_tpu_torch.utils.coded_checkpoint import tree_leaves

SMALL = dict(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=64)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes as an array of unsigned ints of its width (a
    bf16 tensor, a JAX bf16 array and a ``V2`` array agree)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(f"u{x.dtype.itemsize}") if x.dtype.itemsize in (1, 2, 4, 8) \
        else x


def _assert_bit_equal(got, want, what):
    gl, wl = tree_leaves(got), tree_leaves(want)
    assert len(gl) == len(wl), what
    for i, (a, b) in enumerate(zip(gl, wl)):
        np.testing.assert_array_equal(_bits(a), _bits(b),
                                      err_msg=f"{what} leaf {i}")


def _pool_run(pool, backend, am, wa, epochs=4, payload=None):
    try:
        for _ in range(epochs):
            am(pool, np.zeros(2) if payload is None else payload, backend,
               nwait=3)
        wa(pool, backend)
    finally:
        backend.shutdown()
    return pool


# -- the contract (tests/test_train_checkpoint.py) on the port ------------


def test_pytree_and_pool_roundtrip(tmp_path):
    ckpt = TrainCheckpointer(tmp_path / "ck")
    pool = _pool_run(AsyncPool(3, epoch0=5),
                     LocalBackend(lambda i, p, e: p + i, 3), asyncmap,
                     waitall)
    state = {
        "w": torch.arange(6.0).reshape(2, 3),
        "opt": {"mu": torch.ones(3), "step": 7},
    }
    d = ckpt.save(9, state, pool=pool)
    assert ckpt.latest_step() == 9
    back, pool_state, step = ckpt.restore()
    assert step == 9
    np.testing.assert_array_equal(back["w"].numpy(), state["w"].numpy())
    np.testing.assert_array_equal(back["opt"]["mu"].numpy(), np.ones(3))
    assert int(back["opt"]["step"]) == 7
    pool2 = load_state_dict(pool_state)
    assert pool2.epoch == pool.epoch == 9
    assert pool2.epoch0 == 5
    np.testing.assert_array_equal(pool2.repochs, pool.repochs)
    np.testing.assert_allclose(pool2.latency, pool.latency)
    assert d.endswith("step_9")


def test_active_pool_refused_unless_allowed(tmp_path):
    ckpt = TrainCheckpointer(tmp_path / "ck")
    pool = AsyncPool(2)
    gate = threading.Event()

    def work(i, p, e):
        if i == 1:
            gate.wait(10)
        return p

    backend = LocalBackend(work, 2)
    try:
        asyncmap(pool, np.zeros(1), backend, nwait=1)
        assert pool.active[1]
        with pytest.raises(RuntimeError, match="still active"):
            ckpt.save(1, {"w": torch.zeros(1)}, pool=pool)
        ckpt.save(1, {"w": torch.zeros(1)}, pool=pool, allow_active=True)
        _, pool_state, _ = ckpt.restore(1)
        pool2 = load_state_dict(pool_state)
        assert not pool2.active.any()  # in-flight work dropped on restore
        gate.set()
        waitall(pool, backend)
    finally:
        gate.set()
        backend.shutdown()


def test_keep_prunes_old_steps(tmp_path):
    ckpt = TrainCheckpointer(tmp_path / "ck", keep=2)
    for s in (1, 2, 3, 4):
        ckpt.save(s, {"x": torch.full((1,), float(s))})
    assert ckpt.steps() == [3, 4]
    with pytest.raises(FileNotFoundError):
        TrainCheckpointer(tmp_path / "empty").restore()


def test_rollback_save_is_not_self_destructed(tmp_path):
    # saving a LOWER step after a rollback must not delete itself
    ckpt = TrainCheckpointer(tmp_path / "ck", keep=2)
    ckpt.save(10, {"x": torch.zeros(1)})
    ckpt.save(20, {"x": torch.ones(1)})
    d = ckpt.save(6, {"x": torch.full((1,), 6.0)})
    assert os.path.isdir(d)
    assert 6 in ckpt.steps() and len(ckpt.steps()) == 2
    state, _, step = ckpt.restore(6)
    assert float(state["x"][0]) == 6.0 and step == 6


def test_resume_matches_uninterrupted_training(tmp_path):
    """Save at epoch 5, restore into a fresh coordinator, continue — the
    final weights and epoch numbering match a run that never stopped."""

    def make_backend():
        return LocalBackend(lambda i, w, e: (w - 0.1 * (w - i)) / 1.0, 4)

    def train(pool, backend, w, epochs):
        for _ in range(epochs):
            asyncmap(pool, w, backend, nwait=4)
            w = np.mean([np.asarray(r) for r in pool.results], axis=0)
        waitall(pool, backend)
        return w

    b1 = make_backend()
    try:
        w_full = train(AsyncPool(4), b1, np.zeros(3), 10)
    finally:
        b1.shutdown()

    ckpt = TrainCheckpointer(tmp_path / "ck")
    b2 = make_backend()
    try:
        pool = AsyncPool(4)
        w_half = train(pool, b2, np.zeros(3), 5)
        ckpt.save(5, {"w": torch.as_tensor(w_half)}, pool=pool)
    finally:
        b2.shutdown()
    del pool, w_half

    state, pool_state, step = ckpt.restore()
    pool3 = load_state_dict(pool_state)
    assert step == 5 and pool3.epoch == 5
    b3 = make_backend()
    try:
        w_resumed = train(pool3, b3, state["w"].numpy(), 5)
    finally:
        b3.shutdown()
    np.testing.assert_array_equal(w_resumed, w_full)
    assert pool3.epoch == 10  # epoch numbering continued, not restarted


@pytest.mark.slow
def test_1f1b_pipeline_resume_matches_uninterrupted():
    pytest.skip("the 1F1B pipeline train step (parallel/pipeline.py) is "
                "ROADMAP.md Queue 1 item 18")


# -- the leaf rule, optimizer state and orbax ------------------------------


def test_leaf_order_is_jax_tree_leaves():
    """Nested dicts (keys sorted), lists, tuples and None (no leaf) give
    ``jax.tree_util.tree_leaves``' order."""
    tree = {"b": [3, (4, None, {"z": 5, "a": 6})], "a": {"y": 1, "x": 2},
            "c": None, 10: 7}
    tree.pop(10)
    assert tree_leaves(tree) == jax.tree_util.tree_leaves(tree)
    jp = jt.init_params(jt.TransformerConfig(**SMALL), 0)
    tp = tt.init_params(tt.TransformerConfig(**SMALL), 0, device="cpu")
    _assert_bit_equal(tp, jp, "init_params")


def _tiny_model(dtype):
    cfg = tt.TransformerConfig(**SMALL, dtype=dtype)
    params = tt.init_params(cfg, seed=3, device="cpu")
    tok = np.random.default_rng(4).integers(0, cfg.vocab, (2, 9))
    return cfg, params, tok[:, :-1], tok[:, 1:]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_optimizer_resume_is_bit_equal(tmp_path, dt):
    """AdamW through ``state_dict`` / ``load_state_dict``: 2 steps, save,
    restore into fresh tensors and a fresh optimizer, 2 more steps — the
    losses and every leaf equal 4 uninterrupted steps bit for bit."""
    cfg, p0, inp, tgt = _tiny_model(DTYPES[dt][0])
    step, init_state = tt.make_optax_train_step(cfg, tx=tt.adamw(3e-3))

    ref = tt._rebuild(p0, iter([x.clone() for x in tt._leaves(p0)]))
    opt = init_state(ref)
    want = []
    for _ in range(4):
        ref, opt, loss = step(ref, opt, inp, tgt)
        want.append(loss)

    cur = tt._rebuild(p0, iter([x.clone() for x in tt._leaves(p0)]))
    opt = init_state(cur)
    got = []
    for _ in range(2):
        cur, opt, loss = step(cur, opt, inp, tgt)
        got.append(loss)
    ckpt = TrainCheckpointer(tmp_path / "ck")
    ckpt.save(2, {"params": cur, "opt": opt.state_dict()})
    # the optimizer's state exists only after a step, so the structure
    # comes from tree.json; the parameters are copied into fresh tensors
    state, _, at = ckpt.restore()
    assert at == 2
    params = tt.init_params(cfg, seed=9, device="cpu")
    with torch.no_grad():
        for p, r in zip(tt._leaves(params), tt._leaves(state["params"])):
            assert p.dtype == r.dtype
            p.copy_(r)
    opt2 = init_state(params)
    opt2.load_state_dict(state["opt"])
    assert isinstance(state["opt"]["param_groups"][0]["betas"], tuple)
    del cur, opt
    for _ in range(2):
        params, opt2, loss = step(params, opt2, inp, tgt)
        got.append(loss)
    _assert_bit_equal(got, want, "losses")
    _assert_bit_equal(params, ref, "params")
    # a target rebuilds the parameters with its dtypes, bit for bit
    # (``state`` itself: load_state_dict aliased its moments, which the
    # two steps then updated in place)
    again, _, _ = ckpt.restore(2)
    like = tt.init_params(cfg, seed=8, device="cpu")
    back, _, _ = ckpt.restore(2, target={"params": like,
                                         "opt": again["opt"]})
    _assert_bit_equal(back, again, "targeted restore")


def test_orbax_step_is_refused_by_name(tmp_path):
    os.makedirs(tmp_path / "ck" / "step_3" / "state")
    with pytest.raises(ValueError, match="orbax"):
        TrainCheckpointer(tmp_path / "ck").restore()


# -- across the packages ---------------------------------------------------


def _pair_params(dt):
    tdt, jdt = DTYPES[dt]
    jp = jt.init_params(jt.TransformerConfig(**SMALL, dtype=jdt), 5)
    tp = tt.init_params(tt.TransformerConfig(**SMALL, dtype=tdt), 5,
                        device="cpu")
    _assert_bit_equal(tp, jp, "the two packages' init_params")
    return jp, tp


def _pools():
    """The same 4 epochs in both packages (every worker waited for)."""
    ref = _pool_run(RefPool(3, epoch0=2), RefLocal(lambda i, p, e: p + i, 3),
                    ref_asyncmap, ref_waitall)
    port = _pool_run(AsyncPool(3, epoch0=2),
                     LocalBackend(lambda i, p, e: p + i, 3), asyncmap,
                     waitall)
    return ref, port


def _same_pool(a, b):
    assert (a.epoch, a.epoch0, a.nwait) == (b.epoch, b.epoch0, b.nwait)
    np.testing.assert_array_equal(a.repochs, b.repochs)
    np.testing.assert_array_equal(a.latency, b.latency)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_port_checkpoint_restores_in_jax(tmp_path, dt):
    jp, tp = _pair_params(dt)
    _, pool = _pools()
    TrainCheckpointer(tmp_path / "ck").save(7, tp, pool=pool)
    ref = RefCheckpointer(tmp_path / "ck")
    state, pool_state, step = ref.restore(target=jp)
    assert step == 7
    _assert_bit_equal(state, jp, "JAX restore of the port's step")
    _same_pool(ref_load(pool_state), pool)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_jax_checkpoint_restores_in_port(tmp_path, dt):
    jp, tp = _pair_params(dt)
    ref_pool, _ = _pools()
    ref = RefCheckpointer(tmp_path / "ck")
    ref._ocp = None  # the JAX package's npz route
    ref.save(4, jp, pool=ref_pool)
    ckpt = TrainCheckpointer(tmp_path / "ck")
    like = tt.init_params(tt.TransformerConfig(**SMALL,
                                               dtype=DTYPES[dt][0]), 11,
                          device="cpu")
    state, pool_state, step = ckpt.restore(target=like)
    assert step == 4
    assert all(a.dtype == DTYPES[dt][0] for a in tree_leaves(state))
    _assert_bit_equal(state, tp, "port restore of the JAX step")
    _same_pool(load_state_dict(pool_state), ref_pool)
    with pytest.raises(ValueError, match="target"):
        ckpt.restore(4)  # no tree.json: the JAX package wrote it
