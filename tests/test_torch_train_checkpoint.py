"""Training checkpoints of the port (``utils/train_checkpoint.py``)
against the JAX package, both ways.

The contract is ``tests/test_train_checkpoint.py`` (its six cases run
here on the port, the 1F1B pipeline case over a (2, 2) mesh of CPU
ranks; a pipeline step saved by the JAX package resumes in the port).
Tolerance: none, but for the pipeline cases (the reference's 1e-6 for
the resumed trajectory, 1e-5 against the JAX step). Leaves, losses and
pool state are held bit-equal: a
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


def _pipeline_case():
    """tests/test_train_checkpoint.py's 1F1B case: the config, a (2, 2)
    ("dp", "pp") mesh of CPU ranks and its batch."""
    from mpistragglers_jl_tpu_torch.parallel import make_mesh

    fields = dict(vocab=31, d_model=16, n_heads=2, n_layers=4, d_ff=32)
    mesh = make_mesh((2, 2), ("dp", "pp"), devices=["cpu"] * 4)
    data = np.random.default_rng(0).integers(0, 31, (4, 9))
    return fields, mesh, data[:, :-1], data[:, 1:]


def test_1f1b_pipeline_resume_matches_uninterrupted(tmp_path):
    """Checkpoint/resume composes with the 1F1B pipeline train step:
    save mid-training, restore into the live tree's layout (each leaf
    laid out again by its mesh and spec), and the resumed trajectory
    matches the uninterrupted one."""
    from mpistragglers_jl_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
        shard_params_pipeline,
    )

    fields, mesh, toks, tgts = _pipeline_case()
    cfg = tt.TransformerConfig(**fields)
    step = make_pipeline_train_step(cfg, mesh, n_microbatch=2, lr=0.1,
                                    schedule="1f1b")
    dense = tt.init_params(cfg, seed=1, device="cpu")

    ref = shard_params_pipeline(dense, cfg, mesh)
    for _ in range(6):
        ref, _ = step(ref, toks, tgts)

    ckpt = TrainCheckpointer(tmp_path / "pp")
    cur = shard_params_pipeline(dense, cfg, mesh)
    for _ in range(3):
        cur, _ = step(cur, toks, tgts)
    ckpt.save(3, cur)

    restored, _, step_no = ckpt.restore(target=cur)
    assert step_no == 3
    for a, b in zip(tt._leaves(restored), tt._leaves(cur)):
        assert a.mesh is mesh and a.spec == b.spec
        assert all(a.local(r) is not b.local(r) for r in range(4))
    del cur
    for _ in range(3):
        restored, _ = step(restored, toks, tgts)
    for a, b in zip(tt._leaves(restored), tt._leaves(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_jax_pipeline_checkpoint_resumes_in_port(tmp_path, dt):
    """A step of the JAX 1F1B pipeline saved by the JAX package (its npz
    route: sharded arrays as their global values) restores into the
    port's pipeline layout bit for bit, and the port's next steps equal
    the JAX package's (f32) or stay finite and bit-equal across
    replicas (bf16)."""
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from mpistragglers_jl_tpu.parallel import make_mesh as jmake_mesh
    from mpistragglers_jl_tpu.parallel import pipeline as jpl
    from mpistragglers_jl_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
        shard_params_pipeline,
    )

    tdt, jdt = DTYPES[dt]
    fields, mesh, toks, tgts = _pipeline_case()
    jcfg = jt.TransformerConfig(**fields, dtype=jdt)
    jmesh = jmake_mesh((2, 2), ("dp", "pp"))
    jstep = jpl.make_pipeline_train_step(jcfg, jmesh, n_microbatch=2,
                                         lr=0.1, schedule="1f1b")

    def place(a):
        return jax.device_put(jnp.asarray(a, jnp.int32),
                              NamedSharding(jmesh, JP("dp")))

    jparams = jpl.shard_params_pipeline(jt.init_params(jcfg, seed=1), jcfg,
                                        jmesh)
    for _ in range(2):
        jparams, _ = jstep(jparams, place(toks), place(tgts))
    ref = RefCheckpointer(tmp_path / "ck")
    ref._ocp = None  # the JAX package's npz route
    ref.save(2, jparams)

    cfg = tt.TransformerConfig(**fields, dtype=tdt)
    like = shard_params_pipeline(tt.init_params(cfg, seed=9, device="cpu"),
                                 cfg, mesh)
    state, _, at = TrainCheckpointer(tmp_path / "ck").restore(target=like)
    assert at == 2
    _assert_bit_equal([a.gather() for a in tt._leaves(state)],
                      jax.tree.leaves(jparams), "restored pipeline leaves")
    step = make_pipeline_train_step(cfg, mesh, n_microbatch=2, lr=0.1,
                                    schedule="1f1b")
    got = []
    for _ in range(2):
        state, loss = step(state, toks, tgts)
        jparams, jl = jstep(jparams, place(toks), place(tgts))
        got.append((loss.item(), float(jl)))
    if dt == "f32":
        np.testing.assert_allclose(*zip(*got), rtol=1e-5)
        for a, b in zip(tt._leaves(state), jax.tree.leaves(jparams)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-5, rtol=1e-5)
    assert all(np.isfinite(g[0]) for g in got)
    for leaf in tt._leaves(state):
        named = {a for a in leaf.spec if a is not None}
        over = [a for a in mesh.axis_names if a not in named]
        for group in mesh.axis_groups(over):
            assert all(torch.equal(leaf.local(r), leaf.local(group[0]))
                       for r in group)


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
