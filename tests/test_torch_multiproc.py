"""The port's mesh plane across processes (``parallel/multihost.py``,
``mesh.py``, ``collectives.py``, ``mesh_gemm.py``; the sharded train
step and sharded generation of ``models/transformer.py`` and
``models/decode.py``) over ``gloo`` processes on the CPU.

Two spawns, once for the module, each with a timeout of its own: two
processes run the slice, four run the collective cases only. Each
child is this file run as a script (it imports no JAX): it joins the
job with ``initialize_multihost``, builds meshes with
``make_multihost_mesh`` that span the processes, runs the programs on
them, and runs the same programs on a single-controller mesh of eight
CPU ranks in its own process and thread setting. The parent holds

* the multi-process values to the JAX package's mesh programs on its 8
  host devices, on the same mesh shape: forward logits within 2e-4 and
  one SGD step (loss rtol 1e-6, leaves 1e-5), as
  ``tests/test_torch_sharded_transformer.py``; prefill, decode and
  ``make_extend`` logits within ``tests/test_torch_decode_sharded.py``'s
  1e-5; greedy,
  int8 and sampled ``make_generate`` streams token for token; the
  ``MeshCodedGemm`` decode within 1e-10 in f64;
* the multi-process values to the single-controller port's, bit for
  bit, for dp across processes (the ``dcn_axis`` layout), tp across
  processes (a flat mesh with ``tp`` outermost) and sp across processes
  (ring attention);
* ``psum`` (also accumulating in f64), ``all_gather``, ``all_to_all``
  and ``ring_shift`` with their backwards over 2 and 4 processes, on
  integer-valued inputs (every sum exact), bit for bit;
* a control: with the cross-process bytes dropped the loss changes;
* the backend choice; the entry points of ROADMAP item 18h's parts (i)
  and (ii) running over a mesh that spans processes (their values are
  held in ``tests/test_torch_multiproc_models.py``), and those of part
  (iii), which stay single-process, refusing it by name.

Run a child by hand: ``python tests/test_torch_multiproc.py slice
127.0.0.1:<port> <rank> <out.pkl>`` in two shells (``collectives4``:
four).
"""

import functools
import os
import pickle
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 150  # seconds per spawn: a hang (a collective entered out of
# order under gloo) fails the module, never the suite's limit

TRAIN_CFG = dict(vocab=61, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
                 d_ff=64)
GEN_CFG = dict(vocab=61, d_model=64, n_heads=8, n_kv_heads=2, n_layers=2,
               d_ff=128)
# (name, mesh shape, axis names, dcn_axis, config fields); the JAX
# package runs each on the same shape over ("dp", "sp", "tp")
TRAIN = [
    ("dp", (2, 2, 2), ("dp", "sp", "tp"), "dp", dict(attn="ulysses")),
    ("tp", (2, 2, 2), ("tp", "dp", "sp"), None, dict(attn="ulysses")),
    ("sp", (2, 2, 2), ("sp", "dp", "tp"), None, dict(attn="ring")),
]
GEN = [
    ("dp", (2, 4), ("dp", "tp"), "dp"),
    ("tp", (4, 2), ("tp", "dp"), None),
]
GEN_MODES = {"greedy": {}, "int8": {"quantize_kv": True},
             "sampled": {"temperature": 0.8, "top_k": 8}}
B, TP, STEPS, N_NEW = 4, 8, 3, 6
LR = 0.1
FWD, TOL = 2e-4, 1e-5
LATER = ["moe", "moe_ffn_sharded", "pipeline", "speculative",
         "serving_scan", "ring_generate", "pool_fused",
         "device_coordinator", "checkpoint"]
# item 18h's parts (i) and (ii): these now run across processes
RUNS = {"moe", "moe_ffn_sharded", "pipeline", "speculative", "serving_scan",
        "ring_generate", "checkpoint"}


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


# -- the children (no JAX) -------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy()


def _both(mesh_of, fn):
    """``fn(mesh)`` on the mesh across processes ("x") and on the
    single-controller mesh of eight CPU ranks ("s")."""
    return {tag: fn(mesh_of(tag)) for tag in ("x", "s")}


def _collective_cases(n_proc) -> dict:
    from mpistragglers_jl_tpu_torch.parallel import make_mesh
    from mpistragglers_jl_tpu_torch.parallel import multihost as mh

    meshes = {"x": mh.make_multihost_mesh((2, 4), ("a", "b"),
                                          devices=["cpu"] * (8 // n_proc)),
              "s": make_mesh((2, 4), ("a", "b"), devices=["cpu"] * 8)}
    X = np.random.default_rng(11).integers(-8, 8, (8, 4, 6)).astype(
        np.float32)
    out = {}
    for name, op in _collective_ops().items():
        for tag, mesh in meshes.items():
            ranks = mesh.local_ranks()
            xs = [torch.tensor(X[r], requires_grad=True) for r in ranks]
            ys = op(xs, mesh)
            ws = [torch.tensor(np.random.default_rng(100 + r).integers(
                -4, 4, tuple(y.shape)), dtype=y.dtype)
                for r, y in zip(ranks, ys)]
            loss = sum((y * w).sum() for y, w in zip(ys, ws))
            gs = torch.autograd.grad(loss, xs)
            out[name, tag] = {r: (_np(y), _np(g))
                              for r, y, g in zip(ranks, ys, gs)}
    return out


def _collective_ops() -> dict:
    from mpistragglers_jl_tpu_torch.parallel.collectives import (
        all_gather, all_to_all, psum, ring_shift)

    return {
        "psum_a": lambda xs, m: psum(xs, m, "a"),
        "psum_b": lambda xs, m: psum(xs, m, "b"),
        "psum_ab_f64": lambda xs, m: psum(xs, m, ("a", "b"),
                                          dtype=torch.float64),
        "all_gather_a": lambda xs, m: all_gather(xs, m, "a", dim=0),
        "all_gather_b": lambda xs, m: all_gather(xs, m, "b", dim=1),
        "all_to_all_a": lambda xs, m: all_to_all(xs, m, "a", split_dim=1,
                                                 concat_dim=0),
        "all_to_all_b": lambda xs, m: all_to_all(xs, m, "b", split_dim=0,
                                                 concat_dim=1),
        "ring_shift_a": lambda xs, m: ring_shift(xs, m, "a"),
        "ring_shift_b": lambda xs, m: ring_shift(xs, m, "b", shift=-1),
    }


def _train_cases(mh) -> dict:
    from mpistragglers_jl_tpu_torch.models import transformer as tt
    from mpistragglers_jl_tpu_torch.parallel import collectives as col
    from mpistragglers_jl_tpu_torch.parallel import make_mesh

    toks = _tokens(TRAIN_CFG["vocab"], (4, 17), seed=6)
    inp, tgt = toks[:, :-1], toks[:, 1:]
    out = {}
    for name, shape, axes, dcn, fields in TRAIN:
        cfg = tt.TransformerConfig(**TRAIN_CFG, **fields)
        params = tt.init_params(cfg, seed=3, device="cpu")

        def mesh_of(tag):
            if tag == "s":
                return make_mesh(shape, axes, devices=["cpu"] * 8)
            return mh.make_multihost_mesh(shape, axes, dcn_axis=dcn,
                                          devices=["cpu"] * 4)

        def run(mesh):
            sp = tt.shard_params(params, cfg, mesh)
            logits = tt.make_forward(cfg, mesh)(sp, inp).gather()
            col.zero_exchanges()
            sp2, loss = tt.make_train_step(cfg, mesh, lr=LR)(sp, inp, tgt)
            res = {"logits": _np(logits), "loss": _np(loss),
                   "exchanges": dict(col.EXCHANGES),
                   "leaves": [_np(x.gather()) for x in tt._leaves(sp2)]}
            if name == "dp" and mesh.spans_processes:
                col.zero_exchanges()
                with col.exchanges_dropped():
                    res["ctrl_loss"] = _np(tt.sharded_loss_and_grads(
                        sp, inp, tgt, cfg, mesh)[0])
                res["ctrl_exchanges"] = col.EXCHANGES["calls"]
            return res

        out[name] = _both(mesh_of, run)
    return out


def _gen_cases(mh) -> dict:
    from mpistragglers_jl_tpu_torch.models import decode as td
    from mpistragglers_jl_tpu_torch.models import transformer as tt
    from mpistragglers_jl_tpu_torch.parallel import make_mesh
    from mpistragglers_jl_tpu_torch.utils import prng

    cfg = tt.TransformerConfig(**GEN_CFG)
    params = tt.init_params(cfg, seed=4, device="cpu")
    toks = _tokens(cfg.vocab, (B, TP + STEPS), seed=5)
    out = {}
    for name, shape, axes, dcn in GEN:
        def mesh_of(tag):
            if tag == "s":
                return make_mesh(shape, axes, devices=["cpu"] * 8)
            return mh.make_multihost_mesh(shape, axes, dcn_axis=dcn,
                                          devices=["cpu"] * 4)

        def run(mesh):
            sp = tt.shard_params(params, cfg, mesh)
            c = td.init_cache(cfg, B, TP + STEPS, mesh, device="cpu")
            lg, c = td.make_prefill(cfg, mesh)(sp, toks[:, :TP], c)
            logits = [_np(lg.gather())]
            step = td.make_decode_step(cfg, mesh)
            for t in range(TP, TP + STEPS):
                lg, c = step(sp, toks[:, t], c, t)
                logits.append(_np(lg.gather()))
            ext = td.make_extend(cfg, mesh)
            c = td.init_cache(cfg, B, TP, mesh, device="cpu")
            for i in range(0, TP, TP // 2):  # the prompt in two chunks
                lg, c = ext(sp, toks[:, i:i + TP // 2], c, i)
            res = {"logits": logits, "extend": _np(lg.gather())}
            for mode, kw in GEN_MODES.items():
                gen = td.make_generate(cfg, mesh, N_NEW, **kw)
                key = prng.key(7) if "temperature" in kw else None
                res[mode] = _np(gen(sp, toks[:, :TP], key).gather())
            return res

        out[name] = _both(mesh_of, run)
    return out


def _gemm_cases(mh) -> dict:
    from mpistragglers_jl_tpu_torch.parallel import (
        MeshCodedGemm, MeshMatDotGemm, make_mesh)

    rng = np.random.default_rng(8)
    A, Bm = rng.standard_normal((12, 6)), rng.standard_normal((6, 5))

    def mesh_of(tag):
        if tag == "s":
            return make_mesh(4, devices=["cpu"] * 4)
        return mh.make_multihost_mesh(4, devices=["cpu"] * 2)

    def run(mesh):
        mg = MeshCodedGemm(A, mesh, k=3)
        coded = mg.full(mg.epoch(Bm, np.array([1, 0, 1, 1]), 1))
        matdot = MeshMatDotGemm(A, mesh, p=2).epoch(Bm).gather()
        return {"coded": coded, "matdot": _np(matdot)}

    return _both(mesh_of, run)


def _later_refusals(mh) -> dict:
    """Each entry point of ROADMAP item 18h over a mesh that spans the
    processes: "ran", or its error message."""
    from mpistragglers_jl_tpu_torch.models import decode as td
    from mpistragglers_jl_tpu_torch.models import serving as sv
    from mpistragglers_jl_tpu_torch.models import speculative as tsp
    from mpistragglers_jl_tpu_torch.models import transformer as tt
    from mpistragglers_jl_tpu_torch.models.moe import moe_ffn_sharded
    from mpistragglers_jl_tpu_torch.ops.coding import MDSCode
    from mpistragglers_jl_tpu_torch.parallel import (
        DeviceCoordinator, PoolMeshCodedGemm)
    from mpistragglers_jl_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step)
    from mpistragglers_jl_tpu_torch.utils.train_checkpoint import (
        TrainCheckpointer)

    cpu4 = ["cpu"] * 4
    cfg = tt.TransformerConfig(**GEN_CFG)
    win = tt.TransformerConfig(**GEN_CFG, attn_window=8)
    moe = tt.TransformerConfig(**GEN_CFG, n_experts=2)
    dptp = mh.make_multihost_mesh((2, 4), ("dp", "tp"), dcn_axis="dp",
                                  devices=cpu4)
    moe_mesh = mh.make_multihost_mesh((2, 2, 2, 1), ("dp", "sp", "tp", "ep"),
                                      dcn_axis="dp", devices=cpu4)
    pool = mh.make_multihost_mesh(4, devices=["cpu"] * 2)
    tmp = tempfile.mkdtemp()

    def ffn():
        lps = td._rank_params(tt.shard_params(
            tt.init_params(moe, device="cpu"), moe, moe_mesh), moe, moe_mesh)
        xs = [torch.ones(1, 2, moe.d_model) for _ in lps]
        return moe_ffn_sharded(xs, [lp["layers"][0] for lp in lps], 1.0,
                               mesh=moe_mesh)

    calls = {
        "moe": lambda: tt.shard_params(
            tt.init_params(moe, device="cpu"), moe, moe_mesh),
        "moe_ffn_sharded": ffn,
        "pipeline": lambda: make_pipeline_train_step(
            tt.TransformerConfig(**{**GEN_CFG, "n_layers": 4}),
            mh.make_multihost_mesh((2, 4), ("dp", "pp"), dcn_axis="dp",
                                   devices=cpu4), n_microbatch=2),
        "speculative": lambda: tsp.make_speculative(
            cfg, mh.make_multihost_mesh((1, 8), ("dp", "tp"),
                                        devices=cpu4), 4, 4),
        "serving_scan": lambda: sv.make_serving_scan(win, dptp, 2),
        "ring_generate": lambda: td.make_ring_generate(win, dptp, 4),
        "pool_fused": lambda: PoolMeshCodedGemm(np.ones((6, 4)), pool, 3,
                                                dtype=np.float64),
        "device_coordinator": lambda: DeviceCoordinator(
            np.ones((4, 2, 4)), decode="mds",
            G=MDSCode(4, 3, dtype=np.float64).G, k=3, mesh=pool),
        "checkpoint": lambda: TrainCheckpointer(tmp).save(0, {
            "w": tt.shard_params(tt.init_params(cfg, device="cpu"), cfg,
                                 dptp)["emb"]}),
    }
    out = {}
    for name in LATER:
        try:
            calls[name]()
            out[name] = "ran"
        except ValueError as e:
            out[name] = str(e)
    return out


def _child(role, addr, rank, path) -> None:
    torch.set_num_threads(1)
    from mpistragglers_jl_tpu_torch.parallel import multihost as mh

    n_proc = 2 if role == "slice" else 4
    res = {}
    try:  # nccl moves CUDA tensors: a CPU device is refused by name
        mh.initialize_multihost(addr, num_processes=n_proc,
                                process_id=rank, device="cpu",
                                backend="nccl")
    except ValueError as e:
        res["nccl_on_cpu"] = str(e)
    mh.initialize_multihost(addr, num_processes=n_proc, process_id=rank,
                            device="cpu")
    res["backend"] = mh.backend()
    res["collectives"] = _collective_cases(n_proc)
    if role == "slice":
        res["train"] = _train_cases(mh)
        res["gen"] = _gen_cases(mh)
        res["gemm"] = _gemm_cases(mh)
        res["later"] = _later_refusals(mh)
    import torch.distributed as dist

    dist.destroy_process_group()
    with open(path, "wb") as f:
        pickle.dump(res, f)


# -- the parent ------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(role, n, tmp):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    addr = f"127.0.0.1:{_free_port()}"
    paths = [os.path.join(tmp, f"{role}_{r}.pkl") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), role, addr, str(r), p],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r, p in enumerate(paths)]
    return procs, paths


def _collect(procs, paths) -> list:
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    out = []
    for path in paths:
        with open(path, "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns start at once and run while the parent's JAX programs
    compile; ``runs(role)`` waits for one of them."""
    tmp = str(tmp_path_factory.mktemp("multiproc"))
    started = {"slice": _spawn("slice", 2, tmp),
               "collectives4": _spawn("collectives4", 4, tmp)}
    done: dict = {}

    def get(role):
        if role not in done:
            done[role] = _collect(*started.pop(role))
        return done[role]

    yield get
    for procs, _ in started.values():
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module")
def slice_(runs):
    a, b = runs("slice")
    return a, b


# -- backend choice ----------------------------------------------------------


def test_nccl_needs_a_card_of_its_own_per_process():
    from mpistragglers_jl_tpu_torch.parallel.multihost import check_backend

    shared = [("h", "cuda:0"), ("h", "cuda:0")]
    with pytest.raises(ValueError, match=r"processes 0 and 1 share cuda:0"
                       r".*backend='gloo'"):
        check_backend("nccl", shared)
    check_backend("gloo", shared)  # gloo with one card is legal
    check_backend("nccl", [("h", "cuda:0"), ("h", "cuda:1")])
    check_backend("nccl", [("a", "cuda:0"), ("b", "cuda:0")])


def test_nccl_on_a_cpu_device_is_refused_and_gloo_chosen(slice_):
    for r in slice_:
        assert "backend='gloo'" in r["nccl_on_cpu"]
        assert r["backend"] == "gloo"


# -- collectives -------------------------------------------------------------


@pytest.mark.parametrize("op", sorted([
    "psum_a", "psum_b", "psum_ab_f64", "all_gather_a", "all_gather_b",
    "all_to_all_a", "all_to_all_b", "ring_shift_a", "ring_shift_b"]))
@pytest.mark.parametrize("n_proc", [2, 4])
def test_collective_and_backward_across_processes(runs, n_proc, op):
    """Each process's outputs and input gradients equal the
    single-controller program's at its ranks, bit for bit, and the
    processes together cover every rank."""
    got = runs("slice" if n_proc == 2 else "collectives4")
    ranks = []
    for res in got:
        x, s = res["collectives"][op, "x"], res["collectives"][op, "s"]
        assert sorted(s) == list(range(8))
        for r, (y, g) in x.items():
            np.testing.assert_array_equal(y, s[r][0], err_msg=f"{op} {r}")
            np.testing.assert_array_equal(g, s[r][1], err_msg=f"{op} {r}")
            assert y.dtype == s[r][0].dtype and g.dtype == s[r][1].dtype
        ranks += list(x)
    assert sorted(ranks) == list(range(8))


# -- the sharded train step --------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_train(attn):
    """The JAX package's forward and one SGD step on (2, 2, 2)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from mpistragglers_jl_tpu.models import transformer as jt
    from mpistragglers_jl_tpu.parallel import make_mesh as jmake_mesh

    toks = _tokens(TRAIN_CFG["vocab"], (4, 17), seed=6)
    inp, tgt = toks[:, :-1], toks[:, 1:]
    jcfg = jt.TransformerConfig(**TRAIN_CFG, attn=attn)
    jp = jt.init_params(jcfg, 3)
    mesh = jmake_mesh((2, 2, 2), ("dp", "sp", "tp"))
    sh = NamedSharding(mesh, JP("dp", "sp"))
    jparams = jt.shard_params(jp, jcfg, mesh)
    logits = np.asarray(jt.make_forward(jcfg, mesh)(
        jparams, jax.device_put(jnp.asarray(inp), sh)))
    params, loss = jt.make_train_step(jcfg, mesh, lr=LR)(
        jparams, jax.device_put(jnp.asarray(inp), sh),
        jax.device_put(jnp.asarray(tgt), sh))
    return logits, float(loss), [np.asarray(x)
                                 for x in jax.tree.leaves(params)]


@pytest.mark.parametrize("case", [c[0] for c in TRAIN])
def test_train_step_across_processes_matches_jax(slice_, case):
    fields = [c[4] for c in TRAIN if c[0] == case][0]
    logits, loss, leaves = _jax_train(fields["attn"])
    for res in slice_:
        x = res["train"][case]["x"]
        np.testing.assert_allclose(x["logits"], logits, atol=FWD, rtol=FWD)
        np.testing.assert_allclose(float(x["loss"]), loss, rtol=1e-6)
        assert len(x["leaves"]) == len(leaves)
        for i, (a, b) in enumerate(zip(x["leaves"], leaves)):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5,
                                       err_msg=f"leaf {i}")


@pytest.mark.parametrize("case", [c[0] for c in TRAIN])
def test_train_step_across_processes_equals_single_controller(slice_,
                                                              case):
    for res in slice_:
        x, s = res["train"][case]["x"], res["train"][case]["s"]
        np.testing.assert_array_equal(x["logits"], s["logits"])
        np.testing.assert_array_equal(x["loss"], s["loss"])
        for a, b in zip(x["leaves"], s["leaves"]):
            np.testing.assert_array_equal(a, b)
    a, b = (r["train"][case]["x"] for r in slice_)
    np.testing.assert_array_equal(a["loss"], b["loss"])


def test_dropped_cross_process_psum_changes_the_loss(slice_):
    for res in slice_:
        x = res["train"]["dp"]["x"]
        assert x["exchanges"]["calls"] > 0 and x["exchanges"]["bytes"] > 0
        assert x["ctrl_exchanges"] == 0
        assert res["train"]["dp"]["s"]["exchanges"]["calls"] == 0
        rel = abs(float(x["ctrl_loss"]) - float(x["loss"])) / abs(
            float(x["loss"]))
        assert rel > 1e-3, rel


# -- sharded generation --------------------------------------------------------


@pytest.fixture(scope="module")
def jax_gen():
    """The JAX package's programs on (2, 4) ("dp", "tp"): prefill and
    decode logits, and the three streams."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from mpistragglers_jl_tpu.models import decode as jd
    from mpistragglers_jl_tpu.models import transformer as jt
    from mpistragglers_jl_tpu.parallel import make_mesh as jmake_mesh

    jcfg = jt.TransformerConfig(**GEN_CFG)
    jp = jt.init_params(jcfg, 4)
    mesh = jmake_mesh((2, 4), ("dp", "tp"))
    sp = jt.shard_params(jp, jcfg, mesh)
    toks = _tokens(jcfg.vocab, (B, TP + STEPS), seed=5)

    def put(x, spec):
        return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))

    c = jd.shard_cache(jd.init_cache(jcfg, B, TP + STEPS, mesh), jcfg, mesh)
    lg, c = jd.make_prefill(jcfg, mesh)(sp, put(toks[:, :TP],
                                                JP("dp", None)), c)
    logits = [np.asarray(lg)]
    step = jd.make_decode_step(jcfg, mesh)
    for t in range(TP, TP + STEPS):
        lg, c = step(sp, put(toks[:, t], JP("dp")), c, jnp.int32(t))
        logits.append(np.asarray(lg))
    streams = {}
    for mode, kw in GEN_MODES.items():
        args = [jax.random.key(7)] if "temperature" in kw else []
        streams[mode] = np.asarray(jd.make_generate(jcfg, mesh, N_NEW, **kw)(
            sp, put(toks[:, :TP], JP("dp", None)), *args))
    return logits, streams


@pytest.mark.parametrize("case", [c[0] for c in GEN])
def test_prefill_and_decode_across_processes_match_jax(slice_, jax_gen,
                                                       case):
    want = jax_gen[0]
    for res in slice_:
        got = res["gen"][case]["x"]["logits"]
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                       err_msg=f"step {i}")
        # make_extend over the prompt in two chunks: its last position's
        # logits are the prefill's
        np.testing.assert_allclose(res["gen"][case]["x"]["extend"][:, -1],
                                   want[0], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("mode", list(GEN_MODES))
@pytest.mark.parametrize("case", [c[0] for c in GEN])
def test_generate_across_processes_matches_jax(slice_, jax_gen, case, mode):
    for res in slice_:
        np.testing.assert_array_equal(res["gen"][case]["x"][mode],
                                      jax_gen[1][mode])


@pytest.mark.parametrize("case", [c[0] for c in GEN])
def test_generation_across_processes_equals_single_controller(slice_, case):
    for res in slice_:
        x, s = res["gen"][case]["x"], res["gen"][case]["s"]
        for a, b in zip(x["logits"] + [x["extend"]],
                        s["logits"] + [s["extend"]]):
            np.testing.assert_array_equal(a, b)
        for mode in GEN_MODES:
            np.testing.assert_array_equal(x[mode], s[mode])


# -- the mesh GEMMs ------------------------------------------------------------


def test_mesh_gemms_across_processes(slice_):
    """The MDS decode with worker 1 stale against the JAX package's
    ``MeshCodedGemm`` and ``A @ B`` within 1e-10 (f64); both GEMMs bit
    for bit against the single-controller mesh."""
    import jax

    from mpistragglers_jl_tpu.parallel import MeshCodedGemm as JMCG
    from mpistragglers_jl_tpu.parallel import make_mesh as jmake_mesh

    rng = np.random.default_rng(8)
    A, Bm = rng.standard_normal((12, 6)), rng.standard_normal((6, 5))
    jmesh = jmake_mesh(4, devices=jax.devices()[:4])
    jg = JMCG(A, jmesh, k=3)
    want = jg.full(jg.epoch(Bm, np.array([1, 0, 1, 1]), 1))
    for res in slice_:
        x, s = res["gemm"]["x"], res["gemm"]["s"]
        np.testing.assert_allclose(x["coded"], want, atol=1e-10, rtol=1e-10)
        np.testing.assert_allclose(x["coded"], A @ Bm, atol=1e-10,
                                   rtol=1e-10)
        np.testing.assert_allclose(x["matdot"], A @ Bm, atol=1e-10,
                                   rtol=1e-10)
        for k in ("coded", "matdot"):
            np.testing.assert_array_equal(x[k], s[k])


# -- item 18h's entry points -----------------------------------------------------


@pytest.mark.parametrize("entry", LATER)
def test_later_entry_points_refuse_a_mesh_across_processes(slice_, entry):
    for r, res in enumerate(slice_):
        msg = res["later"][entry]
        if entry in RUNS:
            assert msg == "ran", msg
            continue
        assert f"process(es) [{1 - r}], not by this one ({r})" in msg, msg
        assert "ROADMAP item 18h" in msg, msg


if __name__ == "__main__":
    _child(sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4])
