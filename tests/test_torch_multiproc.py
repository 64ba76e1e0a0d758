"""The port's mesh plane across processes (``parallel/multihost.py``,
``mesh.py``, ``collectives.py``, ``mesh_gemm.py``, ``device_coord.py``;
the sharded train step and sharded generation of
``models/transformer.py`` and ``models/decode.py``) over ``gloo``
processes on the CPU.

Two spawns, once for the module, each with a timeout of its own: two
processes run the slice, four run the collective and window cases
only. Each child is this file run as a script (it imports no JAX): it joins the
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
* the device coordinator's mesh window (``parallel/device_coord.py``)
  over ("w",) of 8 across 2 and 4 processes, MDS (8, 6) in f64: one
  window, two back to back, per-epoch payloads and ``backend=``, bit for
  bit against the single-controller window and against the JAX
  package's mesh window (histories equal, products within 1e-9 of JAX's
  and of ``A @ B``), each process's ``pool.results`` holding its own
  workers' only, and every guard raising on every process together;
* the backend choice; the entry points that once refused a mesh across
  processes running over one (the models' values are held in
  ``tests/test_torch_multiproc_models.py``), and the pool-fused GEMM,
  which keeps the JAX package's one-process limit, refusing it by name.

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
# these run across processes; the pool-fused GEMM keeps the JAX
# package's one-process limit
RUNS = {"moe", "moe_ffn_sharded", "pipeline", "speculative", "serving_scan",
        "ring_generate", "checkpoint", "device_coordinator"}
# the device coordinator's mesh window over ("w",) of 8, MDS (8, 6) in
# f64: the windows each case runs back to back, by K
WIN_N, WIN_K = 8, 6
WIN_CASES = {"k6": (6,), "k6k4": (6, 4), "per_epoch": (6,),
             "backend": (6,)}
# the guards: what each process's message holds (``last``: the last
# process, the one whose own pool trips the guard)
WIN_GUARDS = {
    "epochs0": lambda last: "epochs must be >= 1, got 0",
    "pool_size": lambda last: "pool has 7 workers but this window is laid "
                              "out for 8",
    "staged_count": lambda last: "staged payloads carry 5 epochs but the "
                                 "window runs 6",
    "quiescent": lambda last: f"refused on every process: process {last}: "
                              "pool has in-flight host-loop work",
    "diverged_carry": lambda last: f"refused on every process: process "
                                   f"{last}: pool state diverged",
    "delay_fn": lambda last: "pass different values of the delay schedule",
    "blocks": lambda last: "pass different values of the blocks",
}


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
    """Each entry point that once refused a mesh across processes, over
    one that spans them: "ran", or its error message."""
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


def _win_inputs():
    """A (18, 16) and B (16, 5) in f64, and an (6, 16, 5) payload stack."""
    rng = np.random.default_rng(21)
    return (rng.standard_normal((WIN_K * 3, 16)),
            rng.standard_normal((16, 5)), rng.standard_normal((6, 16, 5)))


def _win_delay(faults, extra=0.0):
    """``tests/test_torch_device_coord.py``'s schedule: seeded lognormal,
    worker 2 straggling by 30 s; ``extra`` more on worker 0."""
    base = faults.seeded_lognormal(0.01, 0.7, seed=3)

    def fn(w, e):
        return base(w, e) + (30.0 if w == 2 else 0.0) + (
            extra if w == 0 else 0.0)

    return fn


def _window_cases(mh, n_proc) -> dict:
    """The device coordinator's mesh window over ("w",) of 8 across the
    processes ("x") and on the single-controller mesh of eight CPU ranks
    ("s"), per case of :data:`WIN_CASES`; then each guard of
    :data:`WIN_GUARDS` on "x", and a window after them."""
    from mpistragglers_jl_tpu_torch import AsyncPool, asyncmap_fused
    from mpistragglers_jl_tpu_torch.backends.cuda import CUDADeviceBackend
    from mpistragglers_jl_tpu_torch.ops.coding import MDSCode
    from mpistragglers_jl_tpu_torch.parallel import (
        DeviceCoordinator, make_mesh)
    from mpistragglers_jl_tpu_torch.parallel import collectives as col
    from mpistragglers_jl_tpu_torch.utils import faults

    A, Bm, Bs = _win_inputs()
    code = MDSCode(WIN_N, WIN_K, dtype=np.float64)
    blocks = code.encode_array(torch.from_numpy(A))
    meshes = {"x": mh.make_multihost_mesh(
        WIN_N, devices=["cpu"] * (WIN_N // n_proc)),
        "s": make_mesh(WIN_N, devices=["cpu"] * WIN_N)}

    def coord(mesh, blk=blocks, extra=0.0, backend=None):
        return DeviceCoordinator(blk, decode="mds", G=code.G, k=WIN_K,
                                 mesh=mesh, delay_fn=_win_delay(faults, extra),
                                 backend=backend)

    out = {}
    for case, windows in WIN_CASES.items():
        for tag, mesh in meshes.items():
            backend = None
            if case == "backend":  # over this process's own devices
                backend = CUDADeviceBackend(lambda i, p, e: None, WIN_N,
                                            devices=mesh.local_devices())
            c = coord(mesh, backend=backend)
            pool = AsyncPool(WIN_N)
            pool.results = ["untouched"] * WIN_N
            runs = []
            for K in windows:
                col.zero_exchanges()
                hist = asyncmap_fused(pool, Bs if case == "per_epoch" else Bm,
                                      c, epochs=K)
                calls = col.EXCHANGES["calls"]
                every = np.asarray(c.last_decoded)  # collective: all call it
                runs.append({
                    "hist": hist, "exchanges": calls,
                    "local": {r: _np(c.last_decoded.local(r))
                              for r in mesh.local_ranks()},
                    "decoded": [c.full(every[j]) for j in range(K)],
                    "last_full": _np(c.last_window["last_full"]),
                    "epoch_ends": c.last_window["epoch_ends"]})
            if backend is not None:
                backend.shutdown()
            out[case, tag] = {
                "runs": runs, "workers": mh.local_worker_indices(mesh),
                "pool": {"epoch": pool.epoch, "repochs": pool.repochs.copy(),
                         "sepochs": pool.sepochs.copy(),
                         "active": pool.active.copy()},
                "results": [r if isinstance(r, str) else _np(r)
                            for r in pool.results]}
    me, last, x = mh.process_index(), n_proc - 1, meshes["x"]
    c = coord(x)
    busy = AsyncPool(WIN_N)
    busy.active[0] = me == last
    stepped = AsyncPool(WIN_N)
    guards = {
        "epochs0": lambda: c.run_window(AsyncPool(WIN_N), Bm, epochs=0),
        "pool_size": lambda: c.run_window(AsyncPool(WIN_N - 1), Bm,
                                          epochs=2),
        "staged_count": lambda: c.run_window(AsyncPool(WIN_N), Bs[:5],
                                             epochs=6),
        "quiescent": lambda: c.run_window(busy, Bm, epochs=2),
        "diverged_carry": lambda: c.run_window(stepped, Bm, epochs=2),
        "delay_fn": lambda: coord(x, extra=0.5 * me).run_window(
            AsyncPool(WIN_N), Bm, epochs=2),
        "blocks": lambda: coord(x, blk=blocks + me),
    }
    out["guards"] = {}
    for name, call in guards.items():
        if name == "diverged_carry":  # a window, then the last edits it
            c.run_window(stepped, Bm, epochs=2)
            stepped.sepochs[3] += me == last
        try:
            call()
            out["guards"][name] = "ran"
        except ValueError as e:
            out["guards"][name] = str(e)
    c.reset()  # and the job goes on
    out["after"] = c.run_window(AsyncPool(WIN_N), Bm, epochs=2)
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
    res["window"] = _window_cases(mh, n_proc)
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


# -- the device coordinator's mesh window ---------------------------------------


def _window_runs(runs, n_proc) -> list:
    return [res["window"] for res in
            runs("slice" if n_proc == 2 else "collectives4")]


@pytest.mark.parametrize("case", list(WIN_CASES))
@pytest.mark.parametrize("n_proc", [2, 4])
def test_mesh_window_across_processes_equals_single_controller(runs, n_proc,
                                                               case):
    """Each window's history, each process's decoded blocks, the
    gathered products, ``last_full`` and the pool's end state equal the
    single-controller window's bit for bit; a window makes K
    reduce-scatters, one ring and one digest exchange across processes,
    and the processes together hold every rank."""
    ranks = []
    for res in _window_runs(runs, n_proc):
        x, s = res[case, "x"], res[case, "s"]
        assert len(x["runs"]) == len(WIN_CASES[case])
        for K, a, b in zip(WIN_CASES[case], x["runs"], s["runs"]):
            np.testing.assert_array_equal(a["hist"], b["hist"])
            np.testing.assert_array_equal(a["epoch_ends"], b["epoch_ends"])
            assert (a["exchanges"], b["exchanges"]) == (K + 2, 0)
            for r, blk in a["local"].items():
                np.testing.assert_array_equal(blk, b["local"][r])
            for u, v in zip(a["decoded"], b["decoded"]):
                np.testing.assert_array_equal(u, v)
            np.testing.assert_array_equal(a["last_full"], b["last_full"])
        for key, v in x["pool"].items():
            np.testing.assert_array_equal(v, s["pool"][key], err_msg=key)
        ranks += list(x["runs"][0]["local"])
    assert sorted(ranks) == list(range(WIN_N))


@pytest.fixture(scope="module")
def jax_windows():
    """The JAX package's ``DeviceCoordinator`` mesh window on its 8 host
    devices, per case (``backend`` runs as ``k6``): the histories, every
    epoch's product and ``last_full``."""
    from mpistragglers_jl_tpu import AsyncPool as JPool
    from mpistragglers_jl_tpu import asyncmap_fused as j_fused
    from mpistragglers_jl_tpu.parallel import PoolMeshCodedGemm as JPMCG
    from mpistragglers_jl_tpu.parallel import make_mesh as jmake_mesh
    from mpistragglers_jl_tpu.utils import faults as jfaults

    A, Bm, Bs = _win_inputs()
    fg = JPMCG(A, jmake_mesh(WIN_N), WIN_K, dtype=np.float64)
    out = {}
    try:
        for case, windows in WIN_CASES.items():
            coord = fg.device_coordinator(delay_fn=_win_delay(jfaults))
            pool, got = JPool(WIN_N), []
            for K in windows:
                hist = j_fused(pool, Bs if case == "per_epoch" else Bm,
                               coord, epochs=K)
                every = np.asarray(coord.last_decoded)
                got.append({"hist": hist,
                            "decoded": [coord.full(every[j])
                                        for j in range(K)],
                            "last_full": np.asarray(
                                coord.last_window["last_full"])})
            out[case] = got
    finally:
        fg.shutdown()
    return out


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("case", list(WIN_CASES))
@pytest.mark.parametrize("n_proc", [2, 4])
def test_mesh_window_across_processes_matches_jax(runs, jax_windows, n_proc,
                                                  case):
    """The histories equal the JAX package's mesh window's; every epoch's
    product and ``last_full`` lie within 1e-9 (relative) of JAX's and of
    ``A @ B``, the bound of ``tests/test_device_coord.py``."""
    A, Bm, Bs = _win_inputs()
    for res in _window_runs(runs, n_proc):
        got = res[case, "x"]["runs"]
        for a, w in zip(got, jax_windows[case]):
            np.testing.assert_array_equal(a["hist"], w["hist"])
            for j, (u, v) in enumerate(zip(a["decoded"], w["decoded"])):
                exact = A @ (Bs[j] if case == "per_epoch" else Bm)
                assert _rel(u, v) < 1e-9 and _rel(u, exact) < 1e-9, j
            exact = A @ (Bs[-1] if case == "per_epoch" else Bm)
            assert _rel(a["last_full"], w["last_full"]) < 1e-9
            assert _rel(a["last_full"], exact) < 1e-9


@pytest.mark.parametrize("n_proc", [2, 4])
def test_mesh_window_stores_only_this_process_results(runs, n_proc):
    """``pool.results`` holds, on each process, the fresh results of its
    own workers (bit-equal to the single-controller pool's) and leaves
    every other entry as it was."""
    for case in WIN_CASES:
        mine = []
        for res in _window_runs(runs, n_proc):
            x, s = res[case, "x"], res[case, "s"]
            assert len(x["workers"]) == WIN_N // n_proc
            mine += x["workers"]
            for i, (u, v) in enumerate(zip(x["results"], s["results"])):
                if i not in x["workers"]:
                    assert isinstance(u, str) and u == "untouched", (case, i)
                elif isinstance(v, str):
                    assert u == v, (case, i)
                else:
                    np.testing.assert_array_equal(u, v)
            fresh = np.flatnonzero(x["runs"][-1]["hist"][-1]
                                   == x["pool"]["epoch"])
            assert all(not isinstance(x["results"][i], str)
                       for i in fresh if i in x["workers"])
        assert sorted(mine) == list(range(WIN_N))


@pytest.mark.parametrize("guard", list(WIN_GUARDS))
@pytest.mark.parametrize("n_proc", [2, 4])
def test_mesh_window_guards_raise_on_every_process(runs, n_proc, guard):
    """A guard raises on every process together, also when only the
    last process's own pool, schedule or blocks trip it, and the job
    goes on: a window after them runs on every process alike."""
    got = _window_runs(runs, n_proc)
    want = WIN_GUARDS[guard](n_proc - 1)
    for res in got:
        assert want in res["guards"][guard], res["guards"][guard]
        np.testing.assert_array_equal(res["after"], got[0]["after"])


# -- the entry points that once refused a mesh across processes -------------------


@pytest.mark.parametrize("entry", LATER)
def test_later_entry_points_refuse_a_mesh_across_processes(slice_, entry):
    """Every entry point but the pool-fused GEMM runs over a mesh that
    spans the processes; the pool-fused GEMM refuses it, naming the
    other process and the JAX package's one-process limit."""
    for r, res in enumerate(slice_):
        msg = res["later"][entry]
        if entry in RUNS:
            assert msg == "ran", msg
            continue
        assert f"process(es) [{1 - r}], not by this one ({r})" in msg, msg
        assert ("PoolMeshCodedGemm runs over a mesh that one process drives "
                "whole, as in the JAX package") in msg, msg
        assert "ROADMAP" not in msg and "item " not in msg, msg


if __name__ == "__main__":
    _child(sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4])
