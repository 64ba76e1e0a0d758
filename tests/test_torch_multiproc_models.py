"""The models over a mesh that spans processes: the experts
(``models/moe.py`` ``moe_ffn_sharded`` and the MoE branch of the
sharded step and of the decode programs), the ring generator
(``make_ring_generate``), the serving tick (``make_serving_scan``),
speculation (``make_speculative``), the pipeline (GPipe, circular, and
1F1B with MoE stages) and the checkpointer on sharded leaves, over two
``gloo`` processes on the CPU.

One spawn for the module, with a timeout of its own: each child is
this file run as a script (it imports no JAX). It joins the job with
``initialize_multihost``, runs every case over ``make_multihost_mesh``
with the named axis crossing the processes ("x"), and again over a
single-controller mesh of eight CPU ranks in its own process ("s").
The parent draws every input first: the JAX package's ``init_params``
(carried into the children by ``params_from_jax``), tokens, caches and
keys from numpy seeds. The parent holds

* "x" to "s" bit for bit, in both processes, and both processes'
  values equal;
* "x" to the JAX package's mesh programs on its 8 host devices, with
  the tolerances of each part's contract file: the MoE forward within
  2e-4, its loss within 1e-5 relative, its gradients within 1e-4
  absolute and 1e-3 relative (``tests/test_torch_moe_sharded.py``);
  generated streams token for token (``test_torch_decode_sharded.py``);
  speculation's stream and verify count equal
  (``test_torch_speculative_sharded.py``); the serving tick's tokens,
  positions and done flags equal (``test_torch_serving_sharded.py``);
  the pipelines' losses within 1e-5 relative and their parameters after
  two SGD steps within 1e-5 (``test_torch_pipeline.py``);
* the 1F1B resume across processes bit-equal to the run it interrupted,
  and the step's files restored by the JAX package's
  ``TrainCheckpointer`` bit-equal to the saved leaves
  (``test_torch_train_checkpoint.py``);
* speculation moving every process's cursor by flat rank 0's count,
  broadcast once an iteration;
* the guards (a bad ``n_new``, a cache overflow, a chunk past the
  cache, a sampled tick without keys, a prompt of another length)
  raising on both processes, and both going on to the next program.

Run a child by hand: ``python tests/test_torch_multiproc_models.py
127.0.0.1:<port> <rank> <inputs.pkl> <out.pkl>`` in two shells, with
an ``inputs.pkl`` that the ``children`` fixture wrote.
"""

import functools
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240  # seconds for the spawn: a hang fails the module alone

AX4 = ("dp", "sp", "tp", "ep")
MOE = dict(vocab=61, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           n_experts=4, capacity_factor=4.0, moe_aux_coef=0.01)
DEC = dict(vocab=61, d_model=64, n_heads=8, n_kv_heads=2, n_layers=2,
           d_ff=128)
WIN = dict(DEC, attn_window=5)
MOE_DEC = dict(DEC, n_experts=2, capacity_factor=2.0)
PIPE = dict(vocab=61, d_model=32, n_heads=4, n_layers=4, d_ff=64)
CONFIGS = {
    "moe": MOE, "dec": DEC, "win": WIN, "moe_dec": MOE_DEC,
    "gpipe": PIPE, "circular": dict(PIPE, n_layers=8),
    "1f1b": dict(PIPE, n_experts=4, capacity_factor=1.25,
                 moe_aux_coef=0.01),
    "ckpt": dict(vocab=31, d_model=16, n_heads=2, n_layers=4, d_ff=32),
}
# (case, mesh shape, axis names, dcn_axis): the named axis crosses the
# processes (dcn_axis None: the outermost one, row-major)
MOE_STEP = [("ep", (2, 1, 2, 2), AX4, "ep"), ("dp", (2, 1, 2, 2), AX4, "dp")]
MOE_GEN = ((2, 2, 2), ("dp", "ep", "tp"), "ep")
DP = ((2, 4), ("dp", "tp"), "dp")
TP = ((4, 2), ("tp", "dp"), None)
RING = {"dp": DP, "tp": TP}
RING_MODES = {"greedy": {}, "int8": {"quantize_kv": True}}
SERVE = {"greedy": (DP, {}), "int8": (TP, {"quantize_kv": True}),
         "sampled": (DP, {"temperature": 0.8, "top_k": 7})}
SPEC_MESH = ((1, 8), ("dp", "tp"), None)
SPEC = {"ngram": (15, 4, None), "layers": (12, 3, 1)}  # n_new, k, drafter
# (config, mesh shape, n_microbatch, virtual stages); pp crosses
PIPES = {"gpipe": ((2, 4), 2, None), "circular": ((2, 2), 2, 2),
         "1f1b": ((4, 2), 2, None)}
FWD, LOSS, GRAD_ATOL, GRAD_RTOL, LEAF = 2e-4, 1e-5, 1e-4, 1e-3, 1e-5
LR = 0.1
B_GEN, TP_GEN, N_RING, S, N_INNER = 2, 7, 9, 4, 3


def _np(t):
    return t.detach().cpu().numpy()


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _batch(vocab, B, L, seed):
    d = _tokens(vocab, (B, L + 1), seed)
    return d[:, :-1], d[:, 1:]


# -- the children (no JAX) -------------------------------------------------


def _meshes(mh, shape, axes, dcn):
    from mpistragglers_jl_tpu_torch.parallel import make_mesh

    n = int(np.prod(shape))
    return {"x": mh.make_multihost_mesh(shape, axes, dcn_axis=dcn,
                                        devices=["cpu"] * (n // 2)),
            "s": make_mesh(shape, axes, devices=["cpu"] * n)}


def _moe_cases(mh, params) -> dict:
    from mpistragglers_jl_tpu_torch.models import decode as td
    from mpistragglers_jl_tpu_torch.models import transformer as tt
    from mpistragglers_jl_tpu_torch.parallel import collectives as col

    cfg = tt.TransformerConfig(**MOE)
    inp, tgt = _batch(cfg.vocab, 8, 16, seed=5)
    out = {}
    for name, shape, axes, dcn in MOE_STEP:
        res = {}
        for tag, mesh in _meshes(mh, shape, axes, dcn).items():
            sp = tt.shard_params(params["moe"], cfg, mesh)
            col.zero_exchanges()
            logits = tt.make_forward(cfg, mesh)(sp, inp).gather()
            loss, grads = tt.sharded_loss_and_grads(sp, inp, tgt, cfg, mesh)
            res[tag] = {"logits": _np(logits), "loss": _np(loss),
                        "grads": [_np(g.gather()) for g in tt._leaves(grads)],
                        "exchanges": col.EXCHANGES["calls"]}
        out[name] = res
    cfg = tt.TransformerConfig(**MOE_DEC)
    prompt = _tokens(cfg.vocab, (4, 8), seed=11)
    res = {}
    for tag, mesh in _meshes(mh, *MOE_GEN).items():
        sp = tt.shard_params(params["moe_dec"], cfg, mesh)
        gen = td.make_generate(cfg, mesh, 5, quantize_kv=True)
        res[tag] = _np(gen(sp, prompt).gather())
    out["generate_int8"] = res
    return out


def _ring_cases(mh, params) -> dict:
    from mpistragglers_jl_tpu_torch.models import decode as td
    from mpistragglers_jl_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(**WIN)
    prompt = _tokens(cfg.vocab, (B_GEN, TP_GEN), seed=12)
    out = {}
    for name, mesh_args in RING.items():
        meshes = _meshes(mh, *mesh_args)
        for mode, kw in RING_MODES.items():
            res = {}
            for tag, mesh in meshes.items():
                sp = tt.shard_params(params["win"], cfg, mesh)
                gen = td.make_ring_generate(cfg, mesh, N_RING, **kw)
                res[tag] = _np(gen(sp, prompt).gather())
            out[name, mode] = res
    return out


def _serve_cases(mh, params, inputs) -> dict:
    from mpistragglers_jl_tpu_torch.models import serving as ts
    from mpistragglers_jl_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(**WIN)
    out = {}
    for mode, (mesh_args, kw) in SERVE.items():
        tok, pos, done, caches, keys = inputs["serve"][mode]
        res = {}
        for tag, mesh in _meshes(mh, *mesh_args).items():
            sp = tt.shard_params(params["win"], cfg, mesh)
            f = ts.make_serving_scan(cfg, mesh, N_INNER,
                                     quantize_kv="quantize_kv" in kw,
                                     **{k: v for k, v in kw.items()
                                        if k != "quantize_kv"})
            got = f(sp, tok, pos, done,
                    [{k: torch.as_tensor(a) for k, a in c.items()}
                     for c in caches], keys)
            res[tag] = {
                "tok": _np(got[0].gather()), "pos": _np(got[1].gather()),
                "done": _np(got[2].gather()), "toks": _np(got[4].gather()),
                "caches": [{k: _np(a.gather()) for k, a in c.items()}
                           for c in got[3]]}
        out[mode] = res
    return out


def _spec_cases(mh, params) -> dict:
    import torch.distributed as dist

    from mpistragglers_jl_tpu_torch.models import speculative as tsp
    from mpistragglers_jl_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(**DEC)
    prompt = _tokens(cfg.vocab, (1, 8), seed=44)
    meshes = _meshes(mh, *SPEC_MESH)
    out = {}
    right = dist.broadcast
    for name, (n_new, k, layers) in SPEC.items():
        res = {}
        for tag, mesh in meshes.items():
            sp = tt.shard_params(params["dec"], cfg, mesh)
            run = tsp.make_speculative(cfg, mesh, 8, n_new, k=k,
                                       draft_layers=layers)
            calls = []

            def counted(t, src, *a, **kw):
                calls.append(src)
                return right(t, src, *a, **kw)

            dist.broadcast = counted
            try:
                toks, fwd = run(sp, prompt)
            finally:
                dist.broadcast = right
            res[tag] = {"toks": _np(toks.gather()), "forwards": fwd,
                        "broadcasts": calls}
        out[name] = res
    return out


def _pipe_cases(mh, params) -> dict:
    from mpistragglers_jl_tpu_torch.models import transformer as tt
    from mpistragglers_jl_tpu_torch.parallel import collectives as col
    from mpistragglers_jl_tpu_torch.parallel import pipeline as pl

    out = {}
    for sched, (shape, M, v) in PIPES.items():
        cfg = tt.TransformerConfig(**CONFIGS[sched])
        toks, tgts = _batch(cfg.vocab, 8, 16, seed=7)
        res = {}
        for tag, mesh in _meshes(mh, shape, ("dp", "pp"), "pp").items():
            sp = pl.shard_params_pipeline(params[sched], cfg, mesh,
                                          virtual_stages=v)
            step = pl.make_pipeline_train_step(
                cfg, mesh, n_microbatch=M, lr=LR, schedule=sched,
                virtual_stages=v or 2)
            col.zero_exchanges()
            losses = []
            for _ in range(2):
                sp, loss = step(sp, toks, tgts)
                losses.append(_np(loss))
            res[tag] = {"losses": losses,
                        "leaves": [_np(x.gather()) for x in tt._leaves(sp)],
                        "exchanges": col.EXCHANGES["calls"],
                        "busy": pl.measure_bubble(
                            mesh, M, sched, v=v or 2)["busy"]}
        out[sched] = res
    return out


def _ckpt_case(mh, params, directory) -> dict:
    from mpistragglers_jl_tpu_torch.models import transformer as tt
    from mpistragglers_jl_tpu_torch.parallel import pipeline as pl
    from mpistragglers_jl_tpu_torch.utils import TrainCheckpointer

    cfg = tt.TransformerConfig(**CONFIGS["ckpt"])
    toks, tgts = _batch(cfg.vocab, 4, 8, seed=0)
    rank = mh.process_index()
    res = {}
    for tag, mesh in _meshes(mh, (2, 2), ("dp", "pp"), "pp").items():
        step = pl.make_pipeline_train_step(cfg, mesh, n_microbatch=2, lr=LR,
                                           schedule="1f1b")
        ref = pl.shard_params_pipeline(params["ckpt"], cfg, mesh)
        for _ in range(4):
            ref, _ = step(ref, toks, tgts)
        cur = pl.shard_params_pipeline(params["ckpt"], cfg, mesh)
        for _ in range(2):
            cur, _ = step(cur, toks, tgts)
        # across processes one directory, written by process 0 alone
        d = os.path.join(directory, "x" if tag == "x" else f"s{rank}")
        ck = TrainCheckpointer(d)
        ck.save(2, cur)
        saved = [_np(x.gather()) for x in tt._leaves(cur)]
        restored, _, at = ck.restore(target=cur)
        fresh = all(a.local(r) is not b.local(r)
                    for a, b in zip(tt._leaves(restored), tt._leaves(cur))
                    for r in mesh.local_ranks())
        del cur
        for _ in range(2):
            restored, _ = step(restored, toks, tgts)
        res[tag] = {"saved": saved, "step": at, "fresh": fresh,
                    "resumed": [_np(x.gather())
                                for x in tt._leaves(restored)],
                    "ref": [_np(x.gather()) for x in tt._leaves(ref)],
                    "dir": d, "files": sorted(os.listdir(d))}
    return res


def _guards(mh, params, inputs) -> dict:
    """Each guard over a mesh across the processes: its message (both
    processes raise before any collective), then one program more."""
    from mpistragglers_jl_tpu_torch.models import decode as td
    from mpistragglers_jl_tpu_torch.models import serving as ts
    from mpistragglers_jl_tpu_torch.models import speculative as tsp
    from mpistragglers_jl_tpu_torch.models import transformer as tt

    cfg, dcfg = tt.TransformerConfig(**WIN), tt.TransformerConfig(**DEC)
    mesh = _meshes(mh, *DP)["x"]
    mesh18 = _meshes(mh, *SPEC_MESH)["x"]
    sp = tt.shard_params(params["win"], cfg, mesh)
    prompt = _tokens(cfg.vocab, (B_GEN, TP_GEN), seed=12)
    tok, pos, done, caches, _ = inputs["serve"]["greedy"]
    calls = {
        "ring_n_new": lambda: td.make_ring_generate(cfg, mesh, 0),
        "generate_max_len": lambda: td.make_generate(
            cfg, mesh, 6, max_len=TP_GEN + 2)(sp, prompt),
        "extend_past_cache": lambda: td.make_extend(cfg, mesh)(
            sp, prompt, td.init_cache(cfg, B_GEN, 4, mesh, device="cpu"), 0),
        "serving_keys": lambda: ts.make_serving_scan(
            cfg, mesh, 2, temperature=0.8)(
            sp, tok, pos, done, [{k: torch.as_tensor(a) for k, a in
                                  c.items()} for c in caches]),
        "speculative_prompt": lambda: tsp.make_speculative(
            dcfg, mesh18, 8, 4)(
            tt.shard_params(params["dec"], dcfg, mesh18),
            _tokens(61, (1, 6), seed=1)),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = "ran"
        except ValueError as e:
            out[name] = str(e)
    out["after"] = _np(td.make_ring_generate(cfg, mesh, N_RING)(
        sp, prompt).gather())
    return out


def _child(addr, rank, inputs_path, out_path) -> None:
    torch.set_num_threads(1)
    from mpistragglers_jl_tpu_torch.models import transformer as tt
    from mpistragglers_jl_tpu_torch.parallel import multihost as mh

    mh.initialize_multihost(addr, num_processes=2, process_id=rank,
                            device="cpu")
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    params = {k: tt.params_from_jax(v, "cpu")
              for k, v in inputs["params"].items()}
    res = {"moe": _moe_cases(mh, params),
           "ring": _ring_cases(mh, params),
           "serve": _serve_cases(mh, params, inputs),
           "spec": _spec_cases(mh, params),
           "guards": _guards(mh, params, inputs),
           "pipe": _pipe_cases(mh, params),
           "ckpt": _ckpt_case(mh, params, inputs["dir"])}
    import torch.distributed as dist

    dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


# -- the parent ------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_inputs(mode, quantize_kv):
    """A tick's inputs, as tests/test_torch_serving_sharded.py draws
    them: (tok, pos, done, caches laid out for tp=4, keys' data)."""
    import jax

    from mpistragglers_jl_tpu_torch.models import decode as td

    cfg = CONFIGS["win"]
    seed = {"greedy": 0, "int8": 3, "sampled": 2}[mode]
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, 61, S).astype(np.int32)
    pos = rng.integers(3, 9, S).astype(np.int32)
    done = np.zeros(S, bool)
    hd = cfg["d_model"] // cfg["n_heads"]
    slot = np.arange(4) * cfg["n_kv_heads"] // 4  # kv heads 2 < tp 4
    caches = []
    for _ in range(cfg["n_layers"]):
        layer = {}
        for kk in ("k", "v"):
            x = torch.as_tensor(rng.standard_normal(
                (S, cfg["attn_window"], cfg["n_kv_heads"], hd)) * 0.1,
                dtype=torch.float32)[:, :, slot]
            if quantize_kv:
                q, s_ = td._kv_quantize(x)
                layer[kk], layer[kk + "_s"] = q.numpy(), s_.numpy()
            else:
                layer[kk] = x.numpy()
        caches.append(layer)
    keys = (np.asarray(jax.random.key_data(jax.random.split(
        jax.random.key(4), S))) if mode == "sampled" else None)
    return tok, pos, done, caches, keys


SEEDS = {"moe": 1, "dec": 4, "win": 10, "moe_dec": 10, "gpipe": 2,
         "circular": 2, "1f1b": 3, "ckpt": 1}


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    import jax

    from mpistragglers_jl_tpu.models import transformer as jt

    jcfg = jt.TransformerConfig(**CONFIGS[name])
    jp = jt.init_params(jcfg, SEEDS[name])
    return jcfg, jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Write the inputs, spawn the two children; the fixture's value
    waits for them (the parent's JAX programs compile meanwhile)."""
    tmp = str(tmp_path_factory.mktemp("multiproc_models"))
    inputs = {"params": {k: _jax_params(k)[2] for k in CONFIGS},
              "serve": {m: _serve_inputs(m, "quantize_kv" in kw)
                        for m, (_, kw) in SERVE.items()},
              "dir": os.path.join(tmp, "ckpt")}
    path = os.path.join(tmp, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    addr = f"127.0.0.1:{_free_port()}"
    outs = [os.path.join(tmp, f"out_{r}.pkl") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), addr, str(r), path, o],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r, o in enumerate(outs)]
    done = []

    def get():
        if not done:
            try:
                for p in procs:
                    _, err = p.communicate(timeout=TIMEOUT)
                    assert p.returncode == 0, err[-4000:]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            for o in outs:
                with open(o, "rb") as f:
                    done.append(pickle.load(f))
        return done

    yield get
    for p in procs:
        if p.poll() is None:
            p.kill()


def _jmesh(shape, axes):
    from mpistragglers_jl_tpu.parallel import make_mesh as jmake_mesh

    return jmake_mesh(shape, axes)


def _put(jmesh, a, spec):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    return jax.device_put(jnp.asarray(a), NamedSharding(jmesh, spec))


def _equal(a, b, what=""):
    """Nested values equal bit for bit."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def _without(res, *keys):
    """Both tags' values of one case, less ``keys``."""
    return {t: {k: v for k, v in res[t].items() if k not in keys}
            for t in ("x", "s")}


def _across_equals_single(runs, get):
    """In each process "x" equals "s" bit for bit, and the processes'
    "x" values are equal."""
    for res in runs:
        x, s = get(res)["x"], get(res)["s"]
        _equal(x, s, "x vs s")
    _equal(get(runs[0])["x"], get(runs[1])["x"], "process 0 vs 1")


# -- the experts -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_moe():
    import jax

    from mpistragglers_jl_tpu.models import transformer as jt

    jcfg, jp, _ = _jax_params("moe")
    inp, tgt = _batch(jcfg.vocab, 8, 16, seed=5)
    jmesh = _jmesh((2, 1, 2, 2), AX4)
    spec = jt.data_spec(jcfg)
    sp = jt.shard_params(jp, jcfg, jmesh)
    logits = np.asarray(jt.make_forward(jcfg, jmesh)(
        sp, _put(jmesh, inp, spec)))
    loss, grads = jax.value_and_grad(jax.jit(jt._make_loss_fn(jcfg, jmesh)))(
        sp, _put(jmesh, inp, spec), _put(jmesh, tgt, spec))
    return logits, float(loss), [np.asarray(g) for g in
                                 jax.tree.leaves(grads)]


@pytest.mark.parametrize("case", [c[0] for c in MOE_STEP])
def test_moe_step_across_processes_matches_jax(children, case):
    logits, loss, grads = _jax_moe()
    for res in children():
        x = res["moe"][case]["x"]
        assert x["exchanges"] > 0
        np.testing.assert_allclose(x["logits"], logits, atol=FWD, rtol=FWD)
        np.testing.assert_allclose(float(x["loss"]), loss, rtol=LOSS)
        assert len(x["grads"]) == len(grads)
        for i, (a, b) in enumerate(zip(x["grads"], grads)):
            np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=f"grad leaf {i}")


@pytest.mark.parametrize("case", [c[0] for c in MOE_STEP])
def test_moe_step_across_processes_equals_single_controller(children, case):
    runs = children()
    for res in runs:  # the single-controller mesh exchanges nothing
        assert res["moe"][case]["s"]["exchanges"] == 0
    _across_equals_single(runs, lambda r: _without(r["moe"][case],
                                                   "exchanges"))


def test_moe_int8_generate_across_processes(children):
    """MoE int8 ``make_generate`` on ("dp", "ep", "tp") with ep across
    the processes: the JAX mesh program's stream, and the
    single-controller one bit for bit."""
    from mpistragglers_jl_tpu.models import decode as jd
    from mpistragglers_jl_tpu.models import transformer as jt
    from jax.sharding import PartitionSpec as JP

    jcfg, jp, _ = _jax_params("moe_dec")
    jmesh = _jmesh((2, 2, 2), ("dp", "ep", "tp"))
    prompt = _tokens(jcfg.vocab, (4, 8), seed=11)
    want = np.asarray(jd.make_generate(jcfg, jmesh, 5, quantize_kv=True)(
        jt.shard_params(jp, jcfg, jmesh),
        _put(jmesh, prompt, JP(("dp", "ep"), None))))
    runs = children()
    _across_equals_single(runs, lambda r: r["moe"]["generate_int8"])
    np.testing.assert_array_equal(runs[0]["moe"]["generate_int8"]["x"], want)


# -- the ring generator --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_ring(mode):
    from mpistragglers_jl_tpu.models import decode as jd
    from mpistragglers_jl_tpu.models import transformer as jt
    from jax.sharding import PartitionSpec as JP

    jcfg, jp, _ = _jax_params("win")
    jmesh = _jmesh((2, 4), ("dp", "tp"))
    prompt = _tokens(jcfg.vocab, (B_GEN, TP_GEN), seed=12)
    return np.asarray(jd.make_ring_generate(jcfg, jmesh, N_RING,
                                            **RING_MODES[mode])(
        jt.shard_params(jp, jcfg, jmesh), _put(jmesh, prompt,
                                               JP("dp", None))))


@pytest.mark.parametrize("mode", list(RING_MODES))
@pytest.mark.parametrize("case", list(RING))
def test_ring_generate_across_processes_matches_jax(children, case, mode):
    for res in children():
        np.testing.assert_array_equal(res["ring"][case, mode]["x"],
                                      _jax_ring(mode))


@pytest.mark.parametrize("mode", list(RING_MODES))
@pytest.mark.parametrize("case", list(RING))
def test_ring_generate_across_processes_equals_single_controller(
        children, case, mode):
    _across_equals_single(children(), lambda r: r["ring"][case, mode])


# -- the serving tick ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_tick(mode):
    import jax
    import jax.numpy as jnp

    from mpistragglers_jl_tpu.models import serving as js

    jcfg, jp, _ = _jax_params("win")
    (_, kw) = SERVE[mode]
    tok, pos, done, caches, keys = _serve_inputs(
        mode, "quantize_kv" in kw)
    if keys is None:
        keys = jax.random.split(jax.random.key(0), S)
    else:
        keys = jax.random.wrap_key_data(jnp.asarray(keys))
    out = js.make_serving_scan(jcfg, _jmesh((2, 4), ("dp", "tp")), N_INNER,
                               **kw)(
        jp, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(done),
        [{k: jnp.asarray(a) for k, a in c.items()} for c in caches], keys)
    return [np.asarray(v) for v in (out[0], out[1], out[2], out[4])]


@pytest.mark.parametrize("mode", list(SERVE))
def test_serving_tick_across_processes_matches_jax(children, mode):
    tok, pos, done, toks = _jax_tick(mode)
    for res in children():
        x = res["serve"][mode]["x"]
        np.testing.assert_array_equal(x["toks"], toks)
        np.testing.assert_array_equal(x["tok"], tok)
        np.testing.assert_array_equal(x["pos"], pos)
        np.testing.assert_array_equal(x["done"], done)


@pytest.mark.parametrize("mode", list(SERVE))
def test_serving_tick_across_processes_equals_single_controller(children,
                                                                mode):
    _across_equals_single(children(), lambda r: r["serve"][mode])


# -- speculation ---------------------------------------------------------------


@pytest.mark.parametrize("name", list(SPEC))
def test_speculative_across_processes_matches_jax(children, name):
    from mpistragglers_jl_tpu.models import speculative as js
    from mpistragglers_jl_tpu.models import transformer as jt

    n_new, k, layers = SPEC[name]
    jcfg, jp, _ = _jax_params("dec")
    jmesh = _jmesh((1, 8), ("dp", "tp"))
    packed = np.asarray(js.make_speculative(
        jcfg, jmesh, 8, n_new, k=k, draft_layers=layers)(
            jt.shard_params(jp, jcfg, jmesh),
            _tokens(jcfg.vocab, (1, 8), seed=44)))
    for res in children():
        x = res["spec"][name]["x"]
        np.testing.assert_array_equal(x["toks"], packed[None, :n_new])
        assert x["forwards"] == int(packed[n_new])


@pytest.mark.parametrize("name", list(SPEC))
def test_speculative_across_processes_moves_by_rank0_count(children, name):
    """Stream and verify count bit-equal to the single-controller
    program's; across processes each verify iteration broadcasts flat
    rank 0's accepted count once from process 0, which drives it, and
    nothing is broadcast on the single-controller mesh."""
    runs = children()
    for res in runs:
        x, s = res["spec"][name]["x"], res["spec"][name]["s"]
        assert x["broadcasts"] == [0] * x["forwards"], x["broadcasts"]
        assert s["broadcasts"] == []
    _across_equals_single(runs, lambda r: _without(r["spec"][name],
                                                   "broadcasts"))


# -- the pipeline -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_pipe(sched):
    import jax

    from mpistragglers_jl_tpu.parallel import pipeline as jpl
    from jax.sharding import PartitionSpec as JP

    shape, M, v = PIPES[sched]
    jcfg, jp, _ = _jax_params(sched)
    jmesh = _jmesh(shape, ("dp", "pp"))
    toks, tgts = _batch(jcfg.vocab, 8, 16, seed=7)
    params = jpl.shard_params_pipeline(jp, jcfg, jmesh, virtual_stages=v)
    step = jpl.make_pipeline_train_step(jcfg, jmesh, n_microbatch=M, lr=LR,
                                        schedule=sched,
                                        virtual_stages=v or 2)
    losses = []
    for _ in range(2):
        params, loss = step(params, _put(jmesh, toks, JP("dp")),
                            _put(jmesh, tgts, JP("dp")))
        losses.append(float(loss))
    return losses, [np.asarray(x) for x in jax.tree.leaves(params)]


@pytest.mark.parametrize("sched", list(PIPES))
def test_pipeline_across_processes_matches_jax(children, sched):
    losses, leaves = _jax_pipe(sched)
    for res in children():
        x = res["pipe"][sched]["x"]
        assert x["exchanges"] > 0  # the hops cross the processes
        np.testing.assert_allclose([float(a) for a in x["losses"]], losses,
                                   rtol=LOSS)
        assert len(x["leaves"]) == len(leaves)
        for i, (a, b) in enumerate(zip(x["leaves"], leaves)):
            np.testing.assert_allclose(a, b, atol=LEAF, rtol=LEAF,
                                       err_msg=f"leaf {i}")


@pytest.mark.parametrize("sched", list(PIPES))
def test_pipeline_across_processes_equals_single_controller(children,
                                                            sched):
    """Losses, parameters after two steps and the ``measure_bubble``
    masks bit-equal to the single-controller run's."""
    runs = children()
    for res in runs:
        assert res["pipe"][sched]["s"]["exchanges"] == 0
    _across_equals_single(runs, lambda r: _without(r["pipe"][sched],
                                                   "exchanges"))


# -- the checkpointer ----------------------------------------------------------


def test_1f1b_resume_across_processes_is_bit_equal(children):
    """Save a sharded 1F1B state with pp across the processes (one
    directory, written by process 0 alone), restore it into each
    process's positions, and the resumed run equals the uninterrupted
    one bit for bit, and the single-controller run's."""
    runs = children()
    for res in runs:
        x = res["ckpt"]["x"]
        assert x["step"] == 2 and x["fresh"]
        assert x["files"] == ["step_2"]
        _equal(x["resumed"], x["ref"], "resumed vs uninterrupted")
    assert runs[0]["ckpt"]["x"]["dir"] == runs[1]["ckpt"]["x"]["dir"]
    _across_equals_single(runs, lambda r: _without(r["ckpt"], "dir"))


def test_checkpoint_across_processes_loads_in_jax(children):
    """The JAX package's ``TrainCheckpointer`` (its npz route) restores
    the step written across processes into its own pipeline layout, bit
    for bit the leaves saved."""
    import jax

    from mpistragglers_jl_tpu.parallel import pipeline as jpl
    from mpistragglers_jl_tpu.utils.train_checkpoint import (
        TrainCheckpointer as RefCheckpointer)

    runs = children()
    x = runs[0]["ckpt"]["x"]
    jcfg, jp, _ = _jax_params("ckpt")
    like = jpl.shard_params_pipeline(jp, jcfg, _jmesh((2, 2), ("dp", "pp")))
    ref = RefCheckpointer(x["dir"])
    ref._ocp = None  # the JAX package's npz route
    state, _, step = ref.restore(target=like)
    assert step == 2
    got = [np.asarray(a) for a in jax.tree.leaves(state)]
    assert len(got) == len(x["saved"])
    for a, b in zip(got, x["saved"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -- the guards ----------------------------------------------------------------


def test_guards_raise_on_both_processes_without_a_hang(children):
    """Each guard raises on both processes with the same message, before
    any collective, and both go on to run the next program together."""
    want = {"ring_n_new": "n_new must be >= 1",
            "generate_max_len": f"max_len {TP_GEN + 2} < prompt",
            "extend_past_cache": "does not fit the cache",
            "serving_keys": "temperature > 0 needs the slots' keys",
            "speculative_prompt": "made for a (1, Tp=8) prompt"}
    runs = children()
    for res in runs:
        for name, text in want.items():
            assert text in res["guards"][name], (name, res["guards"][name])
    _equal(runs[0]["guards"], runs[1]["guards"], "process 0 vs 1")
    np.testing.assert_array_equal(runs[0]["guards"]["after"],
                                  _jax_ring("greedy"))


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4])
