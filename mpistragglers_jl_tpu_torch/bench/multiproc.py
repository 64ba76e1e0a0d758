"""The mesh plane across processes on one card: two processes, one
``("dp", "sp", "tp")`` mesh.

Spawns two processes on cuda:0. Each first asks for ``nccl`` (two
processes on one card: refused by name, asking for ``gloo``), then
joins the job with ``initialize_multihost(..., backend="gloo",
device="cuda:0")``: the collectives across processes then move their
bytes through host memory. Each process drives four ranks of
``make_multihost_mesh((2, 2, 2), ("dp", "sp", "tp"), dcn_axis="dp")``
(dp across the processes) and of ``((2, 4), ("dp", "tp"))``:

(a) f32, TF32 off, the training cell of ``bench/train_profile.py`` at 2
    layers and batch 2: one SGD step's loss and leaves against the same
    step on a single-controller (2, 2, 2) mesh of eight ranks that the
    process runs itself, bit for bit, with a control (the bytes that
    cross processes dropped: the loss moves); then ``make_generate`` on
    (2, 4) at ``bench/configs.py`` ``DECODE``'s width (2 layers, B=8,
    prompt 504, 8 new), greedy and int8: the streams against the
    single-controller ones;
(b) bf16 at full width: ``SGD_STEPS`` steps of the training cell (8
    layers, batch 8, sequence 2048; the first one a warm-up, the last
    one timed), the final parameters written by process 0 to
    ``<out>/params.pt`` for the caller's update check; then
    ``make_generate`` int8 on (2, 4) (B=8, prompt 2048, 16 new).

Then the models of ROADMAP item 18h's parts (i) and (ii), each with
the named axis across the processes:

(a) f32, TF32 off, 2 layers (4 for the pipelines), each run both
    across the processes and on a single-controller mesh of the same
    shape that the process runs itself, bit for bit: the
    expert-parallel step of ``bench/moe_train.py``'s model (batch 4) on
    ``("dp", "sp", "tp", "ep")`` = (2, 1, 2, 2), ep across;
    ``make_ring_generate`` int8 on (2, 4), dp across (B=8, a 1030-token
    prompt that wraps the 1024-slot window, 8 new); the int8 serving
    tick on (2, 4), dp across (S=8, 8 inner steps); ``make_speculative``
    on (1, 8), tp across (prompt 64, 16 new, k 4, the n-gram drafter);
    GPipe and circular on (1, 2) and 1F1B with MoE stages on (2, 2), pp
    across (batch 4, 2 microbatches), the 1F1B state then saved by
    ``TrainCheckpointer`` (one directory, process 0 writing), restored
    and stepped again against the run it interrupted;
(b) bf16 at full width, a warm-up and one timed step or tick each: the
    EP step (8 layers, batch 8, sequence 2048) on (2, 1, 2, 2), ep
    across; ``bench/pipeline_train.py``'s ``1f1b`` cell on (4, 2), pp
    across; the int8 serving tick at ``bench/serving_profile.py``'s
    width on (2, 4), dp across (S=8, a 4-step warm-up tick, then 32
    inner steps).

Then the device coordinator's mesh window (``parallel/device_coord.py``)
over ``("w",)`` of 8, four ranks a process, MDS (8, 6) on phase 56's
straggling schedule (:func:`_window`):

(a) f64 at phase 56's shape (A 384x256, B 256x64), K=6 then K=4 back
    to back, across the processes and on a single-controller mesh of
    eight ranks that the process runs itself, bit for bit, and
    ``last_full`` against ``A @ B``; the exchanges a window (K
    reduce-scatters, the ring, the digest);
(b) config 3's width at ``"default"`` (``bench/device_coord.py``: A
    8196x8192 coded, B 8192x8192): a K=1 warm-up window and a timed K=2
    one, the histories against the flat window's on the card, the
    product against the flat window's decode and ``A @ B``.

Every run's parameters are ``init_params(cfg, seed=0)`` of its
configuration (:data:`CONFIGS`), drawn on the host by one background
thread in the order the runs need them, while the runs before them use
the card (numpy's draws release the interpreter lock), and moved to the
card when a run takes them: the same bits as drawing them there.

Every run counts its kernel launches (per process: each rank this
process drives launches its own). The kernels must be built before the
spawn (``ops/_build.build``): the processes load them, never build.
Each process writes ``<out>/rank<r>.json``; :func:`wait` returns both.
The timed runs also report their exchanges across processes
(``collectives.EXCHANGES``: ``exchanges``, ``exchange_ms``,
``exchange_gb``, this process's payloads).

    python -m mpistragglers_jl_tpu_torch.bench.multiproc
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..models import decode as td
from ..models import serving as sv
from ..models import speculative as tsp
from ..models.transformer import (
    TransformerConfig,
    _leaves,
    _to,
    init_params,
    make_train_step,
    shard_params,
    sharded_loss_and_grads,
)
from ..ops.coding import MDSCode
from ..parallel import collectives as col
from ..parallel import make_mesh
from ..parallel import multihost as mh
from ..parallel.device_coord import DeviceCoordinator
from ..parallel.pipeline import (
    make_pipeline_train_step,
    shard_params_pipeline,
)
from ..pool import AsyncPool, asyncmap_fused
from ..utils import faults
from ..utils.train_checkpoint import TrainCheckpointer
from .coded_gemm import MDS_M, _operands, rel_err
from .configs import DECODE
from .device_coord import CONFIG3_SEED
from .moe_train import moe_config
from .pipeline_train import CELLS, V
from .serving_profile import MODEL
from .train_profile import LR, TRAIN, launch_counts, train_batch, \
    zero_launches

AXES = ("dp", "sp", "tp")
MESH = (2, 2, 2)
GEN_AXES = ("dp", "tp")
GEN_MESH = (2, 4)
F32_LAYERS, F32_BATCH = 2, 2
GEN_F32 = (8, 504, 8)      # (B, prompt, n_new): 512 positions, a K5 block
GEN_BF16 = (8, 2048, 16)   # chip_smoke.py phase 59(b)'s (2, 4) run
SGD_STEPS = 2
EP_AXES, EP_MESH = ("dp", "sp", "tp", "ep"), (2, 1, 2, 2)
MOE_F32_BATCH = 4
RING_F32 = (8, 1030, 8)    # (B, prompt, n_new): the prompt wraps W=1024
TICK_F32 = (8, 8)          # (S, inner steps)
SPEC_F32 = (64, 16, 4)     # (prompt, n_new, k), the n-gram drafter
PIPE_F32_LAYERS = 4
PIPE_F32 = {"gpipe": (1, 2), "circular": (1, 2), "1f1b": (2, 2)}  # M = 2
TICK_BF16 = (8, 4, 32)     # (S, warm-up inner steps, timed inner steps)
WIN_N, WIN_K = 8, 6        # the device coordinator's (8, 6) MDS pool
WIN_F64 = (384, 256, 64)   # (a): A (6 * 64, 256), B (256, 64), phase 56's
WIN_KS = (6, 4)            # (a): two windows back to back
WIN_C3 = (1, 2)            # (b): a warm-up window, then the timed one
F32, BF16 = torch.float32, torch.bfloat16
# every configuration the processes initialise, in the order they need it
CONFIGS = {
    "train_f32": TransformerConfig(**{**TRAIN, "n_layers": F32_LAYERS},
                                   dtype=F32),
    "decode_f32": TransformerConfig(**{**DECODE, "n_layers": F32_LAYERS},
                                    dtype=F32),
    "train_bf16": TransformerConfig(**TRAIN, dtype=BF16),
    "decode_bf16": TransformerConfig(**DECODE, dtype=BF16),
    "moe_f32": moe_config(F32, n_layers=F32_LAYERS),
    "pipe_f32": TransformerConfig(**{**TRAIN, "n_layers": PIPE_F32_LAYERS},
                                  dtype=F32),
    "pipe_moe_f32": moe_config(F32, n_layers=PIPE_F32_LAYERS),
    "moe_bf16": moe_config(),
}
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def prompt(vocab: int, B: int, Tp: int, seed: int) -> np.ndarray:
    """Prompts as the reference's decode benches draw them."""
    return np.random.default_rng(seed).integers(0, vocab, (B, Tp))


def _counted(fn):
    """``fn()`` between a reset of the launch counts (and of
    ``collectives.EXCHANGES``) and a read: (its result, seconds, the
    nonzero counts)."""
    torch.cuda.synchronize()
    zero_launches()
    col.zero_exchanges()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {
        k: v for k, v in launch_counts().items() if v}


def _prefetch(pool) -> dict:
    """Each of :data:`CONFIGS`' seed-0 parameter trees, drawn on the
    host by ``pool``'s one thread in order: name -> future."""
    return {name: pool.submit(init_params, cfg, seed=0, device="cpu")
            for name, cfg in CONFIGS.items()}


def _take(trees, name, dev):
    """(config, parameters on ``dev``) of one of :data:`CONFIGS`."""
    return CONFIGS[name], _to(trees[name].result(), dev)


def _meshes(dev, shape, axes, dcn):
    n = int(np.prod(shape))
    return {"x": mh.make_multihost_mesh(shape, axes, dcn_axis=dcn,
                                        devices=[dev] * (n // 2)),
            "s": make_mesh(shape, axes, devices=[dev] * n)}


def _f32(dev, trees) -> dict:
    cfg, params = _take(trees, "train_f32", dev)
    inp, tgt = (t[:F32_BATCH] for t in train_batch(cfg.vocab, dev))
    out, got = {}, {}
    meshes = _meshes(dev, MESH, AXES, "dp")
    for tag, mesh in meshes.items():
        sp = shard_params(params, cfg, mesh)
        step = make_train_step(cfg, mesh, lr=LR)
        (sp2, loss), dt, k = _counted(lambda: step(sp, inp, tgt))
        got[tag] = (loss, [x.gather(dev) for x in _leaves(sp2)])
        out[f"step_{tag}"] = {"loss": loss.item(), "s": dt, "launches": k}
        if tag == "x":
            with col.exchanges_dropped():
                out["ctrl_loss"] = sharded_loss_and_grads(
                    sp, inp, tgt, cfg, mesh)[0].item()
        del sp, sp2
    (lx, px), (ls, ps) = got["x"], got["s"]
    out["step_bit_equal"] = bool(torch.equal(lx, ls) and all(
        torch.equal(a, b) for a, b in zip(px, ps)))
    del got, px, ps, params
    cfg, params = _take(trees, "decode_f32", dev)
    B, Tp, n_new = GEN_F32
    pr = prompt(cfg.vocab, B, Tp, seed=60)
    for name, kw in (("greedy", {}), ("int8", {"quantize_kv": True})):
        streams = {}
        for tag, mesh in _meshes(dev, GEN_MESH, GEN_AXES, "dp").items():
            sp = shard_params(params, cfg, mesh)
            gen = td.make_generate(cfg, mesh, n_new, **kw)
            toks, dt, k = _counted(lambda: gen(sp, pr))
            streams[tag] = toks.gather()
            out[f"generate_{name}_{tag}"] = {"s": dt, "launches": k}
        out[f"generate_{name}_equal"] = bool(torch.equal(streams["x"],
                                                         streams["s"]))
    return out


def _exchanges() -> dict:
    """:data:`collectives.EXCHANGES` since the last reset, in the
    report's units."""
    ex = col.EXCHANGES
    return {"exchange_ms": ex["seconds"] * 1e3,
            "exchange_gb": ex["bytes"] / 1e9, "exchanges": ex["calls"]}


def _timed_steps(step, params, inp, tgt, dev):
    """``SGD_STEPS`` steps (the last one timed) between a reset of the
    launch counts and a read: (params, report), the exchanges the timed
    step's."""
    torch.cuda.synchronize()
    zero_launches()
    losses, times = [], []
    for _ in range(SGD_STEPS):
        col.zero_exchanges()  # the last step's are read
        t0 = time.perf_counter()
        params, loss = step(params, inp, tgt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    return params, {
        "losses": losses, "step_s": times, "ms_per_step": times[-1] * 1e3,
        **_exchanges(),
        "launches": {k: v for k, v in launch_counts().items() if v},
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def _bf16(dev, out_dir: str, trees) -> dict:
    cfg, params = _take(trees, "train_bf16", dev)
    inp, tgt = train_batch(cfg.vocab, dev)
    mesh = _meshes(dev, MESH, AXES, "dp")["x"]
    sp = shard_params(params, cfg, mesh)
    del params
    step = make_train_step(cfg, mesh, lr=LR, donate=True)
    sp, out = _timed_steps(step, sp, inp, tgt, dev)
    final = [x.gather() for x in _leaves(sp)]
    if mh.process_index() == 0:
        torch.save(final, os.path.join(out_dir, "params.pt"))
    del sp, final
    cfg, params = _take(trees, "decode_bf16", dev)
    B, Tp, n_new = GEN_BF16
    mesh = _meshes(dev, GEN_MESH, GEN_AXES, "dp")["x"]
    sp = shard_params(params, cfg, mesh)
    del params
    gen = td.make_generate(cfg, mesh, n_new, quantize_kv=True)
    toks, dt, k = _counted(lambda: gen(sp, prompt(cfg.vocab, B, Tp, 1)))
    out["generate_int8"] = {"s": dt, "launches": k,
                            "stream": toks.gather().tolist()}
    return out


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _runs(dev, shape, axes, dcn, fn) -> tuple[dict, dict]:
    """``fn(mesh)`` -> (a list of tensors, report) across the processes
    ("x") and on the single-controller mesh ("s"), between a reset of
    the launch counts and a read: ({tag: report with ``s`` and
    ``launches``}, {tag: tensors})."""
    reps, vals = {}, {}
    for tag, mesh in _meshes(dev, shape, axes, dcn).items():
        (vals[tag], rep), dt, k = _counted(lambda: fn(mesh))
        reps[tag] = {**rep, "s": dt, "launches": k}
    return reps, vals


def _models_f32(dev, out_dir: str, trees) -> dict:
    """(a) for item 18h's parts (i) and (ii): each run across the
    processes and on the single-controller mesh, bit for bit."""
    out = {}

    def put(name, reps, vals):
        out[name] = {**reps, "bit_equal": _equal(vals["x"], vals["s"])}

    cfg, params = _take(trees, "moe_f32", dev)
    inp, tgt = (t[:MOE_F32_BATCH] for t in train_batch(cfg.vocab, dev))

    def ep_step(mesh):
        sp, loss = make_train_step(cfg, mesh, lr=LR)(
            shard_params(params, cfg, mesh), inp, tgt)
        return [loss] + [x.gather(dev) for x in _leaves(sp)], {
            "loss": loss.item()}

    put("ep_step", *_runs(dev, EP_MESH, EP_AXES, "ep", ep_step))
    cfg, params = _take(trees, "decode_f32", dev)
    cfg = dataclasses.replace(cfg, attn_window=MODEL["attn_window"])
    B, Tp, n_new = RING_F32
    pr = prompt(cfg.vocab, B, Tp, seed=61)

    def ring(mesh):
        gen = td.make_ring_generate(cfg, mesh, n_new, quantize_kv=True)
        return [gen(shard_params(params, cfg, mesh), pr).gather()], {}

    put("ring_int8", *_runs(dev, GEN_MESH, GEN_AXES, "dp", ring))
    S, inner = TICK_F32
    W = cfg.attn_window
    rng = np.random.default_rng(62)
    tok = rng.integers(1, cfg.vocab, S).astype(np.int32)
    pos = rng.integers(W // 2, 3 * W, S).astype(np.int32)  # some wrapped
    gen = torch.Generator().manual_seed(62)
    # kv heads 2 < tp 4: head slot t holds kv head t * kv_heads // tp
    slot = torch.arange(GEN_MESH[1]) * cfg.kv_heads // GEN_MESH[1]
    caches = []
    for _ in range(cfg.n_layers):
        layer = {}
        for kk in ("k", "v"):
            x = torch.randn((S, W, cfg.kv_heads, cfg.head_dim),
                            generator=gen)[:, :, slot]
            layer[kk], layer[kk + "_s"] = (
                t.to(dev) for t in td._kv_quantize(x))
        caches.append(layer)

    def tick(mesh):
        f = sv.make_serving_scan(cfg, mesh, inner, quantize_kv=True)
        res = f(shard_params(params, cfg, mesh), tok, pos, np.zeros(S, bool),
                [dict(c) for c in caches])
        return [v.gather() for v in res[:3] + (res[4],)] + [
            a.gather(dev) for c in res[3] for a in c.values()], {}

    put("tick_int8", *_runs(dev, GEN_MESH, GEN_AXES, "dp", tick))
    del caches
    Tp, n_new, k = SPEC_F32
    pr = prompt(cfg.vocab, 1, Tp, seed=63)

    def spec(mesh):
        toks, fwd = tsp.make_speculative(cfg, mesh, Tp, n_new, k=k)(
            shard_params(params, cfg, mesh), pr)
        return [toks.gather()], {"forwards": fwd}

    put("speculative", *_runs(dev, (1, 8), ("dp", "tp"), None, spec))
    del params
    for sched, shape in PIPE_F32.items():
        cfg, params = _take(trees, "pipe_moe_f32" if sched == "1f1b"
                            else "pipe_f32", dev)
        inp, tgt = (t[:MOE_F32_BATCH] for t in train_batch(cfg.vocab, dev))
        v = V if sched == "circular" else None
        held = {}

        def pipe(mesh):
            step = make_pipeline_train_step(cfg, mesh, n_microbatch=2, lr=LR,
                                            schedule=sched, virtual_stages=V)
            sp, loss = step(shard_params_pipeline(params, cfg, mesh,
                                                  virtual_stages=v),
                            inp, tgt)
            held["x" if mesh.spans_processes else "s"] = (step, sp)
            return [loss] + [x.gather(dev) for x in _leaves(sp)], {
                "loss": loss.item()}

        put(sched, *_runs(dev, shape, ("dp", "pp"), "pp", pipe))
        if sched == "1f1b":
            out["resume"] = _resume(held, inp, tgt, dev, out_dir)
        del params, held
    return out


def _resume(held, inp, tgt, dev, out_dir: str) -> dict:
    """The checkpointer on a stepped state (``held``: tag -> (step,
    params)): saved (across the processes into one directory, process 0
    writing), restored into each position, stepped again beside the run
    it interrupted; the resumed runs bit-equal to those and to each
    other."""
    out, resumed = {}, {}
    for tag, (step, sp) in held.items():
        d = os.path.join(out_dir, "ckpt" if tag == "x"
                         else f"ckpt_s{mh.process_index()}")
        ck = TrainCheckpointer(d)
        ck.save(1, sp)
        state, _, at = ck.restore(target=sp)
        a, b = ([x.gather(dev) for x in _leaves(step(t, inp, tgt)[0])]
                for t in (sp, state))
        resumed[tag] = b
        out[tag] = {"step": at, "bit_equal": _equal(a, b),
                    "files": sorted(os.listdir(d))}
    out["bit_equal"] = _equal(resumed["x"], resumed["s"])
    return out


def _models_bf16(dev, trees) -> dict:
    """(b) for item 18h's parts (i) and (ii), across the processes: a
    warm-up and one timed step of the EP step and the 1F1B cell, and the
    int8 serving tick."""
    cfg, params = _take(trees, "moe_bf16", dev)
    inp, tgt = train_batch(cfg.vocab, dev)
    mesh = _meshes(dev, EP_MESH, EP_AXES, "ep")["x"]
    step = make_train_step(cfg, mesh, lr=LR, donate=True)
    sp, ep = _timed_steps(step, shard_params(params, cfg, mesh), inp, tgt,
                          dev)
    del sp
    torch.cuda.empty_cache()
    shape, M, _ = CELLS["1f1b"]
    mesh = _meshes(dev, shape, ("dp", "pp"), "pp")["x"]
    step = make_pipeline_train_step(cfg, mesh, n_microbatch=M, lr=LR,
                                    schedule="1f1b", donate=True)
    sp, f1b = _timed_steps(step, shard_params_pipeline(params, cfg, mesh),
                           inp, tgt, dev)
    del sp, params
    torch.cuda.empty_cache()
    cfg, params = _take(trees, "decode_bf16", dev)
    cfg = dataclasses.replace(cfg, attn_window=MODEL["attn_window"])
    mesh = _meshes(dev, GEN_MESH, GEN_AXES, "dp")["x"]
    sp = shard_params(params, cfg, mesh)
    del params
    S, warm, inner = TICK_BF16
    W = cfg.attn_window
    rng = np.random.default_rng(60)
    state = (rng.integers(1, cfg.vocab, S).astype(np.int32),
             rng.integers(W, 3 * W, S).astype(np.int32), np.zeros(S, bool))
    caches = td.shard_cache(td.init_cache(cfg, S, W, mesh, quantize_kv=True,
                                          device=dev), cfg, mesh)
    ms = []
    for n_inner in (warm, inner):  # a warm-up first
        tick = sv.make_serving_scan(cfg, mesh, n_inner, quantize_kv=True)
        res, dt, k = _counted(lambda: tick(sp, *state, caches))
        state = res[:3]
        ms.append(dt * 1e3)
    toks = res[4].gather()
    return {"ep_step": ep, "1f1b": f1b,
            "tick_int8": {"ms_per_tick": ms[1], "warmup_ms": ms[0],
                          "launches": k, **_exchanges(),
                          "tokens_in_vocab": bool(
                              ((toks >= 0) & (toks < cfg.vocab)).all()),
                          "tokens": toks.tolist()}}


def _win_delay():
    """Phase 56's window schedule: seeded lognormal, worker 2 straggling
    by 30 s."""
    base = faults.seeded_lognormal(0.01, 0.7, seed=3)
    return lambda w, e: base(w, e) + (30.0 if w == 2 else 0.0)


def _win_run(coord, pool, payload, K: int):
    """One window between a reset of :data:`collectives.EXCHANGES` and a
    read: (its history, report)."""
    torch.cuda.synchronize()
    col.zero_exchanges()
    t0 = time.perf_counter()
    hist = asyncmap_fused(pool, payload, coord, epochs=K)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return hist, {"K": K, "s": dt, "ms_per_epoch": dt / K * 1e3,
                  **_exchanges()}


def _window(dev) -> dict:
    """The device coordinator's mesh window over ("w",) of 8, the pool
    axis across the processes (four ranks each): (a) f64 at phase 56's
    shape, K=6 then K=4, across the processes and on the
    single-controller mesh, bit for bit (histories, every epoch's
    gathered and local blocks, ``last_full``, the pool's end state),
    ``last_full`` against ``A @ B``; (b) config 3's width at
    ``"default"``, a warm-up window and a timed one, the histories
    against the flat window's on the card, ``last_full`` against
    ``A @ B`` within config 3's limit."""
    out, got = {}, {}
    code = MDSCode(WIN_N, WIN_K, dtype=np.float64)
    m, d, c = WIN_F64
    rng = np.random.default_rng(60)
    A, B = rng.standard_normal((m, d)), rng.standard_normal((d, c))
    blocks = code.encode_array(torch.from_numpy(A))
    meshes = _meshes(dev, (WIN_N,), ("w",), None)
    mine = meshes["x"].local_ranks()  # this process's ranks, on both
    for tag, mesh in meshes.items():
        coord = DeviceCoordinator(blocks, decode="mds", G=code.G, k=WIN_K,
                                  mesh=mesh, delay_fn=_win_delay())
        pool, vals, reps = AsyncPool(WIN_N), [], []
        for K in WIN_KS:
            hist, rep = _win_run(coord, pool, B, K)
            reps.append({**rep, "history": hist.tolist()})
            full = coord.last_window["last_full"].cpu()
            vals += [torch.from_numpy(hist),
                     torch.from_numpy(np.asarray(coord.last_decoded)),
                     full] + [coord.last_decoded.local(r).cpu()
                              for r in mine]
        vals += [torch.from_numpy(np.asarray(x)) for x in (
            pool.epoch, pool.repochs, pool.sepochs, pool.active)]
        got[tag] = vals
        out[f"f64_{tag}"] = reps
        if tag == "x":  # the last window's product, the first rank's copy
            out["f64_last_full_rel_err"] = float(
                np.abs(full.numpy() - A @ B).max() / np.abs(A @ B).max())
    out["f64_bit_equal"] = _equal(got["x"], got["s"])
    del got
    # (b) config 3's width: 8196 x 8192 coded at (8, 6), B 8192 x 8192
    A3, B3 = _operands(MDS_M, MDS_M, MDS_M, CONFIG3_SEED, dev)
    C_ref = torch.matmul(A3, B3)
    m_pad = -(-MDS_M // WIN_K) * WIN_K
    A_pad = torch.zeros(m_pad, MDS_M, device=dev)
    A_pad[:MDS_M] = A3
    del A3
    code = MDSCode(WIN_N, WIN_K, dtype=np.float32)
    blocks = code.encode_array(A_pad)
    del A_pad
    kw = dict(decode="mds", G=code.G, k=WIN_K, delay_fn=_win_delay(),
              precision="default")
    coord = DeviceCoordinator(blocks, mesh=meshes["x"], **kw)
    pool, hists, reps = AsyncPool(WIN_N), [], []
    for K in WIN_C3:
        hist, rep = _win_run(coord, pool, B3, K)
        hists.append(hist)
        reps.append(rep)
    last_full = coord.last_window["last_full"]
    del coord
    torch.cuda.empty_cache()
    flat = DeviceCoordinator(blocks, device=dev, **kw)
    fpool = AsyncPool(WIN_N)
    flat_hists = [asyncmap_fused(fpool, B3, flat, epochs=K) for K in WIN_C3]
    # the last epoch's decode inverts G over its first k fresh workers:
    # bf16 operands (unit roundoff 2^-8) and the f32 decode are both
    # amplified by that inverse's condition number
    fresh = np.flatnonzero(hists[-1][-1] == pool.epoch)[:WIN_K]
    cond = float(np.linalg.cond(code.G.astype(np.float64)[fresh]))
    out["config3"] = {
        "shape": [m_pad, MDS_M, MDS_M], "precision": "default",
        "warmup": reps[0], "timed": reps[1],
        "histories_equal_flat": all(
            np.array_equal(a, b) for a, b in zip(hists, flat_hists)),
        "history": hists[1].tolist(), "fresh": fresh.tolist(),
        "cond": cond,
        # the same bf16 products decoded by the flat window (_lu_solve)
        "rel_err_vs_flat": rel_err(last_full, flat.last_decoded[-1]),
        "limit_vs_flat": 1e-5 * cond,
        "rel_err_vs_ab": rel_err(last_full[:MDS_M], C_ref),
        "limit_vs_ab": 2.0 ** -8 * cond}
    del flat, blocks, B3, C_ref
    torch.cuda.empty_cache()
    return out


def child(addr_nccl: str, addr_gloo: str, rank: int, out_dir: str) -> None:
    """One process of :func:`start`: both drive cuda:0."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"rank": rank}
    t0 = time.perf_counter()
    try:
        mh.initialize_multihost(addr_nccl, num_processes=2, process_id=rank,
                                device=dev, backend="nccl")
        res["nccl_shared_card"] = None
    except ValueError as e:
        res["nccl_shared_card"] = str(e)
    mh.initialize_multihost(addr_gloo, num_processes=2, process_id=rank,
                            device=dev, backend="gloo")
    res["backend"] = mh.backend()
    res["init_s"] = time.perf_counter() - t0
    with ThreadPoolExecutor(1) as pool:
        trees = _prefetch(pool)
        res["f32"] = _f32(dev, trees)
        res["f32_s"] = time.perf_counter() - t0
        res["bf16"] = _bf16(dev, out_dir, trees)
        res["bf16_s"] = time.perf_counter() - t0
        res["models_f32"] = _models_f32(dev, out_dir, trees)
        res["models_f32_s"] = time.perf_counter() - t0
        res["models_bf16"] = _models_bf16(dev, trees)
        res["models_bf16_s"] = time.perf_counter() - t0
        res["window"] = _window(dev)
        res["seconds"] = time.perf_counter() - t0
    import torch.distributed as dist

    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(out_dir: str):
    """Spawn the two processes (each writes ``<out_dir>/rank<r>.json``
    and its log beside it); returns the handle :func:`wait` takes."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    addrs = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w")
            for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mpistragglers_jl_tpu_torch.bench.multiproc",
         "--child", *addrs, str(r), out_dir],
        cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
        for r, log in enumerate(logs)]
    return out_dir, procs, logs


def wait(handle, timeout: float = 300.0) -> list:
    """Wait for both processes of :func:`start` (a failure or a hang in
    either fails the run; both are stopped) and return their reports."""
    out_dir, procs, logs = handle
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while failed is None:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"process {bad[0]} exited {codes[bad[0]]}"
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                failed = f"the processes passed {timeout:.0f} s"
            else:
                time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if failed:
        tails = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                tails.append(f"--- process {r}:\n" + f.read()[-3000:])
        raise RuntimeError(failed + "\n" + "\n".join(tails))
    out = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--child", nargs=4, metavar=("NCCL", "GLOO", "RANK",
                                                 "OUT"))
    args = ap.parse_args()
    if args.child:
        a, b, r, out = args.child
        child(a, b, int(r), out)
        return
    from ..ops import _build

    _build.build("flash_attention", "decode_attention", "sampling")
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        reps = wait(start(out))
        for rep in reps:
            rep.get("bf16", {}).get("generate_int8", {}).pop("stream", None)
        print(json.dumps({"multiproc": reps,
                          "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
