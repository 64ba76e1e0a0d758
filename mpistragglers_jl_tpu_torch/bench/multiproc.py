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

Every run counts its kernel launches (per process: each rank this
process drives launches its own). The kernels must be built before the
spawn (``ops/_build.build``): the processes load them, never build.
Each process writes ``<out>/rank<r>.json``; :func:`wait` returns both.
The timed bf16 step also reports its exchanges across processes
(``collectives.EXCHANGES``: ``exchanges``, ``exchange_ms``,
``exchange_gb``, this process's payloads).

    python -m mpistragglers_jl_tpu_torch.bench.multiproc
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..models import decode as td
from ..models.transformer import (
    TransformerConfig,
    _leaves,
    init_params,
    make_train_step,
    shard_params,
    sharded_loss_and_grads,
)
from ..parallel import collectives as col
from ..parallel import make_mesh
from ..parallel import multihost as mh
from .configs import DECODE
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
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def prompt(vocab: int, B: int, Tp: int, seed: int) -> np.ndarray:
    """Prompts as the reference's decode benches draw them."""
    return np.random.default_rng(seed).integers(0, vocab, (B, Tp))


def _counted(fn):
    """``fn()`` between a reset of the launch counts and a read: (its
    result, seconds, the nonzero counts)."""
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {
        k: v for k, v in launch_counts().items() if v}


def _meshes(dev, shape, axes, dcn):
    n = int(np.prod(shape))
    return {"x": mh.make_multihost_mesh(shape, axes, dcn_axis=dcn,
                                        devices=[dev] * (n // 2)),
            "s": make_mesh(shape, axes, devices=[dev] * n)}


def _f32(dev) -> dict:
    cfg = TransformerConfig(**{**TRAIN, "n_layers": F32_LAYERS},
                            dtype=torch.float32)
    params = init_params(cfg, seed=0, device=dev)
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
    cfg = TransformerConfig(**{**DECODE, "n_layers": F32_LAYERS},
                            dtype=torch.float32)
    params = init_params(cfg, seed=0, device=dev)
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


def _bf16(dev, out_dir: str) -> dict:
    cfg = TransformerConfig(**TRAIN, dtype=torch.bfloat16)
    inp, tgt = train_batch(cfg.vocab, dev)
    mesh = _meshes(dev, MESH, AXES, "dp")["x"]
    sp = shard_params(init_params(cfg, seed=0, device=dev), cfg, mesh)
    step = make_train_step(cfg, mesh, lr=LR, donate=True)
    torch.cuda.synchronize()
    zero_launches()
    losses, times = [], []
    for _ in range(SGD_STEPS):
        col.zero_exchanges()  # the last step's are read
        t0 = time.perf_counter()
        sp, loss = step(sp, inp, tgt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    ex = dict(col.EXCHANGES)
    out = {"losses": losses, "step_s": times,
           "ms_per_step": times[-1] * 1e3,
           "exchange_ms": ex["seconds"] * 1e3,
           "exchange_gb": ex["bytes"] / 1e9,
           "exchanges": ex["calls"],
           "launches": {k: v for k, v in launch_counts().items() if v},
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    final = [x.gather() for x in _leaves(sp)]
    if mh.process_index() == 0:
        torch.save(final, os.path.join(out_dir, "params.pt"))
    del sp, final
    cfg = TransformerConfig(**DECODE, dtype=torch.bfloat16)
    B, Tp, n_new = GEN_BF16
    mesh = _meshes(dev, GEN_MESH, GEN_AXES, "dp")["x"]
    sp = shard_params(init_params(cfg, seed=0, device=dev), cfg, mesh)
    gen = td.make_generate(cfg, mesh, n_new, quantize_kv=True)
    toks, dt, k = _counted(lambda: gen(sp, prompt(cfg.vocab, B, Tp, 1)))
    out["generate_int8"] = {"s": dt, "launches": k,
                            "stream": toks.gather().tolist()}
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
    res["f32"] = _f32(dev)
    res["f32_s"] = time.perf_counter() - t0
    res["bf16"] = _bf16(dev, out_dir)
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
