"""K2 and K3, the split flash backward, at the training shape, timed
alike in this tree and in a baseline checkout of the port (``--baseline
DIR``, e.g. an earlier commit unpacked with ``git archive``).

Each tree runs in a process of its own, in the order baseline, this,
this, baseline, so a drift of the card during the call shows as the
spread within each pair. A process puts its tree first on ``sys.path``,
builds that tree's ``ops/csrc/flash_attention.cu`` on first use, and
times at the training shape (bf16, B=8, L=2048, H=8, D=128, causal, the
inputs of ``chip_smoke.py`` phase 16) as that phase does: 20 eager calls
after 3 warm-up calls, timed with CUDA events, per call. It times K2,
K3 and SDPA's backward (dq, dk and dv together), which neither tree
changes and so shows the card's drift, three rounds each, interleaved.
Each process also holds K2's and K3's outputs against its tree's plain
versions (``max_abs_err``) and, when it built the library, reports
ptxas's registers and spills of the tensor-core kernels (``ptxas``).
Only the wrappers' signatures are called, which every tree of the port
shares.

    python -m mpistragglers_jl_tpu_torch.bench.flash_bwd_ab --baseline DIR

prints one JSON line per process, then a summary line.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import re
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

B, L, H, D = 8, 2048, 8, 128
CALLS, WARM, ROUNDS = 20, 3, 3


def _per_call_us(fn) -> float:
    for _ in range(WARM):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CALLS * 1e3


def _ptxas(log: str) -> dict:
    """Kernel -> its ptxas registers/spill lines, tensor-core kernels
    only."""
    out, kern = {}, None
    for line in log.splitlines():
        if "_Z" in line:  # a kernel's mangled name starts its lines
            m = re.search(r"(flash_[a-z_]+_wgmma_kernel)ILi(\d+)E", line)
            kern = f"{m.group(1)}<D={m.group(2)}>" if m else None
        elif kern and ("registers" in line or "spill" in line):
            out.setdefault(kern, []).append(line.strip())
    return out


def _worker(tree: Path) -> dict:
    """Time K2, K3 and SDPA's backward with the flash kernels of
    ``tree``."""
    sys.path.insert(0, str(tree))
    fa = importlib.import_module(
        "mpistragglers_jl_tpu_torch.ops.flash_attention")
    build = importlib.import_module("mpistragglers_jl_tpu_torch.ops._build")
    loaded = Path(fa.__file__).resolve()
    if not loaded.is_relative_to(tree):
        raise RuntimeError(f"imported {loaded}, not from {tree}")
    src = tree / "mpistragglers_jl_tpu_torch/ops/csrc/flash_attention.cu"
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(13)
    q3, k3, v3, do3 = (torch.randn(B * H, L, D, generator=gen)
                       .to(torch.bfloat16).to(dev) for _ in range(4))
    meta = (D ** -0.5, True, None, 1)
    o, lse = fa._fwd(q3, k3, v3, *meta)
    args = (q3, k3, v3, do3, lse, fa._delta(do3, o)) + meta
    args_ref = tuple(t.float() for t in (q3, k3, v3, do3)) + args[4:]
    got = [fa._bwd_dq(*args), *fa._bwd_dkv(*args)]
    want = [fa._bwd_dq_ref(*args_ref), *fa._bwd_dkv_ref(*args_ref)]
    err = [(a.float() - b.float()).abs().max().item()
           for a, b in zip(got, want)]
    del args_ref, got, want
    torch.cuda.empty_cache()
    qh, kh, vh, doh = (t.view(B, H, L, D).clone().requires_grad_()
                       for t in (q3, k3, v3, do3))
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    fns = {"k2_us": lambda: fa._bwd_dq(*args),
           "k3_us": lambda: fa._bwd_dkv(*args),
           "sdpa_bwd_us": lambda: torch.autograd.grad(
               out, (qh, kh, vh), doh, retain_graph=True)}
    times = {name: [] for name in fns}
    for _ in range(ROUNDS):
        for name, fn in fns.items():
            times[name].append(_per_call_us(fn))
    return {
        "tree": str(tree),
        "source_sha256": hashlib.sha256(src.read_bytes()).hexdigest()[:12],
        **times,
        "k2_max_abs_err": err[0], "k3_max_abs_err": max(err[1:]),
        "ptxas": _ptxas(build.build_logs.get("flash_attention", "")) or None,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path,
                    help="root of the baseline checkout")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(_worker(args.worker.resolve())))
        return 0
    if args.baseline is None:
        ap.error("--baseline DIR is required")
    # the worker runs as a script with its tree first on sys.path, so
    # only the parent imports from the package
    from mpistragglers_jl_tpu_torch.bench.decode_serving_ab import (
        run_alternating)
    return run_alternating(Path(__file__).resolve(), args.baseline,
                           "flash_bwd_ab")


if __name__ == "__main__":
    sys.exit(main())
