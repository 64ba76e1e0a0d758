"""K5 and K6 at the serving shape, timed alike in this tree and in a
baseline checkout of the port (``--baseline DIR``, e.g. an earlier
commit unpacked with ``git archive``).

Each tree runs in a process of its own, in the order baseline, this,
this, baseline, so a drift of the card during the call shows as the
spread within each pair. A process puts its tree first on
``sys.path``, builds that tree's ``ops/csrc/decode_attention.cu`` on
first use, and times at the serving shape (B=8, W=1024, H=8 over
Hkv=2, D=128, bf16 q, every row past warm-up; 16 rotated copies of the
cache so each launch finds its cache outside L2):

  graph_us   16 calls, one per copy, captured as one CUDA graph; the
             least of 5 replays, timed with CUDA events, over 16: the
             device's own time
  eager_us   400 eager calls timed with CUDA events: the device's time
             or the host's enqueue time, whichever is longer

for K5 (``quantized_decode_attention`` in ring mode) and K6 (the same
call with a page table, pages of 64), and for SDPA over the
dequantised cache (GQA heads repeated), which neither tree changes and
so shows the card's drift. Each process also holds both kernels'
outputs against its tree's plain version (``max_abs_err``). Only the
wrappers' public signatures are called, which every tree of the port
shares.

    python -m mpistragglers_jl_tpu_torch.bench.decode_serving_ab \\
        --baseline DIR

prints one JSON line per process, then a summary line.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

B, W, H, HKV, D, PAGE, COPIES = 8, 1024, 8, 2, 128, 64, 16
EAGER_CALLS, REPLAYS = 400, 5
THIS_TREE = Path(__file__).resolve().parents[2]


def _quantize(x):
    """Per-(row, key, kv head) absmax int8 and its f32 scale."""
    s = x.abs().amax(-1).clamp_min(1e-8) / 127.0
    return torch.round(x / s[..., None]).to(torch.int8), s


def _cache(rows, gen, dev):
    kq, ks = _quantize(torch.randn(rows, HKV, D, generator=gen))
    vq, vs = _quantize(torch.randn(rows, HKV, D, generator=gen))
    return {n: t.to(dev) for n, t in
            {"k": kq, "k_s": ks, "v": vq, "v_s": vs}.items()}


def _events_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _eager_us(fn) -> float:
    for i in range(10):
        fn(i % COPIES)
    torch.cuda.synchronize()

    def loop():
        for i in range(EAGER_CALLS):
            fn(i % COPIES)

    return _events_ms(loop) / EAGER_CALLS * 1e3


def _graph_us(fn) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        for i in range(COPIES):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(COPIES):
            fn(i)
    graph.replay()
    best = min(_events_ms(graph.replay) for _ in range(REPLAYS))
    del graph
    return best / COPIES * 1e3


def _worker(tree: Path) -> dict:
    """Time K5, K6 and SDPA with the decode kernels of ``tree``."""
    sys.path.insert(0, str(tree))
    da = importlib.import_module(
        "mpistragglers_jl_tpu_torch.ops.decode_attention")
    loaded = Path(da.__file__).resolve()
    if not loaded.is_relative_to(tree):
        raise RuntimeError(f"imported {loaded}, not from {tree}")
    src = tree / "mpistragglers_jl_tpu_torch/ops/csrc/decode_attention.cu"
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(3)
    scale = D ** -0.5
    q = torch.randn(B, 1, H, D, generator=gen).to(torch.bfloat16).to(dev)
    pos = torch.arange(B, dtype=torch.int32, device=dev) + 5000
    caches = [{n: t.reshape((B, W) + t.shape[1:]) for n, t in
               _cache(B * W, gen, dev).items()} for _ in range(COPIES)]
    mp = W // PAGE
    n_pages = B * mp + 1
    pools = [_cache(n_pages * PAGE, gen, dev) for _ in range(COPIES)]
    tables = [(torch.randperm(n_pages - 1, generator=gen) + 1)
              .reshape(B, mp).to(torch.int32).to(dev) for _ in range(COPIES)]

    def k5(i):
        return da.quantized_decode_attention(q, caches[i], pos, scale,
                                             ring=True)

    def k6(i):
        return da.quantized_decode_attention(
            q, pools[i], pos, scale, ring=True, page_table=tables[i],
            page_tokens=PAGE)

    err5 = (k5(0).float() - da.quantized_decode_attention_ref(
        q.float(), caches[0], pos, scale, ring=True)).abs().max().item()
    err6 = (k6(0).float() - da.paged_decode_attention_ref(
        q.float(), pools[0], pos, scale, tables[0], PAGE)).abs().max().item()
    g = H // HKV
    deq = [tuple((c[n].float() * c[n + "_s"][..., None]).to(torch.bfloat16)
                 .repeat_interleave(g, 2).transpose(1, 2).contiguous()
                 for n in ("k", "v")) for c in caches]
    qh = q.transpose(1, 2).contiguous()

    def sdpa(i):  # every key visible: pos >= W
        return F.scaled_dot_product_attention(qh, *deq[i], scale=scale)

    return {
        "tree": str(tree),
        "source_sha256": hashlib.sha256(src.read_bytes()).hexdigest()[:12],
        "k5_graph_us": _graph_us(k5), "k5_eager_us": _eager_us(k5),
        "k6_graph_us": _graph_us(k6), "k6_eager_us": _eager_us(k6),
        "sdpa_graph_us": _graph_us(sdpa), "sdpa_eager_us": _eager_us(sdpa),
        "k5_max_abs_err": err5, "k6_max_abs_err": err6,
    }


def run_alternating(script: Path, baseline: Path, name: str) -> int:
    """The parent of an A/B bench: ``script --worker TREE`` once per
    tree, in the order baseline, this, this, baseline; prints the card,
    each worker's JSON line and a summary of every ``*_us`` key."""
    if not torch.cuda.is_available():
        print(f"{name}: no CUDA device; this bench runs only on the GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    base = baseline.resolve()
    runs = []
    for label, tree in (("baseline", base), ("this", THIS_TREE),
                        ("this", THIS_TREE), ("baseline", base)):
        out = subprocess.run(
            [sys.executable, str(script), "--worker", str(tree)],
            capture_output=True, text=True, check=True,
            timeout=900).stdout.strip().splitlines()[-1]
        runs.append({"run": label, **json.loads(out)})
        print(json.dumps(runs[-1]))
    keys = [k for k in runs[0] if k.endswith("_us")]
    summary = {label: {k: [r[k] for r in runs if r["run"] == label]
                       for k in keys} for label in ("baseline", "this")}
    print(json.dumps({"card": smi, **summary}))
    return 0


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
    return run_alternating(Path(__file__).resolve(), args.baseline,
                           "decode_serving_ab")


if __name__ == "__main__":
    sys.exit(main())
