"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path, the int8 continuous-batching server
(``mpistragglers_jl_tpu_torch.models.serving.ServingScheduler``), at the
full width of the widest model the repo serves, and holds every CUDA
kernel of that path against its plain PyTorch version:

1. card name and power limit;
2. build the kernel from the source in this checkout;
3. kernel against plain version at the serving shape, bf16 and f32,
   ring and positional (with and without window) masks, GQA groups
   1, 4 and 8;
4. serving parity in f32 at full width: ~10 requests through the
   scheduler on the kernel route, then on the einsum route
   (``use_decode_kernel(False)``); greedy streams must be identical,
   equal the ``generate_ring_dense`` oracle, and the kernel must launch
   ``n_layers * n_inner * decode ticks`` times on the first run and
   never on the second;
5. the main path: serving in bf16, S=8 slots of 512-token prompts,
   ``n_inner=64``; every launch count is set to 0 just before and read
   just after; decode tokens/s, ms/step and peak memory;
6. kernel timing at the serving shape (CUDA events, caches rotated
   past the 50 MB L2) beside its byte bound, the plain version and one
   ``F.scaled_dot_product_attention`` call over the dequantised cache
   (a yardstick only: the port never calls it).

Prints a ``{"kernels": [...]}`` JSON line and, last,
``{"ok": true, "device": {...}}``. Exits nonzero, printing no result,
without a CUDA device or when any phase fails.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from mpistragglers_jl_tpu_torch.bench.serving_profile import MODEL
from mpistragglers_jl_tpu_torch.models import decode as td
from mpistragglers_jl_tpu_torch.models.serving import ServingScheduler
from mpistragglers_jl_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)
from mpistragglers_jl_tpu_torch.ops import _build
from mpistragglers_jl_tpu_torch.ops import decode_attention as da

SLOTS = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel against plain version: |got - want| <= atol + rtol * |want|.
# Both sum in f32 (in different orders, hence atol); a bf16 output is
# held against the f32 plain result and may differ by one bf16
# rounding, at most 2**-8 of the value.
TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-5, 2.0 ** -8)}
K5 = "quantized_decode_attention"


class SmokeFailure(RuntimeError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _cache(B, L, Hkv, D, gen, dev):
    kq, ks = td._kv_quantize(torch.randn(B, L, Hkv, D, generator=gen))
    vq, vs = td._kv_quantize(torch.randn(B, L, Hkv, D, generator=gen))
    return {n: t.to(dev) for n, t in
            {"k": kq, "k_s": ks, "v": vq, "v_s": vs}.items()}


def phase_kernel_vs_plain(dev) -> float:
    """Every mode, both q types, GQA 1/4/8 at B=8, L=W=1024, D=128."""
    gen = torch.Generator().manual_seed(0)
    B, L, D, Hq = SLOTS, MODEL["attn_window"], 128, 8
    pos = torch.tensor([0, 7, 31, 32, 1023, 1024, 5000, 2047],
                       dtype=torch.int32, device=dev)
    worst = 0.0
    for Hkv in (8, 2, 1):
        cache = _cache(B, L, Hkv, D, gen, dev)
        q32 = torch.randn(B, 1, Hq, D, generator=gen).to(dev)
        for dt in (torch.bfloat16, torch.float32):
            q = q32.to(dt)
            atol, rtol = TOL[dt]
            for kw in ({"ring": True}, {}, {"window": 100}):
                got = da.quantized_decode_attention(q, cache, pos,
                                                    D ** -0.5, **kw)
                # the plain version in f32 on the same (bf16-valued) q
                want = da.quantized_decode_attention_ref(
                    q.float(), cache, pos, D ** -0.5, **kw)
                torch.cuda.synchronize()
                diff = (got.float() - want).abs()
                err = diff.max().item()
                # share of the limit used by the worst element (<= 1)
                used = (diff / (atol + rtol * want.abs())).max().item()
                ok = bool(torch.isfinite(got).all()) and used <= 1.0
                print(f"  g={Hq // Hkv} {str(dt):15s} {str(kw):16s} "
                      f"max_abs_err={err:.3e} limit atol={atol:.0e} "
                      f"rtol={rtol:.3e} used {used:.3f} "
                      f"{'ok' if ok else 'FAIL'}")
                _require(ok, f"kernel disagrees with plain version: "
                             f"g={Hq // Hkv} {dt} {kw} err={err} "
                             f"limit used {used}")
                worst = max(worst, err)
    return worst


def _prompts(rng, lens, vocab):
    return [rng.integers(0, vocab, n, dtype=np.int64) for n in lens]


def phase_serving_parity_f32(dev) -> None:
    cfg = TransformerConfig(**MODEL, dtype=torch.float32)
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(1)
    lens = [512, 300, 77, 450, 128, 5, 260, 511, 64, 333]
    budgets = [16, 32, 24, 16, 32, 20, 16, 28, 32, 18]
    prompts = _prompts(rng, lens, cfg.vocab)
    streams, launches = [], []
    for toggle in (None, False):
        td.use_decode_kernel(toggle)
        try:
            sched = ServingScheduler(params, cfg, slots=SLOTS, n_inner=8,
                                     prompt_chunk=256, max_prompt=512,
                                     quantize_kv=True, device=dev)
        finally:
            td.use_decode_kernel(None)
        _require(sched.use_kernel == (toggle is None),
                 f"routing: use_kernel={sched.use_kernel} at toggle "
                 f"{toggle}")
        da.LAUNCHES[K5] = 0
        reqs = [sched.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
        sched.run()
        n = da.LAUNCHES[K5]
        want = (cfg.n_layers * sched.n_inner * sched.decode_ticks
                if toggle is None else 0)
        route = "kernel" if toggle is None else "einsum"
        print(f"  {route} route: {sched.decode_ticks} decode ticks, "
              f"{n} kernel launches (want {want})")
        _require(n == want, f"{route} route launched the kernel {n} times, "
                            f"want {want}")
        _require(all(r.finished and len(r.tokens) == b
                     for r, b in zip(reqs, budgets)),
                 f"{route} route: a request did not finish its budget")
        streams.append([r.tokens for r in reqs])
        launches.append(n)
    same = sum(a == b for a, b in zip(*streams))
    print(f"  streams identical on both routes: {same}/{len(prompts)}")
    _require(same == len(prompts), "kernel and einsum routes disagree")
    for i in (2, 5):
        o = td.generate_ring_dense(params, prompts[i][None], budgets[i],
                                   cfg, quantize_kv=True, device=dev)
        _require(o.cpu().numpy()[0].tolist() == streams[0][i],
                 f"request {i} differs from the generate_ring_dense oracle")
    print("  requests 2 and 5 equal the generate_ring_dense oracle")
    del params


def phase_serving_bf16(dev):
    """The main path: returns (launches, report)."""
    cfg = TransformerConfig(**MODEL, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=dev)
    n_inner, ticks, Tp = 64, 3, 512
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(2)
    for name in da.LAUNCHES:
        da.LAUNCHES[name] = 0
    sched = ServingScheduler(params, cfg, slots=SLOTS, n_inner=n_inner,
                             prompt_chunk=Tp, max_prompt=Tp,
                             quantize_kv=True, device=dev)
    _require(sched.use_kernel, "the S=8 int8 tick did not route the kernel")
    reqs = [sched.submit(p, max_new=n_inner * (ticks + 2))
            for p in _prompts(rng, [Tp] * SLOTS, cfg.vocab)]
    t0 = time.perf_counter()
    sched.step()  # admits all 8 (one 512-token chunk each) + 1 tick
    torch.cuda.synchronize()
    t_admit = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(ticks):
        sched.step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(da.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    want = cfg.n_layers * n_inner * sched.decode_ticks
    _require(launches[K5] == want,
             f"main path launched the kernel {launches[K5]} times, want "
             f"{want}")
    for r in reqs:
        _require(len(r.tokens) == 1 + n_inner * (ticks + 1),
                 f"request {r.id} holds {len(r.tokens)} tokens")
        _require(all(0 <= t < cfg.vocab for t in r.tokens),
                 f"request {r.id} emitted an out-of-vocabulary token")
    toks = SLOTS * n_inner * ticks
    rep = {
        "decode_tokens_per_s": toks / dt,
        "ms_per_step": dt / (n_inner * ticks) * 1e3,
        "admit_tick_s": t_admit,
        "peak_mem_gb": peak / 1e9,
        "decode_ticks": sched.decode_ticks,
    }
    print(f"  {sched.decode_ticks} decode ticks ({ticks} timed), "
          f"{launches[K5]} kernel launches (= {cfg.n_layers} layers x "
          f"{n_inner} steps x {sched.decode_ticks} ticks)")
    print(f"  aggregate decode {rep['decode_tokens_per_s']:.1f} tokens/s, "
          f"{rep['ms_per_step']:.3f} ms/step (S={SLOTS}), admission tick "
          f"{t_admit:.3f} s, peak memory {rep['peak_mem_gb']:.3f} GB")
    del sched, params
    return launches, rep


def _time_ms(fn, n_iter, n_warm=10):
    for i in range(n_warm):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(n_iter):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def phase_kernel_timing(dev) -> dict:
    """bf16 ring mode, every row past warm-up (all W keys visible), 16
    cache copies rotated so each launch finds its cache outside L2."""
    gen = torch.Generator().manual_seed(3)
    B, L, Hkv, D = SLOTS, MODEL["attn_window"], MODEL["n_kv_heads"], 128
    H = MODEL["n_heads"]
    dt = torch.bfloat16
    n_copies = 16
    caches = [_cache(B, L, Hkv, D, gen, dev) for _ in range(n_copies)]
    q = torch.randn(B, 1, H, D, generator=gen).to(dt).to(dev)
    pos = torch.arange(B, dtype=torch.int32, device=dev) + 5000
    scale = D ** -0.5
    kern = _time_ms(lambda i: da.quantized_decode_attention(
        q, caches[i % n_copies], pos, scale, ring=True), 400)
    plain = _time_ms(lambda i: da.quantized_decode_attention_ref(
        q, caches[i % n_copies], pos, scale, ring=True), 50)
    # yardstick: SDPA over the dequantised cache, heads repeated for GQA,
    # the same (here all-visible) ring mask
    g = H // Hkv
    deq = []
    for c in caches:
        kd = (c["k"].float() * c["k_s"][..., None]).to(dt)
        vd = (c["v"].float() * c["v_s"][..., None]).to(dt)
        deq.append((kd.repeat_interleave(g, 2).transpose(1, 2).contiguous(),
                    vd.repeat_interleave(g, 2).transpose(1, 2).contiguous()))
    kidx = torch.arange(L, device=dev)
    mask = ((kidx[None] <= pos[:, None]) | (pos[:, None] >= L))[:, None,
                                                                None, :]
    qh = q.transpose(1, 2).contiguous()
    lib = _time_ms(lambda i: F.scaled_dot_product_attention(
        qh, deq[i % n_copies][0], deq[i % n_copies][1], attn_mask=mask,
        scale=scale), 200)
    # the least time for this call: each input read once, output once
    visible = L  # every row is past warm-up: all W slots are read
    nbytes = (B * visible * Hkv * D * 2  # int8 K and V
              + B * visible * Hkv * 4 * 2  # f32 k_s and v_s
              + q.numel() * q.element_size() * 2  # q in, out
              + pos.numel() * 4)
    nops = 4 * B * H * visible * D  # q.k and p.v multiply-adds
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S[dt] * 1e3
    rep = {"ms": kern, "plain_ms": plain, "library_ms": lib,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "ops": nops}
    print(f"  kernel {kern * 1e3:.2f} us/launch, bound "
          f"{rep['bound_ms'] * 1e3:.3f} us ({nbytes} B at 3.35 TB/s; "
          f"{nops} ops {t_ops * 1e3:.4f} us), plain {plain * 1e3:.2f} us, "
          f"SDPA over dequantised cache {lib * 1e3:.2f} us")
    return rep


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on "
              "the GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    # f32 parity needs full-precision products, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1] device: {name}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(smi)

    t0 = time.perf_counter()
    _build.load("decode_attention")
    t_build = time.perf_counter() - t0
    print(f"[2] built decode_attention.cu in {t_build:.1f} s")
    for kname, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {kname}: {line.strip()}")

    print("[3] kernel against plain version, B=8 L=W=1024 D=128")
    max_err = phase_kernel_vs_plain(dev)

    print("[4] serving parity, f32, full width, kernel vs einsum route")
    phase_serving_parity_f32(dev)
    torch.cuda.empty_cache()

    print("[5] main path: bf16 serving, S=8, 512-token prompts, "
          "n_inner=64")
    launches, serve = phase_serving_bf16(dev)
    torch.cuda.empty_cache()

    print("[6] kernel timing, bf16 ring, B=8 L=W=1024 Hkv=2 g=4 D=128")
    tim = phase_kernel_timing(dev)

    kernels = [{
        "name": K5,
        "route": "cuda",
        "source": "mpistragglers_jl_tpu_torch/ops/csrc/decode_attention.cu",
        "replaces": "mpistragglers_jl_tpu/ops/decode_attention.py:134",
        "launches": launches[K5],
        "max_abs_err": max_err,
        "ms": tim["ms"],
        "plain_ms": tim["plain_ms"],
        "bound_ms": tim["bound_ms"],
        "bound_by": tim["bound_by"],
        "library_ms": tim["library_ms"],
    }]
    _require(all(k["launches"] > 0 for k in kernels),
             "a kernel of the main path was never launched")
    print(json.dumps({"serving_bf16": serve, "build_s": t_build}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
