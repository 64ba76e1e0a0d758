"""Where a serving decode step spends its time on the GPU.

Builds the bf16 int8 server of ``chip_smoke.py`` phase 5 (full width,
S=8 slots of 512-token prompts; with ``--paged``, the paged cache of
phase 9: pages of 64, every prompt a shared 256-token system prompt
plus 256 own tokens), runs one warm tick, then traces one more tick of
16 decode steps with ``torch.profiler`` and prints: the tick's host
time, the device's busy time and idle share inside it, and the kernels
and host operators that take the most time.

    python -m mpistragglers_jl_tpu_torch.bench.serving_profile [--paged]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..models.serving import ServingScheduler
from ..models.transformer import TransformerConfig, init_params
from ..ops import decode_attention as da

# the serving model of benchmarks/serving_bench.py (S8_int8), shared
# with chip_smoke.py
MODEL = dict(vocab=32768, d_model=1024, n_heads=8, n_kv_heads=2,
             n_layers=8, d_ff=4096, attn_window=1024)
N_INNER = 16


def _busy_us(events) -> float:
    """Union of the device kernels' intervals, in microseconds (user
    annotations, which span whole ranges on the device timeline, are
    not kernels)."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--paged", action="store_true",
                    help="the paged cache (pages of 64, shared prefix)")
    paged = ap.parse_args().paged
    if not torch.cuda.is_available():
        raise SystemExit("serving_profile: no CUDA device")
    dev = torch.device("cuda", 0)
    cfg = TransformerConfig(**MODEL, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(2)
    sched = ServingScheduler(params, cfg, slots=8, n_inner=N_INNER,
                             prompt_chunk=512, max_prompt=512,
                             quantize_kv=True, device=dev,
                             page_tokens=64 if paged else None)
    system = rng.integers(0, cfg.vocab, 256)
    for _ in range(8):
        own = rng.integers(0, cfg.vocab, 256 if paged else 512)
        # within the window: prompt + budget + n_inner <= 1024
        sched.submit(np.concatenate([system, own]) if paged else own,
                     max_new=400)
        if paged:
            sched.step()  # resident, so the next admission shares
    sched.step()  # admission + first tick
    sched.step()  # warm
    torch.cuda.synchronize()
    for name in da.LAUNCHES:
        da.LAUNCHES[name] = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.step()
        torch.cuda.synchronize()
        tick_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    busy = _busy_us(events)
    n_kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA
                    for e in events)
    ka = prof.key_averages()
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"tick of {N_INNER} steps: host {tick_us:.0f} us, device "
          f"busy {busy:.0f} us, idle share {1 - busy / tick_us:.3f}, "
          f"{n_kernels} kernels ({n_kernels / N_INNER:.0f} per step), "
          f"launches {da.LAUNCHES}")
    print(ka.table(sort_by="cuda_time_total", row_limit=20))
    print(ka.table(sort_by="cpu_time_total", row_limit=20))
    print(json.dumps({"tick_us": tick_us, "device_busy_us": busy,
                      "idle_share": 1 - busy / tick_us,
                      "kernels_per_step": n_kernels / N_INNER,
                      "ms_per_step": tick_us / N_INNER / 1e3}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
