"""Where a long-context decode step spends its time on the GPU.

Builds the decode rung's model (``bench/configs.py`` ``DECODE``),
prefills one 16384-token prompt into a cache of 16512 positions (the
rung's) with ``prefill_dense``, runs 4 warm greedy steps of
``decode_step_dense``, then traces 16 more with ``torch.profiler``,
for the bf16 cache, the int8 cache under AUTO (einsum at B=1) and the
int8 cache with the decode kernel forced (``use_decode_kernel(True)``).
Prints per variant: host time per step, the device's busy time and idle
share, kernels per step, and the kernels that take the most device
time.

    python -m mpistragglers_jl_tpu_torch.bench.generate_profile
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..models import decode as td
from ..models.transformer import TransformerConfig, init_params
from .configs import DECODE
from .serving_profile import _busy_us

PROMPT, WARM, STEPS = 16384, 4, 16
# bench_decode's cache length (prompt + its 128 new tokens): one the
# block picker accepts, so the forced variant routes the kernel
MAX_LEN = PROMPT + 128
VARIANTS = (("bf16", False, None), ("int8", True, None),
            ("int8_kernel", True, True))


def _steps(params, tok, c, pos: int, n: int, cfg):
    """``n`` greedy ``decode_step_dense`` calls from ``pos``: (last
    token, cache)."""
    for p in range(pos, pos + n):
        logits, c = td.decode_step_dense(params, tok, c, p, cfg)
        tok = logits.argmax(-1)
    return tok, c


def _trace(params, cfg, prompt, quantize_kv, toggle, dev) -> dict:
    Tp = prompt.shape[1]
    td.use_decode_kernel(toggle)
    try:
        with torch.no_grad():
            c = td.init_cache(cfg, 1, MAX_LEN,
                              quantize_kv=quantize_kv, device=dev)
            logits, c = td.prefill_dense(params, prompt, c, cfg)
            tok = logits[:, -1].argmax(-1)
            del logits
            tok, c = _steps(params, tok, c, Tp, WARM, cfg)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _steps(params, tok, c, Tp + WARM, STEPS, cfg)
                torch.cuda.synchronize()
                host_us = (time.perf_counter() - t0) * 1e6
    finally:
        td.use_decode_kernel(None)
    events = prof.events()
    busy = _busy_us(events)
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"host_us_per_step": host_us / STEPS,
            "device_busy_us_per_step": busy / STEPS,
            "idle_share": 1 - busy / host_us,
            "kernels_per_step": len(kernels) / STEPS,
            "top_kernels_us_per_step": {n[:60]: t / STEPS for n, t in top}}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("generate_profile: no CUDA device")
    dev = torch.device("cuda", 0)
    cfg = TransformerConfig(**DECODE, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=dev)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, PROMPT)), device=dev)
    print(f"device: {torch.cuda.get_device_name(0)}")
    out = {}
    for name, q8, toggle in VARIANTS:
        out[name] = _trace(params, cfg, prompt, q8, toggle, dev)
        r = out[name]
        print(f"{name}: host {r['host_us_per_step']:.0f} us/step, device "
              f"busy {r['device_busy_us_per_step']:.0f} us/step, idle "
              f"share {r['idle_share']:.3f}, {r['kernels_per_step']:.0f} "
              "kernels/step")
        for k, t in r["top_kernels_us_per_step"].items():
            print(f"    {t:9.1f} us  {k}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
