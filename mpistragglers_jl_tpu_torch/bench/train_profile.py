"""Where a full-width training step spends its time on the GPU.

Builds the bf16 train step of ``chip_smoke.py`` phase 14 (the default
configuration of ``benchmarks/transformer_train_bench.py``: vocab 32768,
d_model 1024, 8 heads of 128, 8 layers, d_ff 4096, batch 8, sequence
2048, flash attention, SGD at lr 1e-3, random weights from seed 0),
takes two warm steps, then traces one more with ``torch.profiler`` and
prints: the step's host time, the device's busy time and idle share
inside it, the kernels per step, the share of device time in the flash
kernels K1-K4, and the kernels that take the most time. ``--fused``
traces the fused backward (K4) instead of the split one (K2, K3).

    python -m mpistragglers_jl_tpu_torch.bench.train_profile [--fused]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..models.transformer import (
    TransformerConfig,
    init_params,
    make_train_step,
)
from ..ops import flash_attention as fa
from .serving_profile import _busy_us

# benchmarks/transformer_train_bench.py bench_transformer_train's
# defaults, shared with chip_smoke.py
TRAIN = dict(vocab=32768, d_model=1024, n_heads=8, n_layers=8, d_ff=4096,
             attn="ulysses", attn_impl="flash")
BATCH, SEQ, LR = 8, 2048, 1e-3
# the CUDA kernel of each flash launch counter
FLASH_KERNELS = {"flash_fwd": "flash_fwd_kernel",
                 "flash_bwd_dq": "flash_bwd_dq_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv_kernel",
                 "flash_bwd_fused": "flash_bwd_fused_kernel"}


def model_flops_per_step(cfg, batch: int, seq: int) -> float:
    """Matmul FLOPs of one fwd+bwd train step, the MFU convention of
    ``benchmarks/transformer_train_bench.py`` (copied: the port imports
    nothing of ``benchmarks/``): backward = 2x forward, causal attention
    halved, the attention recompute of the flash backward not counted."""
    B, L, D, F, V = batch, seq, cfg.d_model, cfg.d_ff, cfg.vocab
    kvf = cfg.kv_heads / cfg.n_heads
    per_layer = (
        # q (2D^2) + k,v (4D^2 * kv fraction) + wo (2D^2) + mlp (4DF)
        B * L * ((4 + 4 * kvf) * D * D + 4 * D * F)
        + 2 * B * L * L * D  # causal attention: 4*B*L^2*D halved
    )
    fwd = cfg.n_layers * per_layer + 2 * B * L * D * V  # + tied head
    return 3.0 * fwd  # fwd + 2x fwd for backward


def train_batch(vocab: int, device):
    """The bench's batch: (inputs, targets) from
    ``np.random.default_rng(0)``, (BATCH, SEQ) each."""
    rng = np.random.default_rng(0)
    tok = torch.as_tensor(rng.integers(0, vocab, (BATCH, SEQ + 1),
                                       dtype=np.int32), device=device)
    return tok[:, :-1], tok[:, 1:]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fused", action="store_true",
                    help="the fused backward (K4) instead of K2 and K3")
    fused = ap.parse_args().fused
    if not torch.cuda.is_available():
        raise SystemExit("train_profile: no CUDA device")
    dev = torch.device("cuda", 0)
    cfg = TransformerConfig(**TRAIN, dtype=torch.bfloat16,
                            flash_bwd="fused" if fused else "auto")
    params = init_params(cfg, seed=0, device=dev)
    inp, tgt = train_batch(cfg.vocab, dev)
    step = make_train_step(cfg, lr=LR, donate=True)
    for _ in range(2):
        params, loss = step(params, inp, tgt)
    torch.cuda.synchronize()
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, loss = step(params, inp, tgt)
        torch.cuda.synchronize()
        step_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(events)
    total = sum(e.time_range.end - e.time_range.start for e in events)
    flash_us = {
        name: sum(e.time_range.end - e.time_range.start for e in events
                  if kern in e.name)
        for name, kern in FLASH_KERNELS.items()
    }
    rep = {
        "device": torch.cuda.get_device_name(0),
        "bwd": "fused" if fused else "split",
        "step_us": step_us,
        "device_busy_us": busy,
        "idle_share": 1 - busy / step_us,
        "kernels_per_step": len(events),
        "flash_us": flash_us,
        "flash_share_of_device_time": sum(flash_us.values()) / total,
        "launches": dict(fa.LAUNCHES),
        "loss": float(loss),
    }
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=20))
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
