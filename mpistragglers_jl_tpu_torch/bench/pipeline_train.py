"""Pipeline training bench of the port: the flagship transformer through
``parallel/pipeline.py`` on one card.

Three cells, each phase 14's model (vocab 32768, d_model 1024, 8 heads
of 128, 8 layers, d_ff 4096, bf16, Ulysses over the flash kernels
K1-K3; batch 8, sequence 2048, SGD at lr 1e-3, random weights from
seed 0), every rank of the mesh on cuda:0:

* ``1f1b``: the MoE of ``bench/moe_train.py`` (4 experts, cf 1.25, aux
  0.01) in 1F1B stages on ``("dp", "pp")`` = (4, 2), 2 microbatches
  (``MULTICHIP_r05.json``'s fourth leg's mesh);
* ``gpipe`` and ``circular`` (2 virtual stages): dense stages on (1, 4),
  4 microbatches.

    python -m mpistragglers_jl_tpu_torch.bench.pipeline_train

Prints the card's name and power limit (``nvidia-smi``), then one JSON
line per cell: ms per step (host clock around 2 steps after 1 warm-up,
ending in a synchronize), tokens/s, peak memory, the flash kernels'
launches over the 3 steps (every count set to 0 just before), and the
bubble that ``measure_bubble`` reads on the card beside
``bubble_fraction``. Eight ranks on one card measure each rank's cost
and the host's dispatch, not a pipeline's overlap across cards.
"""

from __future__ import annotations

import json
import time

import torch

from ..models.transformer import TransformerConfig, init_params
from ..parallel import make_mesh
from ..parallel.pipeline import (
    make_pipeline_train_step,
    measure_bubble,
    shard_params_pipeline,
)
from .decode_kernel_attrib import card
from .moe_train import moe_config
from .train_profile import (
    LR,
    TRAIN,
    _free_garbage,
    launch_counts,
    train_batch,
    zero_launches,
)

TIMED = 2  # timed steps after one warm-up (chip_smoke.py runs this depth)
V = 2      # the circular schedule's virtual stages
# schedule -> (mesh (dp, pp), microbatches, experts)
CELLS = {"1f1b": ((4, 2), 2, True), "gpipe": ((1, 4), 4, False),
         "circular": ((1, 4), 4, False)}


def cell_config(schedule: str) -> TransformerConfig:
    """The cell's model in bf16: the MoE for 1F1B, phase 14's dense
    model otherwise."""
    if CELLS[schedule][2]:
        return moe_config()
    return TransformerConfig(**TRAIN, dtype=torch.bfloat16)


def train_run(step, params, inp, tgt, dev):
    """One warm-up and ``TIMED`` steps between a reset of every launch
    count and a read: ``(params, report)``; the report's times are the
    host clock around steps that end in a synchronize."""
    _free_garbage()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    params, loss0 = step(params, inp, tgt)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    losses = []
    t0 = time.perf_counter()
    for _ in range(TIMED):
        params, loss = step(params, inp, tgt)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TIMED
    return params, {
        "ms_per_step": dt * 1e3,
        "tokens_per_s": inp.numel() / dt,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "warmup_step_s": warm,
        "loss_trajectory": [loss0.item()] + [x.item() for x in losses],
        "steps": 1 + TIMED,
        "launches": launch_counts(),
    }


def pipeline_mesh(dev, shape):
    return make_mesh(shape, ("dp", "pp"), devices=[dev] * (shape[0]
                                                            * shape[1]))


def bench_cell(dev, schedule: str, params0=None):
    """One cell's timed run (``params0``: the dense seed-0 tree, made
    here when None): ``(stepped params, report)``."""
    shape, M, _ = CELLS[schedule]
    cfg = cell_config(schedule)
    mesh = pipeline_mesh(dev, shape)
    if params0 is None:
        params0 = init_params(cfg, seed=0, device=dev)
    vs = V if schedule == "circular" else None
    params = shard_params_pipeline(params0, cfg, mesh, virtual_stages=vs)
    step = make_pipeline_train_step(cfg, mesh, n_microbatch=M, lr=LR,
                                    schedule=schedule, virtual_stages=V,
                                    donate=True)
    inp, tgt = train_batch(cfg.vocab, dev)
    params, rep = train_run(step, params, inp, tgt, dev)
    bub = measure_bubble(mesh, M, schedule, v=V)
    rep.update({"schedule": bub["schedule"], "mesh": list(shape),
                "n_microbatch": M, "experts": cfg.n_experts,
                "bubble_measured": bub["measured"],
                "bubble_formula": bub["formula"], "ticks": bub["ticks"]})
    return params, rep


def main() -> int:
    name, smi = card()
    dev = torch.device("cuda", 0)
    print(f"device: {name}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(smi)
    for schedule in CELLS:
        _, rep = bench_cell(dev, schedule)
        rep["card"] = smi
        print(json.dumps(rep))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
