"""MoE training bench of the port: ``benchmarks/moe_bench.py`` on the GPU.

The flagship transformer (vocab 32768, d_model 1024, 8 layers, 8 heads
of 128, d_ff 4096, bf16, Ulysses over the flash kernels K1-K3) with
every layer's MLP replaced by 4 top-1 Switch experts of the same d_ff
(``capacity_factor`` 1.25, aux-loss coefficient 0.01), trained by SGD
(lr 1e-3) at batch 8, sequence 2048, from seed 0 through the sharded
program ``make_train_step(cfg, mesh)`` on a (1, 1, 1, 1) ``("dp", "ep",
"sp", "tp")`` mesh, as ``benchmarks/moe_bench.py`` does; beside it in
the same process the same MoE on one device (``mesh=None``, every
expert resident) and the dense flagship.

    python -m mpistragglers_jl_tpu_torch.bench.moe_train [--steps 4]
        [--chains 2]

Prints the card's name and power limit (``nvidia-smi``), then one JSON
line:

* ms per step and tokens/s: CUDA events around a chain of ``steps``
  steps, the least of ``chains`` chains, the mesh, one-device and dense
  chains alternated (``one_device_ms_per_step``, ``dense_ms_per_step``
  beside the mesh step's ``ms_per_step``);
* ``routing_overhead_share`` = (one-device MoE step - dense step) /
  one-device MoE step; ``mesh_routing_overhead_share`` the same for the
  mesh step (its layout copies and per-rank loop included);
* MFU against activated FLOPs (each token runs one expert of the dense
  MLP's width, so the dense step's matmul FLOPs,
  ``train_profile.model_flops_per_step``), over a raw bf16 matmul chain
  timed in the same process;
* ``drop_rate`` at capacity factor 1.25 and at 0.5, from layer 0's
  router on the training batch after the steps, and the aux loss there
  at init;
* a 12-step loss trajectory and the reference's check of it
  (``trajectory_ok``: the loss falls by more than 5 times the median
  |second difference|, its own noise);
* every kernel's launches over the mesh side's warm-up step and first
  chain (``launches``) and over the one-device side's
  (``one_device_launches``), each count set to 0 just before each, and
  the mesh side's peak memory.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models.moe import _capacity, switch_route_indices
from ..models.transformer import (
    TransformerConfig,
    _leaves,
    init_params,
    make_train_step,
    shard_params,
)
from .decode_kernel_attrib import card
from .train_profile import (
    BATCH,
    LR,
    SEQ,
    TRAIN,
    _free_garbage,
    launch_counts,
    model_flops_per_step,
    raw_matmul_tflops,
    zero_launches,
)

# benchmarks/moe_bench.py's experts and mesh
MOE = dict(n_experts=4, capacity_factor=1.25, moe_aux_coef=0.01)
MESH_AXES = ("dp", "ep", "sp", "tp")
TRAJ_STEPS = 12


def moe_config(dtype=torch.bfloat16, **kw) -> TransformerConfig:
    """The bench's MoE configuration (``kw`` replaces fields)."""
    return TransformerConfig(**{**TRAIN, **MOE, **kw}, dtype=dtype)


class _Side:
    """One model's state: ``params`` (laid out over ``mesh`` as copies,
    or stepped in place on one device), its batch (``data``, (B, L +
    1)), its step and its best chain."""

    def __init__(self, cfg, params, data, dev, mesh=None):
        self.cfg = cfg
        self.params = params
        if mesh is not None:
            self.params = shard_params(params, cfg, mesh)
        tok = torch.as_tensor(data, device=dev)
        self.inp, self.tgt = tok[:, :-1], tok[:, 1:]
        self.step = make_train_step(cfg, mesh, lr=LR, donate=True)
        self.best = None
        self.loss0 = self.loss = None

    def warm(self) -> None:
        self.params, loss = self.step(self.params, self.inp, self.tgt)
        self.loss0 = loss.item()

    def chain(self, steps: int) -> None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(steps):
            self.params, loss = self.step(self.params, self.inp, self.tgt)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / steps
        self.best = ms if self.best is None else min(self.best, ms)
        self.loss = loss.item()


def trajectory(step, params, inp, tgt, steps: int = TRAJ_STEPS):
    """``steps`` train steps on one batch, the losses fetched once, and
    the reference's noise-calibrated check: (params, report) with
    ``trajectory_ok`` = the drop (first - last) exceeds 5 times the
    median |second difference| of the losses."""
    losses = []
    for _ in range(steps):
        params, loss = step(params, inp, tgt)
        losses.append(loss)
    traj = torch.stack(losses).float().tolist()
    drop = traj[0] - traj[-1]
    noise = float(np.median(np.abs(np.diff(traj, n=2))))
    return params, {"trajectory": traj, "trajectory_drop": drop,
                    "trajectory_noise_med2nd": noise,
                    "trajectory_ok": bool(drop > 5 * max(noise, 1e-9))}


def _local0(leaf):
    """A leaf's tensor on flat rank 0 (the whole of it on a mesh of
    one position)."""
    return leaf if isinstance(leaf, torch.Tensor) else leaf.local(0)


def layer0_routing(params, inp, cfg) -> dict:
    """Layer 0's router on the batch's embeddings: the dropped share of
    tokens at the config's capacity factor and at 0.5, and the aux
    loss."""
    T = inp.numel()
    E = cfg.n_experts
    with torch.no_grad():
        x = _local0(params["emb"])[inp.long()].reshape(T, cfg.d_model)
        wg = _local0(params["layers"][0]["wg"])
        table, _, _, aux = switch_route_indices(
            x, wg, _capacity(T, E, cfg.capacity_factor))
        table_h = switch_route_indices(x, wg, _capacity(T, E, 0.5))[0]
        return {"drop_rate": 1.0 - (table < T).sum().item() / T,
                "drop_rate_at_cf_0.5": 1.0 - (table_h < T).sum().item() / T,
                "aux_loss": aux.item()}


def bench_moe_train(dev, *, steps: int = 4, chains: int = 2) -> dict:
    from ..parallel import make_mesh

    rng = np.random.default_rng(0)
    data = rng.integers(0, TRAIN["vocab"], (BATCH, SEQ + 1), dtype=np.int32)
    mesh = make_mesh((1,) * len(MESH_AXES), MESH_AXES, devices=[dev])
    cfg = moe_config()
    params = init_params(cfg, seed=0, device=dev)  # the host draws once
    moe = _Side(cfg, params, data, dev, mesh)
    n_params = sum(_local0(p).numel() for p in _leaves(moe.params))
    at_init = layer0_routing(moe.params, moe.inp, cfg)
    _free_garbage()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    moe.warm()
    moe.chain(steps)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    one = _Side(cfg, params, data, dev)
    zero_launches()
    one.warm()
    one.chain(steps)
    one_launches = launch_counts()
    dcfg = moe_config(n_experts=0, moe_aux_coef=0.0)
    dense = _Side(dcfg, init_params(dcfg, seed=0, device=dev),
                  rng.integers(0, TRAIN["vocab"], (BATCH, SEQ + 1),
                               dtype=np.int32), dev)
    dense.warm()
    dense.chain(steps)
    for _ in range(chains - 1):
        moe.chain(steps)
        one.chain(steps)
        dense.chain(steps)
    del one.params, params
    moe.params, tr = trajectory(moe.step, moe.params, moe.inp, moe.tgt)
    routing = layer0_routing(moe.params, moe.inp, cfg)
    raw = raw_matmul_tflops(dev)
    flops = model_flops_per_step(cfg, BATCH, SEQ)
    ms = moe.best
    out = {
        "metric": "moe-train-step", "mesh": dict(mesh.shape),
        "ms_per_step": ms,
        "tokens_per_s": BATCH * SEQ / ms * 1e3,
        "activated_tflops_per_s": flops / ms / 1e9,
        "mfu_vs_raw_matmul": flops / ms / 1e9 / raw,
        "raw_bf16_tflops_per_s": raw,
        "params_m": n_params / 1e6, "n_experts": cfg.n_experts,
        "capacity_factor": cfg.capacity_factor,
        "capacity_per_expert": _capacity(BATCH * SEQ, cfg.n_experts,
                                         cfg.capacity_factor),
        "drop_rate": routing["drop_rate"],
        "drop_rate_at_cf_0.5": routing["drop_rate_at_cf_0.5"],
        "aux_loss_at_init": at_init["aux_loss"],
        "aux_loss_after": routing["aux_loss"],
        "loss_first": moe.loss0, "loss_last": moe.loss,
        **tr,
        "launches": launches, "launch_steps": 1 + steps,
        "peak_mem_gb": peak / 1e9, "batch": BATCH, "seq": SEQ,
        "steps_per_chain": steps, "chains_min_of": chains,
        "one_device_ms_per_step": one.best,
        "one_device_loss_first": one.loss0,
        "one_device_launches": one_launches,
        "dense_ms_per_step": dense.best,
        "dense_tokens_per_s": BATCH * SEQ / dense.best * 1e3,
        "routing_overhead_share": (one.best - dense.best) / one.best,
        "mesh_routing_overhead_share": (ms - dense.best) / ms,
        "dense_loss_first": dense.loss0, "chains_alternated": True,
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--chains", type=int, default=2)
    args = ap.parse_args(argv)
    name, smi = card()
    dev = torch.device("cuda", 0)
    print(f"device: {name}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(smi)
    res = bench_moe_train(dev, steps=args.steps, chains=args.chains)
    res["card"] = smi
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
