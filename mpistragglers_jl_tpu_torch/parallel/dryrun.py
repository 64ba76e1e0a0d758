"""The multi-device dry run: every sharded path of the port over an
n-rank single-controller mesh, each held to a dense oracle.

Counterpart of the JAX package's ``__graft_entry__.py``
``dryrun_multichip``, with its shapes, its draws from one
``np.random.default_rng(0)`` in its order, and its asserts, on the mesh
of ``parallel/mesh.py``: ``n_devices`` ranks of one device (the card by
default, ``device="cpu"`` for the host). The legs:

0. the virtual-time pool (``sim/``): 50 epochs twice, bit-identical;
1. the mesh coded GEMM with two stale ranks masked, the pool-fused epoch
   on real arrivals, MatDot's one weighted sum, and the rateless epoch
   past a straggler that never returns (held on a gate until the leg
   ends, where the reference sleeps it 30 s);
2. a dp x tp logistic-regression SGD step, its two psums written out;
3. the transformer train step over ``(dp, sp, tp)`` (ring attention);
4. the 1F1B pipeline step with MoE stages over ``(dp, pp)``;
5. the expert-parallel train step over ``(dp, sp, tp, ep)``;
6. GQA (kv=2): a train step, then sharded inference, each equal to its
   dense program: greedy ``make_generate`` on ``(dp, tp)``, the int8
   ring ``make_ring_generate``, ``make_speculative`` with both drafters
   on ``(1, 4)``, and the serving tick ``make_serving_scan`` on the
   ``(dp, sp, tp)`` mesh, whose ``sp`` replicates.

It prints the reference's summary line.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["dryrun_multichip"]


def _sim_smoke() -> None:
    from .. import AsyncPool, SimBackend, asyncmap, waitall

    def once():
        sbe = SimBackend(
            lambda i, p, e: np.asarray([i, e]), 8,
            delay_fn=lambda i, e: 1.5 if i in (0, 7) else 0.001 * (i + 1),
        )
        spool = AsyncPool(8)
        reps = [asyncmap(spool, np.zeros(1), sbe, nwait=6).copy()
                for _ in range(50)]
        waitall(spool, sbe)
        return np.stack(reps), sbe.clock.now()

    r1, v1 = once()
    r2, v2 = once()
    assert (r1 == r2).all() and v1 == v2, "sim must be bit-identical"
    for idx in range(50):  # fastest-6 fresh, stragglers stale, EVERY epoch
        assert (r1[idx] == idx + 1).sum() == 6
        assert r1[idx][0] != idx + 1 and r1[idx][7] != idx + 1
    print(f"sim smoke: 50 virtual epochs, {v1:.2f}s virtual, "
          "bit-identical across runs: ok")


def _coded_legs(n, devices, rng) -> tuple:
    """Leg 1: (the mesh, the straggler count, the rateless note)."""
    from ..ops.rateless import RatelessLTGemm
    from ..pool import AsyncPool, waitall
    from .fused import PoolMeshCodedGemm
    from .mesh import PartitionSpec as P, make_mesh
    from .mesh_gemm import MeshCodedGemm, MeshMatDotGemm

    mesh = make_mesh(n, devices=devices)
    k = max(1, n - 2)  # tolerate up to 2 stragglers
    A = rng.standard_normal((k * 8, 32)).astype(np.float32)
    B = rng.standard_normal((32, 16)).astype(np.float32)
    mg = MeshCodedGemm(A, mesh, k)
    repochs = np.full(n, 3)
    n_stale = 2 if n > 2 else 0
    if n_stale:
        repochs[[0, n - 1]] = 1  # two stale stragglers, weight-masked out
    C = mg.full(mg.epoch(B, repochs=repochs, epoch=3))
    assert np.allclose(C, A @ B, atol=1e-2), "mesh coded decode mismatch"

    # 1a: the fused pool-driven epoch on real arrivals
    def delay(i, epoch):
        return 1.5 if n_stale and i in (0, n - 1) else 0.0

    fg = PoolMeshCodedGemm(A, mesh, k, delay_fn=delay, dtype=np.float32)
    pool = AsyncPool(n)
    fused = fg.epoch(pool, B.astype(np.float32))
    assert len(pool.fresh_indices()) >= k
    if n_stale:
        assert pool.repochs[0] != pool.epoch, "straggler 0 should be stale"
        assert pool.repochs[n - 1] != pool.epoch
    # the decode stays sharded: one block per rank, each its own tensor
    blocks = [fused.local(r) for r in range(n)]
    assert fused.spec == P("w") and len({id(b) for b in blocks}) == n, (
        "fused decode must stay sharded")
    assert np.allclose(fg.full(fused), A @ B, atol=1e-2), (
        "fused pool decode mismatch")
    waitall(pool, fg.backend, timeout=10.0)
    fg.shutdown()

    # 1b: MatDot, whose decode is one weighted psum over the axis
    if n - n_stale >= 3:  # recovery threshold 2p-1 = 3 with p = 2
        md = MeshMatDotGemm(A, mesh, p=2)
        C2 = np.asarray(md.epoch(B, repochs=repochs, epoch=3))
        assert np.allclose(C2, A @ B, atol=1e-2), "matdot psum mismatch"

    # 1c: rateless incremental redundancy past a permanent straggler
    note = ""
    if n >= 6:
        gate = threading.Event()

        def held(i, e):
            if i == 0:
                gate.wait(60)
            return 0.0

        rl = RatelessLTGemm(np.asarray(A[:4 * 2], dtype=np.float32), 6, 4,
                            seed=0, systematic=False, delay_fn=held,
                            devices=devices[:1])
        try:
            C_rl = rl.multiply(np.asarray(B, dtype=np.float32),
                               AsyncPool(6), round_timeout=2.0,
                               max_rounds=6)
            assert np.allclose(C_rl.cpu().numpy(), A[:4 * 2] @ B,
                               atol=1e-2), "rateless decode mismatch"
            assert rl.stats["max_generation"] >= 1, rl.stats
        finally:
            gate.set()
            rl.backend.shutdown()
        note = (f"+ rateless epoch (gen {rl.stats['max_generation']}, "
                f"{rl.stats['shards_used']}/{rl.stats['k']} shards) ")
    return mesh, n_stale, note


def _logreg_leg(dp, tp, devices, rng):
    """Leg 2: one SGD step of logistic regression, the batch over dp and
    the features over tp: the logits' partial sums meet in a psum over
    tp, the gradient's in a psum over dp (the two XLA inserts). Held to
    the dense step as well as to the reference's shape assert."""
    from .collectives import psum
    from .mesh import PartitionSpec as P, from_local, make_mesh, shard

    mesh = make_mesh((dp, tp), ("dp", "tp"), devices=devices)
    batch, dim = 8 * dp, 16 * tp
    X = rng.standard_normal((batch, dim)).astype(np.float32)
    y = rng.integers(0, 2, batch).astype(np.float32)
    Xs, ys = shard(X, mesh, P("dp", "tp")), shard(y, mesh, P("dp"))
    w = shard(np.zeros(dim, np.float32), mesh, P("tp"))
    n = mesh.size
    logits = psum([Xs.local(r) @ w.local(r) for r in range(n)], mesh, "tp")
    dl = [(torch.sigmoid(lg) - ys.local(r)) / batch
          for r, lg in enumerate(logits)]
    g = psum([Xs.local(r).T @ dl[r] for r in range(n)], mesh, "dp")
    w2 = from_local(mesh, P("tp"), [w.local(r) - 0.1 * g[r]
                                    for r in range(n)], (dim,))
    assert w2.shape == w.shape
    want = -0.1 * X.T @ ((0.5 - y) / batch)  # sigmoid(0) = 0.5
    assert np.allclose(np.asarray(w2), want, atol=1e-5), (
        "sharded logistic-regression step mismatch")
    return mesh


def _two_steps(step, params, toks, tgts, what):
    params, loss0 = step(params, toks, tgts)
    params, loss1 = step(params, toks, tgts)
    assert float(loss1) < float(loss0), (what, float(loss0), float(loss1))
    return params


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Every leg of the reference's dry run over ``n_devices`` ranks of
    ``device`` (default ``cuda``; a device may repeat, so one card holds
    them all). Raises AssertionError on the first leg that disagrees
    with its oracle; prints one summary line when all pass."""
    from ..models.decode import (
        generate_dense,
        generate_ring_dense,
        make_generate,
        make_ring_generate,
    )
    from ..models.serving import make_serving_scan, serving_decode_step_dense
    from ..models.speculative import (
        generate_speculative_dense,
        make_speculative,
    )
    from ..models.transformer import (
        TransformerConfig,
        data_spec,
        init_params,
        make_train_step,
        shard_params,
    )
    from .mesh import PartitionSpec as P, make_mesh, shard
    from .pipeline import (
        bubble_fraction,
        make_pipeline_train_step,
        shard_params_pipeline,
    )

    dev = resolve_device(device)
    devices = [dev] * int(n_devices)

    _sim_smoke()
    rng = np.random.default_rng(0)
    mesh, n_stale, rl_note = _coded_legs(n_devices, devices, rng)

    dp = 2 if n_devices % 2 == 0 else 1
    tp = n_devices // dp
    mesh2 = _logreg_leg(dp, tp, devices, rng)

    # --- 3. the transformer train step over (dp, sp, tp) ---------------
    sp = 2 if n_devices % 2 == 0 else 1
    tp2 = 2 if (n_devices // sp) % 2 == 0 else 1
    dp2 = n_devices // (sp * tp2)
    mesh3 = make_mesh((dp2, sp, tp2), ("dp", "sp", "tp"), devices=devices)
    cfg = TransformerConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                            d_ff=64)
    params = shard_params(init_params(cfg, seed=0, device=dev), cfg, mesh3)
    data = rng.integers(0, cfg.vocab, (2 * dp2, 8 * sp + 1)).astype(np.int32)
    toks, tgts = data[:, :-1], data[:, 1:]
    _two_steps(make_train_step(cfg, mesh3, lr=0.1), params, toks, tgts,
               "transformer")

    # --- 4. the 1F1B pipeline with MoE stages over (dp, pp) ------------
    pp = 2 if n_devices % 2 == 0 else 1
    dp3 = n_devices // pp
    n_micro = 2
    mesh4 = make_mesh((dp3, pp), ("dp", "pp"), devices=devices)
    cfg_pp = TransformerConfig(vocab=64, d_model=32, n_heads=4,
                               n_layers=2 * pp, d_ff=64, n_experts=2,
                               moe_aux_coef=0.01)
    params_pp = shard_params_pipeline(
        init_params(cfg_pp, seed=1, device=dev), cfg_pp, mesh4)
    data = rng.integers(0, cfg_pp.vocab, (4 * dp3, 9)).astype(np.int32)
    _two_steps(make_pipeline_train_step(cfg_pp, mesh4, n_microbatch=n_micro,
                                        lr=0.1, schedule="1f1b"),
               params_pp, data[:, :-1], data[:, 1:], "1F1B")
    pbubble = bubble_fraction(pp, n_micro, "1f1b")

    # --- 5. expert parallelism over (dp, sp, tp, ep) --------------------
    ep = 2 if n_devices % 2 == 0 else 1
    dpm = 2 if (n_devices // ep) % 2 == 0 else 1
    tpm = 2 if (n_devices // (ep * dpm)) % 2 == 0 else 1
    spm = n_devices // (ep * dpm * tpm)
    mesh5 = make_mesh((dpm, spm, tpm, ep), ("dp", "sp", "tp", "ep"),
                      devices=devices)
    cfg_moe = TransformerConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                                d_ff=64, n_experts=2 * max(ep, 1),
                                moe_aux_coef=0.01)
    params_moe = shard_params(init_params(cfg_moe, seed=2, device=dev),
                              cfg_moe, mesh5)
    data = rng.integers(0, cfg_moe.vocab,
                        (2 * dpm * ep, 8 * spm + 1)).astype(np.int32)
    _two_steps(make_train_step(cfg_moe, mesh5, lr=0.1), params_moe,
               shard(data[:, :-1], mesh5, data_spec(cfg_moe)),
               shard(data[:, 1:], mesh5, data_spec(cfg_moe)), "MoE")

    # --- 6. GQA: a train step, then sharded inference ------------------
    cfg_g = TransformerConfig(vocab=64, d_model=32, n_heads=4, n_kv_heads=2,
                              n_layers=2, d_ff=64, attn="ulysses")
    params_h = init_params(cfg_g, seed=3, device=dev)
    _two_steps(make_train_step(cfg_g, mesh3, lr=0.1),
               shard_params(params_h, cfg_g, mesh3), toks, tgts, "GQA")
    prompt = rng.integers(0, cfg_g.vocab, (2 * dp, 8)).astype(np.int32)
    want = generate_dense(params_h, prompt, 4, cfg_g, device=dev)
    got = make_generate(cfg_g, mesh2, n_new=4)(
        shard_params(params_h, cfg_g, mesh2),
        shard(prompt, mesh2, P("dp", None)))
    assert torch.equal(got.gather(dev), want), (
        "sharded generate diverged from the dense oracle")

    # the serving variants: the O(W) ring with int8 KV, sharded == dense
    cfg_w = dataclasses.replace(cfg_g, attn_window=3)
    want_ring = generate_ring_dense(params_h, prompt, 4, cfg_w,
                                    quantize_kv=True, device=dev)
    got_ring = make_ring_generate(cfg_w, mesh2, n_new=4, quantize_kv=True)(
        shard_params(params_h, cfg_w, mesh2),
        shard(prompt, mesh2, P("dp", None)))
    assert torch.equal(got_ring.gather(dev), want_ring), (
        "sharded ring+int8 generate diverged from the dense oracle")

    # speculative decoding on (1, 4), both drafters == the dense programs
    mesh_s = make_mesh((1, 4), ("dp", "tp"), devices=devices[:4])
    prompt_s = prompt[:1]
    ps = shard_params(params_h, cfg_g, mesh_s)
    for layers in (None, 1):
        want_spec, want_fwd = generate_speculative_dense(
            params_h, prompt_s, 5, cfg_g, k=3, draft_layers=layers,
            device=dev)
        got_spec, fwd = make_speculative(cfg_g, mesh_s, prompt_s.shape[1], 5,
                                         k=3, draft_layers=layers)(ps,
                                                                   prompt_s)
        assert torch.equal(got_spec.gather(dev), want_spec) and (
            fwd == want_fwd), (
            f"sharded speculative decode (draft_layers={layers}) diverged "
            "from the dense program")

    # the serving tick on (dp, sp, tp): sp replicates the slots
    S, n_inner = 2 * dp, 2
    tok_s = torch.as_tensor(rng.integers(1, cfg_w.vocab, S), dtype=torch.int32)
    pos_s = torch.as_tensor(rng.integers(3, 9, S), dtype=torch.int32)
    shp = (S, cfg_w.attn_window, cfg_w.kv_heads, cfg_w.head_dim)
    cache_rows = [{kk: torch.as_tensor(rng.standard_normal(shp) * 0.1,
                                       dtype=cfg_w.dtype, device=dev)
                   for kk in ("k", "v")} for _ in range(cfg_w.n_layers)]
    dtok, dpos = tok_s.to(dev), pos_s.to(dev)
    dc = [{kk: a.clone() for kk, a in c.items()} for c in cache_rows]
    for _ in range(n_inner):
        lg, dc = serving_decode_step_dense(params_h, dtok, dpos, dc, cfg_w)
        dtok = torch.argmax(lg, dim=-1).to(torch.int32)
        dpos = dpos + 1
    got_serve = make_serving_scan(cfg_w, mesh3, n_inner)(
        shard_params(params_h, cfg_w, mesh3), tok_s, pos_s,
        torch.zeros(S, dtype=torch.bool), cache_rows)
    assert torch.equal(got_serve[0].gather(dev), dtok), (
        "sharded serving tick diverged from the dense per-row step")

    print(
        f"dryrun_multichip({n_devices}): coded-GEMM + MatDot-psum epochs "
        f"+ FUSED pool-driven epoch (real arrivals, in-place decode) "
        f"on {mesh.shape} "
        f"({n_stale} stragglers masked) {rl_note}+ "
        f"logreg step on {mesh2.shape} + "
        f"transformer train step (ring attention) on {mesh3.shape} + "
        f"1F1B MoE pipeline train step on {mesh4.shape} "
        f"(bubble {pbubble:.2f}) + "
        f"MoE train step (all_to_all ep) on {mesh5.shape} + "
        f"GQA (kv=2) train step on {mesh3.shape} + KV-cache greedy "
        f"decode on {mesh2.shape} (== dense oracle) + ring-cache int8 "
        f"windowed decode (== dense oracle) + sharded speculative "
        f"decode on {mesh_s.shape} (n-gram AND truncated-layer model "
        f"drafters == dense programs) + serving "
        f"scheduler tick (S={S} slots, per-row pos) on {mesh3.shape} "
        f"(== dense per-row step): ok"
    )
