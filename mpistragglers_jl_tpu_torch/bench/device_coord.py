"""Bench of fused K-epoch windows (``parallel/device_coord.py``) on one
card: the dispatch-overhead ladder, and the window at BASELINE config 3.

    python -m mpistragglers_jl_tpu_torch.bench.device_coord
        [--epochs 1000] [--config3] [--device cuda]

Prints the card's name and power limit (``nvidia-smi``), then one JSON
line.

* **The ladder** (the port of ``benchmarks/device_coord_bench.py``):
  the same (n=8, k=6) MDS-coded workload, A 24x32, B 32x8, a distinct
  payload each epoch (staged on the card, so neither side can hoist the
  compute out of its loop), both ways: the host loop (``asyncmap`` over
  ``CUDADeviceBackend`` plus ``result_device`` per epoch), then fused
  windows at K in ``KS`` (1, 8, 64), each as a replayed CUDA graph and
  as the same loop run eagerly (eagerly only, on the CPU). Zero delay schedule: pure dispatch overhead.
  ``devcoord_harvest_k`` is the K that ``sim.sweep_harvest_k`` picks
  when priced with this run's measured host costs on a seeded-lognormal
  fleet; ``devcoord_overhead_x`` is the host loop's ms/epoch over the
  graph window's at that K, and the bench fails below the reference's
  floor of 3. The last window's decode is held to float64 ``A @ B``.
* **Config 3** (``--config3``): 8196x8192 coded at (8, 6) (A padded to
  a multiple of k, as ``bench/coded_gemm.py``), B 8192x8192,
  ``"default"`` precision (bf16 operands, f32 sums and decode): the
  host loop ("ready" and "enqueue" arrival, one stacked product an
  epoch), then graph windows at K=8; ms/epoch (least of 3 chains, of
  7 epochs or 3 windows, that end in one synchronize) and the device's
  idle share over traced epochs (``torch.profiler``: one minus the
  union of kernel intervals over the wall). A trace that loses kernel
  events reads too high a share, so the window's share is bracketed
  from below by CUDA events: ``event_idle_share_floor`` counts only the
  time outside the device span of each window call.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .._device import resolve_device
from ..ops.coded_gemm import CodedGemm
from ..pool import AsyncPool, asyncmap, asyncmap_fused, waitall
from ..sim import sweep_harvest_k
from ..utils import faults

N, K_CODE = 8, 6
SEED = 17
KS = (1, 8, 64)
FLOOR_X = 3.0  # the reference's acceptance floor on devcoord_overhead_x
# config 3: K epochs a window; host-loop chains of 7 epochs and window
# chains of 3 windows; operands from seed 0, as bench/coded_gemm.py
CONFIG3_K, CONFIG3_EPOCHS, CONFIG3_WINDOWS, CONFIG3_SEED = 8, 7, 3, 0


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ladder(dev, *, epochs: int = 1000) -> dict:
    """The dispatch-overhead ladder; see the module docstring."""
    dev = resolve_device(dev)
    routes = ("graph", "eager") if dev.type == "cuda" else ("eager",)
    ks = [k for k in KS if k <= epochs]
    rng = np.random.default_rng(SEED)
    A = rng.standard_normal((K_CODE * 4, 32)).astype(np.float32)
    Bs_np = rng.standard_normal((epochs, 32, 8)).astype(np.float32)
    Bs = torch.from_numpy(Bs_np).to(dev)
    out: dict = {"epochs": epochs, "n": N, "k": K_CODE, "ks": ks,
                 "routes": list(routes)}
    cg = CodedGemm(A, N, K_CODE, devices=[dev])
    try:
        # -- the host loop: the before ------------------------------------
        pool = AsyncPool(N)
        asyncmap(pool, Bs[0], cg.backend, nwait=K_CODE)
        cg.result_device(pool)
        waitall(pool, cg.backend)
        _sync(dev)
        t0 = time.perf_counter()
        for e in range(epochs):
            asyncmap(pool, Bs[e], cg.backend, nwait=K_CODE)
            cg.result_device(pool)
        _sync(dev)
        host_s = time.perf_counter() - t0
        waitall(pool, cg.backend)
        out["host_loop_s"] = host_s
        out["host_ms_per_epoch"] = host_s / epochs * 1e3
        # -- fused windows: the after --------------------------------------
        rungs: dict = {}
        for route in routes:
            for K in ks:
                coord = cg.coordinator()  # zero-delay schedule
                coord._graph_windows = route == "graph"
                # warm-up: capture (or first run) off the clock
                asyncmap_fused(AsyncPool(N), Bs[:K], coord, epochs=K)
                coord.reset()
                fpool = AsyncPool(N)
                windows = epochs // K
                _sync(dev)
                t0 = time.perf_counter()
                for w in range(windows):
                    hist = asyncmap_fused(fpool, Bs[w * K:(w + 1) * K],
                                          coord, epochs=K)
                fused_s = time.perf_counter() - t0
                covered = windows * K
                assert hist.shape == (K, N)
                rungs[f"{route}_K{K}"] = {
                    "route": route, "K": K,
                    "fused_s": fused_s,
                    "ms_per_epoch": fused_s / covered * 1e3,
                    "harvest_ms": fused_s / windows * 1e3,
                    "windows": windows,
                    "overhead_x_vs_host": (host_s / epochs)
                    / (fused_s / covered),
                }
        out["ladder"] = rungs
        # decode identity on the final window's last epoch
        last = coord.last_decoded[-1].double().cpu().numpy()
        ref = A.astype(np.float64) @ Bs_np[covered - 1].astype(np.float64)
        err = float(np.max(np.abs(last - ref)) / np.max(np.abs(ref)))
        out["decode_rel_err"] = err
        if err > 1e-3:
            raise RuntimeError(
                f"fused window decode diverged: rel err {err:.2e}")
    finally:
        cg.backend.shutdown()
    # -- the swept K: the sim twin priced with this run's host costs -----
    best_route = routes[0]
    best_harvest_s = min(r["harvest_ms"] for r in rungs.values()
                         if r["route"] == best_route) / 1e3
    sweep = sweep_harvest_k(
        faults.seeded_lognormal(0.02, 0.6, seed=4),
        n_workers=N, nwait=K_CODE, epochs=min(epochs, 256),
        k_values=tuple(ks),
        host_epoch_s=host_s / epochs,
        host_harvest_s=best_harvest_s,
    )
    swept = int(sweep["best"])
    out["sweep"] = {
        "best_k": swept,
        "host_loop_epochs_per_s": sweep["host_loop_epochs_per_s"],
        "best_epochs_per_s": sweep["best_entry"]["epochs_per_s"],
        "staleness_s": sweep["best_entry"]["staleness_s"],
    }
    out["devcoord_harvest_k"] = swept
    out["devcoord_route"] = best_route
    out["devcoord_overhead_x"] = rungs[f"{best_route}_K{swept}"][
        "overhead_x_vs_host"]
    if out["devcoord_overhead_x"] < FLOOR_X:
        raise RuntimeError(
            f"devcoord_overhead_x {out['devcoord_overhead_x']:.3f} below "
            f"the {FLOOR_X}x floor at the swept K={swept} (host "
            f"{out['host_ms_per_epoch']:.4f} ms/epoch vs fused "
            f"{rungs[f'{best_route}_K{swept}']['ms_per_epoch']:.4f})")
    return out


def _chains(fn, reps: int, dev) -> float:
    """Least-of-3-chains ms per call over ``reps`` calls, each chain
    ending in one synchronize."""
    best = None
    for _ in range(3):
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3 / reps
        best = ms if best is None else min(best, ms)
    return best


def _event_idle_floor(fn, reps: int, dev) -> float:
    """One minus the CUDA-event span of ``reps`` calls over their host
    wall. Each call must end with the card drained (a window's harvest
    does), so the card is idle outside the span from a marker recorded
    before the call to one recorded after it: the device's idle share
    is at least this, whatever a trace may lose."""
    stream = torch.cuda.current_stream(dev)
    span = wall = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _sync(dev)
        t0 = time.perf_counter()
        start.record(stream)
        fn()
        end.record(stream)
        end.synchronize()
        wall += (time.perf_counter() - t0) * 1e3
        span += start.elapsed_time(end)
    return 1.0 - span / wall


def config3(dev) -> dict:
    """Config 3's coded GEMM at ``"default"``: the host loop, then graph
    windows of ``CONFIG3_K`` epochs; see the module docstring."""
    from .coded_gemm import MDS_M, REL_TOL, _operands, device_ms, rel_err

    dev = resolve_device(dev)
    m, n, k = MDS_M, N, K_CODE
    K = CONFIG3_K
    A, B = _operands(m, m, m, CONFIG3_SEED, dev)
    C_ref = torch.matmul(A, B)
    m_pad = -(-m // k) * k
    A_pad = torch.zeros(m_pad, m, device=dev)
    A_pad[:m] = A
    del A
    out: dict = {"m": m, "m_padded": m_pad, "n": n, "k": k,
                 "precision": "default", "K": K}
    tol = REL_TOL["default"]
    for arrival in ("ready", "enqueue"):
        cg = CodedGemm(A_pad, n, k, devices=[dev], precision="default",
                       batch=True, batch_arrival=arrival)
        pool = AsyncPool(n)

        def epoch():
            asyncmap(pool, B, cg.backend, nwait=k)
            C = cg.result_device(pool)
            waitall(pool, cg.backend)
            return C

        try:
            C = epoch()  # warm-up: the solver's first call
            ms = _chains(epoch, CONFIG3_EPOCHS, dev)
            traced = device_ms(epoch, 3)
            err = rel_err(epoch()[:m], C_ref)
            if arrival == "ready":
                # the window after the host loop, on the same blocks
                coord = cg.coordinator(nwait=k)
                wpool = AsyncPool(n)
                asyncmap_fused(wpool, B, coord, epochs=K)  # capture
                wms = _chains(lambda: asyncmap_fused(wpool, B, coord,
                                                     epochs=K),
                              CONFIG3_WINDOWS, dev) / K
                wtraced = device_ms(
                    lambda: asyncmap_fused(wpool, B, coord, epochs=K), 1)
                wfloor = _event_idle_floor(
                    lambda: asyncmap_fused(wpool, B, coord, epochs=K),
                    CONFIG3_WINDOWS, dev)
                werr = rel_err(coord.last_decoded[-1][:m], C_ref)
                out["window"] = {
                    "ms_per_epoch": wms, "rel_err": werr, "rel_tol": tol,
                    "ok": werr <= tol,
                    "event_idle_share_floor": wfloor,
                    "graph": bool(coord._programs) and all(
                        getattr(p, "graph", None) is not None
                        for p in coord._programs.values()),
                }
                if wtraced is not None:
                    wall, busy, top = wtraced
                    out["window"].update(
                        traced_ms_per_epoch=wall / K,
                        device_busy_ms_per_epoch=busy / K,
                        device_idle_share=1.0 - busy / wall,
                        top_kernels_ms_per_window=top)
                del coord
        finally:
            cg.backend.shutdown()
        rung = {"ms_per_epoch": ms, "rel_err": err, "rel_tol": tol,
                "ok": err <= tol}
        if traced is not None:
            wall, busy, top = traced
            rung.update(traced_ms_per_epoch=wall, device_busy_ms=busy,
                        device_idle_share=1.0 - busy / wall,
                        top_kernels_ms=top)
        out[f"host_loop_{arrival}"] = rung
        del cg, pool, C
        torch.cuda.empty_cache()
    out["ok"] = all(out[r]["ok"] for r in ("host_loop_ready",
                                           "host_loop_enqueue", "window"))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--config3", action="store_true",
                    help="also time config 3's window at K=8")
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the eager "
                         "window on the host (no graphs, no config 3)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from .decode_kernel_attrib import card

        torch.backends.cuda.matmul.allow_tf32 = False
        name, smi = card()
        print(smi)
    res = {"ladder": ladder(dev, epochs=args.epochs)}
    if args.config3 and dev.type == "cuda":
        res["config3"] = config3(dev)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
