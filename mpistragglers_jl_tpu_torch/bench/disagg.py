"""The live half of the disaggregation rung: KV-page migration between two
paged schedulers, and the migration ring's transfer rate.

A port of ``benchmarks/disagg_bench.py``'s ``bench_disagg_live_rung``
(its simulated half needs the router, ``ROADMAP.md`` Queue 1 item 12b).

* **handoff**: a ``PrefillWorker`` and a ``DecodeReplica`` (one
  ``MigrationPlanner``) on the same parameters; every request migrates
  at its first token, alternately in process (the captured tensors go
  straight to the destination) and through frames (``ticket_to_frames``
  into a ``MigrationRing``, ``ticket_from_frames`` back, the way a
  ticket crosses processes). Each handoff is timed from export to the
  end of adoption, the card synchronized at both ends, with its payload
  bytes (``MigrationTicket.nbytes``: pages held times the page's bytes).
  Every migrated stream must equal the stream of the same request on a
  third scheduler of the same configuration that never migrates it.
* **ring**: ``segments`` segments of ``segment_bytes`` through a
  ``MigrationRing(slot_bytes=segment_bytes, slots=4)``, staged by the
  sender and read in place through the consumer's own mapping; one-way
  GB/s (each byte counted once, as the reference counts it).

    python -m mpistragglers_jl_tpu_torch.bench.disagg [--device cpu]

On the card the model is ``serving_bench.py``'s (``MODEL``) in bf16
with an int8 paged cache of 64-token pages and 8 slots, 8 requests of
960 tokens (16 pages each, a full window); ``--device cpu`` runs a
tiny model instead. Prints one JSON line, host wall clock, unrounded.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import numpy as np
import torch

from .._device import resolve_device
from ..models.disagg import (
    DecodeReplica,
    MigrationPlanner,
    MigrationRing,
    MigrationRingReader,
    MigrationTicket,
    PrefillWorker,
    ticket_from_frames,
    ticket_to_frames,
)
from ..models.serving import ServingScheduler
from ..models.transformer import TransformerConfig, init_params
from .serving_profile import MODEL

ROUTES = ("in_process", "frames")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def handoff(params, cfg, device, prompts, *, max_new: int, slots: int = 8,
            n_inner: int = 8, page_tokens: int = 64,
            prompt_chunk: int = 256, max_prompt: int = 1024) -> dict:
    """Migrate every request of ``prompts`` at its first token,
    alternating the routes, and hold each stream to the same request
    never migrated. Returns the handoff times and payloads by route."""
    dev = resolve_device(device)
    kw = dict(slots=slots, n_inner=n_inner, page_tokens=page_tokens,
              prompt_chunk=prompt_chunk, max_prompt=max_prompt,
              quantize_kv=True, device=dev)
    planner = MigrationPlanner()
    pw = PrefillWorker(ServingScheduler(params, cfg, **kw), planner=planner)
    dr = DecodeReplica(ServingScheduler(params, cfg, **kw), planner=planner)
    control = ServingScheduler(params, cfg, **kw)
    want = [control.submit(p, max_new=max_new) for p in prompts]
    control.run()
    row_bytes = pw.sched._page_row_bytes()
    # one slot per ticket segment: the prompt, the key, and per layer
    # four leaves of W rows
    seg_bytes = pw.sched.W * max(a.nbytes // a.shape[0]
                                 for cl in pw.sched._caches
                                 for a in cl.values())
    ring = MigrationRing(slot_bytes=max(seg_bytes, 4 * max_prompt),
                         slots=2 + 4 * cfg.n_layers)
    reader = MigrationRingReader(ring)
    reqs = [pw.submit(p, max_new=max_new) for p in prompts]
    moved: set[int] = set()
    out = {r: {"ms": [], "payload_bytes": [], "pages": []} for r in ROUTES}
    while any(r.id not in moved and not r.finished for r in reqs):
        pw.step()
        for r in pw.ready():
            if r.id in moved:
                continue
            route = ROUTES[len(moved) % 2]
            moved.add(r.id)
            nbytes = pw.migration_nbytes(r)
            _sync(dev)
            t0 = time.perf_counter()
            if route == "in_process":
                ticket = pw.migrate_out(r)
                dr.adopt(ticket)
            else:
                ticket = MigrationTicket(pw.sched.export_page_state(r))
                meta = ticket_to_frames(ticket, ring)
                dr.adopt(ticket_from_frames(meta, ticket.frames, reader),
                         request=r)
                ticket.release()
            _sync(dev)
            rec = out[route]
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["payload_bytes"].append(ticket.nbytes)
            rec["pages"].append(ticket.pages)
            if nbytes != ticket.nbytes or ticket.nbytes != (
                    ticket.pages * row_bytes):
                raise AssertionError(
                    f"payload {ticket.nbytes} bytes, migration_nbytes "
                    f"{nbytes}, pages x page bytes "
                    f"{ticket.pages * row_bytes}")
    if len(moved) != len(reqs):
        raise AssertionError(
            f"{len(reqs) - len(moved)} requests retired before their "
            "migration: raise max_new past n_inner")
    dr.run()
    gc.collect()
    same = sum(r.tokens == w.tokens for r, w in zip(reqs, want))
    if same != len(reqs):
        raise AssertionError(
            f"{len(reqs) - same} migrated streams differ from the "
            "never-migrated ones")
    for sched in (pw.sched, dr.sched, control):
        sched.pool.check()
        if sched.pool.used:
            raise AssertionError(f"{sched.pool.used} pages left in a pool")
    if ring.pinned or planner.in_flight:
        raise AssertionError(
            f"{ring.pinned} ring slots pinned, {planner.in_flight} "
            "migrations in flight after the run")
    reader.close()
    ring.close()
    return {"routes": out, "page_bytes": row_bytes,
            "streams_equal": same, "share_hits_destination":
            dr.pool.share_hits, "ring_stalls": ring.stalls}


def ring_rate(*, segments: int = 16, segment_bytes: int = 4 << 20,
              seed: int = 16) -> dict:
    """One-way GB/s of ``segments`` segments through a four-slot
    migration ring, read back through the consumer's own mapping."""
    ring = MigrationRing(slot_bytes=segment_bytes, slots=4)
    if ring.region is None:  # pragma: no cover - no memfd
        return {"skipped": "memfd_create unavailable"}
    reader = MigrationRingReader(ring)
    seg = np.random.default_rng(seed).integers(0, 255, size=segment_bytes,
                                               dtype=np.uint8)
    moved = 0
    t0 = time.perf_counter()
    for _ in range(segments):
        frames = ring.send_segment(seg)
        got = reader.read_segment(frames)
        moved += seg.nbytes
        if got[0] != seg[0] or got[-1] != seg[-1]:
            raise AssertionError("ring payload corrupted")
        ring.release_frames(frames)
        # the view's finalizer frees its slot on the refcount edge
        del got
    wall = time.perf_counter() - t0
    gc.collect()
    rep = {"segments": segments, "segment_bytes": segment_bytes,
           "seconds": wall, "migrate_gbs": moved / wall / 1e9,
           "ring_stalls": ring.stalls}
    reader.close()
    ring.close()
    return rep


def bench_disagg_live_rung(device=None, *, params=None, cfg=None,
                           n_requests: int = 8, prompt_len: int = 960,
                           max_new: int = 24, seed: int = 16) -> dict:
    """Both halves at one configuration: ``MODEL`` in bf16 on the card
    unless ``cfg``/``params`` are given."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = TransformerConfig(**MODEL, dtype=torch.bfloat16)
    if params is None:
        params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, prompt_len)
               for _ in range(n_requests)]
    kw = {}
    if dev.type != "cuda":
        kw = dict(page_tokens=4, prompt_chunk=8, max_prompt=64)
    return {"handoff": handoff(params, cfg, dev, prompts, max_new=max_new,
                               **kw),
            "ring": ring_rate(seed=seed)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu runs a tiny model (default: the card)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        out = bench_disagg_live_rung(dev)
    else:
        cfg = TransformerConfig(vocab=61, d_model=64, n_heads=8,
                                n_kv_heads=2, n_layers=2, d_ff=128,
                                attn_window=24)
        out = bench_disagg_live_rung(
            dev, cfg=cfg, params=init_params(cfg, seed=11, device=dev),
            n_requests=4, prompt_len=9, max_new=12)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
