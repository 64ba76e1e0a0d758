"""Spill/fetch planner: page movements batched and priced in bytes.

Counterpart of ``mpistragglers_jl_tpu/cache/planner.py``, copied
and not imported (pure arithmetic).

The redistribution frame (arxiv 2112.01075): moving KV pages between
tiers is a layout problem, not an RPC problem — what matters is HOW
MANY BYTES cross each link, in how many batches, because every batch
pays a fixed per-message cost on top of the link's byte rate. The
planner turns a list of page movements into batches bounded by
``batch_bytes`` per (src, dst) link and prices each batch with the
affine model the PERF docs carry for every other transport in this
repo::

    seconds = alpha + nbytes / (gbs * 1e9)

``spill_gbs`` prices device→host traffic (a spill is a device gather
plus one host memcpy into the store region), ``fetch_gbs`` prices
host→device and peer→peer traffic (a dram fetch is a host memcpy plus
a device scatter; a peer fetch adds the migration-ring hop, which is
zero-copy under memfd and hence rides the same byte rate). The sim
plane charges these SAME prices to its virtual clock, which is what
makes spill-capacity sweeps comparable to live measurements.

Everything is pure arithmetic on the arguments — no clocks, no state
beyond lifetime counters — so planning is replay-pure by construction.
"""

from __future__ import annotations

__all__ = ["PageMove", "SpillFetchPlanner"]

#: Movement kinds and the rate each is priced with.
_KINDS = ("spill", "fetch_dram", "fetch_peer")


class PageMove:
    """One page movement: ``digest`` goes ``src`` -> ``dst`` (replica
    or store names) carrying ``nbytes``, of ``kind`` in :data:`_KINDS`."""

    __slots__ = ("digest", "src", "dst", "nbytes", "kind")

    def __init__(self, digest: bytes, *, src: str, dst: str,
                 nbytes: int, kind: str):
        if kind not in _KINDS:
            raise ValueError(
                f"unknown movement kind {kind!r}; choose one of {_KINDS}"
            )
        if nbytes < 1:
            raise ValueError(f"movement must carry bytes, got {nbytes}")
        self.digest = digest
        self.src = src
        self.dst = dst
        self.nbytes = int(nbytes)
        self.kind = kind

    def __repr__(self) -> str:
        return (
            f"PageMove({self.digest.hex()[:12]}, {self.src}->{self.dst},"
            f" {self.nbytes}B, {self.kind})"
        )


class SpillFetchPlanner:
    """Batches page movements per link and prices them (module
    docstring). ``batch_bytes`` bounds one batch — a bound makes the
    per-batch ``alpha`` honest (an unbounded batch would amortize the
    fixed cost to zero and the sweep would always choose infinite
    batches) and bounds the ring slot a live batch must fit in."""

    __slots__ = ("spill_gbs", "fetch_gbs", "alpha_s", "batch_bytes",
                 "planned_moves", "planned_bytes", "planned_batches")

    def __init__(self, *, spill_gbs: float = 8.0,
                 fetch_gbs: float = 8.0, alpha_s: float = 20e-6,
                 batch_bytes: int = 1 << 20):
        if not spill_gbs > 0 or not fetch_gbs > 0:
            raise ValueError(
                f"byte rates must be > 0 GB/s, got "
                f"({spill_gbs}, {fetch_gbs})"
            )
        if alpha_s < 0:
            raise ValueError(f"alpha_s must be >= 0, got {alpha_s}")
        if batch_bytes < 1:
            raise ValueError(
                f"batch_bytes must be >= 1, got {batch_bytes}"
            )
        self.spill_gbs = float(spill_gbs)
        self.fetch_gbs = float(fetch_gbs)
        self.alpha_s = float(alpha_s)
        self.batch_bytes = int(batch_bytes)
        self.planned_moves = 0
        self.planned_bytes = 0
        self.planned_batches = 0

    def rate_gbs(self, kind: str) -> float:
        if kind not in _KINDS:
            raise ValueError(
                f"unknown movement kind {kind!r}; choose one of {_KINDS}"
            )
        return self.spill_gbs if kind == "spill" else self.fetch_gbs

    def price(self, nbytes: int, kind: str) -> float:
        """Seconds one batch of ``nbytes`` takes on the ``kind`` link:
        ``alpha_s + nbytes / (rate * 1e9)``."""
        return self.alpha_s + int(nbytes) / (self.rate_gbs(kind) * 1e9)

    def plan(self, moves) -> list[dict]:
        """Group ``moves`` (:class:`PageMove` list) by (src, dst, kind)
        — preserving first-appearance link order and per-link move
        order, the determinism contract — split each link's run at
        ``batch_bytes``, and price every batch. Returns a list of
        ``{"src", "dst", "kind", "moves", "nbytes", "seconds"}``
        batches; ``sum(b["seconds"])`` is the serialized cost, the
        upper bound a sweep charges (links can overlap in reality —
        that is upside, never modeled as guaranteed)."""
        runs: dict[tuple[str, str, str], list[PageMove]] = {}
        for m in moves:
            runs.setdefault((m.src, m.dst, m.kind), []).append(m)
        out: list[dict] = []
        for (src, dst, kind), ms in runs.items():
            batch: list[PageMove] = []
            size = 0
            for m in ms:
                if batch and size + m.nbytes > self.batch_bytes:
                    out.append(self._batch(src, dst, kind, batch, size))
                    batch, size = [], 0
                batch.append(m)
                size += m.nbytes
            if batch:
                out.append(self._batch(src, dst, kind, batch, size))
        return out

    def _batch(self, src: str, dst: str, kind: str,
               moves: list, nbytes: int) -> dict:
        self.planned_moves += len(moves)
        self.planned_bytes += nbytes
        self.planned_batches += 1
        return {
            "src": src, "dst": dst, "kind": kind, "moves": list(moves),
            "nbytes": nbytes, "seconds": self.price(nbytes, kind),
        }

    def stats(self) -> dict:
        return {
            "moves": self.planned_moves,
            "bytes": self.planned_bytes,
            "batches": self.planned_batches,
            "spill_gbs": self.spill_gbs,
            "fetch_gbs": self.fetch_gbs,
            "alpha_s": self.alpha_s,
            "batch_bytes": self.batch_bytes,
        }

    def __repr__(self) -> str:
        return (
            f"SpillFetchPlanner(spill={self.spill_gbs}GB/s, "
            f"fetch={self.fetch_gbs}GB/s, batch={self.batch_bytes}B)"
        )
