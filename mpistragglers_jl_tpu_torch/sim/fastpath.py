"""Vectorized day driver: ``run_router_day`` semantics off the
interpreted event loop, bit-identical digests.

A copy of ``mpistragglers_jl_tpu/sim/fastpath.py``, not an import of it
(the port never imports the JAX package). Stdlib and numpy, no torch and
no OS clock: its digests equal the scalar driver's and the JAX
package's.

The scalar driver (:func:`~.workload.run_router_day`) advances the
clock to every replica tick and re-runs the router's per-slot python
loop each time — ~30 µs per request on a million-request day, which
the fleet controller's *online* sweeps (``fleet/controller.py``, a
decision budget of candidate-days) cannot afford. This module replays
the SAME day as a batched discrete-event program over struct-of-arrays
state:

* **arrival cohorts** — :class:`ArrivalBatch` carries a seeded day as
  numpy columns (:func:`poisson_arrival_batch` /
  :func:`diurnal_arrival_batch` twin the generators draw-for-draw:
  same rng streams, same chunking, same one-coin class/tenant fold),
  so a million arrivals never materialize a million objects;
* **tick streams** — a busy :class:`~.workload.SimReplica` fires a
  *chain* of ticks whose times are a prefix-sum of per-index ``tick_s``
  draws; the engine materializes whole chains with ``np.cumsum``
  (sequential accumulation — bit-equal to the scalar ``t += dt`` walk)
  and touches only the *eventful* ticks: admissions, retirements, and
  chain boundaries. Prefill/decode progress is analytic: a request
  admitted at tick ``k`` with ``c`` chunks emits its first token at
  ``k + c - 1`` and retires ``ceil((max_new - 1)/n_inner)`` ticks
  later — the intermediate ticks change nothing and are never
  visited;
* **DRR rotation windows** — qos days drive the REAL
  :class:`~..qos.DeficitScheduler` instances on the replicas (integer
  work handles instead of request objects), so admission order is the
  deficit scheduler's own arithmetic, not a reimplementation;
* **retry coins** — resubmission dues come from the REAL
  :class:`~.workload.RetryPolicy` (same seeded jitter coin), scheduled
  on the engine's event heap.

**The digest witness is the spec.** The fast path must reproduce the
scalar loop's :meth:`~.workload.WorkloadReport.digest` bit-identically
on every seeded day it accepts — any divergence is a fast-path bug by
definition (tests/test_torch_sim_fastpath.py pins plain, prefix, QoS,
hedge, and retry-storm days). The witness arrays themselves are assembled by
:meth:`~.workload.WorkloadReport.from_arrays` inside ``workload.py``
— one writer for both paths.

**Scalar fallback boundaries.** Genuinely event-driven days fall back
to the scalar loop (the report says so in ``report.fastpath``):
fleet controllers (FleetResize / CoordinatorKill — the topology
mutates mid-day), control-plane event streams and chaos episodes
(partitions, kill/recover ``clock.call_at`` injections), two-tier
routing and ``chunk_s`` prefill pricing (tick *durations* become
state-dependent), custom health probes, observability hooks, and
non-``lognormal_ticks`` tick callables (an arbitrary stateful callable
is only correct on the scalar call sequence). The controller's sweep
entry points (``sim/tune.py``) route here with ``fast="auto"`` —
supported days vectorize, the rest keep their recorded digests via
the scalar path.

Known accepted divergence (shared with the scalar path's own docs):
the scalar loop fires events within ``1e-12`` of each other in one
step; the engine uses exact times. Seeded random days never produce
such collisions across distinct event sources — the parity suite is
the empirical witness.

sim purity (tests/test_torch_imports.py): this module never reads the OS
clock — wall measurement comes from an injected ``timer=``.
"""

from __future__ import annotations

import heapq
import math
from bisect import bisect_right
from collections import deque
from typing import Callable, Iterable

import numpy as np

from .clock import VirtualClock
from .workload import (
    _CHUNK,
    _TENANT_STRIDE,
    Arrival,
    RetryPolicy,
    SimPrompt,
    SimReplica,
    WorkloadReport,
    lognormal_ticks,
    run_router_day,
)

__all__ = [
    "ArrivalBatch",
    "poisson_arrival_batch",
    "diurnal_arrival_batch",
    "fastpath_supported",
    "run_router_day_fast",
]

_INF = math.inf
_BIG = 1 << 60

# outcome codes for the struct-of-arrays request table
_INFLIGHT, _OK, _HEDGED, _HEDGE_WON, _SHED = 0, 1, 2, 3, 4
_OUT_NAMES = {_OK: "ok", _HEDGED: "hedged", _HEDGE_WON: "hedge_won",
              _SHED: "shed"}
_SHED_NAMES = {1: "budget", 2: "overload", 3: "overload_hard"}
_SHED_CODES = {v: k for k, v in _SHED_NAMES.items()}


# -- arrival cohorts ------------------------------------------------------


class ArrivalBatch:
    """A whole arrival day as numpy columns: times, prompt lengths,
    prefix group/length (``-1``/``0`` = unique prompt), ``max_new``,
    and tenant codes into ``tenant_names`` (``-1`` = untenanted).
    Iterating yields :class:`~.workload.Arrival` objects equal
    field-for-field to the generator stream it twins, so one batch
    can drive BOTH execution paths of the same day (the parity
    suite's harness, and the scalar fallback's input)."""

    __slots__ = ("t", "plen", "prefix", "prefix_len", "max_new",
                 "tenant", "tenant_names")

    def __init__(self, t, plen, prefix, prefix_len, max_new, tenant,
                 tenant_names):
        self.t = np.asarray(t, np.float64)
        self.plen = np.asarray(plen, np.int64)
        self.prefix = np.asarray(prefix, np.int64)
        self.prefix_len = np.asarray(prefix_len, np.int64)
        self.max_new = np.asarray(max_new, np.int64)
        self.tenant = np.asarray(tenant, np.int64)
        self.tenant_names = list(tenant_names)
        n = self.t.size
        for col in (self.plen, self.prefix, self.prefix_len,
                    self.max_new, self.tenant):
            if col.size != n:
                raise ValueError("ArrivalBatch columns must be equal "
                                 f"length (got {col.size} vs {n})")

    def __len__(self) -> int:
        return int(self.t.size)

    def __iter__(self):
        names = self.tenant_names
        for t, pl, g, gl, mn, tc in zip(
            self.t.tolist(), self.plen.tolist(), self.prefix.tolist(),
            self.prefix_len.tolist(), self.max_new.tolist(),
            self.tenant.tolist(),
        ):
            p = (SimPrompt(pl) if g < 0
                 else SimPrompt(pl, prefix=g, prefix_len=gl))
            yield Arrival(t, p, mn,
                          tenant=None if tc < 0 else names[tc])

    @classmethod
    def from_arrivals(cls, arrivals: Iterable[Arrival]) -> "ArrivalBatch":
        """Ingest any :class:`~.workload.Arrival` iterable (a recorded
        trace, a hand-built list) into columns. Prefix groups must be
        ints (the sim convention); int prompts are bare lengths."""
        ts, pls, gs, gls, mns, tcs = [], [], [], [], [], []
        names: list = []
        codes: dict = {}
        for a in arrivals:
            p = a.prompt
            if isinstance(p, (int, np.integer)):
                pl, g, gl = int(p), -1, 0
            else:
                pl = int(p.length)
                g = p.prefix
                if g is None:
                    g, gl = -1, 0
                else:
                    g, gl = int(g), int(p.prefix_len)
            ts.append(a.t)
            pls.append(pl)
            gs.append(g)
            gls.append(gl)
            mns.append(int(a.max_new))
            tn = a.tenant
            if tn is None:
                tcs.append(-1)
            else:
                c = codes.get(tn)
                if c is None:
                    c = codes[tn] = len(names)
                    names.append(tn)
                tcs.append(c)
        return cls(ts, pls, gs, gls, mns, tcs, names)


def _classify(coins: np.ndarray, prompt_len: int, prefix_share: float,
              prefix_len: int, n_prefix_groups: int, max_new: int,
              long_share: float, long_prompt_len, long_max_new,
              tenants):
    """The one-coin class/tenant fold of ``_default_prompt_fn`` /
    ``_tenant_fn``, vectorized with the exact scalar float ops (same
    division/compare order, truncating casts, ``% 1.0`` as fmod) —
    bit-identical class and tenant per coin."""
    n = coins.size
    share = float(prefix_share)
    lshare = float(long_share)
    if not (0.0 <= share <= 1.0):
        raise ValueError(f"prefix_share must be in [0, 1], got {share}")
    if not (0.0 <= lshare <= 1.0) or share + lshare > 1.0:
        raise ValueError(
            f"long_share must be in [0, 1] with prefix_share + "
            f"long_share <= 1, got {long_share} (+{share})"
        )
    if share > 0.0 and not (0 < prefix_len <= prompt_len):
        raise ValueError(
            "prefix_share > 0 needs 0 < prefix_len <= prompt_len"
        )
    if lshare > 0.0 and not (long_prompt_len or 0) > 0:
        raise ValueError("long_share > 0 needs long_prompt_len > 0")
    long_mn = int(long_max_new if long_max_new is not None else max_new)
    plen = np.full(n, int(prompt_len), np.int64)
    prefix = np.full(n, -1, np.int64)
    pfxlen = np.zeros(n, np.int64)
    mn = np.full(n, int(max_new), np.int64)
    if share > 0.0:
        is_pfx = coins < share
        g = np.minimum(
            (coins / share * n_prefix_groups).astype(np.int64),
            n_prefix_groups - 1,
        )
        prefix[is_pfx] = g[is_pfx]
        pfxlen[is_pfx] = int(prefix_len)
    else:
        is_pfx = np.zeros(n, bool)
    if lshare > 0.0:
        is_long = (~is_pfx) & (coins >= 1.0 - lshare)
        plen[is_long] = int(long_prompt_len)
        mn[is_long] = long_mn
    if tenants is None:
        tcode = np.full(n, -1, np.int64)
        names: list = []
    else:
        names = list(tenants)
        shares = [float(tenants[nm]) for nm in names]
        if not names or any(s <= 0 for s in shares) or abs(
                sum(shares) - 1.0) > 1e-9:
            raise ValueError(
                f"tenant shares must be > 0 and sum to 1, got "
                f"{dict(tenants)}"
            )
        cum, acc = [], 0.0
        for s in shares:
            acc += s
            cum.append(acc)
        v = np.remainder(coins * _TENANT_STRIDE, 1.0)
        tcode = np.minimum(
            np.searchsorted(np.asarray(cum), v, side="right"),
            len(names) - 1,
        ).astype(np.int64)
    return plen, prefix, pfxlen, mn, tcode, names


def poisson_arrival_batch(
    rate: float, *, n: int, seed: int = 0, start: float = 0.0,
    prompt_len: int = 128, max_new: int = 32,
    prefix_share: float = 0.0, prefix_len: int = 0,
    n_prefix_groups: int = 1, long_share: float = 0.0,
    long_prompt_len: int | None = None,
    long_max_new: int | None = None, tenants: dict | None = None,
) -> ArrivalBatch:
    """:func:`~.workload.poisson_arrivals` as columns: same generator
    seed, same ``_CHUNK``-sized draw order, same carried chunk tail —
    the stream is bit-identical arrival for arrival."""
    if rate <= 0 or n < 1:
        raise ValueError("need rate > 0 and n >= 1")
    rng = np.random.default_rng((0x9E3779B9, int(seed)))
    t = float(start)
    left = int(n)
    ts_parts, coin_parts = [], []
    while left:
        m = min(_CHUNK, left)
        ts = t + np.cumsum(rng.exponential(1.0 / rate, size=m))
        coins = rng.random(size=m)
        t = float(ts[-1])
        ts_parts.append(ts)
        coin_parts.append(coins)
        left -= m
    ts = np.concatenate(ts_parts)
    coins = np.concatenate(coin_parts)
    plen, prefix, pfxlen, mn, tcode, names = _classify(
        coins, prompt_len, prefix_share, prefix_len, n_prefix_groups,
        max_new, long_share, long_prompt_len, long_max_new, tenants)
    return ArrivalBatch(ts, plen, prefix, pfxlen, mn, tcode, names)


def diurnal_arrival_batch(
    mean_rate: float, *, n: int, period: float = 86_400.0,
    amplitude: float = 0.8, seed: int = 0, start: float = 0.0,
    prompt_len: int = 128, max_new: int = 32,
    prefix_share: float = 0.0, prefix_len: int = 0,
    n_prefix_groups: int = 1, long_share: float = 0.0,
    long_prompt_len: int | None = None,
    long_max_new: int | None = None, tenants: dict | None = None,
) -> ArrivalBatch:
    """:func:`~.workload.diurnal_arrivals` as columns — the same Lewis
    thinning, chunk for chunk (full-``_CHUNK`` candidate draws, the
    carry taken BEFORE truncating to ``n`` survivors)."""
    if mean_rate <= 0 or n < 1:
        raise ValueError("need mean_rate > 0 and n >= 1")
    if not (0.0 <= amplitude < 1.0):
        raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
    rng = np.random.default_rng((0x51ED2701, int(seed)))
    peak = mean_rate * (1.0 + amplitude)
    w = 2.0 * math.pi / period
    t = float(start)
    out = 0
    n = int(n)
    ts_parts, coin_parts = [], []
    while out < n:
        ts = t + np.cumsum(rng.exponential(1.0 / peak, size=_CHUNK))
        accept = rng.random(size=_CHUNK)
        coins = rng.random(size=_CHUNK)
        t = float(ts[-1])
        rates = mean_rate * (
            1.0 + amplitude * np.sin(w * ts - math.pi / 2.0)
        )
        keep = accept * peak < rates
        kts, kcoins = ts[keep], coins[keep]
        take = min(kts.size, n - out)
        ts_parts.append(kts[:take])
        coin_parts.append(kcoins[:take])
        out += take
    ts = np.concatenate(ts_parts)
    coins = np.concatenate(coin_parts)
    plen, prefix, pfxlen, mn, tcode, names = _classify(
        coins, prompt_len, prefix_share, prefix_len, n_prefix_groups,
        max_new, long_share, long_prompt_len, long_max_new, tenants)
    return ArrivalBatch(ts, plen, prefix, pfxlen, mn, tcode, names)


# -- the support gate -----------------------------------------------------

_FAST_POLICIES = ("round_robin", "least_loaded", "prefix_affinity",
                  "hedge_p99")


def fastpath_supported(router, *, controller=None, events=(),
                       retry=None, series=None,
                       slo=None) -> tuple[bool, str]:
    """Can this day run on the vectorized engine? Returns
    ``(ok, reason)`` — the reason names the scalar-fallback boundary
    (module docstring) and lands in ``report.fastpath``."""
    if controller is not None:
        return False, "controller attached (elastic day)"
    if events:
        return False, "control-plane events in stream"
    if series is not None or slo is not None:
        # window rollover needs the scalar driver's per-step clock
        # walk; the vectorized engine never visits intermediate times
        return False, "series/slo attached"
    clock = router.clock
    if clock is None:
        return False, "no VirtualClock (live router)"
    if not isinstance(clock, VirtualClock):
        return False, "custom clock"
    if (clock._heap or clock._sleepers or clock._threads
            or clock._pending):
        return False, "clock has scheduled injections (chaos day)"
    if getattr(router, "_obs", None) is not None:
        return False, "router observability attached"
    if getattr(router, "_trace", None) is not None:
        return False, "tracing attached"
    policy = getattr(router, "policy", None)
    if policy not in _FAST_POLICIES:
        return False, f"policy {policy!r} (two_tier is event-driven)"
    if router._health_fn is not None:
        return False, "custom health probe"
    if (router._migrating or router._partitioned or router._orphans
            or router._down_manual):
        return False, "router mid-episode (partition/migration)"
    if router.n_submitted or router.n_completed:
        return False, "router already carries traffic"
    if len(router._hedge):
        return False, "hedges already armed"
    if not router._routable:
        return False, "no routable replicas"
    for i, r in enumerate(router.replicas):
        if type(r) is not SimReplica:
            return False, "non-SimReplica replica"
        if r.chunk_s != 0.0:
            return False, "chunk_s prefill pricing (two-tier timing)"
        if getattr(r, "cache", None) is not None:
            return False, "fleet cache attached (spill/fetch pricing)"
        if (r.tick_count or r.next_tick_at is not None or r.pending
                or r.active or r._resident or r.busy_s):
            return False, "replica already carries state"
        if router._up[i] != r.alive:
            return False, "router health view out of date"
        spec = getattr(r, "_tick_spec", None)
        if callable(spec) and not isinstance(spec, lognormal_ticks):
            return False, "custom tick_s callable"
        drr = r._drr
        if drr is not None and (drr._order or drr._n
                                or drr._max_cost != 1.0):
            return False, "deficit scheduler already carries state"
    for b in router._buckets.values():
        if b is not None and b._last is not None:
            return False, "token bucket already charged"
    return True, "vectorized"


# -- per-replica engine state ---------------------------------------------


class _H(int):
    """Deficit-scheduler work handle: an int with object identity, so
    the REAL ``DeficitScheduler.remove`` (identity scan, like the
    scalar path's request objects) works on encoded work items."""

    __slots__ = ()


class _Rep:
    """Struct-of-state twin of one SimReplica: FIFO/DRR backlog of
    work items (``ridx*2 + leg``), slot generations for O(log n)
    cancel invalidation, a retirement heap keyed by tick index, and
    the current tick *chain* — times materialized by block cumsum."""

    __slots__ = (
        "i", "S", "n_inner", "C", "max_queue", "drr", "tenant_of",
        "handles", "fifo", "q_len", "resident", "slot_gen", "free",
        "retire", "load", "active", "idle", "cur", "base", "times",
        "dts", "wake", "busy_parts", "last_tick_t", "tick_fn",
        "tick_const", "next_ev", "next_k", "n_retired", "n_cancelled",
        "n_shared_admits",
    )

    def __init__(self, i: int, r: SimReplica):
        self.i = i
        self.S = r.S
        self.n_inner = r.n_inner
        self.C = r.C
        self.max_queue = r.max_queue
        self.drr = r._drr  # the REAL deficit scheduler (fresh, gated)
        self.handles: dict[int, _H] = {}
        self.fifo: deque[int] = deque()
        self.q_len = 0
        self.resident: dict = {}
        self.slot_gen = [0] * r.S
        self.free = list(range(r.S))  # already a heap (ascending)
        self.retire: list = []  # (tick, slot, gen, item)
        self.load = 0
        self.active = 0
        self.idle = True
        self.cur = 0  # fired-tick count == scalar tick_count
        self.base = 0
        self.times: list[float] = []
        self.dts: list[float] = []
        self.wake: int | None = None
        self.busy_parts: list[list] = []
        self.last_tick_t: float | None = None
        spec = r._tick_spec
        if callable(spec):
            if spec.sigma == 0.0:
                self.tick_fn, self.tick_const = None, spec.base
            else:
                self.tick_fn, self.tick_const = spec, 0.0
        else:
            self.tick_fn, self.tick_const = None, float(spec)
        self.next_ev = _INF
        self.next_k = 0
        self.n_retired = 0
        self.n_cancelled = 0
        self.n_shared_admits = 0

    # time materialization: times[j] is the time of absolute tick
    # base+j; dts[j] = tick_s(base+j), so times[j+1] = times[j] +
    # dts[j] — the block cumsum threads the exact running value
    # through, bit-equal to the scalar t += dt walk
    def ensure(self, j: int) -> None:
        times, dts = self.times, self.dts
        need = j - (len(times) - 1)
        while need > 0:
            m = need if need > 512 else 512
            b = self.base + len(dts)
            fn = self.tick_fn
            if fn is None:
                blk = [self.tick_const] * m
            else:
                fn(b + m - 1)  # extend the shared seeded cache
                blk = fn._cache[b:b + m]
            arr = np.empty(m + 1)
            arr[0] = times[-1]
            arr[1:] = blk
            np.cumsum(arr, out=arr)
            times.extend(arr[1:].tolist())
            dts.extend(blk)
            need = j - (len(times) - 1)

    def tick_after(self, t: float) -> int:
        """First chain tick strictly after time ``t`` (a tick exactly
        at ``t`` fired before this moment — driver ordering)."""
        times = self.times
        while times[-1] <= t:
            self.ensure(len(times) + 511)
        j = bisect_right(times, t)
        return self.base + (j if j > 0 else 1)

    def refresh(self) -> None:
        rh = self.retire
        sg = self.slot_gen
        while rh and sg[rh[0][1]] != rh[0][2]:
            heapq.heappop(rh)
        k = self.wake
        if rh and (k is None or rh[0][0] < k):
            k = rh[0][0]
        if k is None:
            self.next_ev = _INF
        else:
            self.next_k = k
            j = k - self.base
            self.ensure(j)
            self.next_ev = self.times[j]


# -- the engine -----------------------------------------------------------


class _Engine:
    def __init__(self, router, retry: RetryPolicy | None):
        self.router = router
        self.retry = retry
        self.clock = router.clock
        self.reps = [_Rep(i, r) for i, r in enumerate(router.replicas)]
        self.routable = list(router._routable)
        self.n_all = len(router.replicas)
        self.policy = router.policy
        self.rrc = router._rr
        self.hedging = router.policy == "hedge_p99"
        self.slo = getattr(router, "ttft_slo", None)
        self.shed_depth = router.shed_depth
        self.shed_depth_hard = router.shed_depth_hard
        self.depth = 0  # queued over the routable fleet (= queue_depth)
        # qos door state: per-tenant-code contract facts, the REAL
        # token buckets (router._buckets — left exactly as a scalar
        # day would leave them), and hedge entitlement outstanding
        self.qos = router._qos
        self.buckets = router._buckets
        self.hedges_out: dict[str, int] = {}
        self.c_name: list = []
        self.c_shed: list = []
        self.c_hedges: list = []
        self.c_bucket: list = []
        # struct-of-arrays request table (python lists; np at the end)
        self.r_sub: list[float] = []
        self.r_adm: list[float] = []
        self.r_ft: list[float] = []
        self.r_done: list[float] = []
        self.r_out: list[int] = []
        self.r_shedc: list[int] = []
        self.r_tcode: list[int] = []
        self.r_plen: list[int] = []
        self.r_prefix: list[int] = []
        self.r_pfxlen: list[int] = []
        self.r_maxnew: list[int] = []
        self.r_rep0: list[int] = []
        self.r_hedged: list[bool] = []
        self.r_repfin: list[int] = []
        # hedge-leg books (hedge_p99 only)
        self.leg_admit: dict[int, float] = {}   # item -> admit time
        self.leg_ft: dict[int, float] = {}      # item -> scheduled ft
        self.leg_fin: set[int] = set()
        self.leg_slot: dict[int, tuple] = {}    # item -> (_Rep, slot)
        self.hedge_rep: dict[int, int] = {}     # ridx -> hedge replica
        self.winner: dict[int, int] = {}        # ridx -> winning item
        self.res_heap: list = []                # (ft_t, seq, ridx)
        self.res_seq = 0
        self.hheap: list = []                   # (deadline, seq, ridx)
        self.armed: set[int] = set()
        self.hseq = 0
        self.charged: set[int] = set()
        self.rheap: list = []                   # (due, idx, ridx, att)
        self.n_submitted = 0
        self.n_completed = 0
        self.n_shed = 0
        self.n_hedges = 0
        self.n_hedges_refused = 0
        self.n_over_budget = 0
        self.n_resubmits = 0
        self.last_t = self.clock.now()

    # -- tenant facts ---------------------------------------------------

    def bind_tenants(self, names: list) -> str | None:
        """Resolve per-code contract facts; a name outside the
        registry (or tenantless traffic on a qos router) is a scalar
        matter — return the fallback reason instead of guessing."""
        if self.qos is None:
            self.c_name = list(names)
            return None
        for nm in names:
            try:
                c = self.qos.get(nm)
            except KeyError:
                return f"unknown tenant {nm!r} (scalar raises by name)"
            self.c_name.append(nm)
            self.c_shed.append(c.sheddable)
            self.c_hedges.append(c.hedges)
            self.c_bucket.append(self.buckets.get(nm))
        return None

    # -- placement (the router's pick, replicated) ----------------------

    def _least_loaded(self, cands: list[int]) -> int:
        reps = self.reps
        best, bl = cands[0], None
        for i in cands:
            load = reps[i].load
            if bl is None or load < bl:
                best, bl = i, load
        return best

    def _pick(self, g: int, pl: int) -> int:
        if self.policy == "round_robin":
            n = self.n_all
            routable = self.routable
            for d in range(n):
                i = (self.rrc + d) % n
                if i in routable:
                    self.rrc = (i + 1) % n
                    return i
        if self.policy == "prefix_affinity":
            return self._bounded_affinity(g, pl, self.routable)
        return self._least_loaded(self.routable)

    def _bounded_affinity(self, g: int, pl: int,
                          cands: list[int]) -> int:
        reps = self.reps
        aff, aff_sc = None, 0
        for i in cands:
            r = reps[i]
            if g == -1 or r.resident.get(g, 0) < 1:
                sc = 0
            else:
                sc = -(-pl // r.C)
            if sc > aff_sc or (
                sc == aff_sc and sc > 0
                and reps[i].load < reps[aff].load
            ):
                aff, aff_sc = i, sc
        ll = self._least_loaded(cands)
        if aff is None or aff_sc == 0:
            return ll
        if reps[aff].load <= reps[ll].load + reps[aff].S:
            return aff
        return ll

    # -- replica work ---------------------------------------------------

    def _enqueue(self, rep: _Rep, it: int, ridx: int, t: float) -> None:
        if rep.max_queue is not None and rep.q_len >= rep.max_queue:
            raise RuntimeError(
                f"queue ceiling: {rep.q_len} requests already queued "
                f"at max_queue={rep.max_queue} — shed at the router "
                "(shed_depth=) instead of queueing unboundedly"
            )
        if rep.drr is not None:
            tc = self.r_tcode[ridx]
            if tc < 0:
                raise ValueError(
                    "qos SimReplica needs tenant= at submit: "
                    "admission order is per-contract (register a "
                    "catch-all TenantContract for untagged traffic)"
                )
            h = _H(it)
            rep.handles[it] = h
            rep.drr.enqueue(
                self.c_name[tc], h,
                float(self.r_plen[ridx] + self.r_maxnew[ridx]),
            )
        else:
            rep.fifo.append(it)
        rep.q_len += 1
        rep.load += 1
        self.depth += 1
        if rep.idle:
            # chain start: the scalar submit schedules the first tick
            # off the PRE-increment tick index
            rep.idle = False
            rep.base = rep.cur
            rep.times = [t]
            rep.dts = []
            rep.wake = rep.cur + 1
        elif rep.free:
            k = rep.tick_after(t)
            if rep.wake is None or k < rep.wake:
                rep.wake = k
        rep.refresh()

    def _release_residency(self, rep: _Rep, g: int) -> None:
        left = rep.resident.get(g, 0) - 1
        if left > 0:
            rep.resident[g] = left
        else:
            rep.resident.pop(g, None)

    def _complete(self, ridx: int, it: int, t: float) -> None:
        """Winning leg finished (hedge mode): stamp the completion the
        way ``_resolve_completions`` would at this step."""
        self.r_done[ridx] = t
        if self.r_hedged[ridx]:
            self.r_out[ridx] = (
                _HEDGE_WON if (it & 1) else _HEDGED
            )
        else:
            self.r_out[ridx] = _OK
        self.n_completed += 1

    def _tick(self, rep: _Rep, t: float) -> None:
        """Process one *eventful* tick at time ``t``: retirements and
        admissions interleaved in ascending slot order — the scalar
        step()'s single fused pass."""
        k = rep.next_k
        rep.cur = k
        rep.last_tick_t = t
        if rep.wake is not None and rep.wake <= k:
            rep.wake = None
        rh = rep.retire
        sg = rep.slot_gen
        ret: list = []
        while rh and rh[0][0] <= k:
            e = heapq.heappop(rh)
            if sg[e[1]] == e[2]:
                ret.append((e[1], e[3]))
        ret.sort()
        free = rep.free
        fifo = rep.fifo
        drr = rep.drr
        hedging = self.hedging
        newly: list[int] = []
        ri, nret = 0, len(ret)
        can_admit = True
        while True:
            rslot = ret[ri][0] if ri < nret else _BIG
            fslot = free[0] if (can_admit and free) else _BIG
            if rslot >= _BIG and fslot >= _BIG:
                break
            if rslot < fslot:
                s, it = ret[ri]
                ri += 1
                sg[s] += 1
                rep.active -= 1
                rep.load -= 1
                ridx = it >> 1
                g = self.r_prefix[ridx]
                if g != -1:
                    self._release_residency(rep, g)
                rep.n_retired += 1
                newly.append(s)
                if hedging:
                    self.leg_fin.add(it)
                    self.leg_slot.pop(it, None)
                    if self.winner.get(ridx) == it:
                        self._complete(ridx, it, t)
                else:
                    self.n_completed += 1
                continue
            # admission attempt at slot fslot
            if drr is not None:
                picked = drr.pick()
                if picked is None:
                    can_admit = False
                    continue
                it = int(picked[1])
                rep.handles.pop(it, None)
            else:
                if not fifo:
                    can_admit = False
                    continue
                it = fifo.popleft()
            s = heapq.heappop(free)
            rep.q_len -= 1
            self.depth -= 1
            ridx = it >> 1
            g = self.r_prefix[ridx]
            skip = 0
            if g != -1:
                if rep.resident.get(g, 0):
                    skip = self.r_pfxlen[ridx]
                    rep.n_shared_admits += 1
            chunks = -(-(self.r_plen[ridx] - skip) // rep.C)
            if chunks < 1:
                chunks = 1
            mn = self.r_maxnew[ridx]
            ftk = k + chunks - 1
            dk = (ftk if mn == 1
                  else ftk + -(-(mn - 1) // rep.n_inner))
            if dk == k:
                # chunks == 1 and max_new == 1: admitted, first token,
                # and retired in this very tick — residency is a net
                # no-op (scalar: +1 then _free's -1/pop), the slot
                # frees back for the NEXT tick, load drops by the
                # departed queue entry
                rep.n_retired += 1
                rep.load -= 1
                newly.append(s)
                if hedging:
                    self.leg_admit[it] = t
                    self.leg_ft[it] = t
                    self.leg_fin.add(it)
                    heapq.heappush(self.res_heap,
                                   (t, self.res_seq, ridx))
                    self.res_seq += 1
                    if self.winner.get(ridx) == it:
                        self._complete(ridx, it, t)
                else:
                    self.r_adm[ridx] = t
                    self.r_ft[ridx] = t
                    self.r_done[ridx] = t
                    self.r_out[ridx] = _OK
                    self.r_repfin[ridx] = rep.i
                    self.n_completed += 1
                continue
            if g != -1:
                rep.resident[g] = rep.resident.get(g, 0) + 1
            heapq.heappush(rh, (dk, s, sg[s], it))
            rep.active += 1
            rep.ensure(dk - rep.base)
            ft_t = rep.times[ftk - rep.base]
            dn_t = rep.times[dk - rep.base]
            if hedging:
                self.leg_admit[it] = t
                self.leg_ft[it] = ft_t
                self.leg_slot[it] = (rep, s)
                heapq.heappush(self.res_heap,
                               (ft_t, self.res_seq, ridx))
                self.res_seq += 1
            else:
                self.r_adm[ridx] = t
                self.r_ft[ridx] = ft_t
                self.r_done[ridx] = dn_t
                self.r_out[ridx] = _OK
                self.r_repfin[ridx] = rep.i
        for s in newly:
            heapq.heappush(free, s)
        # chain boundary: empty after the scan means THIS tick was the
        # terminating one (scalar: next_tick_at = None, no busy add)
        if rep.active == 0 and rep.q_len == 0:
            rep.wake = None
            rep.busy_parts.append(rep.dts[1:k - rep.base])
            rep.idle = True
            rep.times = []
            rep.dts = []
            rep.next_ev = _INF
            return
        if rep.q_len and free:
            rep.wake = k + 1
        rep.refresh()

    # -- hedge resolution (hedge_p99 only) ------------------------------

    def _resolve(self, ridx: int, t: float) -> None:
        if ridx in self.winner or self.r_out[ridx] == _SHED:
            return
        it0 = ridx * 2
        f0 = self.leg_ft.get(it0)
        hrep = self.hedge_rep.get(ridx)
        if f0 is not None and f0 <= t:
            win = it0
        else:
            win = it0 + 1
        self.winner[ridx] = win
        adm = self.leg_admit.get(it0)
        a1 = self.leg_admit.get(it0 + 1)
        if a1 is not None and (adm is None or a1 < adm):
            adm = a1
        self.r_adm[ridx] = adm
        self.r_ft[ridx] = t
        self.r_repfin[ridx] = (hrep if (win & 1) else
                               self.r_rep0[ridx])
        self.armed.discard(ridx)
        if ridx in self.charged:
            self.charged.discard(ridx)
            nm = self.c_name[self.r_tcode[ridx]]
            left = self.hedges_out.get(nm, 0) - 1
            if left > 0:
                self.hedges_out[nm] = left
            else:
                self.hedges_out.pop(nm, None)
        # cancel the losing leg (scalar: replicas[jj].cancel(loser) —
        # a no-op on a finished leg)
        lose = it0 + 1 if win == it0 else it0
        if (lose == it0 or hrep is not None) and lose not in self.leg_fin:
            lrep = self.reps[self.r_rep0[ridx] if lose == it0 else hrep]
            slot = self.leg_slot.pop(lose, None)
            if slot is not None:
                _, s = slot
                lrep.slot_gen[s] += 1
                lrep.active -= 1
                lrep.load -= 1
                g = self.r_prefix[ridx]
                if g != -1:
                    self._release_residency(lrep, g)
                lrep.n_cancelled += 1
                heapq.heappush(lrep.free, s)
                if lrep.q_len:
                    k = lrep.tick_after(t)
                    if lrep.wake is None or k < lrep.wake:
                        lrep.wake = k
                elif lrep.active == 0:
                    lrep.wake = lrep.tick_after(t)  # ghost/ending tick
                lrep.refresh()
            else:
                # still queued: withdraw it
                if lrep.drr is not None:
                    h = lrep.handles.pop(lose, None)
                    if h is not None and lrep.drr.remove(h):
                        lrep.q_len -= 1
                        lrep.load -= 1
                        self.depth -= 1
                        lrep.n_cancelled += 1
                else:
                    try:
                        lrep.fifo.remove(lose)
                    except ValueError:
                        pass
                    else:
                        lrep.q_len -= 1
                        lrep.load -= 1
                        self.depth -= 1
                        lrep.n_cancelled += 1
        if win in self.leg_fin:
            self._complete(ridx, win, t)

    def _fire_hedge(self, ridx: int, t: float) -> None:
        primary = self.r_rep0[ridx]
        cands = [i for i in self.routable if i != primary]
        if not cands:
            return  # nowhere to hedge to; the primary stands
        tc = self.r_tcode[ridx]
        if self.qos is not None and tc >= 0:
            ent = self.c_hedges[tc]
            if ent is not None:
                nm = self.c_name[tc]
                out = self.hedges_out.get(nm, 0)
                if out >= ent:
                    self.n_hedges_refused += 1
                    return
                self.hedges_out[nm] = out + 1
                self.charged.add(ridx)
        j = self._least_loaded(cands)
        self.hedge_rep[ridx] = j
        self.r_hedged[ridx] = True
        self._enqueue(self.reps[j], ridx * 2 + 1, ridx, t)
        self.n_hedges += 1

    # -- the entry door -------------------------------------------------

    def _shed(self, t: float, reason_code: int) -> None:
        self.r_adm.append(_INF)
        self.r_ft.append(_INF)
        self.r_done.append(t)
        self.r_out.append(_SHED)
        self.r_shedc[-1] = reason_code
        self.r_rep0.append(-1)
        self.r_hedged.append(False)
        self.r_repfin.append(-1)
        self.n_submitted += 1
        self.n_completed += 1
        self.n_shed += 1

    def _submit(self, t: float, plen: int, g: int, pl: int, mn: int,
                tc: int) -> int:
        """The router submit door, array-native. Returns the new ridx;
        the request is shed iff its outcome code says so."""
        ridx = len(self.r_sub)
        self.r_sub.append(t)
        self.r_tcode.append(tc)
        self.r_plen.append(plen)
        self.r_prefix.append(g)
        self.r_pfxlen.append(pl)
        self.r_maxnew.append(mn)
        self.r_shedc.append(0)
        if self.shed_depth is not None:
            depth = self.depth
            if depth >= self.shed_depth_hard:
                reason_code = _SHED_CODES["overload_hard"]
                self._shed(t, reason_code)
                return ridx
            if depth >= self.shed_depth and (
                self.qos is None or self.c_shed[tc]
            ):
                reason_code = _SHED_CODES["overload"]
                self._shed(t, reason_code)
                return ridx
        if self.qos is not None:
            b = self.c_bucket[tc]
            if b is not None and not b.take(plen + mn, t):
                if self.c_shed[tc]:
                    reason_code = _SHED_CODES["budget"]
                    self._shed(t, reason_code)
                    return ridx
                self.n_over_budget += 1
        i = self._pick(g, pl)
        self.r_adm.append(_INF)
        self.r_ft.append(_INF)
        self.r_done.append(_INF)
        self.r_out.append(_INFLIGHT)
        self.r_rep0.append(i)
        self.r_hedged.append(False)
        self.r_repfin.append(-1)
        self._enqueue(self.reps[i], ridx * 2, ridx, t)
        if self.hedging:
            heapq.heappush(self.hheap,
                           (t + self.slo, self.hseq, ridx))
            self.hseq += 1
            self.armed.add(ridx)
        self.n_submitted += 1
        return ridx

    # -- the drive loop -------------------------------------------------

    def run(self, batch: ArrivalBatch) -> None:
        arr_t = batch.t.tolist()
        arr_pl = batch.plen.tolist()
        arr_g = batch.prefix.tolist()
        arr_gl = batch.prefix_len.tolist()
        arr_mn = batch.max_new.tolist()
        arr_tc = batch.tenant.tolist()
        n_arr = len(arr_t)
        ai = 0
        reps = self.reps
        order = self.routable  # phase-1 order == scalar _routable scan
        retry = self.retry
        rheap = self.rheap
        res_heap = self.res_heap
        hheap = self.hheap
        winner = self.winner
        armed = self.armed
        while True:
            if ai >= n_arr and self.n_completed == self.n_submitted:
                break
            # next boundary over all live event sources
            t = arr_t[ai] if ai < n_arr else _INF
            for rep in reps:
                ne = rep.next_ev
                if ne < t:
                    t = ne
            while res_heap and res_heap[0][2] in winner:
                heapq.heappop(res_heap)
            if res_heap and res_heap[0][0] < t:
                t = res_heap[0][0]
            while hheap and hheap[0][2] not in armed:
                heapq.heappop(hheap)
            if hheap and hheap[0][0] < t:
                t = hheap[0][0]
            if rheap and rheap[0][0] < t:
                t = rheap[0][0]
            if t == _INF:
                raise RuntimeError(
                    "workload stalled with "
                    f"{self.n_submitted - self.n_completed} requests "
                    "in flight: no replica tick, hedge deadline, or "
                    "clock event pending"
                )
            self.last_t = t
            # phase 1: replica ticks (routable order, like step())
            for i in order:
                rep = reps[i]
                if rep.next_ev == t:
                    self._tick(rep, t)
            # phase 2: first-token resolutions due now
            while res_heap and res_heap[0][0] == t:
                e = heapq.heappop(res_heap)
                self._resolve(e[2], t)
            # phase 3: hedge deadlines due now
            while hheap:
                while hheap and hheap[0][2] not in armed:
                    heapq.heappop(hheap)
                if not hheap or hheap[0][0] != t:
                    break
                _d, _s, ridx = heapq.heappop(hheap)
                armed.discard(ridx)
                self._fire_hedge(ridx, t)
            # phase 4: retry dues (the scalar fire_retries, pre-arrival)
            while rheap and rheap[0][0] == t:
                _due, _idx, r0, attempt = heapq.heappop(rheap)
                if self.r_ft[r0] <= t:
                    continue  # first token landed; the chain expires
                if attempt + 1 > retry.max_retries:
                    continue
                r2 = self._submit(
                    t, self.r_plen[r0], self.r_prefix[r0],
                    self.r_pfxlen[r0], self.r_maxnew[r0],
                    self.r_tcode[r0],
                )
                self.n_resubmits += 1
                if self.r_out[r2] != _SHED:
                    due2 = retry.resubmit_at(t, self.n_submitted,
                                             attempt + 1)
                    heapq.heappush(
                        rheap, (due2, self.n_submitted, r2, attempt + 1)
                    )
            # phase 5: arrivals stamped exactly now
            while ai < n_arr and arr_t[ai] == t:
                r1 = self._submit(t, arr_pl[ai], arr_g[ai],
                                  arr_gl[ai], arr_mn[ai], arr_tc[ai])
                ai += 1
                if retry is not None and self.r_out[r1] != _SHED:
                    due = retry.resubmit_at(t, self.n_submitted, 0)
                    heapq.heappush(
                        rheap, (due, self.n_submitted, r1, 0)
                    )

    # -- write-back and report ------------------------------------------

    def finish(self) -> int:
        """Land the day's end state on the REAL router/replicas — the
        sweeps read replica counters off the objects, and a fast day
        must leave the fleet exactly as the scalar drain would.
        Returns the fleet's total fired ticks."""
        router = self.router
        total_ticks = 0
        for rep in self.reps:
            r = router.replicas[rep.i]
            r.tick_count = rep.cur
            total_ticks += rep.cur
            r.last_tick_at = rep.last_tick_t
            if rep.idle:
                r.next_tick_at = None
            else:
                # an open chain at day end: the scalar drain stopped
                # at in-flight zero with this replica's (ghost) tick
                # still scheduled — schedule it, fire it never
                j = rep.cur + 1 - rep.base
                rep.ensure(j)
                r.next_tick_at = rep.times[j]
                rep.busy_parts.append(
                    rep.dts[1:rep.cur - rep.base + 1]
                )
            parts = [p for p in rep.busy_parts if p]
            if parts:
                flat = np.concatenate(
                    [np.asarray(p) for p in parts]
                )
                r.busy_s = float(np.cumsum(flat)[-1])
            else:
                r.busy_s = 0.0
            r.n_retired = rep.n_retired
            r.n_cancelled = rep.n_cancelled
            r.n_shared_admits = rep.n_shared_admits
        router.n_submitted = self.n_submitted
        router.n_completed = self.n_completed
        router.n_shed = self.n_shed
        router.n_hedges = self.n_hedges
        router.n_hedges_refused = self.n_hedges_refused
        router.n_over_budget = self.n_over_budget
        router._rr = self.rrc
        if self.last_t > self.clock.now():
            self.clock.run_until(self.last_t)
        return total_ticks

    def report(self, n_events: int | None,
               wall_s: float | None) -> WorkloadReport:
        sub = np.asarray(self.r_sub)
        ft = np.asarray(self.r_ft)
        done = np.asarray(self.r_done)
        out = np.asarray(self.r_out, np.int64)
        mn = np.asarray(self.r_maxnew, np.int64)
        served = out != _SHED
        outcomes: dict[str, int] = {}
        counts = np.bincount(out, minlength=5)
        for code in (_OK, _HEDGED, _HEDGE_WON, _SHED):
            c = int(counts[code])
            if c:
                outcomes[_OUT_NAMES[code]] = c
        shed_reasons: dict[str, int] = {}
        if self.n_shed:
            sc = np.bincount(np.asarray(self.r_shedc, np.int64),
                             minlength=4)
            for code, nm in _SHED_NAMES.items():
                if sc[code]:
                    shed_reasons[nm] = int(sc[code])
        decode = served & (mn > 1)
        itl = (done[decode] - ft[decode]) / (mn[decode] - 1)
        requests = _FastRequests(self)
        return WorkloadReport.from_arrays(
            requests, self.last_t, self.router,
            ttft=ft[served] - sub[served],
            latency=done[served] - sub[served],
            outcomes=outcomes, shed_reasons=shed_reasons,
            dropped=int(np.count_nonzero(out == _INFLIGHT)),
            decode_itl=itl, n_resubmits=self.n_resubmits,
            n_events=n_events, wall_s=wall_s,
        )


# -- lazy request views ---------------------------------------------------


class _ReqView:
    """One request's report-facing record: the attributes the sweeps
    and per-tenant books read off scalar ``RoutedRequest``s, served
    from the engine's arrays."""

    __slots__ = ("t_submit", "t_admitted", "t_first_token", "t_done",
                 "tenant", "outcome", "shed_reason", "finished",
                 "hedged", "replica", "max_new", "key")

    @property
    def ttft(self):
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def latency(self):
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit

    @property
    def tokens(self):
        return range(self.max_new if self.outcome != "shed" else 0)


class _FastRequests:
    """Sequence facade over the engine's struct-of-arrays request
    table: ``report.requests[i]`` / iteration materialize lightweight
    views on demand — a million-request day never builds a million
    records unless someone actually walks them."""

    def __init__(self, eng: _Engine):
        self._e = eng

    def __len__(self) -> int:
        return len(self._e.r_sub)

    def _view(self, i: int) -> _ReqView:
        e = self._e
        v = _ReqView()
        out = e.r_out[i]
        v.t_submit = e.r_sub[i]
        shed = out == _SHED
        v.t_admitted = None if shed else e.r_adm[i]
        v.t_first_token = None if shed else e.r_ft[i]
        v.t_done = e.r_done[i]
        tc = e.r_tcode[i]
        v.tenant = None if tc < 0 else e.c_name[tc]
        v.outcome = _OUT_NAMES.get(out)
        v.shed_reason = (_SHED_NAMES.get(e.r_shedc[i])
                         if shed else None)
        v.finished = out != _INFLIGHT
        v.hedged = e.r_hedged[i]
        v.replica = None if shed else e.r_repfin[i]
        v.max_new = e.r_maxnew[i]
        v.key = None
        return v

    def __getitem__(self, i: int) -> _ReqView:
        n = len(self._e.r_sub)
        if i < 0:
            i += n
        if not (0 <= i < n):
            raise IndexError(i)
        return self._view(i)

    def __iter__(self):
        for i in range(len(self._e.r_sub)):
            yield self._view(i)


# -- the public driver ----------------------------------------------------


def run_router_day_fast(
    router, arrivals, *, controller=None, events: Iterable = (),
    retry: RetryPolicy | None = None,
    timer: Callable[[], float] | None = None,
    series=None, slo=None,
) -> WorkloadReport:
    """:func:`~.workload.run_router_day` with the vectorized engine on
    supported days and a transparent scalar fallback on the rest —
    same signature, same report, bit-identical
    :meth:`~.workload.WorkloadReport.digest` either way.
    ``report.fastpath`` says which path ran (``"vectorized"`` or
    ``"scalar-fallback: <reason>"``); ``timer=`` opts into events/s
    self-measurement exactly as on the scalar driver."""
    evs = list(events)
    ok, reason = fastpath_supported(
        router, controller=controller, events=evs, retry=retry,
        series=series, slo=slo,
    )
    batch = None
    if ok:
        batch = (arrivals if isinstance(arrivals, ArrivalBatch)
                 else ArrivalBatch.from_arrivals(arrivals))
        if router._qos is not None and bool((batch.tenant < 0).any()):
            ok, reason = False, "untenanted traffic on a qos router"
        arrivals = batch  # the columns ARE the stream, for either path
    if ok:
        eng = _Engine(router, retry)
        bad = eng.bind_tenants(batch.tenant_names)
        if bad is not None:
            ok, reason = False, bad
    if not ok:
        rep = run_router_day(router, arrivals, controller=controller,
                             events=evs, retry=retry, timer=timer,
                             series=series, slo=slo)
        rep.fastpath = f"scalar-fallback: {reason}"
        return rep
    wall_t0 = timer() if timer is not None else None
    eng.run(batch)
    total_ticks = eng.finish()
    n_events = eng.n_submitted + total_ticks
    wall = None if wall_t0 is None else timer() - wall_t0
    rep = eng.report(n_events, wall)
    rep.fastpath = "vectorized"
    return rep
