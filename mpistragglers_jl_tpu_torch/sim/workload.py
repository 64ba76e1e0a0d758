"""Open-loop arrival workloads: traffic for the router plane, on virtual time.

A copy of ``mpistragglers_jl_tpu/sim/workload.py``, not an import of it
(the port never imports the JAX package). Stdlib and numpy, no torch and
no OS clock: the same seeded day gives the same
``WorkloadReport.digest()`` in either package.

The tuner prices *pool* policies by running the real ``asyncmap`` on a
:class:`~.backend.SimBackend`; this module does the same for *serving*
policies: an open-loop arrival process (seeded Poisson, a diurnal rate
schedule, or a recorded JSONL trace) drives the REAL
:class:`~..models.router.RequestRouter` — the identical routing code a
live fleet runs — over a fleet of :class:`SimReplica` scheduler models
on a :class:`~.clock.VirtualClock`. A simulated 1M-request diurnal day
replays in seconds of wall clock, bit-identically across runs (every
draw is seeded, every book is insertion-ordered), so
``sim/tune.py::sweep_router_policy`` can recommend a routing policy per
(load, prefix-share) operating point before a live run — exactly as
``sweep_nwait`` already prices nwait.

What is real and what is modeled:

* **real** — the router: policy choice, health ejection/re-route,
  TTFT-deadline hedging (:class:`~..utils.hedge.RequestHedge`),
  first-token-wins, loser cancellation, all metrics;
* **modeled** — the scheduler replica: :class:`SimReplica` reproduces
  :class:`~..models.serving.ServingScheduler`'s *timing skeleton*
  (S slots, one C-token prefill chunk per tick per admitting slot with
  the first chunk running on the admission tick, ``n_inner`` tokens
  per decode tick, FIFO admission, EOS-free length retirement, and
  residency-scoped prefix sharing that skips shared prefill chunks)
  without the model math — a tick is a ``tick_s`` virtual-second event,
  not a compiled program. Token VALUES do not exist here; TTFT and
  completion dynamics do.

Arrival records carry a :class:`SimPrompt` (length + optional shared
prefix group) rather than token arrays — a million requests must not
materialize a million prompts. Live fleets route real token arrays
through the same router; the arrival MODELS are reusable for both via
``prompt_fn``.
"""

# sim purity (tests/test_torch_imports.py): this module never reads the
# OS clock — virtual time is the only time here.

from __future__ import annotations

import heapq
import json
import math
from collections import deque
from typing import Callable, Iterable, Iterator

import numpy as np

from ..utils.faults import _unit
from .clock import VirtualClock

__all__ = [
    "Arrival",
    "ReplicaPartition",
    "RetryPolicy",
    "SimFleetCache",
    "SimPrompt",
    "SimRequest",
    "SimReplica",
    "SimTicket",
    "WorkloadReport",
    "poisson_arrivals",
    "diurnal_arrivals",
    "arrivals_from_jsonl",
    "dump_arrivals_jsonl",
    "lognormal_ticks",
    "run_router_day",
]

_CHUNK = 4096  # rng draws are batched; part of the determinism contract


class SimPrompt:
    """A prompt descriptor: ``length`` tokens, of which the leading
    ``prefix_len`` belong to shared-prefix group ``prefix`` (None =
    unique prompt, nothing shareable). Interned per distinct triple —
    replicas never mutate prompts, so a million arrivals can share a
    handful of these."""

    __slots__ = ("length", "prefix", "prefix_len")
    _interned: dict[tuple, "SimPrompt"] = {}

    def __new__(cls, length: int, prefix=None, prefix_len: int = 0):
        key = (int(length), prefix, int(prefix_len))
        got = cls._interned.get(key)
        if got is not None:
            return got
        self = super().__new__(cls)
        self.length, self.prefix, self.prefix_len = key
        if self.length < 1:
            raise ValueError("empty prompt")
        if not (0 <= self.prefix_len <= self.length):
            raise ValueError("prefix_len must be within the prompt")
        cls._interned[key] = self
        return self

    def __repr__(self) -> str:
        return (
            f"SimPrompt({self.length}, prefix={self.prefix}, "
            f"prefix_len={self.prefix_len})"
        )


class Arrival:
    """One open-loop arrival: at virtual time ``t``, a request for
    ``max_new`` tokens from ``prompt`` (a :class:`SimPrompt` here; a
    token array when an arrival model feeds a live fleet).
    ``tenant`` names the contract the request bills to (the QoS
    plane; None = untenanted traffic)."""

    __slots__ = ("t", "prompt", "max_new", "tenant")

    def __init__(self, t: float, prompt, max_new: int,
                 tenant: str | None = None):
        self.t = float(t)
        self.prompt = prompt
        self.max_new = int(max_new)
        self.tenant = tenant

    def __repr__(self) -> str:
        return f"Arrival(t={self.t:.6f}, max_new={self.max_new})"


# decorrelation stride for the tenant coin: the tenant label derives
# from the SAME per-arrival uniform draw as the prompt class (no extra
# rng draw — arrival times and prompt mixes stay bit-identical at
# every tenant mix, the long_share pattern), but through a fixed
# multiplicative fold so tenant intervals do not align with the
# prefix/long-class intervals of u itself
_TENANT_STRIDE = 9973.0


def _tenant_fn(tenants) -> Callable[[float], str | None]:
    """(u,) -> tenant name (or None): ``tenants`` is an ordered
    ``{name: share}`` mapping with positive shares summing to 1 —
    refused otherwise by name, never renormalized silently. The label
    is a pure function of the arrival's existing coin ``u`` (module
    comment on ``_TENANT_STRIDE``)."""
    if tenants is None:
        return lambda u: None
    names = list(tenants)
    if not names:
        raise ValueError("tenants= needs at least one (name, share)")
    shares = [float(tenants[n]) for n in names]
    if any(s <= 0 for s in shares):
        raise ValueError(
            f"tenant shares must all be > 0, got {dict(tenants)}"
        )
    if abs(sum(shares) - 1.0) > 1e-9:
        raise ValueError(
            f"tenant shares must sum to 1 (got {sum(shares):.6f}); "
            "shares are the arrival mix, not weights — normalize "
            "explicitly"
        )
    cum = []
    acc = 0.0
    for s in shares:
        acc += s
        cum.append(acc)
    last = len(names) - 1

    def fn(u: float) -> str:
        v = (u * _TENANT_STRIDE) % 1.0
        for i, c in enumerate(cum):
            if v < c:
                return names[i]
        return names[last]

    return fn


def _default_prompt_fn(
    prompt_len: int, prefix_share: float, prefix_len: int,
    n_prefix_groups: int, max_new: int,
    long_share: float = 0.0, long_prompt_len: int | None = None,
    long_max_new: int | None = None,
) -> Callable:
    """(u,) -> (prompt, max_new): with probability ``prefix_share``
    the prompt opens with one of ``n_prefix_groups`` shared system
    prompts of ``prefix_len`` tokens (the prefix-affinity / COW
    scenario); with probability ``long_share`` it is a LONG prompt of
    ``long_prompt_len`` tokens decoding ``long_max_new`` (default: the
    short class's budget) — the mixed long-prompt/short-chat day the
    disaggregation bench replays; else a unique short prompt. ONE rng
    draw decides all of it (the two classes live in disjoint intervals
    of ``u``), so the arrival TIMES are identical at every share and
    mix rate — and streams with the defaults are bit-identical to
    every pre-mix recording."""
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

    def fn(u: float):
        if share > 0.0 and u < share:
            g = int(u / share * n_prefix_groups)  # deterministic in u
            g = min(g, n_prefix_groups - 1)
            return SimPrompt(prompt_len, prefix=g,
                             prefix_len=prefix_len), max_new
        if lshare > 0.0 and u >= 1.0 - lshare:
            return SimPrompt(long_prompt_len), long_mn
        return SimPrompt(prompt_len), max_new

    return fn




def poisson_arrivals(
    rate: float,
    *,
    n: int,
    seed: int = 0,
    start: float = 0.0,
    prompt_len: int = 128,
    max_new: int = 32,
    prefix_share: float = 0.0,
    prefix_len: int = 0,
    n_prefix_groups: int = 1,
    long_share: float = 0.0,
    long_prompt_len: int | None = None,
    long_max_new: int | None = None,
    tenants: dict | None = None,
) -> Iterator[Arrival]:
    """Seeded homogeneous Poisson arrivals: ``n`` requests at mean
    ``rate``/s from virtual ``start``. Every draw comes from one
    generator seeded on ``seed`` in a fixed chunked order, so two calls
    with the same arguments yield bit-identical streams (pinned by
    tests/test_torch_sim_workload.py). ``long_share``/``long_prompt_len``/
    ``long_max_new`` mix in a long-prompt class on the same coin (see
    :func:`_default_prompt_fn` — arrival times never move).
    ``tenants`` (``{name: share}``, shares summing to 1) labels each
    arrival with a tenant off the SAME coin — no extra draw, so
    arrival times and prompt classes are bit-identical at every
    tenant mix (:func:`_tenant_fn`)."""
    if rate <= 0 or n < 1:
        raise ValueError("need rate > 0 and n >= 1")
    rng = np.random.default_rng((0x9E3779B9, int(seed)))
    fn = _default_prompt_fn(prompt_len, prefix_share, prefix_len,
                            n_prefix_groups, max_new, long_share,
                            long_prompt_len, long_max_new)
    tfn = _tenant_fn(tenants)
    t = float(start)
    left = int(n)
    while left:
        m = min(_CHUNK, left)
        ts = t + np.cumsum(rng.exponential(1.0 / rate, size=m))
        coins = rng.random(size=m)
        t = float(ts[-1])
        for tt, u in zip(ts.tolist(), coins.tolist()):
            p, mn = fn(u)
            yield Arrival(tt, p, mn, tenant=tfn(u))
        left -= m


def diurnal_arrivals(
    mean_rate: float,
    *,
    n: int,
    period: float = 86_400.0,
    amplitude: float = 0.8,
    seed: int = 0,
    start: float = 0.0,
    prompt_len: int = 128,
    max_new: int = 32,
    prefix_share: float = 0.0,
    prefix_len: int = 0,
    n_prefix_groups: int = 1,
    long_share: float = 0.0,
    long_prompt_len: int | None = None,
    long_max_new: int | None = None,
    tenants: dict | None = None,
) -> Iterator[Arrival]:
    """Seeded non-homogeneous Poisson arrivals on a diurnal rate
    schedule: ``rate(t) = mean_rate * (1 + amplitude * sin(2*pi*t/
    period - pi/2))`` — trough at ``t = 0``, peak at mid-period (the
    classic traffic day compressed to ``period`` virtual seconds).
    Sampled by Lewis thinning against the peak rate with every
    candidate and acceptance coin drawn from one seeded generator in
    chunked order — bit-identical across runs, like
    :func:`poisson_arrivals` (whose long-prompt mix kwargs apply here
    too: the disaggregation bench's burst day is this function with
    ``long_share > 0``; ``tenants=`` labels arrivals off the same
    coin without moving a single arrival time)."""
    if mean_rate <= 0 or n < 1:
        raise ValueError("need mean_rate > 0 and n >= 1")
    if not (0.0 <= amplitude < 1.0):
        raise ValueError(
            f"amplitude must be in [0, 1), got {amplitude}"
        )
    rng = np.random.default_rng((0x51ED2701, int(seed)))
    fn = _default_prompt_fn(prompt_len, prefix_share, prefix_len,
                            n_prefix_groups, max_new, long_share,
                            long_prompt_len, long_max_new)
    tfn = _tenant_fn(tenants)
    peak = mean_rate * (1.0 + amplitude)
    w = 2.0 * math.pi / period
    t = float(start)
    out = 0
    n = int(n)
    while out < n:
        # Lewis thinning, one chunk of candidates at a time, fully
        # vectorized: candidate times by cumsum, the instantaneous rate
        # at each, and the acceptance mask in numpy — the python loop
        # touches only the survivors
        ts = t + np.cumsum(rng.exponential(1.0 / peak, size=_CHUNK))
        accept = rng.random(size=_CHUNK)
        coins = rng.random(size=_CHUNK)
        t = float(ts[-1])
        rates = mean_rate * (
            1.0 + amplitude * np.sin(w * ts - math.pi / 2.0)
        )
        keep = accept * peak < rates
        for tt, u in zip(ts[keep].tolist(), coins[keep].tolist()):
            p, mn = fn(u)
            yield Arrival(tt, p, mn, tenant=tfn(u))
            out += 1
            if out == n:
                break


def arrivals_from_jsonl(path) -> list[Arrival]:
    """Trace-driven arrivals from a JSONL file (the ``ReplayTrace``
    style: one record per line) — each line
    ``{"t": s, "prompt_len": n, "max_new": m}`` plus optional
    ``"prefix"``/``"prefix_len"`` for shared-prefix requests. Replays
    exactly: the returned list IS the recorded stream."""
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            out.append(Arrival(
                rec["t"],
                SimPrompt(
                    rec["prompt_len"],
                    prefix=rec.get("prefix"),
                    prefix_len=rec.get("prefix_len", 0),
                ),
                rec["max_new"],
                tenant=rec.get("tenant"),
            ))
    if not out:
        raise ValueError(f"empty arrival trace: {path}")
    return out


def dump_arrivals_jsonl(arrivals: Iterable[Arrival], path) -> int:
    """Record an arrival stream for trace-driven replay; returns the
    record count."""
    n = 0
    with open(path, "w") as f:
        for a in arrivals:
            rec = {
                "t": a.t, "prompt_len": a.prompt.length,
                "max_new": a.max_new,
            }
            if a.prompt.prefix is not None:
                rec["prefix"] = a.prompt.prefix
                rec["prefix_len"] = a.prompt.prefix_len
            if a.tenant is not None:
                rec["tenant"] = a.tenant
            f.write(json.dumps(rec) + "\n")
            n += 1
    return n


def service_ticks_per_request(
    *, prompt_len: int, prompt_chunk: int, max_new: int, n_inner: int,
) -> int:
    """Slot-holding ticks one request costs a :class:`SimReplica` (and
    the real scheduler whose tick skeleton it models): its prefill
    chunks plus its decode ticks. THE capacity arithmetic —
    ``sweep_router_policy`` sizes offered load with it and the fleet
    controller's ``replica_capacity_rps`` prices utilization with it
    (one formula, so the controller's signal can never drift from the
    sweep it cross-checks)."""
    if min(prompt_len, prompt_chunk, max_new, n_inner) < 1:
        raise ValueError(
            "prompt_len/prompt_chunk/max_new/n_inner must be >= 1"
        )
    return (
        -(-int(prompt_len) // int(prompt_chunk))
        + -(-max(int(max_new) - 1, 0) // int(n_inner))
    )


class FleetResize:
    """Control-plane event in the simulated day's event stream: at
    virtual time ``t``, an operator forces the fleet to ``target``
    replicas through the attached controller (``run_router_day``'s
    ``controller=``). The controller's range contract still applies —
    a target outside its elastic band is refused by name, never
    clamped — and the resize re-derives (code pair, policy) exactly
    like a hysteresis-triggered one."""

    __slots__ = ("t", "target", "reason")

    def __init__(self, t: float, target: int, reason: str = "operator"):
        self.t = float(t)
        self.target = int(target)
        self.reason = str(reason)

    def fire(self, router, controller) -> None:
        if controller is None:
            raise ValueError(
                "FleetResize event with no controller attached: pass "
                "controller= to run_router_day — there is nothing to "
                "resize"
            )
        controller.resize_to(self.target, reason=self.reason)

    def __repr__(self) -> str:
        return (
            f"FleetResize(t={self.t:.3f}, target={self.target}, "
            f"{self.reason!r})"
        )


class CoordinatorKill:
    """Control-plane event: at virtual time ``t`` the active
    coordinator dies. The data plane (router, replicas) keeps serving;
    decisions stop until the standby adopts the last coded checkpoint
    (:class:`~..fleet.failover.ControllerSupervisor` semantics) — the
    zero-drop failover scenario, replayed bit-identically."""

    __slots__ = ("t",)

    def __init__(self, t: float):
        self.t = float(t)

    def fire(self, router, controller) -> None:
        kill = getattr(controller, "kill", None)
        if kill is None:
            raise ValueError(
                "CoordinatorKill event needs a supervised controller "
                "(fleet.ControllerSupervisor as run_router_day's "
                "controller=): killing an unsupervised coordinator "
                "would end the day, not fail it over"
            )
        kill()

    def __repr__(self) -> str:
        return f"CoordinatorKill(t={self.t:.3f})"


def _retry_coin(seed: int, index: int, attempt: int) -> float:
    """Deterministic uniform [0, 1) from (seed, submit index, attempt)
    — the retry client's seeded coin, delegated to THE fault-plane
    coin (:func:`~..utils.faults._unit`, one implementation) but keyed
    on the DAY-LOCAL submit index rather than a process-global request
    id, so two replays of the same day draw identical jitter."""
    return _unit(int(seed), int(index), int(attempt))


class RetryPolicy:
    """Timeout-and-resubmit client model — the classic metastable-
    failure generator (chaos plane). A client whose request shows no
    first token within ``timeout_s`` resubmits it as a FRESH request
    (the original is NOT cancelled: the client cannot reach into the
    fleet, so both copies consume capacity — that feedback is the
    amplification), up to ``max_retries`` resubmissions per original,
    with per-attempt timeouts stretched by ``backoff`` and resubmit
    jitter drawn on a seeded coin keyed by (day-local submit index,
    attempt) — the storm itself replays bit-identically. A request
    shed at the door is NOT retried (shed is a fast, named refusal the
    client backs off from — retrying sheds would defeat overload
    shedding).

    Consumed by :func:`run_router_day` (``retry=``); resubmissions
    feed back into the day's arrival stream as first-class submits, so
    every attempt appears in the :class:`WorkloadReport` (and its
    digest) and ``n_resubmits`` counts the amplification."""

    __slots__ = ("timeout_s", "max_retries", "backoff", "jitter_s",
                 "seed")

    def __init__(self, timeout_s: float, *, max_retries: int = 3,
                 backoff: float = 1.0, jitter_s: float = 0.0,
                 seed: int = 0):
        if timeout_s <= 0:
            raise ValueError(
                f"timeout_s must be > 0, got {timeout_s}"
            )
        if max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {max_retries}"
            )
        if backoff < 1.0:
            raise ValueError(
                f"backoff must be >= 1 (timeouts never shrink), got "
                f"{backoff}"
            )
        if jitter_s < 0:
            raise ValueError(
                f"jitter_s must be >= 0, got {jitter_s}"
            )
        self.timeout_s = float(timeout_s)
        self.max_retries = int(max_retries)
        self.backoff = float(backoff)
        self.jitter_s = float(jitter_s)
        self.seed = int(seed)

    def resubmit_at(self, t_submit: float, index: int,
                    attempt: int) -> float:
        """When attempt ``attempt`` (0 = the original) submitted at
        ``t_submit`` would be resubmitted: its timeout plus the seeded
        jitter coin."""
        due = t_submit + self.timeout_s * self.backoff ** attempt
        if self.jitter_s:
            due += self.jitter_s * _retry_coin(
                self.seed, index, attempt
            )
        return due

    def __repr__(self) -> str:
        return (
            f"RetryPolicy(timeout_s={self.timeout_s}, "
            f"max_retries={self.max_retries}, "
            f"backoff={self.backoff}, jitter_s={self.jitter_s})"
        )


class ReplicaPartition:
    """Control-plane event in the simulated day's event stream: at
    virtual time ``t`` the router loses network reachability to the
    named ``replicas`` (a partition is distinct from death — the
    replicas keep ticking, their results are simply unreachable:
    :meth:`~..models.router.RequestRouter.partition`), and at
    ``until`` the partition heals — the replicas rejoin through
    :meth:`~..models.router.RequestRouter.heal`, which withdraws
    every stale leg so no request is double-retired. The heal is
    scheduled on the router's clock at fire time, so it lands exactly
    on time in the same event-driven drive loop as kill/recover
    injections."""

    __slots__ = ("t", "replicas", "until")

    def __init__(self, t: float, replicas, until: float):
        self.t = float(t)
        self.replicas = (
            [int(replicas)]
            if isinstance(replicas, (int, np.integer))
            else [int(i) for i in replicas]
        )
        if not self.replicas:
            raise ValueError("ReplicaPartition with no replicas")
        self.until = float(until)
        if self.until <= self.t:
            raise ValueError(
                f"partition must heal after it begins: t={self.t}, "
                f"until={self.until}"
            )

    def fire(self, router, controller) -> None:
        clock = router.clock
        if clock is None:
            raise ValueError(
                "ReplicaPartition event needs a VirtualClock router: "
                "a live fleet's partitions come from the network, not "
                "the event stream"
            )
        for i in self.replicas:
            router.partition(i)

        def _heal():
            for i in self.replicas:
                router.heal(i)

        clock.call_at(self.until, _heal)

    def __repr__(self) -> str:
        return (
            f"ReplicaPartition(t={self.t:.3f}, "
            f"replicas={self.replicas}, until={self.until:.3f})"
        )


class lognormal_ticks:
    """Deterministic per-tick service-time jitter:
    ``tick_s(tick) = base * exp(sigma * N(0,1))`` with the normals
    drawn from one generator seeded on ``seed`` and cached by tick
    index — the same tick always costs the same, whatever order ticks
    are priced in. The knob that makes scheduler replicas heterogeneous
    (a straggling replica is ``lognormal_ticks(base * 1.5, ...)`` or a
    bigger sigma), which is exactly the imbalance ``least_loaded``
    routes around and ``round_robin`` cannot."""

    def __init__(self, base: float, sigma: float = 0.0, *,
                 seed: int = 0):
        self.base = float(base)
        self.sigma = float(sigma)
        self._rng = np.random.default_rng((0x7F4A7C15, int(seed)))
        self._cache: list[float] = []

    def __call__(self, tick: int) -> float:
        if self.sigma == 0.0:
            return self.base
        while len(self._cache) <= tick:
            draws = self._rng.standard_normal(_CHUNK)
            self._cache.extend(
                self.base * math.exp(self.sigma * float(z))
                for z in draws
            )
        return self._cache[tick]


class SimRequest:
    """The scheduler-request face of one simulated request: ``tokens``
    (length-only — token values do not exist in the model),
    ``finished`` / ``reason`` / ``admitted_tick``, exactly the members
    the router's replica protocol reads."""

    __slots__ = ("prompt", "max_new", "tenant", "n_emitted",
                 "finished", "reason", "admitted_tick", "migrated",
                 "trace", "_holds_prefix")

    def __init__(self, prompt: SimPrompt, max_new: int,
                 tenant: str | None = None):
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        self.prompt = prompt
        self.max_new = int(max_new)
        self.tenant = tenant
        self.n_emitted = 0
        self.finished = False
        self.reason = None
        self.admitted_tick = None
        self.trace = None  # TraceBook id (None = dark)
        # True once adopted by another replica: admission then skips
        # prefill entirely (the pages arrived with the request)
        self.migrated = False
        self._holds_prefix = None

    @property
    def tokens(self):
        # range: len() and truthiness in O(1) — the only reads the
        # router protocol makes
        return range(self.n_emitted)


class SimTicket:
    """The sim face of a KV-page migration ticket: the frozen request,
    the byte/page accounting the router's threshold and transfer
    pricing read, and the reason label the obs counters use. The
    request object itself crosses (in-process sim), so adoption is
    stream-continuous exactly like the live in-process fast path."""

    __slots__ = ("request", "nbytes", "pages", "reason", "trace")

    def __init__(self, request: SimRequest, nbytes: int, pages: int,
                 reason: str = "prefill_done"):
        self.request = request
        self.nbytes = int(nbytes)
        self.pages = int(pages)
        self.reason = reason
        self.trace = None  # trace id riding inside the ticket


class SimFleetCache:
    """The sim twin of :class:`~..cache.FleetPrefixCache`: a
    fleet-level prefix-group namespace with the same three tiers and
    the same byte-priced movement model, on virtual time.

    Replicas :meth:`register` and then report residency transitions:
    0→1 holders of a prefix group publishes it as tier-``hbm`` here
    (:meth:`publish_hbm`); the LAST holder leaving withdraws it and —
    when no sibling still advertises the group — spills it into a
    bounded host-DRAM FIFO of ``store_groups`` groups
    (:meth:`residency_lost`, which returns the planner-priced spill
    seconds the replica charges to its tick). An admission whose
    prefix group is not locally resident asks :meth:`fetch`: DRAM
    first, then a reachable peer's HBM — a hit skips the shared
    prefill chunks at a priced transfer cost instead of for free,
    which is exactly the live scheduler's fetch-instead-of-prefill
    trade and what ``sweep_spill_capacity`` sweeps.

    Failure model mirrors the live hub: :meth:`partition` makes a
    replica unreachable (its HBM advertisements invisible, its own
    fetches fail → fall back to prefill) until :meth:`heal`;
    :meth:`drop_replica` (kill) purges its HBM entries while DRAM
    spills SURVIVE. Everything is insertion-ordered dicts and pure
    arithmetic — no OS clock, no unordered iteration — so a day
    replays bit-identically (no OS clock), and every counter lives OUTSIDE
    :meth:`WorkloadReport.digest`.

    ``registry=`` (opt-in) publishes the same counter names as
    the live plane: ``cache_spill_bytes_total``,
    ``cache_fetch_bytes_total{src=}``, ``cache_directory_size``.
    """

    def __init__(self, *, store_groups: int = 64,
                 kv_bytes_per_token: float = 4096.0,
                 planner=None, registry=None):
        if store_groups < 0:
            raise ValueError(
                f"store_groups must be >= 0 (0 disables the DRAM "
                f"tier), got {store_groups}"
            )
        if kv_bytes_per_token < 0.0:
            raise ValueError("kv_bytes_per_token must be >= 0")
        # lazy import: the cache package loads the planner alone here
        # (its client, and with it torch, only on use)
        if planner is None:
            from ..cache import SpillFetchPlanner

            planner = SpillFetchPlanner()
        self.planner = planner
        self.store_groups = int(store_groups)
        self.kv_bytes_per_token = float(kv_bytes_per_token)
        self._hbm: dict[str, set] = {}  # replica -> advertised groups
        self._dram: dict = {}  # group -> nbytes, FIFO eviction order
        self._unreachable: set[str] = set()
        self._n_auto = 0
        self.n_fetches = {"dram": 0, "peer": 0}
        self.n_fallbacks = 0  # group known but unreachable -> prefill
        self.n_spills = 0
        self.n_evictions = 0
        self.n_replica_drops = 0
        self.spill_bytes = 0
        self.fetch_bytes = 0
        self._registry = registry
        self._m_fetch: dict = {}
        if registry is not None:
            self._m_spill = registry.counter(
                "cache_spill_bytes_total",
                help="bytes of prefix pages absorbed by the host-DRAM "
                "spill tier",
            )
            self._m_size = registry.gauge(
                "cache_directory_size",
                help="advertised prefix locations fleet-wide "
                "(hbm + dram)",
            )
        else:
            self._m_spill = None
            self._m_size = None

    # -- membership ------------------------------------------------------

    def register(self, replica) -> str:
        """A SimReplica joins; returns its fleet name (``"s<n>"``)."""
        name = f"s{self._n_auto}"
        self._n_auto += 1
        self._hbm[name] = set()
        return name

    def drop_replica(self, name: str) -> None:
        """Replica death: its HBM advertisements vanish with the
        device memory; its DRAM spills survive (host-side state — the
        whole point of the spill tier)."""
        if self._hbm.pop(name, None) is not None:
            self.n_replica_drops += 1
        self._unreachable.discard(name)
        self._set_size()

    def partition(self, name: str) -> None:
        self._unreachable.add(name)

    def heal(self, name: str) -> None:
        self._unreachable.discard(name)

    # -- residency mirror ------------------------------------------------

    def publish_hbm(self, name: str, group) -> None:
        """First holder of ``group`` landed on ``name``: advertise its
        HBM residency fleet-wide."""
        self._hbm.setdefault(name, set()).add(group)
        self._set_size()

    def residency_lost(self, name: str, group, prefix_len: int) -> float:
        """Last holder of ``group`` left ``name``: withdraw the HBM
        advertisement and, when no sibling still holds the group and
        the DRAM tier has room policy for it, spill it there. Returns
        the priced spill seconds (0.0 when nothing moved) — the
        replica charges them to its next busy tick, the sim's
        device→host DMA."""
        groups = self._hbm.get(name)
        if groups is not None:
            groups.discard(group)
        self._set_size()
        if self.store_groups == 0 or group in self._dram:
            return 0.0
        for held in self._hbm.values():
            if group in held:  # a sibling still serves it from HBM
                return 0.0
        nbytes = int(prefix_len * self.kv_bytes_per_token)
        if nbytes < 1:
            return 0.0
        while len(self._dram) >= self.store_groups:
            oldest = next(iter(self._dram))
            del self._dram[oldest]
            self.n_evictions += 1
        self._dram[group] = nbytes
        self.n_spills += 1
        self.spill_bytes += nbytes
        if self._m_spill is not None:
            self._m_spill.inc(nbytes)
        self._set_size()
        return self.planner.price(nbytes, "spill")

    # -- lookup ----------------------------------------------------------

    def fetch(self, group, prefix_len: int, *,
              exclude: str | None = None):
        """``("dram" | "peer", priced_seconds)`` for a reachable copy
        of ``group``, or None (prefill the chunks). DRAM wins over
        peer like the live hub; a partitioned asker (``exclude``) sees
        nothing at all — it cannot reach the store host either."""
        nbytes = int(prefix_len * self.kv_bytes_per_token)
        if nbytes < 1:
            return None
        if exclude is not None and exclude in self._unreachable:
            if self._known(group, exclude):
                self.n_fallbacks += 1
            return None
        if group in self._dram:
            return self._hit("dram", "fetch_dram", nbytes)
        for name, held in self._hbm.items():
            if name == exclude or name in self._unreachable:
                continue
            if group in held:
                return self._hit("peer", "fetch_peer", nbytes)
        if self._known(group, exclude):
            self.n_fallbacks += 1
        return None

    def _hit(self, src: str, kind: str, nbytes: int):
        self.n_fetches[src] += 1
        self.fetch_bytes += nbytes
        if self._registry is not None:
            m = self._m_fetch.get(src)
            if m is None:
                m = self._registry.counter(
                    "cache_fetch_bytes_total",
                    help="bytes of prefix pages served by the fleet "
                    "cache instead of re-prefill",
                    src=src,
                )
                self._m_fetch[src] = m
            m.inc(nbytes)
        return (src, self.planner.price(nbytes, kind))

    def _known(self, group, exclude: str | None = None) -> bool:
        """Is ``group`` advertised anywhere OTHER than ``exclude``?
        A miss on a group only the asker itself ever held is a cold
        miss, not a fallback — fallbacks name copies that existed and
        could not be reached."""
        if group in self._dram:
            return True
        for name, held in self._hbm.items():
            if name == exclude:
                continue
            if group in held:
                return True
        return False

    def _set_size(self) -> None:
        if self._m_size is not None:
            self._m_size.set(
                len(self._dram)
                + sum(len(h) for h in self._hbm.values())
            )

    # -- bookkeeping -----------------------------------------------------

    def check(self) -> None:
        if len(self._dram) > self.store_groups:
            raise AssertionError(
                f"DRAM tier over capacity: {len(self._dram)} > "
                f"{self.store_groups}"
            )
        for name in self._unreachable:
            if name not in self._hbm:
                raise AssertionError(
                    f"unreachable set holds unknown replica {name!r}"
                )

    def stats(self) -> dict:
        return {
            "replicas": list(self._hbm),
            "unreachable": sorted(self._unreachable),
            "hbm_groups": sum(len(h) for h in self._hbm.values()),
            "dram_groups": len(self._dram),
            "fetches": dict(self.n_fetches),
            "fallbacks": self.n_fallbacks,
            "spills": self.n_spills,
            "evictions": self.n_evictions,
            "replica_drops": self.n_replica_drops,
            "spill_bytes": self.spill_bytes,
            "fetch_bytes": self.fetch_bytes,
        }

    def __repr__(self) -> str:
        return (
            f"SimFleetCache({len(self._hbm)} replicas, "
            f"dram={len(self._dram)}/{self.store_groups})"
        )


class SimReplica:
    """A :class:`~..models.serving.ServingScheduler` timing model on
    virtual time — the router's replica protocol (submit / step /
    cancel / pending / active / prefix_hits / alive / next_tick_at),
    with the scheduler's tick skeleton and none of its math (module
    docstring).

    A tick costs ``tick_s`` virtual seconds (float, or a
    ``f(tick_index) -> s`` callable like :class:`lognormal_ticks`) and
    fires only when due (``next_tick_at``): the workload driver
    advances the clock to the earliest due tick fleet-wide, so
    replicas tick concurrently on the virtual axis exactly as N real
    scheduler processes would on the wall. Per tick, mirroring the
    real ``step()``: admitting slots advance one prefill chunk (the
    first chunk on the admission tick itself), free slots admit FIFO
    from the queue, decoding slots emit ``n_inner`` tokens, rows at
    their ``max_new`` budget retire and free their slot.

    Prefix sharing is residency-scoped like the paged pool: while any
    resident slot holds prefix group g, a newly admitted g-request
    skips its shared prefill chunks (``prefix_len`` tokens) — the
    timing effect of the paged cache's page sharing, which is what
    ``prefix_affinity`` routing compounds.

    ``kill()`` models a replica death: state is wiped, in-flight
    requests stop progressing (the router re-routes them on its next
    health probe), ``alive`` flips for the default health probe;
    ``revive()`` brings the replica back empty.

    **Two-tier mode** (the disaggregation model, models/disagg.py's
    sim twin): ``tier`` tags the replica for the router's ``two_tier``
    placement; ``chunk_s`` prices PREFILL work into the tick — each
    prefill chunk advanced in a tick adds ``chunk_s`` virtual seconds
    to it, so a long-prompt burst inflates every tick it shares a
    replica with and the in-flight decodes' inter-token gaps blow out
    (the real scheduler's ``_advance_admissions`` loop runs one
    ``_extend`` program per admitting slot per tick — this is that
    cost, modeled; ``chunk_s=0`` keeps the unchunked timing
    bit-identical). ``migrate_out`` freezes a decoding request into a
    :class:`SimTicket` sized by the ``kv_bytes_per_token`` byte model;
    ``adopt`` re-queues it with ``migrated=True`` — admission then
    takes the slot WITHOUT prefill chunks (the pages came along) and
    carries its shared-prefix residency to this replica, which is what
    the router's residency-affine adoption compounds."""

    def __init__(self, clock: VirtualClock, *, slots: int = 8,
                 n_inner: int = 8, tick_s=0.02,
                 prompt_chunk: int = 256, tier: str = "unified",
                 chunk_s: float = 0.0,
                 kv_bytes_per_token: float = 4096.0,
                 page_tokens: int = 16, qos=None,
                 max_queue: int | None = None, trace=None,
                 cache: "SimFleetCache | None" = None):
        if slots < 1 or n_inner < 1 or prompt_chunk < 1:
            raise ValueError(
                "slots, n_inner and prompt_chunk must be >= 1"
            )
        if max_queue is not None and max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1 or None, got {max_queue}"
            )
        if tier not in ("unified", "prefill", "decode"):
            raise ValueError(
                f"tier must be unified/prefill/decode, got {tier!r}"
            )
        if chunk_s < 0.0 or kv_bytes_per_token < 0.0 or page_tokens < 1:
            raise ValueError(
                "chunk_s and kv_bytes_per_token must be >= 0, "
                "page_tokens >= 1"
            )
        # multi-tenant QoS (opt-in): the FIFO queue becomes the SAME
        # weighted deficit-round-robin the real scheduler runs under
        # qos= — the timing twin of its admission order, so the
        # isolation claims are measured on virtual time (lazy import:
        # the qos package is stdlib-only, but sim/ keeps its closure
        # explicit the way tune.py's models import does)
        self.qos = qos
        if qos is not None:
            from ..qos import DeficitScheduler

            self._drr = DeficitScheduler(qos)
        else:
            self._drr = None
        self.clock = clock
        self.S = int(slots)
        self.n_inner = int(n_inner)
        self.C = int(prompt_chunk)
        self.tier = tier
        # the scheduler-side bounded-queue backstop (chaos plane):
        # mirrors ServingScheduler(max_queue=) — the router sheds by
        # name first; this is the hard assertion behind it
        self.max_queue = None if max_queue is None else int(max_queue)
        self.chunk_s = float(chunk_s)
        self.kv_bytes_per_token = float(kv_bytes_per_token)
        self.page_tokens = int(page_tokens)
        self._tick_s = (
            tick_s if callable(tick_s)
            else (lambda _t, _d=float(tick_s): _d)
        )
        # the raw tick_s spec, kept for sim/fastpath.py's support
        # gate: a float constant or a recognized index-pure seeded
        # callable (lognormal_ticks) can be replayed off the loop
        self._tick_spec = tick_s
        self._queue: deque[SimRequest] = deque()
        self._slots: list[SimRequest | None] = [None] * self.S
        self._prefill = [0] * self.S
        self._n_active = 0  # occupied slots, O(1) for the router's load reads
        self._resident: dict = {}  # prefix group -> holder count
        self.alive = True
        self.tick_count = 0
        self.next_tick_at: float | None = None
        self.last_tick_at: float | None = None
        self.n_retired = 0
        self.n_cancelled = 0
        self.n_shared_admits = 0
        self.n_adopted = 0
        self.n_migrated_out = 0
        # virtual seconds this replica spent with work on board (tick
        # intervals scheduled while busy) — the numerator of the QoS
        # plane's work-conservation floor; NOT in any digest
        self.busy_s = 0.0
        # fleet prefix cache (opt-in): residency transitions mirror
        # into the shared SimFleetCache; a fleet fetch skips shared
        # prefill chunks at a priced cost accumulated here and charged
        # to the next busy tick (like chunk_s, a tick stretch)
        self.cache = cache
        self.cache_name: str | None = None
        self.n_fleet_hits = 0
        self._xfer_s = 0.0
        if cache is not None:
            self.cache_name = cache.register(self)
        # causal tracing (opt-in): replica-side
        # events — DRR queue transitions, prefill chunks — stamped on
        # the VIRTUAL clock against trace ids the router minted
        self._trace = None
        if trace is not None:
            self.attach_trace(trace)

    def attach_trace(self, book) -> None:
        """Arm causal tracing (the router propagates its book here).
        DRR transitions route through the scheduler's own trace hook
        so qos/ stays clock-free — this callback owns the clock."""
        self._trace = book
        if self._drr is not None:
            self._drr.set_trace(self._drr_trace_event)

    def _drr_trace_event(self, kind, tenant, item, cost) -> None:
        tid = item.trace
        if tid is not None:
            self._trace.event(
                tid, kind, self.clock.now(), tenant=tenant, cost=cost
            )

    # -- replica protocol -------------------------------------------------

    @property
    def pending(self) -> int:
        return (self._drr.total if self._drr is not None
                else len(self._queue))

    @property
    def active(self) -> int:
        return self._n_active

    def submit(self, prompt, max_new: int, key=None,
               tenant: str | None = None, trace=None) -> SimRequest:
        if not self.alive:
            raise RuntimeError(
                "submit to a killed SimReplica: the router must not "
                "route to an unroutable replica"
            )
        if self.max_queue is not None and self.pending >= self.max_queue:
            raise RuntimeError(
                f"queue ceiling: {self.pending} requests already "
                f"queued at max_queue={self.max_queue} — shed at the "
                "router (shed_depth=) instead of queueing unboundedly"
            )
        if isinstance(prompt, int):
            prompt = SimPrompt(prompt)
        req = SimRequest(prompt, max_new, tenant=tenant)
        if trace is not None:
            # stamped BEFORE the enqueue so the DRR trace hook sees
            # the id on its drr_queued event
            req.trace = trace
        self._enqueue(req)
        if self.next_tick_at is None:
            self.next_tick_at = (
                self.clock.now() + self._tick_s(self.tick_count)
            )
        return req

    def _enqueue(self, req: SimRequest) -> None:
        if self._drr is not None:
            if req.tenant is None:
                raise ValueError(
                    "qos SimReplica needs tenant= at submit: "
                    "admission order is per-contract (register a "
                    "catch-all TenantContract for untagged traffic)"
                )
            # DRR cost in tokens, the real scheduler's unit
            self._drr.enqueue(
                req.tenant, req,
                float(req.prompt.length + req.max_new),
            )
        else:
            self._queue.append(req)

    def prefix_hits(self, prompt) -> int:
        """Affinity score: shared-prefill chunks this replica would
        skip for ``prompt`` right now (0 when its prefix group is not
        resident here)."""
        if getattr(prompt, "prefix", None) is None:
            return 0
        if self._resident.get(prompt.prefix, 0) < 1:
            return 0
        return -(-prompt.prefix_len // self.C)

    def cancel(self, req: SimRequest) -> bool:
        if req.finished:
            return False
        if self._drr is not None:
            removed = self._drr.remove(req)
        else:
            try:
                self._queue.remove(req)
                removed = True
            except ValueError:
                removed = False
        if removed:
            req.finished, req.reason = True, "cancelled"
            self.n_cancelled += 1
            return True
        for s, r in enumerate(self._slots):
            if r is req:
                self._free(s)
                req.finished, req.reason = True, "cancelled"
                self.n_cancelled += 1
                return True
        return False

    # -- KV-page migration (the two-tier router protocol) ---------------

    def migration_nbytes(self, req: SimRequest) -> int:
        """The byte model the live scheduler measures: resident KV
        bytes for the tokens this stream has landed so far."""
        return int(
            (req.prompt.length + req.n_emitted)
            * self.kv_bytes_per_token
        )

    def migrate_out(self, req: SimRequest,
                    reason: str = "prefill_done") -> SimTicket:
        """Freeze a decoding request into a ticket and free its slot
        (residency drops with it — the pages leave). The request must
        be past its first token and unfinished, the same migratability
        contract as ``ServingScheduler.export_page_state``."""
        if req.finished or req.n_emitted < 1:
            raise ValueError(
                "migrate_out: request must be decoding (first token "
                "emitted, not finished)"
            )
        for s, r in enumerate(self._slots):
            if r is req and not self._prefill[s]:
                self._free(s)
                self.n_migrated_out += 1
                toks = req.prompt.length + req.n_emitted
                return SimTicket(
                    req, self.migration_nbytes(req),
                    -(-toks // self.page_tokens), reason,
                )
        raise ValueError(
            "migrate_out: request is not decoding in a slot here"
        )

    def can_adopt(self, ticket: SimTicket) -> bool:
        return self.alive

    def adopt(self, ticket: SimTicket) -> SimRequest:
        """Land a migrated request: re-queued with ``migrated=True``
        so admission takes a slot without any prefill chunks and
        decode continues from ``n_emitted`` — the page adoption's
        timing skeleton. Returns the SAME request object (in-process
        stream continuity, like the live fast path)."""
        if not self.alive:
            raise RuntimeError(
                "adopt on a killed SimReplica: the router must not "
                "land migrations on an unroutable replica"
            )
        req = ticket.request
        req.migrated = True
        req._holds_prefix = None  # residency re-established at admit
        self._enqueue(req)
        self.n_adopted += 1
        if self.next_tick_at is None:
            self.next_tick_at = (
                self.clock.now() + self._tick_s(self.tick_count)
            )
        return req

    def step(self) -> list[SimRequest]:
        """One scheduler tick, fired only when due (the router steps
        every busy replica; a not-yet-due sim replica must be a no-op
        or fleet timing would serialize). Returns the requests retired
        in the tick."""
        now = self.clock.now()
        if self.next_tick_at is None or self.next_tick_at > now + 1e-12:
            return []
        self.tick_count += 1
        self.last_tick_at = now
        retired: list[SimRequest] = []
        # ONE pass over the slots (this loop is the hot half of a
        # million-request day; three separate admit/prefill/decode
        # passes measured ~2x): slots are independent, so the fused
        # per-slot dispatch preserves the real scheduler's tick
        # semantics — an admitting slot advances exactly one chunk, a
        # newly admitted slot runs its first chunk this very tick, and
        # neither decodes until a later tick.
        queue = self._queue
        drr = self._drr
        slots = self._slots
        prefill = self._prefill
        n_inner = self.n_inner
        trace = self._trace  # hoisted: dark ticks pay one local read
        n_chunks = 0  # prefill chunks advanced this tick (chunk_s)
        for s in range(self.S):
            req = slots[s]
            if req is None:
                # admit (first chunk runs this very tick): FIFO, or
                # the deficit-round-robin pick under qos= — the same
                # admission-order hook the real scheduler carries
                if drr is not None:
                    picked = drr.pick()
                    if picked is None:
                        continue
                    req = picked[1]
                elif queue:
                    req = queue.popleft()
                else:
                    continue
                p = req.prompt
                if req.migrated:
                    # page adoption: NO prefill — the KV pages arrived
                    # with the request; residency (if any) transfers
                    # here and decode continues from n_emitted on the
                    # next tick
                    if p.prefix is not None:
                        held = self._resident.get(p.prefix, 0)
                        if held == 0 and self.cache is not None:
                            self.cache.publish_hbm(
                                self.cache_name, p.prefix
                            )
                        self._resident[p.prefix] = held + 1
                        req._holds_prefix = p.prefix
                    slots[s] = req
                    self._n_active += 1
                    req.admitted_tick = self.tick_count
                    prefill[s] = 0
                    continue
                skip = 0
                if p.prefix is not None:
                    held = self._resident.get(p.prefix, 0)
                    if held:
                        skip = p.prefix_len
                        self.n_shared_admits += 1
                    elif self.cache is not None:
                        # local miss: probe the fleet — a DRAM or peer
                        # hit skips the shared chunks at a priced
                        # transfer cost instead of re-prefilling them
                        got = self.cache.fetch(
                            p.prefix, p.prefix_len,
                            exclude=self.cache_name,
                        )
                        if got is not None:
                            skip = p.prefix_len
                            self.n_fleet_hits += 1
                            self._xfer_s += got[1]
                    if held == 0 and self.cache is not None:
                        self.cache.publish_hbm(
                            self.cache_name, p.prefix
                        )
                    self._resident[p.prefix] = held + 1
                    req._holds_prefix = p.prefix
                chunks = max(-(-(p.length - skip) // self.C), 1)
                slots[s] = req
                self._n_active += 1
                # admission stamp at PLACEMENT (the real scheduler's
                # semantics: queue wait ends when the slot is taken,
                # not when prefill lands) — the router's queue-wait
                # histogram reads this
                req.admitted_tick = self.tick_count
                prefill[s] = chunks - 1
                n_chunks += 1  # the first chunk's work
                if trace is not None and req.trace is not None:
                    trace.event(
                        req.trace, "prefill_chunk", now,
                        tick=self.tick_count,
                    )
                if chunks == 1:
                    req.n_emitted = 1
                    if req.max_new == 1:
                        self._retire(s, req, retired)
                continue
            pf = prefill[s]
            if pf:
                # advance the admission one chunk
                prefill[s] = pf - 1
                n_chunks += 1
                if trace is not None and req.trace is not None:
                    trace.event(
                        req.trace, "prefill_chunk", now,
                        tick=self.tick_count,
                    )
                if pf == 1:
                    req.n_emitted = 1  # first token, last chunk
                    if req.max_new == 1:
                        self._retire(s, req, retired)
                continue
            # decode n_inner tokens
            ne = req.n_emitted + n_inner
            if ne >= req.max_new:
                req.n_emitted = req.max_new
                self._retire(s, req, retired)
            else:
                req.n_emitted = ne
        if queue or self._n_active or (drr is not None and drr.total):
            dt = self._tick_s(self.tick_count)
            if n_chunks and self.chunk_s:
                # prefill work stretches THIS tick: the real
                # scheduler's per-admitting-slot _extend cost, the
                # contention disaggregation removes
                dt += self.chunk_s * n_chunks
            if self._xfer_s:
                # fleet-cache page movement (fetches this tick, spills
                # from the last retires): the modeled DMA/ring seconds
                # stretch this tick the same way prefill work does
                dt += self._xfer_s
                self._xfer_s = 0.0
            self.next_tick_at = now + dt
            self.busy_s += dt
        else:
            self.next_tick_at = None
        return retired

    # -- internals --------------------------------------------------------

    def _retire(self, s: int, req: SimRequest, out: list) -> None:
        req.finished = True
        req.reason = "length"
        self.n_retired += 1
        out.append(req)
        self._free(s)

    def _free(self, s: int) -> None:
        req = self._slots[s]
        self._slots[s] = None
        self._prefill[s] = 0
        self._n_active -= 1
        if req is not None and req._holds_prefix is not None:
            g = req._holds_prefix
            left = self._resident.get(g, 0) - 1
            if left > 0:
                self._resident[g] = left
            else:
                self._resident.pop(g, None)
                if self.cache is not None:
                    # last holder gone: the fleet withdraws the HBM
                    # advertisement and may spill the group to DRAM —
                    # the priced cost lands on the next busy tick
                    self._xfer_s += self.cache.residency_lost(
                        self.cache_name, g, req.prompt.prefix_len
                    )

    # -- fault injection --------------------------------------------------

    def kill(self) -> None:
        """Replica death: wipe all state; in-flight requests freeze
        (never ``finished`` — the router's health probe re-routes
        them, which is the zero-drop contract under test)."""
        self.alive = False
        self._queue.clear()
        if self._drr is not None:
            self._drr.clear()
        self._slots = [None] * self.S
        self._prefill = [0] * self.S
        self._n_active = 0
        self._resident.clear()
        self._xfer_s = 0.0
        if self.cache is not None:
            # device memory died with the process: HBM advertisements
            # purge; DRAM spills survive for the fleet
            self.cache.drop_replica(self.cache_name)
        self.next_tick_at = None

    def revive(self) -> None:
        self.alive = True
        if self.cache is not None:
            # a respawn is a NEW fleet identity (the live directory's
            # generation bump): stale advertisements can never revive
            self.cache_name = self.cache.register(self)

    def __repr__(self) -> str:
        return (
            f"SimReplica(S={self.S}, pending={self.pending}, "
            f"active={self.active}, "
            f"{'alive' if self.alive else 'dead'})"
        )


class WorkloadReport:
    """Per-request outcome of one simulated day: TTFT / completion
    latency arrays (virtual seconds, in submission order), outcome
    counts, hedge/re-route totals, and :meth:`digest` — a content hash
    of the latency arrays, the one-line bit-identity witness two runs
    of the same scenario must agree on."""

    def __init__(self, requests: list, virtual_s: float, router,
                 controller=None, n_resubmits: int = 0,
                 n_events: int | None = None,
                 wall_s: float | None = None):
        self.requests = requests
        self.n = len(requests)
        self.virtual_s = float(virtual_s)
        # sim-plane throughput self-measurement: events =
        # submits + fleet ticks, wall from an INJECTED timer (no OS clock:
        # sim/ never reads the OS clock itself). All OUTSIDE digest().
        self.n_events = None if n_events is None else int(n_events)
        self.wall_s = None if wall_s is None else float(wall_s)
        self.events_per_s = (
            None
            if (self.n_events is None or self.wall_s is None
                or self.wall_s <= 0.0)
            else self.n_events / self.wall_s
        )
        # which execution mode produced this report ("scalar" here;
        # sim/fastpath.py overwrites with "vectorized" or a
        # "scalar-fallback: <reason>" tag) — observability only
        self.fastpath = "scalar"
        # chaos-plane counters, all OUTSIDE digest() (the bit-identity
        # witness keeps its latency-array definition): retry-client
        # resubmissions, partition begins/heals, and stale legs the
        # heals withdrew
        self.n_resubmits = int(n_resubmits)
        self.n_partitions = getattr(router, "n_partitions", 0)
        self.n_stale_cancelled = getattr(
            router, "n_stale_cancelled", 0
        )
        # control-plane counters (0 without a controller): how often
        # the fleet resized and how many coordinator takeovers the day
        # survived. NOT part of digest() — the bit-identity witness
        # keeps its latency-array definition, so a no-event day hashes
        # exactly as it did before the control plane existed.
        self.n_resizes = (
            0 if controller is None else int(controller.n_resizes)
        )
        self.n_failovers = (
            0 if controller is None else int(controller.n_failovers)
        )
        # the latency arrays cover SERVED requests: a shed request
        # (refused at the door, QoS plane) has no TTFT to measure and
        # must not poison the percentile/digest arrays. A tenant-less
        # day sheds nothing, so every pre-QoS digest is byte-for-byte
        # unchanged.
        served = [r for r in requests if r.outcome != "shed"]
        self.ttft = np.asarray([r.ttft for r in served], np.float64)
        self.latency = np.asarray(
            [r.latency for r in served], np.float64
        )
        self.outcomes: dict[str, int] = {}
        self.shed_reasons: dict[str, int] = {}
        for r in requests:
            self.outcomes[r.outcome] = self.outcomes.get(r.outcome, 0) + 1
            sr = getattr(r, "shed_reason", None)
            if sr is not None:
                self.shed_reasons[sr] = self.shed_reasons.get(sr, 0) + 1
        self.n_hedges = router.n_hedges
        self.n_rerouted = router.n_rerouted
        self.n_migrated = getattr(router, "n_migrated", 0)
        self.n_kept_local = getattr(router, "n_kept_local", 0)
        self.n_shed = getattr(router, "n_shed", 0)
        self.n_hedges_refused = getattr(router, "n_hedges_refused", 0)
        self.dropped = sum(not r.finished for r in requests)
        # per-request mean inter-token gap (first token -> done over
        # the decode tokens): the decode-steadiness distribution the
        # disaggregation claim is about. NOT part of digest() — the
        # bit-identity witness keeps its original definition.
        itl = []
        for r in requests:
            n = len(r.tokens)
            if (r.t_first_token is not None and r.t_done is not None
                    and n > 1):
                itl.append(
                    (r.t_done - r.t_first_token) / (n - 1)
                )
        self.decode_itl = np.asarray(itl, np.float64)

    @classmethod
    def from_arrays(cls, requests, virtual_s: float, router, *,
                    ttft, latency, outcomes: dict, shed_reasons: dict,
                    dropped: int, decode_itl, n_resubmits: int = 0,
                    n_events: int | None = None,
                    wall_s: float | None = None) -> "WorkloadReport":
        """Array-native constructor for the vectorized day driver
        (sim/fastpath.py): the witness arrays (``ttft`` / ``latency``,
        float64, served requests in submission order) and the outcome
        books arrive precomputed instead of being re-derived from a
        million per-request records. The witness fields are assigned
        HERE — in this module — for both execution paths, so the
        digest definition has a single source of truth. ``requests``
        may be any sequence of request views
        exposing the per-request attributes the sweeps read."""
        rep = cls.__new__(cls)
        rep.requests = requests
        rep.n = len(requests)
        rep.virtual_s = float(virtual_s)
        rep.n_resubmits = int(n_resubmits)
        rep.n_partitions = getattr(router, "n_partitions", 0)
        rep.n_stale_cancelled = getattr(router, "n_stale_cancelled", 0)
        rep.n_resizes = 0
        rep.n_failovers = 0
        rep.n_events = None if n_events is None else int(n_events)
        rep.wall_s = None if wall_s is None else float(wall_s)
        rep.events_per_s = (
            None
            if (rep.n_events is None or rep.wall_s is None
                or rep.wall_s <= 0.0)
            else rep.n_events / rep.wall_s
        )
        rep.fastpath = "scalar"
        rep.ttft = np.asarray(ttft, np.float64)
        rep.latency = np.asarray(latency, np.float64)
        rep.outcomes = dict(outcomes)
        rep.shed_reasons = dict(shed_reasons)
        rep.n_hedges = router.n_hedges
        rep.n_rerouted = router.n_rerouted
        rep.n_migrated = getattr(router, "n_migrated", 0)
        rep.n_kept_local = getattr(router, "n_kept_local", 0)
        rep.n_shed = getattr(router, "n_shed", 0)
        rep.n_hedges_refused = getattr(router, "n_hedges_refused", 0)
        rep.dropped = int(dropped)
        rep.decode_itl = np.asarray(decode_itl, np.float64)
        return rep

    def p50_ttft(self) -> float:
        return float(np.percentile(self.ttft, 50))

    def p99_ttft(self) -> float:
        return float(np.percentile(self.ttft, 99))

    def p99_decode_itl(self) -> float:
        """p99 of the per-request mean inter-token gap — decode p99,
        the tail a long-prompt burst wrecks on a unified fleet."""
        if self.decode_itl.size == 0:
            return 0.0
        return float(np.percentile(self.decode_itl, 99))

    def per_tenant(self) -> dict[str, dict]:
        """Per-tenant breakdown (QoS plane): request/shed counts and
        TTFT p50/p99 over the tenant's SERVED requests. OUTSIDE
        :meth:`digest` — the bit-identity witness keeps its
        latency-array definition; a tenant-free day returns ``{}``."""
        acc: dict[str, dict] = {}
        for r in self.requests:
            t = getattr(r, "tenant", None)
            if t is None:
                continue
            d = acc.setdefault(t, {"n": 0, "shed": 0, "_ttft": []})
            d["n"] += 1
            if r.outcome == "shed":
                d["shed"] += 1
            elif r.ttft is not None:
                d["_ttft"].append(r.ttft)
        out: dict[str, dict] = {}
        for t, d in acc.items():
            a = np.asarray(d.pop("_ttft"), np.float64)
            out[t] = {
                "n": d["n"],
                "shed": d["shed"],
                "served": int(a.size),
                "p50_ttft_s": (
                    float(np.percentile(a, 50)) if a.size else 0.0
                ),
                "p99_ttft_s": (
                    float(np.percentile(a, 99)) if a.size else 0.0
                ),
                "mean_ttft_s": float(a.mean()) if a.size else 0.0,
            }
        return out

    def digest(self) -> str:
        import hashlib

        h = hashlib.sha256()
        h.update(self.ttft.tobytes())
        h.update(self.latency.tobytes())
        return h.hexdigest()[:16]

    def __repr__(self) -> str:
        return (
            f"WorkloadReport(n={self.n}, "
            f"p99_ttft={self.p99_ttft() * 1e3:.1f}ms, "
            f"virtual={self.virtual_s:.1f}s, "
            f"outcomes={self.outcomes})"
        )


def run_router_day(
    router, arrivals: Iterable[Arrival], *,
    controller=None, events: Iterable = (), retry: RetryPolicy | None = None,
    timer: Callable[[], float] | None = None,
    series=None, slo=None,
) -> WorkloadReport:
    """Drive a virtual-time :class:`~..models.router.RequestRouter`
    through an arrival stream to completion: advance the clock to each
    arrival (stepping the router at every replica tick, hedge
    deadline, and scheduled clock event in between — ``clock.call_at``
    kill/recover injections fire exactly on time), submit, then drain.
    Every submitted request completes (the router's zero-drop
    contract); the report's :meth:`~WorkloadReport.digest` is
    bit-identical across runs of the same scenario.

    ``controller=`` attaches the fleet control plane (a
    :class:`~..fleet.FleetController`, or its
    :class:`~..fleet.ControllerSupervisor` active/standby wrapper —
    anything with ``observe_arrival`` / ``step`` / ``next_event_at``):
    every arrival feeds its rate estimator, and the driver advances
    the clock to the controller's decision/checkpoint/takeover cadence
    exactly like replica ticks — a whole autoscaling day stays
    bit-identical. ``events=`` interleaves control-plane events
    (:class:`FleetResize`, :class:`CoordinatorKill`) into the stream;
    an event due at ``t`` fires before an arrival stamped ``t``. With
    neither, the drive loop is byte-for-byte the uncontrolled one, so
    recorded digests still hold.

    ``retry=`` attaches a :class:`RetryPolicy` client model (chaos
    plane): a submitted request showing no first token by its timeout
    is resubmitted as a fresh arrival feeding back into THIS day's
    stream on the policy's seeded coin — the retry storm replays
    bit-identically, every attempt lands in the report (and its
    digest), and ``WorkloadReport.n_resubmits`` counts the
    amplification. Shed requests are never retried. ``retry=None``
    keeps the drive loop event-for-event the fault-free one.

    ``timer=`` (e.g. ``time.perf_counter``) opts into events/s
    self-measurement: the report's ``n_events`` (submits + fleet
    ticks), ``wall_s``, and ``events_per_s`` fill in, all OUTSIDE
    :meth:`~WorkloadReport.digest`. The timer is injected because
    sim/ never reads the OS clock itself (tests/test_torch_imports.py pins it).

    ``series=`` / ``slo=`` attach the windowed SLO plane (a
    :class:`~..obs.SeriesStore` and/or :class:`~..obs.SloPolicy`):
    the driver calls their ``maybe_roll(now)`` with the day clock at
    every drive-loop point it already visits — after each fleet step
    and each submit — so window rollover is digest-neutral by
    construction: no clock event is ever scheduled and no router or
    replica state is touched; the stores only READ the registry.
    Dark (both None), the loop is event-for-event the unwindowed
    one."""
    wall_t0 = timer() if timer is not None else None
    clock = router.clock
    if clock is None:
        raise ValueError(
            "run_router_day needs a VirtualClock router (clock=...); "
            "live fleets run router.step() in their own serving loop"
        )

    # the clock's event heap is peeked directly (package-internal by
    # design): this driver is the clock's single thread, and the locked
    # clock.next_event() measured ~8% of a million-request day
    heap = clock._heap
    ctl = controller
    # windowed SLO plane: one bound rollover callable (or
    # None, keeping the dark drive loop branch-cheap); rolls happen
    # only at points the dark loop already visits, so the day's
    # digest is untouched by construction
    obs_roll = None
    if series is not None or slo is not None:
        if slo is not None and (series is None or slo.series is series):
            _store, _roll = slo.series, slo.maybe_roll
        elif series is not None and slo is None:
            _store, _roll = series, series.maybe_roll
        else:
            # distinct stores bound at once (unusual): roll both; no
            # shared boundary to fast-path on
            _store = None

            def _roll(now_v):
                if series is not None:
                    series.maybe_roll(now_v)
                if slo is not None:
                    slo.maybe_roll(now_v)

        if _store is not None:
            from ..obs.series import _EPS as _w_eps

            _w_s = _store.window_s

            def obs_roll(now_v):
                # called at every step/submit with the loop's current
                # virtual time; crossing a boundary is rare, so the
                # common case is one compare against the open window's
                # start (package-internal peek, same license as
                # clock._heap above)
                t0 = _store._t0
                if t0 is None or now_v - t0 + _w_eps >= _w_s:
                    _roll(now_v)
        else:
            obs_roll = _roll
    # retry-client state (chaos plane): a heap of (due, submit-index,
    # request, attempt) timeout checks; empty and untouched when
    # retry=None, keeping the drive loop event-for-event the fault-free one
    rheap: list = []
    n_resubmits = 0

    def next_at():
        nt = router.next_event_at()
        if heap:
            ce = heap[0][0]
            if nt is None or ce < nt:
                nt = ce
        if ctl is not None:
            ct = ctl.next_event_at()
            if ct is not None and (nt is None or ct < nt):
                nt = ct
        if rheap:
            rt = rheap[0][0]
            if nt is None or rt < nt:
                nt = rt
        return nt

    submitted = []
    append = submitted.append
    run_until, step = clock.run_until, router.step
    submit, replicas = router.submit, router.replicas
    ttft_slo = router.ttft_slo
    evs = sorted(events, key=lambda e: e.t)
    ei = 0
    n_evs = len(evs)
    # `nt` (the next event time) is maintained INCREMENTALLY across
    # arrivals: a full next_at() per arrival measured ~25% of a
    # million-request day, and a submit can only add two event kinds —
    # its replica's (possibly fresh) tick and its own hedge deadline
    # (the controller's cadence is monotone and re-read at every full
    # next_at(), so the incremental path never skips past it)
    nt = next_at()

    def arm_retry(rr, attempt):
        # park the client's timeout check; the due time (timeout +
        # seeded jitter) is an event the driver advances to exactly
        nonlocal nt
        idx = router.n_submitted  # day-local, deterministic
        due = retry.resubmit_at(rr.t_submit, idx, attempt)
        heapq.heappush(rheap, (due, idx, rr, attempt))
        if nt is None or due < nt:
            nt = due

    def fire_retries():
        # due timeout checks: a request still showing no first token
        # is resubmitted as a fresh arrival (feedback — the storm);
        # resolved or exhausted chains just expire
        nonlocal n_resubmits
        now_v = clock.now()
        while rheap and rheap[0][0] <= now_v + 1e-12:
            _due, _idx, rr0, attempt = heapq.heappop(rheap)
            if rr0.finished or rr0.t_first_token is not None:
                continue
            if attempt + 1 > retry.max_retries:
                continue
            rr = submit(rr0.prompt, rr0.max_new, key=rr0.key,
                        tenant=rr0.tenant)
            append(rr)
            n_resubmits += 1
            tb = router._trace
            if (tb is not None and rr.trace is not None
                    and rr0.trace is not None):
                # the child trace links back to the timed-out parent:
                # the retry CLIENT alone knows the chain
                tb.link(rr.trace, rr0.trace)
                tb.event(
                    rr.trace, "retry_resubmit", now_v,
                    parent=rr0.trace, attempt=attempt + 1,
                )
            if ctl is not None:
                ctl.observe_arrival(now_v)
            if rr.finished:
                continue  # shed at the door: the client backs off
            arm_retry(rr, attempt + 1)

    def advance_to(t):
        # step the fleet (and the controller, when attached) at every
        # due tick up to virtual time t, then land exactly on t
        nonlocal nt
        while nt is not None and nt <= t:
            run_until(nt)
            step()
            if ctl is not None:
                ctl.step()
            if rheap:
                fire_retries()
            if obs_roll is not None:
                obs_roll(nt)
            nt = next_at()
        run_until(t)
        if obs_roll is not None:
            obs_roll(t)

    def fire_events_through(t):
        # control-plane events due at or before t, in stream order
        nonlocal ei, nt
        while ei < n_evs and evs[ei].t <= t:
            e = evs[ei]
            advance_to(e.t)
            e.fire(router, ctl)
            ei += 1
            nt = next_at()

    for a in arrivals:
        at = a.t
        if ei < n_evs:
            fire_events_through(at)
        while nt is not None and nt <= at:
            run_until(nt)
            step()
            if ctl is not None:
                ctl.step()
            if rheap:
                fire_retries()
            if obs_roll is not None:
                obs_roll(nt)
            nt = next_at()
        run_until(at)
        rr = submit(a.prompt, a.max_new, tenant=a.tenant)
        append(rr)
        if ctl is not None:
            ctl.observe_arrival(at)
        if obs_roll is not None:
            obs_roll(at)
        if rr.finished:
            continue  # shed at the door: no leg, no events to add
        t = getattr(replicas[rr.replica], "next_tick_at", None)
        if t is not None and (nt is None or t < nt):
            nt = t
        if ttft_slo is not None:
            d = rr.t_submit + ttft_slo
            if nt is None or d < nt:
                nt = d
        if retry is not None:
            arm_retry(rr, 0)
    if ei < n_evs:
        # events past the last arrival (an end-of-day kill, a scale-in
        # order): fire them at their times, stepping normally between
        fire_events_through(evs[-1].t)
    # a controller's decision cadence is ALWAYS pending, so with one
    # attached next_at() never returns None and the no-event stall
    # check below can't fire — count barren drain rounds instead
    # (controller stepped, router stepped, yet no replica tick / hedge
    # deadline / clock event appeared and nothing completed) and fail
    # by name after a few, the same contract as the bare stall
    barren = 0
    while router.in_flight:
        nt = next_at()
        if nt is None:
            raise RuntimeError(
                f"workload stalled with {router.in_flight} requests "
                "in flight: no replica tick, hedge deadline, or clock "
                "event pending (every replica down with nothing "
                "scheduled to revive one?)"
            )
        inflight_before = router.in_flight
        clock.run_until(nt)
        router.step()
        if rheap:
            fire_retries()
        if obs_roll is not None:
            obs_roll(nt)
        if ctl is not None:
            ctl.step()
            if (
                router.next_event_at() is None and not heap
                and router.in_flight == inflight_before
            ):
                barren += 1
                if barren >= 3:
                    raise RuntimeError(
                        f"workload stalled with {router.in_flight} "
                        "requests in flight: 3 controller decision "
                        "intervals passed with no replica tick, hedge "
                        "deadline, or clock event and no completion — "
                        "the controller cannot restore a replica it "
                        "never drained (every replica down?)"
                    )
            else:
                barren = 0
    n_events = router.n_submitted + sum(
        getattr(r, "tick_count", 0) for r in router.replicas
    )
    wall = None if wall_t0 is None else timer() - wall_t0
    return WorkloadReport(submitted, clock.now(), router, ctl,
                          n_resubmits=n_resubmits, n_events=n_events,
                          wall_s=wall)
