"""Tenant contracts: the per-tenant half of the QoS plane.

A copy of the JAX package's ``qos/tenancy.py`` (stdlib only).

A tenant is a contract, not a code path: everything the fleet does
differently per tenant is read off one :class:`TenantContract` —
which SLO class it bought (``latency`` | ``throughput`` | ``batch``),
how much of the fleet it is entitled to (``weight``, the
deficit-round-robin share :class:`~.drr.DeficitScheduler` enforces),
how many tokens per second it may inject (``rate``/``burst``, a
:class:`TokenBucket` the router charges at submit), how many KV-cache
pages it may hold (``pages``, enforced at admission plan time with
COW-aware reclaim), and how many TTFT hedges it may have outstanding
(``hedges``, so one tenant's deadline panic cannot spend another's
slack).

Sheddability follows the class: a ``batch`` tenant over its token
budget is shed by name (``outcome == "shed"``, counted per tenant and
reason) — batch work retries; ``latency`` and ``throughput`` tenants
are never shed, they are *paced* instead (the deficit scheduler caps
their share, so an over-budget interactive tenant queues behind its
own weight rather than being dropped or starving anyone else).

Everything here is pure host bookkeeping on an INJECTED clock:
:meth:`TokenBucket.take` refills from the ``now`` the caller passes
(the router's clock — virtual seconds in sim, ``perf_counter`` live),
never from an OS clock, so a tenant-mixed day replays bit-identically.
"""

from __future__ import annotations

__all__ = [
    "SLO_CLASSES",
    "SHED_ORDER",
    "shed_rank",
    "TenantContract",
    "TenantRegistry",
    "TokenBucket",
]

SLO_CLASSES = ("latency", "throughput", "batch")

#: Overload shed order (chaos plane): when the fleet must drop work to
#: keep its queues bounded, classes are shed in THIS order — batch
#: first (its work retries), latency last (its work is a user staring
#: at a spinner). The budget door's shed rule (only ``batch`` sheds,
#: interactive classes are paced) is the rank-0 prefix of this order;
#: the router's soft overload ceiling sheds rank 0, and only the hard
#: ceiling — the bounded-queue guarantee under offered load past 1 —
#: sheds every rank, each by name.
SHED_ORDER = ("batch", "throughput", "latency")


def shed_rank(cls: str) -> int:
    """Position of an SLO class in :data:`SHED_ORDER` (0 sheds first).
    Unknown classes are refused by name, never ranked by guess."""
    try:
        return SHED_ORDER.index(cls)
    except ValueError:
        raise ValueError(
            f"unknown SLO class {cls!r}; choose one of {SLO_CLASSES}"
        ) from None


class TenantContract:
    """One tenant's contract (module docstring for field semantics).

    ``rate`` is a token-rate budget in tokens per clock second
    (``None`` = unlimited); ``burst`` is the bucket depth in tokens
    (default: one second of ``rate``). ``pages`` is the KV page-pool
    quota (``None`` = unlimited). ``spill_pages`` extends the page
    quota to the host-DRAM spill tier (cache/ package): how many of
    the tenant's evicted cold pages the fleet page store may keep
    resident at once (``None`` = unlimited — the store's own capacity
    still bounds it; enforced the same way as cold-page reclaim: the
    tenant's OWN oldest spilled page is evicted first). ``hedges``
    caps OUTSTANDING TTFT-hedge legs (``None`` = unlimited, ``0`` =
    never hedge). ``ttft_slo`` is the advertised first-token deadline
    the sweeps validate latency-class contracts against — a latency
    tenant without one is refused by ``sweep_tenant_weights``, never
    guessed.
    """

    __slots__ = ("name", "cls", "weight", "rate", "burst", "pages",
                 "spill_pages", "hedges", "ttft_slo")

    def __init__(self, name: str, *, cls: str = "throughput",
                 weight: float = 1.0, rate: float | None = None,
                 burst: float | None = None, pages: int | None = None,
                 spill_pages: int | None = None,
                 hedges: int | None = None,
                 ttft_slo: float | None = None):
        if not name or not isinstance(name, str):
            raise ValueError(f"tenant name must be a non-empty str, "
                             f"got {name!r}")
        if cls not in SLO_CLASSES:
            raise ValueError(
                f"unknown SLO class {cls!r} for tenant {name!r}; "
                f"choose one of {SLO_CLASSES}"
            )
        if not weight > 0:
            raise ValueError(
                f"tenant {name!r} weight must be > 0 (it is the DRR "
                f"share), got {weight}"
            )
        if rate is not None and not rate > 0:
            raise ValueError(
                f"tenant {name!r} token rate must be > 0 or None "
                f"(unlimited), got {rate}"
            )
        if burst is not None and rate is None:
            raise ValueError(
                f"tenant {name!r} has burst without rate: a bucket "
                "depth needs a refill rate"
            )
        if burst is not None and not burst > 0:
            raise ValueError(
                f"tenant {name!r} burst must be > 0, got {burst}"
            )
        if pages is not None and pages < 1:
            raise ValueError(
                f"tenant {name!r} page quota must be >= 1 or None "
                f"(unlimited), got {pages}"
            )
        if spill_pages is not None and spill_pages < 0:
            raise ValueError(
                f"tenant {name!r} spill-page quota must be >= 0 or "
                f"None (unlimited; 0 = never spill for this tenant), "
                f"got {spill_pages}"
            )
        if hedges is not None and hedges < 0:
            raise ValueError(
                f"tenant {name!r} hedge entitlement must be >= 0 or "
                f"None (unlimited), got {hedges}"
            )
        if ttft_slo is not None and not ttft_slo > 0:
            raise ValueError(
                f"tenant {name!r} ttft_slo must be > 0, got {ttft_slo}"
            )
        self.name = name
        self.cls = cls
        self.weight = float(weight)
        self.rate = None if rate is None else float(rate)
        self.burst = (
            self.rate if burst is None and rate is not None
            else (None if burst is None else float(burst))
        )
        self.pages = None if pages is None else int(pages)
        self.spill_pages = (
            None if spill_pages is None else int(spill_pages)
        )
        self.hedges = None if hedges is None else int(hedges)
        self.ttft_slo = None if ttft_slo is None else float(ttft_slo)

    @property
    def sheddable(self) -> bool:
        """Over-budget requests of this tenant may be dropped by name
        (``batch`` class only — batch work retries; interactive
        classes are paced by their DRR weight instead). Under fleet
        OVERLOAD the hard queue-depth ceiling sheds every class
        rather than queue unboundedly — but always in
        :data:`SHED_ORDER`, batch first, and always by name."""
        return self.cls == "batch"

    @property
    def shed_rank(self) -> int:
        """This contract's position in :data:`SHED_ORDER` (0 sheds
        first under overload)."""
        return shed_rank(self.cls)

    def bucket(self) -> "TokenBucket | None":
        """A fresh token bucket for this contract, or None when the
        contract carries no rate budget."""
        if self.rate is None:
            return None
        return TokenBucket(self.rate, self.burst)

    def __repr__(self) -> str:
        return (
            f"TenantContract({self.name!r}, cls={self.cls!r}, "
            f"weight={self.weight}, rate={self.rate}, "
            f"pages={self.pages}, hedges={self.hedges})"
        )


class TokenBucket:
    """Token-rate budget with refill, pure in the injected clock:
    ``take(cost, now)`` refills ``rate * (now - last_now)`` (capped at
    ``burst``) and then takes ``cost`` tokens if they are there. The
    first call anchors the refill clock — callers pass the SAME clock
    every time (the router's), which is what makes a tenant-mixed day
    replay bit-identically on :class:`~..sim.clock.VirtualClock`."""

    __slots__ = ("rate", "burst", "tokens", "_last")

    def __init__(self, rate: float, burst: float):
        if not rate > 0 or not burst > 0:
            raise ValueError(
                f"need rate > 0 and burst > 0, got ({rate}, {burst})"
            )
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)  # a fresh tenant starts full
        self._last: float | None = None

    def _refill(self, now: float) -> None:
        if self._last is None:
            self._last = now
            return
        if now > self._last:
            self.tokens = min(
                self.burst, self.tokens + self.rate * (now - self._last)
            )
            self._last = now

    def level(self, now: float) -> float:
        """Tokens available at ``now`` (refilled, nothing taken)."""
        self._refill(now)
        return self.tokens

    def take(self, cost: float, now: float) -> bool:
        """Charge ``cost`` tokens at ``now``; False (nothing taken)
        when the bucket cannot cover it — the caller's shed/pace
        decision point."""
        self._refill(now)
        if self.tokens + 1e-12 < cost:
            return False
        self.tokens -= cost
        return True


class TenantRegistry:
    """The fleet's tenant book: contracts by name, in registration
    order (the order is the DRR rotation order, so it is part of the
    deterministic-replay contract — never hash order). One registry is
    shared by every plane that reads contracts: the scheduler's
    deficit admission, the router's budget/hedge enforcement, and the
    sweeps' feasibility checks."""

    def __init__(self, contracts: "tuple[TenantContract, ...] | list" = ()):
        self._by_name: dict[str, TenantContract] = {}
        for c in contracts:
            self.add(c)

    def add(self, contract: TenantContract) -> TenantContract:
        if contract.name in self._by_name:
            raise ValueError(
                f"tenant {contract.name!r} already registered; update "
                "means a new registry, not a silent overwrite"
            )
        self._by_name[contract.name] = contract
        return contract

    def get(self, name: str) -> TenantContract:
        c = self._by_name.get(name)
        if c is None:
            raise KeyError(
                f"unknown tenant {name!r}: register a TenantContract "
                f"for it (known: {sorted(self._by_name)})"
            )
        return c

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __iter__(self):
        return iter(self._by_name.values())

    def __len__(self) -> int:
        return len(self._by_name)

    def names(self) -> list[str]:
        return list(self._by_name)

    def buckets(self) -> dict[str, TokenBucket]:
        """Fresh token buckets for every rate-budgeted tenant — the
        router builds its runtime charge state here."""
        out = {}
        for c in self._by_name.values():
            b = c.bucket()
            if b is not None:
                out[c.name] = b
        return out

    def aggregate_rate(self) -> float | None:
        """Sum of the registered token-rate budgets, or None when any
        tenant is unlimited (the sum is then unbounded) — the
        feasibility number ``sweep_tenant_weights`` checks against
        fleet capacity."""
        total = 0.0
        for c in self._by_name.values():
            if c.rate is None:
                return None
            total += c.rate
        return total

    def __repr__(self) -> str:
        return f"TenantRegistry({self.names()})"
