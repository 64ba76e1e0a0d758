"""Weighted deficit-round-robin admission: fairness as arithmetic.

A copy of the JAX package's ``qos/drr.py`` (stdlib only): the same
tenants, weights and costs pick in the same order in either package.

FIFO admission has one failure mode at fleet scale: a heavy tenant's
queue IS the queue, and everyone else's requests age behind it. The
classic fix (Shreedhar & Varghese's deficit round robin) keeps one
queue per tenant and serves them in a fixed rotation, each visit
granting the tenant a quantum of credit proportional to its contract
weight; a request is admitted when the tenant's accumulated credit
(its *deficit counter*) covers the request's cost. Two properties fall
out by construction, and both are what the QoS plane's tests pin:

* **work conservation** — the rotation only ever stops at a tenant
  with something queued, so idle capacity always serves whoever is
  waiting: an admission slot is never held empty in the name of
  fairness. A lone backlogged tenant receives everything.
* **exact catch-up** — deficit counters CARRY while a tenant stays
  backlogged: a tenant short-changed in one round (its head request
  cost more than its quantum) keeps the credit and is served first
  thereafter, so long-run shares converge to the weight ratio
  *exactly*, not asymptotically-in-expectation. (Credit does not
  survive IDLENESS — the standard DRR forfeit, applied here at the
  moment a tenant re-enters the rotation with fresh backlog:
  :meth:`~DeficitScheduler.enqueue` onto an empty queue zeroes the
  carry, so a burst can never cash in old idle time, while
  :meth:`~DeficitScheduler.restore` — which re-queues a PICKED item
  whose admission plan failed — bypasses the forfeit: a failed pick
  keeps its exact carry, the restored item IS the backlog.)

Cost is in TOKENS (prompt + budget — the same unit as the contracts'
rate budgets), so "fair" means fair chip work, not fair request
counts; with uniform requests the two coincide and a 2:1 weight ratio
admits exactly 2:1. The quantum unit is adaptive by default (the
largest cost seen so far), which keeps every pick O(#tenants): one
visit's grant always affords the head for weights >= 1.

Single-threaded by design (it lives inside a scheduler's tick loop),
pure in its inputs (no clock at all), and deterministic: rotation order is registration order,
never hash order, so a tenant-mixed day replays bit-identically.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Hashable, Iterable

from .tenancy import TenantRegistry

__all__ = ["DeficitScheduler"]


class DeficitScheduler:
    """Per-tenant admission queues under weighted DRR (module
    docstring for the algorithm and its guarantees).

    >>> drr = DeficitScheduler(registry)
    >>> drr.enqueue("acme", req, cost=160)
    >>> tenant, req, cost = drr.pick()     # the next admission
    >>> drr.restore(tenant, req, cost)     # plan failed: put it back

    ``pick(skip=...)`` returns the next ``(tenant, item, cost)`` per
    DRR order, dequeued and charged; tenants in ``skip`` are passed
    over without charge (the scheduler's per-pass deferral set — a
    tenant whose head cannot be planned right now must not block the
    rotation, which is exactly the head-of-line decoupling FIFO
    lacks). ``restore`` undoes one pick — the item returns to the
    FRONT of its queue and the cost is refunded — so a failed
    admission plan costs the tenant nothing."""

    def __init__(self, registry: TenantRegistry, *,
                 quantum_unit: float | None = None):
        self._registry = registry
        if quantum_unit is not None and not quantum_unit > 0:
            raise ValueError(
                f"quantum_unit must be > 0 or None (adaptive: the "
                f"largest cost seen), got {quantum_unit}"
            )
        self._unit = quantum_unit
        self._max_cost = 1.0  # adaptive-unit floor
        self._order: list[str] = []           # rotation = first-seen
        self._queues: dict[str, deque] = {}   # tenant -> (item, cost)
        self._deficit: dict[str, float] = {}
        self._cursor = 0
        self._granted = False  # current cursor already got its visit's quantum
        self._n = 0
        # causal-tracing hook (opt-in): the OWNER's callback
        # — ``hook(kind, tenant, item, cost)`` — fired at enqueue and
        # grant. The scheduler that owns this DRR owns the clock too;
        # qos/ itself stays clock-free
        self._trace_hook = None

    # -- introspection ---------------------------------------------------

    @property
    def total(self) -> int:
        """Queued items across every tenant."""
        return self._n

    def backlog(self, tenant: str) -> int:
        q = self._queues.get(tenant)
        return len(q) if q else 0

    def deficit(self, tenant: str) -> float:
        """The tenant's carried credit (tokens) — the catch-up state
        the exactness tests read and ``qos_deficit`` exports."""
        return self._deficit.get(tenant, 0.0)

    def backlogged(self, skip: Iterable[str] = ()) -> list[str]:
        s = set(skip)
        return [t for t in self._order
                if t not in s and self._queues.get(t)]

    def __bool__(self) -> bool:
        return self._n > 0

    def __iter__(self):
        """Queued items in rotation-then-queue order (cancel scans)."""
        for t in self._order:
            for item, _c in self._queues.get(t, ()):
                yield item

    # -- the queue faces -------------------------------------------------

    def set_trace(self, hook) -> None:
        """Install (or clear, with None) the owner's causal-tracing
        callback: ``hook(kind, tenant, item, cost)`` fires on
        ``drr_queued`` (enqueue) and ``drr_picked`` (grant). The hook
        stamps the owner's TraceBook on the OWNER's clock — this
        module never reads one."""
        self._trace_hook = hook

    def enqueue(self, tenant: str, item: Any, cost: float) -> None:
        """Queue ``item`` for ``tenant`` at ``cost`` tokens. The
        tenant must hold a contract (its weight is the quantum);
        unknown tenants are refused by name, never defaulted."""
        self._registry.get(tenant)  # raises the named KeyError
        if not cost > 0:
            raise ValueError(f"cost must be > 0 tokens, got {cost}")
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
            self._order.append(tenant)
        if not q:
            # fresh backlog after an idle period forfeits any banked
            # credit (module docstring); restore() deliberately does
            # not come through here
            self._deficit[tenant] = 0.0
        q.append((item, float(cost)))
        self._n += 1
        if cost > self._max_cost:
            self._max_cost = float(cost)
        if self._trace_hook is not None:
            self._trace_hook("drr_queued", tenant, item, float(cost))

    def _quantum(self, tenant: str) -> float:
        unit = self._unit if self._unit is not None else self._max_cost
        return self._registry.get(tenant).weight * unit

    def _advance(self) -> None:
        self._cursor = (self._cursor + 1) % max(len(self._order), 1)
        self._granted = False

    def pick(self, skip: Iterable[Hashable] = ()
             ) -> tuple[str, Any, float] | None:
        """Dequeue and charge the next admission per DRR order, or
        None when nothing outside ``skip`` is queued. One quantum is
        granted per visit (lazily — only when the carried deficit does
        not already cover the head), the visit ends when the next head
        is unaffordable, and credit never survives an idle period (a
        fresh enqueue onto an empty queue forfeits the carry — but a
        restore() never does; module docstring)."""
        s = set(skip)
        live = [t for t in self._order
                if t not in s and self._queues.get(t)]
        if not live:
            return None
        # termination: each full rotation grants every live tenant one
        # quantum, so the cheapest live head is affordable within
        # ceil(max_cost / min live quantum) rotations
        minq = min(self._quantum(t) for t in live)
        maxc = max(q[0][1] for t in live
                   for q in (self._queues[t],))
        limit = len(self._order) * (2 + int(maxc / minq))
        for _ in range(limit + 1):
            t = self._order[self._cursor]
            q = self._queues.get(t)
            if q and t not in s:
                item, c = q[0]
                d = self._deficit.get(t, 0.0)
                if d < c and not self._granted:
                    d = d + self._quantum(t)
                    self._deficit[t] = d
                    self._granted = True
                if d >= c:
                    q.popleft()
                    self._n -= 1
                    # the leftover CARRIES even when the queue empties
                    # — forfeiture happens at the next fresh enqueue
                    # (so restore() of a failed pick keeps the exact
                    # carry instead of silently losing it)
                    self._deficit[t] = d - c
                    if not q or self._deficit[t] < q[0][1]:
                        self._advance()
                    if self._trace_hook is not None:
                        self._trace_hook("drr_picked", t, item, c)
                    return t, item, c
            self._advance()
        raise AssertionError(
            "DRR rotation did not converge — quantum accounting bug"
        )

    def restore(self, tenant: str, item: Any, cost: float) -> None:
        """Undo one :meth:`pick`: the item returns to the FRONT of its
        tenant's queue and the charge is refunded — a failed admission
        plan (pool pressure, page quota) costs the tenant nothing and
        the next rotation retries it in place."""
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
            if tenant not in self._order:
                self._order.append(tenant)
        q.appendleft((item, float(cost)))
        self._n += 1
        self._deficit[tenant] = (
            self._deficit.get(tenant, 0.0) + float(cost)
        )

    def remove(self, item: Any) -> bool:
        """Withdraw a queued item wherever it sits (the cancel path).
        Identity comparison, like the schedulers' queue removal."""
        for t in self._order:
            q = self._queues.get(t)
            if not q:
                continue
            for pair in q:
                if pair[0] is item:
                    q.remove(pair)
                    self._n -= 1
                    # an emptied queue keeps its carry until the next
                    # fresh enqueue forfeits it (the enqueue rule)
                    return True
        return False

    def clear(self) -> None:
        """Drop every queue and every deficit (replica death)."""
        self._queues.clear()
        self._deficit.clear()
        self._order.clear()
        self._cursor = 0
        self._granted = False
        self._n = 0

    def __repr__(self) -> str:
        return (
            f"DeficitScheduler({self._n} queued over "
            f"{len(self.backlogged())} backlogged tenants)"
        )
