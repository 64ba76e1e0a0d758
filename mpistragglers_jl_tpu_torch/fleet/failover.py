"""Coordinator HA: checkpoint, standby adoption, and the elastic pool.

A copy of ``mpistragglers_jl_tpu/fleet/failover.py``, not an import of
it (the port never imports the JAX package). Stdlib and numpy, no torch,
and no OS clock: the same seeded inputs give the same records in either
package.

The coordinator is a single point of failure — ROADMAP item 2's second
half. Three pieces close it:

* :class:`FleetCheckpointer` — controller/coordinator state through
  :class:`~..utils.coded_checkpoint.CodedCheckpoint` on a cadence: the
  state dict is pickled to one byte payload and RS(n, k)-coded across
  shard files, so the checkpoint itself survives losing any ``n - k``
  shards (a torn write is detected by CRC and refused by name — the
  ``CheckpointCorrupt`` contract, pinned in
  tests/test_torch_coded_checkpoint.py).
* :class:`ControllerSupervisor` — the standby story on one clock: the
  active :class:`~.controller.FleetController` checkpoints as it runs;
  :meth:`~ControllerSupervisor.kill` models the coordinator dying
  (decisions stop; the data plane — router, replicas — keeps serving);
  after ``takeover_s`` the standby adopts: a fresh controller restores
  the last checkpoint, re-asserts the provisioned set onto the living
  router, counts the failover, and stamps the takeover into the flight
  recorder. Deterministic on a :class:`~..sim.clock.VirtualClock`, so
  a whole failover day replays bit-identically (tier-1).
* :func:`capture_pool` / :func:`restore_pool` / :func:`adopt_pool` —
  the POOL-plane coordinator state (``epoch``, ``repochs``,
  ``sepochs``, ``stags``, ``active``, last results): a standby
  coordinator process adopts the live backend — the worker processes,
  their fds, memfd arenas, and result rings all outlive the
  coordinator object (the persistent-transport design) — and
  continues ``asyncmap`` from the restored pool state. In-flight
  dispatches captured ``active`` complete into the backend's slots
  while the coordinator is dead; the standby's first epoch harvests
  them (fresh or stale-then-retask), so no epoch is lost and the
  ``repochs`` history is continuous across the handoff.
* :class:`PoolScaler` — the worker-pool half of the elastic pair the
  controller's serving-plane resize mirrors: shrink reaps worker
  processes (``backend.reap``), grow respawns them
  (``backend.respawn``) and forgets the dead incarnation's in-flight
  task (``pool.reset_worker``), with :meth:`~..pool.AsyncPool.carry`
  moving the epoch bookkeeping onto the resized rank set.

Wall-clock purity (tests/test_torch_imports.py covers ``fleet/``):
nothing here reads the OS clock; adoption waits ride the backend's own
timeout machinery.
"""

from __future__ import annotations

import pickle

import numpy as np

from ..pool import AsyncPool
from ..utils.coded_checkpoint import CodedCheckpoint

__all__ = [
    "FleetCheckpointer",
    "ControllerSupervisor",
    "PoolScaler",
    "capture_pool",
    "restore_pool",
    "adopt_pool",
]


class FleetCheckpointer:
    """(n, k)-coded checkpoint channel for one state dict: survives
    any ``n - k`` lost/torn shard files; a deeper loss is refused by
    name at restore (:class:`~..utils.coded_checkpoint.
    CheckpointCorrupt` lists each missing/corrupt shard)."""

    def __init__(self, directory, *, n: int = 5, k: int = 3):
        import os

        self.directory = os.fspath(directory)
        self.coded = CodedCheckpoint(n, k)
        self.n_saves = 0

    def save(self, state: dict) -> None:
        blob = np.frombuffer(
            pickle.dumps(state, protocol=4), dtype=np.uint8
        )
        self.coded.save(self.directory, {"state": blob})
        self.n_saves += 1

    def restore(self) -> dict:
        out = self.coded.restore(
            self.directory, target={"state": np.zeros(0, np.uint8)}
        )
        return pickle.loads(out["state"].tobytes())

    def __repr__(self) -> str:
        return (
            f"FleetCheckpointer({self.directory!r}, "
            f"({self.coded.n},{self.coded.k}), {self.n_saves} saves)"
        )


class ControllerSupervisor:
    """Active/standby pair over one checkpointer (module docstring).

    ``make_controller()`` builds a controller wired to the SHARED
    router/clock/checkpointer — it runs once at construction (the
    active) and once per takeover (the standby), so it must be
    deterministic. The supervisor satisfies the same driver protocol
    as the controller (``observe_arrival`` / ``step`` /
    ``next_event_at`` plus the report counters), which is what
    :func:`~..sim.workload.run_router_day` drives."""

    def __init__(self, make_controller, *, clock,
                 takeover_s: float = 0.0):
        self._make = make_controller
        self.clock = clock
        self.takeover_s = float(takeover_s)
        self.active = make_controller()
        if self.active.checkpointer is None:
            raise ValueError(
                "the supervised controller needs a checkpointer "
                "(checkpointer= / checkpoint_every_s=): a standby "
                "cannot adopt state nobody saved"
            )
        self._checkpointer = self.active.checkpointer
        # the zeroth checkpoint, at construction: a kill BEFORE the
        # first cadence must still leave the standby something to
        # adopt (reviewed failure: restore() on an empty directory
        # killed the whole day at takeover)
        self.active.checkpoint()
        self.takeover_at: float | None = None
        self.n_kills = 0
        self._carried = (0, 0)  # (n_resizes, n_failovers) at kill
        # decision records survive the coordinator: the postmortem
        # story must cover the WHOLE day, not just the current
        # incarnation (the standby's own list starts empty — live
        # decision state is not part of the coded checkpoint)
        self._carried_decisions: list = []

    # -- the coordinator-kill event --------------------------------------

    def kill(self) -> None:
        """The active coordinator dies NOW: decisions stop, the data
        plane keeps serving, and the standby adopts ``takeover_s``
        later. Idempotent while already dead."""
        if self.active is None:
            return
        self._carried = (
            self.active.n_resizes, self.active.n_failovers,
        )
        self._carried_decisions.extend(self.active.decisions)
        self.active = None
        self.n_kills += 1
        self.takeover_at = self.clock.now() + self.takeover_s

    # -- driver protocol --------------------------------------------------

    def observe_arrival(self, t: float) -> None:
        # a dead coordinator observes nothing; the standby's restored
        # estimator resumes from the last checkpoint (deterministic —
        # the lost window is the price of the kill, not noise)
        if self.active is not None:
            self.active.observe_arrival(t)

    def step(self):
        if self.active is None:
            now = self.clock.now()
            if self.takeover_at is None or now + 1e-12 < (
                self.takeover_at
            ):
                return None
            standby = self._make()
            standby.load_state(
                self._checkpointer.restore(), adopted=True
            )
            # the restored seq can lag the carried records (decisions
            # accepted after the last checkpoint kept their higher
            # seqs): the whole-day decision log must never hold two
            # records with one seq
            if self._carried_decisions:
                standby._seq = max(
                    standby._seq,
                    self._carried_decisions[-1].seq + 1,
                )
            self.active = standby
            self.takeover_at = None
            return None
        return self.active.step()

    def next_event_at(self) -> float | None:
        if self.active is None:
            return self.takeover_at
        return self.active.next_event_at()

    def resize_to(self, target: int, *, reason: str = "operator"):
        """Forward an operator resize to the live coordinator. While
        dead, the event is lost with it (deterministically — the
        standby restores the CHECKPOINTED intent, not events nobody
        was alive to act on)."""
        if self.active is None:
            return None
        return self.active.resize_to(target, reason=reason)

    # -- report counters --------------------------------------------------

    @property
    def n_resizes(self) -> int:
        return (
            self.active.n_resizes if self.active is not None
            else self._carried[0]
        )

    @property
    def n_failovers(self) -> int:
        return (
            self.active.n_failovers if self.active is not None
            else self._carried[1]
        )

    @property
    def decisions(self):
        """Every decision of the day, across incarnations: the dead
        actives' carried records plus the live controller's."""
        live = [] if self.active is None else self.active.decisions
        return self._carried_decisions + live

    def chip_seconds(self, t: float | None = None) -> float:
        if self.active is None:
            raise RuntimeError(
                "chip_seconds while the coordinator is dead: read it "
                "after the standby adopts (the books ride the "
                "checkpoint)"
            )
        return self.active.chip_seconds(t)

    def __repr__(self) -> str:
        state = (
            repr(self.active) if self.active is not None
            else f"DEAD until t={self.takeover_at}"
        )
        return f"ControllerSupervisor({state}, kills={self.n_kills})"


# -- pool-plane coordinator state -----------------------------------------


def _host(r):
    """A stored result as host data: a tensor (on the card or not)
    becomes a host tensor of the same dtype, bf16 included, and anything
    else a numpy array, as in the reference. Duck-typed, so this module
    imports no torch."""
    if r is None:
        return None
    if hasattr(r, "detach"):
        return r.detach().cpu().clone()
    return np.asarray(r)


def capture_pool(pool: AsyncPool) -> dict:
    """The coordinator's pool bookkeeping as one checkpointable dict:
    epoch counters, per-worker ``sepochs``/``stags``/``repochs``/
    ``active``, and the last stored results (the decode inputs
    ``fresh_indices`` selects). Call right after an ``asyncmap``
    returns — the epoch boundary is the consistent cut."""
    return {
        "kind": "pool",
        "ranks": np.asarray(pool.ranks, np.int64),
        "epoch": int(pool.epoch),
        "epoch0": int(pool.epoch0),
        "nwait": int(pool.nwait),
        "sepochs": pool.sepochs.copy(),
        "stags": pool.stags.copy(),
        "repochs": pool.repochs.copy(),
        "active": pool.active.copy(),
        "latency": pool.latency.copy(),
        "results": [_host(r) for r in pool.results],
    }


def restore_pool(state: dict) -> AsyncPool:
    """A fresh :class:`~..pool.AsyncPool` in exactly the captured
    state. The backend is NOT part of the state — it is the living
    thing the standby adopts (worker fds, memfd arenas, result rings
    persist across coordinator death by construction)."""
    if state.get("kind") != "pool":
        raise ValueError(
            f"not a pool checkpoint (kind={state.get('kind')!r})"
        )
    pool = AsyncPool(
        [int(r) for r in state["ranks"]],
        epoch0=int(state["epoch0"]), nwait=int(state["nwait"]),
    )
    pool.epoch = int(state["epoch"])
    pool.sepochs[:] = state["sepochs"]
    pool.stags[:] = state["stags"]
    pool.repochs[:] = state["repochs"]
    pool.active[:] = state["active"]
    pool.latency[:] = state["latency"]
    pool.results = list(state["results"])
    return pool


def adopt_pool(
    checkpointer: FleetCheckpointer, *, flight=None
) -> AsyncPool:
    """Standby-coordinator adoption: restore the pool from the last
    coded checkpoint and stamp the takeover into the flight recorder.
    The caller hands the restored pool the SAME backend object (or a
    reconnected one over the same worker fds): workers that were
    in-flight at the checkpoint complete into the backend's slots
    while the coordinator is dead, and the standby's next
    ``asyncmap`` harvests them — fresh results count, stale ones
    re-task, no epoch is lost."""
    state = checkpointer.restore()
    pool = restore_pool(state)
    if flight is not None:
        flight.event(
            "coordinator takeover", src="fleet",
            epoch=pool.epoch,
            active=[int(i) for i in np.flatnonzero(pool.active)],
            detail=(
                f"standby adopted pool at epoch {pool.epoch}; "
                f"{int(pool.active.sum())} dispatches in flight "
                "carried across the handoff"
            ),
        )
    return pool


class PoolScaler:
    """The worker-pool half of the elastic pair (ROADMAP: "grow/shrink
    the worker pool ... ``pool.reset_worker`` + backend respawn/reap").

    Shrink: ranks leave the active set and their worker processes are
    reaped (``backend.reap`` where the backend has one — ProcessBackend
    does; a backend without the verb just stops being dispatched to).
    Grow: reaped ranks rejoin — ``backend.respawn`` brings the process
    back and ``reset_worker`` forgets the dead incarnation's in-flight
    task so the rank is dispatchable next epoch. Either way the epoch
    bookkeeping moves onto the new rank set via
    :meth:`~..pool.AsyncPool.carry`: surviving ranks keep their
    ``repochs``/results, returning ranks are stale-until-they-answer.
    """

    def __init__(self, pool: AsyncPool, backend, *,
                 min_workers: int = 1):
        self.pool = pool
        self.backend = backend
        self.min_workers = int(min_workers)
        self.max_workers = int(backend.n_workers)
        if not (1 <= self.min_workers <= self.max_workers):
            raise ValueError(
                f"min_workers must be in [1, {self.max_workers}], "
                f"got {min_workers}"
            )
        self.n_reaped = 0
        self.n_respawned = 0

    def resize(
        self, n_active: int, *, nwait: int | None = None
    ) -> AsyncPool:
        """Resize to the FIRST ``n_active`` backend ranks; returns the
        carried pool (also stored on ``self.pool``). Refuses, never
        clamps: a target outside ``[min_workers, max_workers]`` is a
        caller bug, not a rounding choice. ``nwait`` is the re-derived
        decodability floor for the resized rank set (the controller's
        ``sweep_hierarchical`` output) — pass it whenever the code's
        ``k`` does not survive the resize: ``carry``'s default clamps
        the old nwait into the new rank count, which on a shrink below
        ``k`` would leave the pool completing epochs the code cannot
        decode."""
        n = int(n_active)
        if not (self.min_workers <= n <= self.max_workers):
            raise ValueError(
                f"resize to {n} workers refused: the elastic range is "
                f"[{self.min_workers}, {self.max_workers}] (the "
                "backend has exactly max_workers processes; grow the "
                "backend, don't overdrive the scaler)"
            )
        ranks = list(range(n))
        old = set(self.pool.ranks)
        new = set(ranks)
        for r in sorted(old - new):
            reap = getattr(self.backend, "reap", None)
            if reap is not None:
                reap(r)
                self.n_reaped += 1
        carried = self.pool.carry(ranks, nwait=nwait)
        for r in sorted(new - old):
            dead = getattr(self.backend, "dead_workers", None)
            if dead is not None and r in dead():
                self.backend.respawn(r)
                self.n_respawned += 1
            # the dead incarnation's dispatch can never complete; the
            # rank must be idle to be dispatchable next epoch
            carried.reset_worker(carried.ranks.index(r))
        self.pool = carried
        return carried

    def __repr__(self) -> str:
        return (
            f"PoolScaler({len(self.pool.ranks)}/"
            f"[{self.min_workers},{self.max_workers}] active, "
            f"reaped={self.n_reaped}, respawned={self.n_respawned})"
        )
