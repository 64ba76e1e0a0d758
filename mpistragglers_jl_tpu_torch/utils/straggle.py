"""Straggler latency modeling and straggle-aware scheduling.

A copy of the JAX package's ``utils/straggle.py`` (numpy only); the
same samples and seed give the same fits and the same ``nwait``.
:meth:`PoolLatencyModel.publish` writes into the port's
:class:`~..obs.MetricsRegistry`.

The reference measures per-worker round-trip latency (``pool.latency``,
reference src/MPIAsyncPools.jl:104-105,:163-164) and then leaves every
scheduling decision to the caller: ``nwait`` is a constant the user picks
by hand in every test and example (test/kmap2.jl:32, :57,
examples/iterative_example.jl:40). This module closes that loop — it
turns the latency samples the pool already produces into decisions:

* :class:`PoolLatencyModel` — online per-worker shifted-exponential fits
  (the standard model for straggling compute nodes: a deterministic
  service floor plus an exponential tail) from ``pool.latency``.
* :meth:`PoolLatencyModel.expected_epoch_time` — E[time until the k
  fastest of the n heterogeneous workers respond] (k-th order statistic),
  by Monte-Carlo over the fitted per-worker distributions.
* :meth:`PoolLatencyModel.optimal_nwait` — the ``nwait`` minimizing
  expected time per fresh result (or any caller utility), the knob that
  trades straggler-avoidance against discarded work in coded workloads.
* :meth:`PoolLatencyModel.proportional_shares` — load-balanced work
  splits proportional to fitted worker speed, for uncoded workloads
  where shard sizes are free parameters.
* :class:`AdaptiveNwait` — drop-in controller: observe after each
  ``asyncmap``, pass ``controller.nwait`` to the next one.

Everything is coordinator-side numpy over data the pool already tracks;
no backend cooperation needed, deterministic given a seeded generator.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["WorkerStats", "PoolLatencyModel", "AdaptiveNwait"]


class WorkerStats:
    """Online latency statistics for one worker (Welford + running min).

    The fitted model is a shifted exponential ``shift + Exp(rate)``:
    ``shift`` is the service floor (estimated by the sample minimum,
    which converges at rate 1/m, much faster than the mean), and the
    exponential tail rate comes from the residual mean
    ``1 / (mean - shift)``.

    ``change_detect=True`` arms a two-sided CUSUM on standardized
    residuals (Page's test: ``S+ <- max(0, S+ + r - drift)`` and
    symmetrically for ``S-``). When either side crosses ``threshold``
    the worker's regime has shifted — a straggler moved onto or off
    this rank — and the fit restarts from the triggering sample
    instead of averaging two regimes forever (without it the
    controller paid 1.65x the oracle on a rotating straggler, because
    Welford means lag a moved straggler by their whole history).

    Default drift/threshold are tuned for the *skewed* exponential
    tail, not the gaussian textbook values: at (drift=0.5, h=5) the
    one-sided residual skew fires falsely on 97% of 500-sample
    stationary shifted-exp traces; (drift=1.5, h=8, warmup 8) measures
    0/100 false alarms at 50 samples, 4/100 at 500, while still
    detecting a straggler-sized (15x) shift on the very next sample.
    """

    def __init__(
        self,
        *,
        change_detect: bool = False,
        cusum_drift: float = 1.5,
        cusum_threshold: float = 8.0,
        cusum_min_count: int = 8,
    ) -> None:
        self.count = 0
        self.mean = 0.0
        self._m2 = 0.0
        self.min = np.inf
        self.change_detect = bool(change_detect)
        self.cusum_drift = float(cusum_drift)
        self.cusum_threshold = float(cusum_threshold)
        self.cusum_min_count = int(cusum_min_count)
        self._sp = 0.0
        self._sn = 0.0
        self.resets = 0  # change-points detected over this stats' life

    def _restart(self) -> None:
        self.count = 0
        self.mean = 0.0
        self._m2 = 0.0
        self.min = np.inf
        self._sp = 0.0
        self._sn = 0.0

    def observe(self, latency: float) -> bool:
        """Ingest one sample; returns True iff a change-point fired
        (the fit was restarted — the triggering sample becomes the
        first of the new regime)."""
        x = float(latency)
        if not np.isfinite(x) or x < 0:
            return False
        shifted = False
        if self.change_detect and self.count >= self.cusum_min_count:
            # std floor: a worker whose samples sit at the service
            # floor has var ~ 0; 5% of mean keeps r finite while still
            # firing within a couple of samples on a real regime shift
            std = max(
                float(np.sqrt(self.var)), 0.05 * max(self.mean, 1e-9)
            )
            r = (x - self.mean) / std
            self._sp = max(0.0, self._sp + r - self.cusum_drift)
            self._sn = max(0.0, self._sn - r - self.cusum_drift)
            if (
                self._sp > self.cusum_threshold
                or self._sn > self.cusum_threshold
            ):
                self._restart()
                self.resets += 1
                shifted = True
        self.count += 1
        delta = x - self.mean
        self.mean += delta / self.count
        self._m2 += delta * (x - self.mean)
        if x < self.min:
            self.min = x
        return shifted

    @property
    def var(self) -> float:
        return self._m2 / (self.count - 1) if self.count > 1 else 0.0

    @property
    def shift(self) -> float:
        return 0.0 if self.count == 0 else float(self.min)

    @property
    def rate(self) -> float:
        """Exponential tail rate; inf for a worker with no observed tail
        (all samples at the floor)."""
        if self.count == 0:
            return np.inf
        tail = self.mean - self.shift
        return np.inf if tail <= 0 else 1.0 / tail

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        if self.count == 0:
            return np.zeros(size)
        rate = self.rate
        if not np.isfinite(rate):
            return np.full(size, self.shift)
        return self.shift + rng.exponential(1.0 / rate, size)

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "mean_s": self.mean,
            "std_s": float(np.sqrt(self.var)),
            "shift_s": self.shift if self.count else None,
            "rate_hz": None if not np.isfinite(self.rate) else self.rate,
        }


class PoolLatencyModel:
    """Per-worker latency models for an n-worker pool.

    Feed it after every ``asyncmap``/``waitall`` with
    :meth:`observe_pool` (it reads ``pool.latency`` for workers that
    delivered since the last call) or directly with :meth:`observe`.

    >>> model = PoolLatencyModel(pool.n_workers)
    >>> repochs = asyncmap(pool, payload, backend, nwait=model_k)
    >>> model.observe_pool(pool)
    >>> model.optimal_nwait()          # nwait minimizing time/result
    >>> model.expected_epoch_time(6)   # predicted wall for nwait=6
    """

    def __init__(
        self, n_workers: int, *, seed: int = 0,
        change_detect: bool = False,
    ):
        self.n_workers = int(n_workers)
        self.workers = [
            WorkerStats(change_detect=change_detect)
            for _ in range(self.n_workers)
        ]
        self._seed = int(seed)
        # repochs snapshot from the previous observe_pool: only workers
        # whose repochs advanced have a *new* latency sample
        self._last_repochs = None
        # workers whose CUSUM fired during the last observe/observe_pool
        # — only THAT worker's fit restarted, everyone else's history
        # stands (a per-worker reset)
        self.shifted_last_observe: list[int] = []

    # -- data intake -------------------------------------------------------
    def observe(self, worker: int, latency: float) -> None:
        self.shifted_last_observe = (
            [worker] if self.workers[worker].observe(latency) else []
        )

    def observe_pool(self, pool) -> int:
        """Record latency samples for workers whose ``repochs`` advanced
        since the previous call; returns how many samples were taken."""
        rep = np.asarray(pool.repochs)
        if self._last_repochs is None:
            newly = [i for i in range(self.n_workers) if pool.results[i] is not None]
        else:
            newly = [
                i for i in range(self.n_workers)
                if rep[i] != self._last_repochs[i]
            ]
        self.shifted_last_observe = [
            i for i in newly if self.workers[i].observe(pool.latency[i])
        ]
        self._last_repochs = rep.copy()
        return len(newly)

    # -- prediction --------------------------------------------------------
    def sample_latencies(self, n_draws: int) -> np.ndarray:
        """(n_draws, n_workers) matrix of sampled per-worker latencies.

        Workers never heard from sample from the pooled prior (mean
        shift/rate of the observed workers) rather than zero — a silent
        worker must not look infinitely fast to ``optimal_nwait``.

        Determinism contract: predictions are pure functions of the
        fitted state and the constructor ``seed``. The draw generator is
        re-seeded per call, so calling ``sample_latencies`` /
        ``expected_epoch_time`` / ``optimal_nwait`` twice on an
        unchanged model returns identical results (a shared generator
        advancing across calls would let two consecutive
        ``optimal_nwait`` calls disagree near a utility tie). This also
        makes ``optimal_nwait``'s SLO sweep monotonic: every candidate
        k is priced on the SAME draw matrix.
        """
        rng = np.random.default_rng(self._seed)
        observed = [w for w in self.workers if w.count > 0]
        prior = None
        if observed:
            prior = WorkerStats()
            for w in observed:
                # moment-match the pool average: same mean and floor
                prior.count += 1
                prior.mean += (w.mean - prior.mean) / prior.count
                prior.min = min(prior.min, w.min)
        cols = [
            (w if w.count > 0 else prior or w).sample(rng, n_draws)
            for w in self.workers
        ]
        return np.stack(cols, axis=1)

    def expected_epoch_time(
        self, nwait: int, *, n_draws: int = 4000
    ) -> float:
        """E[wall-clock until the ``nwait`` fastest workers respond] —
        the mean ``nwait``-th order statistic over the heterogeneous
        fitted distributions (Monte Carlo; closed forms only exist for
        the iid case)."""
        if not (0 <= nwait <= self.n_workers):
            raise ValueError(f"nwait must be in [0, {self.n_workers}]")
        if nwait == 0:
            return 0.0
        draws = self.sample_latencies(n_draws)
        kth = np.partition(draws, nwait - 1, axis=1)[:, nwait - 1]
        return float(kth.mean())

    def optimal_nwait(
        self,
        *,
        utility: Callable[[int], float] | None = None,
        kmin: int = 1,
        kmax: int | None = None,
        slo: float | None = None,
        n_draws: int = 4000,
    ) -> int:
        """The ``nwait`` maximizing ``utility(k) / E[T_(k)]`` (utility per
        second). Default utility is ``k`` — fresh results per epoch — so
        the default objective is minimum expected time per fresh result,
        the natural knob for (n, k)-coded workloads where waiting for
        more shards amortizes the service floor but exposes the epoch to
        deeper order statistics.

        ``kmin`` is the decodability floor: the returned ``nwait`` is
        NEVER below it, under any ``slo`` — fewer than k fresh shards
        cannot decode, so a floor violation would trade latency for
        correctness.

        ``slo`` (seconds, optional) caps expected epoch time: only
        candidates with ``E[T_(k)] <= slo`` compete; if none qualifies
        (the SLO is unachievable even at the floor), the floor ``kmin``
        — the cheapest decodable wait — is returned rather than an
        infeasible pretense. Because ``E[T_(k)]`` is non-decreasing in
        k and every candidate is priced on the same deterministic draw
        matrix (see :meth:`sample_latencies`), the result is monotonic
        non-decreasing in ``slo``: loosening a latency target can only
        admit deeper waits, never retract one.
        """
        kmax = self.n_workers if kmax is None else int(kmax)
        if not (1 <= kmin <= kmax <= self.n_workers):
            raise ValueError(
                f"need 1 <= kmin <= kmax <= {self.n_workers}, "
                f"got [{kmin}, {kmax}]"
            )
        u = (lambda k: float(k)) if utility is None else utility
        draws = self.sample_latencies(n_draws)
        draws.sort(axis=1)
        best_k, best_score = kmin, -np.inf
        for k in range(kmin, kmax + 1):
            t = float(draws[:, k - 1].mean())
            if slo is not None and t > slo and k > kmin:
                # E[T_(k)] is non-decreasing in k on the sorted draw
                # matrix: every deeper candidate busts the SLO too
                break
            score = u(k) / t if t > 0 else np.inf
            if slo is not None and t > slo:
                # the floor itself busts the SLO: it stays the fallback
                # (decodability beats the latency target) but must not
                # outscore a feasible deeper candidate
                score = -np.inf
            if score > best_score:
                best_k, best_score = k, score
        return best_k

    def proportional_shares(self, total: int) -> np.ndarray:
        """Split ``total`` work units across workers proportional to
        fitted speed (1/mean latency), by largest remainder — the
        load-balancing split for uncoded workloads. Workers without
        samples get the mean share."""
        means = np.array(
            [w.mean if w.count else np.nan for w in self.workers]
        )
        if np.isnan(means).all():
            means = np.ones(self.n_workers)
        else:
            means = np.where(np.isnan(means), np.nanmean(means), means)
        speed = 1.0 / np.maximum(means, 1e-12)
        ideal = total * speed / speed.sum()
        shares = np.floor(ideal).astype(np.int64)
        rem = int(total - shares.sum())
        if rem > 0:
            order = np.argsort(-(ideal - shares))
            shares[order[:rem]] += 1
        return shares

    def summary(self) -> list[dict]:
        return [w.to_dict() for w in self.workers]

    def publish(self, registry, *, prefix: str = "pool_worker") -> None:
        """Write the current per-worker fits into ``registry`` gauges
        (one ``worker=<i>``-labeled series per instrument): sample
        count, fitted mean, service floor (``shift``), exponential tail
        rate, and CUSUM change-point resets. Call after
        :meth:`observe_pool` at whatever cadence the scrape needs —
        gauges overwrite, so the registry always shows the live fit and
        the model's internals stay private. A worker with no tail
        (``rate == inf``) publishes rate 0 (Prometheus has no inf
        convention for "all samples at the floor")."""
        for i, w in enumerate(self.workers):
            lbl = {"worker": str(i)}
            registry.gauge(
                f"{prefix}_latency_samples",
                help="latency samples in the current fit", **lbl,
            ).set(w.count)
            registry.gauge(
                f"{prefix}_latency_mean_seconds",
                help="fitted mean round-trip", **lbl,
            ).set(w.mean)
            registry.gauge(
                f"{prefix}_latency_floor_seconds",
                help="fitted service floor (shift)", **lbl,
            ).set(w.shift)
            rate = w.rate
            registry.gauge(
                f"{prefix}_latency_tail_rate_hz",
                help="fitted exponential tail rate (0 = no tail "
                "observed)", **lbl,
            ).set(0.0 if not np.isfinite(rate) else rate)
            registry.gauge(
                f"{prefix}_cusum_resets",
                help="change-points detected on this worker", **lbl,
            ).set(w.resets)


class AdaptiveNwait:
    """Epoch-to-epoch ``nwait`` controller.

    Starts at ``nwait0`` (default n), refits every ``refit_every``
    observed epochs once ``min_samples`` per-worker samples exist, and
    exposes the current choice as ``.nwait``:

    >>> ctl = AdaptiveNwait(pool.n_workers, kmin=code.k)
    >>> for step in range(epochs):
    ...     asyncmap(pool, payload, backend, nwait=ctl.nwait)
    ...     ctl.observe(pool)

    ``kmin`` is the correctness floor — for an (n, k) code, fewer than k
    fresh shards cannot decode, so the controller never goes below it.
    """

    def __init__(
        self,
        n_workers: int,
        *,
        kmin: int = 1,
        kmax: int | None = None,
        nwait0: int | None = None,
        utility: Callable[[int], float] | None = None,
        min_samples: int = 3,
        refit_every: int = 5,
        seed: int = 0,
        change_detect: bool = True,
    ):
        self.model = PoolLatencyModel(
            n_workers, seed=seed, change_detect=change_detect
        )
        self.kmin = int(kmin)
        self.kmax = n_workers if kmax is None else int(kmax)
        self.utility = utility
        self.min_samples = int(min_samples)
        self.refit_every = int(refit_every)
        self.nwait = self.kmax if nwait0 is None else int(nwait0)
        self._observed = 0
        self._shift_boost = 0  # epochs of forced refitting after a shift
        self._fitted_once = False  # first fit fires at quorum, not cadence

    def observe(self, pool) -> int:
        """Feed the model; periodically re-pick ``nwait``. Returns the
        current choice.

        Refitting needs a *quorum* of fitted workers — at least
        ``max(kmin, 2)`` with ``min_samples`` each — not all of them: a
        rank that dies early (or is never heard from) must not disable
        adaptation in exactly the failure regime the controller exists
        for; silent workers are modeled by the pooled prior.

        A CUSUM change-point on any worker (``change_detect``, default
        on) restarts only that worker's fit and switches the controller
        to refit-every-epoch for the next ``refit_every`` epochs, so
        the decision catches up with the new regime at sample speed
        instead of waiting out the cadence."""
        self.model.observe_pool(pool)
        self._observed += 1
        if self.model.shifted_last_observe:
            self._shift_boost = self.refit_every
        fitted = sum(
            w.count >= self.min_samples for w in self.model.workers
        )
        ready = fitted >= max(self.kmin, 2)
        due = self._observed % self.refit_every == 0
        if ready and (due or self._shift_boost > 0 or not self._fitted_once):
            # the FIRST fit fires the moment the quorum exists — gating
            # it on the cadence would leave the controller at nwait0
            # (full gather) for up to refit_every straggler-priced
            # epochs of pure startup cost
            self.nwait = self.model.optimal_nwait(
                utility=self.utility, kmin=self.kmin, kmax=self.kmax
            )
            self._fitted_once = True
        if self._shift_boost > 0:
            self._shift_boost -= 1
        return self.nwait
