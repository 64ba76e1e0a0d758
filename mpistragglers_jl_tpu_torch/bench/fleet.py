"""The elastic-fleet rung: the closed control loop, priced (host only).

A port of ``benchmarks/fleet_bench.py``. A compressed diurnal day with a
3x rate swing (amplitude 0.5) over an 8-replica ``SimReplica`` fleet,
driven twice:

* **elastic**: a ``FleetController`` under a ``ControllerSupervisor``
  autoscales between 2 and 8 replicas against hysteresis bands,
  re-derives (outer rate, inner nwait) with ``sweep_hierarchical`` and
  the router policy with ``sweep_router_policy`` on every accepted
  resize, checkpoints through the (5, 3)-coded channel, and survives one
  mid-day ``CoordinatorKill``: the standby adopts from the last
  checkpoint;
* **static**: the same arrivals on the peak-provisioned fleet, no
  controller.

``fleet_chip_time_x`` is static chip-seconds over elastic (the
reference's floor 1.2) and ``fleet_failover_drops`` the killed day's
dropped requests (must be 0). Two elastic days of one seed must agree on
the digest and the decision records.

    python -m mpistragglers_jl_tpu_torch.bench.fleet [--requests N]

Prints one JSON line, host wall clock, unrounded.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np

_N_FLEET = 8
_SLOTS, _NI, _TICK = 2, 4, 0.25
_PLEN, _CHUNK, _MNEW = 64, 64, 16
_PERIOD = 3600.0
_PEAK_UTIL = 0.675


def _capacity():
    from ..fleet import replica_capacity_rps

    return replica_capacity_rps(
        slots=_SLOTS, n_inner=_NI, tick_s=_TICK, prompt_len=_PLEN,
        prompt_chunk=_CHUNK, max_new=_MNEW,
    )


def _fitted_model(seed=5):
    from ..utils.straggle import PoolLatencyModel

    model = PoolLatencyModel(_NI, seed=0)
    rng = np.random.default_rng(seed)
    for _ in range(40):
        for w in range(_NI):
            model.observe(
                w, 0.01 * (1 + 0.3 * w) * float(rng.lognormal(0, 0.3))
            )
    return model


def _day(n, seed, *, elastic, kill_at=None, ckpt_dir=None):
    from ..fleet import (
        ControllerSupervisor,
        FleetCheckpointer,
        FleetController,
    )
    from ..models.router import RequestRouter
    from ..sim import (
        CoordinatorKill,
        SimReplica,
        VirtualClock,
        diurnal_arrivals,
        lognormal_ticks,
        run_router_day,
    )

    cap = _capacity()
    clock = VirtualClock()
    reps = [
        SimReplica(
            clock, slots=_SLOTS, n_inner=_NI, prompt_chunk=_CHUNK,
            tick_s=lognormal_ticks(_TICK, 0.2, seed=1009 + i),
        )
        for i in range(_N_FLEET)
    ]
    router = RequestRouter(reps, policy="least_loaded", clock=clock)
    peak = _N_FLEET * cap * _PEAK_UTIL
    mean_rate = peak / 1.5  # amplitude 0.5 -> the 3x swing
    sup = None
    events = []
    if elastic:
        ck = FleetCheckpointer(ckpt_dir, n=5, k=3)
        model = _fitted_model()

        def mk():
            return FleetController(
                router, clock=clock, capacity_rps=cap,
                min_replicas=2, max_replicas=_N_FLEET,
                high=0.75, low=0.45, target_util=0.55,
                decision_interval_s=30.0,
                dwell_s=30.0, cooldown_s=60.0, rate_tau_s=120.0,
                checkpointer=ck, checkpoint_every_s=150.0,
                recode=dict(
                    model=model, n_inner=_NI,
                    candidates=[(1.0, 2), (1.0, 3), (0.75, 3)],
                    inner_floor=2, epochs=12,
                ),
                policy_sweep=dict(
                    requests=250, slots=_SLOTS, n_inner=_NI,
                    tick_s=_TICK, prompt_len=_PLEN,
                    prompt_chunk=_CHUNK, max_new=_MNEW, seed=11,
                ),
                decision_budget=100,
            )

        sup = ControllerSupervisor(mk, clock=clock, takeover_s=60.0)
        if kill_at is not None:
            events.append(CoordinatorKill(kill_at))
    report = run_router_day(
        router,
        diurnal_arrivals(
            mean_rate, n=n, period=_PERIOD, amplitude=0.5, seed=seed,
            prompt_len=_PLEN, max_new=_MNEW,
        ),
        controller=sup,
        events=events,
    )
    return report, sup


def bench_fleet_rung(requests: int | None = None):
    """The driver rung ``fleet``: elastic-vs-static chip time under
    the 3x swing + one coordinator kill, with the bit-identity
    witness over the killed day."""
    cap = _capacity()
    mean_rate = _N_FLEET * cap * _PEAK_UTIL / 1.5
    if requests is None:
        requests = int(mean_rate * _PERIOD * 0.97)
    # the kill lands at ~45% of the ACTUAL arrival span (an overridden
    # request count shortens the day; a kill past the last arrival
    # would leave the standby nothing to adopt into)
    kill_at = 0.45 * requests / mean_rate
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d1:
        e1, s1 = _day(
            requests, 13, elastic=True, kill_at=kill_at, ckpt_dir=d1,
        )
        dec1 = [dd.to_dict() for dd in s1.decisions]
        elastic_chip = s1.chip_seconds(e1.virtual_s)
    with tempfile.TemporaryDirectory() as d2:
        e2, s2 = _day(
            requests, 13, elastic=True, kill_at=kill_at, ckpt_dir=d2,
        )
        if e1.digest() != e2.digest():
            raise AssertionError(
                f"elastic day not bit-identical: {e1.digest()} != "
                f"{e2.digest()}"
            )
        if dec1 != [dd.to_dict() for dd in s2.decisions]:
            raise AssertionError(
                "decision records diverged across two replays of the "
                "same seed"
            )
    if e1.dropped != 0:
        raise AssertionError(
            f"fleet_failover_drops {e1.dropped} != 0: the kill dropped "
            "requests (the zero-drop failover contract)"
        )
    if e1.n_failovers != 1:
        raise AssertionError(
            f"expected exactly one coordinator takeover, saw "
            f"{e1.n_failovers}"
        )
    if e1.n_resizes < 2:
        raise AssertionError(
            f"the 3x swing moved the fleet only {e1.n_resizes} times "
            "— the controller never closed the loop"
        )
    # the kill-free elastic day attributes the killed day's TTFT
    # tail: the coordinator dying at the steepest ramp costs TAIL
    # (the dead+re-ramp window under-provisions), never drops or chips
    with tempfile.TemporaryDirectory() as d3:
        nokill, _ = _day(requests, 13, elastic=True, ckpt_dir=d3)
    static, _ = _day(requests, 13, elastic=False)
    if static.dropped:
        raise AssertionError(f"{static.dropped} static-day drops")
    static_chip = _N_FLEET * static.virtual_s
    chip_x = static_chip / elastic_chip
    if chip_x < 1.2:
        raise AssertionError(
            f"fleet_chip_time_x {chip_x:.2f} below the 1.2x "
            f"acceptance floor (elastic {elastic_chip:.0f} vs static "
            f"{static_chip:.0f} chip-seconds)"
        )
    recodes = [
        dd["recode"] for dd in dec1 if dd.get("recode") is not None
    ]
    return {
        "requests": int(requests),
        "virtual_day_s": e1.virtual_s,
        "fleet_chip_time_x": chip_x,
        "fleet_failover_drops": int(e1.dropped),
        "elastic_chip_s": elastic_chip,
        "static_chip_s": static_chip,
        "resizes": int(e1.n_resizes),
        "failovers": int(e1.n_failovers),
        "recode_agree": [bool(rc["agree"]) for rc in recodes
                         if rc["agree"] is not None],
        "recode_pairs": [list(rc["pair"]) for rc in recodes],
        "p99_ttft_s": e1.p99_ttft(),
        "p99_ttft_nokill_s": nokill.p99_ttft(),
        "static_p99_ttft_s": static.p99_ttft(),
        "digest": e1.digest(),
        "wall_s": time.perf_counter() - t0,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=None,
                    help="requests of the day (default: the full day)")
    print(json.dumps(bench_fleet_rung(ap.parse_args().requests)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
