"""One cell of ``BENCHMARK.json``, run and reported.

Everything is found by name under the checkout's ``portbench/``: the
cell's configuration (the file its ``configs`` entry names), which
names its driver (``drivers/<driver>.py``), its traffic
(``traffic/<traffic>.json``) and one reader per metric
(``metrics/<metric>.py``, whose ``read(record)`` returns a number or
None; see :func:`reader`). A ``--trace 0`` run reports the cell's
end-to-end metrics, a ``--trace 1`` run its per-layer metrics; a metric
with a ``workloads`` list is read only in those cells, and a reader that
finds nothing to read leaves its metric out.

A driver module declares what belongs to its configurations:

* ``run(ctx)``: one run, returning its record (the readers' input, the
  compared numbers under ``checks`` and ``setup_parts`` from
  :func:`setup_parts`);
* ``CONTROLS``: the names ``--control`` takes for it (a
  configuration's ``control`` names one of them, or a list: each a
  precision below one the configuration states, whose run must come out
  not correct; see :func:`controls`);
* ``FAULTS``: ``{name: plant(monkeypatch)}``, each breaking the timed
  path underneath (the tests run every cell once with each).

A configuration's ``test`` group holds the keys it changes at test size:
``cpu`` for the CPU tests, ``card`` for the tests on the card.

The record's ``checks`` hold each compared number, per epoch or per
sampled epoch; the cell's ``limits/<cell>.json`` holds each one's limit
(a cell's own, since one configuration's traffic mixes decode through
fresh sets of different conditioning). A run is correct when every value
is within its limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import SimpleNamespace

FORBIDDEN = ("jax", "jaxlib", "flax", "mpistragglers_jl_tpu")
# set-up parts (``run.py``'s marks) that ``setup_s`` leaves out: the
# interpreter's start, torch's import, the wait for card 0's context and
# torch's start on it (``torch.cuda.init``)
OUTSIDE_SETUP = ("python and argparse", "import torch", "CUDA context",
                 "CUDA init")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(entries, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


def load_module(root: str, kind: str, name: str):
    """``portbench/<kind>/<name>.py`` of the checkout at ``root``."""
    path = os.path.join(root, "portbench", kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: str, metric: str):
    """The reader of ``metric``: ``metrics/<metric>.py``, or for a name
    ``<base>.<variant>`` with no file of its own, ``metrics/<base>.py``
    (one quantity reported under a name per group of cells)."""
    path = os.path.join(root, "portbench", "metrics", f"{metric}.py")
    return load_module(root, "metrics",
                       metric if os.path.isfile(path) else
                       metric.split(".")[0])


def cell(root: str, workload: str) -> SimpleNamespace:
    """The manifest's entries for ``workload``: the cell, its
    configuration and traffic, and the metrics it reports."""
    manifest = _json(os.path.join(root, "BENCHMARK.json"))
    entry = _by_name(manifest["workloads"], workload)
    conf = _by_name(manifest["configs"], entry["config"])
    cfg = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(root, "portbench", "traffic",
                                 f"{entry['traffic']}.json"))

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    limits = _json(os.path.join(root, "portbench", "limits",
                                f"{workload}.json"))
    return SimpleNamespace(
        name=workload, entry=entry, cfg=cfg, traffic=traffic, limits=limits,
        end_to_end=mine(manifest["end_to_end"]),
        per_layer=mine(manifest["per_layer"]))


def driver(root: str, cfg: dict):
    """The driver module of configuration ``cfg``."""
    return load_module(root, "drivers", cfg["driver"])


def controls(cfg: dict) -> list:
    """The controls configuration ``cfg`` states (``control``: a name or
    a list of names of its driver's ``CONTROLS``)."""
    c = cfg["control"]
    return [c] if isinstance(c, str) else list(c)


def setup_parts(ctx, marks) -> tuple[dict, dict]:
    """``(parts, cpu)`` at the end of a run's set-up: the seconds of each
    step, ``ctx.marks`` (``run.py``'s, before the driver) and the
    driver's ``marks`` (``(name, time.perf_counter())`` at each step's
    end, in order), the first from ``ctx.t_start``; and the CPU seconds
    the process has used."""
    import resource
    import time

    usage = resource.getrusage(resource.RUSAGE_SELF)
    marks = list(ctx.marks) + list(marks) + [("warm-up",
                                             time.perf_counter())]
    parts = {marks[0][0]: marks[0][1] - ctx.t_start}
    for (_, t0), (name, t1) in zip(marks, marks[1:]):
        parts[name] = t1 - t0
    return parts, {"user": usage.ru_utime, "sys": usage.ru_stime}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def judge(checks: dict, check_epochs: dict, limits: dict):
    """``(correct, failed epochs, {name: (worst value, limit)})``."""
    bad, worst = set(), {}
    for name, values in checks.items():
        limit = float(limits[name])
        if any(v != v for v in values):  # a NaN is the worst value
            worst[name] = (float("nan"), limit)
        else:
            worst[name] = (max(values) if values else None, limit)
        for e, v in zip(check_epochs[name], values):
            if not v <= limit:  # NaN fails too
                bad.add(e)
    correct = not bad and all(v is not None for v, _ in worst.values())
    return correct, len(bad), worst


def run_cell(root: str, workload: str, *, seed: int, seconds: float,
             trace: bool, device, t_start: float, control: str | None = None,
             marks=()):
    """``(result line, compared numbers)`` of one run of ``workload``.
    ``marks`` are ``(name, time.perf_counter())`` of the set-up's steps
    before this call, ``t_start`` its start."""
    import torch

    c = cell(root, workload)
    drv = driver(root, c.cfg)
    if control is not None and control not in drv.CONTROLS:
        raise ValueError(f"driver {c.cfg['driver']!r} has no control "
                         f"{control!r} (it has {list(drv.CONTROLS)})")
    ctx = SimpleNamespace(cfg=c.cfg, traffic=c.traffic, cell=c.name,
                          seed=seed, seconds=seconds, trace=trace,
                          device=device, t_start=t_start, control=control,
                          marks=tuple(marks))
    record = drv.run(ctx)
    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        value = reader(root, m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, failed, worst = judge(record["checks"], record["check_epochs"],
                                   c.limits["limits"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": int(c.entry["chips"]),
           "memory_peak_bytes": int(record["memory_peak_bytes"])}
    result = {"correct": correct, "attempted": record["n_epochs"],
              "failed": failed, "metrics": metrics, "device": dev}
    tr = record.get("trace")
    if trace and tr:
        dev["busy_s"] = tr["busy_us"] / 1e6
        dev["window_s"] = tr["window_us"] / 1e6
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["setup_parts"] = record.get("setup_parts", {})
    result["setup_cpu_s"] = record.get("setup_cpu_s", {})
    result["memory_check_bytes"] = record.get("memory_check_bytes", 0)
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in worst.items()}
    return result, worst
