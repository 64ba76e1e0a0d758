"""The device trace of a traced run, read back from ``torch.profiler``.

The window of a ``--trace 1`` run runs under ``torch.profiler`` (CPU and
CUDA activity). Its Chrome trace is written to a file under ``TMPDIR``,
read back and deleted. The benchmark's own host spans, which the
drivers open with :func:`span` (names beginning ``pb.``), place each
device operation in a layer by where the host launched it:

* launched from a thread other than the one that runs the window (a
  pool worker's dispatcher thread), or inside ``pb.asyncmap``: the pool
  layer (payload copies and the workers' products);
* launched inside ``pb.decode``: the decode;
* launched inside ``pb.check``: the benchmark's own check.

A launch is tied to its device operation by the trace's correlation
ids. A layer's device time is the union of its operations' intervals.
The device's busy time is the union of the device operations'
intervals (kernels, copies, fills) inside the ``pb.window`` span, as
``bench/serving_profile.py`` ``_busy_us`` takes it; the idle gaps
between them are named by the host span that overlaps them.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import Counter, defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "pb."
# spans that hold others; the rest are leaves, which never overlap
CONTAINERS = ("pb.window", "pb.epoch")
LAYER_OF_SPAN = {"pb.asyncmap": "pool", "pb.decode": "decode",
                 "pb.check": "check"}
TOP = 10


def span(name: str, on: bool):
    """A host span the trace can see (``record_function``), or nothing
    when the run is not traced."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def profiler(on: bool):
    """``torch.profiler.profile`` over CPU and CUDA activity, or nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def read(prof) -> dict:
    """The parsed trace of a finished profiler (see :func:`parse`)."""
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return parse(events)


def union_us(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _gaps(intervals, lo: float, hi: float):
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


class _Leaves:
    """The main thread's leaf spans, sorted, for lookups by time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: s[1])
        self.starts = [s[1] for s in self.spans]

    def at(self, t: float):
        j = bisect.bisect_right(self.starts, t) - 1
        if j >= 0 and self.spans[j][2] >= t:
            return self.spans[j][0]
        return None

    def overlap(self, lo: float, hi: float) -> dict:
        """Microseconds of ``[lo, hi]`` under each leaf span's name."""
        out: dict = defaultdict(float)
        j = max(bisect.bisect_right(self.starts, lo) - 1, 0)
        while j < len(self.spans) and self.spans[j][1] < hi:
            name, s, e = self.spans[j]
            cut = min(e, hi) - max(s, lo)
            if cut > 0:
                out[name] += cut
            j += 1
        return out


def parse(events) -> dict | None:
    """Layers, busy time, top operations and named idle gaps of one
    traced window; None when the trace holds no ``pb.window`` span or
    no device operation."""
    spans, launches, device = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            spans.append((e["name"], e.get("tid"), ts, ts + dur))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), ts)
        elif cat in DEVICE_CATS:
            device.append((cat, e.get("name", ""), ts, ts + dur,
                           args.get("correlation")))
    windows = [s for s in spans if s[0] == "pb.window"]
    if not windows or not device:
        return None
    _, main_tid, w0, w1 = windows[0]
    leaves = _Leaves([(n, s, e) for n, t, s, e in spans
                      if t == main_tid and n not in CONTAINERS])
    layers: dict = defaultdict(lambda: {"kernels": 0, "kernel": [],
                                        "all": []})
    ops: Counter = Counter()
    inside = []
    for cat, name, s, e, corr in device:
        launch = launches.get(corr)
        if launch is None:
            layer = "unknown"
        elif launch[0] != main_tid:
            layer = "pool"
        else:
            layer = LAYER_OF_SPAN.get(leaves.at(launch[1]), "other")
        rec = layers[layer]
        rec["all"].append((s, e))
        if cat == "kernel":
            rec["kernel"].append((s, e))
            rec["kernels"] += 1
        lo, hi = max(s, w0), min(e, w1)
        if hi > lo:
            inside.append((lo, hi))
            ops[name] += hi - lo
    idle: Counter = Counter()
    for lo, hi in _gaps(inside, w0, w1):
        named = leaves.overlap(lo, hi)
        for name, us in named.items():
            idle[name] += us
        rest = (hi - lo) - sum(named.values())
        if rest > 0:
            idle["host outside pb spans"] += rest
    return {
        "window_us": w1 - w0,
        "busy_us": union_us(inside),
        "layers": {k: {"kernels": v["kernels"],
                       "kernel_us": union_us(v["kernel"]),
                       "all_us": union_us(v["all"])}
                   for k, v in layers.items()},
        "device_ops": [[n, us / 1e6] for n, us in ops.most_common(TOP)],
        "idle_gaps": [[n, us / 1e6] for n, us in idle.most_common(TOP)],
    }
