"""The program's own spans (``mp.*``) in a traced window, and what they
show of the card's idle time.

The program opens its spans through ``obs.timeline.annotate_if`` (torch's
fast record function: a ``cpu_op`` event named ``mp.*``) when ``asyncmap``
and ``result_device`` are given a tracer that asks for them
(``EpochTracer(spans=True)``), all on the coordinator (the thread that
runs the window, the profiler's own): ``mp.pool.drain``,
``mp.pool.dispatch`` (holding ``mp.backend.copy`` and ``mp.pool.flush``),
one ``mp.pool.wait`` per arrival (the wait and its bookkeeping; a
``mp.pool.retask`` inside), and the decode's ``mp.decode.select``,
``.stack``, ``.factor``, ``.gather`` and ``.solve``; a name carries its
epoch, a re-task its worker too, as ``<span>/w<worker>/e<epoch>``. The
dispatcher threads open none: their work is in the trace as the CUDA
launches they make, each under its thread's id.

:func:`parse` reads, from the same events as ``trace.parse``:

* ``dispatch_idle_us``, per epoch: the device's idle time from the start
  of the epoch's ``mp.pool.dispatch`` to the device start of the first
  operation a dispatcher thread launched after it began, less the
  traffic's stall: as much of that stretch, from its start, as the least
  seeded stall of the tasks the dispatch handed out (``stalls``). The
  head of the epoch: hand-off, the thread's wake and its launch. A stale
  task launching inside it (a straggler of an earlier epoch, after its
  own stall) ends it early;
* ``arrival_idle_us``, per epoch: the device's idle time from the device
  end of the last product kernel (a kernel launched from a thread other
  than the coordinator) that ended before the epoch's last
  ``mp.pool.wait`` returned, to that return: the tail of the epoch;
* ``decode_idle_us``: the device's idle time, over the window, while the
  coordinator is inside an ``mp.decode.*`` span;
* ``idle_gaps``: ``trace.parse``'s idle gaps, each named by the
  innermost span open on the coordinator, ``mp.*`` included (the part
  of their name before ``/``), with the same total.

Host times are taken to the device's clock (:class:`_Skew`) before they
are set against a device operation's.
"""

from __future__ import annotations

import bisect
import re
from collections import Counter, defaultdict

from . import trace

PREFIX = "mp."
# the program's spans are torch's fast record function, a ``cpu_op`` event
SPAN_CATS = ("cpu_op", "user_annotation")
_TAGS = re.compile(r"/w(\d+)|/e(\d+)")
# a launch onto an idle device starts there within microseconds: an epoch
# whose least launch-to-start reads more had all its launches queued
SKEW_KNOWN_US = 50.0


def split(name: str):
    """``(base, worker, epoch)`` of a span name ``base/w<i>/e<e>``; a tag
    that is not there is None."""
    base, _, rest = name.partition("/")
    worker = epoch = None
    for w, e in _TAGS.findall("/" + rest if rest else ""):
        if w:
            worker = int(w)
        if e:
            epoch = int(e)
    return base, worker, epoch


class _Busy:
    """The union of the device's operations, for idle time by interval."""

    def __init__(self, intervals):
        merged = []
        for s, e in sorted(intervals):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self.before = [0.0]  # busy time before merged interval j
        for s, e in merged:
            self.before.append(self.before[-1] + e - s)

    def _busy_to(self, t: float) -> float:
        j = bisect.bisect_right(self.starts, t)
        if j == 0:
            return 0.0
        return self.before[j - 1] + min(t, self.ends[j - 1]) - self.starts[
            j - 1]

    def idle(self, lo: float, hi: float) -> float:
        if hi <= lo:
            return 0.0
        return (hi - lo) - (self._busy_to(hi) - self._busy_to(lo))


class _Skew:
    """The device clock's offset from the host's, through the window.

    The profiler stamps host spans and device operations by two clocks
    that drift apart, at times by over a millisecond a second, and come
    back together (H100, torch 2.11). An operation never starts before
    its launch, so in each epoch the least ``device start - launch`` is
    the offset at that launch (the true launch latency, some
    microseconds, included); between two such points the offset is taken
    as linear. An epoch whose every launch was queued gives no point;
    with no point at all, the offset is 0."""

    def __init__(self, epochs, device, launches):
        starts = [s for s, _ in epochs]
        least = {}  # epoch -> (device start - launch, launch)
        for _, s, _, corr in device:
            launch = launches.get(corr)
            if launch is None:
                continue
            j = bisect.bisect_right(starts, launch[1]) - 1
            if j >= 0 and launch[1] <= epochs[j][1]:
                d = (s - launch[1], launch[1])
                least[j] = min(least.get(j, d), d)
        points = sorted((t, d) for d, t in least.values()
                        if d <= SKEW_KNOWN_US)
        self.at = [t for t, _ in points]
        self.of = [d for _, d in points]

    def __call__(self, t: float) -> float:
        """``t`` on the host's clock, on the device's."""
        if not self.of:
            return t
        j = bisect.bisect_right(self.at, t)
        if j == 0 or j == len(self.at):
            return t + self.of[min(j, len(self.of) - 1)]
        (t0, t1), (d0, d1) = self.at[j - 1:j + 1], self.of[j - 1:j + 1]
        return t + d0 + (d1 - d0) * (t - t0) / (t1 - t0)


def _segments(spans):
    """``(start, end, name)`` stretches of the timeline, each under the
    innermost of ``spans`` (one thread's, so nested) open there."""
    out, stack, at = [], [], None

    def to(t):
        nonlocal at
        if stack and at is not None and t > at:
            out.append((at, t, stack[-1][1]))
        at = t if at is None else max(at, t)

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            to(stack[-1][0])
            stack.pop()
        to(s)
        stack.append((e, name))
    while stack:
        to(stack[-1][0])
        stack.pop()
    return out


def _named_gaps(gaps, segments) -> Counter:
    """Microseconds of each gap under each segment's name; what no
    segment covers goes under ``trace.parse``'s name for it."""
    idle: Counter = Counter()
    starts = [s for s, _, _ in segments]
    for lo, hi in gaps:
        covered = 0.0
        j = max(bisect.bisect_right(starts, lo) - 1, 0)
        while j < len(segments) and segments[j][0] < hi:
            s, e, name = segments[j]
            cut = min(e, hi) - max(s, lo)
            if cut > 0:
                idle[name] += cut
                covered += cut
            j += 1
        if hi - lo - covered > 0:
            idle["host outside pb spans"] += hi - lo - covered
    return idle


def parse(events, stalls=None, top: int = trace.TOP) -> dict | None:
    """The program spans' readings of one traced window (see the module's
    docstring), the ``top`` idle gaps by size; None when the trace holds
    no ``pb.window``, no device operation or no ``mp.*`` span.

    ``stalls`` maps an epoch to the seconds of the least stall that the
    traffic's ``delay_fn`` waits, before the launch, in a task that the
    epoch's dispatch handed out (0 where one of them does not stall);
    an epoch it does not name has none. A launch is told from the
    coordinator's by its thread alone, not tied to a worker: a thread
    the profiler does not profile carries CUPTI's thread id, which does
    not reliably match any of its ``threading`` ids."""
    spans, launches, device = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        name = e.get("name", "")
        if (cat == "user_annotation" and name.startswith(trace.PREFIX)
                or cat in SPAN_CATS and name.startswith(PREFIX)):
            spans.append((name, e.get("tid"), ts, ts + dur))
        elif cat in trace.LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), ts)
        elif cat in trace.DEVICE_CATS:
            device.append((cat, ts, ts + dur, args.get("correlation")))
    windows = [s for s in spans if s[0] == "pb.window"]
    if not windows or not device or not any(
            s[0].startswith(PREFIX) for s in spans):
        return None
    _, main, w0, w1 = windows[0]
    inside = [(max(s, w0), min(e, w1)) for _, s, e, _ in device
              if min(e, w1) > max(s, w0)]
    busy = _Busy([(s, e) for _, s, e, _ in device])
    dev = _Skew(sorted((s, e) for n, t, s, e in spans
                       if n == "pb.epoch" and t == main), device, launches)

    mine = []  # the coordinator's spans, less trace.parse's containers
    decode = []  # its mp.decode.* spans, on the device's clock
    dispatch = {}  # epoch -> start of its mp.pool.dispatch
    waits = defaultdict(list)  # epoch -> ends of its mp.pool.wait
    for name, tid, s, e in spans:
        if tid != main:
            continue
        base, _, epoch = split(name)
        if base not in trace.CONTAINERS:
            mine.append((s, e, base))
        if base == "mp.pool.dispatch":
            dispatch[epoch] = s
        elif base == "mp.pool.wait":
            waits[epoch].append(e)
        elif base.startswith("mp.decode."):
            decode.append((dev(s), dev(e)))

    # the operations the dispatcher threads launched, by launch, and the
    # product kernels' ends
    ops, product_ends = [], []
    for cat, s, e, corr in device:
        launch = launches.get(corr)
        if launch is None or launch[0] == main:
            continue
        ops.append((launch[1], s))
        if cat == "kernel":
            product_ends.append(e)
    ops.sort()
    product_ends.sort()

    # host times below are taken to the device's clock (dev) before they
    # meet a device operation's
    head, tail = [], []
    for epoch, h0 in sorted(dispatch.items()):
        if not w0 <= h0 <= w1:
            continue
        d0 = dev(h0)
        j = bisect.bisect_left(ops, (h0, float("-inf")))
        if j < len(ops):
            t1 = max(ops[j][1], d0)
            stall = (stalls or {}).get(epoch, 0.0) * 1e6
            head.append(busy.idle(d0, t1)
                        - busy.idle(d0, min(t1, d0 + stall)))
        if waits.get(epoch):
            t_r = dev(max(waits[epoch]))
            j = bisect.bisect_left(product_ends, t_r) - 1
            if j >= 0:
                tail.append(busy.idle(max(product_ends[j], d0), t_r))

    # trace.parse's gaps, named by the coordinator's spans on the
    # device's clock (a segment cut where the offset's change moves it
    # over the one before)
    segments, at = [], float("-inf")
    for s, e, name in _segments(mine):
        s, e = max(dev(s), at), dev(s) + (e - s)
        if e > s:
            segments.append((s, e, name))
            at = e
    named = _named_gaps(trace._gaps(inside, w0, w1), segments)
    return {
        "dispatch_idle_us": head,
        "arrival_idle_us": tail,
        "decode_spans": len(decode),
        "decode_idle_us": sum(busy.idle(s, e) for s, e in decode),
        "idle_gaps": [[n, us / 1e6] for n, us in named.most_common(top)],
        "clock_skew_us": sorted(dev.of),
    }
