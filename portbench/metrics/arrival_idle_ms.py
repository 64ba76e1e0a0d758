"""``arrival_idle_ms``: the tail of an epoch, the device's idle ms from
the end of the last product kernel before the epoch's last
``mp.pool.wait`` returned, to that return (arrival detection, notify and
the coordinator's wake); the mean over the window's epochs
(``program_spans.parse``, the trace's ``program`` entry). Nothing to
read without the program's ``mp.*`` spans."""


def read(record):
    tail = ((record["trace"] or {}).get("program") or {}).get(
        "arrival_idle_us")
    return sum(tail) / len(tail) / 1e3 if tail else None
