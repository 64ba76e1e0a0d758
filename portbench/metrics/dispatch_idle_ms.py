"""``dispatch_idle_ms``: the head of an epoch, the device's idle ms from
the start of the pool's ``mp.pool.dispatch`` to the first device
operation a dispatcher thread launched after it, less the traffic's
stall (the least seeded stall of the tasks it handed out); the mean over
the window's epochs (``program_spans.parse``, the trace's ``program``
entry). Nothing to read without the program's ``mp.*`` spans."""


def read(record):
    head = ((record["trace"] or {}).get("program") or {}).get(
        "dispatch_idle_us")
    return sum(head) / len(head) / 1e3 if head else None
