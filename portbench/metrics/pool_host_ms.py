"""``pool_host_ms``: host ms per epoch inside ``pool.asyncmap`` (the
dispatch, the wait for the fastest k or the decodable set, the re-tasks
of stale workers), the mean over the window's epochs of the benchmark's
own span around each call."""


def read(record):
    ms = record["asyncmap_host_ms"]
    return sum(ms) / len(ms) if ms else None
