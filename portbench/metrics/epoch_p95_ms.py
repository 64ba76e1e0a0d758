"""``epoch_p95_ms``: the 95th percentile (numpy's linear interpolation)
over every epoch of the window of the time from the ``asyncmap`` call to
the decoded product complete on the card, read from CUDA events on the
issuing stream. Only closed-loop traffic has it."""

import numpy as np


def read(record):
    lat = record["latency_ms"]
    if not lat:
        return None
    return float(np.percentile(lat, 95))
