"""``device_idle_share``: the share of the traced window, in percent, in
which no operation ran on the device (1 - the union of the device
operations' intervals over the window)."""


def read(record):
    tr = record["trace"]
    if not tr or not tr["window_us"]:
        return None
    return 100.0 * (1.0 - tr["busy_us"] / tr["window_us"])
