"""``decode_ms``: device ms per epoch (the union of the intervals) of
every operation launched inside the benchmark's span around the
program's decode (``result_device``)."""


def read(record):
    tr = record["trace"]
    dec = (tr or {}).get("layers", {}).get("decode")
    if not dec or not dec["all_us"] or not record["n_epochs"]:
        return None
    return dec["all_us"] / 1e3 / record["n_epochs"]
