"""``decode_idle_ms``: the device's idle ms per epoch while the
coordinator is inside one of the decode's ``mp.decode.*`` spans
(``program_spans.parse``, the trace's ``program`` entry). Nothing to
read without those spans."""


def read(record):
    prog = (record["trace"] or {}).get("program")
    if not prog or not prog["decode_spans"] or not record["n_epochs"]:
        return None
    return prog["decode_idle_us"] / 1e3 / record["n_epochs"]
