"""``epoch_ms``: the window's wall time (host clock, from the first
``asyncmap`` after warm-up to the completion of the last epoch issued
before the window's seconds had passed) over the decoded epochs
completed in it."""


def read(record):
    if not record["n_epochs"]:
        return None
    return record["window_s"] * 1e3 / record["n_epochs"]
