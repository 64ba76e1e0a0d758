"""``product_roofline``: the workers' products against their bound, in
percent. The bound is every product dispatched in the traced window
(``EpochTracer`` dispatches and re-tasks, the drain at the close
included), each ``product_flops`` operations at the peak of the
precision the record states (f32 where it states none), or its
``product_bytes`` (where the record counts them) at the HBM peak, where
that is longer; the time is the union of the device intervals of the
kernels launched by the pool layer (the workers' threads, or
``asyncmap``'s coalesced flush), so that products running side by side
on the workers' streams count once."""

from portbench import bounds


def read(record):
    tr = record["trace"]
    pool = (tr or {}).get("layers", {}).get("pool")
    n = record["products_dispatched"]
    if not pool or not pool["kernel_us"] or not n:
        return None
    bound = bounds.bound_s(n * record["product_flops"],
                           n * record.get("product_bytes", 0),
                           record.get("precision", "f32"))
    return bounds.share_pct(bound, pool["kernel_us"] * 1e-6)
