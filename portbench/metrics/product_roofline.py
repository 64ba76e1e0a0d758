"""``product_roofline``: the workers' products against their bound, in
percent. The bound is every product dispatched in the traced window
(``EpochTracer`` dispatches and re-tasks, the drain at the close
included), each 2 * block_rows * kdim * ncols operations at the f32
peak; the time is the union of the device intervals of the kernels
launched by the pool layer (the workers' threads, or ``asyncmap``'s
coalesced flush), so that products running side by side on the workers'
streams count once."""

from portbench import bounds


def read(record):
    tr = record["trace"]
    pool = (tr or {}).get("layers", {}).get("pool")
    if not pool or not pool["kernel_us"] or not record["products_dispatched"]:
        return None
    bound = bounds.bound_s(
        record["products_dispatched"] * record["product_flops"], 0)
    return bounds.share_pct(bound, pool["kernel_us"] * 1e-6)
