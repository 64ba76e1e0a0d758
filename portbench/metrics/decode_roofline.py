"""``decode_roofline``: the decode against its bound, in percent. The
bound of an epoch's decode is the k fresh shards read once and the
product written once at the HBM peak (or its two triangular solves at
the f32 peak, where larger); the time is ``decode_ms``'s."""

from portbench import bounds


def read(record):
    tr = record["trace"]
    dec = (tr or {}).get("layers", {}).get("decode")
    if not dec or not dec["all_us"] or not record["n_epochs"]:
        return None
    bound = record["n_epochs"] * bounds.bound_s(record["decode_flops"],
                                                record["decode_bytes"])
    return bounds.share_pct(bound, dec["all_us"] * 1e-6)
