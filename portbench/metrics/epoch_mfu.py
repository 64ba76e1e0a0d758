"""``epoch_mfu``: the decoded products' useful operations (2 * m * kdim
* ncols an epoch; the code's redundancy is not counted) over the traced
window's time, against the card's published peak in the precision the
record states (f32 where it states none), in percent."""

from portbench import bounds


def read(record):
    tr = record["trace"]
    if not tr or not tr["window_us"] or not record["n_epochs"]:
        return None
    flops = record["useful_flops_per_epoch"] * record["n_epochs"]
    return bounds.share_pct(
        bounds.bound_s(flops, 0, record.get("precision", "f32")),
        tr["window_us"] * 1e-6)
