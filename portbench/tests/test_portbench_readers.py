"""Each metric reader on a record made by hand: its arithmetic, and
nothing (None) where there is nothing to read."""

from __future__ import annotations

import pytest

from portbench import bounds, harness
from portbench.tests._tiny import REPO, manifest

NAMES = [m["name"] for m in manifest()["end_to_end"] + manifest()["per_layer"]]


def _record(**kw):
    rec = {"setup_s": 9.5, "window_s": 30.0, "n_epochs": 1000,
           "latency_ms": [float(i) for i in range(1, 101)],
           "asyncmap_host_ms": [20.0, 24.0], "fresh_at_return": [8, 12],
           "k": 8, "variable_nwait": True,
           "useful_flops_per_epoch": 2 * 8192 ** 3,
           "product_flops": bounds.product_flops(1366, 8192, 8192),
           "products_dispatched": 6000,
           "decode_bytes": bounds.decode_bytes(6, 1366, 8192),
           "decode_flops": bounds.decode_flops(6, 1366, 8192),
           "trace": {"window_us": 30e6, "busy_us": 27e6,
                     "layers": {"pool": {"kernels": 6000,
                                         "kernel_us": 24e6, "all_us": 25e6},
                                "decode": {"kernels": 9000,
                                           "kernel_us": 3e6, "all_us": 3.2e6}},
                     "device_ops": [], "idle_gaps": []}}
    rec.update(kw)
    return rec


def _read(name, record):
    return harness.reader(REPO, name).read(record)


def test_readers_arithmetic():
    r = _record()
    assert _read("setup_s", r) == 9.5
    assert _read("epoch_ms", r) == pytest.approx(30.0)
    assert _read("epoch_p95_ms", r) == pytest.approx(95.05)
    assert _read("pool_host_ms", r) == pytest.approx(22.0)
    assert _read("lt_shards_over_k", r) == pytest.approx(1.25)
    assert _read("device_idle_share", r) == pytest.approx(10.0)
    assert _read("decode_ms", r) == pytest.approx(3.2)
    assert _read("product_roofline", r) == pytest.approx(
        100 * 6000 * 183_341_416_448 / 67e12 / 24.0)
    assert _read("decode_roofline", r) == pytest.approx(
        100 * 1000 * 537_133_056 / 3.35e12 / 3.2)
    assert _read("epoch_mfu", r) == pytest.approx(
        100 * 1000 * 2 * 8192 ** 3 / 67e12 / 30.0)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_gives_nothing(name):
    empty = _record(n_epochs=0, latency_ms=[], asyncmap_host_ms=[],
                    fresh_at_return=[], products_dispatched=None, trace=None)
    if name == "setup_s":
        assert _read(name, empty) == 9.5
    else:
        assert _read(name, empty) is None


def test_a_variant_is_read_by_its_base_reader():
    r = _record()
    for name in NAMES:
        if "." in name:
            assert _read(name, r) == _read(name.split(".")[0], r), name


def test_shards_over_k_only_where_nwait_is_a_predicate():
    assert _read("lt_shards_over_k", _record(variable_nwait=False)) is None
