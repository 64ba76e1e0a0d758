"""Each metric reader on a record made by hand: its arithmetic, and
nothing (None) where there is nothing to read."""

from __future__ import annotations

import pytest

from portbench import bounds, harness
from portbench.tests._tiny import REPO, manifest

NAMES = [m["name"] for m in manifest()["end_to_end"] + manifest()["per_layer"]]


SETUP_PARTS = {"python and argparse": 0.25, "import torch": 5.0,
               "CUDA context": 0.5, "port import": 0.125, "CUDA init": 0.25,
               "harness": 0.5, "operands": 1.0, "program": 2.0,
               "warm-up": 5.5}


def _record(**kw):
    rec = {"setup_parts": dict(SETUP_PARTS), "window_s": 30.0,
           "n_epochs": 1000,
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
    assert _read("setup_s", r) == 9.125
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
        assert _read(name, empty) == 9.125
    else:
        assert _read(name, empty) is None


def test_a_variant_is_read_by_its_base_reader():
    r = _record()
    for name in NAMES:
        if "." in name:
            assert _read(name, r) == _read(name.split(".")[0], r), name


def test_shards_over_k_only_where_nwait_is_a_predicate():
    assert _read("lt_shards_over_k", _record(variable_nwait=False)) is None


@pytest.mark.parametrize("stated", [False, True])
def test_an_f32_record_reads_as_before(stated):
    # the readers' arithmetic before records stated a precision: the f32
    # peak, and no bytes for a product
    r = _record(**({"precision": "f32"} if stated else {}))
    assert _read("product_roofline", r) == 100 * (
        6000 * 183_341_416_448 / 67e12) / 24.0
    assert _read("epoch_mfu", r) == 100 * (
        1000 * 2 * 8192 ** 3 / 67e12) / 30.0
    assert _read("decode_roofline", r) == 100 * (
        1000 * 537_133_056 / 3.35e12) / 3.2


def test_a_bf16_record_reads_against_the_bf16_peak():
    r = _record(precision="bf16")
    assert _read("product_roofline", r) == pytest.approx(
        100 * 6000 * 183_341_416_448 / 989e12 / 24.0)
    assert _read("epoch_mfu", r) == pytest.approx(
        100 * 1000 * 2 * 8192 ** 3 / 989e12 / 30.0)
    # the decode is f32 whatever the products are: bytes, not operations
    assert _read("decode_roofline", r) == _read("decode_roofline", _record())


def test_product_bytes_bound_a_product_where_they_take_longer():
    # a gradient task: 4 operations a data element of 4 bytes, so the
    # bytes at 3.35 TB/s take longer than the operations at 67 TFLOP/s
    flops, nbytes = 4 * 187_500 * 1024, 187_500 * 1024 * 4
    r = _record(product_flops=flops, product_bytes=nbytes)
    assert _read("product_roofline", r) == pytest.approx(
        100 * 6000 * nbytes / 3.35e12 / 24.0)


def test_setup_s_leaves_out_the_interpreter_torch_and_the_context():
    parts = dict(SETUP_PARTS)
    r = _record(setup_parts=parts)
    later = sum(v for k, v in parts.items()
                if k not in ("python and argparse", "import torch",
                             "CUDA context", "CUDA init"))
    assert _read("setup_s", r) == later == 9.125
    # torch's import and start do not move it; every other part does
    for name in ("python and argparse", "import torch", "CUDA context",
                 "CUDA init"):
        assert _read("setup_s", _record(setup_parts={
            **parts, name: parts[name] + 7.0})) == 9.125
    for name in ("port import", "harness", "operands",
                 "program", "warm-up", "a driver's own step"):
        assert _read("setup_s", _record(setup_parts={
            **parts, name: parts.get(name, 0.0) + 1.0})) == 10.125, name
