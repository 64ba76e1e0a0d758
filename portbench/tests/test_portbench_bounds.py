"""The bound arithmetic against counts made by hand."""

from __future__ import annotations

import pytest

from portbench import bounds


def test_peaks_are_the_data_sheets():
    assert bounds.FP32_FLOPS_PER_S == 67e12
    assert bounds.BF16_FLOPS_PER_S == 989e12
    assert bounds.HBM_BYTES_PER_S == 3.35e12
    assert bounds.bound_s(989e12, 0, "bf16") == 1.0
    assert bounds.bound_s(67e12, 0) == bounds.bound_s(67e12, 0, "f32") == 1.0


def test_product_of_one_mds_worker():
    # 1366 rows (8196 / 6) of 8192 times 8192 x 8192: 2 * 1366 * 8192^2
    assert bounds.product_flops(1366, 8192, 8192) == 183_341_416_448
    assert bounds.bound_s(183_341_416_448, 0) == pytest.approx(
        183_341_416_448 / 67e12)


def test_decode_bytes_of_the_mds_and_lt_configs():
    # six shards of 1366 x 8192 f32 in, 8196 x 8192 f32 out
    assert bounds.decode_bytes(6, 1366, 8192) == 6 * 1366 * 8192 * 4 * 2
    assert bounds.decode_bytes(6, 1366, 8192) == 537_133_056
    assert bounds.bound_s(bounds.decode_flops(6, 1366, 8192),
                          537_133_056) == pytest.approx(537_133_056 / 3.35e12)
    # eight shards of 2048 x 16384 in, 16384 x 16384 out: 2 GiB
    assert bounds.decode_bytes(8, 2048, 16384) == 2 * 2 ** 30


def test_decode_flops_are_the_two_solves():
    assert bounds.decode_flops(6, 1366, 8192) == 2 * 36 * 1366 * 8192


def test_shares():
    assert bounds.share_pct(1.0, 2.0) == 50.0
    assert bounds.share_pct(1.0, 0.0) is None
    assert bounds.share_pct(1.0, None) is None
