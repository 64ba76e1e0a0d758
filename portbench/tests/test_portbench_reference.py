"""The coded-GEMM reference's comparisons over some rows, and what they
catch that the whole product's cannot: a product rounded to bf16 where a
configuration stores its blocks in bf16."""

from __future__ import annotations

import pytest
import torch

from portbench import harness, reference
from portbench.tests._tiny import fault_run, manifest, tiny_root

BF16_CELLS = [w["name"] for w in manifest()["workloads"]
              if w["config"].endswith("_bf16")]


def _operands():
    g = torch.Generator().manual_seed(5)
    return (torch.randn(12, 7, generator=g), torch.randn(7, 5, generator=g),
            torch.randn(5, generator=g))


@pytest.mark.parametrize("row,inside", [(1, True), (9, False)])
def test_rel_err_over_rows_sees_only_those_rows(row, inside):
    A, B, _ = _operands()
    C = A @ B
    C[row, 2] += 1.0
    whole = reference.rel_err(C, A, B)
    part = reference.rel_err(C, A, B, ((0, 4), (6, 8)) if inside
                             else ((0, 4),))
    assert whole > 1e-3
    if inside:
        assert part == pytest.approx(whole)
    else:
        assert part < 1e-6


@pytest.mark.parametrize("row,inside", [(1, True), (9, False)])
def test_proj_rel_err_over_rows_sees_only_those_rows(row, inside):
    A, B, v = _operands()
    ref = reference.projection(A, B, v)
    y = (A @ B) @ v
    y[row] += 1.0
    whole = reference.proj_rel_err(y, ref)
    part = reference.proj_rel_err(y, ref, ((0, 4),) if not inside
                                  else ((0, 2),))
    assert whole > 1e-3
    if inside:
        assert part == pytest.approx(whole)
    else:
        assert part < 1e-6


def test_as_stored_rounds_to_bf16_at_default_only():
    A, _, _ = _operands()
    assert reference.as_stored(A, "highest") is A
    q = reference.as_stored(A, "default")
    assert q.dtype == torch.float32
    assert torch.equal(q, A.to(torch.bfloat16).float())
    assert not torch.equal(q, A)


@pytest.mark.parametrize("cell", BF16_CELLS)
def test_products_rounded_to_bf16_fail_only_by_the_direct_blocks(
        tmp_path, monkeypatch, cell):
    """The parity shards' bf16 rounding, through the decode, hides the
    control in the whole product; the blocks a systematic shard delivered
    straight show it."""
    root = tiny_root(tmp_path)
    limits = harness.cell(root, cell).limits["limits"]
    res, worst = fault_run(root, cell, None, monkeypatch, control="bf16_out")
    assert res["correct"] is False
    assert worst["proj_err"][0] <= limits["proj_err"]
    assert worst["proj_err_direct"][0] > 10 * limits["proj_err_direct"]
    assert worst["full_err_direct"][0] > 10 * limits["full_err_direct"]
