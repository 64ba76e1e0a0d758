"""The lower-precision controls on the card: each control a cell's
configuration states (``control`` in its file: TF32 products where it
states f32; float8 operands, and products rounded to bf16, where it
states bf16 operands and f32 products) must come out not correct, and
the program as stated correct, under each cell's limits.

At the size the configuration's ``test.card`` group gives, which a test
run can hold; the cells' own sizes are run by ``portbench/run.py
--control <name>``. Needs a CUDA card::

    python -m pytest portbench/tests -m gpu
"""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests._tiny import cell_config, manifest, tiny_root

CASES = [(w["name"], control) for w in manifest()["workloads"]
         for control in [None, *harness.controls(cell_config(w["name"]))]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell,control", CASES)
def test_tf32_control_is_not_correct(tmp_path, cell, control):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tiny_root(tmp_path, "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res, worst = harness.run_cell(
            root, cell, seed=2 ** 31 + 7, seconds=2.0, trace=False,
            device=torch.device("cuda", 0), t_start=0.0, control=control)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert res["attempted"] > 0
    assert res["correct"] is (control is None), worst
