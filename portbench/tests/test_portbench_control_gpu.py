"""The lower-precision control on the card: the program's products in
TF32 (the configurations state f32 with TF32 off) must come out not
correct, and the program as stated correct, under each cell's limits.

At 2048 rows, a size a test run can hold; the cells' own sizes are run
by ``portbench/run.py --control tf32``. Needs a CUDA card::

    python -m pytest portbench/tests -m gpu
"""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests._tiny import manifest, tiny_root

CELLS = [w["name"] for w in manifest()["workloads"]]
SIZES = {"mds8x6_8192": 2048, "lt16k8_16384": 2048}


@pytest.mark.gpu
@pytest.mark.parametrize("control", [None, "tf32"])
@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_is_not_correct(tmp_path, cell, control):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tiny_root(tmp_path, SIZES)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res, worst = harness.run_cell(
            root, cell, seed=2 ** 31 + 7, seconds=2.0, trace=False,
            device=torch.device("cuda", 0), t_start=0.0, control=control)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert res["attempted"] > 0
    assert res["correct"] is (control is None), worst
