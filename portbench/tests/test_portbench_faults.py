"""A run whose timed path is broken underneath comes out not correct.

Each cell runs at its configuration's CPU test size (the harness's look
for a card is skipped: ``harness.run_cell`` is driven directly), once
sound and once with each fault its driver declares (``FAULTS``: a step
that returns its state unchanged, part of the result left out, a
worker's output altered where it is produced; ``pool_gemm`` and
``drivers/coded_sgd.py`` say how each is planted).

The cells run on one chip, so no exchange between chips can be left out.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.tests._tiny import (REPO, assert_fault_outcome,
                                   cells_and_faults, fault_run, manifest,
                                   tiny_root)

CELLS = [w["name"] for w in manifest()["workloads"]]


@pytest.mark.parametrize("cell,fault", cells_and_faults())
def test_fault_makes_the_run_not_correct(tmp_path, monkeypatch, cell, fault):
    root = tiny_root(tmp_path)
    res, worst = fault_run(root, cell, fault, monkeypatch)
    assert_fault_outcome(res, worst, fault)


def test_run_without_a_card_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_run_in_a_bare_checkout_fails(tmp_path):
    """Only ``BENCHMARK.json`` and ``portbench/``: no program, no run."""
    root = tiny_root(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "mpistragglers_jl_tpu_torch" in proc.stderr
    assert json.load(open(os.path.join(root, "BENCHMARK.json")))
