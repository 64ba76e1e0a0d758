"""A run whose timed path is broken underneath comes out not correct.

Each cell runs at test size on the CPU (the harness's look for a card is
skipped: ``harness.run_cell`` is driven directly), once sound and once
with each fault the coded-GEMM cells can have planted in the program:

* ``stale``: the decode returns its first product every epoch (a step
  that returns its state unchanged);
* ``half``: the decoded product's second half of rows left out (zeros);
* ``altered``: every worker's product altered in one element where it
  is produced.

The cells run on one chip, so no exchange between chips can be left out.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness, pool_gemm
from portbench.tests._tiny import REPO, manifest, tiny_root

CELLS = [w["name"] for w in manifest()["workloads"]]
SEED = 2 ** 31 + 99


def _stale(decode):
    first = []

    def wrapped(pool):
        C = decode(pool)
        if not first:
            first.append(C.clone())
        return first[0]
    return wrapped


def _half(decode):
    def wrapped(pool):
        C = decode(pool).clone()
        C[C.shape[0] // 2:] = 0
        return C
    return wrapped


def _plant(monkeypatch, fault):
    if fault in ("stale", "half"):
        wrap = {"stale": _stale, "half": _half}[fault]
        build = pool_gemm.program

        def program(backend, nwait, decode, **kw):
            return build(backend, nwait, wrap(decode), **kw)

        monkeypatch.setattr(pool_gemm, "program", program)
    elif fault == "altered":
        from mpistragglers_jl_tpu_torch.ops import _batch, gemm

        def altering(matmul):
            def wrapped(a, b, precision):
                out = matmul(a, b, precision)
                out.reshape(-1)[0] += 1.0
                return out
            return wrapped

        monkeypatch.setattr(gemm, "matmul", altering(gemm.matmul))
        monkeypatch.setattr(_batch, "matmul", altering(_batch.matmul))


@pytest.mark.parametrize("fault", [None, "stale", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_the_run_not_correct(tmp_path, monkeypatch, cell, fault):
    root = tiny_root(tmp_path)
    _plant(monkeypatch, fault)
    res, worst = harness.run_cell(root, cell, seed=SEED, seconds=0.3,
                                  trace=False, device=torch.device("cpu"),
                                  t_start=0.0)
    assert res["attempted"] > 0
    assert res["correct"] is (fault is None), worst
    if fault is not None:
        assert res["failed"] > 0
    assert list(res)[-1] == "checks"


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
