"""A configuration, a traffic mix and a metric added as new files are
picked up with no edit to a file that is there: a new configuration of
a driver the benchmark has, and one of a driver it has not, which brings
its test sizes, faults, control, limits and reference as new files."""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch

import portbench
from portbench import harness
from portbench.tests import test_portbench_manifest
from portbench.tests._tiny import (assert_fault_outcome, cells_and_faults,
                                   driver, fault_run, manifest, tiny_root)

# a driver of its own: y = X w, X drawn from the seed, a new w every
# epoch; its program is ``toy_program.product``, which its faults break
TOY_PROGRAM = '''
"""The toy driver's program under test: y = X w."""


def product(X, w):
    return X @ w
'''
TOY_DRIVER = '''
"""Toy driver: y = X w for the seed's X and the epoch's w."""
import time

import torch

from portbench import harness, reference_toy, toy_program

CONTROLS = ("bf16",)


def _stale(monkeypatch):
    real, first = toy_program.product, []

    def stale(X, w):
        if not first:
            first.append(real(X, w))
        return first[0]
    monkeypatch.setattr(toy_program, "product", stale)


def _half(monkeypatch):
    real = toy_program.product

    def half(X, w):
        y = real(X, w)
        y[y.shape[0] // 2:] = 0
        return y
    monkeypatch.setattr(toy_program, "product", half)


def _altered(monkeypatch):
    real = toy_program.product

    def altered(X, w):
        y = real(X, w)
        y[0] += 1.0
        return y
    monkeypatch.setattr(toy_program, "product", altered)


FAULTS = {"stale": _stale, "half": _half, "altered": _altered}


def run(ctx):
    cfg = ctx.cfg
    g = torch.Generator().manual_seed(ctx.seed)
    X = torch.randn(cfg["rows"], cfg["dim"], generator=g)
    W = torch.randn(ctx.traffic["payloads"], cfg["dim"], generator=g)
    marks = [("data", time.perf_counter())]
    Xp = X.bfloat16().float() if ctx.control == "bf16" else X
    setup_parts, setup_cpu = harness.setup_parts(ctx, marks)
    outs, w0 = [], time.perf_counter()
    while time.perf_counter() - w0 < ctx.seconds or not outs:
        outs.append(toy_program.product(Xp, W[len(outs) % len(W)]))
    window_s = time.perf_counter() - w0
    errs = [reference_toy.rel_err(y, X, W[e % len(W)])
            for e, y in enumerate(outs)]
    return {"setup_parts": setup_parts, "setup_cpu_s": setup_cpu,
            "window_s": window_s, "n_epochs": len(outs), "trace": None,
            "memory_peak_bytes": 0, "checks": {"rel_err": errs},
            "check_epochs": {"rel_err": list(range(len(outs)))}}
'''
TOY_REFERENCE = '''
"""The toy driver's plain reference: y = X w in float64."""
import torch


def rel_err(y, X, w):
    ref = X.double() @ w.double()
    return float((y.double() - ref).abs().max() / ref.abs().max())
'''


def _write(path, text):
    with open(path, "w") as f:
        f.write(text if isinstance(text, str) else json.dumps(text))


def _new_coded_gemm_config(base):
    """A new configuration of ``coded_gemm_mds``, a new traffic mix."""
    _write(os.path.join(base, "configs", "mds4x3_24.json"), {
        "name": "mds4x3_24", "driver": "coded_gemm_mds", "m": 24,
        "kdim": 24, "ncols": 24, "n": 4, "k": 3, "nwait": 3,
        "parity": "cauchy", "precision": "highest", "check_sample": 2,
        "reduced": [], "control": "tf32",
        "test": {"cpu": {"m": 12, "kdim": 12, "ncols": 12},
                 "card": {"m": 24, "kdim": 24, "ncols": 24}}})
    _write(os.path.join(base, "traffic", "slow1.json"), {
        "dispatch": "per_worker", "in_flight": 1,
        "stall": {"stragglers": [0], "stall_s": 0.5}, "payloads": 3,
        "warmup_epochs": 1})
    _write(os.path.join(base, "limits", "mds4x3_24.slow1.json"),
           {"limits": {"proj_err": 1e-4, "full_err": 1e-4}})
    # TF32 acts only on a card: its control is the card test's
    return "mds4x3_24", "slow1", {"m": 12}, False


def _new_driver_config(base):
    """A new driver with its configuration, reference and limits."""
    _write(os.path.join(base, "drivers", "toy_product.py"), TOY_DRIVER)
    _write(os.path.join(base, "toy_program.py"), TOY_PROGRAM)
    _write(os.path.join(base, "reference_toy.py"), TOY_REFERENCE)
    _write(os.path.join(base, "configs", "toy64.json"), {
        "name": "toy64", "driver": "toy_product", "rows": 64, "dim": 64,
        "precision": "highest", "reduced": [], "control": "bf16",
        "test": {"cpu": {"rows": 32, "dim": 16},
                 "card": {"rows": 64, "dim": 64}}})
    _write(os.path.join(base, "limits", "toy64.slow2.json"),
           {"limits": {"rel_err": 1e-5}})
    return "toy64", "slow2", {"rows": 32, "dim": 16}, True


@pytest.mark.parametrize("add", [_new_coded_gemm_config, _new_driver_config],
                         ids=["new_config", "new_driver"])
def test_new_files_make_a_new_cell(tmp_path, monkeypatch, add):
    root = tiny_root(tmp_path / "a")
    base = os.path.join(root, "portbench")
    before = {}
    for d, _, files in os.walk(base):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                before[os.path.join(d, f)] = fh.read()
    # the checkout's package, as ``run.py`` finds it in a checkout; its
    # new modules forgotten after the test
    monkeypatch.setattr(portbench, "__path__", [base, *portbench.__path__])
    for mod in ("portbench.reference_toy", "portbench.toy_program"):
        monkeypatch.setitem(sys.modules, mod, None)
        monkeypatch.delitem(sys.modules, mod)
    name, traffic, cut, control_on_cpu = add(base)
    cell = f"{name}.{traffic}"
    _write(os.path.join(base, "metrics", "epochs_done.py"),
           "def read(record):\n    return record['n_epochs']\n")
    man_path = os.path.join(root, "BENCHMARK.json")
    man = manifest(root)
    man["configs"].append({"name": name, "source": "x",
                           "file": f"portbench/configs/{name}.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": cell, "config": name,
                             "traffic": traffic, "chips": 1, "why": "x"})
    # metrics there take it in
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] in ("epoch_ms.host_paced",
                         "device_idle_share.host_paced"):
            m["workloads"].append(cell)
    man["end_to_end"].append({"name": "epochs_done", "unit": "epochs",
                              "better": "higher", "bound": 0.1,
                              "source": "host_clock", "workloads": [cell]})
    _write(man_path, man)
    test_portbench_manifest.check(manifest(root), root)

    res, _ = harness.run_cell(root, cell, seed=3, seconds=0.3,
                              trace=False, device=torch.device("cpu"),
                              t_start=0.0)
    assert res["correct"], res
    assert res["metrics"]["epochs_done"]["value"] == res["attempted"] > 0
    assert set(res["metrics"]) == {"epoch_ms.host_paced", "setup_s",
                                   "epochs_done"}
    # the cells that were there do not report the new metric
    res, _ = harness.run_cell(root, man["workloads"][0]["name"], seed=3,
                              seconds=0.2, trace=False,
                              device=torch.device("cpu"), t_start=0.0)
    assert "epochs_done" not in res["metrics"]
    for path, data in before.items():
        with open(path, "rb") as fh:
            assert fh.read() == data, path

    # the test sizes, faults and control it brings are found by name
    small = tiny_root(tmp_path / "b", src=root)
    with open(os.path.join(small, "portbench", "configs",
                           f"{name}.json")) as f:
        assert cut.items() <= json.load(f).items()
    ours = [(c, f) for c, f in cells_and_faults(small) if c == cell]
    assert [f for _, f in ours] == [None, "altered", "half", "stale"]
    for c, fault in ours:
        with monkeypatch.context() as mp:
            res, worst = fault_run(small, c, fault, mp)
        assert_fault_outcome(res, worst, fault)
    with open(os.path.join(small, "portbench", "configs",
                           f"{name}.json")) as f:
        control = json.load(f)["control"]
    assert control in driver(cell, small).CONTROLS
    if control_on_cpu:
        res, worst = fault_run(small, cell, None, monkeypatch,
                               control=control)
        assert res["correct"] is False, worst
