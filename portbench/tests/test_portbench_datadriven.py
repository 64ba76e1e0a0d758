"""A configuration, a traffic mix and a metric added as new files are
picked up with no edit to a file that is there."""

from __future__ import annotations

import json
import os

import torch

from portbench import harness
from portbench.tests._tiny import tiny_root


def test_new_files_make_a_new_cell(tmp_path):
    root = tiny_root(tmp_path)
    base = os.path.join(root, "portbench")
    before = {}
    for d, _, files in os.walk(base):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                before[os.path.join(d, f)] = fh.read()
    with open(os.path.join(base, "configs", "mds4x3_24.json"), "w") as f:
        json.dump({"name": "mds4x3_24", "driver": "coded_gemm_mds",
                   "m": 24, "kdim": 24, "ncols": 24, "n": 4, "k": 3,
                   "nwait": 3, "parity": "cauchy", "precision": "highest",
                   "check_sample": 2, "reduced": []}, f)
    with open(os.path.join(base, "traffic", "slow1.json"), "w") as f:
        json.dump({"dispatch": "per_worker", "in_flight": 1,
                   "stall": {"stragglers": [0], "stall_s": 0.5},
                   "payloads": 3, "warmup_epochs": 1}, f)
    with open(os.path.join(base, "limits", "mds4x3_24.slow1.json"), "w") as f:
        json.dump({"limits": {"proj_err": 1e-4, "full_err": 1e-4}}, f)
    with open(os.path.join(base, "metrics", "epochs_done.py"), "w") as f:
        f.write("def read(record):\n    return record['n_epochs']\n")
    man_path = os.path.join(root, "BENCHMARK.json")
    with open(man_path) as f:
        man = json.load(f)
    man["configs"].append({"name": "mds4x3_24", "source": "x",
                           "file": "portbench/configs/mds4x3_24.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "mds4x3_24.slow1", "config": "mds4x3_24",
                             "traffic": "slow1", "chips": 1, "why": "x"})
    for m in man["end_to_end"]:  # an end-to-end metric there takes it in
        if m["name"] == "epoch_ms.host_paced":
            m["workloads"].append("mds4x3_24.slow1")
    man["end_to_end"].append({"name": "epochs_done", "unit": "epochs",
                              "better": "higher", "bound": 0.1,
                              "source": "host_clock",
                              "workloads": ["mds4x3_24.slow1"]})
    with open(man_path, "w") as f:
        json.dump(man, f)

    res, _ = harness.run_cell(root, "mds4x3_24.slow1", seed=3, seconds=0.3,
                              trace=False, device=torch.device("cpu"),
                              t_start=0.0)
    assert res["correct"], res
    assert res["metrics"]["epochs_done"]["value"] == res["attempted"] > 0
    assert set(res["metrics"]) == {"epoch_ms.host_paced", "setup_s",
                                   "epochs_done"}
    # the cells that were there do not report the new metric
    res, _ = harness.run_cell(root, "mds8x6_8192.pipelined", seed=3,
                              seconds=0.2, trace=False,
                              device=torch.device("cpu"), t_start=0.0)
    assert "epochs_done" not in res["metrics"]
    for path, data in before.items():
        with open(path, "rb") as fh:
            assert fh.read() == data, path
