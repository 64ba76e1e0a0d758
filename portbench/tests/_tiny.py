"""A copy of the benchmark at sizes a test can run, and the fault test's
machinery, which finds everything by name: the test sizes in each
configuration's ``test`` group, the faults in each driver's ``FAULTS``."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
SEED = 2 ** 31 + 99


def manifest(root: str = REPO) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_config(cell: str, root: str = REPO) -> dict:
    """The configuration file of ``cell`` in the checkout at ``root``."""
    man = manifest(root)
    name = next(w["config"] for w in man["workloads"] if w["name"] == cell)
    conf = next(c for c in man["configs"] if c["name"] == name)
    with open(os.path.join(root, conf["file"])) as f:
        return json.load(f)


def tiny_root(tmp_path, where: str = "cpu", src: str = REPO) -> str:
    """A checkout of ``BENCHMARK.json`` and ``portbench/`` of ``src``
    under ``tmp_path``, every configuration cut to the test size its
    file's ``test`` group gives for ``where`` (``cpu`` or ``card``)."""
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(src, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = manifest(src)
    for conf in man["configs"]:
        path = os.path.join(root, conf["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(cfg["test"][where])
        with open(path, "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return root


def driver(cell: str, root: str = REPO):
    """The driver module of ``cell`` in the checkout at ``root``."""
    from portbench import harness

    return harness.driver(root, cell_config(cell, root))


def cells_and_faults(root: str = REPO) -> list:
    """``(cell, fault)`` for every cell, once sound (None) and once with
    each fault its driver declares."""
    return [(w["name"], f) for w in manifest(root)["workloads"]
            for f in [None] + sorted(driver(w["name"], root).FAULTS)]


def fault_run(root: str, cell: str, fault, monkeypatch, seed: int = SEED,
              seconds: float = 0.3, control=None):
    """``harness.run_cell`` of ``cell`` on the CPU, with ``fault`` (a name
    of its driver's ``FAULTS``, or None) planted by ``monkeypatch``."""
    import torch

    from portbench import harness

    if fault is not None:
        driver(cell, root).FAULTS[fault](monkeypatch)
    return harness.run_cell(root, cell, seed=seed, seconds=seconds,
                            trace=False, device=torch.device("cpu"),
                            t_start=0.0, control=control)


def assert_fault_outcome(res, worst, fault) -> None:
    """Sound runs are correct; a run with a fault is not, on some epoch."""
    assert res["attempted"] > 0
    assert res["correct"] is (fault is None), worst
    if fault is not None:
        assert res["failed"] > 0
    assert list(res)[-1] == "checks"
