"""A copy of the benchmark at sizes a CPU test can run."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
# rows, inner and output widths of each configuration at test size
SIZES = {"mds8x6_8192": 48, "lt16k8_16384": 64}


def manifest() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_root(tmp_path, sizes=None) -> str:
    """A checkout of ``BENCHMARK.json`` and ``portbench/`` under
    ``tmp_path``, every configuration cut to ``sizes``."""
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = manifest()
    for conf in man["configs"]:
        path = os.path.join(root, conf["file"])
        with open(path) as f:
            cfg = json.load(f)
        size = (sizes or SIZES)[conf["name"]]
        cfg.update(m=size, kdim=size, ncols=size, check_sample=3)
        with open(path, "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return root
