"""What the benchmark loads: nothing of JAX or of the JAX package, and a
reference of plain PyTorch and NumPy."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from portbench.tests._tiny import REPO

FORBIDDEN = ("jax", "jaxlib", "flax", "mpistragglers_jl_tpu")

_PROBE = r"""
import json, os, sys
sys.argv = ["run.py"]
import portbench.run
from portbench import harness
man = json.load(open("BENCHMARK.json"))
for c in man["configs"]:
    cfg = json.load(open(c["file"]))
    drv = harness.load_module(".", "drivers", cfg["driver"])
for m in man["end_to_end"] + man["per_layer"]:
    harness.reader(".", m["name"])
# what the drivers load when they build the program
import mpistragglers_jl_tpu_torch.models.logreg
import mpistragglers_jl_tpu_torch.ops.coded_gemm
import mpistragglers_jl_tpu_torch.pool
import mpistragglers_jl_tpu_torch.utils.trace
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""


def test_run_drivers_and_readers_load_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert "mpistragglers_jl_tpu_torch" in top  # the port, whose name
    assert "portbench" in top                   # begins with the forbidden
    assert not top & set(FORBIDDEN), sorted(top & set(FORBIDDEN))


def test_harness_names_a_forbidden_module_by_its_whole_top_name(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "mpistragglers_jl_tpu_torch_x", sys)
    assert "mpistragglers_jl_tpu_torch_x".split(".")[0] not in FORBIDDEN
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert harness.forbidden_modules() == ["jaxlib"]


def test_reference_imports_only_torch_numpy_and_the_standard_library():
    base = os.path.join(REPO, "portbench")
    refs = sorted(f for f in os.listdir(base)
                  if f.startswith("reference") and f.endswith(".py"))
    assert "reference.py" in refs
    for ref in refs:
        with open(os.path.join(base, ref)) as f:
            tree = ast.parse(f.read())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, (ref, "a relative import")
                names.add(node.module.split(".")[0])
        allowed = {"torch", "numpy", "__future__"} | set(
            sys.stdlib_module_names)
        assert names <= allowed, (ref, sorted(names - allowed))
        assert not names & {"mpistragglers_jl_tpu_torch", "portbench"}, ref
