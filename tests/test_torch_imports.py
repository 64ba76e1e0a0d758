"""Import hygiene of the torch port: importing every module of
``mpistragglers_jl_tpu_torch`` (and ``chip_smoke.py``) in a fresh
interpreter leaves ``jax`` and ``mpistragglers_jl_tpu`` out of
``sys.modules``, builds no kernel and touches no card."""

import os
import pkgutil
import subprocess
import sys

import mpistragglers_jl_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    pkg = mpistragglers_jl_tpu_torch
    names = [pkg.__name__]
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        names.append(info.name)
    return names


def test_port_modules_import_neither_jax_nor_the_jax_package():
    mods = _port_modules() + ["chip_smoke"]
    assert {"mpistragglers_jl_tpu_torch.ops.decode_attention",
            "mpistragglers_jl_tpu_torch.ops.flash_attention",
            "mpistragglers_jl_tpu_torch.models.paging",
            "mpistragglers_jl_tpu_torch.models.transformer",
            "mpistragglers_jl_tpu_torch.bench.train_profile",
            "mpistragglers_jl_tpu_torch.bench.decode_kernel_attrib",
            "mpistragglers_jl_tpu_torch.bench.configs",
            "mpistragglers_jl_tpu_torch.models.speculative",
            "mpistragglers_jl_tpu_torch.pool",
            "mpistragglers_jl_tpu_torch.backends.cuda",
            "mpistragglers_jl_tpu_torch.ops.coded_gemm",
            "mpistragglers_jl_tpu_torch.models.logreg",
            "mpistragglers_jl_tpu_torch.bench.coded_gemm",
            "mpistragglers_jl_tpu_torch.models.moe",
            "mpistragglers_jl_tpu_torch.models.coded_train",
            "mpistragglers_jl_tpu_torch.bench.moe_train",
            "mpistragglers_jl_tpu_torch.bench.coded_train"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.')\n"
        "             or m.split('.')[0] == 'mpistragglers_jl_tpu')\n"
        "from mpistragglers_jl_tpu_torch.ops import _build\n"
        "print('BAD', bad, 'LOADED', sorted(_build._loaded))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD [] LOADED []" in out.stdout, out.stdout
