"""Import hygiene of the torch port: importing every module of
``mpistragglers_jl_tpu_torch`` (and ``chip_smoke.py``) in a fresh
interpreter leaves ``jax`` and ``mpistragglers_jl_tpu`` out of
``sys.modules``, builds no kernel (CUDA or C++) and touches no card; the
modules a spawned worker process loads import no torch; and the port
never opens a library of the JAX package's ``native/``."""

import json
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
            "mpistragglers_jl_tpu_torch.bench.coded_train",
            "mpistragglers_jl_tpu_torch.utils.prng",
            "mpistragglers_jl_tpu_torch.utils.trace",
            "mpistragglers_jl_tpu_torch.ops.sampling",
            "mpistragglers_jl_tpu_torch.obs",
            "mpistragglers_jl_tpu_torch.obs.metrics",
            "mpistragglers_jl_tpu_torch.obs.timeline",
            "mpistragglers_jl_tpu_torch.obs.tracing",
            "mpistragglers_jl_tpu_torch.obs.flight",
            "mpistragglers_jl_tpu_torch.obs.series",
            "mpistragglers_jl_tpu_torch.obs.slo",
            "mpistragglers_jl_tpu_torch.obs.audit",
            "mpistragglers_jl_tpu_torch.obs.export",
            "mpistragglers_jl_tpu_torch.utils.faults",
            "mpistragglers_jl_tpu_torch.utils.straggle",
            "mpistragglers_jl_tpu_torch.utils.hedge",
            "mpistragglers_jl_tpu_torch.utils.checkpoint",
            "mpistragglers_jl_tpu_torch.utils.rs_gf256",
            "mpistragglers_jl_tpu_torch.ops.rateless",
            "mpistragglers_jl_tpu_torch.ops._evalgemm",
            "mpistragglers_jl_tpu_torch.ops.matdot",
            "mpistragglers_jl_tpu_torch.ops.polynomial",
            "mpistragglers_jl_tpu_torch.ops.outer_code",
            "mpistragglers_jl_tpu_torch.ops.hierarchical",
            "mpistragglers_jl_tpu_torch.ops.gf256_device",
            "mpistragglers_jl_tpu_torch.native",
            "mpistragglers_jl_tpu_torch.native.codec",
            "mpistragglers_jl_tpu_torch.native.rings",
            "mpistragglers_jl_tpu_torch.native.transport",
            "mpistragglers_jl_tpu_torch.obs.aggregate",
            "mpistragglers_jl_tpu_torch.backends.process",
            "mpistragglers_jl_tpu_torch.backends.native",
            "mpistragglers_jl_tpu_torch.worker",
            "mpistragglers_jl_tpu_torch.launch",
            "mpistragglers_jl_tpu_torch.bench.transport",
            "mpistragglers_jl_tpu_torch.bench.process_gemm",
            "mpistragglers_jl_tpu_torch.bench.launch_gemm",
            "mpistragglers_jl_tpu_torch.utils.train_checkpoint",
            "mpistragglers_jl_tpu_torch.utils.coded_checkpoint",
            "mpistragglers_jl_tpu_torch.sim",
            "mpistragglers_jl_tpu_torch.sim.clock",
            "mpistragglers_jl_tpu_torch.sim.backend",
            "mpistragglers_jl_tpu_torch.sim.replay",
            "mpistragglers_jl_tpu_torch.sim.tune",
            "mpistragglers_jl_tpu_torch.qos",
            "mpistragglers_jl_tpu_torch.qos.drr",
            "mpistragglers_jl_tpu_torch.qos.tenancy"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.')\n"
        "             or m.split('.')[0] == 'mpistragglers_jl_tpu')\n"
        "from mpistragglers_jl_tpu_torch.ops import _build\n"
        "from mpistragglers_jl_tpu_torch import native\n"
        "print('BAD', bad, 'LOADED', sorted(_build._loaded),\n"
        "      sorted(native._loaded))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD [] LOADED [] []" in out.stdout, out.stdout


# what a spawned or CLI worker process imports before its work function
_WORKER_SIDE = [
    "mpistragglers_jl_tpu_torch",
    "mpistragglers_jl_tpu_torch.worker",
    "mpistragglers_jl_tpu_torch.launch",
    "mpistragglers_jl_tpu_torch.native",
    "mpistragglers_jl_tpu_torch.native.codec",
    "mpistragglers_jl_tpu_torch.native.rings",
    "mpistragglers_jl_tpu_torch.native.transport",
    "mpistragglers_jl_tpu_torch.obs",
    "mpistragglers_jl_tpu_torch.obs.aggregate",
    "mpistragglers_jl_tpu_torch.backends",
    "mpistragglers_jl_tpu_torch.backends.process",
    "mpistragglers_jl_tpu_torch.backends.native",
    "mpistragglers_jl_tpu_torch.pool",
    "mpistragglers_jl_tpu_torch.bench.transport",
    "mpistragglers_jl_tpu_torch.bench.process_gemm",
    # the jax-free planes a host process may load: the virtual-time
    # pool simulator, QoS admission and erasure-coded checkpoints
    "mpistragglers_jl_tpu_torch.sim",
    "mpistragglers_jl_tpu_torch.qos",
    "mpistragglers_jl_tpu_torch.utils.coded_checkpoint",
]


def test_worker_side_modules_import_no_torch():
    """``import mpistragglers_jl_tpu_torch.worker`` (and the rest of what
    a worker process loads, the pool, ``from mpistragglers_jl_tpu_torch
    import ProcessBackend``) in a fresh interpreter leaves torch out of
    ``sys.modules``: a worker that stays on the host never pays for it."""
    code = (
        "import importlib, sys\n"
        f"for m in {_WORKER_SIDE!r}:\n"
        "    importlib.import_module(m)\n"
        "from mpistragglers_jl_tpu_torch import (AsyncPool, LocalBackend,\n"
        "    ProcessBackend, WorkerFailure, asyncmap, waitall)\n"
        "from mpistragglers_jl_tpu_torch.backends import NativeProcessBackend\n"
        "from mpistragglers_jl_tpu_torch import SimBackend, VirtualClock\n"
        "print('TORCH', 'torch' in sys.modules)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "TORCH False" in out.stdout, out.stdout


def test_native_libraries_load_from_the_ports_build_dir():
    """The port builds and loads its own C++ libraries (``native/_build``,
    named by source hash) and never opens one under the JAX package's
    ``native/``: the process's memory map after loading all three holds
    none of the JAX package's libraries."""
    code = (
        "import json, os\n"
        "from mpistragglers_jl_tpu_torch import native\n"
        "from mpistragglers_jl_tpu_torch.native import transport\n"
        "from mpistragglers_jl_tpu_torch.ops import lt\n"
        "from mpistragglers_jl_tpu_torch.utils import rs_gf256\n"
        "transport.load_lib(); lt._load_native()\n"
        "assert rs_gf256.RSGF256(4, 2).impl == 'native'\n"
        "maps = open(f'/proc/{os.getpid()}/maps').read()\n"
        "libs = sorted({l.split()[-1] for l in maps.splitlines()\n"
        "               if l.split()[-1].endswith('.so')})\n"
        "print('LIBS', json.dumps([l for l in libs if 'mpistragglers' in l]))\n"
        "print('PATHS', json.dumps([native.lib_path(n) for n in\n"
        "                           ('transport', 'lt_peel', 'rs_gf256')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    libs = json.loads(out.stdout.split("LIBS ", 1)[1].splitlines()[0])
    paths = json.loads(out.stdout.split("PATHS ", 1)[1].splitlines()[0])
    jax_native = os.path.join(ROOT, "mpistragglers_jl_tpu", "native")
    assert sorted(libs) == sorted(paths)
    assert all(os.path.join("mpistragglers_jl_tpu_torch", "native",
                            "_build") in p for p in libs)
    assert not any(p.startswith(jax_native + os.sep) for p in libs)
