"""Import hygiene of the torch port: importing every module of
``mpistragglers_jl_tpu_torch`` (and ``chip_smoke.py``) in a fresh
interpreter leaves ``jax`` and ``mpistragglers_jl_tpu`` out of
``sys.modules``, builds no kernel (CUDA or C++) and touches no card; the
modules a spawned worker process loads, and the host planes (the
router, the router-day simulator, fleet control and chaos), import no
torch; and the port never opens a library of the JAX package's
``native/``.

Two static rules of the host planes ride along, checked on the AST of
the port's sources: nothing in ``sim/``, ``fleet/`` or ``chaos/`` calls
an OS clock (their days replay bit for bit only because the scenario is
the only source of time), and no code path of the router or the
simulator sheds a request without naming its reason.
"""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

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
            "mpistragglers_jl_tpu_torch.qos.tenancy",
            "mpistragglers_jl_tpu_torch.models.disagg",
            "mpistragglers_jl_tpu_torch.cache",
            "mpistragglers_jl_tpu_torch.cache.client",
            "mpistragglers_jl_tpu_torch.cache.directory",
            "mpistragglers_jl_tpu_torch.cache.planner",
            "mpistragglers_jl_tpu_torch.cache.store",
            "mpistragglers_jl_tpu_torch.bench.disagg",
            "mpistragglers_jl_tpu_torch.models.router",
            "mpistragglers_jl_tpu_torch.sim.workload",
            "mpistragglers_jl_tpu_torch.sim.fastpath",
            "mpistragglers_jl_tpu_torch.fleet",
            "mpistragglers_jl_tpu_torch.fleet.signals",
            "mpistragglers_jl_tpu_torch.fleet.controller",
            "mpistragglers_jl_tpu_torch.fleet.failover",
            "mpistragglers_jl_tpu_torch.chaos",
            "mpistragglers_jl_tpu_torch.chaos.report",
            "mpistragglers_jl_tpu_torch.chaos.scenarios",
            "mpistragglers_jl_tpu_torch.chaos.injector",
            "mpistragglers_jl_tpu_torch.bench.router",
            "mpistragglers_jl_tpu_torch.parallel",
            "mpistragglers_jl_tpu_torch.parallel.mesh",
            "mpistragglers_jl_tpu_torch.parallel.collectives",
            "mpistragglers_jl_tpu_torch.parallel.mesh_gemm",
            "mpistragglers_jl_tpu_torch.parallel.fused",
            "mpistragglers_jl_tpu_torch.parallel.device_coord",
            "mpistragglers_jl_tpu_torch.parallel.multihost",
            "mpistragglers_jl_tpu_torch.parallel.pipeline",
            "mpistragglers_jl_tpu_torch.bench.pipeline_train",
            "mpistragglers_jl_tpu_torch.bench.device_coord",
            "mpistragglers_jl_tpu_torch.bench.fused"} <= set(mods)
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
    # the planes above serving: routing, the router-day simulator,
    # fleet control and chaos
    "mpistragglers_jl_tpu_torch.models.router",
    "mpistragglers_jl_tpu_torch.sim.workload",
    "mpistragglers_jl_tpu_torch.sim.fastpath",
    "mpistragglers_jl_tpu_torch.fleet",
    "mpistragglers_jl_tpu_torch.chaos",
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


def test_host_planes_run_a_day_without_torch():
    """Not only importing: a routed day on the scalar and the fast
    driver, a fleet day with a coordinator kill, every chaos episode
    (the COW-churn one drives ``models/paging.PagePool``) and the
    router-policy sweep run in a fresh interpreter without loading
    torch."""
    code = (
        "import sys, tempfile\n"
        "from mpistragglers_jl_tpu_torch import sim, chaos, fleet\n"
        "from mpistragglers_jl_tpu_torch.models.router import RequestRouter\n"
        "for drive in (sim.run_router_day, sim.run_router_day_fast):\n"
        "    c = sim.VirtualClock()\n"
        "    r = RequestRouter([sim.SimReplica(c, tick_s=0.02)\n"
        "                       for _ in range(2)], clock=c)\n"
        "    drive(r, sim.poisson_arrivals(20.0, n=100, seed=1)).digest()\n"
        "sim.sweep_router_policy(requests=100)\n"
        "for name in sorted(chaos.SCENARIOS):\n"
        "    small = {'prefix_churn': {'steps': 800}}.get(name, {'n': 1200})\n"
        "    chaos.ChaosInjector().run(chaos.get_scenario(name, seed=5,\n"
        "                                                 **small))\n"
        "c = sim.VirtualClock()\n"
        "r = RequestRouter([sim.SimReplica(c, tick_s=0.02)\n"
        "                   for _ in range(3)], clock=c)\n"
        "ck = fleet.FleetCheckpointer(tempfile.mkdtemp(), n=3, k=2)\n"
        "sup = fleet.ControllerSupervisor(lambda: fleet.FleetController(\n"
        "    r, clock=c, capacity_rps=50.0, min_replicas=1,\n"
        "    checkpointer=ck, checkpoint_every_s=1.0), clock=c)\n"
        "sim.run_router_day(r, sim.poisson_arrivals(30.0, n=200, seed=2),\n"
        "                   controller=sup, events=[sim.CoordinatorKill(2.0)])\n"
        "print('TORCH', 'torch' in sys.modules, sup.n_kills)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "TORCH False 1" in out.stdout, out.stdout


# -- the clock rule and the shed-by-name rule, on the AST -----------------

_PORT = os.path.join(ROOT, "mpistragglers_jl_tpu_torch")
_CLOCKS = {"time", "perf_counter", "monotonic", "time_ns",
           "perf_counter_ns", "monotonic_ns", "process_time"}


def _sources(*dirs):
    out = []
    for d in dirs:
        path = os.path.join(_PORT, d)
        if path.endswith(".py"):
            out.append(path)
            continue
        out += sorted(os.path.join(path, f) for f in os.listdir(path)
                      if f.endswith(".py"))
    return out


def clock_calls(source: str) -> list:
    """(line, callee) of every OS-clock read in ``source``: a call of
    ``time.<clock>()``, ``datetime.now()``/``utcnow()``, or of a clock
    imported by name from ``time``."""
    tree = ast.parse(source)
    named = {a.asname or a.name for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module == "time"
             for a in n.names if a.name in _CLOCKS}
    found = []
    for n in ast.walk(tree):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and ((f.value.id == "time" and f.attr in _CLOCKS)
                     or (f.value.id == "datetime"
                         and f.attr in ("now", "utcnow")))):
            found.append((n.lineno, f"{f.value.id}.{f.attr}"))
        elif isinstance(f, ast.Name) and f.id in named:
            found.append((n.lineno, f.id))
    return found


def _is_shed_call(name: str) -> bool:
    n = name.lower().lstrip("_")
    return any(n == v or n.startswith(v + "_at_")
               or (n.startswith(v + "_") and "request" in n)
               for v in ("shed", "drop"))


def _trivial(e) -> bool:
    return isinstance(e, ast.Constant) and e.value in (None, "")


def _names_reason(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "reason":
            return not _trivial(kw.value)
    for a in call.args:
        if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                and a.value:
            return True
        if isinstance(a, ast.Name) and "reason" in a.id.lower():
            return True
        if isinstance(a, ast.Attribute) and "reason" in a.attr.lower():
            return True
    return False


def bare_sheds(source: str) -> list:
    """(line, what) of every shed without a reason, function by
    function: an ``x.outcome = "shed"`` with no non-empty
    ``x.shed_reason`` assignment beside it, a shed/drop call
    (``shed``, ``drop``, ``shed_at_*``, ``drop_*request*``) without a
    ``reason=``, a non-empty string or a ``*reason*`` name, and a
    ``shed_reason`` set to None or "" in a function that sheds."""
    found = []
    for fn in ast.walk(ast.parse(source)):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        outcomes, reasons, calls = [], [], []
        stack = list(fn.body)
        while stack:
            cur = stack.pop()
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(cur, ast.Assign):
                for t in cur.targets:
                    if isinstance(t, ast.Attribute) and t.attr == "outcome" \
                            and isinstance(cur.value, ast.Constant) \
                            and cur.value.value == "shed":
                        outcomes.append(cur)
                    elif isinstance(t, ast.Attribute) \
                            and t.attr == "shed_reason":
                        reasons.append(cur)
            elif isinstance(cur, ast.Call):
                f = cur.func
                name = (f.attr if isinstance(f, ast.Attribute)
                        else f.id if isinstance(f, ast.Name) else None)
                if name is not None and _is_shed_call(name):
                    calls.append(cur)
            stack.extend(ast.iter_child_nodes(cur))
        good = [r for r in reasons if not _trivial(r.value)]
        for o in outcomes:
            if not good:
                found.append((o.lineno, "outcome 'shed' without a reason"))
        for c in calls:
            if not _names_reason(c):
                found.append((c.lineno, "shed call without a reason"))
        if outcomes or calls:
            found += [(r.lineno, "empty shed_reason") for r in reasons
                      if _trivial(r.value)]
    return found


@pytest.mark.parametrize("d", ["sim", "fleet", "chaos"])
def test_host_planes_read_no_os_clock(d):
    for path in _sources(d):
        with open(path) as f:
            assert clock_calls(f.read()) == [], path


@pytest.mark.parametrize("path", ["models/router.py", "sim/workload.py",
                                  "sim/fastpath.py", "chaos"])
def test_every_shed_names_its_reason(path):
    sheds = 0
    for src in _sources(path):
        with open(src) as f:
            text = f.read()
        assert bare_sheds(text) == [], src
        sheds += text.count('"shed"')
    assert sheds > 0  # the rule had shed paths to check


@pytest.mark.parametrize("bad,want", [
    ("import time\ndef f():\n    return time.perf_counter()\n",
     [(3, "time.perf_counter")]),
    ("from time import monotonic as m\ndef f():\n    return m()\n",
     [(3, "m")]),
    ("import datetime\ndef f():\n    return datetime.now()\n",
     [(3, "datetime.now")]),
    ("def f(clock):\n    return clock.now()\n", []),
])
def test_clock_rule_catches_a_clock_read(bad, want):
    assert clock_calls(bad) == want


@pytest.mark.parametrize("bad,n", [
    ("def f(rr):\n    rr.outcome = 'shed'\n", 1),
    ("def f(rr):\n    rr.outcome = 'shed'\n    rr.shed_reason = None\n", 2),
    ("def f(self, rr):\n    self._shed_at_door(rr, 4)\n", 1),
    ("def f(q, rr):\n    q.drop(rr, reason='')\n", 1),
    ("def f(rr, why):\n    rr.outcome = 'shed'\n    rr.shed_reason = why\n",
     0),
    ("def f(o, rr, reason):\n    o.shed(rr, reason, 0.0)\n", 0),
    ("def f(self):\n    self._drop_cache()\n", 0),
])
def test_shed_rule_catches_a_bare_shed(bad, n):
    assert len(bare_sheds(bad)) == n
