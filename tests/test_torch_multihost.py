"""The port's multi-process runtime (``parallel/multihost.py``).

* the JAX package's ``tests/test_multihost.py`` in one process: the
  single-process degradation path (the same code a cluster runs, with
  one process), the layout and validation logic, and a helper-built
  mesh driving the collectives;
* ``tests/test_hierarchical.py``'s host groups, read off a mesh too;
* two ``gloo`` ranks on the CPU, spawned once for the module with a
  timeout of their own: ``initialize_multihost``,
  ``make_multihost_mesh``, ``local_worker_indices`` and ``host_groups``
  agree across the ranks;
* ``tests/test_multihost_e2e.py``'s TCP flow: a coordinator over
  ``NativeProcessBackend(spawn=False, address="tcp://...")`` and worker
  processes joined through ``python -m mpistragglers_jl_tpu_torch.worker``
  computing with torch, one killed mid-run and re-adopted (``slow``, as
  the reference marks it).

``work`` and ``reference_grad`` below are the CLI workers' work function
and its numpy oracle: the workers import this module, which imports no
JAX at module level.
"""

import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu_torch.parallel import (
    PartitionSpec as P,
    initialize_multihost,
    local_worker_indices,
    make_multihost_mesh,
    shard,
)
from mpistragglers_jl_tpu_torch.parallel import multihost
from mpistragglers_jl_tpu_torch.parallel.collectives import all_reduce

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8


def test_initialize_single_process_noop():
    # callable (and idempotent) in single-process runs, so the same
    # program text runs everywhere
    initialize_multihost()
    initialize_multihost()
    assert multihost.process_count() == 1
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_cluster_env_detection(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert not multihost._in_cluster_env()
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not multihost._in_cluster_env()  # a one-process job
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert multihost._in_cluster_env()
    monkeypatch.setenv("WORLD_SIZE", "four")
    assert not multihost._in_cluster_env()


def test_mesh_over_all_local_devices():
    mesh = make_multihost_mesh(8, devices=CPU8)
    assert mesh.axis_names == ("w",)
    assert mesh.devices.shape == (8,)
    assert (mesh.process_index == 0).all()


def test_mesh_2d_with_dcn_axis_single_process():
    # dcn_axis is legal with one process; layout equals the local path
    mesh = make_multihost_mesh((2, 4), ("dp", "tp"), dcn_axis="dp",
                               devices=CPU8)
    assert mesh.axis_names == ("dp", "tp")
    assert mesh.devices.shape == (2, 4)


def test_mesh_validation():
    with pytest.raises(ValueError, match="equal length"):
        make_multihost_mesh((2, 4), ("dp",), devices=CPU8)
    with pytest.raises(ValueError, match="not in"):
        make_multihost_mesh((2, 4), ("dp", "tp"), dcn_axis="pp",
                            devices=CPU8)
    with pytest.raises(ValueError, match="needs"):
        make_multihost_mesh(1024, devices=CPU8)


def test_local_worker_indices_single_process_owns_all():
    mesh = make_multihost_mesh(8, devices=CPU8)
    assert local_worker_indices(mesh) == list(range(8))
    mesh2 = make_multihost_mesh((2, 4), ("dp", "w"), devices=CPU8)
    assert local_worker_indices(mesh2, axis="w") == list(range(4))
    with pytest.raises(ValueError, match="not in mesh"):
        local_worker_indices(mesh, axis="tp")


def test_multihost_mesh_drives_collectives():
    # a helper-built mesh slots straight into the sharded compute path:
    # row sums of a (dp, tp)-split matrix, each rank's partial rows
    # summed over its tp ranks by the all-reduce
    mesh = make_multihost_mesh((2, 4), ("dp", "tp"), dcn_axis="dp",
                               devices=CPU8)
    x = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    sx = shard(x, mesh, P("dp", "tp"))
    assert torch.equal(sx.gather(), x)
    rows = []
    for dp in range(2):
        parts = [sx.shards[dp, tp].sum(dim=1) for tp in range(4)]
        rows.append(all_reduce(parts, list(mesh.devices[dp]))[0])
    np.testing.assert_allclose(torch.cat(rows).numpy(),
                               x.sum(dim=1).numpy(), rtol=1e-6)


@pytest.mark.parametrize("entry", [
    "shard", "from_local", "combine", "mds_decode", "ring_allgather",
    "MeshCodedGemm", "MeshMatDotGemm", "PoolMeshCodedGemm",
    "DeviceCoordinator",
])
def test_mesh_plane_refuses_positions_of_another_process(entry):
    # a mesh whose positions 4..7 another process drives serves the
    # ownership reads only: sharding and every collective over it raise,
    # naming the item that brings collectives across processes
    from mpistragglers_jl_tpu_torch.ops.coding import MDSCode
    from mpistragglers_jl_tpu_torch.parallel import (
        DeviceCoordinator, Mesh, MeshCodedGemm, MeshMatDotGemm,
        PoolMeshCodedGemm, distributed_mds_decode,
        masked_psum_scatter_combine, ring_allgather)
    from mpistragglers_jl_tpu_torch.parallel.mesh import from_local

    devs = np.array([torch.device("cpu")] * 8, dtype=object)
    mixed = Mesh(devs, ("w",), process_index=np.repeat([0, 1], 4))
    mine = Mesh(devs, ("w",))
    x = torch.zeros(8, 2, 3, dtype=torch.float64)
    A = np.ones((12, 4))
    calls = {
        "shard": lambda m: shard(x, m, P("w")),
        "from_local": lambda m: from_local(m, P("w"), list(x[:, None]),
                                           x.shape),
        "combine": lambda m: masked_psum_scatter_combine(m),
        "mds_decode": lambda m: distributed_mds_decode(
            m, MDSCode(8, 6, dtype=np.float64)),
        "ring_allgather": lambda m: ring_allgather(m),
        "MeshCodedGemm": lambda m: MeshCodedGemm(A, m, 6),
        "MeshMatDotGemm": lambda m: MeshMatDotGemm(A, m, 2),
        "PoolMeshCodedGemm": lambda m: PoolMeshCodedGemm(
            A, m, 6, dtype=np.float64),
        "DeviceCoordinator": lambda m: DeviceCoordinator(
            np.ones((8, 2, 4)), decode="mds",
            G=MDSCode(8, 6, dtype=np.float64).G, k=6, mesh=m),
    }
    with pytest.raises(ValueError, match=r"process\(es\) \[1\].*item 18d-18f"):
        calls[entry](mixed)
    obj = calls[entry](mine)  # the same call on this process's mesh runs
    if hasattr(obj, "shutdown"):
        obj.shutdown()


class TestHostGroups:
    def test_even_split_without_a_mesh(self):
        from mpistragglers_jl_tpu_torch.parallel import host_groups

        assert host_groups(8, n_hosts=2) == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert host_groups(6, n_hosts=3) == [[0, 1], [2, 3], [4, 5]]
        with pytest.raises(ValueError, match="evenly"):
            host_groups(8, n_hosts=3)
        with pytest.raises(ValueError, match="needs n_workers"):
            host_groups(8)

    def test_single_process_mesh_groups_by_process(self):
        from mpistragglers_jl_tpu_torch.parallel import host_groups

        mesh = make_multihost_mesh((8,), ("w",), devices=CPU8)
        groups = host_groups(mesh=mesh)
        assert sorted(sum(groups, [])) == list(range(8))
        assert len(groups) == 1

    def test_mesh_groups_refuse_split_and_unequal_owners(self):
        from mpistragglers_jl_tpu_torch.parallel import Mesh, host_groups

        devs = np.array([torch.device("cpu")] * 8, dtype=object)
        two = Mesh(devs.reshape(4, 2), ("w", "x"),
                   process_index=np.array([[0, 0], [0, 0], [1, 1], [1, 1]]))
        assert host_groups(mesh=two) == [[0, 1], [2, 3]]
        split = Mesh(devs.reshape(4, 2), ("w", "x"),
                     process_index=np.array([[0, 1], [0, 0], [1, 1],
                                             [1, 1]]))
        with pytest.raises(ValueError, match="spans processes"):
            host_groups(mesh=split)
        uneven = Mesh(devs, ("w",),
                      process_index=np.array([0, 0, 0, 1, 1, 1, 1, 1]))
        with pytest.raises(ValueError, match="unequal"):
            host_groups(mesh=uneven)

    def test_partition_feeds_hierarchical_gemm(self):
        from mpistragglers_jl_tpu_torch import AsyncPool, SimBackend, asyncmap
        from mpistragglers_jl_tpu_torch.ops.hierarchical import (
            HierarchicalCodedGemm,
        )
        from mpistragglers_jl_tpu_torch.parallel import Mesh, host_groups

        rng = np.random.default_rng(0)
        A = rng.standard_normal((24, 16)).astype(np.float32)
        B = rng.standard_normal((16, 8)).astype(np.float32)
        ref = A @ B
        devs = np.array([torch.device("cpu")] * 8, dtype=object)
        mesh = Mesh(devs, ("w",), process_index=np.repeat([0, 1], 4))
        for groups in (host_groups(8, n_hosts=2), host_groups(mesh=mesh)):
            hg = HierarchicalCodedGemm(A, groups=groups, k_inner=3,
                                       device_backend=False,
                                       devices=["cpu"])
            assert hg.H == 2 and hg.n_inner == 4
            be = SimBackend(hg.work, 8)
            pool = AsyncPool(8)
            asyncmap(pool, B, be, nwait=hg.nwait)
            C = hg.result(pool)
            assert np.max(np.abs(C - ref)) / np.max(np.abs(ref)) < 1e-3

    def test_groups_equal_the_jax_package(self):
        """Even splits in both packages, and the JAX package's groups of
        its single-process mesh against the port's."""
        import jax

        from mpistragglers_jl_tpu.parallel import host_groups as jhg
        from mpistragglers_jl_tpu.parallel import (
            make_multihost_mesh as jmesh,
        )
        from mpistragglers_jl_tpu_torch.parallel import host_groups

        for n, h in ((8, 2), (6, 3), (12, 4)):
            assert jhg(n, n_hosts=h) == host_groups(n, n_hosts=h)
        n = len(jax.devices())
        assert jhg(mesh=jmesh((n,), ("w",))) == host_groups(
            mesh=make_multihost_mesh((n,), ("w",), devices=["cpu"] * n))


# -- two gloo ranks, spawned once for the module ---------------------------

_RANK = r"""
import json, sys
import numpy as np
from mpistragglers_jl_tpu_torch.parallel import multihost as mh
addr, rank = sys.argv[1], int(sys.argv[2])
mh.initialize_multihost(addr, num_processes=2, process_id=rank, device="cpu")
mh.initialize_multihost(addr, num_processes=2, process_id=rank, device="cpu")
import torch.distributed as dist
flat = mh.make_multihost_mesh(2)
grid = mh.make_multihost_mesh((2, 2), ("dp", "w"), dcn_axis="dp",
                              devices=["cpu", "cpu"])
mine = {
    "rank": dist.get_rank(), "world": dist.get_world_size(),
    "backend": dist.get_backend(),
    "count": mh.process_count(), "index": mh.process_index(),
    "flat_owners": flat.process_index.tolist(),
    "flat_local": mh.local_worker_indices(flat),
    "flat_groups": mh.host_groups(mesh=flat),
    "grid_owners": grid.process_index.tolist(),
    "grid_local": mh.local_worker_indices(grid, axis="dp"),
    "grid_groups": mh.host_groups(mesh=grid, axis="dp"),
}
# the mesh plane refuses the mesh that spans both processes, and runs
# on one that is this process's own
import torch
from mpistragglers_jl_tpu_torch.parallel import (
    PartitionSpec, make_mesh, masked_psum_scatter_combine, shard)
x = torch.arange(4.0).reshape(2, 2)
for name, call in (("shard", lambda: shard(x, flat, PartitionSpec("w"))),
                   ("combine", lambda: masked_psum_scatter_combine(flat))):
    try:
        call()
    except ValueError as e:
        mine["refused_" + name] = str(e)
own = make_mesh(2, devices=["cpu", "cpu"])
mine["own_owners"] = own.process_index.tolist()
mine["own_gather"] = shard(x, own, PartitionSpec("w")).gather().tolist()
try:
    mh.make_multihost_mesh(3, devices=["cpu"])
except ValueError as e:
    mine["need"] = str(e)
try:
    mh.make_multihost_mesh((2, 1), ("dp", "w"), dcn_axis="dp",
                           devices=["cpu", "cpu"])
except ValueError as e:
    mine["partial"] = str(e)
every = [None, None]
dist.all_gather_object(every, mine)
dist.destroy_process_group()
print("RESULT " + json.dumps(every))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks():
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = ROOT
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, addr, str(r)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(json.loads(out.split("RESULT ", 1)[1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def test_two_gloo_ranks_agree(two_ranks):
    a, b = two_ranks
    assert a == b  # every rank gathered the same two views
    r0, r1 = a
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["world"] == r1["world"] == 2
    assert r0["backend"] == "gloo"
    assert (r0["count"], r0["index"], r1["index"]) == (2, 0, 1)
    for r in a:
        assert r["flat_owners"] == [0, 1]
        assert r["flat_groups"] == [[0], [1]]
        # the cross-process axis is outermost: dp row p on process p
        assert r["grid_owners"] == [[0, 0], [1, 1]]
        assert r["grid_groups"] == [[0], [1]]
        assert "needs 3 devices, have 2 across 2 process(es)" in r["need"]
        assert "must span all 4 global devices" in r["partial"]
    assert (r0["flat_local"], r1["flat_local"]) == ([0], [1])
    assert (r0["grid_local"], r1["grid_local"]) == ([0], [1])


def test_two_gloo_ranks_refuse_a_mesh_across_them(two_ranks):
    # each rank's shard and collective over the mesh that spans both
    # processes raise, naming the other process; a mesh of the rank's
    # own devices shards and gathers back
    for r in two_ranks[0]:
        other = 1 - r["rank"]
        for name in ("shard", "combine"):
            msg = r["refused_" + name]
            assert f"process(es) [{other}], not by this one ({r['rank']})" \
                in msg
            assert "ROADMAP item 18d-18f" in msg
        assert r["own_owners"] == [r["rank"]] * 2
        assert r["own_gather"] == [[0.0, 1.0], [2.0, 3.0]]


# -- the multi-host pool, end to end over TCP (slow) ----------------------

DIM = 16
SHARD = 64  # samples per worker
SECRET = "e2e-test-secret"


def _shard(rank: int):
    """Deterministic per-rank data shard (same on any host)."""
    rng = np.random.default_rng(1000 + rank)
    X = rng.standard_normal((SHARD, DIM))
    w_true = rng.standard_normal(DIM)
    y = (X @ w_true + 0.1 * rng.standard_normal(SHARD) > 0).astype(
        np.float64)
    return X, y


def work(rank: int, payload, epoch: int):
    """CLI worker entry: the torch autograd gradient of this rank's
    shard's logistic loss at the broadcast weights (f64)."""
    X, y = (torch.from_numpy(a) for a in _shard(rank))
    w = torch.tensor(np.asarray(payload), dtype=torch.float64,
                     requires_grad=True)
    logits = X @ w
    loss = (logits.clamp(min=0) - logits * y
            + torch.log1p(torch.exp(-logits.abs()))).mean()
    loss.backward()
    return w.grad.numpy()


def reference_grad(w: np.ndarray, ranks) -> np.ndarray:
    """Host-side oracle: mean of the per-shard gradients."""
    gs = []
    for r in ranks:
        X, y = _shard(r)
        p = 1.0 / (1.0 + np.exp(-(X @ w)))
        gs.append(X.T @ (p - y) / len(y))
    return np.mean(gs, axis=0)


def _start_cli_worker(rank: int, address: str) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests"), env.get("PYTHONPATH", "")])
    env["MSGT_AUTH"] = SECRET
    return subprocess.Popen(
        [sys.executable, "-m", "mpistragglers_jl_tpu_torch.worker",
         "--address", address, "--ranks", str(rank),
         "--work", "test_torch_multihost:work"],
        env=env,
    )


@pytest.mark.slow
def test_tcp_cli_workers_torch_sgd_with_kill_and_reaccept():
    from mpistragglers_jl_tpu_torch import AsyncPool, asyncmap, waitall
    from mpistragglers_jl_tpu_torch.backends.native import (
        NativeProcessBackend,
    )

    n = 3
    backend = NativeProcessBackend(
        None, n, spawn=False, address="tcp://127.0.0.1:0",
        auth=SECRET, accept=False, connect_timeout=120.0,
        on_dead="straggle",
    )
    procs: dict[int, subprocess.Popen] = {}
    try:
        for r in range(n):
            procs[r] = _start_cli_worker(r, backend.address)
        backend.accept(timeout=120.0)
        pool = AsyncPool(n)
        w0 = np.random.default_rng(7).standard_normal(DIM) * 0.1
        w = w0.copy()
        lr = 0.5

        def epoch(ep, nwait):
            nonlocal w
            asyncmap(pool, w, backend, nwait=nwait, epoch=ep)
            fresh = pool.fresh_indices(ep)
            g = np.mean([np.asarray(pool.results[i]) for i in fresh],
                        axis=0)
            w = w - lr * g
            return fresh

        # all ranks healthy: torch's gradients equal the numpy oracle
        epoch(1, nwait=n)
        got = np.mean([np.asarray(pool.results[i]) for i in range(n)],
                      axis=0)
        np.testing.assert_allclose(got, reference_grad(w0, range(n)),
                                   rtol=1e-9, atol=1e-12)
        for ep in range(2, 6):
            epoch(ep, nwait=n)
        # SIGKILL rank 1 mid-run: it becomes an infinite straggler
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait(timeout=30)
        ep = 6
        for _ in range(4):
            assert sorted(int(i) for i in epoch(ep, nwait=2)) == [0, 2]
            ep += 1
        assert backend._coord.is_dead(1)
        assert pool.active[1]
        # restart the CLI process; reaccept re-adopts it
        procs[1] = _start_cli_worker(1, backend.address)
        backend.reaccept(1, timeout=120.0)
        pool.reset_worker(1)
        assert sorted(int(i) for i in epoch(ep, nwait=n)) == [0, 1, 2]
        assert np.linalg.norm(reference_grad(w, range(n))) < 0.5 * \
            np.linalg.norm(reference_grad(w0, range(n)))
        waitall(pool, backend, timeout=30.0)
        assert not pool.active.any()
    finally:
        backend.shutdown()
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
