"""The port's fused pool and mesh decode on CPU ranks: ``asyncmap`` map
step over ``CUDADeviceBackend(devices=<the mesh's>)`` plus the in-place
masked reduce-scatter, held to the JAX package's ``tests/test_fused.py``
contract: real stragglers (``repochs`` from real arrivals), the folded
pool, batch mode, ``select_coded_gemm`` and its non-default ``axis``;
and to the JAX package's ``PoolMeshCodedGemm`` on the same inputs.

Tolerances as the reference's: f32 products and decodes within 1e-3
absolute (2e-4 relative-and-absolute on the folded layouts); f64 within
1e-9 relative of the JAX package's decode.
"""

import threading

import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu_torch.backends.cuda import StackedSlice
from mpistragglers_jl_tpu_torch.parallel import (
    PartitionSpec as P,
    PoolMeshCodedGemm,
    PoolMeshMatDotGemm,
    make_mesh,
    select_coded_gemm,
)
from mpistragglers_jl_tpu_torch.pool import AsyncPool, asyncmap, waitall

N = 8
K = 6
STRAGGLERS = (0, 7)


def _delay(i, epoch):
    # two permanent stragglers, deterministic
    return 0.25 if i in STRAGGLERS else 0.0


def _mesh(n, names="w"):
    return make_mesh(n, names, devices=["cpu"] * n)


@pytest.fixture
def mesh():
    return _mesh(N)


def test_fused_epoch_decodes_with_real_stragglers(mesh):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((K * 16, 24)).astype(np.float32)
    B = rng.standard_normal((24, 12)).astype(np.float32)
    fg = PoolMeshCodedGemm(A, mesh, K, delay_fn=_delay, dtype=np.float32)
    pool = AsyncPool(N)
    try:
        decoded = fg.epoch(pool, B)
        assert len(pool.fresh_indices()) >= K
        for s in STRAGGLERS:
            assert pool.repochs[s] != pool.epoch
            assert pool.active[s]
        np.testing.assert_allclose(fg.full(decoded), A @ B, atol=1e-3)
    finally:
        waitall(pool, fg.backend, timeout=5.0)
        fg.shutdown()


def test_decode_output_stays_sharded_no_rank0_gather(mesh):
    """The decoded value is split across the mesh, one block per rank,
    and the pool's results sit on their workers' ranks: the assembly
    adopts them (no copy)."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((K * 8, 16)).astype(np.float32)
    B = rng.standard_normal((16, 8)).astype(np.float32)
    fg = PoolMeshCodedGemm(A, mesh, K, dtype=np.float32)
    pool = AsyncPool(N)
    try:
        decoded = fg.epoch(pool, B, nwait=N)
        assert decoded.spec == P("w")
        assert [decoded.local(i).shape[0] for i in range(N)] == [1] * N
        for i in range(N):
            assert pool.results[i].device == fg.devices[i]
        shards = fg._adopter.assemble(pool, (8, 8), torch.float32)
        for i in range(N):
            assert shards.local(i).data_ptr() == pool.results[i].data_ptr()
        np.testing.assert_allclose(fg.full(decoded), A @ B, atol=1e-3)
    finally:
        fg.shutdown()


def test_fused_multi_epoch_stale_harvest(mesh):
    """Straggler results from epoch e arrive during epoch e+1: the pool
    harvests them as stale, re-tasks, and the decode still only uses
    fresh shards."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((K * 8, 16)).astype(np.float32)
    fg = PoolMeshCodedGemm(A, mesh, K, delay_fn=_delay, dtype=np.float32)
    pool = AsyncPool(N)
    try:
        for _ in range(3):
            B = rng.standard_normal((16, 8)).astype(np.float32)
            decoded = fg.epoch(pool, B)
            np.testing.assert_allclose(fg.full(decoded), A @ B, atol=1e-3)
    finally:
        waitall(pool, fg.backend, timeout=5.0)
        fg.shutdown()


def test_decode_from_pool_requires_k_fresh(mesh):
    """K-1 fresh shards cannot decode: the refusal names freshness.
    Workers 5..7 are held by a gate until after the check, so the test
    sees exactly 5 fresh (the reference's version is racy)."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((K * 4, 8)).astype(np.float32)
    B = rng.standard_normal((8, 4)).astype(np.float32)
    gate = threading.Event()

    def held(i, epoch):
        if i >= K - 1:
            gate.wait(10.0)
        return 0.0

    fg = PoolMeshCodedGemm(A, mesh, K, delay_fn=held, dtype=np.float32)
    pool = AsyncPool(N)
    try:
        asyncmap(pool, B, fg.backend, nwait=K - 1)
        assert len(pool.fresh_indices()) == K - 1
        with pytest.raises(ValueError, match="fresh"):
            fg.decode_from_pool(pool)
    finally:
        gate.set()
        waitall(pool, fg.backend, timeout=5.0)
        fg.shutdown()


def test_fused_matdot_psum_decode(mesh):
    """MatDot fusion: decode is one weighted all-reduce over resident
    evaluations; result replicated, exact with 2 stragglers stale."""
    rng = np.random.default_rng(4)
    A = rng.standard_normal((24, 16)).astype(np.float32)
    B = rng.standard_normal((16, 8)).astype(np.float32)
    md = PoolMeshMatDotGemm(A, mesh, p=2, delay_fn=_delay, dtype=np.float32)
    pool = AsyncPool(N)
    try:
        C = md.epoch(pool, B)
        for s in STRAGGLERS:
            assert pool.repochs[s] != pool.epoch
        assert C.spec == P()
        np.testing.assert_allclose(np.asarray(C), A @ B, atol=1e-3)
        for i in range(1, N):
            assert torch.equal(C.local(i), C.local(0))
    finally:
        waitall(pool, md.backend, timeout=5.0)
        md.shutdown()


def test_fused_epoch_changed_payload_width(mesh):
    """A stale shard whose width no longer matches the current epoch's B
    enters the combine as a zero placeholder, not a shape error."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((K * 4, 8)).astype(np.float32)
    fg = PoolMeshCodedGemm(A, mesh, K, delay_fn=_delay, dtype=np.float32)
    pool = AsyncPool(N)
    try:
        fg.epoch(pool, rng.standard_normal((8, 4)).astype(np.float32))
        B2 = rng.standard_normal((8, 6)).astype(np.float32)  # new width
        decoded = fg.epoch(pool, B2)
        np.testing.assert_allclose(fg.full(decoded), A @ B2, atol=1e-3)
    finally:
        waitall(pool, fg.backend, timeout=5.0)
        fg.shutdown()


def test_pool_size_mismatch_rejected(mesh):
    rng = np.random.default_rng(6)
    A = rng.standard_normal((K * 4, 8)).astype(np.float32)
    fg = PoolMeshCodedGemm(A, mesh, K, dtype=np.float32)
    try:
        with pytest.raises(ValueError, match="one-to-one"):
            fg.epoch(AsyncPool(N + 2), np.zeros((8, 4), np.float32))
        with pytest.raises(ValueError, match="one-to-one"):
            fg.decode_from_pool(AsyncPool(N - 1))
    finally:
        fg.shutdown()


@pytest.mark.parametrize("mesh_d", [1, 2, 4])
def test_folded_pool_on_smaller_mesh(mesh_d):
    """n_workers > mesh ranks (the one-card layout): workers fold onto
    ranks in contiguous groups, the adopter stacks each group on its
    rank, and the folded combine decodes like the one-worker-per-rank
    path, stragglers included."""
    mesh = _mesh(mesh_d)
    rng = np.random.default_rng(1)
    A = rng.standard_normal((K * 16, 24)).astype(np.float32)
    B = rng.standard_normal((24, 12)).astype(np.float32)
    fg = PoolMeshCodedGemm(
        A, mesh, K, n_workers=N, delay_fn=_delay, dtype=np.float32
    )
    assert fg.fold == N // mesh_d
    pool = AsyncPool(N)
    try:
        decoded = fg.epoch(pool, B, timeout=30.0)
        assert decoded.shape[0] == N
        np.testing.assert_allclose(fg.full(decoded), A @ B,
                                   rtol=2e-4, atol=2e-4)
        assert len(pool.fresh_indices()) >= K
        waitall(pool, fg.backend, timeout=30.0)
        decoded = fg.epoch(pool, B + 1.0, timeout=30.0)
        np.testing.assert_allclose(
            fg.full(decoded), A @ (B + 1.0), rtol=2e-4, atol=2e-4
        )
        waitall(pool, fg.backend, timeout=30.0)
    finally:
        fg.shutdown()


def test_folded_pool_rejects_ragged_fold():
    A = np.zeros((K * 4, 8), np.float32)
    with pytest.raises(ValueError, match="multiple of the mesh axis"):
        PoolMeshCodedGemm(A, _mesh(3), K, n_workers=N)  # 8 over 3 ranks


@pytest.mark.parametrize("mesh_d", [1, 4])
def test_folded_pool_batch_mode(mesh_d):
    """batch=True: one stacked product per device per epoch; every
    harvested result is a lazy slice of it, and the decode equals the
    per-worker dispatch path's. On one rank the group's stack is
    adopted whole (no copy)."""
    mesh = _mesh(mesh_d)
    rng = np.random.default_rng(2)
    A = rng.standard_normal((K * 16, 24)).astype(np.float32)
    B = rng.standard_normal((24, 12)).astype(np.float32)
    fg = PoolMeshCodedGemm(A, mesh, K, n_workers=N, dtype=np.float32,
                           batch=True)
    pool = AsyncPool(N)
    try:
        decoded = fg.epoch(pool, B, timeout=30.0)
        np.testing.assert_allclose(
            fg.full(decoded), A @ B, rtol=2e-4, atol=2e-4
        )
        fresh = pool.fresh_indices()
        assert len(fresh) >= K
        assert all(
            isinstance(pool.results[int(i)], StackedSlice) for i in fresh
        )
        waitall(pool, fg.backend, timeout=30.0)
        assert all(
            isinstance(pool.results[i], StackedSlice) for i in range(N)
        )
        if mesh_d == 1:
            shards = fg._adopter.assemble(pool, (16, 12), torch.float32)
            assert shards.local(0) is pool.results[0].stacked
        decoded = fg.decode_from_pool(pool, epoch=pool.epoch)
        np.testing.assert_allclose(
            fg.full(decoded), A @ B, rtol=2e-4, atol=2e-4
        )
        decoded = fg.epoch(pool, B * 2.0, timeout=30.0)
        np.testing.assert_allclose(
            fg.full(decoded), A @ (B * 2.0), rtol=2e-4, atol=2e-4
        )
        waitall(pool, fg.backend, timeout=30.0)
    finally:
        fg.shutdown()


def test_select_coded_gemm_probes_and_picks(mesh):
    """Both candidates are probed, a winner survives with the decision
    and both measurements recorded, the loser is shut down, and the
    winner decodes exactly."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((K * 8, 16)).astype(np.float32)
    B = rng.standard_normal((16, 10)).astype(np.float32)
    g = select_coded_gemm(A, mesh, K, B, probe_epochs=2, chains=1,
                          dtype=np.float32)
    sel = g.selection
    assert sel["picked"] in ("fused", "unfused")
    assert sel["fused_ms"] > 0 and sel["unfused_ms"] > 0
    assert sel["mesh_devices"] == N
    assert sel[f"{sel['picked']}_ms"] == min(sel["fused_ms"],
                                             sel["unfused_ms"])
    pool = AsyncPool(N)
    C = g.full(g.epoch(pool, B))
    np.testing.assert_allclose(C[: A.shape[0]], A @ B, atol=1e-3)
    waitall(pool, g.backend)
    g.shutdown()


def test_select_coded_gemm_forwards_nondefault_axis():
    """``select_coded_gemm`` pops ``axis`` for its device lookup and
    must forward it to the fused candidate: a 'pool'-named axis probes,
    picks and decodes exactly like the default."""
    mesh = _mesh(N, ("pool",))
    rng = np.random.default_rng(6)
    A = rng.standard_normal((K * 8, 16)).astype(np.float32)
    B = rng.standard_normal((16, 10)).astype(np.float32)
    g = select_coded_gemm(A, mesh, K, B, probe_epochs=1, chains=1,
                          axis="pool", dtype=np.float32)
    try:
        assert g.selection["picked"] in ("fused", "unfused")
        pool = AsyncPool(N)
        np.testing.assert_allclose(
            g.full(g.epoch(pool, B))[: A.shape[0]], A @ B, atol=1e-3
        )
        waitall(pool, g.backend)
    finally:
        g.shutdown()


def test_fused_epoch_equals_the_jax_package(mesh):
    """The same f64 A, B and straggler gate through both packages'
    ``PoolMeshCodedGemm`` (one worker per rank, then folded on a
    one-rank mesh): the same fresh set and decodes within 1e-9
    relative. The stragglers are held by gates, so both pools see the
    same arrivals."""
    from mpistragglers_jl_tpu.parallel import PoolMeshCodedGemm as JPMC
    from mpistragglers_jl_tpu.parallel import make_mesh as jmesh
    from mpistragglers_jl_tpu.pool import AsyncPool as JPool
    from mpistragglers_jl_tpu.pool import waitall as jwaitall

    rng = np.random.default_rng(8)
    A = rng.standard_normal((K * 4, 12))
    B = rng.standard_normal((12, 6))
    for jm, tm, n_workers in ((jmesh(N), mesh, None),
                              (jmesh(1), _mesh(1), N)):
        gate = threading.Event()

        def held(i, epoch):
            if i in STRAGGLERS:
                gate.wait(10.0)
            return 0.0

        jg = JPMC(A, jm, K, n_workers=n_workers, delay_fn=held,
                  dtype=np.float64)
        tg = PoolMeshCodedGemm(A, tm, K, n_workers=n_workers,
                               delay_fn=held, dtype=np.float64)
        jp, tp = JPool(N), AsyncPool(N)
        try:
            want = jg.full(jg.epoch(jp, B))
            got = tg.full(tg.epoch(tp, B))
            assert np.array_equal(jp.repochs, tp.repochs)
            assert np.array_equal(jp.active, tp.active)
            err = np.max(np.abs(got - want)) / np.max(np.abs(want))
            assert err < 1e-9, err
        finally:
            gate.set()
            jwaitall(jp, jg.backend, timeout=10.0)
            waitall(tp, tg.backend, timeout=10.0)
            jg.shutdown()
            tg.shutdown()
