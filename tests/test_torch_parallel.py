"""The port's mesh plane on eight CPU ranks: ``make_mesh``, the masked
combine, the distributed decode with stragglers and its refusal, the
ring all-gather, ``MeshCodedGemm`` and ``MeshMatDotGemm``: the JAX
package's ``tests/test_parallel.py`` contract, plus the same inputs
through both packages' mesh programs (JAX on its 8 host devices) with
the outputs within 1e-9 relative in f64.
"""

import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu_torch.ops import MDSCode
from mpistragglers_jl_tpu_torch.parallel import (
    MeshCodedGemm,
    MeshMatDotGemm,
    PartitionSpec as P,
    distributed_mds_decode,
    make_mesh,
    masked_psum_scatter_combine,
    ring_allgather,
    shard,
)


def _mesh(n, names="w"):
    return make_mesh(n, names, devices=["cpu"] * n)


def _rel(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - want))
                 / np.max(np.abs(want)))


def test_make_mesh():
    mesh = _mesh(8)
    assert mesh.shape == {"w": 8}
    assert mesh.shape["w"] == 8 and list(mesh.shape) == ["w"]
    mesh2 = make_mesh((2, 4), ("dp", "tp"), devices=["cpu"] * 8)
    assert mesh2.shape == {"dp": 2, "tp": 4}
    assert mesh2.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in mesh2.devices.flat)
    with pytest.raises(ValueError):
        make_mesh(16, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        make_mesh((2, 4), ("dp",), devices=["cpu"] * 8)


def test_make_mesh_refusal_message_names_the_need():
    with pytest.raises(ValueError, match=r"mesh \{'w': 9\} needs 9 "
                                         r"devices, have 8"):
        make_mesh(9, devices=["cpu"] * 8)


def test_ranks_that_share_a_device_hold_separate_tensors():
    mesh = _mesh(4)
    x = torch.arange(24.0).reshape(4, 3, 2)
    sh = shard(x, mesh, P("w"))
    ptrs = {sh.local(i).data_ptr() for i in range(4)} | {x.data_ptr()}
    assert len(ptrs) == 5
    sh.local(0).zero_()
    assert torch.equal(sh.local(1), x[1:2]) and x[0].abs().sum() > 0
    rep = shard(x, mesh, P())
    assert len({rep.local(i).data_ptr() for i in range(4)}) == 4
    assert torch.equal(rep.gather(), x)


def test_masked_combine_weighted_sum():
    mesh = _mesh(4)
    combine = masked_psum_scatter_combine(mesh)
    rng = np.random.default_rng(0)
    shards = rng.standard_normal((4, 3, 2)).astype(np.float32)
    weights = rng.standard_normal((4, 4)).astype(np.float32)
    out = combine(shard(shards, mesh, P("w")), torch.from_numpy(weights))
    ref = np.einsum("jw,wrc->jrc", weights, shards)
    assert out.shape == (4, 3, 2)
    assert out.spec == P("w")
    assert np.allclose(np.asarray(out), ref, atol=1e-5)


@pytest.mark.parametrize("fold", [2, 4])
def test_masked_combine_folded(fold):
    """``fold`` worker blocks per rank (the folded pool's combine): the
    same weighted sum, output groups placed on their ranks."""
    d = 8 // fold
    mesh = _mesh(d)
    combine = masked_psum_scatter_combine(mesh, fold=fold)
    rng = np.random.default_rng(1)
    shards = rng.standard_normal((8, 3, 2))
    weights = rng.standard_normal((8, 8))
    out = combine(shard(shards, mesh, P("w")), torch.from_numpy(weights))
    for r in range(d):
        assert out.local(r).shape == (fold, 3, 2)
    ref = np.einsum("jw,wrc->jrc", weights, shards)
    assert _rel(out, ref) < 1e-12


def test_distributed_mds_decode_with_stragglers():
    mesh = _mesh(8)
    n, k = 8, 6
    code = MDSCode(n, k, dtype=np.float32)
    rng = np.random.default_rng(1)
    blocks = rng.standard_normal((k, 4, 3)).astype(np.float32)
    coded = np.asarray(code.encode(blocks))
    decode = distributed_mds_decode(mesh, code)
    repochs = np.full(n, 7)
    repochs[[2, 5]] = 3
    dirty = coded.copy()
    dirty[[2, 5]] = 999.0  # decode must not look at stale data
    out = np.asarray(decode(shard(dirty, mesh, P("w")), repochs, epoch=7))
    assert np.allclose(out[:k], blocks, atol=1e-3)
    assert np.allclose(out[k:], 0.0, atol=1e-6)


def test_distributed_decode_insufficient_fresh():
    mesh = _mesh(8)
    code = MDSCode(8, 6, dtype=np.float32)
    decode = distributed_mds_decode(mesh, code)
    sh = shard(torch.zeros(8, 2, 2), mesh, P("w"))
    with pytest.raises(ValueError, match="need k=6"):
        decode(sh, np.zeros(8), epoch=1)


def test_ring_allgather():
    mesh = _mesh(8)
    gather = ring_allgather(mesh)
    rng = np.random.default_rng(2)
    blocks = rng.standard_normal((8, 2, 3)).astype(np.float32)
    out = np.asarray(gather(shard(blocks, mesh, P("w"))))  # (8, 16, 3)
    full = blocks.reshape(16, 3)
    for dev in range(8):
        assert np.array_equal(out[dev], full), f"rank {dev}"


class TestMeshCodedGemm:
    def test_full_epoch_exact(self):
        rng = np.random.default_rng(3)
        mesh = _mesh(8)
        A = rng.standard_normal((96, 32)).astype(np.float32)
        B = rng.standard_normal((32, 16)).astype(np.float32)
        mg = MeshCodedGemm(A, mesh, 6)
        C = mg.full(mg.epoch(B, epoch=1))
        assert np.allclose(C, A @ B, atol=1e-3)

    def test_epoch_with_stale_mask(self):
        rng = np.random.default_rng(4)
        mesh = _mesh(8)
        A = rng.standard_normal((48, 16)).astype(np.float32)
        B = rng.standard_normal((16, 8)).astype(np.float32)
        mg = MeshCodedGemm(A, mesh, 6)
        repochs = np.full(8, 5)
        repochs[[0, 7]] = 1  # two stragglers stale
        decoded = mg.epoch(B, repochs=repochs, epoch=5)
        assert np.allclose(mg.full(decoded), A @ B, atol=1e-3)

    def test_output_stays_sharded(self):
        rng = np.random.default_rng(5)
        mesh = _mesh(4)
        A = rng.standard_normal((24, 8)).astype(np.float32)
        B = rng.standard_normal((8, 4)).astype(np.float32)
        mg = MeshCodedGemm(A, mesh, 3)
        decoded = mg.epoch(B, epoch=1)
        # one block per rank, not gathered
        assert decoded.spec == P("w")
        assert [decoded.local(i).shape[0] for i in range(4)] == [1] * 4
        assert len({decoded.local(i).data_ptr() for i in range(4)}) == 4


class TestMeshMatDotGemm:
    def _setup(self, p=2, n=8):
        rng = np.random.default_rng(0)
        m, kd, cols = 16, 8 * p, 12
        A = rng.standard_normal((m, kd)).astype(np.float32)
        B = rng.standard_normal((kd, cols)).astype(np.float32)
        return MeshMatDotGemm(A, _mesh(n), p=p), A, B

    def test_full_arrival_exact(self):
        mg, A, B = self._setup()
        C = np.asarray(mg.epoch(B, epoch=1))
        assert _rel(C, A @ B) < 1e-4

    def test_straggler_masked_weighted_psum(self):
        mg, A, B = self._setup()
        repochs = np.full(8, 5)
        repochs[[2, 6]] = 4
        out = mg.epoch(B, repochs, epoch=5)
        assert _rel(np.asarray(out), A @ B) < 1e-4
        # replicated: every rank holds the same bits
        for i in range(1, 8):
            assert torch.equal(out.local(i), out.local(0))
        w = mg.decode_weights(repochs, 5)
        assert w[2] == 0 and w[6] == 0
        assert np.count_nonzero(w) == mg.k

    def test_below_threshold_refuses(self):
        mg, A, B = self._setup(p=4, n=8)  # k = 7
        repochs = np.full(8, 1)
        repochs[:2] = 0  # only 6 fresh < 7
        with pytest.raises(ValueError, match="need 2p-1=7"):
            mg.epoch(B, repochs, epoch=1)


# -- cross-package: the JAX mesh programs on the same inputs -----------------


def _jax_sharded(x, mesh, spec):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def test_collectives_equal_the_jax_package():
    """The masked combine (folded too), the distributed decode past two
    stragglers and the ring all-gather, f64, against the JAX package's
    ``shard_map`` programs on its 8 host devices."""
    from jax.sharding import PartitionSpec as JP

    from mpistragglers_jl_tpu.ops import MDSCode as JMDS
    from mpistragglers_jl_tpu.parallel import collectives as jc
    from mpistragglers_jl_tpu.parallel import make_mesh as jmesh

    rng = np.random.default_rng(11)
    shards = rng.standard_normal((8, 5, 3))
    weights = rng.standard_normal((8, 8))
    for d in (8, 4):
        fold = 8 // d
        want = np.asarray(jc.masked_psum_scatter_combine(
            jmesh(d), fold=fold)(_jax_sharded(shards, jmesh(d), JP("w")),
                                 weights))
        got = masked_psum_scatter_combine(_mesh(d), fold=fold)(
            shard(shards, _mesh(d), P("w")), torch.from_numpy(weights))
        assert _rel(got, want) < 1e-9
    code_j, code_t = JMDS(8, 6, dtype=np.float64), MDSCode(8, 6,
                                                           dtype=np.float64)
    assert np.array_equal(code_j.G, code_t.G)
    coded = rng.standard_normal((8, 4, 3))
    repochs = np.full(8, 3)
    repochs[[1, 4]] = 2
    want = np.asarray(jc.distributed_mds_decode(jmesh(8), code_j)(
        _jax_sharded(coded, jmesh(8), JP("w")), repochs, 3))
    got = distributed_mds_decode(_mesh(8), code_t)(
        shard(coded, _mesh(8), P("w")), repochs, 3)
    assert _rel(got, want) < 1e-9
    want = np.asarray(jc.ring_allgather(jmesh(8))(
        _jax_sharded(coded, jmesh(8), JP("w"))))
    got = ring_allgather(_mesh(8))(shard(coded, _mesh(8), P("w")))
    assert np.array_equal(np.asarray(got), want)


def test_mesh_gemms_equal_the_jax_package():
    """``MeshCodedGemm`` with a stale mask and ``MeshMatDotGemm`` past
    two stragglers, f64, against the JAX package's."""
    from mpistragglers_jl_tpu.parallel import MeshCodedGemm as JMCG
    from mpistragglers_jl_tpu.parallel import MeshMatDotGemm as JMMD
    from mpistragglers_jl_tpu.parallel import make_mesh as jmesh

    rng = np.random.default_rng(12)
    A = rng.standard_normal((48, 16))
    B = rng.standard_normal((16, 8))
    repochs = np.full(8, 5)
    repochs[[0, 7]] = 1
    jm = JMCG(A, jmesh(8), 6)
    tm = MeshCodedGemm(A, _mesh(8), 6)
    want = jm.full(jm.epoch(B, repochs, 5))
    got = tm.full(tm.epoch(B, repochs, 5))
    assert _rel(got, want) < 1e-9 and _rel(got, A @ B) < 1e-9
    A2 = rng.standard_normal((16, 16))
    B2 = rng.standard_normal((16, 12))
    repochs[[2, 6]] = 1
    jd = JMMD(A2, jmesh(8), p=2)
    td = MeshMatDotGemm(A2, _mesh(8), p=2)
    assert np.array_equal(jd.decode_weights(repochs, 5),
                          td.decode_weights(repochs, 5))
    want = np.asarray(jd.epoch(B2, repochs, 5))
    got = np.asarray(td.epoch(B2, repochs, 5))
    assert _rel(got, want) < 1e-9
