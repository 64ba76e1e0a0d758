"""The coded-GEMM decode from a host factor (ops/decode_solve.py) on the
CPU: the host LU, the plain version of the kernel's substitution, the
route ``CodedGemm`` and ``LTCodedGemm`` take, and the kernel wrapper's
checks that need no card (its launches are ``gpu`` tests in
tests/test_torch_gpu.py).

The sets are the benchmark's: every six-of-eight fresh set of the (8, 6)
Cauchy code (BASELINE config 3), and the 0/1 sets that
``LTCodedGemm.decode_rows`` picks for config 4's code (16 workers,
k=8, code seed 0) from fresh sets that first peel in seeded arrival
orders without its stragglers 3 and 11.

Tolerances: the host LU is float64, so ``L U`` equals ``G_S[perm]``
within 1e-14 of max|G_S| and its solve equals ``numpy.linalg.solve``
within 1e-13 x cond(G_S) (two float64 eliminations of the same
system). Against ``_lu_solve`` (LU on the device in the shards' dtype)
the plain version is within 1e-5 x cond(G_S) of max|X| at f32 and
1e-12 x cond at f64: both round the factors once to that dtype and
substitute in it, in other orders. A systematic set (``G_S`` the
identity) is copied bit for bit.
"""

import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu_torch.ops import coded_gemm as tcg
from mpistragglers_jl_tpu_torch.ops import decode_solve as ds
from mpistragglers_jl_tpu_torch.ops.coding import MDSCode, _lu_solve

CPU = torch.device("cpu")
MDS_G = MDSCode(8, 6).G  # f32, as the program holds it
MDS_SETS = list(itertools.combinations(range(8), 6))
LT_SEEDS = range(12)
LT_STRAGGLERS = (3, 11)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lt_gemm():
    """Config 4's code on the CPU (a tiny A: only its generator rows and
    ``decode_rows`` are used)."""
    g = tcg.LTCodedGemm(np.zeros((8, 2), np.float32), 16, 8, devices=[CPU],
                        seed=0)
    yield g
    g.backend.shutdown()


def _lt_rows(g, seed):
    """The workers ``decode_rows`` solves with when the fresh set is the
    first prefix of a seeded arrival order (stragglers left out) that
    peels, and their 0/1 generator rows."""
    order = [i for i in np.random.default_rng(seed).permutation(g.n)
             if i not in LT_STRAGGLERS]
    for m in range(g.k, len(order) + 1):
        fresh = np.sort(np.asarray(order[:m]))
        if g.code.peelable([g.shard_ids[i] for i in fresh]):
            break
    pool = SimpleNamespace(fresh_indices=lambda epoch=None: fresh, epoch=1)
    rows = g.decode_rows(pool)
    return rows, g.code.generator_rows([g.shard_ids[i] for i in rows])


def _cond(G_S):
    return float(np.linalg.cond(np.asarray(G_S, np.float64)))


def _check_host_lu(G_S):
    G64 = np.asarray(G_S, np.float64)
    k = G64.shape[0]
    perm, lu, dinv = ds.host_lu(G_S)
    assert sorted(perm.tolist()) == list(range(k))
    L = np.tril(lu, -1) + np.eye(k)
    U = np.triu(lu)
    assert np.all(np.abs(np.tril(lu, -1)) <= 1.0)  # partial pivoting
    assert np.max(np.abs(L @ U - G64[perm])) <= 1e-14 * np.max(np.abs(G64))
    np.testing.assert_array_equal(dinv, 1.0 / np.diag(U))
    rhs = np.random.default_rng(k).standard_normal((k, 5))
    y = np.linalg.solve(L, rhs[perm])
    x = np.linalg.solve(U, y)
    want = np.linalg.solve(G64, rhs)
    tol = 1e-13 * _cond(G64) * np.max(np.abs(want))
    assert np.max(np.abs(x - want)) <= tol


@pytest.mark.parametrize("idx", MDS_SETS)
def test_host_lu_solves_every_mds_subset(idx):
    _check_host_lu(MDS_G[list(idx)])


@pytest.mark.parametrize("seed", LT_SEEDS)
def test_host_lu_solves_the_lt_sets(lt_gemm, seed):
    rows, G_S = _lt_rows(lt_gemm, seed)
    assert len(rows) == lt_gemm.k and np.linalg.matrix_rank(G_S) == 8
    _check_host_lu(G_S)


def test_host_lu_raises_on_a_singular_or_ragged_system():
    with pytest.raises(ValueError, match="singular"):
        ds.host_lu(np.array([[1.0, 2.0], [2.0, 4.0]]))
    with pytest.raises(ValueError, match="square"):
        ds.host_lu(np.zeros((2, 3)))


def _shards(G_S, dtype, shape=(6, 10), seed=0):
    """k shards ``G_S X`` of random source blocks X, in ``dtype``."""
    k = G_S.shape[0]
    X = np.random.default_rng(seed).standard_normal((k, *shape))
    S = np.einsum("ij,j...->i...", np.asarray(G_S, np.float64), X)
    return [torch.from_numpy(s.astype(dtype)) for s in S]


def _close_to_lu_solve(G_S, dtype, tol):
    shards = _shards(G_S, dtype)
    got = ds.decode_solve(shards, G_S)
    assert got.dtype == shards[0].dtype and got.shape == (len(shards), 6, 10)
    flat = torch.stack(shards).reshape(len(shards), -1)
    want = _lu_solve(torch.from_numpy(np.asarray(G_S, dtype)),
                     flat).reshape(got.shape)
    err = (got - want).abs().max() / want.abs().max()
    assert float(err) <= tol * _cond(G_S), float(err)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-12)])
@pytest.mark.parametrize("idx", MDS_SETS[::3])
def test_plain_version_matches_lu_solve_on_mds_sets(idx, dtype, tol):
    _close_to_lu_solve(MDS_G[list(idx)], dtype, tol)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-12)])
@pytest.mark.parametrize("seed", LT_SEEDS[::3])
def test_plain_version_matches_lu_solve_on_lt_sets(lt_gemm, seed, dtype,
                                                   tol):
    _close_to_lu_solve(_lt_rows(lt_gemm, seed)[1], dtype, tol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_systematic_set_is_copied_bit_for_bit(dtype):
    shards = _shards(MDS_G[:6], dtype)
    got = ds.decode_solve(shards, MDS_G[:6])
    assert torch.equal(got, torch.stack(shards))


@pytest.mark.parametrize("device,dtype,k,want", [
    ("cpu", torch.float32, 6, True),
    ("cpu", torch.float64, 40, True),
    ("cuda", torch.float32, 6, True),
    ("cuda", torch.float32, 16, True),
    ("cuda", torch.float32, 17, False),
    ("cuda", torch.float64, 6, False),
    ("cuda", torch.bfloat16, 6, False),
    ("meta", torch.float32, 6, False),
])
def test_route_follows_device_dtype_and_k(device, dtype, k, want):
    t = SimpleNamespace(device=torch.device(device), dtype=dtype)
    assert ds.takes(t, k) is want


def _boom(*args, **kwargs):
    raise AssertionError("the CPU route must not reach _decode")


@pytest.mark.parametrize("code", ["mds", "mds_coalesced", "lt"])
def test_result_device_on_the_cpu_takes_the_host_factor(monkeypatch, code):
    """``result_device`` on CPU shards solves through the plain version,
    not ``_decode``, and launches no kernel."""
    from mpistragglers_jl_tpu_torch import AsyncPool, asyncmap, waitall

    rng = np.random.default_rng(5)
    A = rng.standard_normal((48, 16)).astype(np.float32)
    B = rng.standard_normal((16, 8)).astype(np.float32)
    monkeypatch.setattr(tcg, "_decode", _boom)
    launches = ds.LAUNCHES["decode_solve"]
    if code == "lt":
        g, n = tcg.LTCodedGemm(A, 16, 8, devices=[CPU]), 16
    else:
        g, n = tcg.CodedGemm(A, 8, 6, devices=[CPU],
                             batch=code == "mds_coalesced"), 8
    try:
        pool = AsyncPool(n)
        asyncmap(pool, B, g.backend, nwait=n)
        got = g.result_device(pool).numpy()
        waitall(pool, g.backend)
    finally:
        g.backend.shutdown()
    want = A.astype(np.float64) @ B
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))
    assert ds.LAUNCHES["decode_solve"] == launches


@pytest.mark.parametrize("batch", [True, False])
def test_result_device_on_the_cpu_decodes_3x3_shards_through_parity(batch):
    """An 18 x 5 A over (8, 6) times a 5 x 3 B: 3 x 3 shards, from one
    fused stack or from each worker, with workers 1 and 4 left out of
    the fresh set so that two parity shards enter the solve."""
    from mpistragglers_jl_tpu_torch import AsyncPool, asyncmap, waitall

    rng = np.random.default_rng(6)
    A = rng.standard_normal((18, 5)).astype(np.float32)
    B = rng.standard_normal((5, 3)).astype(np.float32)
    g = tcg.CodedGemm(A, 8, 6, devices=[CPU], batch=batch)
    try:
        pool = AsyncPool(8)
        asyncmap(pool, B, g.backend, nwait=8)
        pool.repochs[[1, 4]] = pool.epoch - 1
        assert pool.fresh_indices()[:6].tolist() == [0, 2, 3, 5, 6, 7]
        got = g.result_device(pool).numpy()
        waitall(pool, g.backend)
    finally:
        g.backend.shutdown()
    want = A.astype(np.float64) @ B
    cond = np.linalg.cond(MDS_G[[0, 2, 3, 5, 6, 7]].astype(np.float64))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-5 * cond * np.max(np.abs(want))


def _aligned(n, dtype=torch.float32, offset=0):
    buf = torch.zeros(n + 8, dtype=dtype)
    start = (-buf.data_ptr() // buf.element_size()) % (
        16 // buf.element_size()) + offset
    return buf[start:start + n]


@pytest.mark.parametrize("case,match", [
    ("k17", "k <= 16"),
    ("f64", "f32 shards"),
    ("bf16", "f32 shards"),
    ("transposed", "not contiguous"),
    ("shapes", "shard 1 is"),
])
def test_kernel_checks_raise_before_any_launch(case, match):
    """The wrapper's checks on what the kernel cannot take (they read
    only shapes, dtypes and addresses, so they run here)."""
    shards = [_aligned(24).view(4, 6) for _ in range(3)]
    if case == "k17":
        shards = [_aligned(24).view(4, 6) for _ in range(17)]
    elif case == "f64":
        shards[2] = _aligned(24, torch.float64).view(4, 6)
    elif case == "bf16":
        shards[0] = _aligned(24, torch.bfloat16).view(4, 6)
    elif case == "transposed":
        shards = [_aligned(24).view(6, 4).t() for _ in range(3)]
    else:
        shards[1] = _aligned(24).view(6, 4)
    with pytest.raises(ValueError, match=match):
        ds._check_kernel_shards(shards)


def test_aligned_shards_pass_the_kernel_checks():
    ds._check_kernel_shards([_aligned(24).view(4, 6) for _ in range(16)])


@pytest.mark.parametrize("case", ["misaligned", "ragged", "stack_of_3x3"])
def test_odd_shards_pass_the_kernel_checks(case):
    """Any shape and alignment passes: the kernel's float instance
    serves what its float4 instance cannot."""
    shards = [_aligned(24).view(4, 6) for _ in range(3)]
    if case == "misaligned":
        shards[1] = _aligned(24, offset=1).view(4, 6)
    elif case == "ragged":
        shards = [_aligned(6).view(2, 3) for _ in range(3)]
    else:
        shards = list(_aligned(6 * 9).view(6, 3, 3))
    ds._check_kernel_shards(shards)


@pytest.mark.parametrize("n,offsets,want", [
    (24, (0, 0, 0), True),
    (8192 * 1366, (0, 0, 0), True),
    (24, (0, 1, 0), False),  # one shard 4 bytes off
    (24, (0, 0, 2), False),  # the output 8 bytes off
    (9, (0, 0, 0), False),  # a 3 x 3 shard
    (6, (0, 0, 0), False),
])
def test_float4_instance_needs_whole_aligned_float4s(n, offsets, want):
    """The wrapper asks for the float4 instance only where every shard
    and the output are 16-byte aligned and a shard is whole float4s."""
    base = 1 << 20
    ptrs = [base + 4096 * i + 4 * o for i, o in enumerate(offsets)]
    assert ds._float4(n, ptrs) is want


def test_decode_solve_rejects_a_generator_of_the_wrong_size():
    shards = _shards(MDS_G[:6], np.float32)
    with pytest.raises(ValueError, match=r"G_S must be \(6, 6\)"):
        ds.decode_solve(shards, MDS_G[:5, :5])
