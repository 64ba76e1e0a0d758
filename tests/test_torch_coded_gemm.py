"""The port's coded-computation layer on the CPU against the JAX package:
the codes (ops/coding.py, ops/lt.py, ops/gradcode.py), uncoded GEMM
(ops/gemm.py) and MDS- and LT-coded GEMM (ops/coded_gemm.py) over the
pool and ``CUDADeviceBackend(devices=[cpu])``.

Tolerances: the generators ``G`` of ``MDSCode``, the supports and
``generator_rows`` of ``LTCode`` and ``GradientCode.B`` are equal
bitwise (both are numpy). ``MDSCode.decode`` within 1e-5 relative of the
reference's at f32 and 1e-10 at f64 (both solve the same k x k system
in other orders). Products at ``"highest"`` within 1e-5 of max|C| of the
reference's (f32 sums over the contraction in other orders); a decode
through parity shards within 1e-5 x cond(G_S) (the solve amplifies the
products' rounding by up to the condition number of the k generator
rows it uses: 24-65 for the sets below, 852 at worst for the (8, 6)
Cauchy code). Late workers are decided by gates (``threading.Event``),
not sleeps, so both packages decode from the same shards.
"""

import itertools
import threading

import jax
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu import AsyncPool as RefPool
from mpistragglers_jl_tpu import asyncmap as ref_asyncmap
from mpistragglers_jl_tpu import waitall as ref_waitall
from mpistragglers_jl_tpu.ops import coded_gemm as jcg
from mpistragglers_jl_tpu.ops import coding as jcoding
from mpistragglers_jl_tpu.ops import gemm as jgemm
from mpistragglers_jl_tpu.ops import gradcode as jgradcode
from mpistragglers_jl_tpu.ops import lt as jlt
from mpistragglers_jl_tpu_torch import AsyncPool, asyncmap, waitall
from mpistragglers_jl_tpu_torch.backends.cuda import StackedSlice
from mpistragglers_jl_tpu_torch.ops import coded_gemm as tcg
from mpistragglers_jl_tpu_torch.ops import coding as tcoding
from mpistragglers_jl_tpu_torch.ops import gemm as tgemm
from mpistragglers_jl_tpu_torch.ops import gradcode as tgradcode
from mpistragglers_jl_tpu_torch.ops import lt as tlt

CPU = [torch.device("cpu")]
HIGHEST = jax.lax.Precision.HIGHEST
PRODUCT_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mats(seed, m, c, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, c)).astype(np.float32),
            rng.standard_normal((c, d)).astype(np.float32))


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close_to_product(got, want, cond=1.0):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= PRODUCT_TOL * cond, err


def _cond(G, rows):
    return float(np.linalg.cond(np.asarray(G, np.float64)[list(rows)]))


class _Gate:
    """Workers in ``late`` wait until the test opens the gate."""

    def __init__(self, late):
        self.late = set(late)
        self.event = threading.Event()

    def __call__(self, i, epoch):
        if i in self.late and not self.event.wait(30.0):
            raise TimeoutError("gate never opened")
        return 0.0


# -- the codes: bit-identical generators --------------------------------


@pytest.mark.parametrize("parity", ["cauchy", "gaussian"])
@pytest.mark.parametrize("n,k,seed", [(8, 6, 0), (6, 4, 3), (16, 12, 1),
                                      (5, 5, 0)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mds_generator_is_bitwise_the_reference(parity, n, k, seed, dtype):
    got = tcoding.MDSCode(n, k, parity=parity, seed=seed, dtype=dtype).G
    want = jcoding.MDSCode(n, k, parity=parity, seed=seed, dtype=dtype).G
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("k", [1, 4, 8, 16])
@pytest.mark.parametrize("systematic", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_lt_supports_and_generator_rows_are_the_reference(k, systematic,
                                                          seed):
    got = tlt.LTCode(k, seed=seed, systematic=systematic)
    want = jlt.LTCode(k, seed=seed, systematic=systematic)
    ids = list(range(40))
    for s in ids:
        assert np.array_equal(got.shard_indices(s), want.shard_indices(s))
    assert got.generator_rows(ids).tobytes() == \
        want.generator_rows(ids).tobytes()
    assert got.peelable(ids[:k]) == want.peelable(ids[:k])
    assert np.array_equal(tlt.robust_soliton(k), jlt.robust_soliton(k))
    assert np.array_equal(tlt.patch_distribution(k),
                          jlt.patch_distribution(k))


@pytest.mark.parametrize("n,s,seed", [(16, 2, 0), (8, 2, 1), (6, 0, 0),
                                      (10, 3, 5)])
def test_gradient_code_B_is_bitwise_the_reference(n, s, seed):
    got = tgradcode.GradientCode(n, s, seed=seed)
    want = jgradcode.GradientCode(n, s, seed=seed)
    assert got.B.tobytes() == want.B.tobytes()
    arrived = list(range(s, n))
    assert np.array_equal(got.decode_weights(arrived),
                          want.decode_weights(arrived))


def test_nwait_predicates_match_the_reference():
    code_t, code_j = tlt.LTCode(4, seed=2), jlt.LTCode(4, seed=2)
    shards = list(range(6))
    rng = np.random.default_rng(0)
    for _ in range(20):
        repochs = rng.integers(0, 3, 6)
        assert tcoding.nwait_decodable(4)(2, repochs) == \
            jcoding.nwait_decodable(4)(2, repochs)
        assert tlt.nwait_lt_decodable(code_t, shards)(2, repochs) == \
            jlt.nwait_lt_decodable(code_j, shards)(2, repochs)


# -- MDS decode on every k-subset ---------------------------------------


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-10)])
@pytest.mark.parametrize("parity", ["cauchy", "gaussian"])
def test_mds_decode_every_subset_matches_the_reference(dtype, tol, parity):
    n, k = 6, 4
    rng = np.random.default_rng(11)
    blocks = rng.standard_normal((k, 5, 7)).astype(dtype)
    code_t = tcoding.MDSCode(n, k, parity=parity, dtype=dtype)
    code_j = jcoding.MDSCode(n, k, parity=parity, dtype=dtype)
    coded_t = code_t.encode(blocks).numpy()
    coded_j = np.asarray(code_j.encode(blocks))
    np.testing.assert_allclose(coded_t, coded_j, rtol=tol, atol=tol)
    for idx in itertools.combinations(range(n), k):
        idx = list(idx)
        got = code_t.decode(coded_j[idx], idx).numpy()
        want = np.asarray(code_j.decode(coded_j[idx], idx))
        assert got.dtype == want.dtype == dtype
        assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))
        assert np.max(np.abs(got - blocks)) <= tol * 10 * np.max(
            np.abs(blocks))


def test_mds_decode_rejects_bad_index_sets():
    code = tcoding.MDSCode(6, 4)
    shards = np.zeros((4, 2, 2), np.float32)
    with pytest.raises(ValueError, match="distinct"):
        code.decode(shards, [0, 0, 1, 2])
    with pytest.raises(ValueError, match="distinct"):
        code.decode(shards, [0, 1, 2])
    with pytest.raises(ValueError, match="not divisible"):
        code.encode_array(np.zeros((10, 3), np.float32))


# -- uncoded GEMM (BASELINE config 2) -----------------------------------


@pytest.mark.parametrize("batch,arrival", [(False, "ready"),
                                           (True, "ready"),
                                           (True, "enqueue")])
def test_distributed_gemm_matches_the_reference(batch, arrival):
    A, B = _mats(0, 64, 48, 24)
    n = 4
    ref = jgemm.DistributedGemm(A, n, precision=HIGHEST, batch=batch,
                                batch_arrival=arrival)
    pool = RefPool(n)
    ref_asyncmap(pool, B, ref.backend, nwait=n)
    want = ref.result(pool)
    ref_waitall(pool, ref.backend)
    ref.backend.shutdown()

    g = tgemm.DistributedGemm(A, n, devices=CPU, batch=batch,
                              batch_arrival=arrival)
    pool = AsyncPool(n)
    assert list(asyncmap(pool, B, g.backend, nwait=n)) == [1] * n
    _close_to_product(g.result(pool), want)
    _close_to_product(g.result(pool), A.astype(np.float64) @ B)
    waitall(pool, g.backend)
    g.backend.shutdown()


def test_gemm_gated_straggler_rows_are_zero_filled():
    A, B = _mats(1, 64, 32, 16)
    n = 4
    gate = _Gate(late=[2])
    g = tgemm.DistributedGemm(A, n, devices=CPU, delay_fn=gate)
    try:
        pool = AsyncPool(n)
        repochs = asyncmap(pool, B, g.backend, nwait=3)
        assert list(repochs) == [1, 1, 0, 1]
        C = g.result(pool).numpy()
        rows = A.shape[0] // n
        ref = A @ B
        for i in (0, 1, 3):
            np.testing.assert_allclose(C[i * rows:(i + 1) * rows],
                                       ref[i * rows:(i + 1) * rows],
                                       atol=1e-4)
        assert np.all(C[2 * rows:3 * rows] == 0)
        gate.event.set()
        waitall(pool, g.backend, timeout=30.0)
    finally:
        g.backend.shutdown()


def test_gemm_row_splits_and_load_balanced_match_the_reference():
    from mpistragglers_jl_tpu.utils import PoolLatencyModel

    A, B = _mats(2, 70, 24, 8)
    splits = [40, 20, 10, 0]
    g = tgemm.DistributedGemm(A, 4, row_splits=splits, devices=CPU)
    pool = AsyncPool(4)
    asyncmap(pool, B, g.backend, nwait=4)
    assert tuple(g.result(pool).shape) == (70, 8)
    _close_to_product(g.result(pool), A.astype(np.float64) @ B)
    g.backend.shutdown()

    model = PoolLatencyModel(4)  # duck-typed: the port needs only its API
    for i, mean in enumerate([0.01, 0.01, 0.02, 0.08]):
        for _ in range(5):
            model.observe(i, mean)
    A, B = _mats(3, 88, 16, 4)
    g = tgemm.DistributedGemm.load_balanced(A, model, devices=CPU)
    want = jgemm.DistributedGemm.load_balanced(A, model)
    assert g.row_splits == want.row_splits
    want.backend.shutdown()
    pool = AsyncPool(4)
    asyncmap(pool, B, g.backend, nwait=4)
    _close_to_product(g.result(pool), A.astype(np.float64) @ B)
    g.backend.shutdown()
    with pytest.raises(ValueError, match="entries for"):
        tgemm.DistributedGemm(np.zeros((10, 4)), 3, row_splits=[5, 5],
                              devices=CPU)
    with pytest.raises(ValueError, match="sum to 10"):
        tgemm.DistributedGemm(np.zeros((10, 4)), 3, row_splits=[5, 4, 2],
                              devices=CPU)


# -- MDS-coded GEMM (BASELINE config 3) ---------------------------------


@pytest.mark.parametrize("batch,arrival", [(False, "ready"),
                                           (True, "ready"),
                                           (True, "enqueue")])
def test_coded_gemm_result_device_matches_the_reference(batch, arrival):
    """Every worker answers (nwait=n), so both packages decode from the
    same k shards, the systematic ones."""
    A, B = _mats(4, 96, 40, 24)
    n, k = 8, 6
    ref = jcg.CodedGemm(A, n, k, precision=HIGHEST, batch=batch,
                        batch_arrival=arrival)
    pool = RefPool(n)
    ref_asyncmap(pool, B, ref.backend, nwait=n)
    want = np.asarray(ref.result_device(pool))
    ref_waitall(pool, ref.backend)
    ref.backend.shutdown()

    cg = tcg.CodedGemm(A, n, k, devices=CPU, batch=batch,
                       batch_arrival=arrival)
    try:
        pool = AsyncPool(n)
        asyncmap(pool, B, cg.backend, nwait=n)
        if batch:
            assert all(isinstance(pool.results[i], StackedSlice)
                       for i in pool.fresh_indices())
        got = cg.result_device(pool)
        assert isinstance(got, torch.Tensor) and got.device == CPU[0]
        _close_to_product(got, want)
        _close_to_product(got, A.astype(np.float64) @ B)
        np.testing.assert_array_equal(cg.result(pool), got.numpy())
        waitall(pool, cg.backend)
    finally:
        cg.backend.shutdown()


@pytest.mark.parametrize("late", [[0], [1, 4], [6, 7]])
def test_coded_gemm_decodes_around_gated_stragglers(late):
    """Any k of n: the gated workers never answer within the epoch, and
    the product still decodes from the others (systematic and parity
    shards in any mix), as the reference decodes it from the same
    shards."""
    A, B = _mats(5, 96, 40, 24)
    n, k = 8, 6
    rows = [i for i in range(n) if i not in late][:k]
    ref_gate = _Gate(late)
    ref = jcg.CodedGemm(A, n, k, precision=HIGHEST, delay_fn=ref_gate)
    pool = RefPool(n)
    ref_asyncmap(pool, B, ref.backend, nwait=n - len(late))
    assert pool.fresh_indices()[:k].tolist() == rows
    want = np.asarray(ref.result_device(pool))
    ref_gate.event.set()
    ref_waitall(pool, ref.backend, timeout=30.0)
    ref.backend.shutdown()

    gate = _Gate(late)
    cg = tcg.CodedGemm(A, n, k, devices=CPU, delay_fn=gate)
    cond = _cond(cg.code.G, rows)
    try:
        pool = AsyncPool(n)
        repochs = asyncmap(pool, B, cg.backend, nwait=n - len(late))
        assert all(repochs[i] == 0 for i in late)
        got = cg.result_device(pool)
        _close_to_product(got, want, cond)
        _close_to_product(got, A.astype(np.float64) @ B, cond)
        gate.event.set()
        waitall(pool, cg.backend, timeout=30.0)
    finally:
        cg.backend.shutdown()


def test_coded_gemm_fast_path_decodes_a_non_contiguous_stack():
    """Batch mode whose k winners are not rows 0..k-1 of the stack: the
    decode gathers them (and the consecutive case is a view)."""
    A, B = _mats(6, 48, 16, 8)
    n, k = 6, 4
    cg = tcg.CodedGemm(A, n, k, devices=CPU, batch=True)
    try:
        pool = AsyncPool(n)
        asyncmap(pool, B, cg.backend, nwait=n)
        pool.results[1] = None  # as if worker 1 were never heard from
        assert pool.fresh_indices().tolist() == [0, 2, 3, 4, 5]
        _close_to_product(cg.result_device(pool), A.astype(np.float64) @ B,
                          _cond(cg.code.G, [0, 2, 3, 4]))
        waitall(pool, cg.backend)
    finally:
        cg.backend.shutdown()


def test_default_precision_is_bf16_operands_with_f32_sums():
    """``precision="default"``: the workers' products take bf16 operands
    and sum in f32; the decode stays f32. Against the product of the
    bf16-rounded operands in f64."""
    A, B = _mats(7, 96, 64, 32)
    cg = tcg.CodedGemm(A, 8, 6, devices=CPU, batch=True,
                       precision="default")
    try:
        pool = AsyncPool(8)
        asyncmap(pool, B, cg.backend, nwait=6)
        got = cg.result_device(pool)
        assert got.dtype == torch.float32
        bf = lambda x: torch.from_numpy(x).bfloat16().double().numpy()  # noqa: E731
        coded = cg.code.encode_array(A).numpy()
        want_coded = bf(coded.reshape(-1, 64)) @ bf(B)
        got_coded = torch.cat([cg.backend.batch_fn(tuple(range(8)),
                                                   torch.from_numpy(B), 1)
                               .reshape(-1, 32)]).numpy()
        err = np.max(np.abs(got_coded - want_coded)) / np.max(
            np.abs(want_coded))
        assert err <= PRODUCT_TOL, err
        # bf16 operands: far from the f32 product's 1e-5, near bf16's 2^-8
        full = A.astype(np.float64) @ B
        rel = np.max(np.abs(got.numpy() - full)) / np.max(np.abs(full))
        assert 1e-4 < rel < 2 ** -6
        waitall(pool, cg.backend)
    finally:
        cg.backend.shutdown()
    with pytest.raises(ValueError, match="precision"):
        tcg.CodedGemm(A, 8, 6, devices=CPU, precision="fast")


def test_coded_gemm_later_features_raise_naming_their_item():
    A = np.zeros((12, 4), np.float32)
    with pytest.raises(NotImplementedError, match="item 9"):
        tcg.CodedGemm(A, 8, 6, devices=CPU, registry=object())
    cg = tcg.CodedGemm(A, 8, 6, devices=CPU)
    with pytest.raises(NotImplementedError, match="item 18"):
        cg.coordinator()
    cg.backend.shutdown()
    lt = tcg.LTCodedGemm(np.zeros((8, 4), np.float32), 8, 4, devices=CPU)
    with pytest.raises(NotImplementedError, match="item 18"):
        lt.coordinator()
    lt.backend.shutdown()


# -- LT-coded GEMM (BASELINE config 4) ----------------------------------


def _ref_host_peel(lt, pool):
    """The reference's ``LTCodedGemm.result`` with its numpy peel."""
    fresh = pool.fresh_indices()
    shards = np.stack([np.asarray(pool.results[i]) for i in fresh])
    ids = [lt.shard_ids[i] for i in fresh]
    blocks = lt.code.decode(shards, ids, prefer_native=False)
    return blocks.reshape(-1, *blocks.shape[2:])


@pytest.mark.parametrize("systematic", [False, True])
def test_lt_result_device_matches_the_reference_host_peel(systematic):
    A, B = _mats(8, 64, 32, 16)
    n, k = 16, 8
    ref = jcg.LTCodedGemm(A, n, k, precision=HIGHEST, systematic=systematic)
    pool = RefPool(n)
    ref_asyncmap(pool, B, ref.backend, nwait=n)
    want = _ref_host_peel(ref, pool)
    ref_waitall(pool, ref.backend)
    ref.backend.shutdown()

    lt = tcg.LTCodedGemm(A, n, k, devices=CPU, systematic=systematic)
    assert lt.shard_ids == ref.shard_ids
    try:
        pool = AsyncPool(n)
        asyncmap(pool, B, lt.backend, nwait=n)
        _close_to_product(lt.result_device(pool), want)
        _close_to_product(lt.result(pool), want)
        waitall(pool, lt.backend)
    finally:
        lt.backend.shutdown()


def test_lt_variable_nwait_decodes_around_gated_stragglers():
    """Config 4's shape at a small size: workers 3 and 11 gated, the
    pool returns at the first peelable arrival set, and the device solve
    equals the host peel and the product."""
    A, B = _mats(9, 64, 32, 16)
    n, k = 16, 8
    gate = _Gate([3, 11])
    lt = tcg.LTCodedGemm(A, n, k, devices=CPU, delay_fn=gate)
    try:
        pool = AsyncPool(n)
        repochs = asyncmap(pool, B, lt.backend, nwait=lt.nwait)
        assert repochs[3] == 0 and repochs[11] == 0
        fresh = pool.fresh_indices()
        assert lt.code.peelable([lt.shard_ids[i] for i in fresh])
        dev = lt.result_device(pool)
        host = lt.result(pool)
        full = A.astype(np.float64) @ B
        _close_to_product(dev, full,
                          _cond(lt._G.numpy(), lt.decode_rows(pool)))
        _close_to_product(host, full)
        gate.event.set()
        waitall(pool, lt.backend, timeout=30.0)
    finally:
        lt.backend.shutdown()
