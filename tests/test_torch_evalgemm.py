"""The evaluation-point coded GEMMs of the port (``ops/_evalgemm.py``,
``ops/matdot.py``, ``ops/polynomial.py``) against the JAX package, over
``CUDADeviceBackend(devices=[cpu])``.

The contracts are ``tests/test_matdot.py`` and
``tests/test_polynomial.py``. Tolerances: Chebyshev points, encode
weights and MatDot decode weights bit-equal (float64 numpy in both);
decodes of every subset in f64 within rtol/atol 1e-8 of ``A @ B`` (the
contracts' limit) and in f32 within the contracts' 1e-3 (polynomial,
worst subset) and 1e-4 (the pool workloads) of max|A @ B|; the two
packages' decodes of the same fresh set within 1e-5 of max|A @ B| in
f32 (the same products and solves summed in other orders); bf16
operands (``precision="default"``) within 2**-6 x cond(V_S), the
bench's bf16 limit scaled by the Vandermonde solve's amplification.
Late workers are held by gates, so the fresh set is the test's choice.
"""

import itertools
import threading

import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu import AsyncPool as RefPool
from mpistragglers_jl_tpu import asyncmap as ref_asyncmap
from mpistragglers_jl_tpu import waitall as ref_waitall
from mpistragglers_jl_tpu.ops import _evalgemm as jev
from mpistragglers_jl_tpu.ops import matdot as jmd
from mpistragglers_jl_tpu.ops import polynomial as jpoly
from mpistragglers_jl_tpu_torch import (
    AsyncPool,
    WorkerFailure,
    asyncmap,
    waitall,
)
from mpistragglers_jl_tpu_torch.ops import _evalgemm as tev
from mpistragglers_jl_tpu_torch.ops import (
    MatDotCode,
    MatDotGemm,
    MatDotWeightCache,
    PolyCodedGemm,
    PolynomialCode,
)

CPU = [torch.device("cpu")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(_np(got) - want)) / np.max(np.abs(want)))


class _Held:
    """Delay function holding the workers in ``who`` until released."""

    def __init__(self, who):
        self.who = set(who)
        self.gate = threading.Event()

    def __call__(self, i, epoch):
        if i in self.who:
            self.gate.wait(60)
        return 0.0


# -- codes ---------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 5, 8, 13])
def test_chebyshev_points_bit_equal(n):
    np.testing.assert_array_equal(tev.chebyshev_points(n),
                                  jev.chebyshev_points(n))


@pytest.mark.parametrize("p,n", [(1, 2), (2, 5), (3, 7), (4, 8)])
def test_matdot_weights_bit_equal(p, n):
    got, want = MatDotCode(p, n), jmd.MatDotCode(p, n)
    assert got.k == want.k == 2 * p - 1
    for name in ("points", "VA", "VB", "_VC"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for idx in itertools.islice(itertools.combinations(range(n), got.k), 12):
        np.testing.assert_array_equal(got.decode_weights(list(idx)),
                                      want.decode_weights(list(idx)))
    cache = MatDotWeightCache(got, max_entries=2)
    sel = list(range(got.k))
    w = cache.get(sel)
    np.testing.assert_array_equal(w, jmd.MatDotWeightCache(want).get(sel))
    assert cache.get(sel) is w


@pytest.mark.parametrize("p,q,n", [(2, 2, 6), (1, 3, 4), (3, 1, 5),
                                   (2, 3, 8)])
def test_polynomial_weights_bit_equal(p, q, n):
    got, want = PolynomialCode(p, q, n), jpoly.PolynomialCode(p, q, n)
    assert got.k == want.k == p * q
    for name in ("points", "VA", "VB", "VC"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert len(set(np.round(got.points, 12))) == n
    assert np.all(np.abs(got.points) < 1.0)


@pytest.mark.parametrize("p,n", [(1, 2), (2, 5), (3, 7)])
def test_matdot_decode_every_k_subset(p, n):
    rng = np.random.default_rng(0)
    m, kd, nc = 6, 4 * p, 5
    A, B = rng.standard_normal((m, kd)), rng.standard_normal((kd, nc))
    code = MatDotCode(p, n, dtype=np.float64)
    A_enc = _np(code.encode_A(A.reshape(m, p, kd // p).transpose(1, 0, 2)))
    evals = [A_enc[i] @ np.einsum("j,jkw->kw", code.VB[i],
                                  B.reshape(p, kd // p, nc))
             for i in range(n)]
    for idx in itertools.combinations(range(n), code.k):
        C = code.combine(np.stack([evals[i] for i in idx]), list(idx))
        np.testing.assert_allclose(_np(C), A @ B, rtol=1e-8, atol=1e-8)


def test_matdot_weights_interpolate_the_middle_coefficient():
    code = MatDotCode(3, 7)
    idx = [0, 2, 3, 5, 6]
    picked = code.decode_weights(idx) @ (
        code.points[idx][:, None] ** np.arange(code.k))
    expect = np.zeros(code.k)
    expect[code.p - 1] = 1.0
    np.testing.assert_allclose(picked, expect, atol=1e-9)


@pytest.mark.parametrize("p,q,n", [(2, 2, 6), (1, 3, 4), (3, 1, 5),
                                   (2, 3, 8)])
def test_polynomial_decode_every_pq_subset(p, q, n):
    rng = np.random.default_rng(0)
    m, kd, nc = 4 * p, 8, 6 * q
    A, B = rng.standard_normal((m, kd)), rng.standard_normal((kd, nc))
    code = PolynomialCode(p, q, n, dtype=np.float64)
    A_enc = _np(code.encode_A(A.reshape(p, m // p, kd)))
    Bq = B.reshape(kd, q, nc // q)
    evals = [A_enc[i] @ np.einsum("l,klw->kw", code.VB[i], Bq)
             for i in range(n)]
    for idx in itertools.combinations(range(n), p * q):
        C = code.assemble(code.decode(np.stack([evals[i] for i in idx]),
                                      list(idx)))
        np.testing.assert_allclose(_np(C), A @ B, rtol=1e-8, atol=1e-8)


def test_polynomial_f32_conditioning_acceptable():
    rng = np.random.default_rng(1)
    p, q, n = 2, 3, 8
    A = rng.standard_normal((8, 16)).astype(np.float32)
    B = rng.standard_normal((16, 12)).astype(np.float32)
    code = PolynomialCode(p, q, n)
    A_enc = _np(code.encode_A(A.reshape(p, 4, 16)))
    Bq = B.reshape(16, q, 4)
    evals = [A_enc[i] @ np.einsum("l,klw->kw", code.VB[i], Bq)
             for i in range(n)]
    for idx in itertools.combinations(range(n), p * q):
        C = code.assemble(code.decode(np.stack([evals[i] for i in idx]),
                                      list(idx)))
        assert _rel(C, A @ B) < 1e-3, idx


def test_code_validation():
    with pytest.raises(ValueError, match="n >= 2p-1"):
        MatDotCode(3, 4)
    with pytest.raises(ValueError, match="p >= 1"):
        MatDotCode(0, 3)
    code = MatDotCode(2, 5)
    with pytest.raises(ValueError, match="distinct shard indices"):
        code.decode_weights([0, 1, 1])
    with pytest.raises(ValueError, match="expected 2 A-blocks"):
        code.encode_A(np.zeros((3, 2, 2), np.float32))
    with pytest.raises(ValueError, match="expected 3 shards"):
        code.combine(np.zeros((2, 2, 2), np.float32), [0, 1])
    with pytest.raises(ValueError, match="n >= p\\*q"):
        PolynomialCode(2, 3, 5)
    with pytest.raises(ValueError, match="p, q >= 1"):
        PolynomialCode(0, 2, 4)
    pc = PolynomialCode(2, 2, 6)
    with pytest.raises(ValueError, match="distinct shard indices"):
        pc.decode(np.zeros((4, 2, 2), np.float32), [0, 1, 2, 2])
    with pytest.raises(ValueError, match="expected 2 A-blocks"):
        pc.encode_A(np.zeros((3, 2, 2), np.float32))


# -- the pool workloads ----------------------------------------------------


def _held_run(cls, jcls, args, A, B, held, epochs=2):
    """Run the port and the reference with the same workers held, so
    both decode from the same fresh set; returns both products."""
    out = []
    for mod_cls, pool_cls, am, wa, kw in (
            (cls, AsyncPool, asyncmap, waitall, {"devices": CPU}),
            (jcls, RefPool, ref_asyncmap, ref_waitall, {})):
        gate = _Held(held)
        g = mod_cls(A, *args, delay_fn=gate, **kw)
        try:
            pool = pool_cls(g.n)
            for _ in range(epochs):
                am(pool, B, g.backend, nwait=g.nwait)
                assert sorted(set(range(g.n)) - set(
                    pool.fresh_indices().tolist())) == sorted(held)
                out.append(np.asarray(_np(g.result(pool))))
            gate.gate.set()
            wa(pool, g.backend)
        finally:
            gate.gate.set()
            g.backend.shutdown()
    return out[epochs - 1], out[-1]


def test_matdot_pool_workload_equals_the_reference():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((12, 16)).astype(np.float32)
    B = rng.standard_normal((16, 10)).astype(np.float32)
    got, want = _held_run(MatDotGemm, jmd.MatDotGemm, (2, 5), A, B,
                          held=(1, 4))
    assert _rel(got, A @ B) < 1e-4
    assert _rel(got, want) < 1e-5


def test_polynomial_pool_workload_equals_the_reference():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((32, 24)).astype(np.float32)
    B = rng.standard_normal((24, 16)).astype(np.float32)
    got, want = _held_run(PolyCodedGemm, jpoly.PolyCodedGemm, (2, 2, 6),
                          A, B, held=(1, 4))
    assert _rel(got, A @ B) < 1e-4
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("cls,args", [(MatDotGemm, (2, 5)),
                                      (PolyCodedGemm, (2, 2, 4))])
def test_result_requires_k_fresh_and_default_precision(cls, args):
    rng = np.random.default_rng(3)
    A = rng.standard_normal((8, 8)).astype(np.float32)
    B = rng.standard_normal((8, 8)).astype(np.float32)
    g = cls(A, *args, devices=CPU, precision="default")
    try:
        with pytest.raises(ValueError, match=f"need k={g.k}"):
            g.result(AsyncPool(g.n))
        pool = AsyncPool(g.n)
        asyncmap(pool, B, g.backend, nwait=g.n)
        assert g.A_shards[0].dtype == torch.bfloat16
        C = g.result_device(pool)
        idx = pool.fresh_indices()[:g.k]
        V = g.code.points[idx][:, None] ** np.arange(g.k)
        assert C.dtype == torch.float32
        assert _rel(C, A @ B) < 2.0 ** -6 * np.linalg.cond(V)
    finally:
        g.backend.shutdown()


def test_workers_validate_b_shape():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((8, 8)).astype(np.float32)
    pg = PolyCodedGemm(A, 2, 2, 4, devices=CPU)
    try:
        pool = AsyncPool(4)
        with pytest.raises(WorkerFailure, match="divide evenly"):
            asyncmap(pool, rng.standard_normal((8, 7)).astype(np.float32),
                     pg.backend, nwait=4)
            waitall(pool, pg.backend)
    finally:
        pg.backend.shutdown()
    mg = MatDotGemm(np.zeros((4, 6), np.float32), 2, 3, devices=CPU)
    try:
        with pytest.raises(ValueError, match="divide evenly"):
            mg._work(0, torch.zeros(5, 2), 1)
    finally:
        mg.backend.shutdown()
    with pytest.raises(ValueError, match="divide evenly"):
        MatDotGemm(np.zeros((4, 6), np.float32), 4, 9, devices=CPU)
    with pytest.raises(ValueError, match="divide evenly"):
        PolyCodedGemm(np.zeros((9, 4), np.float32), 2, 2, 6, devices=CPU)
