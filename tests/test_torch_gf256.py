"""GF(256) Reed-Solomon in the port against the JAX package: the host
codec (``utils/rs_gf256.py``, its numpy and native routes) and the device codec
(``ops/gf256_device.py`` in torch integer ops, on CPU tensors here).

The contracts are ``tests/test_rs_gf256.py`` and
``tests/test_gf256_device.py``. Tolerance: none — every comparison is
byte-equal (generators, tables, shards, decodes), across the port's
host codec, its device codec with both methods, and the JAX package's
``RSGF256`` and ``DeviceRSGF256``.
"""

import itertools
import threading

import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.ops import gf256_device as jgf
from mpistragglers_jl_tpu.utils import rs_gf256 as jrs
from mpistragglers_jl_tpu_torch import AsyncPool, LocalBackend, asyncmap
from mpistragglers_jl_tpu_torch.ops import DeviceRSGF256, gf256_matmul
from mpistragglers_jl_tpu_torch.ops import gf256_device as tgf
from mpistragglers_jl_tpu_torch.utils import RSGF256
from mpistragglers_jl_tpu_torch.utils import rs_gf256 as trs

METHODS = ["bitslice", "gather"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- the host codec -------------------------------------------------------


def test_tables_equal_the_reference():
    for name in ("_EXP", "_LOG", "_MUL"):
        np.testing.assert_array_equal(getattr(trs, name), getattr(jrs, name))
    for a in range(1, 256):
        assert trs._MUL[a][trs._gf_inv(a)] == 1


@pytest.mark.parametrize("n,k", [(8, 6), (9, 5), (12, 6), (4, 4)])
def test_generator_and_shards_equal_the_reference(n, k):
    tp = RSGF256(n, k, prefer_native=False)
    jx = jrs.RSGF256(n, k, prefer_native=False)
    assert tp.impl == "numpy"
    np.testing.assert_array_equal(tp.G, jx.G)
    data = _bytes(n * 10 + k, (k, 257))
    np.testing.assert_array_equal(tp.encode(data), jx.encode(data))
    np.testing.assert_array_equal(tp.encode(data)[:k], data)


def test_decode_every_subset():
    rs = RSGF256(8, 6)
    data = _bytes(1, (6, 19))
    coded = rs.encode(data)
    for idx in itertools.combinations(range(8), 6):
        np.testing.assert_array_equal(rs.decode(coded[list(idx)], list(idx)),
                                      data)


def test_cross_package_decode():
    """Shards coded by either package decode byte-exactly in the other
    (the reference's native route, where it builds, is byte-identical to
    its numpy route: tests/test_rs_gf256.py)."""
    tp, jx = RSGF256(9, 5), jrs.RSGF256(9, 5)
    data = _bytes(2, (5, 1024))
    idx = [8, 0, 3, 7, 5]
    np.testing.assert_array_equal(tp.decode(jx.encode(data)[idx], idx), data)
    np.testing.assert_array_equal(jx.decode(tp.encode(data)[idx], idx), data)


def test_bytes_roundtrip_and_tiny_payloads():
    rs = RSGF256(8, 6)
    payload = bytes(range(256)) * 3 + b"tail"
    coded, length = rs.encode_bytes(payload)
    idx = list(range(2, 8))
    assert rs.decode_bytes(coded[idx], idx, length) == payload
    jc, jlen = jrs.RSGF256(8, 6, prefer_native=False).encode_bytes(payload)
    np.testing.assert_array_equal(coded, jc)
    assert length == jlen
    rs = RSGF256(5, 3)
    coded, length = rs.encode_bytes(b"")
    assert rs.decode_bytes(coded[[4, 2, 0]], [4, 2, 0], length) == b""
    coded, length = rs.encode_bytes(b"x")
    assert rs.decode_bytes(coded[[1, 3, 2]], [1, 3, 2], length) == b"x"


def test_validation_and_native_route():
    rs = RSGF256(4, 2)
    coded = rs.encode(np.zeros((2, 8), dtype=np.uint8))
    with pytest.raises(ValueError, match="distinct"):
        rs.decode(coded[[1, 1]], [1, 1])
    with pytest.raises(ValueError, match="range"):
        rs.decode(coded[[0, 1]], [0, 9])
    with pytest.raises(ValueError, match="expected"):
        rs.encode(np.zeros((3, 8), dtype=np.uint8))
    with pytest.raises(ValueError, match="n <= 256"):
        RSGF256(300, 4)
    # the native route (the default) is byte-equal to the numpy route
    # and to the JAX package's native codec
    nat, npy = RSGF256(9, 5), RSGF256(9, 5, prefer_native=False)
    jnat = jrs.RSGF256(9, 5)
    assert (nat.impl, npy.impl, jnat.impl) == ("native", "numpy", "native")
    np.testing.assert_array_equal(nat.G, npy.G)
    data = _bytes(3, (5, 4099))
    coded = nat.encode(data)
    np.testing.assert_array_equal(coded, npy.encode(data))
    np.testing.assert_array_equal(coded, jnat.encode(data))
    for idx in ([8, 0, 3, 7, 5], [4, 5, 6, 7, 8], [0, 1, 2, 3, 4]):
        want = npy.decode(coded[idx], idx)
        np.testing.assert_array_equal(nat.decode(coded[idx], idx), want)
        np.testing.assert_array_equal(want, data)


def test_native_builds():
    """``tests/test_rs_gf256.py``'s native case: the port's own build of
    ``native/rs_gf256.cpp`` loads (g++ is on this image) from the port's
    ``native/_build/``, never the JAX package's library."""
    from mpistragglers_jl_tpu_torch import native

    assert RSGF256(4, 2).impl == "native"
    lib = trs._load_native()
    assert lib._name == native.lib_path("rs_gf256")
    assert "mpistragglers_jl_tpu_torch" in lib._name


def test_np_invert_roundtrip():
    rs = RSGF256(12, 6)
    idx = [11, 7, 2, 9, 0, 5]
    inv = trs._np_invert(rs.G[idx])
    np.testing.assert_array_equal(inv, jrs._np_invert(rs.G[idx]))
    np.testing.assert_array_equal(trs._np_matmul(inv, rs.G[idx]),
                                  np.eye(6, dtype=np.uint8))


def test_pool_coded_byte_gather():
    """Pool workers each return one coded shard; the two gated workers
    are still out when the pool returns, and the payload decodes
    byte-exactly from the k fresh ones."""
    n, k = 6, 4
    rs = RSGF256(n, k)
    payload = _bytes(4, (k, 64))
    coded = rs.encode(payload)
    gate = threading.Event()

    def delay(i, epoch):
        if i in (1, 4):
            gate.wait(30)
        return 0.0

    backend = LocalBackend(lambda i, s, e: coded[i], n, delay_fn=delay)
    try:
        pool = AsyncPool(n)
        repochs = asyncmap(pool, np.zeros(1), backend, nwait=k, epoch=1)
        fresh = np.flatnonzero(repochs == 1)
        assert fresh.tolist() == [0, 2, 3, 5]
        shards = np.stack([pool.results[i] for i in fresh])
        np.testing.assert_array_equal(rs.decode(shards, fresh.tolist()),
                                      payload)
    finally:
        gate.set()
        backend.shutdown()


# -- the device codec (torch integer ops; CPU tensors here) ----------------


@pytest.mark.parametrize("method", METHODS)
def test_gf_matmul_matches_numpy_reference(method):
    M, D = _bytes(0, (5, 7)), _bytes(1, (7, 33))
    got = gf256_matmul(M, D, method=method, device="cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(_np(got), trs._np_matmul(M, D))
    np.testing.assert_array_equal(
        _np(got), np.asarray(jgf.gf256_matmul(M, D, method=method)))
    eye = np.eye(7, dtype=np.uint8)
    np.testing.assert_array_equal(
        _np(gf256_matmul(eye, D, method=method, device="cpu")), D)


@pytest.mark.parametrize("method", METHODS)
def test_gf_matmul_over_column_chunks(method, monkeypatch):
    """Columns split over several passes give the one-pass bytes."""
    M, D = _bytes(2, (8, 6)), _bytes(3, (6, 1000))
    want = trs._np_matmul(M, D)
    monkeypatch.setattr(tgf, "_CHUNK", 96)
    np.testing.assert_array_equal(
        _np(gf256_matmul(M, D, method=method, device="cpu")), want)


def test_bitslice_mul_exhaustive_against_table():
    """All 65536 GF(256) products: the bit-sliced multiply agrees with the
    log/exp product table and the reference's carry-less multiply."""
    a = np.repeat(np.arange(256, dtype=np.uint8), 256).reshape(256, 256)
    b = np.tile(np.arange(256, dtype=np.uint8), 256).reshape(256, 256)
    got = tgf._gf_mul_bitslice(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(_np(got), trs._MUL[a, b])
    np.testing.assert_array_equal(
        _np(got), np.asarray(jgf._gf_mul_bitslice(a, b)))


@pytest.mark.parametrize("method", METHODS)
def test_encode_bit_identical_to_host_codecs(method):
    n, k, L = 8, 6, 257
    data = _bytes(1, (k, L))
    dev = DeviceRSGF256(n, k, method=method, device="cpu")
    np.testing.assert_array_equal(dev.G, RSGF256(n, k).G)
    coded = _np(dev.encode(data))
    np.testing.assert_array_equal(coded, RSGF256(n, k).encode(data))
    np.testing.assert_array_equal(
        coded, np.asarray(jgf.DeviceRSGF256(n, k, method=method).encode(data)))
    np.testing.assert_array_equal(coded[:k], data)


@pytest.mark.parametrize("method", METHODS)
def test_decode_every_k_subset_exact(method):
    n, k = 6, 4
    data = _bytes(2, (k, 64))
    dev = DeviceRSGF256(n, k, method=method, device="cpu")
    coded = _np(dev.encode(data))
    for idx in itertools.combinations(range(n), k):
        np.testing.assert_array_equal(
            _np(dev.decode(coded[list(idx)], list(idx))), data)


@pytest.mark.parametrize("method", METHODS)
def test_cross_implementation_decode(method):
    """Shards coded on the device decode on either host codec, and host
    (or JAX device) shards decode on the port's device codec."""
    n, k = 7, 5
    data = _bytes(3, (k, 100))
    idx = [6, 0, 3, 5, 1]
    dev = DeviceRSGF256(n, k, method=method, device="cpu")
    dev_coded = _np(dev.encode(data))
    np.testing.assert_array_equal(RSGF256(n, k).decode(dev_coded[idx], idx),
                                  data)
    np.testing.assert_array_equal(
        jrs.RSGF256(n, k).decode(dev_coded[idx], idx), data)
    jcoded = np.asarray(jgf.DeviceRSGF256(n, k).encode(data))
    np.testing.assert_array_equal(_np(dev.decode(jcoded[idx], idx)), data)
    np.testing.assert_array_equal(
        _np(dev.decode(torch.from_numpy(jcoded[idx]), idx)), data)


def test_device_validation():
    dev = DeviceRSGF256(6, 4, device="cpu")
    with pytest.raises(ValueError, match="distinct indices"):
        dev.decode(np.zeros((4, 8), dtype=np.uint8), [0, 1, 2, 2])
    with pytest.raises(ValueError, match="out of range"):
        dev.decode(np.zeros((4, 8), dtype=np.uint8), [0, 1, 2, 6])
    with pytest.raises(ValueError, match="uint8 array"):
        dev.encode(np.zeros((3, 8), dtype=np.uint8))
    with pytest.raises(ValueError, match="uint8 array"):
        dev.decode(np.zeros((3, 8), dtype=np.uint8), [0, 1, 2])
    with pytest.raises(ValueError, match="uint8"):
        dev.encode(torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown method"):
        DeviceRSGF256(6, 4, method="lut", device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        gf256_matmul(np.eye(2, dtype=np.uint8), np.eye(2, dtype=np.uint8),
                     method="lut", device="cpu")


def test_device_codec_needs_a_card_unless_told_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceRSGF256(6, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gf256_matmul(_bytes(0, (2, 3)), _bytes(1, (3, 5)))


@pytest.mark.parametrize("method", METHODS)
def test_gf_matmul_runs_tensors_where_they_lie(method, monkeypatch):
    """CPU tensors need no card and no ``device=``; a named device
    takes the numpy inputs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    M, D = _bytes(4, (3, 4)), _bytes(5, (4, 17))
    got = gf256_matmul(torch.from_numpy(M), torch.from_numpy(D),
                       method=method)
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(_np(got), trs._np_matmul(M, D))
    np.testing.assert_array_equal(
        _np(gf256_matmul(M, torch.from_numpy(D), method=method,
                         device="cpu")), trs._np_matmul(M, D))
