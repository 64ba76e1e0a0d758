"""The LT peel's native route (``native/lt_peel.cpp``) in the port.

The port's copy of ``tests/test_coding.py`` ``TestLTNativePeel``, and
parity with the JAX package: ``LTCode.decode`` peels host arrays in the
port's own build of the C++ decoder by default (the reference's
default), so its blocks equal the JAX package's native peel bit for bit
(the same source, the same release order). Against the numpy peel and
the port's torch peel, which release in another order, they agree to
rounding: within 1e-12 absolute in f64 and 1e-5 in f32 (values of order
1 summed over a few blocks), exactly on integers.
"""

import warnings

import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.ops.lt import LTCode as JaxLTCode
from mpistragglers_jl_tpu_torch import native
from mpistragglers_jl_tpu_torch.ops import lt as tlt
from mpistragglers_jl_tpu_torch.ops.lt import LTCode


def _peelable_ids(code):
    ids, s = [], 0
    while not code.peelable(ids):
        ids.append(s)
        s += 1
    return ids


def _shards(code, ids, blocks):
    G = code.generator_rows(ids)
    return np.einsum("nk,krc->nrc", G, blocks)


def test_native_builds_into_the_ports_build_dir():
    lib = tlt._load_native()
    path = native.lib_path("lt_peel")
    assert lib._name == path
    assert "mpistragglers_jl_tpu_torch" in path and "_build" in path


def test_native_matches_numpy_f64():
    rng = np.random.default_rng(11)
    k = 12
    code = LTCode(k, seed=3)
    ids = _peelable_ids(code)
    blocks = rng.standard_normal((k, 7, 5))
    shards = _shards(code, ids, blocks)
    a = code.decode(shards, ids, prefer_native=True)
    b = code.decode(shards, ids, prefer_native=False)
    # the release ORDER may differ (worklist vs rescan), so results
    # agree to rounding, not bitwise
    assert np.allclose(a, b, atol=1e-12)
    assert np.allclose(a, blocks, atol=1e-10)


def test_native_f32_and_int_dtypes():
    rng = np.random.default_rng(12)
    k = 6
    code = LTCode(k, seed=2)
    ids = _peelable_ids(code)
    for dtype, atol in ((np.float32, 1e-5), (np.int64, 0)):
        blocks = rng.integers(-50, 50, (k, 4, 3)).astype(dtype)
        shards = _shards(code, ids, blocks.astype(np.float64))
        out = code.decode(shards.astype(dtype), ids)
        assert out.dtype == dtype
        assert np.allclose(out, blocks, atol=atol)


def test_native_stall_raises():
    code = LTCode(8, seed=0)
    ids = [0]
    assert not code.peelable(ids)
    with pytest.raises(ValueError, match="stalled"):
        code.decode(np.zeros((1, 2, 2)), ids, prefer_native=True)


@pytest.mark.parametrize("systematic", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_native_peel_equals_the_jax_packages(systematic, dtype):
    """Both packages' default (native) peels of the same shards give the
    same bits; the numpy peel and the port's torch peel (on CPU
    tensors) agree with them to rounding."""
    k = 8
    rng = np.random.default_rng(21 + systematic)
    code = LTCode(k, seed=16, systematic=systematic)
    jcode = JaxLTCode(k, seed=16, systematic=systematic)
    ids = _peelable_ids(code)
    assert ids == _peelable_ids(jcode)
    blocks = rng.standard_normal((k, 16, 9))
    shards = _shards(code, ids, blocks).astype(dtype)
    got = code.decode(shards, ids)
    np.testing.assert_array_equal(got, jcode.decode(shards, ids))
    atol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(
        got, code.decode(shards, ids, prefer_native=False), atol=atol)
    on_tensors = code.decode(torch.from_numpy(shards), ids)
    assert isinstance(on_tensors, torch.Tensor)
    np.testing.assert_allclose(got, on_tensors.numpy(), atol=atol)


def test_numpy_fallback_warns_when_the_toolchain_is_broken(monkeypatch):
    def broken_load(name, configure=None):
        raise native.NativeBuildError("g++ unavailable or hung: simulated")

    monkeypatch.setattr(native, "load", broken_load)
    code = LTCode(6, seed=2)
    ids = _peelable_ids(code)
    blocks = np.random.default_rng(3).standard_normal((6, 2, 2))
    shards = _shards(code, ids, blocks)
    with pytest.warns(RuntimeWarning, match="numpy fallback"):
        out = code.decode(shards, ids)
    assert np.allclose(out, blocks, atol=1e-10)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # tensors never try the native peel
        code.decode(torch.from_numpy(shards), ids)
