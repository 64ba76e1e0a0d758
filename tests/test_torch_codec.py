"""Zero-copy payload codec (native/codec.py), the port's copy of
``tests/test_codec.py``.

Raw contiguous ndarrays travel as header-prefix + raw bytes (decode is a
frombuffer VIEW, not a copy); everything else falls back to pickle.
Transport-level shm broadcast is exercised through the backend suites;
here the codec contract itself is pinned. On top of the reference's
contract: numpy frames are byte-identical to the JAX package's codec in
both directions, and torch tensors (f32, int64, bf16, ...) cross as
copies of their host bytes, bit-exact. Tolerance: none, every
comparison is of bytes.
"""

import pickle

import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.native import codec as jcodec
from mpistragglers_jl_tpu_torch.native import codec


def _roundtrip(obj):
    prefix, body = codec.encode(obj)
    # socket framing: prefix + body contiguous
    if isinstance(body, np.ndarray):
        wire = bytearray(prefix) + bytearray(body.reshape(-1).view(np.uint8))
    else:
        wire = bytearray(prefix) + bytearray(body)
    return codec.decode(wire)


def test_raw_arrays_bit_exact():
    for arr in [
        np.array([np.pi, -0.0, np.inf, np.nan]),
        np.arange(24, dtype=np.int64).reshape(2, 3, 4),
        np.array(7.5, dtype=np.float32),          # 0-d
        np.zeros((0, 3), dtype=np.uint8),          # empty
        np.array([2**62, -1], dtype=np.int64),
    ]:
        got = _roundtrip(arr)
        assert got.dtype == arr.dtype and got.shape == arr.shape
        assert got.tobytes() == arr.tobytes()


def test_raw_decode_is_a_view_not_a_copy():
    arr = np.arange(8, dtype=np.float64)
    prefix, body = codec.encode(arr)
    assert body is arr  # send side: the array itself, zero-copy
    wire = bytearray(prefix) + bytearray(body.view(np.uint8))
    got = codec.decode(wire)
    assert got.base is not None  # view over the frame buffer
    wire[len(prefix)] ^= 0xFF    # mutate the buffer through the view
    assert got[0] != arr[0]


def test_out_of_band_body():
    arr = np.arange(6, dtype=np.int32).reshape(2, 3)
    prefix, body = codec.encode(arr)
    got = codec.decode(prefix, memoryview(body.reshape(-1).view(np.uint8)))
    assert np.array_equal(got, arr)


def test_noncontiguous_input_is_made_contiguous():
    arr = np.arange(16, dtype=np.float32).reshape(4, 4)[:, ::2]
    got = _roundtrip(arr)
    assert np.array_equal(got, arr)


def test_pickle_fallbacks():
    rec = np.zeros(2, dtype=[("a", np.int32), ("b", "S3")])
    rec["a"] = [1, 2]
    rec["b"] = [b"xy", b"zzz"]
    for obj in [rec, {"k": [1, 2.5]}, "text", 42, None,
                np.array([{}, []], dtype=object)]:
        prefix, body = codec.encode(obj)
        assert prefix[0] == codec.MAGIC_PICKLE
        got = _roundtrip(obj)
        if isinstance(obj, np.ndarray):
            assert got.dtype == obj.dtype
            assert list(got) == list(obj)
        else:
            assert got == obj


def test_unknown_magic_rejected():
    with pytest.raises(ValueError, match="magic"):
        codec.decode(b"\x7fgarbage")
    with pytest.raises(ValueError, match="magic"):
        codec.decode(b"")


# -- the port's additions -------------------------------------------------


def _wire(prefix, body) -> bytes:
    if isinstance(body, np.ndarray):
        return bytes(prefix) + body.reshape(-1).view(np.uint8).tobytes()
    return bytes(prefix) + bytes(body)


_FRAMES = [
    np.array([np.pi, -0.0, np.inf, np.nan]),
    np.arange(24, dtype=np.int64).reshape(2, 3, 4),
    np.array(7.5, dtype=np.float32),
    np.zeros((0, 3), dtype=np.uint8),
    np.arange(16, dtype=np.float32).reshape(4, 4)[:, ::2],
    np.float64(2.5),
    {"k": [1, 2.5], "t": (None, "x")},
    (np.arange(3, dtype=np.int16), "tail"),
]


@pytest.mark.parametrize("i", range(len(_FRAMES)))
def test_frames_byte_identical_to_the_jax_codec(i):
    """Either package's frame decodes in the other, and the frames are
    the same bytes: the wire is one protocol."""
    obj = _FRAMES[i]
    ours, theirs = _wire(*codec.encode(obj)), _wire(*jcodec.encode(obj))
    assert ours == theirs
    for got in (codec.decode(bytearray(theirs)),
                jcodec.decode(bytearray(ours))):
        if isinstance(obj, (np.ndarray, np.generic)):
            assert got.dtype == np.asarray(obj).dtype
            assert got.tobytes() == np.ascontiguousarray(obj).tobytes()
        else:
            assert pickle.dumps(got) == pickle.dumps(obj)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int64,
                                   torch.float64, torch.uint8, torch.bool])
def test_numpy_dtype_tensor_rides_the_raw_frame(dtype):
    """A tensor numpy can express encodes as the raw frame of its host
    copy: the same bytes as its numpy array's frame, decoded as numpy
    (also by the JAX package's codec)."""
    t = (torch.arange(-6, 18).reshape(4, 6) % 7).to(dtype)
    t = t[:, 1::2]  # not contiguous
    prefix, body = codec.encode(t)
    assert prefix[0] == codec.MAGIC_RAW
    want = t.contiguous().numpy()
    assert _wire(prefix, body) == _wire(*jcodec.encode(want))
    for dec in (codec.decode, jcodec.decode):
        got = dec(bytearray(_wire(prefix, body)))
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()


def test_bf16_tensor_crosses_as_bytes():
    """numpy has no bf16: the tensor pickles as its dtype, shape and
    host bytes and decodes as a fresh CPU tensor that owns them."""
    t = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    prefix, body = codec.encode(t)
    assert prefix[0] == codec.MAGIC_PICKLE
    got = codec.decode(bytearray(_wire(prefix, body)))
    assert got.dtype == torch.bfloat16 and got.shape == t.shape
    assert torch.equal(got.view(torch.int16), t.view(torch.int16))
    got += 1  # writable: its own memory, not the frame's
    assert not torch.equal(got, t)
    # nested, with a 0-d and an empty bf16 tensor
    obj = {"a": t[1:3, ::2], "b": [torch.tensor(1.5, dtype=torch.bfloat16),
                                   torch.zeros(0, 3, dtype=torch.bfloat16)]}
    got = codec.decode(bytearray(_wire(*codec.encode(obj))))
    assert torch.equal(got["a"], t[1:3, ::2])
    assert got["b"][0].shape == () and float(got["b"][0]) == 1.5
    assert got["b"][1].shape == (0, 3)


def test_dumps_never_shares_tensor_memory():
    """``dumps`` (the pipes' pickler) copies a tensor's bytes: the
    unpickled value does not change when the sender's tensor does, and
    no torch storage reduction (a shared-memory handle) is used."""
    t = torch.arange(8, dtype=torch.float32)
    b = torch.arange(4, dtype=torch.float32).to(torch.bfloat16)
    data = codec.dumps((t, b))
    assert b"torch.storage" not in data and b"rebuild_storage" not in data
    t += 100
    b += 100
    got_t, got_b = pickle.loads(data)
    np.testing.assert_array_equal(got_t, np.arange(8, dtype=np.float32))
    assert torch.equal(got_b, torch.arange(4.0).to(torch.bfloat16))


def test_dumps_out_of_band_buffers_carry_tensor_bytes():
    """With a buffer callback (the shared-memory rings), a tensor's
    bytes leave as a protocol-5 out-of-band buffer, as an ndarray's do."""
    t = torch.arange(64, dtype=torch.int64)
    bufs = []
    data = codec.dumps(t, buffer_callback=bufs.append)
    assert len(bufs) == 1 and bufs[0].raw().nbytes == t.numel() * 8
    got = pickle.loads(data, buffers=[b.raw() for b in bufs])
    np.testing.assert_array_equal(got, t.numpy())
