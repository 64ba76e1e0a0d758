"""Payload codec for the native transport: raw-ndarray fast path.

A copy of the JAX package's ``native/codec.py`` with the same wire
format, so frames of numpy arrays are byte-identical between the two
packages and either side's workers serve the other's coordinator. The
port adds torch tensors, which cross as copies of their bytes on the
host, never as shared-memory or CUDA IPC handles:

* a tensor of a dtype numpy can express is encoded as the raw frame of
  its host copy (it decodes as a numpy array, as a JAX array does in
  the reference);
* any other tensor (bf16, ...) goes through the pickle frame, where
  :func:`dumps` reduces it to its dtype, shape and host bytes and
  :func:`_rebuild_tensor` makes a CPU tensor of them on the other side.

torch is never imported here: a payload can only be a tensor if the
process already imported torch (``sys.modules``).

An earlier transport pickled every payload (backends/native.py), which
put serialization — an extra full copy plus object framing — on the hot
path and capped broadcast throughput around 0.5 GiB/s. This codec keeps
pickle only as the fallback for arbitrary objects; contiguous ndarrays
of plain dtypes travel as a 1-magic-byte + dtype/shape header prefix and
their raw bytes:

* **encode** returns ``(prefix, body)`` where ``body`` is the array
  itself — the transport's two-buffer sends (``isend2`` /
  ``isend_shared`` / ``send2``) write it straight from the array's
  memory, so the send side is zero-copy in user space (the coordinator's
  send queue snapshot is the one required copy: in-flight sends must
  survive caller mutation, the reference's ``isendbuf`` discipline at
  src/MPIAsyncPools.jl:63-66).
* **decode** returns ``np.frombuffer`` over the received frame buffer —
  a view, not a copy; the frame's ``bytearray`` stays alive as the
  array's base.

Wire format (little-endian): ``0x02 | u8 dtype_len | u8 ndim |
dtype_str | i64 shape[ndim] | raw bytes`` for arrays; ``0x01 |
pickle5`` for everything else. Structured dtypes, object dtypes, and
dtypes that don't round-trip through ``dtype.str`` (e.g. ml_dtypes
extension types) take the pickle path — correctness first, the fast
path is an optimization.
"""

from __future__ import annotations

import io
import pickle
import struct
import sys

import numpy as np

__all__ = ["encode", "decode", "dumps", "host_array", "tensor_types",
           "MAGIC_PICKLE", "MAGIC_RAW"]

MAGIC_PICKLE = 0x01
MAGIC_RAW = 0x02


def _raw_eligible(arr: np.ndarray) -> bool:
    if arr.dtype.hasobject or arr.dtype.names is not None:
        return False
    try:
        # extension dtypes (bfloat16, ...) stringify to opaque void
        # descriptors that do not round-trip; verify before trusting
        return np.dtype(arr.dtype.str) == arr.dtype
    except TypeError:  # pragma: no cover - exotic dtype
        return False


def tensor_types() -> tuple:
    """``(torch.Tensor,)`` once this process imported torch, else ``()``
    (no payload can be a tensor then)."""
    torch = sys.modules.get("torch")
    return () if torch is None else (torch.Tensor,)


def host_array(t) -> "np.ndarray | None":
    """A torch tensor's values on the host as a numpy array, or None
    when numpy cannot express its dtype (bf16, ...). A CPU tensor's
    array shares its memory: callers copy it before it can change
    (the transports snapshot at dispatch)."""
    import torch

    if t.layout != torch.strided or t.is_quantized:
        return None
    try:  # probe the dtype on an empty tensor: no copy from the card
        torch.empty(0, dtype=t.dtype).numpy()
    except (TypeError, RuntimeError):
        return None
    return t.detach().resolve_conj().resolve_neg().cpu().contiguous().numpy()


def _tensor_bytes(t) -> np.ndarray:
    """A dense tensor's bytes on the host, flat uint8 (any dtype)."""
    import torch

    if t.layout != torch.strided:
        t = t.to_dense()
    flat = t.detach().cpu().contiguous().reshape(-1)
    return flat.view(torch.uint8).numpy()


def _rebuild_tensor(dtype: str, shape: tuple, data) -> object:
    """The receiving side of a pickled tensor: a fresh CPU tensor that
    owns a copy of ``data`` (a transport view may be read-only and is
    never aliased)."""
    import torch

    data = np.asarray(data, dtype=np.uint8).reshape(-1)
    flat = torch.empty(data.size, dtype=torch.uint8)
    flat.numpy()[:] = data
    return flat.view(getattr(torch, dtype)).reshape(shape)


class _TensorPickler(pickle.Pickler):
    """Pickles torch tensors as their host bytes: numpy-expressible
    dtypes as the numpy array of their values, others through
    :func:`_rebuild_tensor`. Everything else pickles as usual."""

    _tensor: tuple = ()

    def reducer_override(self, obj):
        if isinstance(obj, self._tensor):
            arr = host_array(obj)
            if arr is not None:
                return arr.__reduce_ex__(5)
            return _rebuild_tensor, (
                str(obj.dtype).removeprefix("torch."), tuple(obj.shape),
                _tensor_bytes(obj),
            )
        return NotImplemented


def dumps(obj, buffer_callback=None) -> bytes:
    """``pickle.dumps(obj, protocol=5)`` with torch tensors turned into
    host bytes (:class:`_TensorPickler`). Without torch imported it is
    ``pickle.dumps`` itself."""
    tensor = tensor_types()
    if not tensor:
        return pickle.dumps(obj, protocol=5, buffer_callback=buffer_callback)
    f = io.BytesIO()
    p = _TensorPickler(f, protocol=5, buffer_callback=buffer_callback)
    p._tensor = tensor
    p.dump(obj)
    return f.getvalue()


def encode(obj) -> tuple[bytes, object]:
    """``obj`` -> ``(prefix, body)`` for a two-buffer transport send.

    ``body`` is either the (contiguous) ndarray itself — send it
    zero-copy — or pickled bytes.
    """
    arr = None
    if isinstance(obj, np.ndarray):
        arr = obj
    elif isinstance(obj, tensor_types()):
        # the host copy of a tensor numpy can express; the rest (bf16)
        # pickles as its bytes below
        arr = host_array(obj)
    elif hasattr(obj, "__array__") and not isinstance(
        obj, (str, bytes, bytearray, memoryview)
    ):
        # device arrays: np.asarray is the D2H transfer, unavoidable
        # for a host transport
        arr = np.asarray(obj)
    if arr is not None and _raw_eligible(arr):
        shape = arr.shape  # before ascontiguousarray: it promotes 0-d to 1-d
        arr = np.ascontiguousarray(arr)
        dstr = arr.dtype.str.encode()
        prefix = (
            struct.pack("<BBB", MAGIC_RAW, len(dstr), len(shape))
            + dstr
            + struct.pack(f"<{len(shape)}q", *shape)
        )
        return prefix, arr
    return bytes([MAGIC_PICKLE]), dumps(obj)


def decode(buf, body=None):
    """Inverse of :func:`encode` over a received frame buffer.

    ``buf`` holds the codec prefix; the body either follows it in the
    same buffer (socket frames) or arrives out-of-band in ``body``
    (shared-memory frames — Message.body). Raw arrays come back as
    ``np.frombuffer`` views (no copy; writable iff the buffer is).
    """
    mv = memoryview(buf)
    if mv.nbytes == 0:
        raise ValueError("empty payload has no codec magic")
    magic = mv[0]
    if magic == MAGIC_RAW:
        dlen, ndim = struct.unpack_from("<BB", mv, 1)
        dstr = bytes(mv[3 : 3 + dlen]).decode("ascii")
        shape = struct.unpack_from(f"<{ndim}q", mv, 3 + dlen)
        off = 3 + dlen + 8 * ndim
        data = memoryview(body) if body is not None else mv[off:]
        out = np.frombuffer(data, dtype=np.dtype(dstr)).reshape(shape)
        if out.flags.writeable:
            # uniform contract: decoded payloads are READ-ONLY views of
            # transport memory on every path. Shared-memory bodies are
            # physically read-only (all workers map the same pages);
            # making socket bodies writable would let the same work_fn
            # pass or crash depending on payload size and transport.
            out.flags.writeable = False
        return out
    if magic == MAGIC_PICKLE:
        data = memoryview(body) if body is not None else mv[1:]
        return pickle.loads(data)
    raise ValueError(f"unknown payload codec magic {magic:#x}")
