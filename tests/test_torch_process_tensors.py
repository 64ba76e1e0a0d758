"""Torch tensors across the port's process boundaries.

Both host backends (``ProcessBackend`` over pipes and shared-memory
rings, ``NativeProcessBackend`` over the C++ transport) carry a torch
tensor as a copy of its host bytes, in both directions: never as
torch's shared-memory or CUDA IPC handle, so a ``sendbuf`` mutated right
after ``asyncmap`` does not reach the workers and a worker's result
outlives its process. A tensor of a numpy dtype arrives as a numpy
array (as the reference's JAX arrays do), bf16 as a CPU tensor; every
comparison is of bytes (tolerance: none). Small payloads ride the pipes
or socket frames, large ones (>= 64 KiB, >= 1 MiB for the native
broadcast arena) the shared-memory rings: both sizes are covered.
"""

import os
import time

import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu_torch import AsyncPool, asyncmap, waitall
from mpistragglers_jl_tpu_torch.backends.native import NativeProcessBackend
from mpistragglers_jl_tpu_torch.backends.process import ProcessBackend

N = 2
SMALL, LARGE = 16, 1 << 19  # elements: in band, and through the rings


def _echo(i, payload, epoch):
    return payload


def _made(i, kind, n):
    """The tensors a worker makes: seeded, so the coordinator can make
    the same ones."""
    g = torch.Generator().manual_seed(1000 * i + n)
    x = torch.randn(n, generator=g)
    return {"f32": x, "i64": (x * 1e6).to(torch.int64),
            "bf16": x.to(torch.bfloat16)}[kind]


def _make(i, payload, epoch):
    kind, n = payload["kind"], int(payload["n"])
    return _made(i, kind, n)


class Gate:
    """A delay_fn that holds a worker, before it reads its payload,
    until the file ``path`` exists (a gate across processes)."""

    def __init__(self, path):
        self.path = str(path)

    def __call__(self, i, epoch):
        deadline = time.monotonic() + 60.0
        while not os.path.exists(self.path):
            if time.monotonic() > deadline:
                raise TimeoutError(f"gate {self.path} never opened")
            time.sleep(0.005)
        return 0.0


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


@pytest.fixture(scope="module", params=["process", "native"])
def backends(request, tmp_path_factory):
    """(echo backend, maker backend, gated echo backend and its gate
    file) of one kind, shared by the module's tests (worker start-up is
    the cost)."""
    make = {"process": ProcessBackend,
            "native": NativeProcessBackend}[request.param]
    gate = tmp_path_factory.mktemp(request.param) / "open"
    made = [make(_echo, N), make(_make, N),
            make(_echo, N, delay_fn=Gate(gate))]
    yield made + [gate]
    gate.touch()  # no worker stays held
    for b in made:
        b.shutdown()


def _tensor(kind, n):
    g = torch.Generator().manual_seed(7 + n)
    x = torch.randn(n, generator=g)
    return {"f32": x, "i64": (x * 1e6).to(torch.int64),
            "bf16": x.to(torch.bfloat16)}[kind]


@pytest.mark.parametrize("n", [SMALL, LARGE])
@pytest.mark.parametrize("kind", ["f32", "i64", "bf16"])
def test_tensor_payload_round_trips_bit_exact(backends, kind, n):
    """coordinator -> worker -> coordinator: the echoed value carries
    the tensor's bytes, dtype and shape."""
    backend = backends[0]
    t = _tensor(kind, n)
    pool = AsyncPool(N)
    asyncmap(pool, t, backend, nwait=N)
    waitall(pool, backend)
    for r in pool.results:
        if kind == "bf16":
            assert isinstance(r, torch.Tensor) and r.dtype == torch.bfloat16
        else:
            assert isinstance(r, np.ndarray)
            assert r.dtype == t.numpy().dtype
        assert tuple(r.shape) == tuple(t.shape)
        assert _bits(r) == _bits(t)


@pytest.mark.parametrize("n", [SMALL, LARGE])
@pytest.mark.parametrize("kind", ["f32", "i64", "bf16"])
def test_worker_tensor_results_arrive_bit_exact(backends, kind, n):
    """worker -> coordinator: tensors made in the worker process arrive
    with their bytes, and bit-copy into a ``recvbuf`` of their width."""
    backend = backends[1]
    pool = AsyncPool(N)
    width = {"f32": np.float32, "i64": np.int64, "bf16": np.uint16}[kind]
    recvbuf = np.zeros(N * n, dtype=width)
    asyncmap(pool, {"kind": kind, "n": n}, backend, recvbuf, nwait=N)
    waitall(pool, backend, recvbuf)
    for i in range(N):
        want = _made(i, kind, n)
        assert _bits(pool.results[i]) == _bits(want)
        assert recvbuf[i * n:(i + 1) * n].tobytes() == _bits(want)


@pytest.mark.parametrize("n", [SMALL, LARGE])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_sendbuf_mutated_after_asyncmap_does_not_reach_workers(
        backends, kind, n):
    """The snapshot rule (``pool.py``'s docstring): the workers are held
    at a gate before they read their payload, the caller overwrites its
    tensor right after ``asyncmap`` returns and then opens the gate, and
    the workers still echo the bytes it had at dispatch."""
    backend, gate = backends[2], backends[3]
    gate.unlink(missing_ok=True)
    t = _tensor(kind, n)
    want = _bits(t.clone())
    pool = AsyncPool(N)
    asyncmap(pool, t, backend, nwait=0)
    t.fill_(-1)
    gate.touch()
    waitall(pool, backend)
    for r in pool.results:
        assert _bits(r) == want
