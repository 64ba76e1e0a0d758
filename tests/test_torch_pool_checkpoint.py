"""Pool checkpoints of the port (``utils/checkpoint.py``) against the
JAX package, both ways.

The contract is ``tests/test_utils.py`` ``TestCheckpoint``. Tolerance:
none — the state dicts are JSON of integers and floats, so a pool run
through the same epochs in both packages gives equal dicts apart from
the measured latencies, and a dict (or file) saved by either package
restores in the other to equal state, latencies included. The format
string is the reference's. Late workers are held by gates.
"""

import json
import threading

import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu import AsyncPool as RefPool
from mpistragglers_jl_tpu import LocalBackend as RefLocal
from mpistragglers_jl_tpu import asyncmap as ref_asyncmap
from mpistragglers_jl_tpu import waitall as ref_waitall
from mpistragglers_jl_tpu.utils import checkpoint as jck
from mpistragglers_jl_tpu_torch import (
    AsyncPool,
    CUDADeviceBackend,
    LocalBackend,
    asyncmap,
    waitall,
)
from mpistragglers_jl_tpu_torch.utils import (
    load_state_dict,
    restore,
    save,
    state_dict,
)
from mpistragglers_jl_tpu_torch.utils import checkpoint as tck

CPU = [torch.device("cpu")]
FIELDS = ("ranks", "epoch", "epoch0", "nwait", "sepochs", "repochs")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _echo(worker, payload, epoch):
    return np.concatenate([[worker, epoch], payload])


def _run(pool_cls, backend_cls, am, wa, epochs=3, ranks=3, epoch0=0):
    """``epochs`` epochs of nwait=2, worker 2 gated until each epoch
    returns and then drained: the same bookkeeping in either package."""
    gates = [threading.Event() for _ in range(epoch0 + epochs + 2)]

    def delay(i, epoch):
        if i == 2:
            gates[epoch].wait(30)
        return 0.0

    backend = backend_cls(_echo, ranks, delay_fn=delay)
    try:
        pool = pool_cls(ranks, nwait=2, epoch0=epoch0)
        for _ in range(epochs):
            am(pool, np.zeros(2), backend)
            assert pool.active.tolist() == [False, False, True]
            gates[pool.epoch].set()
            wa(pool, backend)
    finally:
        for g in gates:
            g.set()
        backend.shutdown()
    return pool


def test_state_dict_equals_the_reference():
    got = state_dict(_run(AsyncPool, LocalBackend, asyncmap, waitall,
                          epoch0=4))
    want = jck.state_dict(_run(RefPool, RefLocal, ref_asyncmap, ref_waitall,
                               epoch0=4))
    assert got["format"] == want["format"] == "mpistragglers_jl_tpu.pool-v1"
    assert set(got) == set(want)
    for k in FIELDS:
        assert got[k] == want[k], k
    assert len(got["latency"]) == 3 and all(x > 0 for x in got["latency"])


@pytest.mark.parametrize("direction", ["jax->torch", "torch->jax"])
def test_checkpoint_restores_across_packages(direction, tmp_path):
    path = tmp_path / "pool.json"
    if direction == "jax->torch":
        src = _run(RefPool, RefLocal, ref_asyncmap, ref_waitall)
        jck.save(src, path)
        clone = restore(path)
        back = jck.state_dict(src)
        assert state_dict(clone) == back
    else:
        src = _run(AsyncPool, LocalBackend, asyncmap, waitall)
        save(src, path)
        clone = jck.restore(path)
        assert jck.state_dict(clone) == state_dict(src)
    assert json.loads(path.read_text())["format"] == tck._FORMAT
    np.testing.assert_array_equal(clone.repochs, src.repochs)
    np.testing.assert_array_equal(clone.latency, src.latency)
    assert not clone.active.any()


def test_resume_continues_epoch_numbering():
    pool = _run(AsyncPool, LocalBackend, asyncmap, waitall, epochs=4)
    clone = load_state_dict(state_dict(pool))
    assert clone.nwait == pool.nwait and clone.epoch == 4
    backend = CUDADeviceBackend(lambda i, p, e: p + i, 3, devices=CPU)
    try:
        assert (asyncmap(clone, torch.zeros(2), backend, nwait=3) == 5).all()
        waitall(clone, backend)
    finally:
        backend.shutdown()


def test_refuses_active_pool():
    gate = threading.Event()

    def delay(i, epoch):
        gate.wait(30)
        return 0.0

    backend = LocalBackend(_echo, 2, delay_fn=delay)
    try:
        pool = AsyncPool(2)
        asyncmap(pool, np.zeros(1), backend, nwait=0)
        with pytest.raises(RuntimeError, match="still active"):
            state_dict(pool)
        clone = load_state_dict(state_dict(pool, allow_active=True))
        assert not clone.active.any()
        gate.set()
        waitall(pool, backend)
    finally:
        gate.set()
        backend.shutdown()


def test_rejects_unknown_format():
    with pytest.raises(ValueError, match="format"):
        load_state_dict({"format": "bogus"})
