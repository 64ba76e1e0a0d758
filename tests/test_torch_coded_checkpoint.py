"""Erasure-coded checkpoints of the port (``utils/coded_checkpoint.py``)
against the JAX package, both ways.

The contract is ``tests/test_coded_checkpoint.py``: its six
``CodedCheckpoint`` cases, its two ``FleetCheckpointer`` cases and the
crash-safe generation swap run here on the port, and a fleet checkpoint
saved by either package restores in the other. Tolerance: none. A checkpoint written by either package, with
n - k of its shards deleted, restores bit-equal in the other, f32 and
bf16 leaves included, on the native and the numpy RS routes. Shard files
are not compared byte for byte: ``np.savez`` stamps zip entry times.
"""

import glob
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.utils.coded_checkpoint import (
    CodedCheckpoint as RefCoded,
)
from mpistragglers_jl_tpu_torch.utils import CheckpointCorrupt, RSGF256
from mpistragglers_jl_tpu_torch.utils import CodedCheckpoint as _Coded

ROUTES = [True, False]  # prefer_native: the C++ route, then numpy


def CodedCheckpoint(n, k, prefer_native=True):  # noqa: N802
    """The port's checkpointer, on the native or the numpy RS route
    (the same generator, so the same bytes)."""
    cc = _Coded(n, k)
    if not prefer_native:
        cc.rs = RSGF256(n, k, prefer_native=False)
    return cc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state():
    return {
        "w": torch.arange(10.0).reshape(2, 5),
        "opt": {"mu": torch.full((3,), 0.5), "step": np.int64(42)},
    }


def _check(restored, expect):
    np.testing.assert_array_equal(restored["w"].numpy(), expect["w"].numpy())
    np.testing.assert_array_equal(restored["opt"]["mu"].numpy(),
                                  expect["opt"]["mu"].numpy())
    assert int(restored["opt"]["step"]) == 42


def _shard(tmp_path, i):
    (match,) = glob.glob(str(tmp_path / f"shard_{i}.*.rs"))
    return match


@pytest.mark.parametrize("native", ROUTES)
def test_roundtrip_all_shards(tmp_path, native):
    cc = CodedCheckpoint(5, 3, prefer_native=native)
    assert cc.rs.impl == ("native" if native else "numpy")
    paths = cc.save(tmp_path, _state())
    assert len(paths) == 5 and all(os.path.exists(p) for p in paths)
    _check(cc.restore(tmp_path, target=_state()), _state())


def test_restores_after_losing_n_minus_k_shards(tmp_path):
    cc = CodedCheckpoint(5, 3)
    cc.save(tmp_path, _state())
    os.remove(_shard(tmp_path, 0))
    os.remove(_shard(tmp_path, 3))  # any 2 of 5 gone
    _check(cc.restore(tmp_path, target=_state()), _state())


def test_corrupt_shards_detected_and_excluded(tmp_path):
    cc = CodedCheckpoint(5, 3)
    cc.save(tmp_path, _state())
    # flip bytes in two shards: CRC catches them, decode uses the rest
    for i in (1, 4):
        p = pathlib.Path(_shard(tmp_path, i))
        raw = bytearray(p.read_bytes())
        raw[7] ^= 0xFF
        p.write_bytes(bytes(raw))
    _check(cc.restore(tmp_path, target=_state()), _state())


def test_too_few_intact_shards_raises(tmp_path):
    cc = CodedCheckpoint(4, 3)
    cc.save(tmp_path, _state())
    os.remove(_shard(tmp_path, 0))
    pathlib.Path(_shard(tmp_path, 2)).write_bytes(b"\x00" * 5)  # bad length
    with pytest.raises(CheckpointCorrupt) as e:
        cc.restore(tmp_path, target=_state())
    assert e.value.have == 2 and e.value.need == 3
    assert "corrupt" in str(e.value)


def test_mismatched_code_params_refused(tmp_path):
    CodedCheckpoint(5, 3).save(tmp_path, _state())
    with pytest.raises(ValueError, match="coded"):
        CodedCheckpoint(6, 4).restore(tmp_path)


def test_restore_without_target_returns_leaves(tmp_path):
    cc = CodedCheckpoint(3, 2)
    cc.save(tmp_path, {"a": np.arange(4), "b": np.ones(2)})
    leaves = cc.restore(tmp_path)
    assert isinstance(leaves, list) and len(leaves) == 2


def _controller_state():
    """A coordinator-shaped state dict: epoch counters, per-worker
    repochs/active, and the router book summary — the payload
    fleet.FleetCheckpointer codes across shards."""
    return {
        "epoch": np.int64(41),
        "repochs": np.array([41, 41, 40, 41], np.int64),
        "active": np.array([False, False, True, False]),
        "provisioned": np.array([True, True, True, False]),
        "chip_seconds": np.array([120.5, 120.5, 60.25, 0.0]),
        "book_awaiting": np.array([2, 0, 1, 0], np.int64),
        "book_streaming": np.array([3, 4, 0, 0], np.int64),
        "inflight_ids": np.arange(10, dtype=np.int64),
        "rate_count": np.float64(17.25),
        "policy_code": np.int64(1),
    }


def test_controller_state_roundtrip_through_fleet_checkpointer(tmp_path):
    """The failover payload round-trips exactly: epoch,
    repochs, active set, router books — through the pickle-blob
    FleetCheckpointer channel, surviving n-k lost shards."""
    from mpistragglers_jl_tpu_torch.fleet import FleetCheckpointer

    ck = FleetCheckpointer(tmp_path, n=5, k=3)
    state = _controller_state()
    ck.save(state)
    os.remove(_shard(tmp_path, 1))
    os.remove(_shard(tmp_path, 4))  # any n-k=2 of 5 gone
    out = ck.restore()
    assert set(out) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(v))
    assert out["repochs"].dtype == np.int64  # bit-exact, not value-cast
    assert ck.n_saves == 1


def test_controller_state_torn_write_refused_by_name(tmp_path):
    """A torn write (truncated shard) plus too many losses is REFUSED
    by name: CheckpointCorrupt lists each missing/corrupt shard, and
    the standby must not adopt a partial state."""
    from mpistragglers_jl_tpu_torch.fleet import FleetCheckpointer

    ck = FleetCheckpointer(tmp_path, n=4, k=3)
    ck.save(_controller_state())
    # a torn write: the shard file exists but holds half its bytes
    p = _shard(tmp_path, 0)
    raw = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(raw[: len(raw) // 2])
    os.remove(_shard(tmp_path, 2))
    with pytest.raises(CheckpointCorrupt) as e:
        ck.restore()
    msg = str(e.value)
    assert e.value.have == 2 and e.value.need == 3
    assert "shard 0" in msg and "corrupt" in msg  # the torn write, named
    assert "shard 2" in msg  # the missing shard, named


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fleet_checkpoint_crosses_between_the_packages(tmp_path, writer):
    """A controller state saved by either package's FleetCheckpointer,
    with n - k of its shards gone, restores equal in the other: the
    state is plain data (numpy leaves in a pickled dict)."""
    from mpistragglers_jl_tpu.fleet import FleetCheckpointer as RefFleet
    from mpistragglers_jl_tpu_torch.fleet import FleetCheckpointer

    cls = {"port": FleetCheckpointer, "jax": RefFleet}
    other = {"port": RefFleet, "jax": FleetCheckpointer}[writer]
    state = _controller_state()
    cls[writer](tmp_path, n=5, k=3).save(state)
    os.remove(_shard(tmp_path, 0))
    os.remove(_shard(tmp_path, 3))
    out = other(tmp_path, n=5, k=3).restore()
    assert set(out) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(v))
        assert np.asarray(out[k]).dtype == np.asarray(v).dtype


def test_resave_is_crash_safe_generation_swap(tmp_path):
    """A second save commits via the manifest: new-suffix shards appear,
    previous generation's shards are pruned, restore gets the new state."""
    cc = CodedCheckpoint(4, 2)
    cc.save(tmp_path, {"a": np.zeros(3)})
    first = set(glob.glob(str(tmp_path / "shard_*.rs")))
    cc.save(tmp_path, {"a": np.full(3, 9.0)})
    second = set(glob.glob(str(tmp_path / "shard_*.rs")))
    assert len(second) == 4 and not (first & second)  # old gen pruned
    out = cc.restore(tmp_path, target={"a": np.zeros(3)})
    np.testing.assert_array_equal(out["a"], np.full(3, 9.0))


def test_crash_before_the_manifest_keeps_the_previous_generation(tmp_path):
    """A save that dies after writing its shards but before the manifest
    replace leaves the previous checkpoint restorable, and the next save
    prunes the orphans."""
    cc = CodedCheckpoint(4, 2)
    cc.save(tmp_path, {"a": np.full(3, 1.0)})

    def crash(*a, **k):
        raise OSError("disk gone")

    real = cc._save_locked
    orphan = CodedCheckpoint(4, 2)
    coded, nbytes = orphan.rs.encode_bytes(b"x" * 40)
    for i in range(4):  # the shards of a generation that never committed
        (tmp_path / f"shard_{i}.deadbeef.rs").write_bytes(coded[i].tobytes())
    cc._save_locked = crash
    with pytest.raises(OSError, match="disk gone"):
        cc.save(tmp_path, {"a": np.full(3, 2.0)})
    cc._save_locked = real
    out = cc.restore(tmp_path, target={"a": np.zeros(3)})
    np.testing.assert_array_equal(out["a"], np.full(3, 1.0))
    cc.save(tmp_path, {"a": np.full(3, 3.0)})
    assert not glob.glob(str(tmp_path / "shard_*.deadbeef.rs"))
    out = cc.restore(tmp_path, target={"a": np.zeros(3)})
    np.testing.assert_array_equal(out["a"], np.full(3, 3.0))


# -- across the packages ---------------------------------------------------


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(f"u{x.dtype.itemsize}")


def _pair(dt, seed=0):
    """The same leaves as a JAX tree and a port tree: f32 or bf16
    matrices, an int64 counter, a bool mask."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((33, 17)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    mask = rng.random(7) < 0.5
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    jtree = {"layers": [{"w": jnp.asarray(w, jdt)}, {"w": jnp.asarray(b, jdt)}],
             "step": np.int64(9), "mask": mask}
    ttree = {"layers": [{"w": torch.tensor(w).to(tdt)},
                        {"w": torch.tensor(b).to(tdt)}],
             "step": np.int64(9), "mask": torch.tensor(mask)}
    return jtree, ttree


def _same(port_tree, jax_tree):
    np.testing.assert_array_equal(_bits(port_tree["layers"][0]["w"]),
                                  _bits(jax_tree["layers"][0]["w"]))
    np.testing.assert_array_equal(_bits(port_tree["layers"][1]["w"]),
                                  _bits(jax_tree["layers"][1]["w"]))
    assert int(port_tree["step"]) == int(jax_tree["step"]) == 9
    np.testing.assert_array_equal(np.asarray(port_tree["mask"]),
                                  np.asarray(jax_tree["mask"]))


def _lose(tmp_path, n, k):
    """Lose n - k of the even-numbered shards: corrupt the first, delete
    the rest."""
    gone = list(range(0, n, 2))[: n - k]
    for j, i in enumerate(gone):
        p = pathlib.Path(_shard(tmp_path, i))
        if j == 0:
            raw = bytearray(p.read_bytes())
            raw[3] ^= 0x5A
            p.write_bytes(bytes(raw))
        else:
            p.unlink()


@pytest.mark.parametrize("native", ROUTES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_port_checkpoint_restores_in_jax(tmp_path, dt, native):
    jtree, ttree = _pair(dt)
    CodedCheckpoint(8, 6, prefer_native=native).save(tmp_path, ttree)
    _lose(tmp_path, 8, 6)
    back = RefCoded(8, 6).restore(tmp_path, target=jtree)
    _same(ttree, back)


@pytest.mark.parametrize("native", ROUTES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_jax_checkpoint_restores_in_port(tmp_path, dt, native):
    jtree, ttree = _pair(dt, seed=1)
    RefCoded(8, 6).save(tmp_path, jtree)
    _lose(tmp_path, 8, 6)
    like = _pair(dt, seed=2)[1]
    back = CodedCheckpoint(8, 6, prefer_native=native).restore(
        tmp_path, target=like)
    assert back["layers"][0]["w"].dtype == like["layers"][0]["w"].dtype
    assert back["mask"].dtype == torch.bool
    _same(back, jtree)
    os.remove(_shard(tmp_path, 1))  # a third shard gone
    with pytest.raises(CheckpointCorrupt):
        CodedCheckpoint(8, 6, prefer_native=native).restore(tmp_path,
                                                             target=like)
