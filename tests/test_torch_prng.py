"""The port's counter-based generator (mpistragglers_jl_tpu_torch/utils/
prng.py) against ``jax.random`` (Threefry-2x32, partitionable, JAX on
the CPU): keys, ``fold_in``, ``bits``, ``uniform`` and ``gumbel`` are
bit-equal; ``categorical`` draws the same index."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu_torch.utils import prng

SEEDS = [0, 1, 42, 2 ** 31 - 1, 2 ** 31, 2 ** 32 + 5, 2 ** 63 - 1, -1,
         -2 ** 63]
SHAPES = [(1,), (7,), (3, 5), (2, 3, 4), (32768,)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jdata(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_are_bit_equal(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _jdata(jk))
    np.testing.assert_array_equal(prng.key_data(tk),
                                  np.asarray(jax.random.key_data(jk)))
    rng = np.random.default_rng(seed % 2 ** 32)
    for d in [0, 1, 2 ** 31, 2 ** 32 - 1, *rng.integers(0, 2 ** 32, 5)]:
        np.testing.assert_array_equal(
            prng.fold_in(tk, int(d)).numpy(),
            _jdata(jax.random.fold_in(jk, np.uint32(d))))
    # a batch of keys folds a batch of data, as vmap would
    ds = rng.integers(0, 2 ** 31, 6)
    got = prng.fold_in(tk.expand(6, 2), torch.as_tensor(ds))
    want = np.stack([_jdata(jax.random.fold_in(jk, int(d))) for d in ds])
    np.testing.assert_array_equal(got.numpy(), want)


def test_key_data_round_trip_and_bad_seeds():
    data = np.asarray(jax.random.key_data(jax.random.key(77)))
    k = prng.wrap_key_data(data)
    assert k.dtype == torch.int64 and k.shape == (2,)
    np.testing.assert_array_equal(prng.key_data(k), data)
    for bad in (-2 ** 63 - 1, 2 ** 63):
        with pytest.raises(ValueError, match="seed"):
            prng.key(bad)
    with pytest.raises(ValueError, match="pair"):
        prng.wrap_key_data(np.zeros(3, np.uint32))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_gumbel_are_bit_equal(shape):
    for i, seed in enumerate(SEEDS):
        jk = jax.random.fold_in(jax.random.key(seed), 1000 + i)
        tk = prng.wrap_key_data(np.asarray(jax.random.key_data(jk)))
        np.testing.assert_array_equal(
            prng.bits(tk, shape).numpy(),
            np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(
                np.int64))
        for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0),
                       (-3.0, 5.5), (0.25, 0.75)):
            np.testing.assert_array_equal(
                prng.uniform(tk, shape, lo, hi).numpy(),
                np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo,
                                              hi)))
        got = prng.gumbel(tk, shape)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax.random.gumbel(jk, shape,
                                                      jnp.float32)))


def test_batched_keys_draw_each_keys_stream():
    keys = [jax.random.key(s) for s in (3, 4, 5)]
    tk = prng.wrap_key_data(np.stack(
        [np.asarray(jax.random.key_data(k)) for k in keys]))
    got = prng.gumbel(tk, (2, 9))
    assert got.shape == (3, 2, 9)
    for r, k in enumerate(keys):
        np.testing.assert_array_equal(
            got[r].numpy(), np.asarray(jax.random.gumbel(k, (2, 9),
                                                         jnp.float32)))


def test_gumbel_is_bit_equal_over_every_uniform_value():
    """The noise depends on 23 bits of each draw, so all 2**23 values
    ``uniform(tiny, 1)`` can give are checked: JAX's own expression
    (``_gumbel``, mode "low") against the port's, in four pieces."""
    tiny = np.float32(np.finfo(np.float32).tiny)

    @jax.jit
    def jax_gumbel(m):
        f = jax.lax.bitcast_convert_type(
            m | np.uint32(0x3F800000), jnp.float32) - 1.0
        u = jnp.maximum(tiny, f * (1.0 - tiny) + tiny)
        return -jnp.log(-jnp.log(u))

    n = 2 ** 23
    for part in range(4):
        m = np.arange(part * n // 4, (part + 1) * n // 4, dtype=np.uint32)
        want = np.asarray(jax_gumbel(m))
        f = torch.from_numpy((m | 0x3F800000).view(np.float32)) - 1.0
        u = torch.clamp_min(f + float(tiny), float(tiny))
        got = (-prng._log(-prng._log(u))).numpy()
        bad = np.flatnonzero(got.view(np.uint32) != want.view(np.uint32))
        assert bad.size == 0, (bad.size, m[bad[:5]])


def test_categorical_draws_the_reference_index():
    rng = np.random.default_rng(0)
    hits = 0
    for i in range(200):
        jk = jax.random.key(i)
        lg = (rng.standard_normal(1000) * 2).astype(np.float32)
        want = int(jax.random.categorical(jk, jnp.asarray(lg)))
        got = prng.categorical(prng.key(i), torch.from_numpy(lg))
        hits += int(got) == want
    assert hits == 200
    lg = (rng.standard_normal((4, 50))).astype(np.float32)
    np.testing.assert_array_equal(
        prng.categorical(prng.key(3), torch.from_numpy(lg)).numpy(),
        np.asarray(jax.random.categorical(jax.random.key(3),
                                          jnp.asarray(lg))))
