"""The port's threefry-2x32 stream is bit-equal to the installed
``jax.random`` (partitionable threefry), and so is the serving engine's
per-token rounding stream built on it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import _layer_salt as jax_layer_salt
from repro.serve.kv_cache import token_rbits as jax_token_rbits
from repro_torch.core import prng
from repro_torch.core import rounding
from repro_torch.serve.engine import _layer_salt
from repro_torch.serve.kv_cache import token_rbits
from torch_test_env import port_test_env  # noqa: F401

SEEDS = [0, 1, 42, 2 ** 31 - 1]
SHAPES = [(1,), (7,), (3, 5), (2, 3, 4), (768,)]


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64) & 0xFFFFFFFF


def test_partitionable_threefry_is_on():
    """The parity target: the port reproduces the partitionable stream."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_bit_equal(seed):
    np.testing.assert_array_equal(prng.key(seed).numpy(),
                                  _u32(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 3, 1000, 2 ** 31 - 1, 2 ** 32 - 1])
def test_fold_in_bit_equal(seed, data):
    want = jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(data))
    got = prng.fold_in(prng.key(seed), data)
    np.testing.assert_array_equal(got.numpy(), _u32(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_bit_equal(seed, shape):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    want = jax.random.bits(k, shape, dtype=jnp.uint32)
    got = prng.bits(prng.fold_in(prng.key(seed), 5), shape)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), _u32(want))


def test_batched_keys_equal_one_by_one():
    """A batch of keys (one per row) draws each row's own stream."""
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, 2 ** 31, 6)
    data = rng.integers(0, 2 ** 31, 6)
    ks = prng.fold_in(prng.key(torch.from_numpy(seeds)),
                      torch.from_numpy(data))
    rows = prng.bits(ks, (9,))
    for i in range(6):
        k = jax.random.fold_in(jax.random.PRNGKey(int(seeds[i])),
                               int(data[i]))
        np.testing.assert_array_equal(
            rows[i].numpy(), _u32(jax.random.bits(k, (9,), jnp.uint32)))


def test_random_bits_are_int32_patterns():
    k = prng.key(7)
    got = rounding.random_bits(k, (4, 33))
    assert got.dtype == torch.int32
    want = jax.random.bits(jax.random.PRNGKey(7), (4, 33), jnp.uint32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


def test_out_of_range_python_ints_raise():
    with pytest.raises(ValueError):
        prng.key(2 ** 32)
    with pytest.raises(ValueError):
        prng.fold_in(prng.key(0), -1)


@pytest.mark.parametrize("gi,j", [(0, 0), (1, 0), (0, 2)])
def test_layer_salts_match(gi, j):
    for flavor in ("k", "v"):
        assert _layer_salt(gi, j, flavor) == jax_layer_salt(gi, j, flavor)


@pytest.mark.parametrize("rep", [0, 1, 11])
@pytest.mark.parametrize("flavor", ["k", "v"])
def test_token_rbits_bit_equal(rep, flavor):
    """The engine's composition key(seed) -> fold_in(pos) ->
    fold_in(salt) -> fold_in(rep) -> bits, with the engine's salts."""
    rng = np.random.default_rng(rep)
    seeds = np.concatenate([[0, 2 ** 31 - 1],
                            rng.integers(0, 2 ** 31, 6)]).astype(np.int32)
    pos = rng.integers(0, 512, seeds.shape[0]).astype(np.int32)
    salt = _layer_salt(0, 0, flavor)
    d = 768
    want = jax_token_rbits(jnp.asarray(seeds), jnp.asarray(pos), salt,
                           jnp.int32(rep), d)
    got = token_rbits(torch.from_numpy(seeds), torch.from_numpy(pos), salt,
                      rep, d)
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, d)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 7])
def test_split_bit_equal(seed, num):
    k = jax.random.fold_in(jax.random.key(seed), 3)
    want = jax.random.key_data(jax.random.split(k, num))
    got = prng.split(prng.fold_in(prng.key(seed), 3), num)
    np.testing.assert_array_equal(got.numpy(), _u32(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [
    ((), 0, 64), ((8,), 0, 32768), ((3, 4), 0, 4), ((10,), -5, 70_000),
    ((5,), 3, 3), ((6,), -2 ** 31, 2 ** 31 - 1)])
def test_randint_bit_equal(seed, shape, lo, hi):
    """jax's two-stream span multiply, its uint32 wrap included (spans
    above 2**16 wrap the multiplier)."""
    k = jax.random.key(seed)
    want = jax.random.randint(k, shape, lo, hi)
    got = prng.randint(prng.key(seed), shape, lo, hi)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (7,), (2, 3)])
def test_uniform_bit_equal(seed, shape):
    k = jax.random.key(seed)
    np.testing.assert_array_equal(
        prng.uniform(prng.key(seed), shape).numpy(),
        np.asarray(jax.random.uniform(k, shape)))
    np.testing.assert_array_equal(
        prng.uniform(prng.key(seed), shape, -2.0, 3.0).numpy(),
        np.asarray(jax.random.uniform(k, shape, minval=-2.0, maxval=3.0)))


def test_batched_split_and_randint_equal_one_by_one():
    keys = prng.split(prng.key(4), 5)                       # (5, 2)
    got = prng.randint(prng.split(keys, 3)[:, 1], (2,), 0, 100)
    jkeys = jax.random.split(jax.random.key(4), 5)
    for i in range(5):
        sub = jax.random.split(jkeys[i], 3)[1]
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(jax.random.randint(sub, (2,), 0, 100)))
