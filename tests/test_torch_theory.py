"""The port's ``core/theory`` against the JAX reference's, on seeded numpy
inputs, for every scheme of the registry with and without a σ-clip.

* ``expected_mse`` / ``deterministic_mse`` on given levels and indices:
  float-close (rtol 1e-6: the same masked row sums, added in another
  order).
* ``scheme_mse``: the level fits are float-close across frameworks, so
  the MSE is held within rtol 1e-5 (seen: 2e-7).
* ``empirical_bias``: the keys of ``prng.split`` equal
  ``jax.random.split``'s, so the same rounding streams are drawn; the
  bias is held within 1e-5 of max |v| (BinGrad-b's levels are means, whose
  sums add in another order; seen: 6e-8 at max |v| 0.3).
* fp has no level fit: both packages refuse ``scheme_mse`` alike; its
  bias is the rounding of the mean of equal samples.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import theory as jtheory
from repro.core.api import all_methods as jall_methods
from repro.core.api import make_quantizer as jmake_quantizer
from repro_torch.core import prng, theory
from repro_torch.core.api import all_methods, make_quantizer
from torch_test_env import port_test_env  # noqa: F401

SCHEMES = all_methods()
BUCKET = 512


def _values(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 0.1).astype(np.float32)
    x[:3] = [1.5, -2.0, 0.0]                 # tails the σ-clip cuts
    return x


def _pair(name, clip_c):
    return (make_quantizer(name, bucket_size=BUCKET, clip_c=clip_c),
            jmake_quantizer(name, bucket_size=BUCKET, clip_c=clip_c))


def test_registry_matches_reference():
    assert SCHEMES == jall_methods()


@pytest.mark.parametrize("clip_c", [None, 2.5])
@pytest.mark.parametrize("name", SCHEMES)
def test_scheme_mse_matches_reference(name, clip_c):
    x = _values()
    qz, jqz = _pair(name, clip_c)
    if qz.is_identity:
        with pytest.raises(ValueError):
            jtheory.scheme_mse(jqz, jnp.asarray(x))
        with pytest.raises(ValueError):
            theory.scheme_mse(qz, torch.from_numpy(x))
        return
    want = float(jtheory.scheme_mse(jqz, jnp.asarray(x)))
    got = float(theory.scheme_mse(qz, torch.from_numpy(x)))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _bucketed(seed, nb=6, d=100, s=5):
    rng = np.random.default_rng(seed)
    bkt = (rng.standard_normal((nb, d)) * 0.2).astype(np.float32)
    mask = rng.random((nb, d)) > 0.2
    mask[0] = False                          # an empty bucket
    levels = np.sort((rng.standard_normal((nb, s)) * 0.15).astype(
        np.float32), axis=1)
    idx = rng.integers(0, s, (nb, d)).astype(np.int32)
    return bkt, mask, levels, idx


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expected_mse_matches_reference(seed):
    bkt, mask, levels, _ = _bucketed(seed)
    want = np.asarray(jtheory.expected_mse(
        jnp.asarray(bkt), jnp.asarray(mask), jnp.asarray(levels)))
    got = theory.expected_mse(torch.from_numpy(bkt), torch.from_numpy(mask),
                              torch.from_numpy(levels)).numpy()
    assert got[0] == want[0] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deterministic_mse_matches_reference(seed):
    bkt, mask, levels, idx = _bucketed(seed)
    want = np.asarray(jtheory.deterministic_mse(
        jnp.asarray(bkt), jnp.asarray(mask), jnp.asarray(levels),
        jnp.asarray(idx)))
    got = theory.deterministic_mse(
        torch.from_numpy(bkt), torch.from_numpy(mask),
        torch.from_numpy(levels), torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("num", [1, 16, 256])
def test_split_keys_match_reference(num):
    want = np.asarray(jax.random.key_data(
        jax.random.split(jax.random.key(3), num)))
    got = prng.split(prng.key(3), num).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("clip_c", [None, 2.5])
@pytest.mark.parametrize("name", SCHEMES)
def test_empirical_bias_matches_reference(name, clip_c):
    x = _values(1000, seed=4)
    qz, jqz = _pair(name, clip_c)
    want = np.asarray(jtheory.empirical_bias(jqz, jnp.asarray(x),
                                             jax.random.key(3),
                                             n_samples=16))
    got = theory.empirical_bias(qz, torch.from_numpy(x), prng.key(3),
                                n_samples=16).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(x).max())
