"""Quantized-KV serving kernels of the port against the JAX reference.

* ``append_kv`` words and levels are bit-equal to the reference's given
  the same rounding bits (the ORQ fits agree exactly on these inputs).
* ``decode_attend``'s plain version is float-close to the Pallas kernel
  (interpret mode): both compute in float32, but the score and PV
  contractions and the softmax sum add in another order. Tolerance:
  ``atol 2e-6`` on outputs of magnitude <= ~1.

The CUDA kernels are held against these plain versions on the card by
``test_torch_fused_kv_gpu.py`` (no JAX there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import make_quantizer as jmake_quantizer
from repro.kernels import ops as jops
from repro.kernels.fused_kv import append_kv as jappend_kv
from repro_torch.core.api import make_quantizer
from repro_torch.kernels import fused_encode, fused_kv, ops

jax.config.update("jax_platform_name", "cpu")

ATOL_PLAIN = 2e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _context(name, B, C, d, seed):
    """B*C random tokens' K/V rows quantized by the reference's append_kv,
    shaped as (B, C, ...) context views; returns numpy arrays."""
    rng = np.random.default_rng(seed)
    qz = jmake_quantizer(name, bucket_size=d)
    k = (rng.standard_normal((B * C, d)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B * C, d)) * 0.5).astype(np.float32)
    rb = rng.integers(0, 2 ** 32, (2 * B * C, d), dtype=np.uint32)
    parts = jappend_kv(qz, jnp.asarray(k), jnp.asarray(v), jnp.asarray(rb))
    return [np.asarray(p).reshape(B, C, -1) for p in parts]


def _mask(B, T, C, fills, seed):
    """Causal-style ragged fills; a fill of 0 gives a fully masked row."""
    m = np.arange(C)[None, None, :] < np.asarray(fills)[:, None, None]
    m = np.broadcast_to(m, (B, T, C)).copy()
    if T > 1:   # later queries see one more position each
        m |= (np.arange(C)[None, None, :]
              < (np.asarray(fills)[:, None, None]
                 + np.arange(T)[None, :, None]))
    return m


ATTEND_CASES = {  # name -> (B, T, H, KV, hd, C, scheme, softcap, fills)
    "decode": (3, 1, 4, 4, 32, 24, "orq-9", 0.0, [24, 5, 13]),
    "prefill": (1, 8, 4, 4, 32, 32, "orq-9", 0.0, [17]),
    "gqa": (2, 1, 8, 2, 32, 16, "orq-5", 0.0, [16, 9]),
    "softcap": (2, 3, 4, 2, 32, 16, "orq-9", 5.0, [7, 16]),
    "fully_masked": (2, 1, 4, 4, 32, 16, "orq-9", 0.0, [0, 16]),
    "bits3_ragged": (2, 1, 2, 2, 50, 16, "orq-5", 0.0, [10, 3]),
}


def _attend_inputs(case, seed=0):
    B, T, H, KV, hd, C, scheme, cap, fills = ATTEND_CASES[case]
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, T, H, hd))).astype(np.float32)
    kw, klv, vw, vlv = _context(scheme, B, C, KV * hd, seed + 1)
    mask = _mask(B, T, C, fills, seed)
    bits = jmake_quantizer(scheme).wire_bits_per_element
    kwargs = dict(bits=bits, kv_heads=KV, scale=hd ** -0.5, softcap=cap)
    return (q, kw, klv, vw, vlv, mask), kwargs


@pytest.mark.parametrize("case", sorted(ATTEND_CASES))
def test_decode_attend_plain_matches_pallas(case):
    args, kw = _attend_inputs(case)
    want = np.asarray(jops.decode_attend(*map(jnp.asarray, args), **kw))
    q, kwd, klv, vwd, vlv, mask = args
    got = ops.decode_attend(_t(q), _t(kwd.view(np.int32)), _t(klv),
                            _t(vwd.view(np.int32)), _t(vlv), _t(mask), **kw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_PLAIN)


def test_fully_masked_row_is_uniform_average():
    """A row with no valid position averages all C values (the reference's
    -2e38 fill), never NaN."""
    args, kw = _attend_inputs("fully_masked")
    q, kwd, klv, vwd, vlv, mask = args
    got = ops.decode_attend(_t(q), _t(kwd.view(np.int32)), _t(klv),
                            _t(vwd.view(np.int32)), _t(vlv), _t(mask), **kw)
    from repro_torch.kernels.ref import _kv_decode
    H, hd = q.shape[2:]
    vals = _kv_decode(_t(vwd.view(np.int32)), _t(vlv), kw["bits"],
                      vlv.shape[-1], H * hd)
    want = vals[0].mean(0).reshape(H, hd)
    np.testing.assert_allclose(got[0, 0].numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("scheme", ["orq-3", "orq-5", "orq-9", "orq-17"])
@pytest.mark.parametrize("rows", [1, 7, 16])
def test_append_kv_bit_equal(scheme, rows):
    d = 64
    rng = np.random.default_rng(rows)
    k = (rng.laplace(size=(rows, d)) * 0.2).astype(np.float32)
    v = (rng.laplace(size=(rows, d)) * 0.2).astype(np.float32)
    rb = rng.integers(0, 2 ** 32, (2 * rows, d), dtype=np.uint32)
    want = jappend_kv(jmake_quantizer(scheme, bucket_size=d),
                      jnp.asarray(k), jnp.asarray(v), jnp.asarray(rb))
    got = fused_kv.append_kv(make_quantizer(scheme, bucket_size=d), _t(k),
                             _t(v), _t(rb.view(np.int32)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype == np.uint32:
            np.testing.assert_array_equal(g.numpy().view(np.uint32), w)
        else:
            np.testing.assert_array_equal(g.numpy(), w)


def test_wrappers_reject_bad_shapes():
    args, kw = _attend_inputs("decode")
    q, kwd, klv, vwd, vlv, mask = map(_t, args)
    with pytest.raises(ValueError, match="mask"):
        ops.decode_attend(q, kwd, klv, vwd, vlv, mask[:, :, :-1], **kw)
    with pytest.raises(ValueError, match="levels do not fit"):
        fused_encode.encode_fused_plain(torch.zeros(2, 8),
                                        torch.zeros(2, 9), None, None, None,
                                        bits=3, mode="bin")
