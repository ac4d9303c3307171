"""The port's decode and qdq plain versions against the reference's Pallas
kernels, and the wire-level rounding stream's device.

The reference kernels run in interpret mode, as the reference's own tests
run them on the CPU. Given the same words, levels, clip limits and
rounding bits, every comparison here is exact (``assert_array_equal``,
which also holds -0.0 == 0.0: the reference's one-hot decode and the
port's table lookup may differ only in the sign of a zero). The mean
decode is exact for every worker count L: the reference's ``out += val *
(1.0 / L)`` runs, under XLA, as one fused multiply-add per worker, and
the port accumulates ``fma(val, f32(1/L), out)`` in the same order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_decode as jfused_decode
from repro.kernels import fused_encode as jfused_encode
from repro_torch.core import encode, floats, prng
from repro_torch.core.api import make_quantizer
from repro_torch.core.comm import wire
from repro_torch.kernels import fused_decode, fused_encode, ops, ref

jax.config.update("jax_platform_name", "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _stack(L, nb, d, bits, s, seed):
    rng = np.random.default_rng(seed)
    nw = encode.packed_words(d, bits)
    # random words: the unused top bits at 3 and 5 bits are set too, and
    # indices >= s occur (both decode those to 0)
    words = rng.integers(0, 2 ** 32, (L, nb, nw), dtype=np.uint32)
    levels = np.sort(rng.standard_normal((L, nb, s)) * 0.3,
                     axis=-1).astype(np.float32)
    levels[0, 0, 1] = 0.0                 # a zero level entry
    return words, levels


DECODE_CASES = ([(L, 4, 9, 100) for L in (1, 2, 3, 4)]
                + [(3, bits, s, 97) for bits, s in ((1, 2), (2, 3), (3, 5),
                                                    (5, 17))]
                + [(4, 4, 9, 2048)])


@pytest.mark.parametrize("L,bits,s,d", DECODE_CASES)
def test_decode_fused_mean_plain_exact(L, bits, s, d):
    words, levels = _stack(L, 5, d, bits, s, seed=L * 100 + bits)
    want = np.asarray(jfused_decode.decode_fused_mean(
        jnp.asarray(words), jnp.asarray(levels), d=d, bits=bits, s=s,
        interpret=True))
    got = fused_decode.decode_fused_mean_plain(
        _t(words.view(np.int32)), _t(levels), d=d, bits=bits)
    assert got.shape == (5, d) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("L,bits,s,d", DECODE_CASES)
def test_decode_fused_each_plain_exact(L, bits, s, d):
    words, levels = _stack(L, 5, d, bits, s, seed=L * 100 + bits + 7)
    want = np.asarray(jfused_decode.decode_fused_each(
        jnp.asarray(words), jnp.asarray(levels), d=d, bits=bits, s=s,
        interpret=True))
    got = fused_decode.decode_fused_each_plain(
        _t(words.view(np.int32)), _t(levels), d=d, bits=bits)
    assert got.shape == (L, 5, d)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("L,s,want", [
    (1, 9, 8), (4, 9, 8), (4, 2, 8), (90, 17, 8), (91, 17, 7), (400, 17, 1),
    (800, 17, 1),
    # the largest L the mean wrapper takes: one row's tables fill 227 KB
    (fused_decode.SMEM_BYTES // (4 * 17), 17, 1),
    (fused_decode.SMEM_BYTES // (4 * 2), 2, 1),
])
def test_mean_rows_per_block(L, s, want):
    """Rows a block of the mean kernel takes: 8 while their L level tables
    fit the 48 KB budget, fewer as L grows, one row (alone over the budget
    from L * s > 12,288, where the launch opts in) up to 227 KB."""
    R = fused_decode.mean_rows(L, s)
    assert R == want
    assert R * L * s * 4 <= fused_decode.SMEM_BYTES
    assert R == 1 or R * L * s * 4 <= fused_decode.MEAN_SMEM_BUDGET


def test_decode_mean_is_not_sum_then_scale():
    """At L = 3 the kernel's order (a fused multiply-add per worker), a
    separate multiply and add, and the reference's jnp oracle (add, then
    scale) all round differently somewhere; the port follows the kernel."""
    words, levels = _stack(3, 64, 256, 4, 9, seed=5)
    kernel_order = fused_decode.decode_fused_mean_plain(
        _t(words.view(np.int32)), _t(levels), d=256, bits=4).numpy()
    each = fused_decode.decode_fused_each_plain(
        _t(words.view(np.int32)), _t(levels), d=256, bits=4)
    inv = torch.tensor(1 / 3)
    sum_then_scale = (each.sum(0) * inv).numpy()
    mul_add = (each[0] * inv + each[1] * inv + each[2] * inv).numpy()
    for other in (sum_then_scale, mul_add):
        assert (kernel_order != other).any()
        np.testing.assert_allclose(kernel_order, other, rtol=1e-6,
                                   atol=1e-7)


def test_fma_f32_rounds_once():
    """``floats.fma_f32`` against exact rational arithmetic, with addends
    from far below to far above the product."""
    from fractions import Fraction
    rng = np.random.default_rng(0)
    a = rng.standard_normal(3000).astype(np.float32)
    b = np.where(np.arange(3000) % 2, np.float32(1 / 3),
                 rng.standard_normal(3000)).astype(np.float32)
    c = (rng.standard_normal(3000)
         * 2.0 ** rng.integers(-30, 30, 3000)).astype(np.float32)
    got = floats.fma_f32(_t(a), _t(b), _t(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda f: (abs(Fraction(float(f)) - exact),
                                         int(np.float32(f).view(np.int32))
                                         & 1))
        assert g == best, (x, y, z, g, best)


@pytest.mark.parametrize("bits", [1, 4])
def test_decode_checks_shapes(bits):
    words, levels = _stack(2, 3, 64, bits, 2, seed=1)
    with pytest.raises(ValueError, match="do not hold"):
        fused_decode.decode_fused_mean_plain(_t(words.view(np.int32)),
                                             _t(levels), d=65 * 32, bits=bits)
    with pytest.raises(ValueError, match="levels"):
        fused_decode.decode_fused_each_plain(_t(words.view(np.int32)),
                                             _t(levels[:1]), d=64, bits=bits)


QDQ_CASES = [("rr", 9, 300), ("rr", 5, 97), ("rr", 17, 64), ("bin", 2, 300),
             ("sign", 2, 300)]


def _qdq_inputs(nb, d, s, mode, seed, edge=None):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((nb, d)) * 0.3).astype(np.float32)
    mask = rng.random((nb, d)) >= 0.1
    levels = np.sort(rng.standard_normal((nb, s)) * 0.3,
                     axis=-1).astype(np.float32)
    rb = (rng.integers(0, 2 ** 32, (nb, d), dtype=np.uint32)
          if mode == "rr" else None)
    if edge is not None:
        QDQ_EDGES[edge](v, levels)
    return v, mask, levels, rb


def _ties(v, lv):
    """Equal levels (a whole table, an inner run, the top pair, the bottom
    pair) and values exactly on them."""
    s = lv.shape[1]
    lv[0, :] = lv[0, 0]
    lv[1, 1:s - 1] = lv[1, 1]
    lv[2, -1] = lv[2, -2]
    lv[3, 1] = lv[3, 0]
    v[:4, :s] = lv[:4]


def _nonfinite(v, lv):
    """NaN, +inf, -inf and -0.0 values; row 3 holds one NaN, so its clip
    limit is NaN."""
    v[0, :6] = [np.nan, np.inf, -np.inf, -0.0, 0.0, np.nan]
    v[1, :] = np.inf
    v[2, ::3] = -np.inf
    v[3, v.shape[1] // 2] = np.nan


def _nonfinite_levels(v, lv):
    """NaN levels (inside, all, on top, at the bottom), infinite levels
    and a descending table; infinite values."""
    lv[0, 1] = np.nan
    lv[1, :] = np.nan
    lv[2, -1] = np.nan
    lv[3, 0], lv[3, -1] = -np.inf, np.inf
    lv[4] = lv[4, ::-1].copy()
    lv[5, 0] = -np.inf
    v[:6, :3] = [np.inf, -np.inf, 0.0]


QDQ_EDGES = {"ties": _ties, "nonfinite": _nonfinite,
             "nonfinite_levels": _nonfinite_levels}


def _hold_qdq(mode, s, d, clip_c, edge=None):
    """The plain qdq against the reference's kernel (interpret mode) given
    the reference's clip limit (a row reduction, float-close across
    frameworks): equal values (NaN where it gives NaN); masked slots
    decode to level 0."""
    v, mask, levels, rb = _qdq_inputs(6, d, s, mode, seed=s * 10 + d,
                                      edge=edge)
    want = np.asarray(jfused_encode.qdq_fused(
        jnp.asarray(v), jnp.asarray(levels),
        None if rb is None else jnp.asarray(rb), jnp.asarray(mask), s=s,
        clip_c=clip_c, mode=mode, interpret=True))
    lim = (None if clip_c is None else _t(np.asarray(
        jfused_encode.clip_limit(jnp.asarray(v), jnp.asarray(mask),
                                 clip_c))))
    got = fused_encode.qdq_fused_plain(
        _t(v), _t(levels), None if rb is None else _t(rb.view(np.int32)),
        _t(mask), lim, mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[~mask],
                                  np.broadcast_to(levels[:, :1],
                                                  mask.shape)[~mask])


@pytest.mark.parametrize("clip_c", [None, 2.5])
@pytest.mark.parametrize("mode,s,d", QDQ_CASES)
def test_qdq_fused_plain_exact(mode, s, d, clip_c):
    """Given the reference's clip limit, the qdq values are exact; masked
    slots decode to level 0."""
    _hold_qdq(mode, s, d, clip_c)


@pytest.mark.parametrize("clip_c", [None, 2.5])
@pytest.mark.parametrize("edge", sorted(QDQ_EDGES))
@pytest.mark.parametrize("mode,s,d", QDQ_CASES)
def test_qdq_fused_plain_exact_edges(mode, s, d, edge, clip_c):
    """Tied levels, non-finite values and non-finite or unsorted level
    tables: the reference's values; a NaN value or limit clips to NaN and
    rounds to level 0, as jnp.clip does."""
    _hold_qdq(mode, s, d, clip_c, edge)


def test_qdq_matches_encode_then_decode():
    """qdq is the decode of what encode puts on the wire (same levels,
    same rounding): the error-feedback residual is consistent."""
    v, mask, levels, rb = _qdq_inputs(4, 200, 9, "rr", seed=3)
    args = (_t(v), _t(levels), _t(rb.view(np.int32)), _t(mask))
    lim = fused_encode.clip_limit(_t(v), _t(mask), 2.5)
    words = fused_encode.encode_fused_plain(*args, lim, bits=4)
    dec = ref.decode_fused_each_ref(words[None], _t(levels)[None], d=200,
                                    bits=4)[0]
    qdq = fused_encode.qdq_fused_plain(*args, lim)
    np.testing.assert_array_equal(qdq.numpy(), dec.numpy())


def test_ops_dispatch_cpu_takes_plain_versions():
    words, levels = _stack(2, 3, 64, 4, 9, seed=2)
    w, lv = _t(words.view(np.int32)), _t(levels)
    np.testing.assert_array_equal(
        ops.decode_fused_mean(w, lv, 64, bits=4).numpy(),
        fused_decode.decode_fused_mean_plain(w, lv, d=64, bits=4).numpy())
    np.testing.assert_array_equal(
        ops.decode_fused_each(w, lv, 64, bits=4).numpy(),
        fused_decode.decode_fused_each_plain(w, lv, d=64, bits=4).numpy())
    with pytest.raises(ValueError, match="CUDA device"):
        fused_decode.decode_fused_mean_cuda(w, lv, d=64, bits=4)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_encode.qdq_fused_cuda(_t(np.zeros((2, 8), np.float32)),
                                    lv[0, :2], None, None, None, mode="sign")


# ---------------------------------------------------------------------------
# the rounding stream is drawn where the values are
# ---------------------------------------------------------------------------

def test_encode_draws_on_the_values_device(monkeypatch):
    """``wire.encode``/``qdq`` move the key to the values' device before
    the threefry draw: every draw's key lies on ``bkt``'s device."""
    seen = []
    real_bits = prng.bits

    def spy(k, shape):
        seen.append(k.device)
        return real_bits(k, shape)

    monkeypatch.setattr(prng, "bits", spy)
    qz = make_quantizer("orq-9", bucket_size=64)
    v = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    key = prng.key(7, device=torch.device("cpu", 0))
    wire.encode(qz, v, None, key)
    wire.qdq(qz, v, None, key)
    assert seen and all(d == v.device for d in seen)


def test_encode_words_independent_of_key_device_object():
    qz = make_quantizer("orq-9", bucket_size=128)
    v = torch.randn(4, 128, generator=torch.Generator().manual_seed(1))
    mask = torch.rand(4, 128, generator=torch.Generator().manual_seed(2)) > .1
    a, la = wire.encode(qz, v, mask, prng.key(3))
    b, lb = wire.encode(qz, v, mask, prng.key(3, device=torch.device("cpu",
                                                                     0)))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(la.numpy(), lb.numpy())
    np.testing.assert_array_equal(
        wire.qdq(qz, v, mask, prng.key(3)).numpy(),
        wire.qdq(qz, v, mask, prng.key(3, device="cpu")).numpy())
