"""The port's quantizer numerics against the JAX reference.

Exact stages (bit-equal): pack/unpack, and the fused encode (clip, round,
mask, pack) given the reference's levels, clip limits and rounding bits;
the Pallas kernel runs in interpret mode, as the reference's own tests
run it on the CPU. Float-close stages: the ORQ level fit and the σ-clip
limit, whose row sums and prefix sums add in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encode as jencode
from repro.core import levels as jlevels
from repro.core.api import make_quantizer as jmake_quantizer
from repro.core.comm import wire as jwire
from repro.kernels import fused_encode as jfused_encode
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import encode
from repro_torch.core import levels
from repro_torch.core.api import all_methods, make_quantizer
from repro_torch.core.comm import wire
from repro_torch.kernels import fused_encode, ops, ref
from torch_test_env import port_test_env  # noqa: F401

jax.config.update("jax_platform_name", "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _data(nb, d, seed, *, frac_masked=0.1, dist="normal"):
    rng = np.random.default_rng(seed)
    if dist == "laplace":
        v = rng.laplace(size=(nb, d)) * 0.2
    else:
        v = rng.standard_normal((nb, d)) * 0.3
    mask = rng.random((nb, d)) >= frac_masked
    rb = rng.integers(0, 2 ** 32, (nb, d), dtype=np.uint32)
    return v.astype(np.float32), mask, rb


def _levels(v, mask, s, seed):
    """Ascending (nb, s) tables (the ORQ fit when s = 2^K + 1)."""
    K = (s - 1).bit_length() - 1
    if s >= 3 and 2 ** K + 1 == s:
        return np.asarray(jlevels.orq_levels(jnp.asarray(v),
                                             jnp.asarray(mask), K))
    rng = np.random.default_rng(seed)
    return np.sort(rng.standard_normal((v.shape[0], s)) * 0.3,
                   axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("d", [1, 31, 100, 768])
def test_pack_unpack_exact(bits, d):
    rng = np.random.default_rng(bits * 1000 + d)
    idx = rng.integers(0, 2 ** bits, (5, d)).astype(np.int32)
    want = np.asarray(jencode.pack(jnp.asarray(idx), bits))
    got = encode.pack(_t(idx), bits)
    assert got.dtype == torch.int32
    assert got.shape[1] == encode.packed_words(d, bits)
    np.testing.assert_array_equal(_words(got), want)
    back = encode.unpack(got, bits, d)
    np.testing.assert_array_equal(back.numpy(), idx)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jencode.unpack(jnp.asarray(want), bits, d)))


def test_static_descriptions_match():
    for name in ("orq-3", "orq-5", "orq-9", "orq-17", "terngrad",
                 "bingrad-b", "signsgd", "qsgd-5"):
        a, b = make_quantizer(name), jmake_quantizer(name)
        assert (a.s, a.wire_bits_per_element) == \
            (b.s, b.wire_bits_per_element)
        assert wire._fused_mode(a) == jwire._fused_mode(b)
        assert wire.wire_unit_bytes(a, 7, 768) == \
            jwire.wire_unit_bytes(b, 7, 768)
    assert all_methods() == list(__import__(
        "repro.core.api", fromlist=["all_methods"]).all_methods())


def test_unported_solvers_raise():
    """Every registered scheme's solver is ported now and fits as the
    reference does (``test_torch_levels.py`` holds each one closely); a
    bad name still raises, and a scheme with no fused encode takes the
    multi-pass path, whose fit raises for an unknown method as the
    reference's does."""
    v, mask, _ = _data(2, 16, 0)
    for name in ("terngrad", "bingrad-b", "signsgd"):
        got = make_quantizer(name).fit(_t(v), _t(mask)).numpy()
        want = np.asarray(jmake_quantizer(name).fit(jnp.asarray(v),
                                                    jnp.asarray(mask)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="bad quantizer name"):
        make_quantizer("orq_9_x")
    from repro_torch.core.quantizers import Quantizer
    from repro.core.quantizers import Quantizer as JQuantizer
    with pytest.raises(ValueError, match="unknown method"):
        wire.encode(Quantizer(method="custom"), _t(v), _t(mask), None)
    with pytest.raises(ValueError, match="unknown method"):
        jwire.encode(JQuantizer(method="custom"), jnp.asarray(v),
                     jnp.asarray(mask), None)


# ---------------------------------------------------------------------------
# ORQ level fit (float-close)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("dist", ["normal", "laplace"])
def test_orq_levels_close(K, dist):
    """Levels agree except where a prefix-sum ulp moves the round at
    ``levels.py:112`` by one sorted index; such flips are counted and must
    stay rare (at most 1% of the table entries)."""
    v, mask, _ = _data(64, 768, K, dist=dist)
    want = np.asarray(jlevels.orq_levels(jnp.asarray(v), jnp.asarray(mask),
                                         K))
    got = levels.orq_levels(_t(v), _t(mask), K).numpy()
    flips = int((got != want).sum())
    print(f"orq K={K} {dist}: {flips} of {want.size} level entries differ")
    assert flips <= 0.01 * want.size
    # every entry is a bucket value either way: a flip moves to a neighbour
    rows_ok = (got == want).all(axis=1)
    np.testing.assert_array_equal(got[rows_ok], want[rows_ok])
    assert np.all(np.diff(got, axis=1) >= 0)


# ---------------------------------------------------------------------------
# fused encode (bit-exact given levels, limits and bits)
# ---------------------------------------------------------------------------

CASES = [  # (mode, bits, s, d)
    ("rr", 4, 9, 768), ("rr", 1, 2, 100), ("rr", 2, 3, 100),
    ("rr", 3, 5, 100), ("rr", 5, 17, 300),
    ("bin", 1, 2, 768), ("sign", 1, 2, 768), ("bin", 1, 2, 33),
]


@pytest.mark.parametrize("clip_c", [None, 2.5])
@pytest.mark.parametrize("mode,bits,s,d", CASES)
def test_encode_fused_plain_bit_exact(mode, bits, s, d, clip_c):
    """The kernel's plain version against the Pallas kernel (interpret
    mode), given the reference's levels, clip limit and bits."""
    v, mask, rb = _data(16, d, bits * 7 + d)
    lv = _levels(v, mask, s, d)
    rbits = jnp.asarray(rb) if mode == "rr" else None
    want = np.asarray(jops.encode_fused(
        jnp.asarray(v), jnp.asarray(lv), rbits, jnp.asarray(mask),
        bits=bits, clip_c=clip_c, mode=mode))
    lim = jfused_encode.clip_limit(jnp.asarray(v), jnp.asarray(mask),
                                   clip_c)
    got = fused_encode.encode_fused_plain(
        _t(v), _t(lv), _t(rb.view(np.int32)) if mode == "rr" else None,
        _t(mask), None if lim is None else _t(np.asarray(lim)),
        bits=bits, mode=mode)
    np.testing.assert_array_equal(_words(got), want)


@pytest.mark.parametrize("clip_c", [None, 2.5])
@pytest.mark.parametrize("mode", ["rr", "bin", "sign"])
def test_encode_fused_ref_and_dispatch_match(mode, clip_c):
    """The plain oracle (multi-pass composition) and the CPU dispatch
    (limit computed by the port) give the reference's words."""
    v, mask, rb = _data(32, 768, 5)
    s, bits = (9, 4) if mode == "rr" else (2, 1)
    lv = _levels(v, mask, s, 3)
    rbits = jnp.asarray(rb) if mode == "rr" else None
    want = np.asarray(jops.encode_fused(
        jnp.asarray(v), jnp.asarray(lv), rbits, jnp.asarray(mask),
        bits=bits, clip_c=clip_c, mode=mode))
    want_ref = np.asarray(jref.encode_fused_ref(
        jnp.asarray(v), jnp.asarray(lv), rbits, jnp.asarray(mask),
        bits=bits, clip_c=clip_c, mode=mode))
    np.testing.assert_array_equal(want, want_ref)
    trb = _t(rb.view(np.int32)) if mode == "rr" else None
    got_ref = ref.encode_fused_ref(_t(v), _t(lv), trb, _t(mask), bits=bits,
                                   clip_c=clip_c, mode=mode)
    got_ops = ops.encode_fused(_t(v), _t(lv), trb, _t(mask), bits=bits,
                               clip_c=clip_c, mode=mode)
    np.testing.assert_array_equal(_words(got_ref), want)
    np.testing.assert_array_equal(_words(got_ops), want)


@pytest.mark.parametrize("nb,d,bits,want", [
    (16, 768, 4, (1, 48)),        # the serving decode: one warp a block
    (128, 768, 4, (1, 384)),      # a prefill chunk
    (16, 768, 1, (1, 16)),
    (16, 100, 3, (1, 16)),
    (1, 2048, 4, (1, 8)),
    (66_058, 2048, 4, (8, 66_058)),   # the training buffer, orq-9
    (66_058, 2048, 3, (7, 66_058)),
    (66_058, 2048, 1, (2, 66_058)),
    (400, 2047, 5, (8, 800)),
])
def test_encode_grid(nb, d, bits, want):
    """(warps a block, blocks) of the encode launch: every word of every
    row lies in exactly one warp's tile."""
    warps, blocks = fused_encode.encode_grid(nb, d, bits)
    assert (warps, blocks) == want
    assert 1 <= warps <= fused_encode.MAX_WARPS and blocks % nb == 0
    tiles = -(-encode.packed_words(d, bits) // fused_encode.TILE_WORDS)
    per_row = blocks // nb
    assert (per_row - 1) * warps < tiles <= per_row * warps


def test_clip_limit_close():
    """σ-clip limits are float-close (row sums add in another order)."""
    v, mask, _ = _data(64, 768, 9)
    want = np.asarray(jfused_encode.clip_limit(jnp.asarray(v),
                                               jnp.asarray(mask), 2.5))
    got = fused_encode.clip_limit(_t(v), _t(mask), 2.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_encode_fused_mask_none_means_all_valid():
    v, _, rb = _data(4, 100, 2)
    lv = _levels(v, np.ones_like(v, bool), 9, 0)
    ones = torch.ones(v.shape, dtype=torch.bool)
    a = fused_encode.encode_fused_plain(_t(v), _t(lv), _t(rb.view(np.int32)),
                                        None, None, bits=4)
    b = fused_encode.encode_fused_plain(_t(v), _t(lv), _t(rb.view(np.int32)),
                                        ones, None, bits=4)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name,clip_c", [("orq-9", None), ("orq-9", 2.5),
                                         ("orq-5", None), ("orq-17", None)])
def test_wire_encode_matches(name, clip_c):
    """``wire.encode`` end to end (fit + encode) with the reference's rbits:
    rows whose levels agree have bit-equal words; level flips are rare."""
    v, mask, rb = _data(64, 768, 11)
    jq = jmake_quantizer(name, bucket_size=768, clip_c=clip_c)
    tq = make_quantizer(name, bucket_size=768, clip_c=clip_c)
    jw, jl = jwire.encode(jq, jnp.asarray(v), jnp.asarray(mask), None,
                          rbits=jnp.asarray(rb))
    tw, tl = wire.encode(tq, _t(v), _t(mask), None,
                         rbits=_t(rb.view(np.int32)))
    jw, jl, tl = np.asarray(jw), np.asarray(jl), tl.numpy()
    # with clip_c the end levels are ±c·σ, whose row sums differ by ulps
    close = np.isclose(tl, jl, rtol=1e-6, atol=0)
    flips = int((~close).sum())
    same = (tl == jl).all(axis=1)
    words_same = (_words(tw) == jw).all(axis=1)
    print(f"{name} clip={clip_c}: {flips} level flips, "
          f"{int((~same).sum())} of 64 rows not bit-equal in levels, "
          f"{int((~words_same).sum())} rows with differing words")
    assert flips <= 0.01 * jl.size
    np.testing.assert_array_equal(_words(tw)[same], jw[same])
