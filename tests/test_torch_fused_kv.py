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
from torch_test_env import port_test_env  # noqa: F401

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
    # head dims the CUDA kernel pads to 32, 64 and 256 (command-r-plus's
    # smoke config and whisper-base: hd 16; gemma2-9b: hd 256)
    "hd16": (2, 1, 8, 2, 16, 24, "orq-9", 0.0, [24, 7]),
    "hd48_bits1": (2, 2, 4, 4, 48, 16, "bingrad-b", 0.0, [9, 16]),
    "hd256_gqa": (2, 1, 4, 2, 256, 16, "orq-9", 0.0, [16, 5]),
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


# The CUDA kernel skips every context tile that no row of its block admits
# (all tiles for a block with a fully masked row) and cuts the context into
# ``split_count`` splits. Its premise, checked on the plain version: the
# skipped tiles carry weight exactly 0, so attending over the walked tiles
# alone gives the same output (within float32 summation order).
SKIP_CASES = {  # name -> (B, T, H, KV, C, mask kind)
    "decode": (4, 1, 4, 4, 200, "causal"),
    "window": (3, 2, 4, 2, 160, "window"),
    "holes": (2, 3, 8, 2, 96, "holes"),
    "fully_masked_row": (2, 3, 4, 4, 128, "masked_row"),
    "gqa_prefill": (1, 5, 8, 2, 128, "causal"),
}


def _skip_mask(B, T, C, kind, rng):
    c = np.arange(C)[None, None, :]
    qpos = rng.integers(0, C - T + 1, (B,))[:, None] + np.arange(T)[None]
    qpos = qpos[:, :, None]
    if kind == "masked_row":   # row t = 0 admits nothing; t = 1 one position
        qpos = np.full((B, 1, 1), -1) + np.arange(T)[None, :, None]
    mask = c <= qpos
    if kind == "window":
        mask &= c > qpos - 40
    if kind == "holes":
        mask = rng.random((B, T, C)) < 0.05
    return torch.from_numpy(np.ascontiguousarray(mask))


@pytest.mark.parametrize("case", sorted(SKIP_CASES))
def test_skip_rule_drops_only_zero_weights(case):
    B, T, H, KV, C, kind = SKIP_CASES[case]
    hd, bits, s, g = 32, 4, 9, H // KV
    rng = np.random.default_rng(sorted(SKIP_CASES).index(case))
    nw = -(-KV * hd // 8)
    words = [_t(rng.integers(-2 ** 31, 2 ** 31, (B, C, nw), dtype=np.int64)
                .astype(np.int32)) for _ in range(2)]
    lvs = [_t(np.sort(rng.standard_normal((B, C, s)).astype(np.float32)))
           for _ in range(2)]
    q = _t(rng.standard_normal((B, T, H, hd)).astype(np.float32))
    mask = _skip_mask(B, T, C, kind, rng)
    kw = dict(bits=bits, kv_heads=KV, scale=hd ** -0.5)
    full = fused_kv.decode_attend_plain(q, words[0], lvs[0], words[1], lvs[1],
                                        mask, **kw)
    walked = fused_kv.walked_tiles(mask, H, KV)
    n_tiles = -(-C // fused_kv.TILE)
    assert walked.shape == (B, -(-T * g // fused_kv.ROWS_PER_BLOCK), n_tiles)
    if kind == "masked_row":   # the block of a fully masked row walks all
        assert walked[:, 0].all()
    else:
        assert not walked.all()
    for b in range(B):
        for grp in range(walked.shape[1]):
            tiles = walked[b, grp].nonzero().flatten()
            pos = (tiles[:, None] * fused_kv.TILE
                   + torch.arange(fused_kv.TILE)).flatten()
            pos = pos[pos < C]
            sub = fused_kv.decode_attend_plain(
                q[b:b + 1], words[0][b:b + 1, pos].contiguous(),
                lvs[0][b:b + 1, pos].contiguous(),
                words[1][b:b + 1, pos].contiguous(),
                lvs[1][b:b + 1, pos].contiguous(),
                mask[b:b + 1, :, pos].contiguous(), **kw)
            rows = range(grp * fused_kv.ROWS_PER_BLOCK,
                         min((grp + 1) * fused_kv.ROWS_PER_BLOCK, T * g))
            for r in rows:
                t, i = divmod(r, g)
                heads = [kvh * g + i for kvh in range(KV)]
                np.testing.assert_allclose(sub[0, t, heads].numpy(),
                                           full[b, t, heads].numpy(),
                                           rtol=0, atol=1e-6)


@pytest.mark.parametrize("hd,want", [(1, 32), (16, 32), (32, 32), (33, 64),
                                     (48, 64), (64, 64), (80, 128),
                                     (128, 128), (129, 256), (256, 256)])
def test_padded_head_dim(hd, want):
    assert fused_kv.padded_head_dim(hd) == want


@pytest.mark.parametrize("hd", [0, -4, 257, 320])
def test_padded_head_dim_rejects(hd):
    with pytest.raises(ValueError, match="head_dim"):
        fused_kv.padded_head_dim(hd)


@pytest.mark.parametrize("shape,want", [
    ((8, 1, 12, 12, 512), 4),     # lm-100m decode, batch 8
    ((1, 64, 12, 12, 512), 2),    # lm-100m prefill chunk
    ((4, 1, 8, 2, 256), 2),       # GQA, short context: capped by tiles
    ((1, 1, 4, 4, 40), 1),        # two tiles
    ((8, 1, 12, 12, 1000), 4),
    ((1, 1, 32, 8, 4096), 8),     # capped at the portable cluster size
])
def test_split_count(shape, want):
    B, T, H, KV, C = shape
    S = fused_kv.split_count(*shape)
    tiles = -(-C // fused_kv.TILE)
    assert S == want
    assert 1 <= S <= fused_kv.MAX_SPLITS and S & (S - 1) == 0
    assert S == 1 or S * fused_kv.WARPS <= tiles
