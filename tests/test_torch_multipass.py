"""The multi-pass wire path against the JAX reference, and against the
port's own fused path.

* ``quant_rr_plain``, ``pack_plain``, ``unpack_plain`` and
  ``dequant_avg_plain`` against the reference's Pallas kernels in
  interpret mode, as its own kernel tests run them.
* ``core.rounding`` and the ``Quantizer`` stages (``assign``, ``decode``,
  ``quantize``, ``qdq``, ``encode_wire``, ``decode_wire``,
  ``wire_bytes``) against the reference's, given the same bits or key.
* ``wire.encode_multipass``, ``decode_mean_multipass`` and
  ``decode_each_multipass`` against the reference's for every scheme.
* The port's multi-pass path against its own fused path, at the shapes
  of the reference's ``TestEncodeParity`` / ``TestDecodeParity``.
* ``wire.encode`` / ``wire.qdq`` falling back to the multi-pass path for
  a scheme with no fused mode, against the reference doing the same.

Tolerance: bit-equal everywhere (floats compared as bit patterns, so
the sign of a zero counts, except where a test says "by value"). The
kernels and rounding rules are exact; the level fits are row sums and
sorts, exact in any order on multiples of 1/64 in [-1, 1] (d <= 2048),
so the tests that fit run on such buffers. Elsewhere the tests inject
the reference's levels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rounding as jR
from repro.core.api import make_quantizer as jmake_quantizer
from repro.core.comm import wire as jwire
from repro.core.quantizers import Quantizer as JQuantizer
from repro.kernels import bitpack as jbitpack
from repro.kernels import dequant_avg as jdequant_avg
from repro.kernels import quant_rr as jquant_rr
from repro.kernels import ref as jref
from repro_torch.core import prng
from repro_torch.core import rounding as R
from repro_torch.core.api import all_methods, make_quantizer
from repro_torch.core.comm import wire
from repro_torch.core.quantizers import Quantizer
from repro_torch.kernels import bitpack, dequant_avg, ops, quant_rr
from torch_test_env import port_test_env  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

SCHEMES = [n for n in all_methods() if n != "fp"]
#: the reference's fused-parity schemes (tests/test_fused_kernels.py:30-43)
PARITY = {
    "orq-9": dict(method="orq", num_levels=9),
    "orq-17": dict(method="orq", num_levels=17),
    "orq-5-clip": dict(method="orq", num_levels=5, clip_c=2.5),
    "terngrad-clip": dict(method="terngrad", clip_c=2.5),
    "qsgd-9": dict(method="qsgd", num_levels=9),
    "linear-5": dict(method="linear", num_levels=5),
    "minmax2": dict(method="minmax2"),
    "bingrad-pb": dict(method="bingrad_pb"),
    "bingrad-b": dict(method="bingrad_b"),
    "bingrad-b-lloyd-clip": dict(method="bingrad_b", clip_c=2.5,
                                 lloyd_iters=2),
    "signsgd": dict(method="signsgd"),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    """Bit patterns of a float32 or uint32/int32 array, for bit-equality."""
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)))


def _q64(nb, d, valid=None, seed=0):
    """Multiples of 1/64 in [-1, 1] and a mask whose first ``valid`` slots
    are set (ragged tail)."""
    rng = np.random.default_rng(seed)
    v = (rng.integers(-64, 65, (nb, d)) / 64).astype(np.float32)
    n = nb * d if valid is None else valid
    mask = np.arange(nb * d).reshape(nb, d) < n
    return np.where(mask, v, 0).astype(np.float32), mask


def _laplace(nb, d, valid=None, seed=1):
    rng = np.random.default_rng(seed)
    v = (rng.laplace(size=(nb, d)) * 0.1).astype(np.float32)
    n = nb * d if valid is None else valid
    return v, np.arange(nb * d).reshape(nb, d) < n


def _rr_inputs(nb, d, s, seed):
    """Values (some outside the level range), ascending levels (a row of
    equal levels, a row with a repeated level, a level of -0.0) and
    uint32 rounding words (some 0: always round up)."""
    rng = np.random.default_rng(seed)
    v = (rng.laplace(size=(nb, d)) * 0.2).astype(np.float32)
    v[0, :4] = [-10.0, 10.0, 0.0, -0.0]
    lv = np.sort(rng.uniform(-0.5, 0.5, (nb, s)), axis=-1).astype(np.float32)
    lv[1] = 0.0
    if s >= 3:
        lv[2, 1] = lv[2, 0]
    lv[3, 0] = -0.0
    lv[3] = np.sort(lv[3])
    bits = rng.integers(0, 2 ** 32, (nb, d), dtype=np.uint64).astype(np.uint32)
    bits[4, ::3] = 0
    return v, lv, bits


# ---------------------------------------------------------------------------
# the plain kernels against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [2, 3, 5, 9, 17])
def test_quant_rr_plain_matches_pallas(s):
    v, lv, bits = _rr_inputs(6, 37, s, s)
    want = jquant_rr.quant_rr(jnp.asarray(v), jnp.asarray(lv),
                              jnp.asarray(bits), s=s, interpret=True)
    got = quant_rr.quant_rr_plain(_t(v), _t(lv), _t(bits.view(np.int32)))
    assert got.dtype == torch.int32
    _same(got, want)
    assert int(got.min()) >= 0 and int(got.max()) <= s - 1
    # the oracle of the fused encode's round stage agrees
    _same(jref.quant_rr_ref(jnp.asarray(v), jnp.asarray(lv),
                            jnp.asarray(bits)), want)


@pytest.mark.parametrize("d", [37, 129])
@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 5])
def test_pack_unpack_plain_match_pallas(nbits, d):
    rng = np.random.default_rng(nbits * 1000 + d)
    idx = rng.integers(0, 2 ** nbits, (3, d)).astype(np.int32)
    want_w = jbitpack.pack(jnp.asarray(idx), bits=nbits, interpret=True)
    got_w = bitpack.pack_plain(_t(idx), nbits)
    assert got_w.dtype == torch.int32
    _same(got_w, want_w)
    if nbits in (3, 5):     # 10 / 6 lanes: the top 2 bits stay 0
        assert not (_bits(got_w.numpy()) >> (nbits * (32 // nbits))).any()
    want_i = jbitpack.unpack(want_w, bits=nbits, d=d, interpret=True)
    got_i = bitpack.unpack_plain(_t(np.asarray(want_w).view(np.int32)),
                                 nbits, d)
    assert got_i.dtype == torch.int32
    _same(got_i, want_i)
    _same(got_i, idx)


@pytest.mark.parametrize("L", [1, 3, 4])
def test_dequant_avg_plain_matches_pallas(L):
    """Bit-equal to the Pallas kernel's ``out += val * (1/L)`` order at
    every L, with an index >= s and a negative one decoding to 0 and a
    level of -0.0 (the kernel's one-hot sum gives +0.0). The reference's
    own oracle sums first: at L = 3 it differs from its kernel (at L = 1
    and 4 it equals it by value; it keeps the -0.0)."""
    nb, d, s = 5, 129, 9
    rng = np.random.default_rng(L)
    idx = rng.integers(0, 16, (L, nb, d)).astype(np.int32)
    idx[0, 0, :3] = [-1, 15, 9]
    lv = np.sort(rng.standard_normal((L, nb, s)), axis=-1).astype(np.float32)
    lv[:, 1, 0] = -0.0
    idx[:, 1, :] = 0
    want = jdequant_avg.dequant_avg(jnp.asarray(idx), jnp.asarray(lv), s=s,
                                    interpret=True)
    got = dequant_avg.dequant_avg_plain(_t(idx), _t(lv))
    _same(got, want)
    assert (_bits(got.numpy())[1] == 0).all()           # +0.0, not -0.0
    oracle = np.asarray(jref.dequant_avg_ref(
        jnp.asarray(np.clip(idx, 0, s - 1)), jnp.asarray(lv)))
    sel = (idx >= 0).all(0) & (idx < s).all(0)
    if L == 3:
        assert (oracle[sel] != np.asarray(want)[sel]).any()
    else:
        np.testing.assert_array_equal(oracle[sel], np.asarray(want)[sel])


def test_ops_dispatch_cpu_and_check_shapes():
    """CPU tensors take the plain versions; each version checks shapes."""
    v, lv, bits = _rr_inputs(6, 37, 5, 0)
    b32 = _t(bits.view(np.int32))
    _same(ops.quant_rr(_t(v), _t(lv), b32),
          quant_rr.quant_rr_plain(_t(v), _t(lv), b32))
    idx = ops.quant_rr(_t(v), _t(lv), b32)
    w = ops.pack(idx, 3)
    _same(ops.unpack(w, 3, 37), idx)
    _same(ops.dequant_avg(idx[None], _t(lv)[None]),
          dequant_avg.dequant_avg_plain(idx[None], _t(lv)[None]))
    with pytest.raises(ValueError, match="levels"):
        quant_rr.quant_rr_plain(_t(v), _t(lv[:, :1]), b32)
    with pytest.raises(ValueError, match="levels"):
        quant_rr.quant_rr_plain(_t(v), _t(np.zeros((6, 18), np.float32)),
                                b32)
    with pytest.raises(ValueError, match="bits must"):
        quant_rr.quant_rr_plain(_t(v), _t(lv), b32[:, :3])
    with pytest.raises(ValueError, match="bits must lie"):
        bitpack.pack_plain(idx, 6)
    with pytest.raises(ValueError, match="do not hold"):
        bitpack.unpack_plain(w, 3, 100)
    with pytest.raises(ValueError, match="expected"):
        dequant_avg.dequant_avg_plain(idx, _t(lv))


def test_cuda_wrappers_reject_cpu_tensors():
    v, lv, bits = _rr_inputs(6, 37, 5, 0)
    idx = torch.zeros((6, 37), dtype=torch.int32)
    for call in (lambda: quant_rr.quant_rr_cuda(_t(v), _t(lv),
                                                _t(bits.view(np.int32))),
                 lambda: bitpack.pack_cuda(idx, 3),
                 lambda: bitpack.unpack_cuda(bitpack.pack_plain(idx, 3), 3,
                                             37),
                 lambda: dequant_avg.dequant_avg_cuda(idx[None],
                                                      _t(lv)[None])):
        with pytest.raises(ValueError, match="not on a CUDA device"):
            call()


# ---------------------------------------------------------------------------
# rounding rules and the Quantizer stages against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [2, 5, 17])
def test_rounding_matches_reference(s):
    v, lv, bits = _rr_inputs(6, 64, s, 10 + s)
    jv, jlv = jnp.asarray(v), jnp.asarray(lv)
    tv, tlv = _t(v), _t(lv)
    k = R.find_interval(tv, tlv)
    _same(k, jR.find_interval(jv, jlv))
    jk = jR.find_interval(jv, jlv)
    for got, want in zip(R.select_levels(tlv, k), jR.select_levels(jlv, jk)):
        _same(got, want)
    _same(R.random_round(tv, tlv, _t(bits.view(np.int32))),
          jR.random_round(jv, jlv, jnp.asarray(bits)))
    _same(R.nearest_round(tv, tlv), jR.nearest_round(jv, jlv))
    b0 = lv[:, 1:2]
    _same(R.threshold_round(tv, _t(b0)), jR.threshold_round(jv,
                                                             jnp.asarray(b0)))
    # a gather: -1 counts from the end, an index >= s gives NaN
    idx = np.random.default_rng(s).integers(-1, s + 2, (6, 64)).astype(
        np.int32)
    _same(R.dequantize(_t(idx), tlv), jR.dequantize(jnp.asarray(idx), jlv))
    # the stream: the same words from the same key
    _same(R.random_bits(prng.key(s), (6, 64)),
          np.asarray(jR.random_bits(jax.random.key(s), (6, 64))).view(
              np.int32))


@pytest.mark.parametrize("name", SCHEMES)
def test_quantizer_stages_match_reference(name):
    """``assign`` (given the reference's levels and the same key, σ-clip
    schemes on their real mask) and ``decode`` on Laplace values;
    ``quantize``, ``dequantize``, ``qdq``, ``encode_wire`` and
    ``decode_wire`` on a multiple-of-1/64 buffer with a ragged tail, where
    the fits are exact; ``wire_bytes``."""
    d = 64
    qz, jqz = (make_quantizer(name, bucket_size=d),
               jmake_quantizer(name, bucket_size=d))
    v, mask = _laplace(5, d, 5 * d - 23)
    jlv = jqz.fit(jnp.asarray(v), jnp.asarray(mask))
    tlv = _t(jlv)
    idx = qz.assign(_t(v), tlv, prng.key(3), mask=_t(mask))
    jidx = jqz.assign(jnp.asarray(v), jlv, jax.random.key(3),
                      mask=jnp.asarray(mask))
    assert idx.dtype == torch.int32
    _same(idx, jidx)
    _same(Quantizer.decode(idx, tlv), JQuantizer.decode(jidx, jlv))

    flat, _ = _q64(1, 5 * d - 23, seed=len(name))
    flat = flat.reshape(-1)
    q = qz.quantize(_t(flat), prng.key(4))
    jq = jqz.quantize(jnp.asarray(flat), jax.random.key(4))
    _same(q.idx, jq.idx)
    _same(q.levels, jq.levels)
    assert q.n == jq.n
    _same(qz.dequantize(q), jqz.dequantize(jq))
    grid = flat.reshape(-1, 11)
    _same(qz.qdq(_t(grid), prng.key(4)), jqz.qdq(jnp.asarray(grid),
                                                 jax.random.key(4)))
    w = qz.encode_wire(q)
    _same(w, jqz.encode_wire(jq))
    back = qz.decode_wire(w, q.levels, q.n)
    jback = jqz.decode_wire(jqz.encode_wire(jq), jq.levels, jq.n)
    _same(back.idx, jback.idx)
    assert back.n == jback.n
    for n in (1, d, 135_285_504):
        assert qz.wire_bytes(n) == jqz.wire_bytes(n)


def test_fp_quantizer_is_identity():
    qz, jqz = make_quantizer("fp"), jmake_quantizer("fp")
    flat = np.arange(10, dtype=np.float32)
    _same(qz.qdq(_t(flat), None), jqz.qdq(jnp.asarray(flat), None))
    assert qz.wire_bytes(4097) == jqz.wire_bytes(4097)


# ---------------------------------------------------------------------------
# the multi-pass wire path against the reference's
# ---------------------------------------------------------------------------

def _units(enc, qz, bkt, mask, L):
    """L stacked wire units, unit l encoded with key l."""
    units = [enc(qz, bkt, mask, l) for l in range(L)]
    return [np.stack([np.asarray(u[i]) for u in units]) for i in (0, 1)]


@pytest.mark.parametrize("name", SCHEMES)
def test_multipass_wire_matches_reference(name):
    """Encode and both decodes bit-equal to the reference's, at L = 1 and
    L = 3, on a multiple-of-1/64 buffer with a ragged tail."""
    nb, d = 5, 37
    qz, jqz = (make_quantizer(name, bucket_size=d),
               jmake_quantizer(name, bucket_size=d))
    v, mask = _q64(nb, d, 172, seed=7)

    def port(qz_, b, m, l):
        w, lv = wire.encode_multipass(qz_, _t(b), _t(m), prng.key(l))
        return w.numpy(), lv.numpy()

    def ref(qz_, b, m, l):
        return jwire.encode_multipass(qz_, jnp.asarray(b), jnp.asarray(m),
                                      jax.random.key(l))

    for L in (1, 3):
        tw, tl = _units(port, qz, v, mask, L)
        jw, jl = _units(ref, jqz, v, mask, L)
        _same(tw, jw)
        _same(tl, jl)
        jw, jl = jnp.asarray(jw), jnp.asarray(jl)
        tw, tl = _t(tw), _t(tl)
        _same(wire.decode_mean_multipass(qz, tw, tl, d),
              jwire.decode_mean_multipass(jqz, jw, jl, d))
        _same(wire.decode_each_multipass(qz, tw, tl, d),
              jwire.decode_each_multipass(jqz, jw, jl, d))


@pytest.mark.parametrize("name", ["orq-9", "terngrad", "qsgd-5",
                                  "bingrad-b", "signsgd"])
def test_multipass_stages_with_injected_levels(name):
    """Laplace values, where the fits are float-close: with the
    reference's levels injected, ``wire.assign`` + masked select + pack is
    bit-equal to the reference's encode, and the decodes of its words are
    bit-equal at L = 3."""
    nb, d = 6, 129
    qz, jqz = (make_quantizer(name, bucket_size=d),
               jmake_quantizer(name, bucket_size=d))
    v, mask = _laplace(nb, d, nb * d - 50)
    jw, jl = [], []
    for l in range(3):
        w, lv = jwire.encode_multipass(jqz, jnp.asarray(v), jnp.asarray(mask),
                                       jax.random.key(l))
        idx = torch.where(_t(mask), wire.assign(qz, _t(v), _t(lv),
                                                prng.key(l), mask=_t(mask)),
                          0)
        _same(ops.pack(idx, qz.wire_bits_per_element), w)
        jw.append(np.asarray(w))
        jl.append(np.asarray(lv))
    jw, jl = np.stack(jw), np.stack(jl)
    _same(wire.decode_mean_multipass(qz, _t(jw.view(np.int32)), _t(jl), d),
          jwire.decode_mean_multipass(jqz, jnp.asarray(jw), jnp.asarray(jl),
                                      d))
    _same(wire.decode_each_multipass(qz, _t(jw.view(np.int32)), _t(jl), d),
          jwire.decode_each_multipass(jqz, jnp.asarray(jw), jnp.asarray(jl),
                                      d))


# ---------------------------------------------------------------------------
# the port's multi-pass path against its own fused path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PARITY))
@pytest.mark.parametrize("nb,d,valid", [(5, 37, 172), (8, 64, 8 * 64),
                                        (1, 129, 100)])
def test_multipass_encode_equals_fused(name, nb, d, valid):
    qz = Quantizer(bucket_size=d, **PARITY[name])
    v, mask = _laplace(nb, d, valid)
    w_f, lv_f = wire.encode(qz, _t(v), _t(mask), prng.key(11))
    w_m, lv_m = wire.encode_multipass(qz, _t(v), _t(mask), prng.key(11))
    _same(w_m, w_f)
    _same(lv_m, lv_f)


@pytest.mark.parametrize("name", ["orq-9", "terngrad-clip", "bingrad-b",
                                  "orq-17"])
@pytest.mark.parametrize("L", [1, 3, 4])
def test_multipass_decodes_equal_fused(name, L):
    """The mean decode bit-equal, the per-worker decode equal by value
    (the gather keeps a level's -0.0, the fused lookup may not)."""
    nb, d = 5, 37
    qz = Quantizer(bucket_size=d, **PARITY[name])
    v, mask = _laplace(nb, d, 172)
    units = [wire.encode(qz, _t(v), _t(mask), prng.key(l)) for l in range(L)]
    ws = torch.stack([u[0] for u in units])
    lvs = torch.stack([u[1] for u in units])
    _same(wire.decode_mean_multipass(qz, ws, lvs, d),
          wire.decode_mean(qz, ws, lvs, d))
    torch.testing.assert_close(wire.decode_each_multipass(qz, ws, lvs, d),
                               wire.decode_each(qz, ws, lvs, d), rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# encode / qdq fall back to the multi-pass path without a fused mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["orq-9", "terngrad", "bingrad-b",
                                  "signsgd"])
def test_encode_and_qdq_fallback_match_reference(name, monkeypatch):
    """With ``_fused_mode`` giving '' in both packages, ``encode`` is the
    multi-pass encode and ``qdq`` the decode of its indices, bit-equal
    to the reference's (multiple-of-1/64 buffer, ragged tail)."""
    monkeypatch.setattr(wire, "_fused_mode", lambda qz: "")
    monkeypatch.setattr(jwire, "_fused_mode", lambda qz: "")
    nb, d = 4, 64
    qz, jqz = (make_quantizer(name, bucket_size=d),
               jmake_quantizer(name, bucket_size=d))
    v, mask = _q64(nb, d, nb * d - 9, seed=3)
    w, lv = wire.encode(qz, _t(v), _t(mask), prng.key(2))
    jw, jl = jwire.encode(jqz, jnp.asarray(v), jnp.asarray(mask),
                          jax.random.key(2))
    _same(w, jw)
    _same(lv, jl)
    _same(wire.qdq(qz, _t(v), _t(mask), prng.key(2)),
          jwire.qdq(jqz, jnp.asarray(v), jnp.asarray(mask),
                    jax.random.key(2)))


def test_scheme_without_a_fit_raises_as_the_reference():
    v, mask = _q64(2, 16)
    for enc in (lambda: wire.encode(Quantizer(method="custom"), _t(v),
                                    _t(mask), prng.key(0)),
                lambda: jwire.encode(JQuantizer(method="custom"),
                                     jnp.asarray(v), jnp.asarray(mask),
                                     jax.random.key(0))):
        with pytest.raises(ValueError, match="unknown method"):
            enc()
