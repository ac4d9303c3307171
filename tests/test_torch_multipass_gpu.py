"""The multi-pass CUDA kernels (``csrc/multipass.cu``) against their plain
PyTorch versions, and the multi-pass wire path against the fused one on
the card.

Tests marked ``gpu`` need a CUDA device and skip without one; they import
no JAX, so they run on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_multipass_gpu.py

Tolerances, with their reasons: every kernel here is exact (integer
work, one IEEE divide per element, one fma per worker), so each is held
bit-equal to its plain version, floats as bit patterns. The multi-pass
encode equals the fused encode bit for bit given the same key, except
BinGrad-b's levels: the multi-pass fit is plain PyTorch row sums, the
fused one the kernel's, so they are held within ``LEVEL_RTOL`` of the
row's max |v| and the multi-pass words are held exactly to the fused
encode's threshold of the multi-pass levels. The per-worker decodes are
equal by value (the gather keeps a level's -0.0; the fused lookup may
give +0.0).
"""
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.api import make_quantizer
from repro_torch.core.comm import wire
from repro_torch.core.quantizers import Quantizer
from repro_torch.kernels import (bitpack, build, dequant_avg, fused_bingrad,
                                 fused_decode, fused_encode, quant_rr)

LEVEL_RTOL = 1e-5
MID_NB, MID_D = 4096, 2048          # a mid-size slice of the training shape

SCHEMES = {
    "orq-9": make_quantizer("orq-9"), "orq-17": make_quantizer("orq-17"),
    "terngrad": make_quantizer("terngrad"), "qsgd-5": make_quantizer("qsgd-5"),
    "linear-5": make_quantizer("linear-5"),
    "minmax2": make_quantizer("minmax2"),
    "bingrad-pb": make_quantizer("bingrad-pb"),
    "bingrad-b": make_quantizer("bingrad-b"),
    "signsgd": make_quantizer("signsgd"),
    "terngrad-clip": Quantizer(method="terngrad", clip_c=2.5),
    "bingrad-b-lloyd-clip": Quantizer(method="bingrad_b", clip_c=2.5,
                                      lloyd_iters=2),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _words(g, shape):
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=g,
                         dtype=torch.int64).to(torch.int32)


def _bitwise(t):
    return t.cpu().contiguous().view(torch.int32)


def _assert_bit_equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bitwise(got), _bitwise(want))


def _rr_inputs(nb, d, s, seed):
    """Values (some outside the level range), ascending levels (equal
    levels in one row, a repeated level in another) and rounding words."""
    g = _gen(seed)
    v = torch.randn((nb, d), generator=g) * 0.3
    v[0, :2] = torch.tensor([-10.0, 10.0])
    lv = torch.sort(torch.rand((nb, s), generator=g) - 0.5).values
    if nb > 2:
        lv[1] = 0.0
        lv[2, 1] = lv[2, 0]
    return v, lv, _words(g, (nb, d))


def _mid_buffer(dev, seed=0):
    g = _gen(seed)
    mask = (torch.arange(MID_NB * MID_D) < MID_NB * MID_D - 777).reshape(
        MID_NB, MID_D)
    v = torch.where(mask, torch.randn((MID_NB, MID_D), generator=g) * 1e-3,
                    0.0)
    return v.to(dev), mask.to(dev)


def _zero():
    for fn in _counters().values():
        fn.launches = 0


def _counters():
    return {"quant_rr": quant_rr.quant_rr_cuda, "pack": bitpack.pack_cuda,
            "unpack": bitpack.unpack_cuda,
            "dequant_avg": dequant_avg.dequant_avg_cuda,
            "encode_fused": fused_encode.encode_fused_cuda,
            "qdq_fused": fused_encode.qdq_fused_cuda,
            "decode_fused_mean": fused_decode.decode_fused_mean_cuda,
            "decode_fused_each": fused_decode.decode_fused_each_cuda,
            "encode_bingrad_fused": fused_bingrad.encode_bingrad_fused_cuda}


def _read():
    return {k: fn.launches for k, fn in _counters().items() if fn.launches}


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("s", [2, 3, 5, 9, 17])
@pytest.mark.parametrize("nb,d", [(5, 37), (1, 129), (MID_NB, MID_D)])
def test_quant_rr_cuda_bit_equal(cuda, nb, d, s):
    v, lv, bits = _rr_inputs(nb, d, s, 10 * s + nb)
    want = quant_rr.quant_rr_plain(v, lv, bits)
    got = quant_rr.quant_rr_cuda(v.to(cuda), lv.to(cuda), bits.to(cuda))
    torch.cuda.synchronize()
    _assert_bit_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("nb,d", [(5, 37), (1, 129), (MID_NB, MID_D)])
def test_pack_unpack_cuda_bit_equal(cuda, nb, d, nbits):
    g = _gen(nbits * 7 + d)
    idx = torch.randint(0, 2 ** nbits, (nb, d), generator=g,
                        dtype=torch.int32)
    words = bitpack.pack_cuda(idx.to(cuda), nbits)
    _assert_bit_equal(words, bitpack.pack_plain(idx, nbits))
    back = bitpack.unpack_cuda(words, nbits, d)
    _assert_bit_equal(back, idx)
    raw = _words(g, words.shape)                 # every bit pattern
    _assert_bit_equal(bitpack.unpack_cuda(raw.to(cuda), nbits, d),
                      bitpack.unpack_plain(raw, nbits, d))
    # indices beyond 2^bits and negative ones wrap as the uint32 sum does
    wild = torch.randint(-2 ** 31, 2 ** 31, (nb, d), generator=g,
                         dtype=torch.int64).to(torch.int32)
    _assert_bit_equal(bitpack.pack_cuda(wild.to(cuda), nbits),
                      bitpack.pack_plain(wild, nbits))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 3, 4])
@pytest.mark.parametrize("nb,d,s", [(5, 37, 9), (1, 129, 17),
                                    (MID_NB, MID_D, 9)])
def test_dequant_avg_cuda_bit_equal(cuda, L, nb, d, s):
    g = _gen(L * 100 + s)
    idx = torch.randint(-1, 2 ** (s - 1).bit_length(), (L, nb, d),
                        generator=g, dtype=torch.int32)
    lv = torch.sort(torch.randn((L, nb, s), generator=g)).values
    lv[:, 0, 0] = -0.0
    idx[:, 0, :5] = 0            # a level of -0.0 decodes to +0.0
    got = dequant_avg.dequant_avg_cuda(idx.to(cuda), lv.to(cuda))
    torch.cuda.synchronize()
    _assert_bit_equal(got, dequant_avg.dequant_avg_plain(idx, lv))
    assert (_bitwise(got)[0, :5] == 0).all()


@pytest.mark.gpu
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    v, lv, bits = _rr_inputs(4, 64, 5, 0)
    with pytest.raises(TypeError, match="float32"):
        quant_rr.quant_rr_cuda(v.double().to(cuda), lv.to(cuda),
                               bits.to(cuda))
    with pytest.raises(TypeError, match="int32"):
        bitpack.pack_cuda(torch.zeros((4, 64), dtype=torch.int64,
                                      device=cuda), 3)
    with pytest.raises(ValueError, match="contiguous"):
        bitpack.unpack_cuda(torch.zeros((4, 40), dtype=torch.int32,
                                        device=cuda)[:, ::2], 3, 200)
    with pytest.raises(TypeError, match="int32"):
        dequant_avg.dequant_avg_cuda(
            torch.zeros((1, 4, 64), dtype=torch.int64, device=cuda),
            lv[None].to(cuda))


# ---------------------------------------------------------------------------
# the multi-pass path against the fused path, on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_multipass_encode_equals_fused_on_card(cuda, name):
    qz = SCHEMES[name]
    v, mask = _mid_buffer(cuda)
    key = prng.key(3, device=cuda)
    _zero()
    w_m, lv_m = wire.encode_multipass(qz, v, mask, key)
    torch.cuda.synchronize()
    rr = wire._fused_mode(qz) == "rr"
    assert _read() == ({"quant_rr": 1, "pack": 1} if rr else {"pack": 1})
    w_f, lv_f = wire.encode(qz, v, mask, key)
    if qz.method == "bingrad_b":
        vmax = float(v.abs().max())
        assert float((lv_m - lv_f).abs().max()) <= LEVEL_RTOL * vmax
        lim = fused_encode.clip_limit(v, mask, qz.clip_c)
        _assert_bit_equal(w_m, fused_encode.encode_fused_cuda(
            v, lv_m, None, mask, lim, bits=1, mode="bin"))
    else:
        _assert_bit_equal(lv_m, lv_f)
        _assert_bit_equal(w_m, w_f)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["orq-9", "terngrad-clip", "bingrad-b",
                                  "signsgd"])
@pytest.mark.parametrize("L", [1, 4])
def test_multipass_decodes_equal_fused_on_card(cuda, name, L):
    qz = SCHEMES[name]
    v, mask = _mid_buffer(cuda)
    units = [wire.encode(qz, v, mask, prng.key(k, device=cuda))
             for k in range(L)]
    ws = torch.stack([u[0] for u in units])
    lvs = torch.stack([u[1] for u in units])
    _zero()
    mean = wire.decode_mean_multipass(qz, ws, lvs, MID_D)
    torch.cuda.synchronize()
    assert _read() == {"unpack": 1, "dequant_avg": 1}
    _assert_bit_equal(mean, wire.decode_mean(qz, ws, lvs, MID_D))
    _zero()
    each = wire.decode_each_multipass(qz, ws, lvs, MID_D)
    torch.cuda.synchronize()
    assert _read() == {"unpack": 1}
    assert torch.equal(each, wire.decode_each(qz, ws, lvs, MID_D))


@pytest.mark.gpu
def test_fallback_encode_and_qdq_run_the_multipass_kernels(cuda,
                                                           monkeypatch):
    """Without a fused mode, ``encode`` launches quant_rr + pack and
    ``qdq`` quant_rr alone, and both equal the fused path's result."""
    qz = SCHEMES["orq-9"]
    v, mask = _mid_buffer(cuda)
    key = prng.key(5, device=cuda)
    want_w, want_l = wire.encode(qz, v, mask, key)
    want_q = wire.qdq(qz, v, mask, key)
    monkeypatch.setattr(wire, "_fused_mode", lambda q: "")
    _zero()
    w, lv = wire.encode(qz, v, mask, key)
    q = wire.qdq(qz, v, mask, key)
    torch.cuda.synchronize()
    assert _read() == {"quant_rr": 2, "pack": 1}
    _assert_bit_equal(w, want_w)
    _assert_bit_equal(lv, want_l)
    assert torch.equal(q, want_q)


# ---------------------------------------------------------------------------
# CPU: the build names a library by its source, headers and flags
# ---------------------------------------------------------------------------

def test_library_path_follows_the_shared_header(tmp_path, monkeypatch):
    """An edit to a ``csrc/*.cuh`` header gives every library a new name,
    so a stale build is never loaded."""
    for f in list(build.CSRC.glob("*.cu")) + list(build.CSRC.glob("*.cuh")):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build.library_path(n) for n in build.SOURCES}
    assert "multipass" in before and len(set(before.values())) == len(before)
    (tmp_path / "round.cuh").write_text(
        (tmp_path / "round.cuh").read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in build.SOURCES}
    assert all(after[n] != before[n] for n in build.SOURCES)
    assert all(p.parent == build.BUILD_DIR for p in after.values())
