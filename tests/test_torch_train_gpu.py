"""The training slice's CUDA kernels against their plain PyTorch versions,
and one full-width training step on the card.

Tests marked ``gpu`` need a CUDA device and skip without one; they import
no JAX, so they run on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_gpu.py

Tolerance: none. ``decode_fused_mean`` / ``decode_fused_each`` and
``qdq_fused`` are held bit-equal by value (``torch.equal`` holds -0.0 ==
0.0): the kernels repeat the plain versions' float32 operations (the
mean's one fused multiply-add per worker included), compiled without
other FMA contraction or fast math.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import encode, prng
from repro_torch.kernels import fused_decode, fused_encode


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _stack(L, nb, d, bits, s, seed):
    g = _gen(seed)
    nw = encode.packed_words(d, bits)
    words = torch.randint(-2 ** 31, 2 ** 31, (L, nb, nw), generator=g,
                          dtype=torch.int64).to(torch.int32)
    levels = torch.sort(torch.randn((L, nb, s), generator=g) * 0.3).values
    return words, levels


DECODE_CASES = ([(L, 4, 9, 2048) for L in (1, 3, 4)]
                + [(3, 4, 9, 2047)]
                + [(2, bits, s, 100) for bits, s in ((1, 2), (2, 3), (3, 5),
                                                     (5, 17))])


#: the mean's quads, ragged rows and 16-byte alignment: bits 1-5 at d
#: 2048, 2047, 300 and 37, L 1, 3 and 4 (33 rows, not a multiple of the 8
#: rows a block takes); then L at which a block takes one row
#: (fused_decode.mean_rows: 400 workers of 17 levels) and at which that
#: row's tables need more than 48 KB of shared memory (800)
MEAN_CASES = ([(L, bits, s, d) for L in (1, 3, 4)
               for bits, s in ((1, 2), (2, 3), (3, 5), (4, 9), (5, 17))
               for d in (2048, 2047, 300, 37)]
              + [(400, 5, 17, 37), (800, 5, 17, 37)])


@pytest.mark.gpu
@pytest.mark.parametrize("L,bits,s,d", sorted(set(DECODE_CASES + MEAN_CASES)))
def test_decode_fused_mean_cuda_bit_equal(cuda, L, bits, s, d):
    words, levels = _stack(L, 33, d, bits, s, seed=L * 10 + bits)
    want = fused_decode.decode_fused_mean_plain(words, levels, d=d,
                                                bits=bits)
    got = fused_decode.decode_fused_mean_cuda(words.to(cuda),
                                              levels.to(cuda), d=d,
                                              bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


#: the per-worker decode's quads, ragged rows and 16-byte alignment: bits
#: 1-5 at d 2048, 2047, 300 and 37 (rows of d 2047 and 37 start unaligned),
#: L 1 and 4; 33 rows, not a multiple of the 8 rows a block takes
EACH_CASES = [(L, bits, s, d) for L in (1, 4)
              for bits, s in ((1, 2), (2, 3), (3, 5), (4, 9), (5, 17))
              for d in (2048, 2047, 300, 37)]


@pytest.mark.gpu
@pytest.mark.parametrize("L,bits,s,d", sorted(set(DECODE_CASES + EACH_CASES)))
def test_decode_fused_each_cuda_bit_equal(cuda, L, bits, s, d):
    words, levels = _stack(L, 33, d, bits, s, seed=L * 10 + bits + 1)
    want = fused_decode.decode_fused_each_plain(words, levels, d=d,
                                                bits=bits)
    got = fused_decode.decode_fused_each_cuda(words.to(cuda),
                                              levels.to(cuda), d=d,
                                              bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("nb,d", [(1, 37), (7, 2048), (8, 2047), (1001, 300),
                                  (3000, 2048)])
def test_decode_fused_each_cuda_row_counts(cuda, nb, d):
    """Blocks of 8 rows: a run shorter than a block, exactly one, and many
    with a partial last block."""
    words, levels = _stack(3, nb, d, 4, 9, seed=nb)
    want = fused_decode.decode_fused_each_plain(words, levels, d=d, bits=4)
    got = fused_decode.decode_fused_each_cuda(words.to(cuda),
                                              levels.to(cuda), d=d, bits=4)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


NAN, INF = float("nan"), float("inf")


def _edge_ties(v, lv):
    """Equal levels: a whole table, an inner run, the top and the bottom
    pair; values exactly on the levels."""
    s = lv.shape[1]
    for r in range(min(4, lv.shape[0])):
        t = lv[r].clone()
        if r == 0:
            t[:] = t[0].item()
        elif r == 1:
            t[1:s - 1] = t[1].item()
        elif r == 2:
            t[-1] = t[-2]
        else:
            t[1] = t[0]
        lv[r] = t
        k = min(s, v.shape[1])
        v[r, :k] = lv[r, :k]


def _edge_nonfinite(v, lv):
    """NaN, +inf, -inf and -0.0 values: row 0 a few of each, row 1 every
    value +inf, row 2 every third -inf, row 3 one NaN (its clip limit
    is NaN)."""
    k = min(6, v.shape[1])
    v[0, :k] = torch.tensor([NAN, INF, -INF, -0.0, 0.0, NAN])[:k]
    for r, fill in ((1, lambda t: t.fill_(INF)),
                    (2, lambda t: t[::3].fill_(-INF)),
                    (3, lambda t: t[v.shape[1] // 2:][:1].fill_(NAN))):
        if r < v.shape[0]:
            fill(v[r])


def _edge_nantable(v, lv):
    """Tables the search does not take: a NaN inside, all NaN, a NaN on
    top, at the bottom, and a descending table."""
    rows = [(0, 1), (1, None), (2, -1), (3, 0)]
    for r, j in rows[:lv.shape[0]]:
        if j is None:
            lv[r] = NAN
        else:
            lv[r, j] = NAN
    if lv.shape[0] > 4:
        lv[4] = lv[4].flip(0)


def _edge_inftable(v, lv):
    """Infinite levels in ascending tables, and infinite values."""
    edits = [(0, 0, -INF), (1, -1, INF), (2, slice(None), INF),
             (3, 0, -INF), (3, -1, INF)]
    for r, j, x in edits:
        if r < lv.shape[0]:
            lv[r, j] = x
    k = min(3, v.shape[1])
    v[:4, :k] = torch.tensor([INF, -INF, 0.0])[:k]


def _edge_negzero(v, lv):
    """-0.0 levels (decoded as they are) and signed zero values."""
    edits = [(0, 0), (1, 1), (2, slice(None))]
    for r, j in edits:
        if r < lv.shape[0]:
            lv[r, j] = -0.0
    k = min(4, v.shape[1])
    v[:3, :k] = torch.tensor([-0.0, 0.0, -0.0, 0.0])[:k]


EDGES = {"none": None, "ties": _edge_ties, "nonfinite": _edge_nonfinite,
         "nantable": _edge_nantable, "inftable": _edge_inftable,
         "negzero": _edge_negzero}


def _round_stage_inputs(mode, s, d, masked, clip, edge, nb, seed):
    """(v, levels, rbits, mask, limit) on the CPU: sorted random tables,
    then the named edge written in; the limit is the clip's (NaN in a row
    with a NaN value)."""
    g = _gen(seed)
    v = torch.randn((nb, d), generator=g) * 0.3
    lv = torch.sort(torch.randn((nb, s), generator=g) * 0.3).values
    rb = (torch.randint(-2 ** 31, 2 ** 31, (nb, d), generator=g,
                        dtype=torch.int64).to(torch.int32)
          if mode == "rr" else None)
    mask = torch.rand((nb, d), generator=g) > 0.1 if masked else None
    if EDGES[edge] is not None:
        EDGES[edge](v, lv)
    lim = fused_encode.clip_limit(v, mask, 2.5) if clip else None
    return v, lv, rb, mask, lim


#: modes, every compiled level count (2, 3, 5, 9, 17) and two the general
#: path takes (4, 7); d 2048 (16-byte accesses), 300 and 97 (single
#: ones); mask and clip on and off; every edge; one row
QDQ_CASES = list(dict.fromkeys(
    [("rr", 9, 2048, True, False, "none", 29),
     ("rr", 9, 768, False, True, "none", 29),
     ("rr", 5, 100, True, True, "none", 29),
     ("rr", 17, 300, False, False, "none", 29),
     ("bin", 2, 768, True, False, "none", 29),
     ("sign", 2, 100, False, True, "none", 29)]
    + [("rr", s, 2048, masked, clip, "none", 29)
       for s in (2, 3, 4, 5, 7, 9, 17)
       for masked, clip in ((True, False), (False, True))]
    + [("rr", s, d, True, clip, edge, 29)
       for s in (3, 4, 7, 9, 17) for d in (2048, 300, 97)
       for edge in EDGES if edge != "none" for clip in (False, True)]
    + [(mode, 2, d, masked, clip, edge, 29)
       for mode in ("bin", "sign") for d in (2048, 97)
       for edge in ("nonfinite", "negzero", "inftable")
       for masked, clip in ((True, False), (False, True))]
    + [("rr", 9, 2048, True, False, "none", 1),
       ("rr", 17, 97, False, True, "nonfinite", 1),
       ("rr", 7, 300, True, True, "ties", 1),
       ("bin", 2, 2048, False, True, "nonfinite", 1)]))


@pytest.mark.gpu
@pytest.mark.parametrize("mode,s,d,masked,clip,edge,nb", QDQ_CASES)
def test_qdq_fused_cuda_bit_equal(cuda, mode, s, d, masked, clip, edge, nb):
    """Bit patterns equal to the plain version's (a NaN the table holds
    comes out as the same NaN; -0.0 levels keep their sign)."""
    cpu = _round_stage_inputs(mode, s, d, masked, clip, edge, nb,
                              QDQ_CASES.index((mode, s, d, masked, clip,
                                               edge, nb)))
    want = fused_encode.qdq_fused_plain(*cpu, mode=mode)
    dev = [None if t is None else t.to(cuda) for t in cpu]
    got = fused_encode.qdq_fused_cuda(*dev, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("bits,s", [(1, 2), (2, 3), (3, 5), (4, 9), (4, 12),
                                    (5, 17)])
@pytest.mark.parametrize("edge", ["nonfinite", "inftable"])
def test_encode_fused_cuda_nonfinite_clip(cuda, bits, s, edge):
    """The encode clips as the reference does: a NaN value or limit stays
    NaN and rounds to index 0."""
    cpu = _round_stage_inputs("rr", s, 2048, True, True, edge, 29, bits * s)
    want = fused_encode.encode_fused_plain(*cpu, bits=bits)
    got = fused_encode.encode_fused_cuda(
        *[None if t is None else t.to(cuda) for t in cpu], bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_decode_cuda_wrappers_reject_cpu_tensors():
    words, levels = _stack(2, 3, 64, 4, 9, seed=0)
    for fn in (fused_decode.decode_fused_mean_cuda,
               fused_decode.decode_fused_each_cuda):
        with pytest.raises(ValueError, match="not on a CUDA device"):
            fn(words, levels, d=64, bits=4)


@pytest.mark.gpu
def test_full_width_step_goes_through_the_kernels(cuda, monkeypatch):
    """One lm-100m step (orq-9, EF) through the launcher on a world of one
    (NCCL): finite loss, the exact wire bytes, each kernel launched as
    Algorithm 2 says, and every threefry draw on the card although the
    launcher's key started as an int."""
    from repro_torch.launch import train as launcher

    seen = []
    real = prng.bits

    def spy(k, shape):
        seen.append(k.device.type)
        return real(k, shape)

    monkeypatch.setattr(prng, "bits", spy)
    counters = [fused_encode.encode_fused_cuda, fused_encode.qdq_fused_cuda,
                fused_decode.decode_fused_mean_cuda,
                fused_decode.decode_fused_each_cuda]
    before = [fn.launches for fn in counters]
    r = launcher.train(["--arch", "lm-100m", "--steps", "1", "--batch", "8",
                        "--seq", "128", "--quant", "orq-9",
                        "--error-feedback", "--log-every", "1"])
    launches = [fn.launches - b for fn, b in zip(counters, before)]
    assert launches == [2, 1, 1, 1]
    assert np.isfinite(r["history"][0]["loss"])
    assert r["wire_bytes_per_worker"] == 140_042_960
    assert r["n_params"] == 135_285_504
    assert seen and set(seen) == {"cuda"}
