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


@pytest.mark.gpu
@pytest.mark.parametrize("mode,s,d,masked,clip", [
    ("rr", 9, 2048, True, False), ("rr", 9, 768, False, True),
    ("rr", 5, 100, True, True), ("rr", 17, 300, False, False),
    ("bin", 2, 768, True, False), ("sign", 2, 100, False, True),
])
def test_qdq_fused_cuda_bit_equal(cuda, mode, s, d, masked, clip):
    g = _gen(d + s)
    nb = 29
    v = torch.randn((nb, d), generator=g) * 0.3
    lv = torch.sort(torch.randn((nb, s), generator=g) * 0.3).values
    rb = (torch.randint(-2 ** 31, 2 ** 31, (nb, d), generator=g,
                        dtype=torch.int64).to(torch.int32)
          if mode == "rr" else None)
    mask = torch.rand((nb, d), generator=g) > 0.1 if masked else None
    lim = fused_encode.clip_limit(v, mask, 2.5) if clip else None
    want = fused_encode.qdq_fused_plain(v, lv, rb, mask, lim, mode=mode)
    dev = [None if t is None else t.to(cuda) for t in (v, lv, rb, mask, lim)]
    got = fused_encode.qdq_fused_cuda(*dev, mode=mode)
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
