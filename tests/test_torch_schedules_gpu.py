"""The CUDA kernels at the shapes only the per-leaf and pipelined exchange
schedules give them, against their plain PyTorch versions: one row of 768
(lm-100m's final_norm at L = 1), one row of 192 (its chunk at L = 4), 5
rows of 2048 with 1024 valid in the last (a (12, 768) norm leaf at
L = 1), 2 rows with 256 valid in the second (the same at L = 4), and a
pipeline span cut out of a larger buffer (rows of 2048, 768 valid in the
last).

Tests marked ``gpu`` need a CUDA device and skip without one; they import
no JAX, so they run on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_schedules_gpu.py

Tolerance: none for ``encode_fused``, ``qdq_fused`` and the decodes (bit-
equal by value, as in ``test_torch_train_gpu.py``). BinGrad-b's levels are
bit-equal to ``fused_bingrad.kernel_order_levels`` (its order of additions
in plain PyTorch), and its words are the exact threshold of its own levels
(as in ``test_torch_bingrad_gpu.py``).
"""
import pytest
import torch

from repro_torch.core import encode
from repro_torch.core import levels as lvmod
from repro_torch.kernels import fused_bingrad, fused_decode, fused_encode

#: name -> (rows, d, valid values in the last row)
SHAPES = {"row768": (1, 768, 768), "row192": (1, 192, 192),
          "rows5_last1024": (5, 2048, 1024), "rows2_last256": (2, 2048, 256),
          "span_last768": (301, 2048, 768)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _inputs(case, dev, seed=0, q64=False):
    nb, d, last = SHAPES[case]
    g = torch.Generator().manual_seed(seed)
    mask = (torch.arange(nb * d) < (nb - 1) * d + last).reshape(nb, d)
    v = (torch.randint(-64, 65, (nb, d), generator=g).float() / 64 if q64
         else torch.randn((nb, d), generator=g) * 1e-3)
    v = torch.where(mask, v, 0.0)
    rb = torch.randint(-2 ** 31, 2 ** 31, (nb, d), generator=g,
                       dtype=torch.int64).to(torch.int32)
    return v.to(dev), mask.to(dev), rb.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_encode_and_qdq_at_schedule_shapes(cuda, case):
    v, mask, rb = _inputs(case, cuda)
    lv = lvmod.orq_levels(v, mask, 3)
    args = (v, lv, rb, mask, None)
    assert torch.equal(fused_encode.encode_fused_cuda(*args, bits=4),
                       fused_encode.encode_fused_plain(*args, bits=4))
    assert torch.equal(fused_encode.qdq_fused_cuda(*args, mode="rr"),
                       fused_encode.qdq_fused_plain(*args, mode="rr"))


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 3, 4])
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_decodes_at_schedule_shapes(cuda, case, L):
    nb, d, _ = SHAPES[case]
    g = torch.Generator().manual_seed(L)
    words = torch.randint(-2 ** 31, 2 ** 31,
                          (L, nb, encode.packed_words(d, 4)), generator=g,
                          dtype=torch.int64).to(torch.int32).to(cuda)
    levels = torch.sort(torch.randn((L, nb, 9), generator=g)).values.to(cuda)
    for cuda_fn, plain in (
            (fused_decode.decode_fused_mean_cuda,
             fused_decode.decode_fused_mean_plain),
            (fused_decode.decode_fused_each_cuda,
             fused_decode.decode_fused_each_plain)):
        assert torch.equal(cuda_fn(words, levels, d=d, bits=4),
                           plain(words, levels, d=d, bits=4))


@pytest.mark.gpu
@pytest.mark.parametrize("q64", [True, False])
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_bingrad_encode_at_schedule_shapes(cuda, case, q64):
    v, mask, _ = _inputs(case, cuda, seed=1, q64=q64)
    words, lv = fused_bingrad.encode_bingrad_fused_cuda(v, mask, None)
    order = fused_bingrad.kernel_order_levels(v, mask, None)
    assert torch.equal(lv.view(torch.int32), order.view(torch.int32))
    own = fused_encode.encode_fused_plain(v, lv, None, mask, None, bits=1,
                                          mode="bin")
    assert torch.equal(words, own)
    if q64:       # every sum exact: the plain fit's levels and words too
        want_w, want_l = fused_bingrad.encode_bingrad_fused_plain(v, mask,
                                                                  None)
        assert torch.equal(lv, want_l) and torch.equal(words, want_w)
