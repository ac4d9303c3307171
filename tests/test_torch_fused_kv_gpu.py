"""The port's CUDA kernels against their plain PyTorch versions.

Tests marked ``gpu`` need a CUDA device and skip without one; they import
no JAX, so they run on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_fused_kv_gpu.py

Tolerances: ``encode_fused`` is bit-equal (the kernel repeats the plain
version's float32 operations, compiled without FMA contraction or fast
math); ``decode_attend`` is within ``atol 1e-5`` (its online softmax and
per-lane dot products add in another order than the plain einsum).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.core.api import make_quantizer
from repro_torch.kernels import fused_encode, fused_kv
from repro_torch.models import LM
from repro_torch.models.model import map_tree
from repro_torch.serve import Engine, ServeConfig

ATOL_KERNEL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _encode_bit_equal(cuda, mode, bits, s, d, masked, clip, nb, seed):
    g = _gen(seed)
    v = torch.randn((nb, d), generator=g) * 0.3
    lv = torch.sort(torch.randn((nb, s), generator=g) * 0.3).values
    rb = (torch.randint(-2 ** 31, 2 ** 31, (nb, d), generator=g,
                        dtype=torch.int64).to(torch.int32)
          if mode == "rr" else None)
    mask = torch.rand((nb, d), generator=g) > 0.1 if masked else None
    lim = fused_encode.clip_limit(v, mask, 2.5) if clip else None
    want = fused_encode.encode_fused_plain(v, lv, rb, mask, lim, bits=bits,
                                           mode=mode)
    dev = [None if t is None else t.to(cuda) for t in (v, lv, rb, mask, lim)]
    got = fused_encode.encode_fused_cuda(*dev, bits=bits, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,bits,s,d,masked,clip", [
    ("rr", 4, 9, 768, False, False), ("rr", 4, 9, 768, True, True),
    ("rr", 3, 5, 100, True, False), ("rr", 5, 17, 300, False, True),
    ("rr", 2, 3, 33, True, False), ("rr", 1, 2, 64, False, False),
    ("bin", 1, 2, 768, True, False), ("sign", 1, 2, 100, False, True),
])
def test_encode_fused_cuda_bit_equal(cuda, mode, bits, s, d, masked, clip):
    _encode_bit_equal(cuda, mode, bits, s, d, masked, clip, 37, d + bits)


#: bits 1-5 at the scheme's s = 2^(bits-1) + 1 (the kernel holds the table
#: in registers) and at another s (in shared memory); d 2048, 2047 (a
#: ragged last word) and 100; mask none or random; clip or not
ENCODE_GRID = [(bits, s, d, masked, clip)
               for bits, ss in ((1, (2,)), (2, (3, 4)), (3, (5, 7)),
                                (4, (9, 12)), (5, (17, 10)))
               for s in ss for d in (2048, 2047, 100)
               for masked in (False, True) for clip in (False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("bits,s,d,masked,clip", ENCODE_GRID)
def test_encode_fused_cuda_grid_bit_equal(cuda, bits, s, d, masked, clip):
    _encode_bit_equal(cuda, "rr", bits, s, d, masked, clip, 37,
                      ENCODE_GRID.index((bits, s, d, masked, clip)))


@pytest.mark.gpu
@pytest.mark.parametrize("nb,d,bits,s,mode", [
    (1, 2048, 4, 9, "rr"), (1, 37, 3, 5, "rr"), (16, 768, 4, 9, "rr"),
    (128, 768, 4, 9, "rr"), (16, 768, 1, 2, "bin"), (600, 2048, 4, 9, "rr"),
    (3000, 2048, 1, 2, "sign"), (400, 2047, 5, 17, "rr"),
    (300, 2000, 3, 5, "rr"),
])
def test_encode_fused_cuda_row_counts(cuda, nb, d, bits, s, mode):
    """One row, the serving shapes (one-warp blocks) and enough rows for
    blocks of several warps (fused_encode.encode_grid)."""
    _encode_bit_equal(cuda, mode, bits, s, d, True, False, nb, nb + d)


ATTEND_CASES = {  # name -> (B, T, H, KV, hd, C, softcap, first positions
    #                          [, "window", width | "holes", admitted share])
    "decode": (3, 1, 4, 4, 32, 40, 0.0, [39, 5, 13]),
    "prefill": (1, 16, 12, 12, 64, 64, 0.0, [20]),
    "gqa": (2, 1, 8, 2, 64, 48, 0.0, [47, 9]),
    "softcap": (2, 3, 4, 2, 128, 33, 5.0, [7, 30]),
    "fully_masked": (2, 1, 4, 4, 32, 16, 0.0, [-1, 15]),
    # the skip and the split (S 4 at C 512, 8 at C 1000, fused_kv.
    # split_count): last admitted position at 0, 31, 32, 511, C - 1
    "split_c512_last0_511": (2, 1, 4, 4, 64, 512, 0.0, [0, 511]),
    "split_c512_last31_32": (2, 1, 4, 4, 64, 512, 0.0, [31, 32]),
    "split_c1000_last999": (2, 1, 4, 4, 64, 1000, 0.0, [999, 500]),
    # an admitted run across split boundaries (128, 256 at S 4), not from 0
    "split_c512_window": (1, 1, 4, 4, 64, 512, 0.0, [300], "window", 250),
    "split_c1000_window": (2, 2, 4, 4, 64, 1000, 0.0, [700, 90], "window",
                           200),
    "split_holes": (2, 2, 4, 4, 64, 512, 0.0, [400, 200], "holes", 0.3),
    # T > 1, row t = 0 fully masked beside admitted rows of its block
    "split_masked_row_t3": (2, 3, 4, 4, 64, 512, 0.0, [-1, 130]),
    "split_masked_row_c1000": (1, 2, 4, 4, 64, 1000, 0.0, [-1]),
    "split_gqa4": (2, 1, 8, 2, 64, 512, 0.0, [137, 511]),
    "split_gqa4_t3_softcap": (1, 3, 8, 2, 32, 1000, 5.0, [600]),
    "split_hd32": (3, 1, 4, 4, 32, 512, 0.0, [40, 160, 511]),
    "split_hd128": (2, 2, 4, 2, 128, 512, 0.0, [255, 256]),
    # the serving path's positions: 128-160 of 512
    "split_serve": (8, 1, 12, 12, 64, 512, 0.0,
                    [128, 132, 137, 141, 146, 150, 155, 160]),
    # head dims padded to the kernel's 32, 64, 128 or 256 (hd 16: command-r
    # plus's smoke config and whisper-base; 256: gemma2-9b)
    "hd16": (3, 1, 4, 4, 16, 40, 0.0, [39, 5, 13]),
    "hd48": (2, 2, 4, 4, 48, 512, 0.0, [300, 40]),
    "hd80": (2, 1, 8, 2, 80, 300, 0.0, [299, 17]),
    "hd256": (2, 1, 4, 4, 256, 512, 0.0, [511, 100]),
    "hd256_gqa4_t2": (2, 2, 8, 2, 256, 300, 0.0, [150, 298]),
    "hd256_softcap": (1, 3, 4, 4, 256, 200, 5.0, [100]),
    # head slices that start inside a word at 1, 2, 3 and 5 bits
    "hd16_bits1": (2, 1, 4, 4, 16, 100, 0.0, [99, 50]),
    "hd100_bits2": (2, 1, 6, 3, 100, 64, 0.0, [63, 10]),
    "hd20_bits3": (2, 2, 4, 4, 20, 80, 0.0, [60, 3]),
    "hd36_bits5": (2, 1, 4, 2, 36, 70, 0.0, [69, 33]),
}
#: the page scheme of a case where it is not orq-9 (4 bits)
ATTEND_SCHEMES = {"hd16_bits1": "bingrad-b", "hd100_bits2": "terngrad",
                  "hd20_bits3": "orq-5", "hd36_bits5": "orq-17"}


def _attend_inputs(case):
    B, T, H, KV, hd, C, cap, first, *band = ATTEND_CASES[case]
    g = _gen(sorted(ATTEND_CASES).index(case))
    d = KV * hd
    qz = make_quantizer(ATTEND_SCHEMES.get(case, "orq-9"), bucket_size=d)
    rows = torch.randn((2, B * C, d), generator=g) * 0.5
    rb = torch.randint(-2 ** 31, 2 ** 31, (2 * B * C, d), generator=g,
                       dtype=torch.int64).to(torch.int32)
    parts = fused_kv.append_kv(qz, rows[0], rows[1], rb)
    kw, klv, vw, vlv = (t.reshape(B, C, -1).contiguous() for t in parts)
    q = torch.randn((B, T, H, hd), generator=g)
    qpos = torch.tensor(first)[:, None] + torch.arange(T)[None]
    mask = torch.arange(C)[None, None, :] <= qpos[:, :, None]
    if band and band[0] == "window":
        mask &= torch.arange(C)[None, None, :] > qpos[:, :, None] - band[1]
    if band and band[0] == "holes":
        mask = torch.rand((B, T, C), generator=g) < band[1]
    kwargs = dict(bits=qz.wire_bits_per_element, kv_heads=KV,
                  scale=hd ** -0.5, softcap=cap)
    return (q, kw, klv, vw, vlv, mask), kwargs


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(ATTEND_CASES))
def test_decode_attend_cuda_close(cuda, case):
    args, kw = _attend_inputs(case)
    want = fused_kv.decode_attend_plain(*args, **kw)
    got = fused_kv.decode_attend_cuda(*[t.to(cuda) for t in args], **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=ATOL_KERNEL)


@pytest.mark.gpu
def test_decode_attend_cuda_rejects_head_dim(cuda):
    """hd 1..256 run (padded to 32, 64, 128 or 256); hd 320 raises."""
    B, C = 3, 40
    q = torch.zeros((B, 1, 1, 320), device=cuda)
    words = torch.zeros((B, C, 40), dtype=torch.int32, device=cuda)
    lv = torch.zeros((B, C, 9), device=cuda)
    mask = torch.ones((B, 1, C), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fused_kv.decode_attend_cuda(q, words, lv, words, lv, mask, bits=4,
                                    kv_heads=1, scale=1.0)


def test_cuda_wrappers_reject_cpu_tensors():
    """The kernel wrappers never run on the CPU; the dispatch picks the
    plain version there instead."""
    args, kw = _attend_inputs("decode")
    with pytest.raises(ValueError, match="not on a CUDA device"):
        fused_kv.decode_attend_cuda(*args, **kw)
    v = torch.zeros((2, 8))
    lv = torch.tensor([[-1.0, 1.0]] * 2)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        fused_encode.encode_fused_cuda(v, lv, None, None, None, bits=1,
                                       mode="sign")


@pytest.mark.gpu
def test_engine_on_card_goes_through_the_kernels(cuda):
    model = LM(get_smoke_config("lm-100m"))
    params = map_tree(lambda t: t.to(torch.bfloat16),
                      model.init(_gen(0), device="cpu"))
    cfg = ServeConfig(kv_quant="orq-9", page_size=4, max_batch=2,
                      max_pages_per_seq=4, prefill_chunk=4)
    eng = Engine(model, params, cfg)
    assert eng.device.type == "cuda"
    enc0 = fused_encode.encode_fused_cuda.launches
    att0 = fused_kv.decode_attend_cuda.launches
    rids = [eng.submit(np.arange(6) + i, max_new=3) for i in range(2)]
    res = eng.run()
    n = eng.forward_calls * model.cfg.num_layers
    assert fused_encode.encode_fused_cuda.launches - enc0 == n
    assert fused_kv.decode_attend_cuda.launches - att0 == n
    assert all(len(res[r].generated) == 3 for r in rids)
