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


@pytest.mark.gpu
@pytest.mark.parametrize("mode,bits,s,d,masked,clip", [
    ("rr", 4, 9, 768, False, False), ("rr", 4, 9, 768, True, True),
    ("rr", 3, 5, 100, True, False), ("rr", 5, 17, 300, False, True),
    ("rr", 2, 3, 33, True, False), ("rr", 1, 2, 64, False, False),
    ("bin", 1, 2, 768, True, False), ("sign", 1, 2, 100, False, True),
])
def test_encode_fused_cuda_bit_equal(cuda, mode, bits, s, d, masked, clip):
    g = _gen(d + bits)
    nb = 37
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
}


def _attend_inputs(case):
    B, T, H, KV, hd, C, cap, first, *band = ATTEND_CASES[case]
    g = _gen(sorted(ATTEND_CASES).index(case))
    d = KV * hd
    qz = make_quantizer("orq-9", bucket_size=d)
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
    args, kw = _attend_inputs("decode")
    q = torch.zeros((3, 1, 2, 48), device=cuda)
    rest = [t.to(cuda) for t in args[1:]]
    kw = dict(kw, kv_heads=2)
    with pytest.raises(ValueError, match="head_dim"):
        fused_kv.decode_attend_cuda(q, *rest, **kw)


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
