"""The serving kernels at the five dense GQA / sliding-window
architectures' full-width shapes, on the card against their plain PyTorch
versions.

Tests marked ``gpu`` need a CUDA device and skip without one; they import
no JAX, so they run on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_archs_gpu.py

Tolerances: ``encode_fused`` is bit-equal; ``decode_attend`` within
``atol 1e-5`` (its online softmax adds in another order than the plain
einsum). The smoke-size engines on the card and on the CPU agree within
0.25 in the logits (bf16 matmuls of cuBLAS and the CPU round apart, which
moves a few 4-bit roundings of the second layer).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.api import make_quantizer
from repro_torch.kernels import fused_encode, fused_kv
from repro_torch.models import LM
from repro_torch.models.model import map_tree
from repro_torch.serve import Engine, ServeConfig

ATOL_KERNEL = 1e-5
ATOL_LOGITS = 0.25
ARCHS = ["qwen1.5-32b", "command-r-plus-104b", "chameleon-34b", "gemma2-9b",
         "gemma3-27b"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _pages(cfg, B, C, g):
    """orq-9 K/V pages of ``B`` sequences of ``C`` tokens at the arch's
    KV width, encoded by the plain version."""
    d = cfg.num_kv_heads * cfg.resolved_head_dim
    qz = make_quantizer("orq-9", bucket_size=d)
    rows = torch.randn((2, B * C, d), generator=g) * 0.5
    rb = torch.randint(-2 ** 31, 2 ** 31, (2 * B * C, d), generator=g,
                       dtype=torch.int64).to(torch.int32)
    kw, klv, vw, vlv = fused_kv.append_kv(qz, rows[0], rows[1], rb)
    return qz, [t.reshape(B, C, -1).contiguous() for t in (kw, klv, vw, vlv)]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("local", [False, True])
def test_decode_attend_at_arch_shapes(cuda, arch, local):
    """Batch-2 decode at a context 64 past the window (or of 192): the
    arch's head dim, GQA ratio and softcap; on a local layer the window
    mask."""
    cfg = get_config(arch)
    if local and not cfg.window:
        pytest.skip(f"{arch} has no sliding-window layer")
    g = torch.Generator().manual_seed(7)
    B, C = 2, (cfg.window or 128) + 64
    qz, (kw, klv, vw, vlv) = _pages(cfg, B, C, g)
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q = torch.randn((B, 1, H, hd), generator=g)
    pos = torch.tensor([C - 1, C - 9])
    carr = torch.arange(C)
    mask = carr[None, None, :] <= pos[:, None, None]
    if local:
        mask &= (pos[:, None, None] - carr[None, None, :]) < cfg.window
    kw_ = dict(bits=qz.wire_bits_per_element, kv_heads=cfg.num_kv_heads,
               scale=hd ** -0.5, softcap=cfg.attn_softcap)
    args = (q, kw, klv, vw, vlv, mask)
    want = fused_kv.decode_attend_plain(*args, **kw_)
    got = fused_kv.decode_attend_cuda(*[t.to(cuda) for t in args], **kw_)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got.cpu() - want).abs().max()) <= ATOL_KERNEL


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_kv_encode_bit_equal_at_arch_width(cuda, arch):
    cfg = get_config(arch)
    d = cfg.num_kv_heads * cfg.resolved_head_dim
    g = torch.Generator().manual_seed(3)
    v = torch.randn((4, d), generator=g)
    qz = make_quantizer("orq-9", bucket_size=d)
    levels = qz.fit(v, torch.ones_like(v, dtype=torch.bool))
    rb = torch.randint(-2 ** 31, 2 ** 31, (4, d), generator=g,
                       dtype=torch.int64).to(torch.int32)
    args = (v, levels, rb, None, None)
    want = fused_encode.encode_fused_plain(*args, bits=4)
    got = fused_encode.encode_fused_cuda(
        *[None if t is None else t.to(cuda) for t in args], bits=4)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma3-27b"])
def test_windowed_smoke_engine_card_close_to_cpu(cuda, arch):
    """The smoke engine with orq-9 pages over a prompt past the window,
    one prefill chunk and a decode step, card against CPU from equal
    weights and pools."""
    model = LM(get_smoke_config(arch))
    params = map_tree(lambda t: t.to(torch.bfloat16),
                      model.init(torch.Generator().manual_seed(0),
                                 device="cpu"))
    cfg = ServeConfig(kv_quant="orq-9", page_size=8, max_batch=1,
                      max_pages_per_seq=8, prefill_chunk=48,
                      record_logits=True)
    engines = [Engine(model, params, cfg, device=d) for d in ("cpu", cuda)]
    prompt = np.random.default_rng(5).integers(0, 512, 40).astype(np.int32)
    out = []
    for eng in engines:
        rid = eng.submit(prompt, max_new=2)
        out.append(eng.run()[rid])
    assert out[0].logits and len(out[0].logits) == len(out[1].logits)
    np.testing.assert_allclose(np.asarray(out[1].logits[0]),
                               np.asarray(out[0].logits[0]), rtol=0,
                               atol=ATOL_LOGITS)
