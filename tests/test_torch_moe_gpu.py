"""The MoE FFN and MLA's absorbed decode on the card against the CPU, at
the ``SMOKE`` sizes of mixtral-8x22b and deepseek-v2-236b.

Tests marked ``gpu`` need a CUDA device and skip without one; they import
no JAX, so they run on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_moe_gpu.py

Both paths are plain PyTorch (the reference computes them outside any
Pallas kernel), so the card and the CPU differ only in how cuBLAS and the
CPU round float32 sums. Tolerances:

* ``moe_ffn`` in float32: the routing equal (expert ids and the capacity
  mask), y and aux within 1e-5;
* one MLA decode step in float32: the new ``ckv`` and ``kr`` rows within
  CACHE_ATOL of their magnitude (the card and the CPU round the row's
  float32 arithmetic apart in the last bits; phase 21 of
  ``chip_smoke.py`` reads stage by stage where), every other slot and the
  ``pos`` array bit-equal, the output within 1e-4.

The bf16 forward of both architectures, card against CPU with routing
agreement, is phase 21 of ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.models import LM, moe
from repro_torch.models import blocks
from repro_torch.models.model import map_tree

ATOL_F32 = 1e-5
ATOL_MLA = 1e-4
CACHE_ATOL = 1e-6
ARCHS = ["mixtral-8x22b", "deepseek-v2-236b"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _moe_layer(arch, seed=0):
    cfg = get_smoke_config(arch)
    spec = next(s for s in LM(cfg).specs if s.moe)
    p = blocks.init_layer(cfg, spec, torch.Generator().manual_seed(seed))
    return cfg, spec, p


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("T", [16, 256])
def test_moe_ffn_card_vs_cpu(cuda, arch, T):
    cfg, _, p = _moe_layer(arch)
    spec = blocks.moe_spec(cfg)
    x = torch.randn((T, cfg.d_model), generator=torch.Generator()
                    .manual_seed(T))
    # expert 0 favoured, so its queue overflows at T 256: drops
    p["ffn"]["router"][0, 0] = 4.0
    x[:, 0] += 1.5
    y_cpu, aux_cpu = moe.moe_ffn(p["ffn"], x, spec)
    r_cpu = moe.route(p["ffn"], x, spec)
    pc = map_tree(lambda t: t.to(cuda), p["ffn"])
    y, aux = moe.moe_ffn(pc, x.to(cuda), spec)
    r = moe.route(pc, x.to(cuda), spec)
    assert torch.equal(r.topi.cpu(), r_cpu.topi)
    assert torch.equal(r.keep.cpu(), r_cpu.keep)
    np.testing.assert_allclose(y.cpu().numpy(), y_cpu.numpy(), rtol=0,
                               atol=ATOL_F32)
    np.testing.assert_allclose(float(aux), float(aux_cpu), rtol=0,
                               atol=ATOL_F32)


@pytest.mark.gpu
def test_mla_decode_card_vs_cpu(cuda):
    """One absorbed-form decode step at position 5 of a cache with 5
    written slots, float32."""
    cfg = get_smoke_config("deepseek-v2-236b")
    spec = LM(cfg).specs[1]
    g = torch.Generator().manual_seed(1)
    p = blocks.init_layer(cfg, spec, g)
    p["attn"]["q_norm"] = 0.1 * torch.randn(p["attn"]["q_norm"].shape,
                                            generator=g)
    B, C, pos = 3, 16, 5
    cache = blocks.init_layer_cache(cfg, spec, B, C, torch.float32,
                                    device="cpu")
    cache["ckv"][:, :pos] = torch.randn((B, pos, cfg.mla.kv_lora),
                                        generator=g)
    cache["kr"][:, :pos] = torch.randn((B, pos, cfg.mla.rope_head_dim),
                                       generator=g)
    cache["pos"][:pos] = torch.arange(pos, dtype=torch.int32)
    x = torch.randn((B, 1, cfg.d_model), generator=g)
    cache_gpu = {k: v.to(cuda) for k, v in cache.items()}
    want = blocks._mla_decode(cfg, p, x, cache, pos)
    got = blocks._mla_decode(cfg, map_tree(lambda t: t.to(cuda), p), x.to(cuda),
                    cache_gpu, pos)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=ATOL_MLA)
    for k in ("ckv", "kr"):
        a, b = cache_gpu[k].cpu(), cache[k]
        assert torch.equal(a[:, :pos], b[:, :pos])
        assert torch.equal(a[:, pos + 1:], b[:, pos + 1:])
        np.testing.assert_allclose(a[:, pos].numpy(), b[:, pos].numpy(),
                                   rtol=0,
                                   atol=CACHE_ATOL * float(b.abs().max()))
    assert torch.equal(cache_gpu["pos"].cpu(), cache["pos"])
