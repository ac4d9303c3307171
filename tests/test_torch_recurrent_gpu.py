"""Mamba and RWKV-6 on the card against the CPU, at the ``SMOKE`` sizes of
jamba-v0.1-52b and rwkv6-3b.

Tests marked ``gpu`` need a CUDA device and skip without one; they import
no JAX, so they run on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_recurrent_gpu.py

Both layers are plain PyTorch (the reference's are plain ``jnp``), so the
card and the CPU differ only in how cuBLAS and the CPU round float32 sums.
Every bound is on the largest |difference| over the largest magnitude of
the CPU's value, ATOL_F32 = 1e-5 (the bound the CPU tests hold the port to
against the reference): ``mamba_forward``, a chain of
``mamba_decode_step`` with its states, ``_wkv_scan`` (its output and
final state) and one RWKV decode step with its ``wkv`` state; the decode
step's shifts are its own inputs, bit-equal. The bf16 forward of both
models, card against CPU, is phase 22 of ``chip_smoke.py``.
"""
import pytest
import torch

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.launch.serve import dense_state_bytes
from repro_torch.models import LM, blocks, rwkv, ssm
from repro_torch.models.model import map_tree

ATOL_F32 = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _err(got, want):
    return float((got.cpu() - want).abs().max() / want.abs().max())


def _layer(arch, seed=0):
    """One smoke layer of the arch's recurrent kind, float32, with its
    zero and constant leaves moved off their init."""
    cfg = get_smoke_config(arch)
    spec = next(s for s in LM(cfg).specs if s.kind in ("mamba", "rwkv"))
    g = torch.Generator().manual_seed(seed)
    p = blocks.init_layer(cfg, spec, g)
    for n, t in p.items():
        if not isinstance(t, dict) and t.dim() <= 2 and t.numel() <= 6 * 512:
            p[n] = t + 0.1 * torch.randn(t.shape, generator=g)
    return cfg, spec, p, g


@pytest.mark.gpu
@pytest.mark.parametrize("S", [64, 300])
def test_mamba_forward_card_vs_cpu(cuda, S):
    cfg, _, p, g = _layer("jamba-v0.1-52b")
    p = {k: v for k, v in p.items() if k != "norm"}
    spec = blocks.mamba_spec(cfg)
    x = torch.randn((2, S, cfg.d_model), generator=g)
    want = ssm.mamba_forward(p, x, spec)
    got = ssm.mamba_forward(map_tree(lambda t: t.to(cuda), p), x.to(cuda),
                            spec)
    assert _err(got, want) <= ATOL_F32


@pytest.mark.gpu
def test_mamba_decode_chain_card_vs_cpu(cuda):
    cfg, _, p, g = _layer("jamba-v0.1-52b", 1)
    p = {k: v for k, v in p.items() if k != "norm"}
    spec = blocks.mamba_spec(cfg)
    pd = map_tree(lambda t: t.to(cuda), p)
    x = torch.randn((3, 12, cfg.d_model), generator=g)
    st = ssm.init_mamba_state(3, spec, torch.float32, device="cpu")
    sd = ssm.init_mamba_state(3, spec, torch.float32, device=cuda)
    for i in range(12):
        want, st = ssm.mamba_decode_step(p, x[:, i:i + 1], st, spec)
        got, sd = ssm.mamba_decode_step(pd, x[:, i:i + 1].to(cuda), sd, spec)
        assert _err(got, want) <= ATOL_F32, i
    for k in ("ssm", "conv"):
        assert _err(sd[k], st[k]) <= ATOL_F32, k


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 50, 128])
def test_wkv_scan_card_vs_cpu(cuda, S):
    g = torch.Generator().manual_seed(S)
    B, H, hd = 2, 4, 32
    r, k, v = (torch.randn((B, S, H, hd), generator=g) for _ in range(3))
    logw = -torch.exp(torch.randn((B, S, H, hd), generator=g) - 1.0)
    u = torch.randn((H, hd), generator=g)
    s0 = torch.randn((B, H, hd, hd), generator=g)
    want = rwkv._wkv_scan(r, k, v, None, u, 32, s0, logw=logw)
    got = rwkv._wkv_scan(*(t.to(cuda) for t in (r, k, v)), None, u.to(cuda),
                         32, s0.to(cuda), logw=logw.to(cuda))
    for a, b in zip(got, want):
        assert _err(a, b) <= ATOL_F32


@pytest.mark.gpu
def test_rwkv_mixes_and_decode_step_card_vs_cpu(cuda):
    cfg, _, p, g = _layer("rwkv6-3b", 2)
    spec = blocks.rwkv_spec(cfg)
    pd = map_tree(lambda t: t.to(cuda), p)
    x = torch.randn((2, 40, cfg.d_model), generator=g)
    assert _err(rwkv.time_mix(pd, x.to(cuda), spec),
                rwkv.time_mix(p, x, spec)) <= ATOL_F32
    assert _err(rwkv.channel_mix_train(pd, x.to(cuda)),
                rwkv.channel_mix_train(p, x)) <= ATOL_F32
    B, D = 3, cfg.d_model
    xt, ht = (torch.randn((B, 1, D), generator=g) for _ in range(2))
    st = {"wkv": torch.randn((B, spec.num_heads, spec.head_dim,
                              spec.head_dim), generator=g),
          "shift": torch.randn((B, D), generator=g)}
    cm_shift = torch.randn((B, D), generator=g)
    want = rwkv.time_mix_decode(p, xt, st, spec)
    got = rwkv.time_mix_decode(pd, xt.to(cuda), map_tree(
        lambda t: t.to(cuda), st), spec)
    assert _err(got[0], want[0]) <= ATOL_F32
    assert _err(got[1]["wkv"], want[1]["wkv"]) <= ATOL_F32
    assert torch.equal(got[1]["shift"].cpu(), want[1]["shift"])
    cw = rwkv.channel_mix_decode(p, ht, {"shift": cm_shift})
    cg = rwkv.channel_mix_decode(pd, ht.to(cuda), {"shift": cm_shift.to(
        cuda)})
    assert _err(cg[0], cw[0]) <= ATOL_F32
    assert torch.equal(cg[1]["shift"].cpu(), cw[1]["shift"])


@pytest.mark.gpu
@pytest.mark.parametrize("arch,want", [("jamba-v0.1-52b", 573_440),
                                       ("rwkv6-3b", 665_600)])
def test_full_width_layer_state_bytes(cuda, arch, want):
    """One full-width recurrent layer's cache on the card, batch 8: the
    bytes ``dense_state_bytes`` reports a sequence, eight times."""
    cfg = get_config(arch)
    spec = next(s for s in LM(cfg).specs if s.kind in ("mamba", "rwkv"))
    cache = blocks.init_layer_cache(cfg, spec, 8, 128, device=cuda)
    got = sum(t.numel() * t.element_size() for t in cache.values())
    assert all(t.device.type == "cuda" for t in cache.values())
    assert dense_state_bytes(cfg) == want and got == 8 * want
