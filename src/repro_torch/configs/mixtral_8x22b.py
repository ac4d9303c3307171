"""Mixtral 8x22B [arXiv:2401.04088]: 56L, d=6144, 48H (GQA kv=8), 8 experts
top-2 (d_ff_expert=16384), vocab 32768, sliding-window attention."""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEParams

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    layer_pattern=("attn_local",),
    window=4096,
    moe_every=1,
    moe=MoEParams(num_experts=8, top_k=2, d_ff_expert=16384),
    rope_theta=1e6,
    supports_long_context=True,   # SWA: ring cache stays at `window`
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    window=64,
    moe=MoEParams(num_experts=4, top_k=2, d_ff_expert=256),
    q_chunk=64,
    kv_chunk=64,
)
