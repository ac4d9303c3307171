"""Jamba v0.1 52B [arXiv:2403.19887]: 32L, d=4096, Mamba:attention 7:1
(attention at position 4 of each 8-layer block), MoE 16 experts top-2 every
other layer, 32H (GQA kv=8), d_ff=14336, vocab 65536."""
import dataclasses

from repro_torch.configs.base import MambaParams, ModelConfig, MoEParams

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    layer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    moe_every=2,
    moe=MoEParams(num_experts=16, top_k=2, d_ff_expert=14336),
    mamba=MambaParams(d_state=16, d_conv=4, expand=2),
    supports_long_context=True,   # SSM state is O(1); few attn layers
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=2,
    layer_pattern=("mamba", "attn"),
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    moe=MoEParams(num_experts=4, top_k=2, d_ff_expert=256),
    mamba=MambaParams(d_state=8, d_conv=4, expand=2),
    q_chunk=64,
    kv_chunk=64,
)
