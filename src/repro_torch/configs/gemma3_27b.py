"""Gemma-3 27B [hf:google/gemma-3-1b-pt family]: 62L, d=5376, 32H (GQA
kv=16), d_ff=21504, vocab 262144, 5:1 local:global interleave (window 1024),
qk-norm, tied embeddings, 128k-class context."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    arch_type="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    layer_pattern=("attn_local",) * 5 + ("attn",),
    window=1024,
    qk_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    mlp_act="gelu",
    rope_theta=1e6,
    rope_theta_local=1e4,
    supports_long_context=True,   # 5/6 of layers are windowed; global-layer
                                  # KV is sequence-sharded at 500k
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=2,                 # one local + one global (pattern cycles)
    layer_pattern=("attn_local", "attn"),
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    window=32,
    q_chunk=64,
    kv_chunk=64,
)
