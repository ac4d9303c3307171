"""Gemma-2 9B [arXiv:2408.00118]: 42L, d=3584, 16H (GQA kv=8, head_dim
256), d_ff=14336, vocab 256000, alternating local(4096)/global attention,
attn logit softcap 50, final logit softcap 30, tied embeddings."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    arch_type="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    layer_pattern=("attn_local", "attn"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    embed_scale=True,
    tie_embeddings=True,
    mlp_act="gelu",
    supports_long_context=True,   # half the layers windowed; global-layer
                                  # KV sequence-sharded at 500k
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
    window=32,
    q_chunk=64,
    kv_chunk=64,
)
