"""Qwen1.5 32B [hf:Qwen/Qwen1.5-0.5B family]: 64L, d=5120, 40H (MHA,
kv=40), d_ff=27392, vocab 152064, QKV bias."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    arch_type="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    supports_long_context=False,  # pure full attention
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    q_chunk=64,
    kv_chunk=64,
)
