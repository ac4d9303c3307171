"""RWKV-6 "Finch" 3B [arXiv:2404.05892]: 32L, d=2560, attention-free
(40 heads x 64), channel-mix d_ff=8960, vocab 65536, data-dependent decay."""
import dataclasses

from repro_torch.configs.base import ModelConfig, RWKVParams

CONFIG = ModelConfig(
    name="rwkv6-3b",
    arch_type="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=0,                  # attention-free
    num_kv_heads=0,
    d_ff=8960,
    vocab_size=65536,
    layer_pattern=("rwkv",),
    rwkv=RWKVParams(head_dim=64, lora_mix=32, lora_decay=64),
    supports_long_context=True,   # O(1) recurrent state
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=2,
    d_model=128,
    d_ff=256,
    vocab_size=512,
    rwkv=RWKVParams(head_dim=32, lora_mix=16, lora_decay=16),
)
