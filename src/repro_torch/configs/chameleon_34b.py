"""Chameleon 34B [arXiv:2405.09818]: 48L, d=8192, 64H (GQA kv=8),
d_ff=22016, vocab 65536 — early fusion: VQ image tokens are ordinary ids in
the shared vocabulary (the VQ-VAE tokenizer is the stubbed frontend;
``input_specs`` supplies interleaved text+image token ids). qk-norm."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    supports_long_context=False,  # pure full attention
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
    q_chunk=64,
    kv_chunk=64,
)
