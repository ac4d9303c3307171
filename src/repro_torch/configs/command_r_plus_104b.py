"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-v01 family]: 64L,
d=12288, 96H (GQA kv=8), d_ff=33792, vocab 256000, no biases."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    arch_type="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    supports_long_context=False,  # pure full attention
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=2,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    q_chunk=64,
    kv_chunk=64,
)
