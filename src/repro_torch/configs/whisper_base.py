"""Whisper base [arXiv:2212.04356]: enc-dec, 6+6L, d=512, 8H, d_ff=2048,
vocab 51865. The mel-spectrogram + conv frontend is a STUB: callers supply
precomputed (B, 1500, 512) frame embeddings (``enc_embeds``)."""
import dataclasses

from repro_torch.configs.base import EncoderParams, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    arch_type="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    encoder=EncoderParams(num_layers=6, num_frames=1500),
    norm="ln",
    mlp_act="gelu",
    norm_eps=1e-5,
    supports_long_context=False,  # enc-dec ASR; 500k decode out of scope
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    encoder=EncoderParams(num_layers=2, num_frames=30),
    q_chunk=32,
    kv_chunk=32,
)
