"""~110M-parameter dense LM used by the end-to-end training example."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="lm-100m",
    arch_type="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=2048,
    vocab_size=32768,
    q_chunk=256,
    kv_chunk=256,
    supports_long_context=False,
)

SMOKE = dataclasses.replace(CONFIG, num_layers=2, d_model=128, num_heads=4,
                            num_kv_heads=4, head_dim=32, d_ff=256,
                            vocab_size=512)
