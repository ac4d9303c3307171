"""DeepSeek-V2 236B [arXiv:2405.04434]: 60L, d=5120, 128H with MLA
(kv_lora=512, q_lora=1536, rope/nope head dims 64/128), 2 shared + 160
routed experts top-6 (d_ff_expert=1536), first layer dense (d_ff=12288),
vocab 102400."""
import dataclasses

from repro_torch.configs.base import MLAParams, ModelConfig, MoEParams

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=1536,
    vocab_size=102400,
    mla=MLAParams(q_lora=1536, kv_lora=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe_every=1,
    moe=MoEParams(num_experts=160, top_k=6, d_ff_expert=1536, num_shared=2),
    first_layer_dense_ff=12288,
    supports_long_context=False,  # MLA is full attention over the cache
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=64,
    vocab_size=512,
    mla=MLAParams(q_lora=64, kv_lora=32, rope_head_dim=16,
                  nope_head_dim=32, v_head_dim=32),
    moe=MoEParams(num_experts=4, top_k=2, d_ff_expert=64, num_shared=1),
    first_layer_dense_ff=128,
    q_chunk=64,
    kv_chunk=64,
)
