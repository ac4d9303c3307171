"""Model configuration schema + registry (copy of the reference's
``configs/base.py``; the registry names only the ported configs)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEParams:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAParams:
    q_lora: int = 1536
    kv_lora: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaParams:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class RWKVParams:
    head_dim: int = 64
    lora_mix: int = 32
    lora_decay: int = 64
    chunk: int = 32     # chunked-WKV span (see EXPERIMENTS.md §Perf it. 1)


@dataclasses.dataclass(frozen=True)
class EncoderParams:
    """Whisper-style encoder over a stubbed modality frontend: the conv/mel
    stack is replaced by precomputed frame embeddings in ``input_specs``."""
    num_layers: int
    num_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                      # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // num_heads
    # layer pattern, cycled across layers: attn | attn_local | mamba | rwkv
    layer_pattern: Tuple[str, ...] = ("attn",)
    window: Optional[int] = None        # sliding window for attn_local
    moe_every: int = 0                  # 0 = dense; n = MoE on layers i%n==n-1
    moe: Optional[MoEParams] = None
    first_layer_dense_ff: int = 0       # deepseek: layer 0 keeps a dense FFN
    mla: Optional[MLAParams] = None
    mamba: Optional[MambaParams] = None
    rwkv: Optional[RWKVParams] = None
    encoder: Optional[EncoderParams] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 1e4
    rope_theta_local: float = 0.0       # gemma3: different theta for local
    tie_embeddings: bool = False
    embed_scale: bool = False           # gemma: scale embeds by sqrt(D)
    mlp_act: str = "silu"
    norm: str = "rms"                   # rms | ln
    norm_eps: float = 1e-6
    q_chunk: int = 512
    kv_chunk: int = 512
    remat: bool = True
    attn_probs_bf16: bool = False   # beyond-paper: bf16 attention probs
                                    # (halves PV-einsum read traffic)
    # which input shapes this arch supports for decode; long_500k needs a
    # sub-quadratic/windowed stack (see DESIGN.md §shape-skips)
    supports_long_context: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def layer_kind(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def layer_is_moe(self, i: int) -> bool:
        if self.moe_every == 0 or self.moe is None:
            return False
        if i == 0 and self.first_layer_dense_ff:
            return False
        return i % self.moe_every == self.moe_every - 1

    def layer_ff(self, i: int) -> int:
        if i == 0 and self.first_layer_dense_ff:
            return self.first_layer_dense_ff
        return self.d_ff


# Every configuration of the reference's registry
# (``src/repro/configs/base.py``).
_REGISTRY = {
    "lm-100m": "repro_torch.configs.lm_100m",
    "qwen1.5-32b": "repro_torch.configs.qwen15_32b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "whisper-base": "repro_torch.configs.whisper_base",
}


def list_archs():
    return sorted(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    """Full-size config for ``--arch <name>``."""
    mod = importlib.import_module(_REGISTRY[name])
    return mod.CONFIG


def cut_depth(cfg: ModelConfig, num_layers: Optional[int]) -> ModelConfig:
    """``cfg`` kept to its first ``num_layers`` layers, widths unchanged
    (None keeps every layer)."""
    if num_layers is None:
        return cfg
    if not 1 <= num_layers <= cfg.num_layers:
        raise ValueError(f"num_layers {num_layers} not in 1..{cfg.num_layers}")
    return dataclasses.replace(cfg, num_layers=num_layers)


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family variant (<= 2 layers, d_model <= 512, <= 4
    experts) for CPU smoke tests."""
    mod = importlib.import_module(_REGISTRY[name])
    return mod.SMOKE
