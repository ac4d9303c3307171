"""Shared neural building blocks (the reference's ``models/layers.py``, the
parts the serving engine calls).

Mixed precision follows the reference: norms and rotary embeddings compute
in float32 and cast back to the input's type; the gated MLP's activation
product is formed in float32 and rounded once, as XLA does when it fuses
the elementwise ops.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, *,
             offset: float = 1.0) -> torch.Tensor:
    """RMSNorm with (1 + scale) parameterization (gemma/llama style)."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (offset + scale.to(torch.float32))).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x (..., S, H, hd), positions (..., S) -> rotated x (split halves)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)       # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# jax.nn.gelu is the tanh approximation by default
_ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
         "relu": F.relu}


def gated_mlp(p, x: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """p: {wi_gate (D,F), wi_up (D,F), wo (F,D)}; x (..., D)."""
    g = x @ p["wi_gate"]
    u = x @ p["wi_up"]
    h = (_ACTS[act](g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# init helpers (the port's own init; weights from a torch.Generator)
# ---------------------------------------------------------------------------

def dense_init(gen: Optional[torch.Generator], shape: Sequence[int],
               in_axis: int = 0) -> torch.Tensor:
    """Drawn on ``gen``'s device; ``gen=None`` gives a ``meta`` tensor:
    the shape, no values."""
    if gen is None:
        return torch.empty(tuple(shape), device="meta")
    fan_in = shape[in_axis]
    return torch.randn(tuple(shape), generator=gen,
                       device=gen.device) / math.sqrt(fan_in)


def embed_init(gen: Optional[torch.Generator],
               shape: Sequence[int]) -> torch.Tensor:
    if gen is None:
        return torch.empty(tuple(shape), device="meta")
    return torch.randn(tuple(shape), generator=gen, device=gen.device) * 0.02
