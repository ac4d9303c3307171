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

from repro_torch.models import tp as tp_mod


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, *,
             offset: float = 1.0) -> torch.Tensor:
    """RMSNorm with (1 + scale) parameterization (gemma/llama style)."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (offset + scale.to(torch.float32))).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm by the reference's formula: the mean, then the mean of
    (x - mu)^2, both in float32, then scale and bias in float32 and a
    cast back to x's type."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)
            + bias.to(torch.float32)).to(dt)


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


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)) in x's dtype, rounded after each op: the
    reference's ``jax.nn.sigmoid`` as XLA runs it (in bf16,
    ``torch.sigmoid`` rounds once and differs from it in about a third of
    the values). x is clamped at -88 inside the exp, where the value is 0
    either way, so that no inf reaches the backward."""
    return 1 / (1 + torch.exp(-torch.clamp(x, min=-88.0)))


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), rounded after each op (``jax.nn.silu``)."""
    return x * sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) + log1p(exp(-|x|)), rounded after each op: the
    reference's ``jax.nn.softplus`` (``jnp.logaddexp(x, 0)``)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of ``jax.nn.gelu``, x * 0.5 * (1 + tanh(sqrt(2/pi) *
    (x + 0.044715 x^3))), rounded after each op in x's type, as XLA runs
    it (in bf16, ``F.gelu`` rounds once and differs from it in about 40%
    of the values)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))


# jax.nn.gelu is the tanh approximation by default
_ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
         "relu": F.relu}


def gated_mlp(p, x: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """p: {wi_gate (D,F), wi_up (D,F), wo (F,D)}; x (..., D)."""
    g = x @ p["wi_gate"]
    u = x @ p["wi_up"]
    h = (_ACTS[act](g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
    return h @ p["wo"]


def gated_mlp_tp(tp: "tp_mod.LayerTP", p, x: torch.Tensor, *,
                 act: str = "silu") -> torch.Tensor:
    """:func:`gated_mlp` on the local blocks of its leaves (the reference
    shards the hidden columns over ``model``, ``layers.py:141,149``): each
    projection by the dim its leaf is split on, the activation product on
    whichever block both halves share, the output replicated."""
    ax, d = tp.axis, tp.dims
    g, gs = tp_mod.linear(ax, x, p["wi_gate"], d["wi_gate"])
    u, us = tp_mod.linear(ax, x, p["wi_up"], d["wi_up"])
    if gs != us:
        g, u, gs = tp_mod.to_full(ax, g, gs), tp_mod.to_full(ax, u, us), False
    h = (_ACTS[act](g.to(torch.float32)) * u.to(torch.float32)).to(x.dtype)
    y, ys = tp_mod.linear(ax, h, p["wo"], d["wo"], x_split=gs)
    return tp_mod.to_full(ax, y, ys)


def dense_mlp(p, x: torch.Tensor, *, act: str = "gelu") -> torch.Tensor:
    """p: {wi (D,F), bi (F,), wo (F,D), bo (D,)} (whisper-style); the
    biases are added in x's type, as the reference adds its bf16 leaves."""
    h = {"gelu": gelu, "silu": silu, "relu": F.relu}[act](
        x @ p["wi"] + p["bi"])
    return h @ p["wo"] + p["bo"]


def dense_mlp_tp(tp: "tp_mod.LayerTP", p, x: torch.Tensor, *,
                 act: str = "gelu") -> torch.Tensor:
    """:func:`dense_mlp` on the local blocks of its leaves: ``wi`` and
    ``wo`` by the dims their leaves are split on, each bias taken to the
    block of the product it is added to, the output replicated."""
    ax, d = tp.axis, tp.dims
    h, hs = tp_mod.linear(ax, x, p["wi"], d["wi"])
    bi = (tp_mod.local_part(ax, p["bi"], d["bi"], 0) if hs
          else tp_mod.full(ax, p["bi"], d["bi"]))
    h = {"gelu": gelu, "silu": silu, "relu": F.relu}[act](h + bi)
    y, ys = tp_mod.linear(ax, h, p["wo"], d["wo"], x_split=hs)
    return tp_mod.to_full(ax, y, ys) + tp_mod.full(ax, p["bo"], d["bo"])


# ---------------------------------------------------------------------------
# init helpers (the port's own init; weights from a torch.Generator)
# ---------------------------------------------------------------------------

def dense_init(gen: Optional[torch.Generator], shape: Sequence[int],
               in_axis: int = 0, scale: float = 1.0) -> torch.Tensor:
    """Drawn on ``gen``'s device, then times ``scale``; ``gen=None`` gives
    a ``meta`` tensor: the shape, no values."""
    if gen is None:
        return torch.empty(tuple(shape), device="meta")
    fan_in = shape[in_axis]
    w = torch.randn(tuple(shape), generator=gen,
                    device=gen.device) / math.sqrt(fan_in)
    return w if scale == 1.0 else w * scale


def embed_init(gen: Optional[torch.Generator],
               shape: Sequence[int]) -> torch.Tensor:
    if gen is None:
        return torch.empty(tuple(shape), device="meta")
    return torch.randn(tuple(shape), generator=gen, device=gen.device) * 0.02
