"""TernGrad-style gradient clipping (paper §5): clip(v) = sign(v)·min(|v|, c·σ).

σ² is the per-bucket gradient variance; c is a positive constant (paper uses
2.5, also sweeps 1.7 in Table 4). Applied *before* level fitting/quantization.
"""
from __future__ import annotations

import torch


def masked_moments(bkt: torch.Tensor, mask: torch.Tensor):
    """Per-bucket (mean, std) over valid elements. Returns ((nb,1), (nb,1))."""
    m = mask.to(bkt.dtype)
    cnt = torch.clamp(m.sum(dim=-1, keepdim=True), min=1.0)
    mean = (bkt * m).sum(dim=-1, keepdim=True) / cnt
    var = (((bkt - mean) ** 2) * m).sum(dim=-1, keepdim=True) / cnt
    return mean, torch.sqrt(var)


def sigma_clip(bkt: torch.Tensor, mask: torch.Tensor, c: float) -> torch.Tensor:
    """Clip each element to ±c·σ of its bucket (σ computed around 0-mean,
    matching TernGrad which clips magnitudes)."""
    _, std = masked_moments(bkt, mask)
    lim = c * std
    return torch.minimum(torch.maximum(bkt, -lim), lim)
