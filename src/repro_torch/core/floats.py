"""Float32 arithmetic as XLA rounds it.

XLA contracts ``a * b + c`` into one fused multiply-add where it can (the
reference's mean decode ``out += val * (1.0 / L)``, ``jax.random.uniform``'s
``floats * (maxval - minval) + minval``). PyTorch's eager ops round the
product and the sum separately, so the port computes those expressions
with :func:`fma_f32`.
"""
from __future__ import annotations

import torch


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` (one rounding), elementwise.

    The product of two floats is exact in float64; the float64 sum ``s``
    is rounded, and its exact error ``e`` comes from TwoSum. Rounding
    ``s`` to float32 is then correct except when ``s`` lies exactly
    halfway between two floats and ``e`` breaks the tie: that case moves
    to the neighbour on ``e``'s side."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    r = s.to(torch.float32)
    diff = s - r.to(torch.float64)
    away = torch.where(diff > 0, torch.inf, -torch.inf).to(torch.float32)
    n = torch.nextafter(r, away)
    tie = (diff != 0) & (s == (r.to(torch.float64) + n.to(torch.float64))
                         / 2)
    return torch.where(tie & (e != 0) & ((e > 0) == (diff > 0)), n, r)
