"""Float32 arithmetic as XLA rounds it.

XLA contracts ``a * b + c`` into one fused multiply-add where it can (the
reference's mean decode ``out += val * (1.0 / L)``, ``jax.random.uniform``'s
``floats * (maxval - minval) + minval``, the SGD and outer optimizer
steps). PyTorch's eager ops round the product and the sum separately, so
the port computes those expressions with :func:`fma_f32`.
"""
from __future__ import annotations

from typing import Union

import torch

Operand = Union[torch.Tensor, float]


def _f64(x: Operand) -> Operand:
    """A tensor in float64, or a Python float rounded to float32 first."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return float(torch.tensor(x, dtype=torch.float32))


def _round_once(p: torch.Tensor, c64: torch.Tensor) -> torch.Tensor:
    """float32 of the exact ``p + c64`` (both float64, ``p`` an exact
    product): the float64 sum ``s`` is rounded, and its exact error ``e``
    comes from TwoSum. Rounding ``s`` to float32 is then correct except
    when ``s`` lies exactly halfway between two floats and ``e`` breaks
    the tie: that case moves to the neighbour on ``e``'s side."""
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


def fma_f32(a: torch.Tensor, b: Operand, c: Operand) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` (one rounding), elementwise;
    ``b`` and ``c`` are tensors that broadcast with ``a`` or Python floats
    (taken as float32).

    The product of two floats is exact in float64, so ``s = a * b + c`` in
    float64 is rounded once, and rounding ``s`` to float32 gives the
    correctly rounded result unless ``s`` landed exactly halfway between
    two float32 values (a second rounding can only err there) or lies in
    float32's subnormal range: only those elements, if any, take the exact
    tie-break of :func:`_round_once`."""
    p = a.to(torch.float64) * _f64(b)
    c64 = _f64(c)
    s = p + c64
    shape = s.shape
    s = s.reshape(-1)
    r = s.to(torch.float32)
    halfway = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    tiny = (s.abs() < 2.0 ** -126) & (s != 0)
    idx = (halfway | tiny).nonzero().squeeze(1)
    if idx.numel():
        pp = p.expand(shape).reshape(-1)[idx]
        cc = (c64.expand(shape).reshape(-1)[idx]
              if isinstance(c64, torch.Tensor) else torch.full_like(pp, c64))
        r[idx] = _round_once(pp, cc)
    return r.reshape(shape)
