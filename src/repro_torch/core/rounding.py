"""Rounding rules mapping values to level indices; the reference's
``core/rounding.py``.

* ``random_round`` — unbiased random rounding (Eq. 7): v in [b_{k-1}, b_k]
  goes up with probability (v − b_{k-1})/(b_k − b_{k-1}). Values outside the
  level range are clipped to the end levels first (for BinGrad-pb this clip
  IS the partially biased part of Eq. 14).
* ``nearest_round`` / ``threshold_round`` — deterministic rules (BinGrad-b
  Eq. 16, scaled SignSGD).

The interval search is a compare-accumulate over the s <= 17 levels and
lo/hi a one-hot select, as in the reference (an (nb, d, s) broadcast would
dominate peak memory at the training shape). Indices are int32, the
reference's dtype.

The reference draws uint32 threefry bits with ``jax.random.bits`` and maps
them to [0, 1) by ``float(bits) * 2**-32``. The port draws the same words
through :mod:`repro_torch.core.prng`.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import prng

INV_U32 = 1.0 / 4294967296.0  # 2**-32, exact in float32


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (any integer dtype; int32 bit patterns are read as
    unsigned) -> [0, 1) float32, the kernel's multiplicative map."""
    u = bits.to(torch.int64) & prng.MASK32
    return u.to(torch.float32) * INV_U32


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Counter-based uint32 bits for the rounding decision, as int32 bit
    patterns (``key`` may be a batch of keys; see ``prng.bits``)."""
    return prng.to_int32(prng.bits(key, shape))


def find_interval(bkt: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Index k of the lower level of v's interval: levels[k] <= v <
    levels[k+1]. bkt (nb, d), levels (nb, s) ascending -> (nb, d) int32 in
    [0, s-2]; values below levels[0] map to 0, above levels[-1] to s-2."""
    v = bkt.to(torch.float32)
    lv = levels.to(torch.float32)
    s = lv.shape[-1]
    k = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    for j in range(s):
        k += v >= lv[:, j:j + 1]
    return torch.clamp(k - 1, 0, s - 2)


def select_levels(levels: torch.Tensor, k: torch.Tensor):
    """(lo, hi) = (levels[k], levels[k+1]) by a one-hot accumulate, as the
    reference computes them (a level of -0.0 comes out as +0.0)."""
    lv = levels.to(torch.float32)
    s = lv.shape[-1]
    lo = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    hi = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    for j in range(s - 1):
        sel = (k == j).to(torch.float32)
        lo = lo + sel * lv[:, j:j + 1]
        hi = hi + sel * lv[:, j + 1:j + 2]
    return lo, hi


def _clip_to(bkt: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    return torch.minimum(torch.maximum(bkt.to(torch.float32), lo), hi)


def random_round(bkt: torch.Tensor, levels: torch.Tensor,
                 bits: torch.Tensor) -> torch.Tensor:
    """Unbiased random rounding to level indices: (nb, d) values + (nb, s)
    levels + (nb, d) uint32 words (int32 bit patterns) -> (nb, d) int32."""
    k = find_interval(bkt, levels)
    lo, hi = select_levels(levels, k)
    v = _clip_to(bkt, lo, hi)
    width = hi - lo
    p_up = torch.where(width > 0,
                       (v - lo) / torch.where(width > 0, width, 1.0), 0.0)
    return k + (uniform_from_bits(bits) < p_up).to(torch.int32)


def nearest_round(bkt: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Deterministic nearest-level rounding (midpoint thresholds)."""
    k = find_interval(bkt, levels)
    lo, hi = select_levels(levels, k)
    v = _clip_to(bkt, lo, hi)
    return k + (v - lo > hi - v).to(torch.int32)


def threshold_round(bkt: torch.Tensor, b0: torch.Tensor) -> torch.Tensor:
    """Binary deterministic rule (Eq. 16): idx = 1 iff v >= b0; b0 (nb, 1)."""
    return (bkt.to(torch.float32) >= b0).to(torch.int32)


def dequantize(idx: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Level indices back to values: (..., d) idx + (..., s) levels ->
    (..., d), a gather along the last axis as the reference's
    ``take_along_axis``: a negative index counts from the end, and one
    outside [-s, s) gives NaN."""
    s = levels.shape[-1]
    i = idx.to(torch.int64)
    i = torch.where(i < 0, i + s, i)
    ok = (i >= 0) & (i < s)
    val = torch.gather(levels, -1, torch.clamp(i, 0, s - 1))
    return torch.where(ok, val, torch.nan)
