"""Uniform randomness for the rounding rules.

The reference draws uint32 threefry bits with ``jax.random.bits`` and maps
them to [0, 1) by ``float(bits) * 2**-32`` (``core/rounding.py``). The
port draws the same words through :mod:`repro_torch.core.prng`.
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
