"""Bucket-based gradient layout (paper §5: bucket size d, default 512/2048);
the reference's ``core/buckets.py``.

The whole (flattened) gradient is split into buckets of fixed length ``d``;
each bucket is quantized independently with its own levels. The final,
possibly ragged bucket is handled with an explicit validity mask so padding
never contaminates the fitted levels.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def num_buckets(n: int, d: int) -> int:
    return -(-n // d)


def to_buckets(flat: torch.Tensor, d: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n,) -> ((nb, d) values, (nb, d) bool mask). Padding is 0 but
    masked."""
    if flat.dim() != 1:
        raise ValueError(f"to_buckets expects flat input, got "
                         f"{tuple(flat.shape)}")
    n = flat.shape[0]
    nb = num_buckets(n, d)
    vals = F.pad(flat, (0, nb * d - n))
    mask = torch.arange(nb * d, device=flat.device) < n
    return vals.reshape(nb, d), mask.reshape(nb, d)


def from_buckets(bkt: torch.Tensor, n: int) -> torch.Tensor:
    """(nb, d) -> (n,) dropping padding."""
    return bkt.reshape(-1)[:n]
