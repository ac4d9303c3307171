"""Threefry-2x32 counter-based bits, bit-equal to the reference's
``jax.random`` stream.

The reference draws every rounding decision from ``jax.random.key`` /
``fold_in`` / ``bits`` (``core/rounding.py``, ``serve/kv_cache.py``), in
the mode the installed jax runs: ``jax_threefry_partitionable=True``
(``jax/_src/prng.py``: ``threefry_seed``, ``_threefry2x32_lowering``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable``). This module
reproduces those words exactly so that the port rounds the same values the
same way.

A key is an ``(..., 2)`` int64 tensor holding two uint32 words; every
function broadcasts over the leading axes, so one call derives the keys
of many rows at once. All arithmetic runs in int64 masked to 32 bits:
PyTorch has no shifts, adds or compares for ``torch.uint32`` on the CPU.
This is plain tensor code, not a kernel: the reference draws the bits
outside any Pallas kernel too.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

IntLike = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The 20-round Threefry-2x32 block on int64 tensors holding uint32
    words (broadcast together) -> (y1, y2), the unrolled form of jax's
    ``_threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & MASK32
    y = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y) & MASK32
            y = _rotl(y, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        y = (y + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, y


def _u32(x: IntLike, lo: int, device) -> torch.Tensor:
    """A Python int (checked against [lo, 2**32)) or an integer tensor
    (wrapped mod 2**32, as jax converts int32 arrays; no check, so no host
    sync) -> int64 tensor of uint32 values."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & MASK32
    if not lo <= int(x) <= MASK32:
        raise ValueError(f"{x!r} is out of the range [{lo}, 2**32)")
    return torch.tensor(int(x) & MASK32, dtype=torch.int64, device=device)


def key(seed: IntLike, *, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for 32-bit seeds: ``(0, seed mod
    2**32)``. A tensor of seeds gives a batch of keys ``(..., 2)``."""
    s = _u32(seed, -2 ** 31, device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(k: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in``: hash the uint32 ``data`` (broadcast over the
    key batch) into each key: ``threefry2x32(key, (0, data))``."""
    d = _u32(data, 0, k.device)
    y1, y2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def bits(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` -> int64 tensor of uint32
    values, shape ``k.shape[:-1] + shape``. The partitionable stream
    hashes the (hi, lo) words of each element's row-major index and XORs
    the two outputs."""
    shape = tuple(int(n) for n in shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    lead = k.shape[:-1]
    k1 = k[..., 0].reshape(*lead, 1)
    k2 = k[..., 1].reshape(*lead, 1)
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & MASK32)
    return (y1 ^ y2).reshape(*lead, *shape)


def to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> int32 tensor with the same bit
    patterns (the port's storage type for uint32 words)."""
    return (words - ((words >> 31) & 1) * (1 << 32)).to(torch.int32)
