"""Threefry-2x32 counter-based bits, bit-equal to the reference's
``jax.random`` stream.

The reference draws every rounding decision from ``jax.random.key`` /
``fold_in`` / ``bits`` (``core/rounding.py``, ``serve/kv_cache.py``) and
its synthetic tokens from ``split`` / ``randint`` / ``uniform``
(``data/synthetic.py``), in the mode the installed jax runs:
``jax_threefry_partitionable=True`` (``jax/_src/prng.py``:
``threefry_seed``, ``_threefry2x32_lowering``, ``threefry_fold_in``,
``_threefry_random_bits_partitionable``, ``_threefry_split_foldlike``;
``jax/_src/random.py``: ``_randint``, ``_uniform``). This module
reproduces those words exactly so that the port rounds the same values the
same way and trains on the same tokens.

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

from repro_torch.core.floats import fma_f32

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

IntLike = Union[int, torch.Tensor]


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The 20-round Threefry-2x32 block on int64 tensors holding uint32
    words (broadcast together) -> (y1, y2), the unrolled form of jax's
    ``_threefry2x32_lowering``. The two state words are updated in place
    (one scratch buffer for the rotations): a draw of n words allocates
    three n-word tensors, not a hundred."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = torch.add(x1, ks[0]).bitwise_and_(MASK32)
    y = torch.add(x2, ks[1]).bitwise_and_(MASK32)
    x0, y = torch.broadcast_tensors(x0, y)
    x0, y = x0.contiguous(), y.contiguous()
    t = torch.empty_like(y)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(y).bitwise_and_(MASK32)
            # y = rotl(y, r) ^ x0
            torch.bitwise_left_shift(y, r, out=t)
            y.bitwise_right_shift_(32 - r).bitwise_or_(t)
            y.bitwise_and_(MASK32).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK32)
        y.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK32)
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


def _counts(k: torch.Tensor, shape: Sequence[int]):
    """(k1, k2, hi, lo): the key words broadcast against the (hi, lo)
    words of each element's row-major index (``iota_2x32_shape``)."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    lead = k.shape[:-1]
    return (k[..., 0].reshape(*lead, 1), k[..., 1].reshape(*lead, 1),
            idx >> 32, idx & MASK32)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)`` in the partitionable mode
    (``_threefry_split_foldlike``): key i is the threefry block of the
    index i, both output words kept -> ``k.shape[:-1] + (num, 2)``."""
    y1, y2 = threefry2x32(*_counts(k, (num,)))
    return torch.stack([y1, y2], dim=-1)


def bits(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` -> int64 tensor of uint32
    values, shape ``k.shape[:-1] + shape``. The partitionable stream
    hashes the (hi, lo) words of each element's row-major index and XORs
    the two outputs."""
    shape = tuple(int(n) for n in shape)
    y1, y2 = threefry2x32(*_counts(k, shape))
    return (y1 ^ y2).reshape(tuple(k.shape[:-1]) + shape)


def uniform(k: torch.Tensor, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``: the top
    23 bits of each word as the mantissa of a float in [1, 2), minus 1,
    scaled (one fused multiply-add, as XLA computes it), and floored at
    ``minval``."""
    b = bits(k, shape)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full_like(f, minval)
    hi = torch.full_like(f, maxval)
    return torch.maximum(lo, fma_f32(f, hi - lo, lo))


def randint(k: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` for int32 bounds:
    two bit streams from ``split(k)``, combined modulo the span through
    the multiplier ``(2**16 % span)**2 % span`` in uint32 arithmetic,
    wrapping where jax's does
    (``jax/_src/random.py: _randint``). -> int64 tensor."""
    if not (-2 ** 31 <= minval and maxval <= 2 ** 31 - 1):
        raise ValueError("randint takes int32 bounds")
    span = maxval - minval if maxval > minval else 1
    k1, k2 = split(k).unbind(dim=-2)
    hi, lo = bits(k1, shape), bits(k2, shape)
    mult = (((2 ** 16 % span) ** 2) & MASK32) % span   # uint32 product
    off = (((hi % span) * mult) & MASK32) + (lo % span)
    return minval + (off & MASK32) % span


def to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> int32 tensor with the same bit
    patterns (the port's storage type for uint32 words)."""
    return (words - ((words >> 31) & 1) * (1 << 32)).to(torch.int32)
