"""Wire encoding: bit-packing level indices into uint32 words.

s levels need ceil(log2(s)) bits per element; ``32 // bits`` indices go
into each word, element ``e`` of a row in word ``e // epw`` at shift
``bits * (e % epw)``, the ragged tail padded with index 0.

The port stores uint32 words as ``torch.int32`` tensors holding the same
bit patterns: PyTorch implements neither shifts nor ``index_put_`` for
``torch.uint32``. ``words.numpy().view(np.uint32)`` recovers the wire
words. Packing runs in int64 masked to 32 bits.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.prng import MASK32, to_int32


def bits_for_levels(s: int) -> int:
    return max(1, math.ceil(math.log2(s)))


def elems_per_word(bits: int) -> int:
    return 32 // bits


def packed_words(d: int, bits: int) -> int:
    epw = elems_per_word(bits)
    return -(-d // epw)


def pack(idx: torch.Tensor, bits: int) -> torch.Tensor:
    """(nb, d) integer indices in [0, 2^bits) -> (nb, nw) int32 words."""
    nb, d = idx.shape
    epw = elems_per_word(bits)
    nw = packed_words(d, bits)
    padded = torch.zeros((nb, nw * epw), dtype=torch.int64, device=idx.device)
    padded[:, :d] = idx.to(torch.int64)
    lanes = padded.reshape(nb, nw, epw)
    shifts = torch.arange(epw, dtype=torch.int64, device=idx.device) * bits
    # disjoint bit ranges: addition == bitwise OR
    return to_int32((lanes << shifts).sum(dim=-1))


def unpack(words: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    """(nb, nw) int32 words -> (nb, d) int64 indices."""
    nb, nw = words.shape
    epw = elems_per_word(bits)
    w = words.to(torch.int64) & MASK32
    shifts = torch.arange(epw, dtype=torch.int64, device=words.device) * bits
    lanes = (w[:, :, None] >> shifts) & (2 ** bits - 1)
    return lanes.reshape(nb, nw * epw)[:, :d]
