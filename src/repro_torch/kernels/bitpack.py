"""Multi-pass PACK / UNPACK: level indices <-> uint32 wire words.

Port of the reference's Pallas kernels ``kernels/bitpack.py``: ``pack``
(``pl.pallas_call`` at line 46, body ``_pack_kernel``) and ``unpack``
(line 65, body ``_unpack_kernel``). ``epw = 32 // bits`` consecutive
indices go into each word, element ``e`` of a row at shift ``bits * (e %
epw)`` of word ``e // epw``; pack adds the shifted fields (disjoint for
indices below 2^bits; otherwise the sum wraps mod 2^32, as the
reference's uint32 sum does), and the ragged tail packs index 0. The CUDA
kernels are in ``csrc/multipass.cu``; :func:`pack_plain` and
:func:`unpack_plain` are their plain PyTorch versions (``ref.pack_ref``
/ ``ref.unpack_ref``, the packing of ``core.encode``).
All are exact.

Words are int32 tensors holding uint32 bit patterns (``core.encode``);
indices are int32, the reference's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import encode
from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

#: repro_pack(idx, out, nb, d, nw, bits, stream) and
#: repro_unpack(words, out, nb, d, nw, bits, stream)
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _check_bits(bits: int) -> None:
    if not 1 <= bits <= 5:
        raise ValueError(f"bits must lie in 1..5, got {bits}")


def _check_pack(idx: torch.Tensor, bits: int) -> None:
    _check_bits(bits)
    if idx.dim() != 2:
        raise ValueError(f"idx must be (nb, d), got {tuple(idx.shape)}")


def _check_unpack(words: torch.Tensor, bits: int, d: int) -> None:
    _check_bits(bits)
    if words.dim() != 2:
        raise ValueError(f"words must be (nb, nw), got "
                         f"{tuple(words.shape)}")
    if words.shape[1] != encode.packed_words(d, bits):
        raise ValueError(f"{words.shape[1]} words do not hold d = {d} at "
                         f"{bits} bits")


def pack_plain(idx: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain PyTorch version: (nb, d) integer indices -> (nb, ceil(d / (32
    // bits))) int32 words."""
    _check_pack(idx, bits)
    return _ref.pack_ref(idx, bits)


def unpack_plain(words: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    """Plain PyTorch version: (nb, nw) int32 words -> (nb, d) int32
    indices."""
    _check_unpack(words, bits, d)
    return _ref.unpack_ref(words, bits, d).to(torch.int32)


def _launch(symbol: str, src: torch.Tensor, out: torch.Tensor, nb: int,
            d: int, nw: int, bits: int) -> None:
    launch = build.function("multipass", symbol, _ARGTYPES)
    launch(src.data_ptr(), out.data_ptr(), nb, d, nw, bits,
           torch.cuda.current_stream().cuda_stream)


def pack_cuda(idx: torch.Tensor, bits: int) -> torch.Tensor:
    """Launch ``csrc/multipass.cu``'s pack kernel on the current stream;
    same contract as :func:`pack_plain`. idx int32, contiguous, on the
    current CUDA device."""
    _check_pack(idx, bits)
    build.check_cuda("pack", idx=idx)
    if idx.dtype != torch.int32:
        raise TypeError(f"pack: idx must be int32, got {idx.dtype}")
    nb, d = idx.shape
    nw = encode.packed_words(d, bits)
    out = torch.empty((nb, nw), dtype=torch.int32, device=idx.device)
    if nb and d:
        _launch("repro_pack", idx, out, nb, d, nw, bits)
        pack_cuda.launches += 1
    return out


def unpack_cuda(words: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    """Launch ``csrc/multipass.cu``'s unpack kernel on the current stream;
    same contract as :func:`unpack_plain`. words int32 or uint32,
    contiguous, on the current CUDA device."""
    _check_unpack(words, bits, d)
    build.check_cuda("unpack", words=words)
    if words.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"unpack: words must be int32 or uint32, got "
                        f"{words.dtype}")
    nb, nw = words.shape
    out = torch.empty((nb, d), dtype=torch.int32, device=words.device)
    if nb and d:
        _launch("repro_unpack", words, out, nb, d, nw, bits)
        unpack_cuda.launches += 1
    return out


pack_cuda.launches = 0
unpack_cuda.launches = 0
