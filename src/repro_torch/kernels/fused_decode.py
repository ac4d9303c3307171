"""Fused one-pass DECODE: unpack -> level lookup [-> mean over workers].

Port of the reference's Pallas kernels ``kernels/fused_decode.py``:
``decode_fused_mean`` (``pl.pallas_call`` at line 84, the server side of
Algorithm 2's phase 1) and ``decode_fused_each`` (line 107, phase 2's
broadcast decode). The CUDA kernels are ``csrc/decode_fused.cu``; the
plain PyTorch versions are ``ref.decode_fused_mean_ref`` /
``ref.decode_fused_each_ref``. Both are exact: the lookup equals the
reference's one-hot sum by value (only the sign of a zero can differ),
and the mean accumulates ``fma(val, f32(1/L), out)`` worker by worker in
the Pallas kernel's order (as the reference computes it when it runs), so
the kernel is bit-equal to its plain version, and both to the reference,
for every worker count L.

Words are int32 tensors holding uint32 bit patterns (``core.encode``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import encode
from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

MAX_LEVELS = 17
#: the mean kernel holds its rows' L level tables in shared memory: at
#: most a block's 227 KB, and rows per block are chosen to stay within the
#: 48 KB a launch gets without opting in
SMEM_BYTES = 227 * 1024
MEAN_SMEM_BUDGET = 48 * 1024
#: most bucket rows a block of the mean kernel takes
MEAN_MAX_ROWS = 8

#: repro_decode_fused_mean(words, levels, out, L, nb, nw, d, s, bits, R,
#:                         inv, stream)
_MEAN_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                  + [ctypes.c_float, ctypes.c_void_p])
#: repro_decode_fused_each(words, levels, out, L, nb, nw, d, s, bits, stream)
_EACH_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p]


def mean_rows(L: int, s: int) -> int:
    """Bucket rows R a block of the mean kernel takes: as many as keep
    the rows' L level tables of s floats within MEAN_SMEM_BUDGET, between
    1 and MEAN_MAX_ROWS. R = 8 up to L * s = 1536 (L = 90 at s = 17); a
    single row needs more than the budget from L * s = 12,289, and the
    launch then opts in to more shared memory."""
    return max(1, min(MEAN_MAX_ROWS, MEAN_SMEM_BUDGET // (L * s * 4)))


def _check(words: torch.Tensor, levels: torch.Tensor, d: int, bits: int):
    if not 1 <= bits <= 5:
        raise ValueError(f"bits must lie in 1..5, got {bits}")
    if words.dim() != 3 or levels.dim() != 3 \
            or levels.shape[:2] != words.shape[:2]:
        raise ValueError(f"words (L, nb, nw) and levels (L, nb, s) expected, "
                         f"got {tuple(words.shape)} and "
                         f"{tuple(levels.shape)}")
    s = levels.shape[2]
    if not 1 <= s <= min(MAX_LEVELS, 2 ** bits):
        raise ValueError(f"{s} levels do not fit {bits}-bit indices")
    if words.shape[2] != encode.packed_words(d, bits):
        raise ValueError(f"{words.shape[2]} words do not hold d = {d} at "
                         f"{bits} bits")
    if words.shape[0] < 1:
        raise ValueError("no worker payloads to decode")


def decode_fused_mean_plain(words, levels, *, d: int, bits: int):
    """Plain PyTorch version: (L, nb, nw) int32 words + (L, nb, s) levels
    -> (nb, d) f32 mean over the L workers."""
    _check(words, levels, d, bits)
    return _ref.decode_fused_mean_ref(words, levels, d=d, bits=bits)


def decode_fused_each_plain(words, levels, *, d: int, bits: int):
    """Plain PyTorch version: -> (L, nb, d) f32, no averaging."""
    _check(words, levels, d, bits)
    return _ref.decode_fused_each_ref(words, levels, d=d, bits=bits)


def _check_cuda(kernel, words, levels):
    build.check_cuda(kernel, words=words, levels=levels)
    if words.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"{kernel}: words must be int32 or uint32, got "
                        f"{words.dtype}")
    if levels.dtype != torch.float32:
        raise TypeError(f"{kernel}: levels must be float32, got "
                        f"{levels.dtype}")


def decode_fused_mean_cuda(words, levels, *, d: int, bits: int):
    """Launch ``csrc/decode_fused.cu``'s mean kernel on the current stream;
    same contract as :func:`decode_fused_mean_plain`."""
    _check(words, levels, d, bits)
    _check_cuda("decode_fused_mean", words, levels)
    L, nb, nw = words.shape
    s = levels.shape[2]
    if L * s * 4 > SMEM_BYTES:
        raise ValueError(f"decode_fused_mean: {L} workers' level tables do "
                         f"not fit one block's shared memory")
    out = torch.empty((nb, d), dtype=torch.float32, device=words.device)
    if nb:
        launch = build.function("decode_fused", "repro_decode_fused_mean",
                                _MEAN_ARGTYPES)
        launch(words.data_ptr(), levels.data_ptr(), out.data_ptr(), L, nb,
               nw, d, s, bits, mean_rows(L, s), float(np.float32(1.0 / L)),
               torch.cuda.current_stream().cuda_stream)
        decode_fused_mean_cuda.launches += 1
    return out


def decode_fused_each_cuda(words, levels, *, d: int, bits: int):
    """Launch ``csrc/decode_fused.cu``'s per-worker kernel on the current
    stream; same contract as :func:`decode_fused_each_plain`."""
    _check(words, levels, d, bits)
    _check_cuda("decode_fused_each", words, levels)
    L, nb, nw = words.shape
    out = torch.empty((L, nb, d), dtype=torch.float32, device=words.device)
    if nb:
        launch = build.function("decode_fused", "repro_decode_fused_each",
                                _EACH_ARGTYPES)
        launch(words.data_ptr(), levels.data_ptr(), out.data_ptr(), L, nb,
               nw, d, levels.shape[2], bits,
               torch.cuda.current_stream().cuda_stream)
        decode_fused_each_cuda.launches += 1
    return out


decode_fused_mean_cuda.launches = 0
decode_fused_each_cuda.launches = 0
