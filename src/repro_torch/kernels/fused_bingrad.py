"""Fully fused BinGrad-b ENCODE: b₀ search + conditional-mean levels +
threshold + 1-bit pack, one launch.

Port of the reference's Pallas kernel ``kernels/fused_bingrad.py:
encode_bingrad_fused`` (``pl.pallas_call`` at line 102, body
``_bingrad_encode_kernel``). BinGrad-b's level fit is moments only —
b₀ = mean(G), then the conditional means below/above b₀ (Eq. 17),
optionally iterated ``lloyd_iters`` times to the 2-means fixed point — so
the whole scheme fuses: one sweep computes the level table (b₋₁, b₁),
thresholds at its midpoint and packs 32 elements per uint32 word. The
CUDA kernel is in ``csrc/encode_bingrad.cu``;
:func:`encode_bingrad_fused_plain` is its plain PyTorch version, the
reference's formulas term for term.

Parity: the levels are row sums divided by counts, so they are
float-close across summation orders (kernel vs plain version, card vs
CPU, port vs XLA). The words are exact GIVEN the levels: each is the
threshold ``v >= 0.5 * (b₋₁ + b₁)`` of the (clipped) values. On values
whose every partial sum is exact in float32 (multiples of 1/64 in
[-1, 1], d <= 2048) everything is bit-equal.

The optional σ-clip limit is computed once outside the kernel
(``fused_encode.clip_limit``) and rides in as an (nb, 1) side input, as
in the reference. ``mask=None`` marks every slot valid (the serving
path's KV rows): the fit then counts all d slots.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import encode
from repro_torch.core import levels as L
from repro_torch.kernels import build
from repro_torch.kernels.fused_encode import _clip_round

#: the kernel keeps a row in registers, 8 values a thread, at most 1024
#: threads a block
MAX_D = 8 * 1024


def _check(v, mask, lim, lloyd_iters):
    if v.dim() != 2:
        raise ValueError(f"v must be (nb, d), got {tuple(v.shape)}")
    if mask is not None and (mask.shape != v.shape
                             or mask.dtype != torch.bool):
        raise ValueError("mask must be a bool tensor shaped like v")
    if lim is not None and lim.shape != (v.shape[0], 1):
        raise ValueError("lim must be (nb, 1)")
    if lloyd_iters < 0:
        raise ValueError(f"lloyd_iters must be >= 0, got {lloyd_iters}")


def encode_bingrad_fused_plain(v: torch.Tensor,
                               mask: Optional[torch.Tensor],
                               lim: Optional[torch.Tensor], *,
                               lloyd_iters: int = 0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (nb, d) values [+ (nb, d) bool
    mask] [+ (nb, 1) clip limit] -> ((nb, ceil(d / 32)) int32 words,
    (nb, 2) f32 levels (b₋₁, b₁)). A masked slot packs index 0."""
    _check(v, mask, lim, lloyd_iters)
    v = v.to(torch.float32)
    if lim is not None:
        lim = lim.to(torch.float32)
        v = torch.minimum(torch.maximum(v, -lim), lim)
    m = torch.ones_like(v, dtype=torch.bool) if mask is None else mask
    lv = L.bingrad_b_levels(v, m, lloyd_iters=lloyd_iters)
    idx = _clip_round(2, "bin", v, lv, mask, None, None)
    return encode.pack(idx, 1), lv


#: repro_encode_bingrad(v, mask, lim, words, levels, nb, d, lloyd_iters,
#:                      stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def encode_bingrad_fused_cuda(v: torch.Tensor,
                              mask: Optional[torch.Tensor],
                              lim: Optional[torch.Tensor], *,
                              lloyd_iters: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/encode_bingrad.cu`` on the current stream; same
    contract as :func:`encode_bingrad_fused_plain`. Every tensor must lie
    on one CUDA device and be contiguous: v/lim float32, mask bool;
    d <= MAX_D."""
    _check(v, mask, lim, lloyd_iters)
    build.check_cuda("encode_bingrad_fused", v=v, mask=mask, lim=lim)
    for name, t in (("v", v), ("lim", lim)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"encode_bingrad_fused: {name} must be float32, "
                            f"got {t.dtype}")
    nb, d = v.shape
    if d > MAX_D:
        raise ValueError(f"encode_bingrad_fused: d = {d} > {MAX_D}")
    words = torch.empty((nb, encode.packed_words(d, 1)), dtype=torch.int32,
                        device=v.device)
    levels = torch.empty((nb, 2), dtype=torch.float32, device=v.device)
    if nb:
        launch = build.function("encode_bingrad", "repro_encode_bingrad",
                                _ARGTYPES)
        launch(v.data_ptr(), None if mask is None else mask.data_ptr(),
               None if lim is None else lim.data_ptr(), words.data_ptr(),
               levels.data_ptr(), nb, d, lloyd_iters,
               torch.cuda.current_stream().cuda_stream)
        encode_bingrad_fused_cuda.launches += 1
    return words, levels


encode_bingrad_fused_cuda.launches = 0
