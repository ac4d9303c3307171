"""Fused one-pass ENCODE: clip -> interval search -> round -> mask -> pack,
and QDQ: the same clip/round stage decoded in-register.

Port of the reference's Pallas kernels ``kernels/fused_encode.py:
encode_fused`` (``pl.pallas_call`` at line 255, body ``_encode_kernel``,
``_clip_round``, ``_pack_words``) and ``qdq_fused`` (line 283, body
``_qdq_kernel``, the error-feedback residual path). The CUDA kernels are
in ``csrc/encode_fused.cu``; :func:`encode_fused_plain` and
:func:`qdq_fused_plain` are their plain PyTorch versions, the same
arithmetic term for term, so each pair is bit-equal.

Rounding modes:
    "rr"    unbiased random rounding (Eq. 7) on precomputed threefry
            uint32 bits: idx = k + (bits * 2**-32 < (v - lo) / (hi - lo)).
    "bin"   BinGrad-b threshold at the level midpoint (Eq. 17).
    "sign"  scaled SignSGD threshold at 0 (Eq. 13).

The σ-clip limit is a per-row reduction computed once outside the kernel
(:func:`clip_limit`); the kernel applies a single clip against it.
Words are int32 tensors holding uint32 bit patterns (see ``core.encode``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import clipping, encode
from repro_torch.core.rounding import uniform_from_bits
from repro_torch.kernels import build

MODES = ("rr", "bin", "sign")
MAX_LEVELS = 17          # the kernel's level-table capacity (s <= 17)

#: the encode kernel's blocking (``csrc/encode_fused.cu``): words a warp
#: packs (one a lane), most warps a block
TILE_WORDS = 32
MAX_WARPS = 8
#: an H100 SXM's streaming multiprocessors
SM_COUNT = 132


def encode_grid(nb: int, d: int, bits: int):
    """(warps a block, blocks) of the encode launch. A warp packs a tile
    of TILE_WORDS words of a row; a block takes up to MAX_WARPS tiles of
    one row once that still gives every SM two blocks of MAX_WARPS warps,
    else one, so that a small call spreads over as many blocks as it has
    tiles. The serving decode's 16 rows of 768 at 4 bits: 48 one-warp
    blocks; the training buffer's 66,058 rows of 2048 at 4 bits: one
    block of eight warps a row."""
    tiles = -(-encode.packed_words(d, bits) // TILE_WORDS)
    warps = 1
    if nb * tiles >= 2 * SM_COUNT * MAX_WARPS:
        warps = min(MAX_WARPS, tiles)
    return warps, nb * -(-tiles // warps)


def clip_limit(v: torch.Tensor, mask: Optional[torch.Tensor],
               clip_c: Optional[float]) -> Optional[torch.Tensor]:
    """Per-bucket TernGrad clip limit c·σ as an (nb, 1) f32 tensor (None
    when clipping is off) from ``clipping.masked_moments``. Float-close
    to the reference's, not bit-equal: its row sums add in another order."""
    if clip_c is None:
        return None
    v = v.to(torch.float32)
    m = torch.ones_like(v, dtype=torch.bool) if mask is None else mask
    return clip_c * clipping.masked_moments(v, m)[1]


def _clip_round(s: int, mode: str, v: torch.Tensor, lv: torch.Tensor,
                m: Optional[torch.Tensor], u: Optional[torch.Tensor],
                lim: Optional[torch.Tensor]) -> torch.Tensor:
    """clip -> round -> mask on (nb, d) f32 values with (nb, s) levels and
    (nb, 1) limits; the reference's ``_clip_round`` term for term (the
    interval search and the lo/hi selection share one sweep of running
    selects over the ascending level table). -> (nb, d) int64 indices."""
    if lim is not None:
        v = torch.minimum(torch.maximum(v, -lim), lim)
    if mode == "rr":
        k = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
        lo = lv[:, 0:1].expand_as(v)
        hi = lv[:, 1:2].expand_as(v)
        ge_prev = None
        for j in range(s):
            ge = v >= lv[:, j:j + 1]
            k = k + ge.to(torch.int64)
            if 1 <= j <= s - 2:
                lo = torch.where(ge, lv[:, j:j + 1], lo)
            if j >= 2:
                hi = torch.where(ge_prev, lv[:, j:j + 1], hi)
            ge_prev = ge
        k = torch.clamp(k - 1, 0, s - 2)
        vc = torch.minimum(torch.maximum(v, lo), hi)
        width = hi - lo
        p_up = torch.where(width > 0,
                           (vc - lo) / torch.where(width > 0, width, 1.0),
                           0.0)
        idx = k + (u < p_up).to(torch.int64)
    elif mode == "bin":
        thr = 0.5 * (lv[:, 0:1] + lv[:, 1:2])
        idx = (v >= thr).to(torch.int64)
    elif mode == "sign":
        idx = (v >= 0.0).to(torch.int64)
    else:
        raise ValueError(f"unknown rounding mode {mode!r}")
    if m is None:
        return idx
    return torch.where(m, idx, 0)


def _check(v, levels, rbits, mask, lim, bits, mode):
    if mode not in MODES:
        raise ValueError(f"unknown rounding mode {mode!r}")
    if not 1 <= bits <= 5:
        raise ValueError(f"bits must lie in 1..5, got {bits}")
    if v.dim() != 2 or levels.dim() != 2 or levels.shape[0] != v.shape[0]:
        raise ValueError(f"v (nb, d) and levels (nb, s) expected, got "
                         f"{tuple(v.shape)} and {tuple(levels.shape)}")
    s = levels.shape[1]
    if not 2 <= s <= min(MAX_LEVELS, 2 ** bits):
        raise ValueError(f"{s} levels do not fit {bits}-bit indices")
    if mode == "rr" and (rbits is None or rbits.shape != v.shape):
        raise ValueError("mode 'rr' needs (nb, d) rounding bits")
    if mask is not None and (mask.shape != v.shape
                             or mask.dtype != torch.bool):
        raise ValueError("mask must be a bool tensor shaped like v")
    if lim is not None and lim.shape != (v.shape[0], 1):
        raise ValueError("lim must be (nb, 1)")


def _indices(v, levels, rbits, mask, lim, bits, mode):
    """The shared clip/round/mask stage of both plain versions -> ((nb, d)
    int64 level indices, f32 levels)."""
    _check(v, levels, rbits, mask, lim, bits, mode)
    u = uniform_from_bits(rbits) if mode == "rr" else None
    lv = levels.to(torch.float32)
    lim32 = None if lim is None else lim.to(torch.float32)
    return _clip_round(levels.shape[1], mode, v.to(torch.float32), lv, mask,
                       u, lim32), lv


def encode_fused_plain(v: torch.Tensor, levels: torch.Tensor,
                       rbits: Optional[torch.Tensor],
                       mask: Optional[torch.Tensor],
                       lim: Optional[torch.Tensor], *, bits: int,
                       mode: str = "rr") -> torch.Tensor:
    """Plain PyTorch version of the kernel: (nb, d) values + (nb, s)
    levels [+ (nb, d) bits] [+ (nb, d) bool mask] [+ (nb, 1) limit] ->
    (nb, ceil(d / (32 // bits))) int32 words. ``mask=None`` means every
    slot is valid."""
    idx, _ = _indices(v, levels, rbits, mask, lim, bits, mode)
    return encode.pack(idx, bits)


def qdq_fused_plain(v: torch.Tensor, levels: torch.Tensor,
                    rbits: Optional[torch.Tensor],
                    mask: Optional[torch.Tensor],
                    lim: Optional[torch.Tensor], *,
                    mode: str = "rr") -> torch.Tensor:
    """Plain PyTorch version of the qdq kernel: the inputs of
    :func:`encode_fused_plain` -> (nb, d) f32, each slot the level its
    index names (a masked slot decodes to level 0)."""
    idx, lv = _indices(v, levels, rbits, mask, lim,
                       encode.bits_for_levels(levels.shape[1]), mode)
    return torch.gather(lv, 1, idx)


_MODE_CODES = {"rr": 0, "bin": 1, "sign": 2}
#: repro_encode_fused(v, levels, rbits, mask, lim, out, nb, d, s, bits,
#:                    mode, warps, stream)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
#: repro_qdq_fused(v, levels, rbits, mask, lim, out, nb, d, s, mode, stream)
_QDQ_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p])


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_cuda(kernel, v, levels, rbits, mask, lim):
    build.check_cuda(kernel, v=v, levels=levels, rbits=rbits, mask=mask,
                     lim=lim)
    for name, t, dts in (("v", v, (torch.float32,)),
                         ("levels", levels, (torch.float32,)),
                         ("lim", lim, (torch.float32,)),
                         ("rbits", rbits, (torch.int32, torch.uint32))):
        if t is not None and t.dtype not in dts:
            raise TypeError(f"{kernel}: {name} must be {dts}, "
                            f"got {t.dtype}")


def encode_fused_cuda(v: torch.Tensor, levels: torch.Tensor,
                      rbits: Optional[torch.Tensor],
                      mask: Optional[torch.Tensor],
                      lim: Optional[torch.Tensor], *, bits: int,
                      mode: str = "rr") -> torch.Tensor:
    """Launch ``csrc/encode_fused.cu`` on the current stream; same contract
    as :func:`encode_fused_plain`. Every tensor must lie on one CUDA device
    and be contiguous: v/levels/lim float32, rbits int32 or uint32, mask
    bool."""
    _check(v, levels, rbits, mask, lim, bits, mode)
    _check_cuda("encode_fused", v, levels, rbits, mask, lim)
    nb, d = v.shape
    nw = encode.packed_words(d, bits)
    out = torch.empty((nb, nw), dtype=torch.int32, device=v.device)
    if nb:
        launch = build.function("encode_fused", "repro_encode_fused",
                                _ARGTYPES)
        launch(v.data_ptr(), levels.data_ptr(),
               _ptr(rbits if mode == "rr" else None), _ptr(mask), _ptr(lim),
               out.data_ptr(), nb, d, levels.shape[1], bits,
               _MODE_CODES[mode], encode_grid(nb, d, bits)[0],
               torch.cuda.current_stream().cuda_stream)
        encode_fused_cuda.launches += 1
    return out


encode_fused_cuda.launches = 0


def qdq_fused_cuda(v: torch.Tensor, levels: torch.Tensor,
                   rbits: Optional[torch.Tensor],
                   mask: Optional[torch.Tensor],
                   lim: Optional[torch.Tensor], *,
                   mode: str = "rr") -> torch.Tensor:
    """Launch the qdq kernel of ``csrc/encode_fused.cu`` on the current
    stream; same contract as :func:`qdq_fused_plain` and the same input
    types as :func:`encode_fused_cuda`."""
    s = levels.shape[1]
    _check(v, levels, rbits, mask, lim, encode.bits_for_levels(s), mode)
    _check_cuda("qdq_fused", v, levels, rbits, mask, lim)
    nb, d = v.shape
    out = torch.empty((nb, d), dtype=torch.float32, device=v.device)
    if nb:
        launch = build.function("encode_fused", "repro_qdq_fused",
                                _QDQ_ARGTYPES)
        launch(v.data_ptr(), levels.data_ptr(),
               _ptr(rbits if mode == "rr" else None), _ptr(mask), _ptr(lim),
               out.data_ptr(), nb, d, s, _MODE_CODES[mode],
               torch.cuda.current_stream().cuda_stream)
        qdq_fused_cuda.launches += 1
    return out


qdq_fused_cuda.launches = 0
