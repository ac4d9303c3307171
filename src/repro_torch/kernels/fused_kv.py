"""Kernels of the quantized-KV serving engine.

    append_kv      quantize a batch of new tokens' K/V rows to wire format:
                   K and V rows are stacked into one (2R, d) bucket matrix
                   and pushed through ``wire.encode``, so the level fit
                   plus ONE ``encode_fused`` launch covers both.
    decode_attend  fused dequant-attention over the packed context; port of
                   the reference's Pallas kernel ``kernels/fused_kv.py:
                   decode_attend`` (``pl.pallas_call`` at line 70). The
                   CUDA kernel is ``csrc/decode_attend.cu``; its plain
                   version is ``ref.kv_attend_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

#: repro_decode_attend(q, kw, klv, vw, vlv, mask, out, B, T, H, KV, hd, C,
#:                     nw, s, bits, scale, softcap, S, stream)
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
             + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
#: the head dims the kernel is built for (``csrc/decode_attend.cu``): a
#: call runs the least that holds its hd, which may be any of 1..256
PADDED_HEAD_DIMS = (32, 64, 128, 256)
MAX_HEAD_DIM = PADDED_HEAD_DIMS[-1]

#: the kernel's blocking (``csrc/decode_attend.cu``): context tokens per
#: tile, warps and query rows per block, most context splits (the portable
#: cluster size)
TILE = 32
WARPS = 4
ROWS_PER_BLOCK = 4
MAX_SPLITS = 8
#: an H100 SXM's streaming multiprocessors
SM_COUNT = 132


def padded_head_dim(hd: int) -> int:
    """The kernel instantiation a head dim runs: the least of
    PADDED_HEAD_DIMS that holds it. Raises for hd outside 1..256."""
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attend: head_dim {hd} not in "
                         f"1..{MAX_HEAD_DIM}")
    return next(p for p in PADDED_HEAD_DIMS if hd <= p)


def split_count(B: int, T: int, H: int, KV: int, C: int) -> int:
    """Context splits S of each (sequence, KV head, row group): the least
    power of two that gives at least two blocks per SM, capped so that
    every warp of a split has a tile (S <= tiles / WARPS) and at
    MAX_SPLITS. lm-100m's decode (B 8, T 1, H = KV = 12, C 512): 96 row
    groups, S = 4; its prefill chunk (T 64): 192, S = 2."""
    groups = B * KV * -(-T * (H // KV) // ROWS_PER_BLOCK)
    tiles = -(-C // TILE)
    cap = max(1, min(MAX_SPLITS, tiles // WARPS))
    S = 1
    while S < cap and groups * S < 2 * SM_COUNT:
        S *= 2
    return min(S, cap)


def walked_tiles(mask: torch.Tensor, heads: int,
                 kv_heads: int) -> torch.Tensor:
    """The kernel's skip rule: mask (B, T, C) -> bool (B, groups, tiles),
    which tiles of the context the block of each row group walks (the same
    for every KV head). A block's rows are r = t * g + i (query position t,
    head i of the KV head's group), ROWS_PER_BLOCK at a time; it walks a
    tile that one of its rows admits, and every tile if one of its rows
    admits no position at all."""
    B, T, C = mask.shape
    g = heads // kv_heads
    n_tiles = -(-C // TILE)
    groups = -(-T * g // ROWS_PER_BLOCK)
    r = torch.arange(groups * ROWS_PER_BLOCK, device=mask.device)
    active = (r < T * g).reshape(groups, ROWS_PER_BLOCK)
    t = torch.clamp(r // g, max=T - 1)
    m = torch.nn.functional.pad(mask.to(torch.bool), (0, n_tiles * TILE - C))
    per_tile = m.reshape(B, T, n_tiles, TILE).any(-1)[:, t]   # (B, R, tiles)
    per_tile = per_tile.reshape(B, groups, ROWS_PER_BLOCK, n_tiles)
    per_tile = per_tile & active[None, :, :, None]
    empty = (~mask.to(torch.bool).any(-1))[:, t].reshape(
        B, groups, ROWS_PER_BLOCK) & active[None]
    return per_tile.any(2) | empty.any(2, keepdim=True)


def _check(q, kw, klv, vw, vlv, mask, bits, kv_heads):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, T, H, hd), got {tuple(q.shape)}")
    B, T, H, hd = q.shape
    if H % kv_heads:
        raise ValueError(f"{H} query heads do not group over {kv_heads} "
                         f"KV heads")
    C, nw = kw.shape[1], kw.shape[2]
    s = klv.shape[-1]
    for name, t, shape in (("kw", kw, (B, C, nw)), ("vw", vw, (B, C, nw)),
                           ("klv", klv, (B, C, s)), ("vlv", vlv, (B, C, s)),
                           ("mask", mask, (B, T, C))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if nw * (32 // bits) < kv_heads * hd:
        raise ValueError(f"{nw} words of {bits}-bit indices cannot hold "
                         f"d = {kv_heads * hd}")


def decode_attend_plain(q, kw, klv, vw, vlv, mask, *, bits: int,
                        kv_heads: int, scale: float,
                        softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version: q (B, T, H, hd) + packed kw/vw (B, C, nw) +
    klv/vlv (B, C, s) + mask (B, T, C) -> (B, T, H, hd) f32."""
    _check(q, kw, klv, vw, vlv, mask, bits, kv_heads)
    return _ref.kv_attend_ref(q, kw, klv, vw, vlv, mask, bits=bits,
                              kv_heads=kv_heads, scale=scale,
                              softcap=softcap)


def decode_attend_cuda(q, kw, klv, vw, vlv, mask, *, bits: int,
                       kv_heads: int, scale: float,
                       softcap: float = 0.0) -> torch.Tensor:
    """Launch ``csrc/decode_attend.cu`` on the current stream; same
    contract as :func:`decode_attend_plain`. q/klv/vlv float32, kw/vw
    int32 or uint32, mask bool, all contiguous on one CUDA device."""
    _check(q, kw, klv, vw, vlv, mask, bits, kv_heads)
    build.check_cuda("decode_attend", q=q, kw=kw, klv=klv, vw=vw, vlv=vlv,
                     mask=mask)
    for name, t, dts in (("q", q, (torch.float32,)),
                         ("klv", klv, (torch.float32,)),
                         ("vlv", vlv, (torch.float32,)),
                         ("kw", kw, (torch.int32, torch.uint32)),
                         ("vw", vw, (torch.int32, torch.uint32)),
                         ("mask", mask, (torch.bool,))):
        if t.dtype not in dts:
            raise TypeError(f"decode_attend: {name} must be {dts}, "
                            f"got {t.dtype}")
    B, T, H, hd = q.shape
    padded_head_dim(hd)
    C, nw = kw.shape[1], kw.shape[2]
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    launch = build.function("decode_attend", "repro_decode_attend",
                            _ARGTYPES)
    launch(q.data_ptr(), kw.data_ptr(), klv.data_ptr(), vw.data_ptr(),
           vlv.data_ptr(), mask.data_ptr(), out.data_ptr(), B, T, H,
           kv_heads, hd, C, nw, klv.shape[-1], bits, float(scale),
           float(softcap or 0.0), split_count(B, T, H, kv_heads, C),
           torch.cuda.current_stream().cuda_stream)
    decode_attend_cuda.launches += 1
    return out


decode_attend_cuda.launches = 0


def append_kv(qz, k_rows: torch.Tensor, v_rows: torch.Tensor,
              rbits: Optional[torch.Tensor]):
    """Quantize R new tokens' K and V rows to wire format with one encode
    launch: k_rows/v_rows (R, d) f32 (d = kv_heads * head_dim, one bucket
    per token spanning all KV heads) -> (kw, klv, vw, vlv), words (R, nw)
    int32 and levels (R, s) f32.

    ``rbits`` is the caller's (2R, d) rounding stream for the random-round
    schemes, K rows first, then V rows, or None for deterministic modes.
    Every encode stage is independent per bucket row, so stacking K and V
    changes nothing about each row's bits."""
    from repro_torch.core.comm import wire

    if not wire._fused_mode(qz):
        raise ValueError(
            f"kv scheme {qz.method!r} has no fused one-pass encode; "
            f"supported: random-round schemes, bingrad-b, signsgd")
    R = k_rows.shape[0]
    stacked = torch.cat([k_rows.to(torch.float32),
                         v_rows.to(torch.float32)], dim=0)
    # every slot of a KV row is valid: no mask reaches the kernel
    words, levels = wire.encode(qz, stacked, None, None, rbits=rbits)
    return words[:R], levels[:R], words[R:], levels[R:]
