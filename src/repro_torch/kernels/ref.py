"""Plain PyTorch oracles: the ported part of the reference's
``kernels/ref.py``.

``encode_fused_ref`` / ``qdq_fused_ref`` are the multi-pass compositions
(σ-clip, count-and-gather random round, mask, pack or decode as separate
sweeps) that the one-pass kernels are held bit-identical against.
``dequant_avg_ref`` looks the levels up and averages over the workers:
it accumulates ``out = fma(val, f32(1/L), out)`` worker by worker, l =
0..L-1: the Pallas kernels' ``out += val * (1.0 / L)``
(``dequant_avg.py:35``, ``fused_decode.py:50-58``) in their order, with
the multiply and the add rounded once, as XLA contracts them when the
reference runs. So the port is exact for every L. (The reference's own
jnp oracle sums, then scales, and agrees with its kernels only when L is
a power of two: ``wire.py:25-29``; for such L, and for L = 1, fma and a
separate multiply and add agree, since the product is exact.)
``decode_fused_mean_ref`` / ``decode_fused_each_ref`` unpack, then look
up [and average] the same way; ``pack_ref`` / ``unpack_ref`` are the
wire packing of ``core.encode``.
``encode_bingrad_fused_ref`` is BinGrad-b's whole encode as separate
sweeps (σ-clip, the Eq. 17 level fit, threshold at the midpoint, pack);
``bingrad_pass_ref`` the conditional sums and the assignment at a given
b₀. ``kv_attend_block`` is THE definition of the serving engine's
dequant-attention math; ``fused_kv.decode_attend_plain`` is this
function, and the CUDA kernel is held float-close to it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import clipping, encode
from repro_torch.core import levels as L
from repro_torch.core.floats import fma_f32
from repro_torch.core.rounding import uniform_from_bits

NEG_INF = -2.0e38


def quant_rr_ref(v: torch.Tensor, levels: torch.Tensor,
                 bits: torch.Tensor) -> torch.Tensor:
    """Interval search + random round -> (nb, d) int64 level indices."""
    s = levels.shape[-1]
    v = v.to(torch.float32)
    lv = levels.to(torch.float32)
    k = (v[..., None] >= lv[:, None, :]).sum(-1) - 1
    k = torch.clamp(k, 0, s - 2)
    lo = torch.gather(lv, 1, k)
    hi = torch.gather(lv, 1, k + 1)
    vc = torch.minimum(torch.maximum(v, lo), hi)
    width = hi - lo
    p_up = torch.where(width > 0,
                       (vc - lo) / torch.where(width > 0, width, 1.0), 0.0)
    return k + (uniform_from_bits(bits) < p_up).to(torch.int64)


def _round_ref(v: torch.Tensor, levels: torch.Tensor,
               rbits: Optional[torch.Tensor], mask: torch.Tensor,
               clip_c: Optional[float], mode: str) -> torch.Tensor:
    """Shared clip+round stage: masked int64 level indices."""
    v = v.to(torch.float32)
    if clip_c is not None:
        v = clipping.sigma_clip(v, mask, clip_c)
    if mode == "rr":
        idx = quant_rr_ref(v, levels, rbits)
    elif mode == "bin":
        b0 = 0.5 * (levels[:, :1] + levels[:, 1:2])   # Eq. (17): midpoint
        idx = (v >= b0).to(torch.int64)
    elif mode == "sign":
        idx = (v >= 0.0).to(torch.int64)
    else:
        raise ValueError(f"unknown rounding mode {mode!r}")
    return torch.where(mask, idx, 0)


def encode_fused_ref(v: torch.Tensor, levels: torch.Tensor,
                     rbits: Optional[torch.Tensor], mask: torch.Tensor, *,
                     bits: int, clip_c: Optional[float] = None,
                     mode: str = "rr") -> torch.Tensor:
    """Oracle for ``fused_encode.encode_fused``: (nb, nw) int32 words."""
    return encode.pack(_round_ref(v, levels, rbits, mask, clip_c, mode), bits)


def qdq_fused_ref(v: torch.Tensor, levels: torch.Tensor,
                  rbits: Optional[torch.Tensor], mask: torch.Tensor, *,
                  clip_c: Optional[float] = None,
                  mode: str = "rr") -> torch.Tensor:
    """Oracle for ``fused_encode.qdq_fused``: (nb, d) f32 values, masked
    slots decoded to level 0."""
    idx = _round_ref(v, levels, rbits, mask, clip_c, mode)
    return torch.gather(levels.to(torch.float32), 1, idx)


def encode_bingrad_fused_ref(v: torch.Tensor, mask: torch.Tensor, *,
                             clip_c: Optional[float] = None,
                             lloyd_iters: int = 0):
    """Oracle for ``fused_bingrad.encode_bingrad_fused``: ((nb, ceil(d /
    32)) int32 words, (nb, 2) f32 levels)."""
    v = v.to(torch.float32)
    if clip_c is not None:
        v = clipping.sigma_clip(v, mask, clip_c)
    lv = L.bingrad_b_levels(v, mask, lloyd_iters=lloyd_iters)
    idx = _round_ref(v, lv, None, mask, None, "bin")
    return encode.pack(idx, 1), lv


def bingrad_pass_ref(v: torch.Tensor, b0: torch.Tensor, mask: torch.Tensor):
    """Oracle for ``bingrad.bingrad_pass``: ((nb, d) int32 assignment
    ``v >= b0`` on valid slots, (nb, 4) f32 ``[sum_lo, cnt_lo, sum_hi,
    cnt_hi]``)."""
    v = v.to(torch.float32)
    m = mask.to(torch.float32)
    ge = (v >= b0.to(torch.float32)).to(torch.float32)
    hi = ge * m
    lo = (1.0 - ge) * m
    idx = (hi > 0).to(torch.int32)
    part = torch.stack([(v * lo).sum(-1), lo.sum(-1), (v * hi).sum(-1),
                        hi.sum(-1)], dim=-1)
    return idx, part


def level_lookup(idx: torch.Tensor, lv: torch.Tensor) -> torch.Tensor:
    """(..., d) integer indices + (..., s) levels -> (..., d) f32 values;
    an index outside [0, s) decodes to 0, as the reference's one-hot
    decode does."""
    s = lv.shape[-1]
    idx = idx.to(torch.int64)
    val = torch.gather(lv.to(torch.float32), -1, torch.clamp(idx, 0, s - 1))
    return torch.where((idx >= 0) & (idx < s), val, 0.0)


def dequant_avg_ref(idx: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Oracle for ``dequant_avg.dequant_avg``: (L, nb, d) indices + (L, nb,
    s) levels -> (nb, d) f32 mean, accumulated as ``out = fma(val, f32(1/L),
    out)`` for l = 0..L-1 from +0."""
    L = idx.shape[0]
    out = torch.zeros(idx.shape[1:], dtype=torch.float32, device=idx.device)
    inv = torch.full_like(out, 1.0 / L)
    for l in range(L):
        out = fma_f32(level_lookup(idx[l], levels[l]), inv, out)
    return out


def pack_ref(idx: torch.Tensor, bits: int) -> torch.Tensor:
    """Oracle for ``bitpack.pack``: (nb, d) indices -> (nb, nw) int32
    words."""
    return encode.pack(idx, bits)


def unpack_ref(words: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    """Oracle for ``bitpack.unpack``: (nb, nw) int32 words -> (nb, d) int64
    indices."""
    return encode.unpack(words, bits, d)


def _unpack_stack(words: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    """(L, nb, nw) int32 words -> (L, nb, d) int64 indices."""
    L, nb, nw = words.shape
    return encode.unpack(words.reshape(L * nb, nw), bits, d).reshape(L, nb, d)


def decode_fused_mean_ref(words: torch.Tensor, levels: torch.Tensor, *,
                          d: int, bits: int) -> torch.Tensor:
    """(L, nb, nw) words + (L, nb, s) levels -> (nb, d) f32 mean,
    accumulated as ``out = fma(val, f32(1/L), out)`` for l = 0..L-1."""
    return dequant_avg_ref(_unpack_stack(words, bits, d), levels)


def decode_fused_each_ref(words: torch.Tensor, levels: torch.Tensor, *,
                          d: int, bits: int) -> torch.Tensor:
    """(L, nb, nw) words + (L, nb, s) levels -> (L, nb, d) f32 values."""
    return level_lookup(_unpack_stack(words, bits, d), levels)


# ---------------------------------------------------------------------------
# quantized-KV serving oracles (kernels/fused_kv.py)
# ---------------------------------------------------------------------------

def _kv_decode(w: torch.Tensor, lv: torch.Tensor, bits: int, s: int,
               d: int) -> torch.Tensor:
    """(..., C, nw) int32 packed words + (..., C, s) levels -> (..., C, d)
    f32 values: shift-mask unpack, then the level-table lookup (an index
    >= s decodes to 0, as the reference's one-hot decode does)."""
    lead = w.shape[:-1]
    idx = encode.unpack(w.reshape(-1, w.shape[-1]), bits, d)
    return level_lookup(idx.reshape(*lead, d), lv[..., :s])


def kv_attend_block(q: torch.Tensor, kw: torch.Tensor, klv: torch.Tensor,
                    vw: torch.Tensor, vlv: torch.Tensor, mask: torch.Tensor,
                    *, bits: int, kv_heads: int, scale: float,
                    softcap: float = 0.0) -> torch.Tensor:
    """Fused dequant-attention for one sequence or a batch of them on
    leading axes: q (..., T, H, hd) against a quantized KV context kw/vw
    (..., C, nw) + klv/vlv (..., C, s) with mask (..., T, C) -> (..., T, H,
    hd) f32. Masked scores are -2e38, so a fully masked row averages the
    C positions uniformly, as the reference does."""
    *lead, T, H, hd = q.shape
    d = kv_heads * hd
    s = klv.shape[-1]
    C = kw.shape[-2]
    k = _kv_decode(kw, klv, bits, s, d).reshape(*lead, C, kv_heads, hd)
    v = _kv_decode(vw, vlv, bits, s, d).reshape(*lead, C, kv_heads, hd)
    g = H // kv_heads
    qg = q.to(torch.float32).reshape(*lead, T, kv_heads, g, hd)
    sc = torch.einsum("...tkgh,...ckh->...kgtc", qg, k) * scale
    sc = sc.reshape(*lead, H, T, C)
    if softcap:
        sc = torch.tanh(sc / softcap) * softcap
    sc = torch.where(mask.unsqueeze(-3), sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)                         # (..., H, T, C)
    o = torch.einsum("...kgtc,...ckh->...tkgh",
                     p.reshape(*lead, kv_heads, g, T, C), v)
    return o.reshape(*lead, T, H, hd)


def kv_attend_ref(q: torch.Tensor, kw: torch.Tensor, klv: torch.Tensor,
                  vw: torch.Tensor, vlv: torch.Tensor, mask: torch.Tensor,
                  *, bits: int, kv_heads: int, scale: float,
                  softcap: float = 0.0) -> torch.Tensor:
    """Oracle for ``fused_kv.decode_attend``: q (B, T, H, hd), kw/vw
    (B, C, nw), klv/vlv (B, C, s), mask (B, T, C) -> (B, T, H, hd) f32."""
    return kv_attend_block(q, kw, klv, vw, vlv, mask.to(torch.bool),
                           bits=bits, kv_heads=kv_heads, scale=scale,
                           softcap=softcap)
