"""Device dispatch for the kernels: a CPU tensor takes the kernel's plain
PyTorch version, a CUDA tensor launches the CUDA kernel (which raises on
what it cannot take). There is no environment switch and no fallback."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import bingrad as _bin
from repro_torch.kernels import bitpack as _pack
from repro_torch.kernels import dequant_avg as _dqa
from repro_torch.kernels import fused_bingrad as _fbin
from repro_torch.kernels import fused_decode as _fdec
from repro_torch.kernels import fused_encode as _fenc
from repro_torch.kernels import fused_kv as _fkv
from repro_torch.kernels import quant_rr as _qrr


def launch_counters() -> dict:
    """Every kernel's CUDA wrapper by kernel name; each counts its own
    launches in its ``launches`` attribute (set it to 0 to start a count)."""
    return {"encode_fused": _fenc.encode_fused_cuda,
            "decode_attend": _fkv.decode_attend_cuda,
            "qdq_fused": _fenc.qdq_fused_cuda,
            "decode_fused_mean": _fdec.decode_fused_mean_cuda,
            "decode_fused_each": _fdec.decode_fused_each_cuda,
            "encode_bingrad_fused": _fbin.encode_bingrad_fused_cuda,
            "bingrad_pass": _bin.bingrad_pass_cuda,
            "quant_rr": _qrr.quant_rr_cuda, "pack": _pack.pack_cuda,
            "unpack": _pack.unpack_cuda,
            "dequant_avg": _dqa.dequant_avg_cuda}


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def encode_fused(v, levels, rbits, mask, *, bits: int,
                 clip_c: Optional[float] = None, mode: str = "rr"):
    """σ-clip + round + mask + bit-pack: (nb, d) values -> (nb, nw) int32
    wire words. ``rbits`` is the threefry stream for mode 'rr' (None for
    the deterministic modes); ``mask=None`` marks every slot valid."""
    lim = _fenc.clip_limit(v, mask, clip_c)
    fn = _fenc.encode_fused_cuda if _on_cuda(v) else _fenc.encode_fused_plain
    return fn(v, levels, rbits, mask, lim, bits=bits, mode=mode)


def qdq_fused(v, levels, rbits, mask, *, clip_c: Optional[float] = None,
              mode: str = "rr"):
    """σ-clip + round + mask + in-register decode: (nb, d) values -> (nb, d)
    dequantized f32 (the error-feedback residual path)."""
    lim = _fenc.clip_limit(v, mask, clip_c)
    fn = _fenc.qdq_fused_cuda if _on_cuda(v) else _fenc.qdq_fused_plain
    return fn(v, levels, rbits, mask, lim, mode=mode)


def encode_bingrad(v, mask, *, clip_c: Optional[float] = None,
                   lloyd_iters: int = 0):
    """Fully fused BinGrad-b: σ-clip, b₀ search, conditional-mean levels,
    threshold and 1-bit pack -> ((nb, ceil(d / 32)) int32 words, (nb, 2)
    f32 levels). ``mask=None`` marks every slot valid."""
    lim = _fenc.clip_limit(v, mask, clip_c)
    fn = (_fbin.encode_bingrad_fused_cuda if _on_cuda(v)
          else _fbin.encode_bingrad_fused_plain)
    return fn(v, mask, lim, lloyd_iters=lloyd_iters)


def bingrad_pass(v, b0, mask):
    """Conditional sums below / above b₀ plus the assignment: (nb, d)
    values + (nb, 1) b₀ + (nb, d) mask -> ((nb, d) int32, (nb, 4) f32
    ``[sum_lo, cnt_lo, sum_hi, cnt_hi]``)."""
    fn = _bin.bingrad_pass_cuda if _on_cuda(v) else _bin.bingrad_pass_plain
    return fn(v, b0, mask)


def decode_fused_mean(words, levels, d: int, *, bits: int):
    """Unpack + dequantize + average L workers' payloads: (L, nb, nw) +
    (L, nb, s) -> (nb, d) f32 mean."""
    fn = (_fdec.decode_fused_mean_cuda if _on_cuda(words)
          else _fdec.decode_fused_mean_plain)
    return fn(words, levels, d=d, bits=bits)


def decode_fused_each(words, levels, d: int, *, bits: int):
    """Unpack + dequantize, no averaging: (L, nb, nw) + (L, nb, s) ->
    (L, nb, d) f32."""
    fn = (_fdec.decode_fused_each_cuda if _on_cuda(words)
          else _fdec.decode_fused_each_plain)
    return fn(words, levels, d=d, bits=bits)


def decode_attend(q, kw, klv, vw, vlv, mask, *, bits: int, kv_heads: int,
                  scale: float, softcap: float = 0.0):
    """Fused dequant-attention: q (B, T, H, hd) + packed kw/vw (B, C, nw) +
    klv/vlv (B, C, s) + mask (B, T, C) -> (B, T, H, hd) f32."""
    fn = (_fkv.decode_attend_cuda if _on_cuda(q)
          else _fkv.decode_attend_plain)
    return fn(q, kw, klv, vw, vlv, mask, bits=bits, kv_heads=kv_heads,
              scale=scale, softcap=softcap)


# ---------------------------------------------------------------------------
# the multi-pass pipeline (wire.encode_multipass / decode_*_multipass)
# ---------------------------------------------------------------------------

def quant_rr(v, levels, bits):
    """Interval search + unbiased random rounding: (nb, d) values + (nb, s)
    levels + (nb, d) uint32 rounding words -> (nb, d) int32 indices."""
    fn = _qrr.quant_rr_cuda if _on_cuda(v) else _qrr.quant_rr_plain
    return fn(v, levels, bits)


def pack(idx, bits: int):
    """(nb, d) int32 indices -> (nb, ceil(d / (32 // bits))) int32 words."""
    fn = _pack.pack_cuda if _on_cuda(idx) else _pack.pack_plain
    return fn(idx, bits)


def unpack(words, bits: int, d: int):
    """(nb, nw) int32 words -> (nb, d) int32 indices."""
    fn = _pack.unpack_cuda if _on_cuda(words) else _pack.unpack_plain
    return fn(words, bits, d)


def dequant_avg(idx, levels):
    """Level lookup + mean over L workers: (L, nb, d) int32 indices + (L,
    nb, s) levels -> (nb, d) f32."""
    fn = _dqa.dequant_avg_cuda if _on_cuda(idx) else _dqa.dequant_avg_plain
    return fn(idx, levels)
