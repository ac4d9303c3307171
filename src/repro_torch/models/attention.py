"""Attention (the reference's ``models/attention.py``): the spec, its
scale and rope policy (none for cross-attention; MLA rotates only the
last ``rope_dims``), the chunked online-softmax attention of the
training forward (causal or not, full or sliding-window, the latter as
the reference's banded scan; queries and keys of different lengths for
cross-attention), and the cache attention with a full per-query mask,
used by the serving engine's bf16 escape hatch and by the dense
ring-buffer decode (``decode_attention``). Plain PyTorch: the reference
computes all of it outside any Pallas kernel."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import tp as tp_mod
from repro_torch.models.layers import apply_rope, softcap

NEG_INF = -2.0e38


class AttnSpec(NamedTuple):
    """The fields of the reference's ``AttnSpec`` that the ported paths
    read (all but its ``probs_bf16``)."""

    num_heads: int
    num_kv_heads: int
    head_dim: int
    attn_softcap: float = 0.0
    rope_theta: float = 1e4
    causal: bool = True
    window: Optional[int] = None     # None = full; int = sliding window
    q_chunk: int = 512
    kv_chunk: int = 512
    scale: Optional[float] = None    # default hd^-0.5
    use_rope: bool = True            # False: cross-attention
    rope_dims: int = 0               # >0: rotate only the LAST rope_dims
                                     # (MLA: the nope dims stay unrotated)


def _scale(spec: AttnSpec) -> float:
    return spec.scale if spec.scale is not None else spec.head_dim ** -0.5


def spec_rope(x, positions, spec: AttnSpec):
    """The spec's rope on (..., S, H, hd): none without ``use_rope``, the
    whole head, or with ``rope_dims`` only its last ``rope_dims``
    dimensions."""
    if not spec.use_rope:
        return x
    if spec.rope_dims:
        keep, rot = x[..., :-spec.rope_dims], x[..., -spec.rope_dims:]
        return torch.cat([keep, apply_rope(rot, positions,
                                           spec.rope_theta)], dim=-1)
    return apply_rope(x, positions, spec.rope_theta)


def _chunk_scores(q, k, spec: AttnSpec):
    """q (B, qc, H, hd), k (B, kc, KV, hd) -> logits (B, H, qc, kc) f32."""
    B, qc, H, hd = q.shape
    kv = k.shape[2]
    g = H // kv
    qg = q.reshape(B, qc, kv, g, hd)
    s = torch.einsum("bqkgh,bckh->bkgqc", qg.to(torch.float32),
                     k.to(torch.float32))
    s = s * _scale(spec)
    if spec.attn_softcap:
        s = softcap(s, spec.attn_softcap)
    return s.reshape(B, H, qc, k.shape[1])


def _chunk_out(p, v, B, H, qc):
    """p (B, H, qc, kc) f32, v (B, kc, KV, hd) -> (B, qc, H, hd) f32."""
    kv = v.shape[2]
    g = H // kv
    pk = p.reshape(B, kv, g, qc, v.shape[1])
    o = torch.einsum("bkgqc,bckh->bqkgh", pk, v.to(torch.float32))
    return o.reshape(B, qc, H, -1)


def chunked_attention(q, k, v, spec: AttnSpec):
    """Training attention: q (B,S,H,hd), k/v (B,T,KV,hd), rope not yet
    applied -> (B,S,H,hd) in q's type. The reference's flash-style loop:
    query chunks outside, key/value chunks inside with a running (max,
    sum, acc) in float32, so no (S, T) score matrix exists. Queries sit
    at positions 0..S-1 and keys at 0..T-1 (T != S for cross-attention,
    which is not causal). Rope rotates each position independently, so it
    is applied to the whole q and k once instead of per chunk.

    The reference pads T up to a multiple of kv_chunk and masks the
    padded keys; here the last chunk is simply shorter (a fully masked
    tail adds nothing, so only the order of the sums differs).

    A causal sliding-window spec takes the reference's banded scan: each
    query chunk visits at most ceil(window / kv_chunk) + 1 KV chunks,
    walking backwards from the diagonal, so work and memory scale with
    S·window, not S²; it needs q_chunk == kv_chunk, as the reference
    asserts. The reference's clamped duplicate visits and the chunks above
    the diagonal are fully masked, and a fully masked chunk leaves (max,
    sum, acc) exactly as they were, so they are skipped here."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    qpos = torch.arange(S, device=q.device)
    kpos = torch.arange(T, device=q.device)
    q = spec_rope(q, qpos, spec)
    k = spec_rope(k, kpos, spec)
    qc, kc = min(spec.q_chunk, S), min(spec.kv_chunk, T)
    banded = spec.window is not None and spec.causal and S == T
    if banded and qc != kc:
        raise ValueError("banded sliding-window attention needs equal "
                         f"q/kv chunk sizes (got {qc}, {kc})")
    outs = []
    for q0 in range(0, S, qc):
        qb = q[:, q0:q0 + qc]
        n = qb.shape[1]
        m = torch.full((B, H, n), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, n), dtype=torch.float32, device=q.device)
        o = torch.zeros((B, H, n, hd), dtype=torch.float32, device=q.device)
        if banded:                           # the diagonal, then backwards
            w_chunks = -(-spec.window // kc)
            k_starts = [q0 - r * kc for r in range(w_chunks + 1)
                        if q0 - r * kc >= 0]
        else:
            k_starts = range(0, T, kc)
        for k0 in k_starts:
            if spec.causal and k0 > q0 + n - 1:
                break                        # every score masked: no-op
            kb, vb = k[:, k0:k0 + kc], v[:, k0:k0 + kc]
            s = _chunk_scores(qb, kb, spec)              # (B,H,n,kc)
            qp, kp = qpos[q0:q0 + n, None], kpos[None, k0:k0 + kc]
            mask = qp >= kp if spec.causal else None
            if spec.window is not None:
                near = qp - kp < spec.window
                mask = near if mask is None else mask & near
            if mask is not None:
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            if mask is not None:
                p = torch.where(mask, p, 0.0)
            corr = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_safe))
            l = l * corr + p.sum(dim=-1)
            o = (o * corr[..., None]
                 + _chunk_out(p, vb, B, H, n).transpose(1, 2))
            m = m_new
        out = o / torch.clamp(l, min=1e-30)[..., None]   # (B,H,n,hd)
        outs.append(out.transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)


def masked_decode_attention(q, k_cache, v_cache, mask, spec: AttnSpec):
    """Cache attention with a full per-query mask: q (B,T,H,hd) (rope
    already applied); k_cache/v_cache (B,C,KV,hd); mask (B,T,C) bool
    (causal ∧ valid ∧ window, caller-built) -> (B,T,H,hd) in q's type."""
    B, T, H, hd = q.shape
    s = _chunk_scores(q, k_cache, spec)                 # (B,H,T,C)
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _chunk_out(p, v_cache, B, H, T)                 # (B,T,H,hd)
    return o.to(q.dtype)


def decode_attention(q, k_cache, v_cache, valid_mask, spec: AttnSpec):
    """One-token attention: q (B,1,H,hd) (rope already applied);
    k_cache/v_cache (B,C,KV,hd) (rope applied at insert); valid_mask
    (B,C) bool -> (B,1,H,hd): :func:`masked_decode_attention` at T == 1,
    the same computation."""
    return masked_decode_attention(q, k_cache, v_cache,
                                   valid_mask[:, None, :], spec)


def split_attention(q, k_cache, v_cache, mask, spec: AttnSpec,
                    ax: "tp_mod.Axis"):
    """:func:`masked_decode_attention` over a cache whose slots are split
    over ``ax`` (flash-decoding; the reference's sequence-sharded cache,
    whose combine XLA derives): q (B,T,H,hd) the same on every rank, this
    rank's slots in k_cache / v_cache (B,C_loc,KV,hd) and mask (B,T,C_loc).
    Each rank attends its slots to a partial (max, sum, PV) in float32;
    the partials are gathered (one all-reduce) and combined, rescaled to
    the largest max, in axis order. A rank whose slots are all masked
    adds nothing."""
    B, T, H, hd = q.shape
    s = _chunk_scores(q, k_cache, spec)                 # (B,H,T,C_loc)
    s = torch.where(mask[:, None], s, NEG_INF)
    m = s.amax(dim=-1)                                  # (B,H,T)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.where(mask[:, None], torch.exp(s - m_safe[..., None]), 0.0)
    o = _chunk_out(p, v_cache, B, H, T)                 # (B,T,H,hd) f32
    ms, ls, os_ = tp_mod.gather_blocks(ax, [m, p.sum(dim=-1), o])
    top = ms.amax(dim=0)
    top = torch.where(top <= NEG_INF / 2, 0.0, top)
    w = torch.where(ms <= NEG_INF / 2, 0.0, torch.exp(ms - top))  # (n,B,H,T)
    den = (ls * w).sum(dim=0)                           # (B,H,T)
    num = (os_ * w.permute(0, 1, 3, 2)[..., None]).sum(dim=0)
    out = num / torch.clamp(den, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)
