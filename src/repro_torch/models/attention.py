"""Attention pieces the serving engine calls (the reference's
``models/attention.py``): the spec, its scale, and the cache attention
with a full per-query mask, used by the bf16 escape hatch."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.layers import softcap

NEG_INF = -2.0e38


class AttnSpec(NamedTuple):
    """The fields of the reference's ``AttnSpec`` that cache attention
    reads (its chunking, windowing, scale-override and partial-rope fields
    come with the training and dense paths)."""

    num_heads: int
    num_kv_heads: int
    head_dim: int
    attn_softcap: float = 0.0
    rope_theta: float = 1e4


def _scale(spec: AttnSpec) -> float:
    return spec.head_dim ** -0.5


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
