"""Per-layer parameters and the dense GQA attention layer: the pieces the
serving engine applies, the training forward ``apply_layer_train`` and
the dense ring-buffer decode (``init_layer_cache``,
``apply_layer_prefill_chunk``, ``apply_layer_decode``), as in the
reference's ``models/blocks.py``.

The ring-buffer cache of one layer is ``{"k", "v": (B, C, KV, hd) bf16,
"pos": (C,) int32}``: slot ``pos % C`` holds the token at absolute
position ``pos``, and ``pos`` is -1 where no token was written yet. A
sliding-window layer (``attn_local``) keeps C = min(max_len, window)
slots. The decode functions write the new rows into the cache in place
(the reference donates the cache through its jit) and return it."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (AttnSpec, chunked_attention,
                                         decode_attention,
                                         masked_decode_attention)
from repro_torch.models.layers import (apply_rope, dense_init, gated_mlp,
                                       rms_norm)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str            # attn | attn_local | mamba | rwkv
    moe: bool
    d_ff: int
    cross_attn: bool = False   # whisper decoder layers
    causal: bool = True


def attn_spec(cfg: ModelConfig, spec: LayerSpec) -> AttnSpec:
    local = spec.kind == "attn_local"
    theta = (cfg.rope_theta_local
             if (local and cfg.rope_theta_local) else cfg.rope_theta)
    return AttnSpec(
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        attn_softcap=cfg.attn_softcap,
        rope_theta=theta,
        causal=spec.causal,
        window=cfg.window if local else None,
        q_chunk=cfg.q_chunk,
        kv_chunk=cfg.kv_chunk,
    )


def check_dense_gqa(cfg: ModelConfig, spec: LayerSpec) -> None:
    """The port runs dense GQA attention layers with RMSNorm only."""
    if (spec.kind not in ("attn", "attn_local") or spec.moe or cfg.mla
            or cfg.norm != "rms" or spec.cross_attn):
        raise NotImplementedError(
            f"repro_torch ports dense GQA attention layers with RMSNorm "
            f"only (kind={spec.kind!r}, moe={spec.moe}, "
            f"mla={cfg.mla is not None}, norm={cfg.norm!r})")


def init_layer(cfg: ModelConfig, spec: LayerSpec,
               gen: torch.Generator) -> dict:
    """Float32 parameters of one dense GQA attention layer, in the
    reference's layout."""
    check_dense_gqa(cfg, spec)
    D, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, F = cfg.resolved_head_dim, spec.d_ff
    attn = {"wq": dense_init(gen, (D, H * hd)),
            "wk": dense_init(gen, (D, KV * hd)),
            "wv": dense_init(gen, (D, KV * hd)),
            "wo": dense_init(gen, (H * hd, D))}
    if cfg.qkv_bias:
        attn["bq"] = torch.zeros(H * hd)
        attn["bk"] = torch.zeros(KV * hd)
        attn["bv"] = torch.zeros(KV * hd)
    if cfg.qk_norm:
        attn["q_norm"] = torch.zeros(hd)
        attn["k_norm"] = torch.zeros(hd)
    return {
        "norm1": {"scale": torch.zeros(D)},
        "norm2": {"scale": torch.zeros(D)},
        "attn": attn,
        "ffn": {"wi_gate": dense_init(gen, (D, F)),
                "wi_up": dense_init(gen, (D, F)),
                "wo": dense_init(gen, (F, D))},
    }


def _apply_norm(cfg: ModelConfig, p, x):
    return rms_norm(x, p["scale"], cfg.norm_eps)


def _gqa_project(cfg: ModelConfig, p, x):
    B, S, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _ffn_train(cfg: ModelConfig, spec: LayerSpec, p, x):
    """Dense gated MLP. Returns (y, aux) like the reference."""
    return gated_mlp(p, x, act=cfg.mlp_act), 0.0


def _attn_block_train(cfg: ModelConfig, spec: LayerSpec, p, x):
    q, k, v = _gqa_project(cfg, p["attn"], x)
    o = chunked_attention(q, k, v, attn_spec(cfg, spec))
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ p["attn"]["wo"]


def apply_layer_train(cfg: ModelConfig, spec: LayerSpec, p, x):
    """x (B,S,D) -> (x', aux_loss): pre-norm attention, then the FFN."""
    check_dense_gqa(cfg, spec)
    h = x + _attn_block_train(cfg, spec, p, _apply_norm(cfg, p["norm1"], x))
    y, aux = _ffn_train(cfg, spec, p["ffn"], _apply_norm(cfg, p["norm2"], h))
    return h + y, aux


# ---------------------------------------------------------------------------
# dense ring-buffer decode
# ---------------------------------------------------------------------------

def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype=torch.bfloat16,
                     device=None) -> dict:
    """One GQA attention layer's empty ring-buffer cache."""
    check_dense_gqa(cfg, spec)
    C = min(max_len, cfg.window) if spec.kind == "attn_local" else max_len
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {"k": torch.zeros((batch, C, KV, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, C, KV, hd), dtype=dtype, device=device),
            "pos": torch.full((C,), -1, dtype=torch.int32, device=device)}


def _attend_out(cfg, spec, p, x, o):
    """Attention output projection, the residual, then the FFN block."""
    B, T = x.shape[:2]
    h = x + o.reshape(B, T, -1) @ p["attn"]["wo"]
    y, _ = _ffn_train(cfg, spec, p["ffn"], _apply_norm(cfg, p["norm2"], h))
    return h + y


def apply_layer_prefill_chunk(cfg: ModelConfig, spec: LayerSpec, p, x,
                              cache: dict, start: int):
    """Chunked-prefill twin of :func:`apply_layer_decode`: x (B, T, D),
    ``start`` the absolute position of x[:, 0] -> (x', cache). Writes the
    chunk's K/V at slots start..start+T-1 (the caller guarantees
    start + T <= C: no ring wrap) and attends with an explicit causal ∧
    valid ∧ window mask through the decode's score -> softmax -> PV
    composition; at T == 1 it computes exactly the decode step."""
    check_dense_gqa(cfg, spec)
    B, T = x.shape[:2]
    asp = attn_spec(cfg, spec)
    q, k, v = _gqa_project(cfg, p["attn"], _apply_norm(cfg, p["norm1"], x))
    qpos = start + torch.arange(T, dtype=torch.int32, device=x.device)
    posv = qpos[None].expand(B, T)
    q = apply_rope(q, posv, asp.rope_theta)
    k = apply_rope(k, posv, asp.rope_theta)
    cache["k"][:, start:start + T] = k.to(cache["k"].dtype)
    cache["v"][:, start:start + T] = v.to(cache["v"].dtype)
    cache["pos"][start:start + T] = qpos
    posa = cache["pos"]
    mask = ((posa >= 0)[None, None, :]
            & (posa[None, None, :] <= posv[:, :, None]))     # (B, T, C)
    if spec.kind == "attn_local" and cfg.window:
        mask &= (posv[:, :, None] - posa[None, None, :]) < cfg.window
    o = masked_decode_attention(q, cache["k"], cache["v"], mask, asp)
    return _attend_out(cfg, spec, p, x, o), cache


def apply_layer_decode(cfg: ModelConfig, spec: LayerSpec, p, x,
                       cache: dict, pos: int):
    """x (B, 1, D) at absolute position ``pos`` -> (x', cache): the new
    K/V go to ring slot ``pos % C``; a slot is attended once written, and
    on an ``attn_local`` layer only within the window."""
    check_dense_gqa(cfg, spec)
    B = x.shape[0]
    asp = attn_spec(cfg, spec)
    q, k, v = _gqa_project(cfg, p["attn"], _apply_norm(cfg, p["norm1"], x))
    C = cache["k"].shape[1]
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, asp.rope_theta)
    k = apply_rope(k, posv, asp.rope_theta)
    slot = pos % C
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = pos
    posa = cache["pos"]
    valid = posa >= 0
    if spec.kind == "attn_local" and cfg.window:
        valid &= (pos - posa) < cfg.window
    o = decode_attention(q, cache["k"], cache["v"],
                         valid[None].expand(B, C), asp)
    return _attend_out(cfg, spec, p, x, o), cache
