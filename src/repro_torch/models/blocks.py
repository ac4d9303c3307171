"""Per-layer parameters and the layers: attention (GQA or MLA, each with
a dense or a Mixture-of-Experts FFN), Mamba and RWKV-6. The pieces the
serving engine applies, the training forward ``apply_layer_train`` and
the dense ring-buffer decode (``init_layer_cache``,
``apply_layer_prefill_chunk``, ``apply_layer_decode``), as in the
reference's ``models/blocks.py``.

The ring-buffer cache of a GQA layer is ``{"k", "v": (B, C, KV, hd)
bf16, "pos": (C,) int32}``: slot ``pos % C`` holds the token at absolute
position ``pos``, and ``pos`` is -1 where no token was written yet. A
sliding-window layer (``attn_local``) keeps C = min(max_len, window)
slots. An MLA layer caches the compressed latent instead, ``{"ckv": (B,
C, kv_lora), "kr": (B, C, rope_head_dim), "pos"}`` (``kr`` roped when it
is written), and decodes in the absorbed form. The decode functions write
the new rows into the cache in place (the reference donates the cache
through its jit) and return it.

A Mamba or RWKV layer's cache is its recurrent state (``ssm.
init_mamba_state``, ``rwkv.init_rwkv_state``): its decode returns new
state tensors, which the caller writes back into the cache. These layers
have no chunked prefill (a prompt prefills token by token), as in the
reference."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (NEG_INF, AttnSpec,
                                         chunked_attention,
                                         decode_attention,
                                         masked_decode_attention)
from repro_torch.models.layers import (apply_rope, dense_init, gated_mlp,
                                       rms_norm)
from repro_torch.models.moe import MoESpec, moe_ffn


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


def mamba_spec(cfg: ModelConfig) -> ssm_mod.MambaSpec:
    m = cfg.mamba
    return ssm_mod.MambaSpec(d_model=cfg.d_model, d_state=m.d_state,
                             d_conv=m.d_conv, expand=m.expand)


def rwkv_spec(cfg: ModelConfig) -> rwkv_mod.RWKVSpec:
    r = cfg.rwkv
    return rwkv_mod.RWKVSpec(d_model=cfg.d_model, head_dim=r.head_dim,
                             lora_mix=r.lora_mix, lora_decay=r.lora_decay,
                             chunk=r.chunk)


def moe_spec(cfg: ModelConfig) -> MoESpec:
    m = cfg.moe
    return MoESpec(num_experts=m.num_experts, top_k=m.top_k,
                   d_ff_expert=m.d_ff_expert, num_shared=m.num_shared,
                   capacity_factor=m.capacity_factor,
                   router_aux_weight=m.router_aux_weight, act=cfg.mlp_act)


def check_ported_layer(cfg: ModelConfig, spec: LayerSpec) -> None:
    """The port runs attention layers (GQA or MLA, dense or MoE FFN),
    Mamba and RWKV-6 layers, with RMSNorm; cross-attention and layer norm
    are refused."""
    if (spec.kind not in ("attn", "attn_local", "mamba", "rwkv")
            or cfg.norm != "rms" or spec.cross_attn):
        raise NotImplementedError(
            f"repro_torch ports attention, Mamba and RWKV layers with "
            f"RMSNorm only (kind={spec.kind!r}, norm={cfg.norm!r}, "
            f"cross_attn={spec.cross_attn}); cross-attention and layer norm "
            f"are not ported yet (see ROADMAP.md)")


def _init_attn(cfg: ModelConfig, gen) -> dict:
    D, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
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
    return attn


def _init_mla(cfg: ModelConfig, gen) -> dict:
    D, H, m = cfg.d_model, cfg.num_heads, cfg.mla
    return {
        "wq_a": dense_init(gen, (D, m.q_lora)),
        "q_norm": torch.zeros(m.q_lora),
        "wq_b": dense_init(gen, (m.q_lora,
                                 H * (m.nope_head_dim + m.rope_head_dim))),
        "wkv_a": dense_init(gen, (D, m.kv_lora + m.rope_head_dim)),
        "kv_norm": torch.zeros(m.kv_lora),
        "wkv_b": dense_init(gen, (m.kv_lora,
                                  H * (m.nope_head_dim + m.v_head_dim))),
        "wo": dense_init(gen, (H * m.v_head_dim, D)),
    }


def _init_ffn(cfg: ModelConfig, gen, spec: LayerSpec) -> dict:
    D = cfg.d_model
    if spec.moe:
        m = cfg.moe
        E, Fe = m.num_experts, m.d_ff_expert
        p = {"router": dense_init(gen, (D, E)),
             "wg": dense_init(gen, (E, D, Fe), in_axis=1),
             "wu": dense_init(gen, (E, D, Fe), in_axis=1),
             "wo": dense_init(gen, (E, Fe, D), in_axis=1)}
        if m.num_shared:
            Fs = Fe * m.num_shared
            p["shared_wg"] = dense_init(gen, (D, Fs))
            p["shared_wu"] = dense_init(gen, (D, Fs))
            p["shared_wo"] = dense_init(gen, (Fs, D))
        return p
    F = spec.d_ff
    return {"wi_gate": dense_init(gen, (D, F)),
            "wi_up": dense_init(gen, (D, F)),
            "wo": dense_init(gen, (F, D))}


def _init_mamba(cfg: ModelConfig, gen) -> dict:
    D, ms = cfg.d_model, mamba_spec(cfg)
    d_in, N, rank = ms.d_inner, ms.d_state, ms.rank
    return {
        "norm": {"scale": torch.zeros(D)},
        "in_proj": dense_init(gen, (D, 2 * d_in)),
        "conv_w": dense_init(gen, (ms.d_conv, d_in)) * 0.1,
        "conv_b": torch.zeros(d_in),
        "x_proj": dense_init(gen, (d_in, rank + 2 * N)),
        "dt_proj": dense_init(gen, (rank, d_in)),
        "dt_bias": torch.full((d_in,), -4.6),      # softplus ~ 0.01
        "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32)
                           ).repeat(d_in, 1),
        "D": torch.ones(d_in),
        "out_proj": dense_init(gen, (d_in, D)),
    }


def _init_rwkv(cfg: ModelConfig, spec: LayerSpec, gen) -> dict:
    D, rs = cfg.d_model, rwkv_spec(cfg)
    H, hd, Lm, Ld = rs.num_heads, rs.head_dim, rs.lora_mix, rs.lora_decay
    F = spec.d_ff
    return {
        "norm1": {"scale": torch.zeros(D)},
        "norm2": {"scale": torch.zeros(D)},
        "tm_mu": torch.full((6, D), 0.5),
        "tm_w1": dense_init(gen, (D, 5 * Lm)) * 0.1,
        "tm_w2": dense_init(gen, (5, Lm, D), in_axis=1) * 0.1,
        "w0": torch.full((D,), -2.0),
        "dec_w1": dense_init(gen, (D, Ld)) * 0.1,
        "dec_w2": dense_init(gen, (Ld, D)) * 0.1,
        "u": dense_init(gen, (H, hd)),
        "wr": dense_init(gen, (D, D)),
        "wk": dense_init(gen, (D, D)),
        "wv": dense_init(gen, (D, D)),
        "wg": dense_init(gen, (D, D)),
        "ln_x": torch.ones(D),
        "wo": dense_init(gen, (D, D)),
        "cm_mu_k": torch.full((D,), 0.5),
        "cm_mu_r": torch.full((D,), 0.5),
        "ck": dense_init(gen, (D, F)),
        "cv": dense_init(gen, (F, D)),
        "cr": dense_init(gen, (D, D)),
    }


def init_layer(cfg: ModelConfig, spec: LayerSpec,
               gen: torch.Generator) -> dict:
    """Float32 parameters of one layer, in the reference's layout."""
    check_ported_layer(cfg, spec)
    if spec.kind == "mamba":
        return _init_mamba(cfg, gen)
    if spec.kind == "rwkv":
        return _init_rwkv(cfg, spec, gen)
    D = cfg.d_model
    return {
        "norm1": {"scale": torch.zeros(D)},
        "norm2": {"scale": torch.zeros(D)},
        "attn": _init_mla(cfg, gen) if cfg.mla else _init_attn(cfg, gen),
        "ffn": _init_ffn(cfg, gen, spec),
    }


def _apply_norm(cfg: ModelConfig, p, x):
    return rms_norm(x, p["scale"], cfg.norm_eps)


def _norm_of_sum(cfg: ModelConfig, p, x, y):
    """norm(x + y), of the float32 sum: where a bf16 residual add feeds
    only a norm's cast to float32, XLA computes the add unrounded (the
    rounded sum still feeds the residual). Within an RWKV layer; the
    other layers round the sum first."""
    return rms_norm(x.float() + y.float(), p["scale"],
                    cfg.norm_eps).to(x.dtype)


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


def _mla_project(cfg: ModelConfig, p, x):
    """MLA's expanded-form projections (train): q and k of head dim
    nope + rope (k's rope part one shared head, broadcast over H before
    the attention), v of ``v_head_dim``."""
    B, S, D = x.shape
    m, H = cfg.mla, cfg.num_heads
    cq = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wq_b"]).reshape(B, S, H, m.nope_head_dim + m.rope_head_dim)
    kv_in = x @ p["wkv_a"]                               # (B, S, dc + dr)
    ckv = rms_norm(kv_in[..., :m.kv_lora], p["kv_norm"], cfg.norm_eps)
    k_rope = kv_in[..., m.kv_lora:]
    kvb = (ckv @ p["wkv_b"]).reshape(B, S, H, m.nope_head_dim + m.v_head_dim)
    k_nope, v = kvb[..., :m.nope_head_dim], kvb[..., m.nope_head_dim:]
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H,
                                                     m.rope_head_dim)],
                  dim=-1)
    return q, k, v


def _ffn_train(cfg: ModelConfig, spec: LayerSpec, p, x):
    """The gated MLP or the MoE FFN. Returns (y, aux) like the
    reference."""
    if spec.moe:
        B, S, D = x.shape
        y, aux = moe_ffn(p, x.reshape(B * S, D), moe_spec(cfg))
        return y.reshape(B, S, D), aux
    return gated_mlp(p, x, act=cfg.mlp_act), 0.0


def _attn_block_train(cfg: ModelConfig, spec: LayerSpec, p, x):
    B, S = x.shape[:2]
    asp = attn_spec(cfg, spec)
    if cfg.mla:
        m = cfg.mla
        hd = m.nope_head_dim + m.rope_head_dim
        q, k, v = _mla_project(cfg, p["attn"], x)
        asp = asp._replace(num_kv_heads=cfg.num_heads, head_dim=hd,
                           scale=hd ** -0.5, rope_dims=m.rope_head_dim)
        # v zero-padded to the qk head dim for the shared attention, then
        # sliced back
        v = torch.nn.functional.pad(v, (0, hd - m.v_head_dim))
        o = chunked_attention(q, k, v, asp)[..., :m.v_head_dim]
        return o.reshape(B, S, -1) @ p["attn"]["wo"]
    q, k, v = _gqa_project(cfg, p["attn"], x)
    o = chunked_attention(q, k, v, asp)
    return o.reshape(B, S, -1) @ p["attn"]["wo"]


def _without_norm(p):
    return {k: v for k, v in p.items() if k != "norm"}


def apply_layer_train(cfg: ModelConfig, spec: LayerSpec, p, x):
    """x (B,S,D) -> (x', aux_loss): pre-norm attention, then the FFN; a
    Mamba layer is its mixer alone (no FFN), an RWKV layer its time mix
    then its channel mix."""
    check_ported_layer(cfg, spec)
    if spec.kind == "mamba":
        return x + ssm_mod.mamba_forward(
            _without_norm(p), _apply_norm(cfg, p["norm"], x),
            mamba_spec(cfg)), 0.0
    if spec.kind == "rwkv":
        tm = rwkv_mod.time_mix(p, _apply_norm(cfg, p["norm1"], x),
                               rwkv_spec(cfg))
        return x + tm + rwkv_mod.channel_mix_train(
            p, _norm_of_sum(cfg, p["norm2"], x, tm)), 0.0
    h = x + _attn_block_train(cfg, spec, p, _apply_norm(cfg, p["norm1"], x))
    y, aux = _ffn_train(cfg, spec, p["ffn"], _apply_norm(cfg, p["norm2"], h))
    return h + y, aux


# ---------------------------------------------------------------------------
# dense ring-buffer decode
# ---------------------------------------------------------------------------

def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype=torch.bfloat16,
                     device=None) -> dict:
    """One layer's empty cache: K/V heads in a ring buffer, MLA's
    compressed latent (``ckv``, ``kr``), or a Mamba / RWKV layer's zero
    state (``max_len`` unused)."""
    check_ported_layer(cfg, spec)
    if spec.kind == "mamba":
        return ssm_mod.init_mamba_state(batch, mamba_spec(cfg), dtype,
                                        device=device)
    if spec.kind == "rwkv":
        return rwkv_mod.init_rwkv_state(batch, rwkv_spec(cfg), dtype,
                                        device=device)
    C = min(max_len, cfg.window) if spec.kind == "attn_local" else max_len
    if cfg.mla:
        m = cfg.mla
        return {"ckv": torch.zeros((batch, C, m.kv_lora), dtype=dtype,
                                   device=device),
                "kr": torch.zeros((batch, C, m.rope_head_dim), dtype=dtype,
                                  device=device),
                "pos": torch.full((C,), -1, dtype=torch.int32,
                                  device=device)}
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {"k": torch.zeros((batch, C, KV, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, C, KV, hd), dtype=dtype, device=device),
            "pos": torch.full((C,), -1, dtype=torch.int32, device=device)}


def _ffn_block(cfg, spec, p, h):
    """The pre-norm FFN block on the residual stream h."""
    y, _ = _ffn_train(cfg, spec, p["ffn"], _apply_norm(cfg, p["norm2"], h))
    return h + y


def _attend_out(cfg, spec, p, x, o):
    """Attention output projection and the residual, then the FFN block."""
    B, T = x.shape[:2]
    return _ffn_block(cfg, spec, p, x + o.reshape(B, T, -1) @ p["attn"]["wo"])


def _mla_decode(cfg: ModelConfig, p, x, cache: dict, pos: int):
    """Absorbed-form MLA decode of x (B, 1, D) over the compressed cache
    -> the residual stream h. q_nope goes through W_uk so that scores are
    taken against the kv_lora-wide latent, and the attended latent is
    expanded through W_uv; the new token's ``ckv`` and roped ``kr`` are
    written at slot ``pos % C`` first."""
    m = cfg.mla
    B = x.shape[0]
    H, dn, dr, dv, dc = (cfg.num_heads, m.nope_head_dim, m.rope_head_dim,
                         m.v_head_dim, m.kv_lora)
    f32 = torch.float32
    pa = p["attn"]
    xn = _apply_norm(cfg, p["norm1"], x)
    cq = rms_norm(xn @ pa["wq_a"], pa["q_norm"], cfg.norm_eps)
    q = (cq @ pa["wq_b"]).reshape(B, 1, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_rope = apply_rope(q_rope, posv, cfg.rope_theta)
    kv_in = xn[:, 0] @ pa["wkv_a"]                       # (B, dc + dr)
    ckv_t = rms_norm(kv_in[..., :dc], pa["kv_norm"], cfg.norm_eps)
    kr_t = apply_rope(kv_in[..., dc:][:, None, None, :], posv,
                      cfg.rope_theta)[:, 0, 0]           # (B, dr)
    C = cache["ckv"].shape[1]
    slot = pos % C
    cache["ckv"][:, slot] = ckv_t.to(cache["ckv"].dtype)
    cache["kr"][:, slot] = kr_t.to(cache["kr"].dtype)
    cache["pos"][slot] = pos
    ckv, kr = cache["ckv"].to(f32), cache["kr"].to(f32)
    valid = cache["pos"] >= 0
    wkv_b = pa["wkv_b"].reshape(dc, H, dn + dv).to(f32)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]
    q_eff = torch.einsum("bqhd,chd->bqhc", q_nope.to(f32), w_uk)
    s = (torch.einsum("bqhc,bkc->bhqk", q_eff, ckv)
         + torch.einsum("bqhr,bkr->bhqk", q_rope.to(f32), kr))
    s = s * ((dn + dr) ** -0.5)
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)                         # (B, H, 1, C)
    att_c = torch.einsum("bhqk,bkc->bqhc", w, ckv)
    o = torch.einsum("bqhc,chd->bqhd", att_c, w_uv)      # (B, 1, H, dv)
    return x + o.reshape(B, 1, H * dv).to(x.dtype) @ pa["wo"]


def apply_layer_prefill_chunk(cfg: ModelConfig, spec: LayerSpec, p, x,
                              cache: dict, start: int):
    """Chunked-prefill twin of :func:`apply_layer_decode`: x (B, T, D),
    ``start`` the absolute position of x[:, 0] -> (x', cache). Writes the
    chunk's K/V at slots start..start+T-1 (the caller guarantees
    start + T <= C: no ring wrap) and attends with an explicit causal ∧
    valid ∧ window mask through the decode's score -> softmax -> PV
    composition; at T == 1 it computes exactly the decode step. MLA
    (absorbed-form cache) has no chunked path: callers take the
    token-by-token loop, and so do Mamba and RWKV (stateful
    recurrences)."""
    check_ported_layer(cfg, spec)
    if spec.kind in ("mamba", "rwkv") or cfg.mla:
        raise NotImplementedError(
            f"chunked prefill supports GQA attention layers only "
            f"(kind={spec.kind!r}, mla={cfg.mla is not None})")
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
    on an ``attn_local`` layer only within the window. An MLA layer
    decodes in the absorbed form over its latent cache. A Mamba or RWKV
    layer returns its new state (the normed inputs of this token as RWKV's
    shifts) instead of writing into ``cache``."""
    check_ported_layer(cfg, spec)
    if spec.kind == "mamba":
        y, st = ssm_mod.mamba_decode_step(
            _without_norm(p), _apply_norm(cfg, p["norm"], x), cache,
            mamba_spec(cfg))
        return x + y, st
    if spec.kind == "rwkv":
        rs = rwkv_spec(cfg)
        tm, tm_st = rwkv_mod.time_mix_decode(
            p, _apply_norm(cfg, p["norm1"], x),
            {"wkv": cache["wkv"], "shift": cache["tm_shift"]}, rs)
        cm, cm_st = rwkv_mod.channel_mix_decode(
            p, _norm_of_sum(cfg, p["norm2"], x, tm),
            {"shift": cache["cm_shift"]})
        return x + tm + cm, {"wkv": tm_st["wkv"],
                             "tm_shift": tm_st["shift"],
                             "cm_shift": cm_st["shift"]}
    if cfg.mla:
        return _ffn_block(cfg, spec, p,
                          _mla_decode(cfg, p, x, cache, pos)), cache
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
