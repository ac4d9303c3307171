"""RWKV-6 "Finch" block: linear attention with a data-dependent decay and
no softmax (the reference's ``models/rwkv.py``).

Token shift with the data-dependent lerp (ddlerp) gives r / k / v / g / w;
each channel decays by w_t = exp(-exp(.)); u is the bonus of the current
token; the WKV state of each head runs

    out_t = r_t . (S_{t-1} + u * k_t^T v_t)
    S_t   = diag(w_t) S_{t-1} + k_t^T v_t

The train path evaluates it chunk by chunk (the chunked form of
``_wkv_scan``, matmuls inside a chunk, sequential over chunks); decode
is the same function at one token, with the (H, hd, hd) float32 state
and the last normed token of each mix carried. The channel mix is the
squared-ReLU FFN with token shift.

Under a model axis (``time_mix_tp``, ``channel_mix_tp`` and their
decodes) the WKV recurrence and the group norm run on this rank's heads:
r / k / v / g and the decay come to this rank's channels (``wr`` ... by
``tp.linear`` at the dims the plan split them on), the small LoRA mixes
(``tm_w1``, ``tm_w2``, ``dec_w1``, ``dec_w2``) are computed replicated on
gathered leaves, and ``wo`` / ``cv`` add their partial products over the
axis. The WKV state holds this rank's heads; the token-shift inputs are
whole.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import tp as tp_mod
from repro_torch.models.layers import sigmoid, silu


class RWKVSpec(NamedTuple):
    d_model: int
    head_dim: int = 64
    lora_mix: int = 32
    lora_decay: int = 64
    chunk: int = 128

    @property
    def num_heads(self) -> int:
        return self.d_model // self.head_dim


def _shift(x):
    """x (B, S, D) -> the previous token's x, zero before the first."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _ddlerp(x, x_prev, mu_base, w1, w2):
    """The five data-dependent lerps (r, k, v, g, w) of x and x_prev (B, S,
    D); mu_base (6, D) [0: the token-shift trunk, 1..5: r, k, v, g, w], w1
    (D, 5 L), w2 (5, L, D) -> (5, B, S, D)."""
    B, S, D = x.shape
    dx = x_prev - x
    xx = x + dx * mu_base[0]
    a = torch.tanh(xx @ w1).reshape(B, S, 5, -1)            # (B, S, 5, L)
    mods = torch.einsum("bsfl,fld->fbsd", a, w2)            # (5, B, S, D)
    return x[None] + dx[None] * (mu_base[1:, None, None, :] + mods)


def _wkv_scan_sequential(r, k, v, w, u, chunk: int, s0):
    """The WKV recurrence one token at a time: r / k / v / w (B, S, H,
    hd), w the decay in (0, 1), u (H, hd), s0 (B, H, hd, hd) -> (out (B,
    S, H, hd), s_last). The plain twin of :func:`_wkv_scan` (the chunk
    changes nothing here); only the tests use it."""
    del chunk
    s, outs = s0, []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]      # (B, H, hd, hd)
        outs.append(torch.einsum("bhij,bhi->bhj", s + u[..., :, None] * kv,
                                 r[:, t]))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def _wkv_scan(r, k, v, w, u, chunk: int, s0, *, logw=None):
    """The chunked WKV, equal to the recurrence: within a chunk of T
    tokens, with c_t = sum_{tau <= t} log w_tau,

        A[t, j] = sum_i r_t[i] k_j[i] exp(c_{t-1}[i] - c_j[i])   (j < t)
        A[t, t] = sum_i r_t[i] u[i] k_t[i]
        out     = A @ V + (r * exp(c_{t-1})) @ S_0
        S_T     = diag(exp(c_T)) S_0 + (k * exp(c_T - c_j))^T @ V

    Every exponent sums log-decays over a forward range, so it is <= 0 and
    needs no clamping. The reference pads S up to a multiple of T with
    log w = 0 and zero r / k / v, which changes neither the real outputs
    nor the state; the port runs a shorter last chunk instead. The
    (B, T, T, H, hd) decay factors exist one chunk at a time."""
    B, S, H, hd = r.shape
    T = min(chunk, S)
    if logw is None:
        logw = torch.log(torch.clamp(w, min=1e-38))
    s, outs = s0, []
    for c0 in range(0, S, T):
        rb, kb, vb, lw = (a[:, c0:c0 + T] for a in (r, k, v, logw))
        n = rb.shape[1]
        cw = torch.cumsum(lw, dim=1)                       # c_t, inclusive
        cprev = cw - lw                                    # c_{t-1}
        # exp(c_{t-1} - c_j) for j < t; the exponent is masked before the
        # exp (not after, as the reference does), so that no inf reaches
        # the backward
        tri = torch.ones((n, n), dtype=torch.bool, device=r.device).tril(-1)
        decay = torch.exp(torch.where(tri[:, :, None, None],
                                      cprev[:, :, None] - cw[:, None],
                                      float("-inf")))      # (B, T, T, H, hd)
        A = (rb[:, :, None] * kb[:, None] * decay).sum(-1)  # (B, T, T, H)
        A = A.permute(0, 3, 1, 2)                          # (B, H, T, T)
        diag = torch.einsum("bthi,hi,bthi->bht", rb, u.to(rb.dtype), kb)
        A = A + torch.diag_embed(diag)
        out = torch.einsum("bhtj,bjho->btho", A, vb)
        out = out + torch.einsum("bthi,bhio->btho", rb * torch.exp(cprev), s)
        c_T = cw[:, n - 1]                                 # (B, H, hd)
        kp = kb * torch.exp(c_T[:, None] - cw)
        s = (torch.exp(c_T)[..., None] * s
             + torch.einsum("bjhi,bjho->bhio", kp, vb))
        outs.append(out)
    return torch.cat(outs, dim=1), s


def _group_norm(x, scale, n_heads: int, eps: float = 1e-5):
    """Per-head norm of x (B, S, D) laid out as heads x hd, in float32,
    times ``scale``, cast back to x's dtype."""
    B, S, D = x.shape
    xh = x.reshape(B, S, n_heads, -1).float()
    mu = xh.mean(-1, keepdim=True)
    var = ((xh - mu) ** 2).mean(-1, keepdim=True)
    y = (xh - mu) * torch.rsqrt(var + eps)
    return (y.reshape(B, S, D) * scale.float()).to(x.dtype)


def _time_mix_core(p, x, x_prev, spec: RWKVSpec, s0):
    """The time mix of x (B, S, D) given each token's predecessor x_prev
    and the state s0 -> (out (B, S, D), s_last): the train path (S
    tokens) and decode (S = 1, x_prev carried)."""
    B, S, D = x.shape
    H, hd = spec.num_heads, spec.head_dim
    xr, xk, xv, xg, xw = _ddlerp(x, x_prev, p["tm_mu"], p["tm_w1"],
                                 p["tm_w2"])
    r = (xr @ p["wr"]).reshape(B, S, H, hd)
    k = (xk @ p["wk"]).reshape(B, S, H, hd)
    v = (xv @ p["wv"]).reshape(B, S, H, hd)
    g = silu(xg @ p["wg"])
    # dec = w0 + tanh(xw W1) W2 goes to float32 at once, so XLA adds w0 in
    # float32 (the product is rounded to bf16 first)
    dec = p["w0"].float() + (torch.tanh(xw @ p["dec_w1"]) @ p["dec_w2"]
                             ).float()
    logw = (-torch.exp(dec)).reshape(B, S, H, hd)
    out, s_last = _wkv_scan(r.float(), k.float(), v.float(), None, p["u"],
                            spec.chunk, s0, logw=logw)
    out = _group_norm(out.reshape(B, S, D).to(x.dtype), p["ln_x"], H) * g
    return out @ p["wo"], s_last


def time_mix(p, x, spec: RWKVSpec):
    """Training path. x (B, S, D) -> (B, S, D)."""
    B = x.shape[0]
    s0 = torch.zeros((B, spec.num_heads, spec.head_dim, spec.head_dim),
                     dtype=torch.float32, device=x.device)
    out, _ = _time_mix_core(p, x, _shift(x), spec, s0)
    return out


def channel_mix(p, x, x_prev):
    """The RWKV FFN with token shift: sigmoid(xr Wr) * (relu(xk Wk)^2 Wv)."""
    dx = x_prev - x
    xk = x + dx * p["cm_mu_k"]
    xr = x + dx * p["cm_mu_r"]
    k = torch.square(F.relu(xk @ p["ck"]))
    return sigmoid(xr @ p["cr"]) * (k @ p["cv"])


def channel_mix_train(p, x):
    return channel_mix(p, x, _shift(x))


def time_mix_decode(p, x, state, spec: RWKVSpec):
    """x (B, 1, D); state {wkv (B, H, hd, hd), shift (B, D)} -> (out, new
    state): the new shift is this token's x."""
    out, s_last = _time_mix_core(p, x, state["shift"][:, None], spec,
                                 state["wkv"])
    return out, {"wkv": s_last, "shift": x[:, 0]}


def channel_mix_decode(p, x, state):
    """x (B, 1, D); state {shift (B, D)}."""
    out = channel_mix(p, x, state["shift"][:, None])
    return out, {"shift": x[:, 0]}


# ---------------------------------------------------------------------------
# head-parallel (under a model axis)
# ---------------------------------------------------------------------------

def _cols_tp(tp, p, x, name):
    """x (replicated) @ p[name] -> this rank's block of its columns."""
    y, split = tp_mod.linear(tp.axis, x, p[name], tp.dims[name])
    return tp_mod.to_split(tp.axis, y, split)


def _time_mix_core_tp(tp, p, x, x_prev, spec: RWKVSpec, s0):
    """:func:`_time_mix_core` on this rank's heads (``tp`` a ``LayerTP``,
    the heads divisible by its axis size): x,
    x_prev (B, S, D) replicated, s0 this rank's heads' state -> (out (B,
    S, D) replicated, this rank's new state)."""
    ax, d = tp.axis, tp.dims
    B, S, D = x.shape
    hd = spec.head_dim
    Hn = spec.num_heads // ax.n

    def full(name):
        return tp_mod.full(ax, p[name], d[name])

    xr, xk, xv, xg, xw = _ddlerp(x, x_prev, full("tm_mu"), full("tm_w1"),
                                 full("tm_w2"))
    r = _cols_tp(tp, p, xr, "wr").reshape(B, S, Hn, hd)
    k = _cols_tp(tp, p, xk, "wk").reshape(B, S, Hn, hd)
    v = _cols_tp(tp, p, xv, "wv").reshape(B, S, Hn, hd)
    g = silu(_cols_tp(tp, p, xg, "wg"))
    dec = full("w0").float() + (torch.tanh(xw @ full("dec_w1"))
                                @ full("dec_w2")).float()
    logw = (-torch.exp(tp_mod.split_to(ax, dec))).reshape(B, S, Hn, hd)
    u = tp_mod.local_part(ax, p["u"], d["u"], 0)
    out, s_last = _wkv_scan(r.float(), k.float(), v.float(), None, u,
                            spec.chunk, s0, logw=logw)
    ln_x = tp_mod.local_part(ax, p["ln_x"], d["ln_x"], 0)
    out = _group_norm(out.reshape(B, S, Hn * hd).to(x.dtype), ln_x, Hn) * g
    y, split = tp_mod.linear(ax, out, p["wo"], d["wo"], x_split=True)
    return tp_mod.to_full(ax, y, split), s_last


def time_mix_tp(tp, p, x, spec: RWKVSpec):
    """:func:`time_mix` under a model axis."""
    s0 = torch.zeros((x.shape[0], spec.num_heads // tp.axis.n,
                      spec.head_dim, spec.head_dim), dtype=torch.float32,
                     device=x.device)
    out, _ = _time_mix_core_tp(tp, p, x, _shift(x), spec, s0)
    return out


def channel_mix_tp(tp, p, x, x_prev):
    """:func:`channel_mix` under a model axis: ``ck`` / ``cv`` by their
    plan dims (the hidden block stays local between them), ``cr``'s
    product gathered; the output replicated."""
    ax, d = tp.axis, tp.dims
    dx = x_prev - x
    xk = x + dx * tp_mod.full(ax, p["cm_mu_k"], d["cm_mu_k"])
    xr = x + dx * tp_mod.full(ax, p["cm_mu_r"], d["cm_mu_r"])
    kk, ks = tp_mod.linear(ax, xk, p["ck"], d["ck"])
    kv, kvs = tp_mod.linear(ax, torch.square(F.relu(kk)), p["cv"], d["cv"],
                            x_split=ks)
    rr, rs = tp_mod.linear(ax, xr, p["cr"], d["cr"])
    return (sigmoid(tp_mod.to_full(ax, rr, rs))
            * tp_mod.to_full(ax, kv, kvs))


def time_mix_decode_tp(tp, p, x, wkv, shift, spec: RWKVSpec):
    """:func:`time_mix_decode` under a model axis: ``wkv`` this rank's
    heads' state, ``shift`` (B, D) whole -> (out, this rank's new
    state)."""
    return _time_mix_core_tp(tp, p, x, shift[:, None], spec, wkv)


def init_rwkv_state(batch: int, spec: RWKVSpec, dtype=torch.bfloat16,
                    device=None) -> dict:
    return {"wkv": torch.zeros((batch, spec.num_heads, spec.head_dim,
                                spec.head_dim), dtype=torch.float32,
                               device=device),
            "tm_shift": torch.zeros((batch, spec.d_model), dtype=dtype,
                                    device=device),
            "cm_shift": torch.zeros((batch, spec.d_model), dtype=dtype,
                                    device=device)}
