"""Mixture-of-Experts FFN (the reference's ``models/moe.py``): top-k
routing with a static capacity, GShard-style dispatch.

Tokens are placed into an ``(E, C, D)`` buffer by expert id and position
in that expert's queue (an integer cumsum over the flattened, token-major
``(T·k, E)`` one-hot, so the drop order is the reference's), the experts
run as batched products over E, and the outputs are gathered back with the
router's combine weights. A (token, slot) past its expert's capacity goes
to the out-of-range row ``E·C`` and contributes nothing. DeepSeek-style
shared experts are an always-on gated MLP beside the routed ones. The
function returns the switch load-balance loss ``w·E·Σ_e f_e·p_e``.

Plain PyTorch, as the reference computes it outside any Pallas kernel.
The reference's ``shard(...)`` constraints (experts over the ``model``
axis) have no counterpart: the port has no model axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _ACTS, gated_mlp


class MoESpec(NamedTuple):
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    act: str = "silu"


class Routing(NamedTuple):
    """One call's routing: ``probs`` (T, E) f32, the renormalised top-k
    weights ``topw`` and expert ids ``topi`` (T, k), ``keep`` (T·k,) bool
    (the (token, slot) fits its expert's queue), ``pos`` (T·k,) its place
    in that queue, ``capacity`` C."""
    probs: torch.Tensor
    topw: torch.Tensor
    topi: torch.Tensor
    keep: torch.Tensor
    pos: torch.Tensor
    capacity: int


def capacity(n_tokens: int, spec: MoESpec) -> int:
    c = int(n_tokens * spec.top_k * spec.capacity_factor / spec.num_experts)
    return max(8, -(-c // 8) * 8)


def top_k(probs: torch.Tensor, k: int):
    """The k largest of each row, ties to the lower index as
    ``jax.lax.top_k`` breaks them (``torch.topk`` promises no order among
    equal values): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, x: torch.Tensor, spec: MoESpec) -> Routing:
    """Softmax router in float32, top-k, renormalisation, and each
    (token, slot)'s place in its expert's queue."""
    T = x.shape[0]
    E, k = spec.num_experts, spec.top_k
    C = capacity(T, spec)
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                 # (T, E)
    topw, topi = top_k(probs, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    flat_e = topi.reshape(-1)                             # (T*k,)
    onehot = F.one_hot(flat_e, E)                         # (T*k, E) int64
    pos = torch.cumsum(onehot, dim=0) - 1
    pos_in_e = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    return Routing(probs, topw, topi, pos_in_e < C, pos_in_e, C)


def moe_ffn(p, x: torch.Tensor, spec: MoESpec):
    """p: {router (D, E), wg / wu (E, D, F), wo (E, F, D) [, shared_wg /
    shared_wu (D, F·S), shared_wo (F·S, D)]}; x (T, D) -> (y (T, D) in x's
    type, aux loss f32 scalar)."""
    T, D = x.shape
    E, k = spec.num_experts, spec.top_k
    r = route(p, x, spec)
    C = r.capacity
    flat_e = r.topi.reshape(-1)
    dest = torch.where(r.keep, flat_e * C + r.pos,
                       torch.full_like(flat_e, E * C))    # dropped: row E*C
    x_rep = torch.repeat_interleave(x, k, dim=0)           # (T*k, D)
    # the kept destinations are unique, so the add is an exact copy
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, dest, x_rep)[:E * C].reshape(E, C, D)

    g = torch.bmm(buf, p["wg"])
    u = torch.bmm(buf, p["wu"])
    h = (_ACTS[spec.act](g.to(torch.float32))
         * u.to(torch.float32)).to(x.dtype)
    out = torch.bmm(h, p["wo"]).reshape(E * C, D)

    safe = torch.where(r.keep, dest, torch.zeros_like(dest))
    tok_out = out[safe] * r.keep[:, None].to(x.dtype)
    w = r.topw.reshape(-1)[:, None].to(x.dtype)
    y = (tok_out * w).reshape(T, k, D).sum(dim=1)

    if spec.num_shared > 0:
        y = y + gated_mlp({"wi_gate": p["shared_wg"],
                           "wi_up": p["shared_wu"],
                           "wo": p["shared_wo"]}, x, act=spec.act)

    onehot = F.one_hot(flat_e, E)
    frac_tokens = (onehot * r.keep[:, None]).to(torch.float32).mean(0) * k
    aux = spec.router_aux_weight * E * torch.sum(frac_tokens
                                                 * r.probs.mean(0))
    return y, aux
