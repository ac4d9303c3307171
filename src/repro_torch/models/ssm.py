"""Mamba (S6) selective state-space block, the Jamba mixer (the
reference's ``models/ssm.py``).

Train path: a depthwise causal conv over time, then the selective scan
``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t``, ``y_t = h_t C_t``, with h
carried in float32. The reference evaluates each chunk of 256 steps with
an associative scan and pads S up to a multiple of the chunk (the padded
steps have dt = 0, so they leave h as it was); the port runs the same
recurrence step by step over the real steps, a chunk's transition
tensors at a time. It adds in another order than the associative form, so
it agrees with the reference to float rounding, not bit for bit. Outside
the scan every op runs in the input's dtype and rounds as the reference's
XLA program does (the sum over the conv taps in order, silu and softplus
op by op).

Decode path: one token, O(1): a rolling window of the last d_conv - 1
``in_proj`` outputs (in the cache dtype) and the (d_inner, d_state)
float32 state.

Under a model axis (``mamba_forward_tp``, ``mamba_decode_step_tp``) the
block is d_inner-parallel: each rank runs the conv, the scan and the gate
on its block of channels. The plan splits ``in_proj``'s (D, 2 d_inner)
columns as one leaf (over two ranks one holds x, the other z), so its
product is gathered (an activation, not the 2 d_inner-wide weight) and
cut into its x and z halves before a rank takes its channels of each.
``x_proj``'s partial products (dt_low, B, C) are added in float32 over
the axis, ``out_proj`` is row-parallel, and the SSM state holds the
rank's channels; the conv window holds every channel (the serve plan
leaves it whole).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import tp as tp_mod
from repro_torch.models.layers import sigmoid, silu, softplus


class MambaSpec(NamedTuple):
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0            # 0 -> ceil(d_model / 16)
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)


def selective_scan(dt, xc, Bm, Cm, A, h0, chunk: int):
    """dt, xc (B, S, d); Bm, Cm (B, S, N); A (d, N); h0 (B, d, N), all
    float32 -> (y (B, S, d), h_last). The (B, chunk, d, N) transition and
    input tensors exist one chunk at a time."""
    S = dt.shape[1]
    h, ys = h0, []
    for c0 in range(0, S, chunk):
        c1 = min(c0 + chunk, S)
        da = torch.exp(dt[:, c0:c1, :, None] * A)           # (B, T, d, N)
        db = (dt[:, c0:c1] * xc[:, c0:c1])[..., None] * Bm[:, c0:c1, None, :]
        for t in range(c1 - c0):
            h = da[:, t] * h + db[:, t]
            ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, c0 + t]))
    return torch.stack(ys, dim=1), h


def _silu_both(v):
    """silu(v) in v's dtype, and in float32 for the scan. XLA computes the
    product of a silu whose only other use is a cast to float32 in float32
    (unrounded); the bf16 product feeds the projections."""
    s = sigmoid(v)
    return v * s, v.float() * s.float()


def _dt(xc, p, spec: MambaSpec):
    """The input-dependent (dt, B, C) of each token: dt is softplus of its
    rank-r projection plus ``dt_bias``."""
    N = spec.d_state
    dbc = xc @ p["x_proj"]                             # (..., rank + 2N)
    dt, Bm, Cm = torch.split(dbc, [spec.rank, N, N], dim=-1)
    return softplus(dt @ p["dt_proj"] + p["dt_bias"]), Bm, Cm


def _gate_out(p, y, xc, z):
    """(y + xc D) silu(z) @ out_proj, y cast back to xc's dtype first."""
    y = y.to(xc.dtype) + xc * p["D"]
    return (y * silu(z)) @ p["out_proj"]


def mamba_forward(p, x, spec: MambaSpec):
    """p: the layer's params without its norm; x (B, S, D) -> (B, S, D).
    Training / prefill path."""
    S = x.shape[1]
    xs, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)   # (B, S, d_in)
    xpad = F.pad(xs, (0, 0, spec.d_conv - 1, 0))
    w = p["conv_w"]                                    # (d_conv, d_in)
    pre = xpad[:, :S] * w[0]
    for i in range(1, spec.d_conv):
        pre = pre + xpad[:, i:i + S] * w[i]
    xc, xc32 = _silu_both(pre + p["conv_b"])
    dt, Bm, Cm = _dt(xc, p, spec)
    A = -torch.exp(p["A_log"].float())                  # (d_in, N)
    h0 = torch.zeros((x.shape[0], spec.d_inner, spec.d_state),
                     dtype=torch.float32, device=x.device)
    y, _ = selective_scan(dt.float(), xc32, Bm.float(), Cm.float(), A, h0,
                          spec.chunk)
    return _gate_out(p, y, xc, z)


def mamba_decode_step(p, x, state, spec: MambaSpec):
    """x (B, 1, D); state {conv (B, d_conv-1, d_in), ssm (B, d_in, N)} ->
    (out (B, 1, D), new state). The window holds the last d_conv - 1
    ``in_proj`` outputs, oldest first."""
    xs, z = torch.chunk(x[:, 0] @ p["in_proj"], 2, dim=-1)   # (B, d_in)
    win = torch.cat([state["conv"], xs[:, None]], dim=1)
    xc, xc32 = _silu_both((win * p["conv_w"][None]).sum(dim=1)
                          + p["conv_b"])
    dt, Bm, Cm = _dt(xc, p, spec)
    A = -torch.exp(p["A_log"].float())
    dt32 = dt.float()
    da = torch.exp(dt32[..., None] * A)                 # (B, d_in, N)
    db = (dt32 * xc32)[..., None] * Bm.float()[:, None, :]
    h = state["ssm"] * da + db
    y = torch.einsum("bdn,bn->bd", h, Cm.float())
    out = _gate_out(p, y, xc, z)[:, None]
    return out, {"conv": win[:, 1:], "ssm": h}


# ---------------------------------------------------------------------------
# d_inner-parallel (under a model axis)
# ---------------------------------------------------------------------------

def _in_halves_tp(tp, p, x):
    """x @ in_proj -> its x and z halves (..., d_inner), replicated."""
    y, split = tp_mod.linear(tp.axis, x, p["in_proj"], tp.dims["in_proj"])
    return torch.chunk(tp_mod.to_full(tp.axis, y, split), 2, dim=-1)


def _channels(tp, p, name):
    """This rank's channels of a leaf whose first dim is d_inner."""
    return tp_mod.local_part(tp.axis, p[name], tp.dims[name], 0)


def _dt_tp(tp, xc, p, spec: MambaSpec):
    """:func:`_dt` on this rank's channels xc: the partial products of
    ``x_proj`` summed in float32 over the axis (dt_low, B and C are then
    the same on every rank), dt on this rank's channels. The parts of
    their gradients are added in float32 and rounded once."""
    ax, d, N = tp.axis, tp.dims, spec.d_state
    y, split = tp_mod.linear(ax, xc, p["x_proj"], d["x_proj"], x_split=True)
    dt, Bm, Cm = torch.split(tp_mod.to_full(ax, y, split),
                             [spec.rank, N, N], dim=-1)
    w = tp_mod.local_part(ax, p["dt_proj"], d["dt_proj"], 1)
    dt = tp_mod.column_linear(ax, dt, w)
    return (softplus(dt + _channels(tp, p, "dt_bias")),
            tp_mod.copy_to(ax, Bm.float()), tp_mod.copy_to(ax, Cm.float()))


def _gate_out_tp(tp, p, y, xc, z):
    """:func:`_gate_out` with ``out_proj`` row-parallel -> replicated."""
    y = y.to(xc.dtype) + xc * _channels(tp, p, "D")
    out, split = tp_mod.linear(tp.axis, y * silu(z), p["out_proj"],
                               tp.dims["out_proj"], x_split=True)
    return tp_mod.to_full(tp.axis, out, split)


def _A_tp(tp, p):
    return -torch.exp(_channels(tp, p, "A_log").float())


def mamba_forward_tp(tp, p, x, spec: MambaSpec):
    """:func:`mamba_forward` under a model axis (``tp`` a ``LayerTP``;
    d_inner divisible by its size): x (B, S, D) replicated -> (B, S, D)
    replicated."""
    ax = tp.axis
    S = x.shape[1]
    xs, z = (tp_mod.split_to(ax, h) for h in _in_halves_tp(tp, p, x))
    xpad = F.pad(xs, (0, 0, spec.d_conv - 1, 0))
    w = tp_mod.local_part(ax, p["conv_w"], tp.dims["conv_w"], 1)
    pre = xpad[:, :S] * w[0]
    for i in range(1, spec.d_conv):
        pre = pre + xpad[:, i:i + S] * w[i]
    xc, xc32 = _silu_both(pre + _channels(tp, p, "conv_b"))
    dt, Bm, Cm = _dt_tp(tp, xc, p, spec)
    h0 = torch.zeros((x.shape[0], xc.shape[-1], spec.d_state),
                     dtype=torch.float32, device=x.device)
    y, _ = selective_scan(dt.float(), xc32, Bm.float(), Cm.float(),
                          _A_tp(tp, p), h0, spec.chunk)
    return _gate_out_tp(tp, p, y, xc, z)


def mamba_decode_step_tp(tp, p, x, conv, ssm, spec: MambaSpec):
    """:func:`mamba_decode_step` under a model axis: ``conv`` the whole
    window (B, d_conv - 1, d_inner), ``ssm`` this rank's channels (B,
    d_inner / n, N) -> (out (B, 1, D) replicated, {conv: the whole new
    window, ssm: this rank's new channels})."""
    ax = tp.axis
    xs, z = _in_halves_tp(tp, p, x[:, 0])
    win = torch.cat([conv, xs[:, None]], dim=1)
    w = tp_mod.local_part(ax, p["conv_w"], tp.dims["conv_w"], 1)
    xc, xc32 = _silu_both((tp_mod.own_block(ax, win, -1) * w[None]).sum(
        dim=1) + _channels(tp, p, "conv_b"))
    dt, Bm, Cm = _dt_tp(tp, xc, p, spec)
    dt32 = dt.float()
    da = torch.exp(dt32[..., None] * _A_tp(tp, p))
    db = (dt32 * xc32)[..., None] * Bm.float()[:, None, :]
    h = ssm * da + db
    y = torch.einsum("bdn,bn->bd", h, Cm.float())
    out = _gate_out_tp(tp, p, y, xc, tp_mod.own_block(ax, z, -1))[:, None]
    return out, {"conv": win[:, 1:], "ssm": h}


def init_mamba_state(batch: int, spec: MambaSpec, dtype=torch.bfloat16,
                     device=None) -> dict:
    return {"conv": torch.zeros((batch, spec.d_conv - 1, spec.d_inner),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, spec.d_inner, spec.d_state),
                               dtype=torch.float32, device=device)}
