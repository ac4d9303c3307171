"""ZeRO-3 parameter gathers whose backward is the quantized gradient
exchange (the reference's ``core/comm/gather.py``), as
``torch.autograd.Function``s.

``make_fsdp_gather`` returns an all-gather whose backward is the phase-1
quantized reduce-scatter of the leaf's cotangent: the per-leaf fsdp path
(``TrainConfig(mode="fsdp", fused_exchange=False)``), where the model
gathers each leaf (each stacked layer's slice) at its point of use.
``make_replicated_gather`` is the identity-forward variant for leaves that
stay dp-replicated: its backward is the full Algorithm 2 all-reduce.

Under a model axis each rank stores and computes with its TP block of a
leaf (``models/tp.py``). The fsdp gather then moves that block, full over
the dp group, and its backward reduce-scatters this rank's TP block of
the cotangent over the dp group, keyed by the dp index alone: the rounding
bits are shared across model ranks, whose blocks hold disjoint data (the
reference's nested manual region over ``model``, ``gather.py:72-93``).
A dp-replicated leaf with a TP block gathers its cotangent over the model
axis, so the Algorithm 2 all-reduce quantizes the whole leaf, as the
reference's does, and keeps this rank's block of the mean.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import prng
from repro_torch.core.comm.collectives import (quantized_all_reduce_mean,
                                               world)
from repro_torch.core.comm.fsdp_exchange import (all_gather_dim,
                                                 reduce_scatter_mean_block)
from repro_torch.core.quantizers import Quantizer
from repro_torch.models import tp as tp_mod


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, key, qz, group, dim, compute_dtype, param_dtype):
        ctx.key, ctx.qz, ctx.group, ctx.dim = key, qz, group, dim
        ctx.param_dtype = param_dtype
        ctx.wid = world(group)[1]
        return all_gather_dim(w.to(compute_dtype), dim, group)

    @staticmethod
    def backward(ctx, g):
        key_w = prng.fold_in(ctx.key, ctx.wid)
        out = reduce_scatter_mean_block(g, ctx.qz, key_w, ctx.group,
                                        dim=ctx.dim,
                                        param_dtype=ctx.param_dtype)
        return out, None, None, None, None, None, None


class _ReplicatedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, key, qz, group, compute_dtype, param_dtype,
                server_requant, tp_axis, tp_dim):
        ctx.key, ctx.qz, ctx.group = key, qz, group
        ctx.param_dtype, ctx.server_requant = param_dtype, server_requant
        ctx.tp_axis, ctx.tp_dim = tp_axis, tp_dim
        ctx.wid = world(group)[1]
        return w.to(compute_dtype).clone()

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp_axis is not None and ctx.tp_dim is not None
        if tp:
            g = tp_mod.gather_dim(ctx.tp_axis, g.contiguous(), ctx.tp_dim)
        flat = g.to(torch.float32).reshape(-1)
        if ctx.qz.is_identity:
            mean = flat.clone()
            dist.all_reduce(mean, group=ctx.group)
            mean = mean / world(ctx.group)[0]
        else:
            mean = quantized_all_reduce_mean(
                flat, ctx.qz, ctx.key, group=ctx.group, worker_id=ctx.wid,
                server_requant=ctx.server_requant)
        out = mean.reshape(g.shape).to(ctx.param_dtype)
        if tp:
            out = tp_mod.own_block(ctx.tp_axis, out, ctx.tp_dim).contiguous()
        return out, None, None, None, None, None, None, None, None


def make_fsdp_gather(qz: Quantizer, group=None, *, dim: int,
                     tp_dim: Optional[int] = None,
                     compute_dtype=torch.bfloat16,
                     param_dtype=torch.float32):
    """Returns ``gather(w_shard, key) -> full compute_dtype leaf``.

    fwd: cast + all-gather along ``dim`` over the dp group (the FSDP
         parameter broadcast; bf16 on the wire).
    bwd: the quantized reduce-scatter of the full-size cotangent, key
         folded by this worker's rank in the dp group; the f32 result has
         the stored shard's shape.

    With ``tp_dim`` (the leaf's TP dim) the shard is this rank's TP
    block's: the gather gives the TP block and the backward quantizes this
    rank's TP block of the cotangent, with the key every model rank of
    this dp index shares."""

    def gather(w, key):
        return _FsdpGather.apply(w, key, qz, group, dim, compute_dtype,
                                 param_dtype)

    return gather


def make_replicated_gather(qz: Quantizer, group=None, *,
                           compute_dtype=torch.bfloat16,
                           param_dtype=torch.float32,
                           server_requant: bool = True,
                           tp_axis: Optional["tp_mod.Axis"] = None,
                           tp_dim: Optional[int] = None):
    """Identity "gather" of a dp-replicated leaf whose backward runs the
    full Algorithm 2 all-reduce (fp: the all-reduce mean); with a TP block
    (``tp_axis``, ``tp_dim``) on the whole leaf's cotangent, gathered over
    the model axis."""

    def gather(w, key):
        return _ReplicatedGather.apply(w, key, qz, group, compute_dtype,
                                       param_dtype, server_requant, tp_axis,
                                       tp_dim)

    return gather
