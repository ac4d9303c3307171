"""ZeRO-3 parameter gathers whose backward is the quantized gradient
exchange (the reference's ``core/comm/gather.py``), as
``torch.autograd.Function``s.

``make_fsdp_gather`` returns an all-gather whose backward is the phase-1
quantized reduce-scatter of the leaf's cotangent: the per-leaf fsdp path
(``TrainConfig(mode="fsdp", fused_exchange=False)``), where the model
gathers each leaf (each stacked layer's slice) at its point of use.
``make_replicated_gather`` is the identity-forward variant for leaves that
stay dp-replicated: its backward is the full Algorithm 2 all-reduce.
Tensor parallelism (the reference's ``tp_dim``) is not ported.
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
                server_requant):
        ctx.key, ctx.qz, ctx.group = key, qz, group
        ctx.param_dtype, ctx.server_requant = param_dtype, server_requant
        ctx.wid = world(group)[1]
        return w.to(compute_dtype).clone()

    @staticmethod
    def backward(ctx, g):
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
        return out, None, None, None, None, None, None


def make_fsdp_gather(qz: Quantizer, group=None, *, dim: int,
                     tp_dim: Optional[int] = None,
                     compute_dtype=torch.bfloat16,
                     param_dtype=torch.float32):
    """Returns ``gather(w_shard, key) -> full compute_dtype leaf``.

    fwd: cast + all-gather along ``dim`` over the dp group (the FSDP
         parameter broadcast; bf16 on the wire).
    bwd: the quantized reduce-scatter of the full-size cotangent, key
         folded by this worker's rank; the f32 result has the stored
         shard's shape."""
    if tp_dim is not None:
        raise NotImplementedError(
            "tensor parallelism (tp_dim) is not ported to repro_torch yet "
            "(see ROADMAP.md)")

    def gather(w, key):
        return _FsdpGather.apply(w, key, qz, group, dim, compute_dtype,
                                 param_dtype)

    return gather


def make_replicated_gather(qz: Quantizer, group=None, *,
                           compute_dtype=torch.bfloat16,
                           param_dtype=torch.float32,
                           server_requant: bool = True):
    """Identity "gather" of a dp-replicated leaf whose backward runs the
    full Algorithm 2 all-reduce (fp: the all-reduce mean)."""

    def gather(w, key):
        return _ReplicatedGather.apply(w, key, qz, group, compute_dtype,
                                       param_dtype, server_requant)

    return gather
