"""Tensor parallelism over the mesh's ``model`` axis: the collectives that
XLA derives in the reference from its ``shard`` constraints
(``models/layers.py:13`` and its call sites), written out by hand.

A parameter leaf is stored as this rank's block along the dim the plan
names for it (``train/step.py`` ``plan_sharding_shapes`` in training,
``serve/step.py`` ``plan_serve_sharding`` in serving): that dim is not
always the Megatron one (lm-100m's training plan splits ``attn/wo`` on its
output), so every helper takes the dim the plan chose. Activations on the
residual stream are replicated over the model axis; inside a layer a
tensor is either replicated or split along its last dim.

Three autograd Functions carry every crossing (the Megatron "f" and "g"
operators and a gather), with their own backwards:

* :func:`copy_to` identity forward, all-reduce backward: a replicated
  tensor entering rank-local compute (each rank's gradient is a part);
* :func:`reduce_from` all-reduce forward, identity backward: partial
  products summed (in float32, rounded once);
* :func:`gather_from` the blocks along a dim forward, this rank's block
  backward (the gathered tensor then feeds replicated compute).

(``torch.distributed.nn.functional.all_reduce`` all-reduces in its
backward as well, which multiplies a replicated gradient by the axis
size.)

All-reduce is the only collective: a gather is the all-reduce of a
zero-filled buffer of every rank's block, summed as raw bytes (uint8), so
it is exact for any dtype (-0.0 and NaN payloads included), and one code
path runs on NCCL, on gloo with CPU tensors and on gloo with CUDA tensors
(which carries all-reduce and broadcast only).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

_ROADMAP = "is not ported to repro_torch yet (see ROADMAP.md)"


class Axis:
    """One mesh axis (or several, flattened) as seen from this rank: its
    process group (None: the default group), its size and this rank's
    index along it. ``collectives`` counts the all-reduces issued (none
    when ``n == 1``)."""

    def __init__(self, group, n: int, index: int):
        self.group, self.n, self.index = group, int(n), int(index)
        self.collectives = 0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the axis, in place; returns ``t``."""
        if self.n > 1:
            dist.all_reduce(t, group=self.group)
            self.collectives += 1
        return t


def gather_blocks(ax: Axis, blocks: Sequence[torch.Tensor]
                  ) -> List[torch.Tensor]:
    """Every rank's ``blocks`` -> for each block, the (n, *block.shape)
    stack of all ranks' blocks in axis order: one all-reduce of a
    zero-filled uint8 buffer whatever the number of blocks and their
    dtypes (the blocks of one position must have the same shape and
    dtype on every rank)."""
    if ax.n == 1:
        return [b[None] for b in blocks]
    sizes = [b.numel() * b.element_size() for b in blocks]
    dev = blocks[0].device
    buf = torch.zeros((ax.n, sum(sizes)), dtype=torch.uint8, device=dev)
    off = 0
    for b, s in zip(blocks, sizes):
        buf[ax.index, off:off + s] = b.detach().contiguous().reshape(
            -1).view(torch.uint8)
        off += s
    ax.all_reduce(buf)
    out, off = [], 0
    for b, s in zip(blocks, sizes):
        raw = buf[:, off:off + s].contiguous()
        out.append(raw.view(b.dtype).reshape((ax.n,) + tuple(b.shape)))
        off += s
    return out


def gather_dim(ax: Axis, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The blocks of every rank concatenated along ``dim`` (no autograd)."""
    if ax.n == 1:
        return x
    return torch.cat(gather_blocks(ax, [x])[0].unbind(0), dim=dim)


def gather_leaves(ax: Axis, leaves, dims) -> list:
    """Each leaf's blocks concatenated along its dim (None: the leaf as it
    is), in one all-reduce."""
    idx = [i for i, d in enumerate(dims) if d is not None]
    out = list(leaves)
    if ax.n == 1 or not idx:
        return out
    stacks = gather_blocks(ax, [leaves[i] for i in idx])
    for i, s in zip(idx, stacks):
        out[i] = torch.cat(s.unbind(0), dim=dims[i])
    return out


def own_block(ax: Axis, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``."""
    if ax.n == 1:
        return x
    size = x.shape[dim] // ax.n
    return x.narrow(dim, ax.index * size, size)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # the parts added in float32 and rounded once
        return ctx.ax.all_reduce(g.to(torch.float32)).to(g.dtype), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return ax.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return gather_dim(ax, x, dim)

    @staticmethod
    def backward(ctx, g):
        return own_block(ctx.ax, g, ctx.dim).contiguous(), None, None


class _ColumnLinear(torch.autograd.Function):
    """``copy_to(x) @ w`` for a weight split on its output columns, whose
    backward forms this rank's part of dx in float32, so the parts are
    added and rounded once (a bf16 matmul would round each part first)."""

    @staticmethod
    def forward(ctx, x, w, ax):
        ctx.save_for_backward(x, w)
        ctx.ax = ax
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = ctx.ax.all_reduce(g.to(torch.float32) @ w.to(torch.float32).T)
        dw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return dx.to(x.dtype), dw.to(w.dtype), None


def copy_to(ax: Axis, x: torch.Tensor) -> torch.Tensor:
    return x if ax.n == 1 else _CopyTo.apply(x, ax)


def reduce_from(ax: Axis, x: torch.Tensor) -> torch.Tensor:
    return x if ax.n == 1 else _ReduceFrom.apply(x, ax)


def gather_from(ax: Axis, x: torch.Tensor, dim: int) -> torch.Tensor:
    if ax.n == 1:
        return x
    return _GatherFrom.apply(x, ax, dim % x.dim())


# ---------------------------------------------------------------------------
# op helpers: a leaf's local block and the dim the plan split it on
# ---------------------------------------------------------------------------

class LayerTP(NamedTuple):
    """What a layer needs under a model axis: the axis and the TP dim of
    each of its parameter leaves (a tree aligned with the layer's params,
    per-repeat coordinates; None: the leaf is whole)."""

    axis: Axis
    dims: dict
    batch: Optional[Axis] = None    # serving: the axis splitting the batch


def full(ax: Axis, w: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """A leaf gathered on use (an elementwise scale or bias, or a weight
    feeding replicated compute); the result is replicated."""
    return w if dim is None else gather_from(ax, w, dim)


def local_part(ax: Axis, w: torch.Tensor, dim: Optional[int],
               along: int) -> torch.Tensor:
    """This rank's block of a leaf along ``along`` for rank-local compute:
    the stored block when the plan split it there, else the whole leaf
    (gathered when split elsewhere) entering local compute."""
    if dim is not None and dim % w.dim() == along % w.dim():
        return w
    return own_block(ax, copy_to(ax, full(ax, w, dim)), along)


def linear(ax: Axis, x: torch.Tensor, w: torch.Tensor, dim: Optional[int],
           x_split: bool = False):
    """``x @ w`` for a (in, out) weight stored as its block along ``dim``;
    ``x`` replicated, or (``x_split``) this rank's block of its last dim.
    -> (y, y_split): input-split gives the float32 partial product summed
    over the axis and rounded once (replicated); output-split gives this
    rank's columns (split); a whole weight gives the replicated product."""
    if dim == 0:
        if not x_split:
            x = own_block(ax, copy_to(ax, x), -1)
        part = x.to(torch.float32) @ w.to(torch.float32)
        return reduce_from(ax, part).to(x.dtype), False
    if x_split:
        x = gather_from(ax, x, -1)
    if dim == 1:
        if ax.n == 1:
            return x @ w, True
        return _ColumnLinear.apply(x, w, ax), True
    return x @ w, False


def to_full(ax: Axis, y: torch.Tensor, split: bool) -> torch.Tensor:
    return gather_from(ax, y, -1) if split else y


def embed(ax: Axis, w: torch.Tensor, dim: Optional[int],
          tokens: torch.Tensor) -> torch.Tensor:
    """Embedding lookup of ``tokens`` in a (V, D) table stored as its block
    along ``dim``: over a vocab block each rank looks up the tokens it
    holds (zero elsewhere) and the rows are summed over the axis (exact:
    one rank adds a value, the others zeros); over a D block the columns
    are gathered."""
    if dim == 0:
        rows = w.shape[0]
        idx = tokens - ax.index * rows
        mine = (idx >= 0) & (idx < rows)
        out = w[idx.clamp(0, rows - 1)] * mine[..., None].to(w.dtype)
        return reduce_from(ax, out.to(torch.float32)).to(w.dtype)
    if dim == 1:
        return gather_from(ax, w[tokens], -1)
    return w[tokens]


def refuse(what: str):
    raise NotImplementedError(f"{what} under a model axis {_ROADMAP}")


class ModelTP(NamedTuple):
    """What ``LM`` reads under a sharded mesh: the model axis, the TP dim
    of every parameter path (per-repeat coordinates for a stacked leaf;
    None or absent: the leaf is whole), and, in the sharded serve step,
    per group a dict of each unit position's
    :class:`~repro_torch.models.blocks.CacheShard`."""

    axis: Axis
    dims: dict
    cache: Optional[tuple] = None
    batch: Optional[Axis] = None
