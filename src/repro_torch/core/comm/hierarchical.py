"""The two-level hierarchy: full precision within a pod, quantized across
pods (the reference's ``core/comm/hierarchical.py``).

On a world of ``n_inter`` pods of ``n_intra`` workers (dp axes
``("pod", "data")``, rank = pod * n_intra + data, inter-major as the
reference's mesh enumerates its devices) the exchange runs in three
phases:

    phase 0 (intra, full precision)  ``intra_reduce_scatter_mean``: each
        worker ends with a 1/n_intra shard of its pod's mean gradient.
    phase 1+2 (inter, quantized)     Algorithm 2 on that shard over the
        pod group only (``collectives.quantized_all_reduce_mean``).
    phase 3 (intra, full precision)  ``intra_all_gather`` reassembles the
        global mean inside each pod.

The quantized traffic across pods shrinks by 1/n_intra. A world with one
pod, or pods of one worker, degenerates to the flat split and is the flat
exchange. The axis names stand in for the reference's mesh axes; the
process groups (:func:`pod_groups`) carry the collectives.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.comm.collectives import _all_gather, scatter_mean, world

# dp axes that cross pods; the rest of the dp tuple stays within a pod
INTER_AXIS_NAMES: Tuple[str, ...] = ("pod",)

HIERARCHIES = ("flat", "two_level", "two_level_async", "auto")


def resolve_hierarchy(hierarchy: str, dp_axes: Sequence[str],
                      local_steps: int = 1) -> str:
    """'flat', 'two_level' or 'two_level_async' for a dp axis tuple;
    'auto' picks two_level whenever there are >= 2 dp axes (never the
    temporal variant). 'two_level_async' with ``local_steps <= 1`` is
    'two_level'."""
    if hierarchy not in HIERARCHIES:
        raise ValueError(
            f"hierarchy must be one of {HIERARCHIES}, got {hierarchy!r}")
    if hierarchy == "auto":
        return "two_level" if len(tuple(dp_axes)) >= 2 else "flat"
    if hierarchy == "two_level_async" and local_steps <= 1:
        return "two_level"
    return hierarchy


def split_dp_axes(dp_axes: Sequence[str], hierarchy: str
                  ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """The ordered dp axes -> ``(intra_axes, inter_axes)``: flat (and a
    world with no pod axis, or only one) quantizes over everything,
    ``((), dp_axes)``; two_level quantizes over the pod axis only. The
    inter axes must precede the intra axes (inter-major enumeration)."""
    dp = tuple(dp_axes)
    if resolve_hierarchy(hierarchy, dp) == "flat":
        return (), dp
    inter = tuple(a for a in dp if a in INTER_AXIS_NAMES)
    intra = tuple(a for a in dp if a not in INTER_AXIS_NAMES)
    if not inter or not intra:
        return (), dp
    if dp != inter + intra:
        raise ValueError(
            f"inter axes {inter} must precede intra axes {intra} in the dp "
            f"tuple {dp}: the combined worker enumeration (and the fused "
            f"fsdp row layout) is inter-major")
    return intra, inter


def pod_groups(n_inter: int, n_intra: int, backend=None, n_model: int = 1):
    """(intra group, inter group) of this rank in a world of ``n_inter``
    pods of ``n_intra`` workers, rank = pod * n_intra + data; with a model
    axis of ``n_model`` (``launch.mesh``) the worker of dp index ``w`` and
    model index ``m`` is rank ``w * n_model + m``, and each model index has
    its own pods. Every rank creates every group, in the same order
    (``dist.new_group`` is collective); ``backend`` as ``dist.new_group``
    takes it."""
    if dist.get_world_size() != n_inter * n_intra * n_model:
        raise ValueError(f"{n_inter} pods of {n_intra} workers need a world "
                         f"of {n_inter * n_intra * n_model}, got "
                         f"{dist.get_world_size()}")
    dp_rank, mine = divmod(dist.get_rank(), n_model)
    intra = inter = None
    for m in range(n_model):
        for p in range(n_inter):
            g = dist.new_group([(p * n_intra + d) * n_model + m
                                for d in range(n_intra)], backend=backend)
            if m == mine and dp_rank // n_intra == p:
                intra = g
    for m in range(n_model):
        for d in range(n_intra):
            g = dist.new_group([(p * n_intra + d) * n_model + m
                                for p in range(n_inter)], backend=backend)
            if m == mine and dp_rank % n_intra == d:
                inter = g
    return intra, inter


# ---------------------------------------------------------------------------
# full-precision intra-pod primitives
# ---------------------------------------------------------------------------

def intra_chunk_len(n: int, n_intra: int) -> int:
    """Per-worker shard length of an (n,) buffer scattered over
    ``n_intra`` workers (ceil division; the tail shard is padded)."""
    return -(-n // max(n_intra, 1))


def intra_reduce_scatter_mean(flat: torch.Tensor, intra_group
                              ) -> torch.Tensor:
    """(n,) local buffer -> (ceil(n/L_i),) shard of the pod's mean, in
    full precision (``collectives.scatter_mean``)."""
    L = world(intra_group)[0]
    n = flat.shape[0]
    chunk = intra_chunk_len(n, L)
    padded = F.pad(flat.to(torch.float32), (0, L * chunk - n))
    return scatter_mean(padded.reshape(L, chunk), intra_group)


def intra_all_gather(shard: torch.Tensor, intra_group, n: int
                     ) -> torch.Tensor:
    """(chunk,) per-worker shard -> the reassembled (n,) buffer (inverse
    of :func:`intra_reduce_scatter_mean`)."""
    return _all_gather(shard, intra_group).reshape(-1)[:n]


def shard_valid_mask(n: int, intra_group, device=None) -> torch.Tensor:
    """(chunk,) bool: which positions of this worker's intra shard hold
    real elements of the (n,) buffer (False: scatter padding, kept out of
    the level fits)."""
    L, d = world(intra_group)
    chunk = intra_chunk_len(n, L)
    return d * chunk + torch.arange(chunk, device=device) < n
