"""Sharding specs: which dimension of each parameter leaf ZeRO-3 shards
over the data-parallel workers (the reference's ``utils/sharding.py``).

Parameters are stored ZeRO-3 style: each leaf is split over the combined
data-parallel axes ``(pod, data)`` along one dimension, the "fsdp dim".
A spec is a tuple with one entry per leaf dimension: ``None``, an axis
name, or a tuple of axis names (the reference's ``PartitionSpec``
entries). Worker ``w`` of the combined axes holds block ``w`` of the
sharded dimension; the combined enumeration is inter-major, so worker
``w = pod * n_data + data``, which is the process group rank.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

# Canonical data-parallel axes, slow to fast (pod = across pods, data =
# within a pod). Every dp-axis selection goes through dp_axis_names, so
# the order cannot drift between call sites.
DP_AXIS_ORDER: Tuple[str, ...] = ("pod", "data")

Spec = Tuple[object, ...]


def dp_axis_names(axis_names: Sequence[str]) -> Tuple[str, ...]:
    """The data-parallel axes among ``axis_names``, in canonical order
    (pod before data)."""
    return tuple(a for a in DP_AXIS_ORDER if a in tuple(axis_names))


def choose_fsdp_dim(shape: Sequence[int], n_shards: int, *,
                    skip_dims: Tuple[int, ...] = (),
                    prefer_sizes: Tuple[int, ...] = ()) -> Optional[int]:
    """The dimension to shard ``n_shards`` ways, or None to replicate: a
    dim whose size is in ``prefer_sizes`` (the d_model-sized dims) first,
    then the largest divisible dim. Dims in ``skip_dims`` are never
    chosen."""
    candidates = [i for i, s in enumerate(shape)
                  if i not in skip_dims and i - len(shape) not in skip_dims
                  and s % n_shards == 0 and s > 0]
    if not candidates:
        return None
    for i in candidates:
        if shape[i] in prefer_sizes:
            return i
    return max(candidates, key=lambda i: shape[i])


def spec_dp_dim(spec: Spec, dp_axes: Tuple[str, ...]) -> Optional[int]:
    """The dimension ``spec`` shards over the dp axes (full leaf
    coordinates), or None for a dp-replicated leaf."""
    dp = set(dp_axes)
    for i, ent in enumerate(spec):
        if ent is None:
            continue
        names = ent if isinstance(ent, (tuple, list)) else (ent,)
        if any(a in dp for a in names):
            return i
    return None


def leaf_fsdp_spec(shape: Sequence[int], n_shards: int,
                   dp_axes: Tuple[str, ...], *,
                   skip_dims: Tuple[int, ...] = (),
                   prefer_sizes: Tuple[int, ...] = ()) -> Spec:
    """The spec placing the combined dp axes on the chosen fsdp dim."""
    dim = choose_fsdp_dim(shape, n_shards, skip_dims=skip_dims,
                          prefer_sizes=prefer_sizes)
    if dim is None:
        return ()
    spec = [None] * len(shape)
    spec[dim] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    return tuple(spec)


def shard_slice(full, dim: Optional[int], n_shards: int, worker: int):
    """Worker ``worker``'s block of ``full`` along ``dim`` (the whole leaf
    when ``dim`` is None)."""
    if dim is None:
        return full
    size = full.shape[dim] // n_shards
    return full.narrow(dim, worker * size, size)
