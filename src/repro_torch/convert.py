"""Carry a reference params tree, or a whole training state, across to
the port, and cut a whole tree into one rank's blocks of a sharding plan.

The port keeps the reference's params layout (dicts, the tuple of groups,
the stacked ``(repeats, ...)`` axis), so conversion is a tree map over
numpy leaves. bfloat16 leaves (numpy arrays of the ``ml_dtypes`` type the
reference hands out) are reinterpreted bit for bit.

A plan (``train.step.ShardingPlan`` or ``serve.step.ServePlan``) gives
each leaf a spec, one entry per dim: None, an axis name, or a tuple of
names (split over their product, the first slowest). ``shard_params`` /
``shard_cache`` keep the block at this rank's coordinates (``{axis:
index}``, ``HostMesh.coords``); ``unshard_params`` concatenates the blocks
of one axis back.
"""
from __future__ import annotations


import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.utils.pytree import tree_leaves, tree_unflatten


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree, device=None):
    """Tree of numpy arrays in the reference's layout (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) -> the same tree of
    tensors on ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return None if node is None else _leaf(node, dev)

    return walk(tree)


def state_from_jax(state, device=None):
    """A reference ``TrainState`` (params, SGD momentum, EF residuals as
    a params-shaped tree, a tuple of group buffers or None, step, and the
    two_level_async outer anchor and momentum or None), its leaves fetched
    as numpy (e.g. ``jax.tree_util.tree_map(np.asarray, state)`` or the
    state itself) -> the port's ``TrainState`` on ``device``. The arrays
    are the global ones: on one worker they are its fsdp shards too (and
    its async params and optimizer state keep their leading worker axis
    of one: ``StateSharding.scatter`` takes the worker's row)."""
    from repro_torch.train.state import OuterState, TrainState

    outer = getattr(state, "outer", None)
    return TrainState(
        params=params_from_jax(state.params, device),
        opt=params_from_jax(state.opt, device),
        step=int(np.asarray(state.step)),
        ef=None if state.ef is None else params_from_jax(state.ef, device),
        outer=None if outer is None else OuterState(
            anchor=params_from_jax(outer.anchor, device),
            mom=params_from_jax(outer.mom, device)))


def _names(ent):
    return tuple(ent) if isinstance(ent, (tuple, list)) else (ent,)


def _block(x: torch.Tensor, spec, coords, sizes) -> torch.Tensor:
    """The block of ``x`` at ``coords`` under ``spec`` (a copy)."""
    for dim, ent in enumerate(spec):
        if ent is None:
            continue
        n, idx = 1, 0
        for a in _names(ent):
            n, idx = n * sizes[a], idx * sizes[a] + coords[a]
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x.clone()


def _param_specs(plan) -> dict:
    return getattr(plan, "param_specs", None) or plan.specs


def shard_params(params, plan, coords):
    """A whole params tree -> this rank's blocks of it under ``plan``."""
    specs, sizes = _param_specs(plan), plan.axis_sizes
    return tree_unflatten(params, [
        _block(x, specs[p], coords, sizes)
        for p, x in zip(tree_leaves(plan.paths), tree_leaves(params))])


def shard_cache(cache, plan, coords):
    """A whole decode cache -> this rank's blocks under ``plan``'s cache
    specs (a tree aligned with the cache)."""
    sizes = plan.axis_sizes

    def walk(c, s):
        if isinstance(c, dict):
            return {k: walk(c[k], s[k]) for k in c}
        if isinstance(c, (tuple, list)):
            return type(c)(walk(a, b) for a, b in zip(c, s))
        return _block(c, s, coords, sizes)

    return walk(cache, plan.cache_specs)


def unshard_params(parts, plan, axis: str = "model"):
    """The blocks of one axis (``parts[i]``: the tree at index i along
    ``axis``, the other coordinates fixed) concatenated back along each
    leaf's dim split over ``axis`` alone."""
    specs = _param_specs(plan)
    leaves = [tree_leaves(t) for t in parts]
    out = []
    for j, path in enumerate(tree_leaves(plan.paths)):
        dim = next((i for i, e in enumerate(specs[path])
                    if e is not None and _names(e) == (axis,)), None)
        blocks = [ls[j] for ls in leaves]
        out.append(blocks[0] if dim is None else torch.cat(blocks, dim=dim))
    return tree_unflatten(parts[0], out)


__all__ = ["params_from_jax", "state_from_jax", "shard_params",
           "shard_cache", "unshard_params"]
