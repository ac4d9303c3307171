"""Carry a reference params tree, or a whole training state, across to
the port.

The port keeps the reference's params layout (dicts, the tuple of groups,
the stacked ``(repeats, ...)`` axis), so conversion is a tree map over
numpy leaves. bfloat16 leaves (numpy arrays of the ``ml_dtypes`` type the
reference hands out) are reinterpreted bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


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
