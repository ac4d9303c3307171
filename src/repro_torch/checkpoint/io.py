"""Checkpoints: a tree <-> an .npz with a structure manifest, in the
reference's file format (``checkpoint/io.py``), so each package reads
the other's files.

Leaves are written as a flat npz keyed by ``jax.tree_util.keystr``'s path
strings: ``['key']`` for a dict entry, ``[i]`` for a tuple or list entry,
``.name`` for a NamedTuple field (a ``TrainState`` is ``.params[...]``,
``.opt...``, ``.step``, ``.ef[...]`` and, in two_level_async mode,
``.outer.anchor[...]`` / ``.outer.mom[...]``). ``None`` is an empty
subtree. A Python int leaf (the step counter, AdamW's count) is an int32
scalar, as the reference's ``jnp.int32``.

Crash safety: both files are written to temporary paths and committed
with ``os.replace``; the manifest is also embedded in the npz
(``__manifest__``), so the npz replace is the single atomic commit point.
The external ``.manifest.json`` is kept for inspection and for files
written without the embedded copy.

Restore is strict: a shape or dtype mismatch, or a missing or extra key,
raises ``ValueError`` naming the key; nothing is cast silently.
"""
from __future__ import annotations

import json
import os
from typing import Any, List, Tuple

import numpy as np
import torch


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten_with_keys(tree) -> List[Tuple[str, Any]]:
    """[(keystr, leaf), ...] in jax's canonical order (sorted dict keys,
    NamedTuple fields in declaration order)."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}[{k!r}]")
        elif _is_namedtuple(node):
            for name, v in zip(node._fields, node):
                walk(v, f"{path}.{name}")
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        elif node is not None:
            out.append((path, node))

    walk(tree, "")
    return out


def _unflatten_like(like, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            vals = {k: build(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*[build(v) for v in node])
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        if node is None:
            return None
        return next(it)

    return build(like)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, (bool, np.bool_)):
        return np.asarray(leaf)
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, dtype=np.int32)
    return np.asarray(leaf)


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    """Write ``tree`` (torch tensors, Python ints) atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _flatten_with_keys(tree)}
    order = sorted(flat)
    manifest = {"keys": order, "step": int(step)}
    npz = _npz_path(path)
    tmp = npz + ".tmp"
    # a file object, so np.savez does not append ".npz" to the temp name;
    # a crash here leaves only the *.tmp file behind
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f, __manifest__=np.asarray(json.dumps(manifest)),
            **{f"arr_{i}": flat[k] for i, k in enumerate(order)})
    os.replace(tmp, npz)     # the atomic commit point
    mpath = path + ".manifest.json"
    tmp_m = mpath + ".tmp"
    with open(tmp_m, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp_m, mpath)


def _load_manifest(path: str, data) -> dict:
    if "__manifest__" in data:
        return json.loads(str(data["__manifest__"][()]))
    with open(path + ".manifest.json") as f:
        return json.load(f)


def _want(leaf) -> Tuple[Tuple[int, ...], np.dtype]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), torch.empty(0, dtype=leaf.dtype).numpy(
        ).dtype
    arr = _to_numpy(leaf)
    return tuple(arr.shape), arr.dtype


def load_checkpoint(path: str, like: Any):
    """Restore into the structure of ``like`` -> (tree, step). Shapes and
    dtypes must match exactly; tensors land on the device of ``like``'s
    leaf, int leaves come back as Python ints."""
    data = np.load(_npz_path(path))
    manifest = _load_manifest(path, data)
    by_key = {k: data[f"arr_{i}"] for i, k in enumerate(manifest["keys"])}
    pairs = _flatten_with_keys(like)
    want_keys = [k for k, _ in pairs]
    missing = [k for k in want_keys if k not in by_key]
    extra = sorted(set(by_key) - set(want_keys))
    if missing or extra:
        raise ValueError(
            f"checkpoint {path!r} does not match the restore target: "
            f"missing keys {missing[:5]}{'...' if len(missing) > 5 else ''} "
            f"(total {len(missing)}), extra keys "
            f"{extra[:5]}{'...' if len(extra) > 5 else ''} "
            f"(total {len(extra)})")
    leaves = []
    for key, leaf in pairs:
        arr = by_key[key]
        shape, dtype = _want(leaf)
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {tuple(arr.shape)} but "
                f"the restore target expects {shape}")
        if np.dtype(arr.dtype) != dtype:
            raise ValueError(
                f"checkpoint leaf {key!r} has dtype {arr.dtype} but the "
                f"restore target expects {dtype}; refusing to cast "
                f"silently")
        if isinstance(leaf, torch.Tensor):
            leaves.append(torch.from_numpy(np.array(arr, copy=True)).to(
                leaf.device))
        else:
            leaves.append(arr.item())
    return _unflatten_like(like, leaves), manifest["step"]
