"""Parameter trees in the reference's canonical leaf order.

The port keeps parameters in plain dicts, tuples and lists, in the
reference's layout. ``jax.tree_util`` flattens a dict by SORTED key,
whatever order its keys were inserted in; the fused exchange's flat
buffer (and with it every bucket boundary and every rounding decision)
depends on that order, so the port flattens the same way. Path strings
are ``jax.tree_util.keystr``'s: ``['key']`` for a dict entry, ``[i]`` for
a sequence entry. ``None`` is an empty subtree, as in jax.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_flatten_with_path(tree) -> Tuple[List[Tuple[str, Any]], Any]:
    """-> ([(path, leaf), ...] in canonical order, treedef). The treedef
    is the tree itself, used only for its structure."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}[{k!r}]")
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        elif node is not None:
            out.append((path, node))

    walk(tree, "")
    return out, tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)[0]]


def tree_unflatten(treedef, leaves):
    """Rebuild ``treedef``'s structure (dict keys in its own order) from
    leaves given in canonical order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            vals = {k: build(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        if node is None:
            return None
        return next(it)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over aligned leaves of ``tree`` and ``rest`` (same
    structure); the result has ``tree``'s structure."""
    others = [tree_leaves(t) for t in rest]
    leaves = tree_leaves(tree)
    return tree_unflatten(tree, [fn(*xs) for xs in zip(leaves, *others)])
