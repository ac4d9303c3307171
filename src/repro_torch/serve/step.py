"""Sharded serving: the cached decode step and the prefill forwards over a
mesh (the reference's ``serve/step.py``).

No gradients flow at serving time, so the paper's quantized collectives
are not on this path; parameters are bf16 and tensor-parallel over
``model`` by :func:`plan_serve_sharding`, the reference's plan. The cache
is split as the reference splits it:

* batched decode: batch over the dp axes, the cache's SEQUENCE (slot)
  dim over ``model``; the attention runs over each rank's slots and the
  partial softmaxes are combined (``models/attention.py``
  ``split_attention``, the flash-decoding combine XLA derives in the
  reference);
* long-context decode (``seq_sharded=True``, batch 1): the slot dim over
  the dp axes and ``model`` together, the batch replicated.

A layer whose slot count does not divide stays whole (sliding-window
layers with a short cache), as the reference's ``cspec`` leaves it.
The int32 slot-position table ``(reps, C)`` is split on its slot dim over
the dp axes by the same rule (``cspec`` takes dim 1 for the batch); the
step gathers it where it is split.

The steps take and return this rank's blocks (``convert.shard_params`` /
``shard_cache`` slice a whole tree); on a world of one they are the
model's own ``decode_step`` / ``prefill_chunk`` / ``logits``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

from repro_torch.models import tp as tp_mod
from repro_torch.models.blocks import CacheShard
from repro_torch.models.model import LM
from repro_torch.utils.pytree import tree_leaves
from repro_torch.utils.sharding import dp_axis_names


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """``param_specs``: path -> spec of every parameter leaf;
    ``cache_specs``: a tree aligned with the cache, a spec per leaf (a spec
    is a tuple with one entry per dim: None, an axis name or a tuple of
    names); ``axis_sizes``: {axis: size} of the mesh planned for;
    ``paths``: the params' tree of path strings."""

    param_specs: Dict[str, tuple]
    cache_specs: Any
    axis_sizes: Dict[str, int]
    paths: Any = None               # the params' tree of path strings

    def tp_dims(self) -> Dict[str, Any]:
        """path -> the dim (per-repeat coordinates) split over ``model``,
        or None."""
        out = {}
        for path, spec in self.param_specs.items():
            off = 1 if (path.startswith("g") or path.startswith("enc/g")) \
                else 0
            out[path] = next((i - off for i, e in enumerate(spec)
                              if e == "model"), None)
        return out


def _map_cache(fn, cache):
    """``fn`` over the leaves of a cache tree (tuple of dicts of dicts)."""
    if isinstance(cache, dict):
        return {k: _map_cache(fn, v) for k, v in cache.items()}
    if isinstance(cache, (tuple, list)):
        return type(cache)(_map_cache(fn, v) for v in cache)
    return fn(cache)


def plan_serve_sharding(model: LM, aparams, acache, mesh, *,
                        seq_sharded: bool = False) -> ServePlan:
    """The reference's plan from shapes only (``aparams`` / ``acache``
    may be meta tensors): each parameter leaf split over ``model`` on its
    experts dim, else its largest divisible dim (the first of equal
    sizes); each cache leaf as the module docstring says."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    n_model = sizes.get("model", 1)
    dp_axes = dp_axis_names(mesh.axis_names)
    n_dp = math.prod(sizes[a] for a in dp_axes) if dp_axes else 1
    dp_ent = dp_axes if len(dp_axes) > 1 else (dp_axes[0] if dp_axes
                                               else None)
    n_exp = model.cfg.moe.num_experts if model.cfg.moe else -1

    def pspec(path, leaf):
        shape = tuple(leaf.shape)
        off = 1 if (path.startswith("g") or path.startswith("enc/g")) else 0
        sl = shape[off:]
        cand = [i for i, s in enumerate(sl)
                if s % n_model == 0 and s >= n_model]
        ent = [None] * len(shape)
        if cand and n_model > 1:
            pref = [i for i in cand if sl[i] == n_exp]
            t = pref[0] if pref else max(cand, key=lambda i: sl[i])
            ent[off + t] = "model"
        return tuple(ent)

    def cspec(leaf):
        ent = [None] * leaf.dim()
        if leaf.dim() >= 2 and dp_ent is not None:
            if seq_sharded:
                if leaf.dim() >= 3:
                    both = dp_axes + ("model",) if n_model > 1 else dp_axes
                    total = n_dp * (n_model if n_model > 1 else 1)
                    if leaf.shape[2] % total == 0:
                        ent[2] = both
                    elif leaf.shape[2] % n_dp == 0:
                        ent[2] = dp_ent
            else:
                if leaf.shape[1] % n_dp == 0:
                    ent[1] = dp_ent
                if (leaf.dim() >= 3 and n_model > 1
                        and leaf.shape[2] % n_model == 0):
                    ent[2] = "model"
        return tuple(ent)

    paths = model.param_paths(aparams)
    param_specs = {p: pspec(p, x) for p, x in zip(tree_leaves(paths),
                                                  tree_leaves(aparams))}
    return ServePlan(param_specs=param_specs,
                     cache_specs=_map_cache(cspec, acache),
                     axis_sizes=sizes, paths=paths)


def _is_trivial(mesh) -> bool:
    return math.prod(mesh.shape) == 1


def _axis(mesh, entry) -> "tp_mod.Axis":
    return tp_mod.Axis(None, 1, 0) if entry is None else mesh.axis_for(
        entry)


def model_tp(model: LM, mesh, plan: ServePlan,
             batch_dp: bool = True) -> "tp_mod.ModelTP":
    """The ``tp`` the model's cached paths read: the model axis, the
    plan's TP dims, each layer's :class:`CacheShard` (from its ``k``
    leaf's slot entry and its ``pos`` leaf's) and the batch's axis."""
    model.check_tp(mesh.n_model)
    shards = tuple(
        {pos: CacheShard(seq=_axis(mesh, specs["k"][2]),
                         pos=_axis(mesh, specs["pos"][1]))
         for pos, specs in gc.items()}
        for gc in plan.cache_specs)
    # the batch's axis, where the plan splits the cache's batch dim
    entries = {specs["k"][1] for gc in plan.cache_specs
               for specs in gc.values()}
    entry = entries.pop() if len(entries) == 1 else None
    batch = mesh.axis_for(entry) if batch_dp and entry is not None else None
    return tp_mod.ModelTP(mesh.model_axis, plan.tp_dims(), shards, batch)


def make_serve_step(model: LM, mesh, plan: ServePlan, *,
                    batch_dp: bool = True):
    """decode one token: ``step(params, cache, tokens (B, 1), pos) ->
    (logits (B, 1, V) f32, cache)`` on this rank's blocks, the cache
    updated in place; ``tokens`` and the logits are this rank's block of
    the batch (``batch_dp=False``: the whole batch on every rank, the
    long-context layout whose cache slot dim carries the dp split)."""
    if _is_trivial(mesh):
        return lambda params, cache, tokens, pos: model.decode_step(
            params, cache, tokens, pos)
    tp = model_tp(model, mesh, plan, batch_dp)

    def step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, tp=tp)

    return step


def make_chunked_prefill_step(model: LM, mesh, plan: ServePlan):
    """Cache-filling chunked prefill: ``step(params, cache, tokens (B, T),
    start) -> (logits (B, T, V), cache)``, writing the chunk's K/V at
    slots start..start+T-1 (the caller guarantees no ring wrap), on this
    rank's blocks."""
    if _is_trivial(mesh):
        return lambda params, cache, tokens, start: model.prefill_chunk(
            params, cache, tokens, start)
    tp = model_tp(model, mesh, plan)

    def step(params, cache, tokens, start):
        return model.prefill_chunk(params, cache, tokens, start, tp=tp)

    return step


def make_prefill_step(model: LM, mesh, plan: ServePlan):
    """The forward over whole prompts: ``step(params, {"tokens": (B, S)})
    -> logits (B, S, V)`` on this rank's parameter blocks and batch rows
    (head-parallel attention, as in training)."""
    if _is_trivial(mesh):
        return lambda params, batch: model.logits(params, batch["tokens"])[0]
    model.check_tp(mesh.n_model)
    tp = tp_mod.ModelTP(mesh.model_axis, plan.tp_dims(),
                        batch=mesh.dp_axis)

    def step(params, batch):
        return model.logits(params, batch["tokens"], tp=tp)[0]

    return step


__all__ = ["ServePlan", "plan_serve_sharding", "make_serve_step",
           "make_chunked_prefill_step", "make_prefill_step", "model_tp"]
