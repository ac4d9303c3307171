"""LM: the decoder-only model over LayerSpecs, the parts the serving engine
calls (the reference's ``models/model.py``).

Layers are grouped into repeating units; each group's parameters are
stacked on a leading ``(repeats, ...)`` axis, exactly the reference's
params tree, so carrying weights across is a tree map
(``repro_torch.convert.params_from_jax``). The port's own ``init`` draws
from a ``torch.Generator`` (numbers differ from ``jax.random``'s).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.blocks import LayerSpec, init_layer
from repro_torch.models.layers import dense_init, embed_init, rms_norm


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    unit: Tuple[LayerSpec, ...]
    repeats: int
    start: int          # global index of the group's first layer


def build_layer_specs(cfg: ModelConfig, *, decoder: bool = True):
    return [LayerSpec(kind=cfg.layer_kind(i), moe=cfg.layer_is_moe(i),
                      d_ff=cfg.layer_ff(i),
                      cross_attn=decoder and cfg.encoder is not None,
                      causal=decoder)
            for i in range(cfg.num_layers)]


def build_groups(cfg: ModelConfig, specs) -> Tuple[GroupSpec, ...]:
    groups = []
    i = 0
    if cfg.first_layer_dense_ff:
        groups.append(GroupSpec(unit=(specs[0],), repeats=1, start=0))
        i = 1
    P = math.lcm(len(cfg.layer_pattern), cfg.moe_every or 1)
    main = len(specs) - i
    n_rep, rem = divmod(main, P)
    if n_rep:
        groups.append(GroupSpec(unit=tuple(specs[i:i + P]), repeats=n_rep,
                                start=i))
    if rem:
        start = i + n_rep * P
        groups.append(GroupSpec(unit=tuple(specs[start:]), repeats=1,
                                start=start))
    return tuple(groups)


def _stack(trees):
    """List of identical param trees -> one tree with a leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def map_tree(fn, tree):
    """Apply ``fn`` to every tensor leaf of a dict / tuple / list tree."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


class LM:
    """Decoder-only language model (dense GQA stacks)."""

    compute_dtype = torch.bfloat16

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.specs = build_layer_specs(cfg)
        self.groups = build_groups(cfg, self.specs)

    def init(self, gen: torch.Generator, *, device=None) -> dict:
        """Float32 params in the reference's tree layout, drawn from
        ``gen`` on the CPU (so a seed gives the same weights on any
        device), then moved to ``device``: the card unless the caller
        passes ``device="cpu"``."""
        device = resolve_device(device)
        cfg = self.cfg
        params = {
            "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model)),
            "groups": tuple(
                {f"pos{j}": _stack([init_layer(cfg, spec, gen)
                                    for _ in range(g.repeats)])
                 for j, spec in enumerate(g.unit)}
                for g in self.groups),
            "final_norm": torch.zeros(cfg.d_model),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, (cfg.d_model,
                                                 cfg.vocab_size))
        return map_tree(lambda t: t.to(device), params)

    def _final_norm(self, p, x):
        return rms_norm(x, p, self.cfg.norm_eps)

    def _cast(self, leaf: torch.Tensor) -> torch.Tensor:
        if leaf.is_floating_point():
            return leaf.to(self.compute_dtype)
        return leaf

    def _cast_tree(self, tree):
        return map_tree(self._cast, tree)

    def _head(self, params) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self._cast(params["embed"]).T
        return self._cast(params["lm_head"])
