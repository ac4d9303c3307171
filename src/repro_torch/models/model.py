"""LM: the decoder-only model over LayerSpecs (the reference's
``models/model.py``): the training forward (``hidden_states``,
``logits``, the chunked ``loss``), the parts the serving engine calls,
and the dense ring-buffer decode (``init_cache``, ``decode_step``,
``prefill_chunk``, ``prefill``).

Layers are grouped into repeating units; each group's parameters are
stacked on a leading ``(repeats, ...)`` axis, exactly the reference's
params tree, so carrying weights across is a tree map
(``repro_torch.convert.params_from_jax``). The port's own ``init`` draws
from a ``torch.Generator`` (numbers differ from ``jax.random``'s).

Mixed precision is the reference's: f32 master weights, every leaf cast
to bf16 at its point of use, norms/rope/softmax/logsumexp in f32. The
backward is autograd through these plain ops (the reference's
``jax.value_and_grad``; no Pallas kernel is on this path). The
reference's ``cfg.remat`` (rematerialise each layer group in the
backward) changes no value, and the port ignores it: at the ported
sizes the activations fit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.blocks import (LayerSpec, apply_layer_decode,
                                      apply_layer_prefill_chunk,
                                      apply_layer_train, init_layer,
                                      init_layer_cache)
from repro_torch.models.layers import (dense_init, embed_init, rms_norm,
                                       softcap)


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


def _map_with(fn, paths, tree):
    """``fn(path, leaf)`` over a dict tree and its aligned path tree."""
    if isinstance(tree, dict):
        return {k: _map_with(fn, paths[k], v) for k, v in tree.items()}
    return fn(paths, tree)


class LM:
    """Decoder-only language model (GQA or MLA attention, dense or MoE
    FFNs, Mamba and RWKV-6 layers)."""

    compute_dtype = torch.bfloat16

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.specs = build_layer_specs(cfg)
        self.groups = build_groups(cfg, self.specs)

    def init(self, gen: torch.Generator, *, device=None) -> dict:
        """Float32 params in the reference's tree layout, drawn from
        ``gen`` on its device (a CPU generator gives the same weights
        whatever ``device`` is), then moved to ``device``: the card unless
        the caller passes ``device="cpu"``. A generator on the card draws
        full-width weights there, without a pass through host memory."""
        device = resolve_device(device)
        return map_tree(lambda t: t.to(device), self._build(gen))

    def abstract_params(self) -> dict:
        """The params tree with shapes and dtypes but no values (the large
        leaves are ``meta`` tensors): layouts and byte accounting at full
        size."""
        return self._build(None)

    def _build(self, gen: Optional[torch.Generator]) -> dict:
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
        return params

    def param_paths(self, params) -> dict:
        """Tree of path strings aligned with ``params``: the reference's
        gather paths (``"embed"``, ``"g0/pos0['attn']['wq']"``, ...), which
        policies are resolved against."""
        def named(prefix, tree):
            if isinstance(tree, dict):
                return {k: named(f"{prefix}[{k!r}]", v)
                        for k, v in tree.items()}
            return prefix

        out = {"embed": "embed",
               "final_norm": named("final_norm", params["final_norm"]),
               "groups": tuple({k: named(f"g{gi}/{k}", gp[k]) for k in gp}
                               for gi, gp in enumerate(params["groups"]))}
        if "lm_head" in params:
            out["lm_head"] = "lm_head"
        return out

    def _final_norm(self, p, x):
        return rms_norm(x, p, self.cfg.norm_eps)

    def _cast(self, leaf: torch.Tensor) -> torch.Tensor:
        if leaf.is_floating_point():
            return leaf.to(self.compute_dtype)
        return leaf

    def _cast_tree(self, tree):
        return map_tree(self._cast, tree)

    def _gather_leaf(self, path, leaf, salt, gather):
        if gather is None:
            return self._cast(leaf)
        return self._cast(gather(path, leaf, salt))

    def _head(self, params, gather=None) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self._gather_leaf("embed", params["embed"], 0, gather).T
        return self._gather_leaf("lm_head", params["lm_head"], 0, gather)

    # ------------------------------------------------------------------
    # training forward
    # ------------------------------------------------------------------
    def hidden_states(self, params, tokens: torch.Tensor, gather=None):
        """tokens (B, S) -> (final-normed hidden states (B, S, D) bf16,
        aux loss). Each group's stacked layers run in order.

        ``gather(path, leaf, salt) -> full leaf`` (the reference's gather
        hook, e.g. the per-leaf fsdp all-gather) is called on each leaf at
        its point of use: ``embed`` and ``final_norm`` whole with salt 0,
        a stacked layer leaf one repeat's slice at a time with the repeat
        index as its salt, under the paths of :meth:`param_paths`."""
        cfg = self.cfg
        paths = self.param_paths(params) if gather is not None else None
        x = self._embed(params, tokens, gather)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for gi, (g, gp) in enumerate(zip(self.groups, params["groups"])):
            for r in range(g.repeats):
                for j, spec in enumerate(g.unit):
                    unit = gp[f"pos{j}"]
                    if gather is None:
                        pj = map_tree(lambda t: self._cast(t[r]), unit)
                    else:
                        pj = _map_with(
                            lambda p, t: self._gather_leaf(p, t[r], r,
                                                           gather),
                            paths["groups"][gi][f"pos{j}"], unit)
                    x, a = apply_layer_train(cfg, spec, pj, x)
                    aux = aux + a
        fp = self._gather_leaf("final_norm", params["final_norm"], 0, gather)
        return self._final_norm(fp, x), aux

    def logits(self, params, tokens: torch.Tensor, gather=None):
        x, aux = self.hidden_states(params, tokens, gather)
        lg = (x @ self._head(params, gather)).to(torch.float32)
        return softcap(lg, self.cfg.final_softcap), aux

    def loss(self, params, batch, gather=None, *, loss_chunk: int = 512):
        """batch: {tokens (B, S)}. Next-token cross entropy, computed in
        sequence chunks so (B, S, V) logits never exist at once. Returns
        (loss, {"nll", "aux", "tokens"}) like the reference. ``gather`` as
        in :meth:`hidden_states` (the head too, salt 0)."""
        tokens = batch["tokens"].long()
        x, aux = self.hidden_states(params, tokens, gather)
        head = self._head(params, gather)
        inputs, targets = x[:, :-1], tokens[:, 1:]
        T = inputs.shape[1]
        ck = min(loss_chunk, T)
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, T, ck):
            lg = (inputs[:, c0:c0 + ck] @ head).to(torch.float32)
            lg = softcap(lg, self.cfg.final_softcap)
            tc = targets[:, c0:c0 + ck]
            tgt = torch.gather(lg, -1, tc[..., None])[..., 0]
            tot = tot + (torch.logsumexp(lg, dim=-1) - tgt).sum()
        cnt = torch.tensor(float(targets.numel()), device=x.device)
        loss = tot / torch.clamp(cnt, min=1.0)
        return loss + aux, {"nll": loss, "aux": aux, "tokens": cnt}

    # ------------------------------------------------------------------
    # dense ring-buffer decode (no gradients flow)
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, *,
                   device=None) -> tuple:
        """Empty caches, one dict per group with each unit position's
        layer caches stacked on a leading ``(repeats, ...)`` axis, as the
        reference lays them out; on the card unless ``device="cpu"``."""
        device = resolve_device(device)
        caches = []
        for g in self.groups:
            gc = {}
            for j, spec in enumerate(g.unit):
                one = init_layer_cache(self.cfg, spec, batch, max_len, dtype,
                                       device=device)
                gc[f"pos{j}"] = {k: torch.stack([t] * g.repeats)
                                 for k, t in one.items()}
            caches.append(gc)
        return tuple(caches)

    def _embed(self, params, tokens: torch.Tensor,
               gather=None) -> torch.Tensor:
        x = self._gather_leaf("embed", params["embed"], 0, gather)[
            tokens.long()]
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype)
        return x

    def _run_cached(self, params, cache, x, layer_fn):
        """Every layer in order, each with its view of ``cache``, then the
        final norm and the head -> f32 logits. An attention layer writes
        its view in place; the new state tensors a Mamba or RWKV layer
        returns are copied into it."""
        for g, gp, gc in zip(self.groups, params["groups"], cache):
            for r in range(g.repeats):          # the reference's scan
                for j, spec in enumerate(g.unit):
                    pj = map_tree(lambda t: self._cast(t[r]), gp[f"pos{j}"])
                    cj = {k: t[r] for k, t in gc[f"pos{j}"].items()}
                    x, new = layer_fn(spec, pj, x, cj)
                    for k, t in new.items():
                        if t is not cj[k]:
                            cj[k].copy_(t)
        x = self._final_norm(self._cast(params["final_norm"]), x)
        lg = (x @ self._head(params).to(x.dtype)).to(torch.float32)
        return softcap(lg, self.cfg.final_softcap)

    @torch.no_grad()
    def decode_step(self, params, cache, tokens: torch.Tensor, pos: int):
        """tokens (B, 1) at absolute position ``pos`` -> (logits (B, 1, V)
        f32, cache updated in place)."""
        lg = self._run_cached(
            params, cache, self._embed(params, tokens),
            lambda spec, p, x, c: apply_layer_decode(self.cfg, spec, p, x, c,
                                                     int(pos)))
        return lg, cache

    def supports_chunked_prefill(self) -> bool:
        """True when every layer has the chunked-prefill path (the GQA
        attention kinds; MLA, Mamba and RWKV take the token-by-token
        :meth:`prefill`)."""
        return (self.cfg.mla is None
                and all(s.kind in ("attn", "attn_local")
                        for s in self.specs))

    @torch.no_grad()
    def prefill_chunk(self, params, cache, tokens: torch.Tensor,
                      start: int):
        """tokens (B, T) at absolute positions start..start+T-1 ->
        (logits (B, T, V) f32, cache updated in place): one forward over
        the chunk instead of T decode steps. The caller guarantees that
        start + T fits every layer's cache (no ring wrap)."""
        lg = self._run_cached(
            params, cache, self._embed(params, tokens),
            lambda spec, p, x, c: apply_layer_prefill_chunk(
                self.cfg, spec, p, x, c, int(start)))
        return lg, cache

    def prefill(self, params, cache, tokens: torch.Tensor):
        """Sequential prefill through :meth:`decode_step`, one token at a
        time (the reference loop) -> (last logits (B, 1, V), cache)."""
        lg = None
        for i in range(tokens.shape[1]):
            lg, cache = self.decode_step(params, cache, tokens[:, i:i + 1],
                                         i)
        return lg, cache
