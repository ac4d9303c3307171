"""LM: the decoder-only or encoder-decoder model over LayerSpecs (the
reference's ``models/model.py``): the training forward (``hidden_states``,
``logits``, the chunked ``loss``), the parts the serving engine calls,
and the dense ring-buffer decode (``init_cache``, ``decode_step``,
``prefill_chunk``, ``prefill``). With ``cfg.encoder`` (whisper) an
encoder of non-causal attention layers (``encode``) runs over frame
embeddings the caller supplies (``enc_embeds``, the reference's stub of
the mel/conv frontend), and every decoder layer cross-attends to its
output; ``warm_cache`` writes the cross K/V into the decode cache.

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

Under a sharded mesh the forward, the loss, the encoder, ``warm_cache``
and the cached decode take a ``tp``
(:class:`~repro_torch.models.tp.ModelTP`): the params are this rank's
blocks by the plan, the embedding, the head and every layer run on them
(``blocks.apply_layer_train_tp`` / ``apply_layer_cached_tp``), and the
logits are gathered over V before the loss or the caller sees them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import tp as tp_mod
from repro_torch.models.blocks import (LayerSpec, _gqa_kv,
                                      apply_layer_cached_tp,
                                      apply_layer_decode,
                                      apply_layer_prefill_chunk,
                                      apply_layer_train,
                                      apply_layer_train_tp,
                                      check_ported_layer, cross_kv_tp,
                                      init_layer, init_layer_cache,
                                      mamba_spec, rwkv_spec)
from repro_torch.models.layers import (dense_init, embed_init, layer_norm,
                                       rms_norm, softcap)


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
    if first.device.type == "meta":      # shapes only: no meta kernel runs
        return torch.empty((len(trees),) + tuple(first.shape),
                           dtype=first.dtype, device="meta")
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


def _named(prefix: str, tree):
    """The reference's ``prefix + keystr(path)`` of every leaf of a dict
    tree (``prefix`` itself for a bare leaf)."""
    if isinstance(tree, dict):
        return {k: _named(f"{prefix}[{k!r}]", v) for k, v in tree.items()}
    return prefix


def _norm_params(cfg: ModelConfig) -> dict | torch.Tensor:
    if cfg.norm == "ln":
        return {"scale": torch.ones(cfg.d_model),
                "bias": torch.zeros(cfg.d_model)}
    return torch.zeros(cfg.d_model)


class LM:
    """Language model (GQA or MLA attention, dense or MoE FFNs, Mamba and
    RWKV-6 layers), decoder-only or, with ``cfg.encoder``, encoder-decoder
    (whisper)."""

    compute_dtype = torch.bfloat16

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.specs = build_layer_specs(cfg)
        self.groups = build_groups(cfg, self.specs)
        if cfg.encoder:
            self.enc_cfg = dataclasses.replace(
                cfg, num_layers=cfg.encoder.num_layers, moe_every=0,
                layer_pattern=("attn",), first_layer_dense_ff=0)
            self.enc_specs = build_layer_specs(self.enc_cfg, decoder=False)
            self.enc_groups = build_groups(self.enc_cfg, self.enc_specs)

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

    @staticmethod
    def _build_groups(cfg, groups, gen) -> tuple:
        return tuple({f"pos{j}": _stack([init_layer(cfg, spec, gen)
                                         for _ in range(g.repeats)])
                      for j, spec in enumerate(g.unit)}
                     for g in groups)

    def _build(self, gen: Optional[torch.Generator]) -> dict:
        cfg = self.cfg
        params = {
            "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model)),
            "groups": self._build_groups(cfg, self.groups, gen),
            "final_norm": _norm_params(cfg),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, (cfg.d_model,
                                                 cfg.vocab_size))
        if cfg.encoder:
            params["encoder"] = {
                "pos_embed": embed_init(gen, (cfg.encoder.num_frames,
                                              cfg.d_model)),
                "groups": self._build_groups(self.enc_cfg, self.enc_groups,
                                             gen),
                "final_norm": _norm_params(cfg),
            }
        return params

    def param_paths(self, params) -> dict:
        """Tree of path strings aligned with ``params``: the reference's
        gather paths (``"embed"``, ``"g0/pos0['attn']['wq']"``, ...), which
        policies are resolved against."""
        def group_paths(groups_p, prefix=""):
            return tuple({k: _named(f"{prefix}g{gi}/{k}", gp[k])
                          for k in gp} for gi, gp in enumerate(groups_p))

        out = {"embed": "embed",
               "final_norm": _named("final_norm", params["final_norm"]),
               "groups": group_paths(params["groups"])}
        if "lm_head" in params:
            out["lm_head"] = "lm_head"
        if "encoder" in params:
            enc = params["encoder"]
            out["encoder"] = {
                "pos_embed": "enc/['pos_embed']",
                "final_norm": _named("enc/['final_norm']",
                                     enc["final_norm"]),
                "groups": group_paths(enc["groups"], "enc/")}
        return out

    def _final_norm(self, p, x):
        if self.cfg.norm == "ln":
            return layer_norm(x, p["scale"], p["bias"], self.cfg.norm_eps)
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

    def _gather_tree(self, tree, gather, prefix: str, salt):
        """Every leaf of ``tree`` through :meth:`_gather_leaf` under the
        path ``prefix + keystr`` (the reference's ``_gather_tree``)."""
        return _map_with(lambda p, t: self._gather_leaf(p, t, salt, gather),
                         _named(prefix, tree), tree)

    def _head(self, params, gather=None) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self._gather_leaf("embed", params["embed"], 0, gather).T
        return self._gather_leaf("lm_head", params["lm_head"], 0, gather)

    def _head_dim(self, tp) -> Optional[int]:
        """The TP dim of the (D, V) head: the tied embedding's transposed."""
        if self.cfg.tie_embeddings:
            d = tp.dims.get("embed")
            return None if d is None else 1 - d
        return tp.dims.get("lm_head")

    def _project(self, x, head, tp=None) -> torch.Tensor:
        """x @ head -> f32 logits over the whole vocabulary."""
        if tp is None:
            return (x @ head).to(torch.float32)
        lg, split = tp_mod.linear(tp.axis, x, head, self._head_dim(tp))
        return tp_mod.to_full(tp.axis, lg, split).to(torch.float32)

    def _layer_tp(self, tp, prefix: str, unit) -> "tp_mod.LayerTP":
        """A layer's :class:`~repro_torch.models.tp.LayerTP` from the
        plan's dims under the paths ``prefix + keystr``."""
        return tp_mod.LayerTP(tp.axis, _map_with(
            lambda p, t: tp.dims.get(p), _named(prefix, unit), unit),
            tp.batch)

    @staticmethod
    def _full_named(tp, tree, prefix: str):
        """A tree of leaves stored as their blocks under the paths
        ``prefix + keystr``, gathered whole."""
        return tp_mod.full_tree(tp.axis, tree, _map_with(
            lambda p, t: tp.dims.get(p), _named(prefix, tree), tree))

    def check_tp(self, n_model: int) -> None:
        """Refuse, before any compute, a model with a layer the sharded
        paths do not compute over ``n_model`` model ranks: Mamba channels,
        RWKV-6 heads, MLA heads or experts that do not split over them
        (GQA heads that do not split run replicated)."""
        pairs = [(self.cfg, s) for s in self.specs]
        if self.cfg.encoder:
            pairs += [(self.enc_cfg, s) for s in self.enc_specs]
        for cfg, spec in pairs:
            check_ported_layer(cfg, spec)
            split = []
            if spec.kind == "mamba":
                split.append(("Mamba channels", mamba_spec(cfg).d_inner))
            elif spec.kind == "rwkv":
                split.append(("RWKV-6 heads", rwkv_spec(cfg).num_heads))
            elif cfg.mla:
                split.append(("MLA heads", cfg.num_heads))
            if spec.moe:
                split.append(("experts", cfg.moe.num_experts))
            for what, n in split:
                if n % n_model:
                    raise NotImplementedError(
                        f"{n} {what} do not split over {n_model} model "
                        f"ranks; not ported (see ROADMAP.md)")

    # ------------------------------------------------------------------
    # training forward
    # ------------------------------------------------------------------
    def _run_groups(self, cfg, groups, group_params, x, gather,
                    prefix="", enc_out=None, tp=None):
        """Each group's stacked layers in order -> (x, aux). A layer leaf
        is gathered one repeat's slice at a time, the repeat index as its
        salt, under ``prefix + "g{gi}/pos{j}" + keystr``."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for gi, (g, gp) in enumerate(zip(groups, group_params)):
            for r in range(g.repeats):
                for j, spec in enumerate(g.unit):
                    unit = gp[f"pos{j}"]
                    if gather is None:
                        pj = map_tree(lambda t: self._cast(t[r]), unit)
                    else:
                        pj = _map_with(
                            lambda p, t: self._gather_leaf(p, t[r], r,
                                                           gather),
                            _named(f"{prefix}g{gi}/pos{j}", unit), unit)
                    if tp is None:
                        x, a = apply_layer_train(cfg, spec, pj, x,
                                                 enc_out=enc_out)
                    else:
                        x, a = apply_layer_train_tp(
                            cfg, spec, pj, x, self._layer_tp(
                                tp, f"{prefix}g{gi}/pos{j}", unit),
                            enc_out=enc_out)
                    aux = aux + a
        return x, aux

    def encode(self, params, enc_embeds: torch.Tensor, gather=None, *,
               tp=None):
        """Frame embeddings (B, frames, D) -> the encoder's final-normed
        output (B, frames, D) bf16: ``pos_embed`` added in bf16, the
        non-causal attention layers, the final layer norm. ``pos_embed``
        and ``final_norm`` are gathered under ``"enc/"`` with salt 0.
        ``tp``: this rank's blocks under a model axis (head-parallel
        layers; the output replicated)."""
        enc = params["encoder"]
        ep = self._gather_tree({"pos_embed": enc["pos_embed"],
                                "final_norm": enc["final_norm"]},
                               gather, "enc/", 0)
        if tp is not None:
            ep = self._full_named(tp, ep, "enc/")
        x = enc_embeds.to(torch.bfloat16) + ep["pos_embed"][None]
        x, _ = self._run_groups(self.enc_cfg, self.enc_groups, enc["groups"],
                                x, gather, prefix="enc/", tp=tp)
        return self._final_norm(ep["final_norm"], x)

    def hidden_states(self, params, tokens: torch.Tensor, gather=None,
                      enc_embeds=None, *, tp=None):
        """tokens (B, S) [and, with an encoder, ``enc_embeds`` (B, frames,
        D)] -> (final-normed hidden states (B, S, D) bf16, aux loss).
        Each group's stacked layers run in order.

        ``gather(path, leaf, salt) -> full leaf`` (the reference's gather
        hook, e.g. the per-leaf fsdp all-gather) is called on each leaf at
        its point of use: ``embed`` and each ``final_norm`` leaf whole
        with salt 0, a stacked layer leaf one repeat's slice at a time
        with the repeat index as its salt, under the paths of
        :meth:`param_paths`. ``tp``: this rank's blocks under a model
        axis."""
        cfg = self.cfg
        if tp is not None:
            self.check_tp(tp.axis.n)
        x = self._embed(params, tokens, gather, tp)
        enc_out = (self.encode(params, enc_embeds, gather, tp=tp)
                   if cfg.encoder else None)
        x, aux = self._run_groups(cfg, self.groups, params["groups"], x,
                                  gather, enc_out=enc_out, tp=tp)
        fp = self._gather_tree(params["final_norm"], gather, "final_norm", 0)
        if tp is not None:
            fp = self._full_named(tp, fp, "final_norm")
        return self._final_norm(fp, x), aux

    def logits(self, params, tokens: torch.Tensor, gather=None,
               enc_embeds=None, *, tp=None):
        x, aux = self.hidden_states(params, tokens, gather, enc_embeds,
                                    tp=tp)
        lg = self._project(x, self._head(params, gather), tp)
        return softcap(lg, self.cfg.final_softcap), aux

    def loss(self, params, batch, gather=None, *, loss_chunk: int = 512,
             tp=None):
        """batch: {tokens (B, S) [, enc_embeds (B, frames, D)]}. Next-token
        cross entropy, computed in sequence chunks so (B, S, V) logits
        never exist at once. Returns (loss, {"nll", "aux", "tokens"}) like
        the reference. ``gather`` as in :meth:`hidden_states` (the head
        too, salt 0)."""
        tokens = batch["tokens"].long()
        x, aux = self.hidden_states(params, tokens, gather,
                                    batch.get("enc_embeds"), tp=tp)
        head = self._head(params, gather)
        inputs, targets = x[:, :-1], tokens[:, 1:]
        T = inputs.shape[1]
        ck = min(loss_chunk, T)
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, T, ck):
            lg = softcap(self._project(inputs[:, c0:c0 + ck], head, tp),
                         self.cfg.final_softcap)
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
        return self._build_cache(batch, max_len, dtype,
                                 resolve_device(device))

    def abstract_cache(self, batch: int, max_len: int,
                       dtype=torch.bfloat16) -> tuple:
        """:meth:`init_cache`'s tree of ``meta`` tensors: the shapes, no
        memory (the serving plan at full size)."""
        return self._build_cache(batch, max_len, dtype, torch.device("meta"))

    def _build_cache(self, batch, max_len, dtype, device) -> tuple:
        frames = self.cfg.encoder.num_frames if self.cfg.encoder else 0
        caches = []
        for g in self.groups:
            gc = {}
            for j, spec in enumerate(g.unit):
                one = init_layer_cache(self.cfg, spec, batch, max_len, dtype,
                                       device=device, enc_frames=frames)
                gc[f"pos{j}"] = {k: _stack([t] * g.repeats)
                                 for k, t in one.items()}
            caches.append(gc)
        return tuple(caches)

    def _embed(self, params, tokens: torch.Tensor,
               gather=None, tp=None) -> torch.Tensor:
        w = self._gather_leaf("embed", params["embed"], 0, gather)
        if tp is None:
            x = w[tokens.long()]
        else:
            x = tp_mod.embed(tp.axis, w, tp.dims.get("embed"), tokens.long())
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype)
        return x

    def _run_cached(self, params, cache, x, layer_fn, tp=None, start=0):
        """Every layer in order, each with its view of ``cache``, then the
        final norm and the head -> f32 logits. An attention layer writes
        its view in place; the new state tensors a Mamba or RWKV layer
        returns are copied into it. With ``tp`` every layer runs
        ``apply_layer_cached_tp`` at absolute position ``start`` over its
        blocks of params and cache."""
        if tp is not None:
            self.check_tp(tp.axis.n)
        for gi, (g, gp, gc) in enumerate(zip(self.groups, params["groups"],
                                             cache)):
            for r in range(g.repeats):          # the reference's scan
                for j, spec in enumerate(g.unit):
                    unit = gp[f"pos{j}"]
                    pj = map_tree(lambda t: self._cast(t[r]), unit)
                    cj = {k: t[r] for k, t in gc[f"pos{j}"].items()}
                    if tp is None:
                        x, new = layer_fn(spec, pj, x, cj)
                    else:
                        x, new = apply_layer_cached_tp(
                            self.cfg, spec, pj, x, cj, start,
                            self._layer_tp(tp, f"g{gi}/pos{j}", unit),
                            tp.cache[gi][f"pos{j}"])
                    for k, t in new.items():
                        if t is not cj[k]:
                            cj[k].copy_(t)
        fp = self._cast_tree(params["final_norm"])
        if tp is not None:
            fp = self._full_named(tp, fp, "final_norm")
        x = self._final_norm(fp, x)
        lg = self._project(x, self._head(params).to(x.dtype), tp)
        return softcap(lg, self.cfg.final_softcap)

    @torch.no_grad()
    def warm_cache(self, params, cache, enc_embeds: torch.Tensor,
                   gather=None, *, tp=None):
        """Whisper's cross-attention K/V of every decoder layer from the
        encoder's output on ``enc_embeds``, written into ``cache`` in the
        cache's type (in place; returned). As in the reference, the
        projection multiplies the bf16 encoder output by the layer's
        weights as they are (float32 weights: a float32 product). ``tp``:
        this rank's blocks of params and cache in the sharded serve step;
        each rank writes its block of the frames of ``xk`` / ``xv``."""
        if not self.cfg.encoder:
            return cache
        enc_out = self.encode(params, enc_embeds, gather, tp=tp)
        for gi, (g, gp, gc) in enumerate(zip(self.groups, params["groups"],
                                             cache)):
            for j, spec in enumerate(g.unit):
                if not spec.cross_attn:
                    continue
                xp, cj = gp[f"pos{j}"]["xattn"], gc[f"pos{j}"]
                ltp = (None if tp is None else self._layer_tp(
                    tp, f"g{gi}/pos{j}", gp[f"pos{j}"]))
                for r in range(g.repeats):
                    pr = {n: t[r] for n, t in xp.items()}
                    if ltp is None:
                        k, v = _gqa_kv(self.cfg, pr, enc_out)
                    else:
                        k, v = cross_kv_tp(
                            self.cfg, ltp, pr, ltp.dims["xattn"], enc_out,
                            tp.cache[gi][f"pos{j}"].leaves["xk"])
                    cj["xk"][r].copy_(k)
                    cj["xv"][r].copy_(v)
        return cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens: torch.Tensor, pos: int, *,
                    tp=None):
        """tokens (B, 1) at absolute position ``pos`` -> (logits (B, 1, V)
        f32, cache updated in place). ``tp``: this rank's blocks of params
        and cache in the sharded serve step (``serve/step.py``)."""
        lg = self._run_cached(
            params, cache, self._embed(params, tokens, tp=tp),
            lambda spec, p, x, c: apply_layer_decode(self.cfg, spec, p, x, c,
                                                     int(pos)),
            tp, int(pos))
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
                      start: int, *, tp=None):
        """tokens (B, T) at absolute positions start..start+T-1 ->
        (logits (B, T, V) f32, cache updated in place): one forward over
        the chunk instead of T decode steps. The caller guarantees that
        start + T fits every layer's cache (no ring wrap)."""
        lg = self._run_cached(
            params, cache, self._embed(params, tokens, tp=tp),
            lambda spec, p, x, c: apply_layer_prefill_chunk(
                self.cfg, spec, p, x, c, int(start)),
            tp, int(start))
        return lg, cache

    def prefill(self, params, cache, tokens: torch.Tensor, enc_embeds=None):
        """Sequential prefill through :meth:`decode_step`, one token at a
        time (the reference loop) -> (last logits (B, 1, V), cache); with
        an encoder, :meth:`warm_cache` on ``enc_embeds`` first."""
        if self.cfg.encoder:
            cache = self.warm_cache(params, cache, enc_embeds)
        lg = None
        for i in range(tokens.shape[1]):
            lg, cache = self.decode_step(params, cache, tokens[:, i:i + 1],
                                         i)
        return lg, cache
