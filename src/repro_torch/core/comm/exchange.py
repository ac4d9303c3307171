"""Fused flat-buffer gradient exchange: one collective for the whole tree
(the reference's ``core/comm/exchange.py``, flat mode).

    GradLayout          static flatten/unflatten plan for a gradient tree
                        (per-leaf offsets/sizes/dtypes), leaves in the
                        reference's canonical order (sorted dict keys,
                        ``utils.pytree``), so the flat buffer, its bucket
                        boundaries and every rounding decision match;
    GradientExchange    ONE quantized all-reduce over the fused f32 buffer
                        (optionally size-capped spans with a per-span key
                        fold) plus the matching fused ``local_qdq`` for
                        error-feedback residuals;
    PolicyLayout /      per-parameter-group policies: leaves grouped by
    PartitionedExchange their resolved QuantConfig into contiguous
                        segments, one fused exchange per group. A uniform
                        policy is exactly one group with an unfolded key.
    LeafExchange        the per-leaf exchange: one quantized all-reduce
                        per parameter leaf under its policy-resolved
                        quantizer, keyed by the crc32 of its path;
    policy_stats /      static accounting without a tree: launches and
    per_leaf_stats /    wire bytes per worker of a policy, of the per-leaf
    fused_stats         exchange and of the fused one (benchmarks);
    link_stats /        the same per link (intra-pod and inter-pod bytes)
    policy_link_stats / for the two-level hierarchy, from a policy or from
    observed_link_stats an engine as built.

The compute side goes through ``core/comm/wire.py`` and its kernels.
With an ``intra_group`` (the two-level mode, ``hierarchical.py``) an
engine's ``group`` is the inter-pod group it quantizes over and
``intra_group`` the pod it averages over in full precision first.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.api import QuantConfig
from repro_torch.core.comm import hierarchical, wire
from repro_torch.core.comm.collectives import (local_qdq_comm_layout,
                                               quantized_all_reduce_mean,
                                               world)
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantizers import Quantizer
from repro_torch.utils.pytree import (tree_flatten_with_path, tree_leaves,
                                      tree_map, tree_unflatten)


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """One leaf's span inside its fused buffer."""

    path: str
    shape: Tuple[int, ...]
    dtype: Any
    offset: int
    size: int


def _slot(path: str, leaf, offset: int) -> LeafSlot:
    shape = tuple(leaf.shape)
    return LeafSlot(path=path, shape=shape, dtype=leaf.dtype, offset=offset,
                    size=math.prod(shape))


def _same_count(what: str, got: int, want: int) -> None:
    if got != want:
        raise ValueError(f"{got} {what} given, the layout has {want}")


def _leaf(buf: torch.Tensor, s: LeafSlot, restore_dtype: bool):
    leaf = buf[s.offset:s.offset + s.size].reshape(s.shape)
    return leaf.to(s.dtype) if restore_dtype else leaf


@dataclasses.dataclass(frozen=True)
class GradLayout:
    """Static flatten/unflatten plan: leaf order, spans, dtype restore."""

    treedef: Any
    slots: Tuple[LeafSlot, ...]
    size: int                    # total element count of the fused buffer

    @classmethod
    def from_tree(cls, tree) -> "GradLayout":
        pairs, treedef = tree_flatten_with_path(tree)
        slots, off = [], 0
        for path, leaf in pairs:
            slots.append(_slot(path, leaf, off))
            off += slots[-1].size
        return cls(treedef=treedef, slots=tuple(slots), size=off)

    def flatten(self, tree) -> torch.Tensor:
        """Tree -> (size,) contiguous f32 buffer (canonical leaf order)."""
        leaves = tree_leaves(tree)
        _same_count("leaves", len(leaves), len(self.slots))
        return torch.cat([x.to(torch.float32).reshape(-1) for x in leaves])

    def unflatten(self, buf: torch.Tensor, *, restore_dtype: bool = True):
        """(size,) buffer -> tree of views (cast back to each leaf's dtype
        unless ``restore_dtype=False``: error-feedback residuals stay
        f32)."""
        return tree_unflatten(self.treedef, [_leaf(buf, s, restore_dtype)
                                             for s in self.slots])


@dataclasses.dataclass(frozen=True)
class GradientExchange:
    """Fused Algorithm 2 exchange over a flat buffer, on the process group
    ``group`` (None: the default group).

    With an ``intra_group`` (the pod, ``hierarchical.pod_groups``) the
    exchange is two-level: a full-precision reduce-scatter mean over the
    pod, the quantized Algorithm 2 on the resulting shard over ``group``
    (the workers of the same intra index across pods), and a
    full-precision all-gather back over the pod. Without one it is the
    flat exchange.

    ``max_chunk_elems`` optionally caps the per-collective buffer size:
    the buffer is split into ceil(n / cap) contiguous spans, each
    exchanged independently with the key folded by the span index;
    :meth:`local_qdq_flat` applies the identical schedule, so
    error-feedback residuals stay bit-consistent with what was sent.

    ``pipeline_chunks`` is the pipelined schedule (a latency knob): each
    span's all-reduce is issued as that many bucket-row chunks,
    bit-identical to ``pipeline_chunks=1``, so error-feedback residuals
    need no schedule awareness."""

    qz: Quantizer
    group: Any = None
    server_requant: bool = True
    max_chunk_elems: Optional[int] = None
    pipeline_chunks: int = 1
    intra_group: Any = None

    def __post_init__(self):
        if self.max_chunk_elems is not None and self.max_chunk_elems <= 0:
            raise ValueError(f"max_chunk_elems must be positive, got "
                             f"{self.max_chunk_elems}")
        if self.pipeline_chunks < 1:
            raise ValueError(f"pipeline_chunks must be >= 1, got "
                             f"{self.pipeline_chunks}")

    def spans(self, n: int) -> List[Tuple[int, int]]:
        cap = self.max_chunk_elems
        if not cap or n <= cap:
            return [(0, n)]
        return [(a, min(a + cap, n)) for a in range(0, n, cap)]

    def _span_key(self, key: torch.Tensor, i: int) -> torch.Tensor:
        return prng.fold_in(key, i) if self.max_chunk_elems else key

    # -- two-level helpers ---------------------------------------------------
    @property
    def two_level(self) -> bool:
        return self.intra_group is not None

    def _intra_fold(self, key: torch.Tensor, intra_id=None) -> torch.Tensor:
        """Decorrelate the rounding streams of the intra shards; no fold
        in flat mode, so a degenerate two_level keys like flat."""
        if not self.two_level:
            return key
        if intra_id is None:
            intra_id = world(self.intra_group)[1]
        return prng.fold_in(key, intra_id)

    def intra_scatter(self, flat: torch.Tensor):
        """(n,) buffer -> (shard, valid) after the full-precision intra
        reduce-scatter mean; ``(flat, None)`` in flat mode."""
        if not self.two_level:
            return flat, None
        return (hierarchical.intra_reduce_scatter_mean(flat,
                                                       self.intra_group),
                hierarchical.shard_valid_mask(flat.shape[0],
                                              self.intra_group, flat.device))

    def intra_gather(self, shard: torch.Tensor, n: int) -> torch.Tensor:
        """Inverse of :meth:`intra_scatter` (full-precision all_gather)."""
        if not self.two_level:
            return shard
        return hierarchical.intra_all_gather(shard, self.intra_group, n)

    def exchange_shard(self, shard: torch.Tensor, key: torch.Tensor, *,
                       valid=None, worker_id: Optional[int] = None,
                       intra_id: Optional[int] = None) -> torch.Tensor:
        """Quantized Algorithm 2 of an (already intra-averaged) shard over
        ``group`` only, one all-reduce per span; ``valid`` keeps scatter
        padding out of the level fits."""
        key = self._intra_fold(key, intra_id)
        outs = [quantized_all_reduce_mean(
                    shard[a:b], self.qz, self._span_key(key, i),
                    group=self.group, worker_id=worker_id,
                    server_requant=self.server_requant,
                    valid=None if valid is None else valid[a:b],
                    pipeline_chunks=self.pipeline_chunks)
                for i, (a, b) in enumerate(self.spans(shard.shape[0]))]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def local_qdq_shard(self, shard: torch.Tensor, key: torch.Tensor, *,
                        valid=None, worker_id: Optional[int] = None,
                        intra_id: Optional[int] = None) -> torch.Tensor:
        """This worker's own dequantized shard, bit-identical to its
        :meth:`exchange_shard` phase-1 contribution (same spans, keys and
        mask): two-level error feedback lives on this shard."""
        key = self._intra_fold(key, intra_id)
        outs = [local_qdq_comm_layout(
                    shard[a:b], self.qz, self._span_key(key, i),
                    group=self.group, worker_id=worker_id,
                    valid=None if valid is None else valid[a:b])
                for i, (a, b) in enumerate(self.spans(shard.shape[0]))]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def exchange_flat(self, flat: torch.Tensor, key: torch.Tensor, *,
                      worker_id: Optional[int] = None,
                      intra_id: Optional[int] = None) -> torch.Tensor:
        """(n,) local gradient buffer -> (n,) across-worker mean, identical
        on every worker. Flat: one quantized all-reduce per span. Two-level:
        fp intra scatter -> quantized shard exchange -> fp intra gather
        (``worker_id`` / ``intra_id`` are the inter / intra indices)."""
        if not self.two_level:
            return self.exchange_shard(flat, key, worker_id=worker_id)
        shard, valid = self.intra_scatter(flat)
        mean = self.exchange_shard(shard, key, valid=valid,
                                   worker_id=worker_id, intra_id=intra_id)
        return self.intra_gather(mean, flat.shape[0])

    def local_qdq_flat(self, flat: torch.Tensor, key: torch.Tensor, *,
                       worker_id: Optional[int] = None) -> torch.Tensor:
        """This worker's own dequantized buffer, bit-identical to its
        phase-1 contribution (same spans, layout and folded keys). Flat
        mode only: a two-level residual lives on the intra shard."""
        if self.two_level:
            raise ValueError(
                "local_qdq_flat is the flat-mode residual; a two-level "
                "engine's residual lives on the intra shard: use "
                "intra_scatter + local_qdq_shard")
        return self.local_qdq_shard(flat, key, worker_id=worker_id)

    def qdq_local_flat(self, flat: torch.Tensor,
                       key: torch.Tensor) -> torch.Tensor:
        """The single-device Algorithm 2: quantize -> dequantize the whole
        buffer locally (one bucketed pass per span, no collective)."""
        if self.qz.is_identity:
            return flat
        outs = [self.qz.qdq(flat[a:b], self._span_key(key, i))
                for i, (a, b) in enumerate(self.spans(flat.shape[0]))]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    # -- static cost accounting --------------------------------------------
    def _pipeline_k(self, m: int, n_workers: Optional[int]) -> int:
        """Effective pipeline chunk count for an m-element span: the
        schedule clamps K to the span's bucket rows (an unknown worker
        count assumes no clamp)."""
        if self.pipeline_chunks <= 1:
            return 1
        if n_workers is None:
            return self.pipeline_chunks
        chunk = -(-m // max(n_workers, 1))
        d_eff = wire.bucket_len(chunk, self.qz.bucket_size)
        nbc = -(-chunk // d_eff)
        return max(1, min(self.pipeline_chunks, nbc))

    def collective_launches(self, n: int,
                            n_workers: Optional[int] = None) -> int:
        """Collective launches for one exchange of n elements, per
        pipeline chunk: 2 all_to_all (words, levels) in phase 1, then 2
        all_gather when re-quantizing, else 1 f32 all_gather (unchunked);
        fp = 1 all-reduce per span. ``n_workers`` gives the exact clamp
        of K to each span's bucket rows."""
        if self.qz.is_identity:
            return len(self.spans(n))
        total = 0
        for a, b in self.spans(n):
            k = self._pipeline_k(b - a, n_workers)
            total += 4 * k if self.server_requant else 2 * k + 1
        return total

    @staticmethod
    def rs_stats(qz: Quantizer, n: int, n_workers: int,
                 pipeline_chunks: int = 1) -> Tuple[int, float]:
        """(launches, wire bytes per worker) of ONE fused quantized
        reduce-scatter of n elements: the phase-1 uplink only. K
        multiplies the launches (2 all_to_all a chunk); the bytes do not
        depend on the schedule."""
        if qz.is_identity:
            return 1, 4.0 * n                    # one reduce-scatter
        chunk = -(-n // max(n_workers, 1))
        d_eff = wire.bucket_len(chunk, qz.bucket_size)
        nbc = -(-chunk // d_eff)
        k = max(1, min(int(pipeline_chunks), nbc))
        return 2 * k, float(wire.wire_unit_bytes(qz, nbc * n_workers, d_eff))

    def wire_bytes_per_worker(self, n: int, n_workers: int) -> float:
        """Bytes one worker transmits per exchange (uplink phase 1 +
        phase-2 broadcast of its own chunk), after chunk/bucket padding."""
        if self.qz.is_identity:
            return 4.0 * n
        total = 0.0
        for a, b in self.spans(n):
            chunk = -(-(b - a) // max(n_workers, 1))
            d_eff = wire.bucket_len(chunk, self.qz.bucket_size)
            nbc = -(-chunk // d_eff)                 # buckets per chunk
            up = wire.wire_unit_bytes(self.qz, nbc * n_workers, d_eff)
            down = (wire.wire_unit_bytes(self.qz, nbc, d_eff)
                    if self.server_requant else 4.0 * chunk)
            total += up + down
        return total


@dataclasses.dataclass(frozen=True)
class GroupSegment:
    """One policy group's contiguous segment."""

    cfg: QuantConfig
    leaf_ids: Tuple[int, ...]    # canonical leaf order indices, ascending
    size: int                    # total element count of the group buffer


@dataclasses.dataclass(frozen=True)
class PolicyLayout:
    """Canonical leaves grouped by resolved QuantConfig into contiguous
    per-group buffers (groups in order of first appearance). A uniform
    policy yields one group whose buffer equals ``GradLayout``'s."""

    treedef: Any
    slots: Tuple[LeafSlot, ...]
    groups: Tuple[GroupSegment, ...]
    leaf_group: Tuple[int, ...]          # leaf i -> index into groups

    @classmethod
    def from_tree(cls, tree, policy: QuantPolicy, *,
                  paths=None) -> "PolicyLayout":
        """``paths`` optionally gives the leaf path strings the policy is
        resolved against (a tree aligned with ``tree``, e.g.
        ``LM.param_paths``); the default is the keystr paths of ``tree``."""
        pairs, treedef = tree_flatten_with_path(tree)
        path_strs = ([p for p, _ in pairs] if paths is None
                     else tree_leaves(paths))
        _same_count("paths", len(path_strs), len(pairs))
        dead = policy.unmatched_rules(path_strs)
        if dead:
            warnings.warn(f"policy rules matched no parameter leaf: {dead}; "
                          f"check the patterns against the model's param "
                          f"paths", stacklevel=2)
        group_ix: Dict[QuantConfig, int] = {}
        g_leaves: List[List[int]] = []
        g_off: List[int] = []
        slots, leaf_group = [], []
        for i, ((_, leaf), path) in enumerate(zip(pairs, path_strs)):
            cfg = policy.resolve(path)
            gi = group_ix.setdefault(cfg, len(group_ix))
            if gi == len(g_leaves):
                g_leaves.append([])
                g_off.append(0)
            slots.append(_slot(path, leaf, g_off[gi]))
            g_off[gi] += slots[-1].size
            g_leaves[gi].append(i)
            leaf_group.append(gi)
        groups = tuple(GroupSegment(cfg=c, leaf_ids=tuple(ls), size=off)
                       for c, ls, off in zip(group_ix, g_leaves, g_off))
        return cls(treedef=treedef, slots=tuple(slots), groups=groups,
                   leaf_group=tuple(leaf_group))

    @property
    def size(self) -> int:
        return sum(g.size for g in self.groups)

    def flatten_groups(self, tree) -> Tuple[torch.Tensor, ...]:
        """Tree -> one (group.size,) contiguous f32 buffer per group."""
        leaves = tree_leaves(tree)
        _same_count("leaves", len(leaves), len(self.slots))
        return tuple(torch.cat([leaves[i].to(torch.float32).reshape(-1)
                                for i in g.leaf_ids])
                     for g in self.groups)

    def unflatten_groups(self, bufs: Sequence[torch.Tensor], *,
                         restore_dtype: bool = True):
        """Per-group buffers -> tree of views."""
        _same_count("buffers", len(bufs), len(self.groups))
        return tree_unflatten(self.treedef, [
            _leaf(bufs[self.leaf_group[i]], s, restore_dtype)
            for i, s in enumerate(self.slots)])


@dataclasses.dataclass(frozen=True)
class PartitionedExchange:
    """Per-policy-group fused Algorithm 2: one ``GradientExchange`` per
    group, each with its own key stream and wire accounting."""

    layout: PolicyLayout
    engines: Tuple[GradientExchange, ...]     # aligned with layout.groups

    @classmethod
    def build(cls, policy: QuantPolicy, tree, group=None, *, paths=None,
              max_chunk_elems: Optional[int] = None,
              pipeline_chunks: int = 1,
              intra_group=None) -> "PartitionedExchange":
        """``group`` is the quantized (inter) group; an ``intra_group``
        (the pod) makes every group's engine two-level."""
        layout = PolicyLayout.from_tree(tree, policy, paths=paths)
        engines = tuple(
            GradientExchange(g.cfg.to_quantizer(), group,
                             server_requant=g.cfg.server_requant,
                             max_chunk_elems=max_chunk_elems,
                             pipeline_chunks=pipeline_chunks,
                             intra_group=intra_group)
            for g in layout.groups)
        return cls(layout=layout, engines=engines)

    @property
    def two_level(self) -> bool:
        return bool(self.engines) and self.engines[0].two_level

    def _group_key(self, key: torch.Tensor, gi: int) -> torch.Tensor:
        # a single group is the uniform fused exchange: its key stays
        # unfolded, bit-identical to GradientExchange on GradLayout
        return key if len(self.engines) == 1 else prng.fold_in(key, gi)

    @property
    def is_identity(self) -> bool:
        return all(e.qz.is_identity for e in self.engines)

    def exchange_parts(self, bufs: Sequence[torch.Tensor], key, *,
                       worker_id: Optional[int] = None
                       ) -> Tuple[torch.Tensor, ...]:
        """Per-group local buffers -> per-group across-worker means."""
        return tuple(eng.exchange_flat(buf, self._group_key(key, gi),
                                       worker_id=worker_id)
                     for gi, (eng, buf) in enumerate(zip(self.engines,
                                                         bufs)))

    def local_qdq_parts(self, bufs: Sequence[torch.Tensor], key, *,
                        worker_id: Optional[int] = None
                        ) -> Tuple[torch.Tensor, ...]:
        """Per-group local quantize -> dequantize, bit-consistent with
        :meth:`exchange_parts`; identity groups pass through (zero
        residual)."""
        return tuple(
            buf if eng.qz.is_identity
            else eng.local_qdq_flat(buf, self._group_key(key, gi),
                                    worker_id=worker_id)
            for gi, (eng, buf) in enumerate(zip(self.engines, bufs)))

    # -- two-level shard parts ---------------------------------------------
    def intra_scatter_parts(self, bufs: Sequence[torch.Tensor]):
        """Per-group fp intra reduce-scatter mean: (shards, valids)."""
        pairs = [eng.intra_scatter(buf)
                 for eng, buf in zip(self.engines, bufs)]
        return tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)

    def exchange_shard_parts(self, shards: Sequence[torch.Tensor], key,
                             valids, *, worker_id: Optional[int] = None
                             ) -> Tuple[torch.Tensor, ...]:
        """Per-group quantized shard exchange over the inter group (keys
        folded per group as in :meth:`exchange_parts`)."""
        return tuple(
            eng.exchange_shard(s, self._group_key(key, gi), valid=v,
                               worker_id=worker_id)
            for gi, (eng, s, v) in enumerate(zip(self.engines, shards,
                                                 valids)))

    def local_qdq_shard_parts(self, shards: Sequence[torch.Tensor], key,
                              valids, *, worker_id: Optional[int] = None
                              ) -> Tuple[torch.Tensor, ...]:
        """Per-group local shard quantize -> dequantize, bit-consistent
        with :meth:`exchange_shard_parts`; identity groups pass through."""
        return tuple(
            s if eng.qz.is_identity
            else eng.local_qdq_shard(s, self._group_key(key, gi), valid=v,
                                     worker_id=worker_id)
            for gi, (eng, s, v) in enumerate(zip(self.engines, shards,
                                                 valids)))

    def intra_gather_parts(self, shards: Sequence[torch.Tensor]
                           ) -> Tuple[torch.Tensor, ...]:
        """Per-group fp intra all-gather back to full group buffers."""
        return tuple(eng.intra_gather(s, g.size) for eng, s, g in
                     zip(self.engines, shards, self.layout.groups))

    def ef_shard_sizes(self, n_intra: int) -> Tuple[Optional[int], ...]:
        """Per-group two-level residual lengths (one intra shard per
        worker); None for identity groups."""
        return tuple(
            None if eng.qz.is_identity
            else hierarchical.intra_chunk_len(g.size, n_intra)
            for eng, g in zip(self.engines, self.layout.groups))

    def qdq_local_parts(self, bufs: Sequence[torch.Tensor],
                        key) -> Tuple[torch.Tensor, ...]:
        """Per-group single-device quantize -> dequantize (no collective);
        identity groups pass through."""
        return tuple(eng.qdq_local_flat(buf, self._group_key(key, gi))
                     for gi, (eng, buf) in enumerate(zip(self.engines,
                                                         bufs)))

    def collective_launches(self) -> int:
        return sum(eng.collective_launches(g.size)
                   for eng, g in zip(self.engines, self.layout.groups))

    def wire_bytes_per_worker(self, n_workers: int) -> float:
        return sum(eng.wire_bytes_per_worker(g.size, n_workers)
                   for eng, g in zip(self.engines, self.layout.groups))

    def launches_and_bytes(self, n_workers: int) -> Tuple[int, float]:
        """(collective launches, wire bytes per worker) of one exchange."""
        return (self.collective_launches(),
                self.wire_bytes_per_worker(n_workers))


@dataclasses.dataclass(frozen=True)
class LeafExchange:
    """The per-leaf exchange (the reference's ``fused_exchange=False``
    branch of its replicated step): every leaf of a gradient tree goes
    through its own quantized all-reduce under its policy-resolved
    quantizer (built once per config), keyed by ``fold_in(step_key,
    crc32(path) & 0x7FFFFFFF)``; an fp leaf is an all-reduce / L. The
    ``paths`` trees are aligned with the gradient trees
    (``LM.param_paths``); ``path_sizes`` (``[(path, size), ...]``, as
    :meth:`build` lays them out) serve the accounting."""

    policy: QuantPolicy
    group: Any = None
    path_sizes: Tuple[Tuple[str, int], ...] = ()
    _cache: Dict[QuantConfig, Quantizer] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @classmethod
    def build(cls, policy: QuantPolicy, tree, group=None, *,
              paths) -> "LeafExchange":
        return cls(policy, group, tuple(
            (p, int(t.numel()))
            for p, t in zip(tree_leaves(paths), tree_leaves(tree),
                            strict=True)))

    @property
    def is_identity(self) -> bool:
        return all(self.resolve(p)[1].is_identity
                   for p, _ in self.path_sizes)

    def resolve(self, path: str) -> Tuple[QuantConfig, Quantizer]:
        cfg = self.policy.resolve(path)
        if cfg not in self._cache:
            self._cache[cfg] = cfg.to_quantizer()
        return cfg, self._cache[cfg]

    @staticmethod
    def leaf_key(step_key: torch.Tensor, path: str) -> torch.Tensor:
        return prng.fold_in(step_key, zlib.crc32(path.encode()) & 0x7FFFFFFF)

    def exchange(self, paths, grads, step_key: torch.Tensor):
        """Each leaf's across-worker mean, in the leaf's shape and dtype."""
        def one(path, g):
            cfg, qz = self.resolve(path)
            out = quantized_all_reduce_mean(
                g.to(torch.float32).reshape(-1), qz,
                self.leaf_key(step_key, path), group=self.group,
                server_requant=cfg.server_requant)
            return out.reshape(g.shape).to(g.dtype)
        return tree_map(one, paths, grads)

    def residuals(self, paths, grads, step_key: torch.Tensor):
        """Error feedback: each leaf's f32 ``g - Q^-1(Q(g))`` on the
        layout of its phase-1 contribution (zero for an fp leaf)."""
        def one(path, g):
            _, qz = self.resolve(path)
            if qz.is_identity:
                return torch.zeros(g.shape, dtype=torch.float32,
                                   device=g.device)
            flat = g.to(torch.float32).reshape(-1)
            local = local_qdq_comm_layout(flat, qz,
                                          self.leaf_key(step_key, path),
                                          group=self.group)
            return (flat - local).reshape(g.shape)
        return tree_map(one, paths, grads)

    def qdq_local(self, paths, grads, step_key: torch.Tensor):
        """The single-device per-leaf step: each leaf quantized and
        dequantized locally (no collective), in its shape and dtype."""
        def one(path, g):
            _, qz = self.resolve(path)
            if qz.is_identity:
                return g
            return qz.qdq(g.to(torch.float32).reshape(-1),
                          self.leaf_key(step_key, path)).reshape(
                              g.shape).to(g.dtype)
        return tree_map(one, paths, grads)

    def launches_and_bytes(self, n_workers: int) -> Tuple[int, float]:
        """(collective launches, wire bytes per worker) of one exchange:
        :func:`per_leaf_stats` of each leaf under its own quantizer."""
        launches, wire_bytes = 0, 0.0
        for path, size in self.path_sizes:
            cfg, qz = self.resolve(path)
            count, b = per_leaf_stats(qz, [size], n_workers,
                                      server_requant=cfg.server_requant)
            launches += count
            wire_bytes += b
        return launches, wire_bytes


def policy_stats(policy: QuantPolicy, path_sizes, n_workers: int, *,
                 max_chunk_elems: Optional[int] = None,
                 sharded_paths=None
                 ) -> Tuple[int, float, Tuple[str, ...]]:
    """(launches, wire bytes per worker, group labels) of a policy over
    ``[(path, size), ...]`` leaves, without a tree (benchmarks).

    ``sharded_paths`` (paths exchanged by the fused quantized
    reduce-scatter, the phase-1 uplink only, as fsdp shards them) are
    accounted as their own ``<scheme>/rs`` segments, each rounded up to a
    multiple of ``n_workers``; the other leaves pay the full Algorithm 2
    all-reduce."""
    sharded_paths = frozenset(sharded_paths or ())
    groups: Dict[Tuple[QuantConfig, bool], int] = {}
    for path, size in path_sizes:
        key = (policy.resolve(path), path in sharded_paths)
        groups[key] = groups.get(key, 0) + int(size)
    launches, bytes_, labels = 0, 0.0, []
    for (cfg, sharded), n in groups.items():
        qz = cfg.to_quantizer()
        if sharded:
            n = -(-n // n_workers) * n_workers
            count, b = GradientExchange.rs_stats(qz, n, n_workers)
            launches += count
            bytes_ += b
            labels.append(f"{cfg.name}/rs")
            continue
        eng = GradientExchange(qz, server_requant=cfg.server_requant,
                               max_chunk_elems=max_chunk_elems)
        launches += eng.collective_launches(n)
        bytes_ += eng.wire_bytes_per_worker(n, n_workers)
        labels.append(cfg.name)
    return launches, bytes_, tuple(labels)


def _zero_links() -> Dict[str, float]:
    return {"ici_bytes": 0.0, "dcn_bytes": 0.0, "dcn_q_bytes": 0.0,
            "launches": 0.0}


def link_stats(qz: Quantizer, n: int, *, n_intra: int, n_inter: int,
               two_level: bool, server_requant: bool = True,
               sharded: bool = False,
               max_chunk_elems: Optional[int] = None,
               pipeline_chunks: int = 1,
               sync_every: int = 1) -> Dict[str, float]:
    """Per-link bytes one worker transmits for one exchange of ``n``
    elements on (n_inter pods) x (n_intra workers a pod):

        ici_bytes    within a pod
        dcn_bytes    across pods
        dcn_q_bytes  the quantized part of dcn_bytes
        launches     collective launches (the fp intra phases included)

    all_to_all / all_gather traffic is uniformly addressed, so
    (n_inter-1)/n_inter of a flat collective's bytes cross pods; a ring
    reduce-scatter or all-gather over one axis sends (L-1)/L of the
    payload per worker. ``sharded=True`` is the fsdp phase-1-only
    reduce-scatter. ``pipeline_chunks`` multiplies the quantized launches
    and leaves the bytes. ``sync_every=H > 1`` prices the temporal
    hierarchy per step (:func:`_amortize_sync`)."""
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    L = n_intra * n_inter
    dcn_frac = (n_inter - 1) / n_inter if n_inter > 1 else 0.0
    if not two_level:
        if sharded:
            launches, total = GradientExchange.rs_stats(
                qz, n, L, pipeline_chunks=pipeline_chunks)
        else:
            eng = GradientExchange(qz, server_requant=server_requant,
                                   max_chunk_elems=max_chunk_elems,
                                   pipeline_chunks=pipeline_chunks)
            launches = eng.collective_launches(n, L)
            total = eng.wire_bytes_per_worker(n, L)
        dcn = total * dcn_frac
        st = {"ici_bytes": total - dcn, "dcn_bytes": dcn,
              "dcn_q_bytes": 0.0 if qz.is_identity else dcn,
              "launches": float(launches)}
        return _amortize_sync(st, n, n_intra, sync_every)
    shard = -(-n // n_intra)
    ici = 4.0 * n * (n_intra - 1) / n_intra        # intra reduce-scatter
    launches = 1
    if sharded:
        l_i, inter_total = GradientExchange.rs_stats(
            qz, shard, n_inter, pipeline_chunks=pipeline_chunks)
    else:
        eng = GradientExchange(qz, server_requant=server_requant,
                               max_chunk_elems=max_chunk_elems,
                               pipeline_chunks=pipeline_chunks)
        l_i = eng.collective_launches(shard, n_inter)
        inter_total = eng.wire_bytes_per_worker(shard, n_inter)
        ici += 4.0 * n * (n_intra - 1) / n_intra   # final intra all-gather
        launches += 1
    launches += l_i
    dcn = inter_total * dcn_frac
    st = {"ici_bytes": ici + inter_total - dcn, "dcn_bytes": dcn,
          "dcn_q_bytes": 0.0 if qz.is_identity else dcn,
          "launches": float(launches)}
    return _amortize_sync(st, n, n_intra, sync_every)


def _amortize_sync(st: Dict[str, float], n: int, n_intra: int,
                   sync_every: int) -> Dict[str, float]:
    """One exchange's link stats amortized over an H-step window, plus
    the full-precision intra all-reduce every inner step pays."""
    if sync_every <= 1:
        return st
    st = {k: v / sync_every for k, v in st.items()}
    if n_intra > 1:
        st["ici_bytes"] += 8.0 * n * (n_intra - 1) / n_intra
        st["launches"] += 1.0
    return st


def policy_link_stats(policy: QuantPolicy, path_sizes, *, n_intra: int,
                      n_inter: int, two_level: bool, sharded_paths=None,
                      max_chunk_elems: Optional[int] = None,
                      pipeline_chunks: int = 1, sync_every: int = 1
                      ) -> Tuple[Dict[str, float], Tuple[str, ...]]:
    """:func:`link_stats` summed over a policy's groups of ``[(path,
    size), ...]`` leaves, and the group labels. Sharded leaves are rounded
    up to a multiple of the worker count, as in :func:`policy_stats`."""
    L = n_intra * n_inter
    sharded_paths = frozenset(sharded_paths or ())
    groups: Dict[Tuple[QuantConfig, bool], int] = {}
    for path, size in path_sizes:
        key = (policy.resolve(path), path in sharded_paths)
        groups[key] = groups.get(key, 0) + int(size)
    total, labels = _zero_links(), []
    for (cfg, sharded), n in groups.items():
        if sharded:
            n = -(-n // L) * L
        st = link_stats(cfg.to_quantizer(), n, n_intra=n_intra,
                        n_inter=n_inter, two_level=two_level,
                        server_requant=cfg.server_requant, sharded=sharded,
                        max_chunk_elems=max_chunk_elems,
                        pipeline_chunks=pipeline_chunks,
                        sync_every=sync_every)
        for k in total:
            total[k] += st[k]
        labels.append(f"{cfg.name}/rs" if sharded else cfg.name)
    return total, tuple(labels)


def observed_link_stats(ex: PartitionedExchange, *, n_intra: int,
                        n_inter: int, sync_every: int = 1
                        ) -> Tuple[Dict[str, float],
                                   Tuple[Dict[str, Any], ...]]:
    """Per-link accounting of an engine as built (the sibling of
    :func:`policy_link_stats`, which re-derives the groups from a policy):
    (summed totals, one row per group with its label, size and
    :func:`link_stats`). The reference's optional runtime ``stats``
    columns belong to the bit schedule, which is not ported."""
    two_level = ex.two_level
    total, rows = _zero_links(), []
    for eng, g in zip(ex.engines, ex.layout.groups):
        st = link_stats(eng.qz, g.size, n_intra=n_intra, n_inter=n_inter,
                        two_level=two_level,
                        server_requant=eng.server_requant,
                        max_chunk_elems=eng.max_chunk_elems,
                        pipeline_chunks=eng.pipeline_chunks,
                        sync_every=sync_every)
        rows.append({"label": g.cfg.name, "size": g.size, "rule_id": None,
                     **st})
        for k in total:
            total[k] += st[k]
    return total, tuple(rows)


def per_leaf_stats(qz: Quantizer, sizes: Sequence[int], n_workers: int, *,
                   server_requant: bool = True) -> Tuple[int, float]:
    """(launches, wire bytes per worker) of the per-leaf exchange: every
    leaf pays its own collectives and its own chunk/bucket padding."""
    eng = GradientExchange(qz, server_requant=server_requant)
    return (sum(eng.collective_launches(n) for n in sizes),
            sum(eng.wire_bytes_per_worker(n, n_workers) for n in sizes))


def fused_stats(qz: Quantizer, sizes: Sequence[int], n_workers: int, *,
                server_requant: bool = True,
                max_chunk_elems: Optional[int] = None) -> Tuple[int, float]:
    """(launches, wire bytes per worker) of the fused exchange of the same
    leaves through one flat buffer."""
    eng = GradientExchange(qz, server_requant=server_requant,
                           max_chunk_elems=max_chunk_elems)
    n = int(sum(sizes))
    return eng.collective_launches(n), eng.wire_bytes_per_worker(n, n_workers)
