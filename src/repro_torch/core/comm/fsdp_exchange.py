"""Fused policy-aware FSDP (ZeRO-3) gradient exchange (the reference's
``core/comm/fsdp_exchange.py``).

    FsdpLayout     leaves grouped by (resolved QuantConfig, sharded?) into
                   one flat buffer per group; a sharded group is laid out
                   worker-major, row w = worker w's shard slices of every
                   leaf (``movedim(dim, 0)``), so a reduce-scatter of the
                   buffer hands each worker exactly the gradient of its
                   own parameter shards;
    FsdpExchange   one quantized reduce-scatter per SHARDED group (phase 1
                   only: the next forward's parameter all-gather is the
                   downlink) and one quantized all-reduce per REPLICATED
                   group (leaves with no dp-divisible dim), with per-group
                   wire accounting and error-feedback residuals;
    make_fused_tree_gather
                   the whole-tree gather the train step calls, a
                   ``torch.autograd.Function``: forward = one bf16
                   all-gather per sharded group; backward = the exchange
                   above, onto the stored shards.

Buffer layout of one sharded group (L workers, leaves a, b):

        row 0:   [ a.shard0   | b.shard0   ]
        row 1:   [ a.shard1   | b.shard1   ]
        ...
        row L-1: [ a.shardL-1 | b.shardL-1 ]

Collective launches are O(#policy groups), never O(#leaves). The worker
index is the rank in the dp process group (the reference's combined
``axis_index`` over ``("pod", "data")``, inter-major). In the two-level
mode (``intra_axes``) every group quantizes over the inter-pod group only,
on data first averaged in full precision within the pod; the residuals
then live on the 1/n_intra intra shard.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.api import QuantConfig
from repro_torch.core.comm.collectives import (_all_gather, _rs_mean_parts,
                                               local_qdq_comm_layout,
                                               quantized_reduce_scatter_mean,
                                               scatter_mean, world)
from repro_torch.core.comm.exchange import (GradientExchange, _respecialized,
                                            _stats_row, _with_configs,
                                            _zero_links, link_stats)
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantizers import Quantizer
from repro_torch.utils.pytree import (tree_flatten_with_path, tree_leaves,
                                      tree_unflatten)


def all_gather_rows(row: torch.Tensor, group) -> torch.Tensor:
    """(n,) -> (L, n) stacked by rank. The bytes travel as uint8, so any
    dtype (bf16 included) gathers exactly on every backend."""
    raw = _all_gather(row.contiguous().view(torch.uint8), group)
    return raw.view(row.dtype)


def all_gather_dim(w: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Tiled all-gather of a shard along ``dim`` (``lax.all_gather(...,
    axis=dim, tiled=True)``)."""
    L = world(group)[0]
    wm = torch.movedim(w, dim, 0)
    rows = all_gather_rows(wm.reshape(-1), group)
    full = rows.reshape((L * wm.shape[0],) + tuple(wm.shape[1:]))
    return torch.movedim(full, 0, dim)


def reduce_scatter_mean_block(g: torch.Tensor, qz: Quantizer,
                              key: torch.Tensor, group=None, *, dim: int,
                              param_dtype=torch.float32,
                              pipeline_chunks: int = 1) -> torch.Tensor:
    """Quantized reduce-scatter of one full-size cotangent block along
    ``dim``: this worker's shard of the across-worker mean, in the stored
    shard's shape. ``key`` is already folded per worker. The single-leaf
    primitive of the per-leaf fsdp gather (``gather.make_fsdp_gather``)."""
    L = world(group)[0]
    gm = torch.movedim(g.to(torch.float32), dim, 0)
    lead, rest = gm.shape[0], tuple(gm.shape[1:])
    chunk = (lead // L) * math.prod(rest)
    parts = gm.reshape(L, chunk)
    if qz.is_identity:
        mean_chunk = scatter_mean(parts, group)
    else:
        valid = torch.ones((L, chunk), dtype=torch.bool, device=g.device)
        mean_chunk = _rs_mean_parts(parts, valid, qz, key, group,
                                    pipeline_chunks=pipeline_chunks)
    out = mean_chunk.reshape((lead // L,) + rest)
    return torch.movedim(out, 0, dim).to(param_dtype)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FsdpSlot:
    """One leaf's span inside its group buffer (full-leaf coordinates)."""

    path: str
    shape: Tuple[int, ...]       # full (unsharded) leaf shape
    dtype: Any
    dim: Optional[int]           # dp-shard dim in full coords; None: repl.
    offset: int                  # sharded: offset inside each worker row;
                                 # replicated: inside the group buffer
    size: int                    # full element count


@dataclasses.dataclass(frozen=True)
class FsdpGroup:
    """One policy group's segment (``rule_id``: see
    ``exchange.GroupSegment``)."""

    cfg: QuantConfig
    sharded: bool                # True: reduce-scatter; False: all-reduce
    leaf_ids: Tuple[int, ...]    # canonical leaf order indices, ascending
    size: int                    # full element count of the group buffer
    rule_id: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class FsdpLayout:
    """Shard-aware partition plan of a ZeRO-3 parameter tree (full leaf
    shapes in, stored shards out)."""

    treedef: Any
    slots: Tuple[FsdpSlot, ...]
    groups: Tuple[FsdpGroup, ...]
    leaf_group: Tuple[int, ...]          # leaf i -> index into groups
    n_shards: int                        # L, the dp worker count

    @classmethod
    def from_tree(cls, tree, policy: QuantPolicy, *, paths, shard_dims,
                  n_shards: int, by_rule: bool = False) -> "FsdpLayout":
        """``tree`` has the FULL leaf shapes; ``paths`` is a tree of path
        strings aligned with it; ``shard_dims``: path -> dp-shard dim in
        full coordinates (None: replicated). Every sharded leaf's
        ``shape[dim]`` must divide by ``n_shards``. ``by_rule=True`` keys
        the groups on ``(policy rule index, sharded)`` instead of
        ``(config, sharded)``, the partition a ``BitSchedule`` keeps
        across phases (see ``PolicyLayout.from_tree``)."""
        pairs, treedef = tree_flatten_with_path(tree)
        path_strs = tree_leaves(paths)
        if len(path_strs) != len(pairs):
            raise ValueError(f"{len(path_strs)} paths given, the tree has "
                             f"{len(pairs)} leaves")
        group_ix: Dict[Tuple[Any, bool], int] = {}
        g_cfg: List[Tuple[QuantConfig, bool, Optional[int]]] = []
        g_leaves: List[List[int]] = []
        g_off: List[int] = []
        slots, leaf_group = [], []
        for i, ((_, leaf), path) in enumerate(zip(pairs, path_strs)):
            shape = tuple(leaf.shape)
            dim = shard_dims.get(path)
            if dim is not None and (not shape or shape[dim] % n_shards):
                raise ValueError(
                    f"leaf {path!r} shape {shape} is not divisible by "
                    f"{n_shards} along dim {dim}")
            sharded = dim is not None
            cfg = policy.resolve(path)
            rid = policy.resolve_ix(path) if by_rule else None
            gi = group_ix.setdefault((rid if by_rule else cfg, sharded),
                                     len(group_ix))
            if gi == len(g_leaves):
                g_cfg.append((cfg, sharded, rid))
                g_leaves.append([])
                g_off.append(0)
            size = math.prod(shape)
            slots.append(FsdpSlot(path=path, shape=shape, dtype=leaf.dtype,
                                  dim=dim, offset=g_off[gi], size=size))
            # a worker row advances by one shard, a replicated buffer by
            # the full leaf
            g_off[gi] += size // n_shards if sharded else size
            g_leaves[gi].append(i)
            leaf_group.append(gi)
        groups = tuple(
            FsdpGroup(cfg=cfg, sharded=sh, leaf_ids=tuple(ls),
                      size=off * (n_shards if sh else 1), rule_id=r)
            for (cfg, sh, r), ls, off in zip(g_cfg, g_leaves, g_off))
        return cls(treedef=treedef, slots=tuple(slots), groups=groups,
                   leaf_group=tuple(leaf_group), n_shards=n_shards)

    def with_configs(self, policy: QuantPolicy) -> "FsdpLayout":
        """A ``by_rule`` layout specialized to one phase's configs (see
        ``PolicyLayout.with_configs``)."""
        return dataclasses.replace(
            self, groups=_with_configs(self.groups, policy))

    @property
    def size(self) -> int:
        return sum(g.size for g in self.groups)

    def _check(self, leaves) -> list:
        leaves = list(leaves)
        if len(leaves) != len(self.slots):
            raise ValueError(f"{len(leaves)} leaves given, the layout has "
                             f"{len(self.slots)}")
        return leaves

    # -- forward: the fused parameter all-gather ---------------------------
    def gather_full(self, tree, group, *, compute_dtype=torch.bfloat16):
        """Sharded-param tree -> full-leaf tree in ``compute_dtype``: ONE
        all-gather per sharded group (replicated leaves are cast in
        place)."""
        shards = self._check(tree_leaves(tree))
        L = self.n_shards
        full: List[Any] = [None] * len(shards)
        for g in self.groups:
            if not g.sharded:
                for i in g.leaf_ids:
                    full[i] = shards[i].to(compute_dtype)
                continue
            row = torch.cat([
                torch.movedim(shards[i].to(compute_dtype), self.slots[i].dim,
                              0).reshape(-1) for i in g.leaf_ids])
            rows = all_gather_rows(row, group)               # (L, row)
            for i in g.leaf_ids:
                s = self.slots[i]
                rest = s.shape[:s.dim] + s.shape[s.dim + 1:]
                seg = rows[:, s.offset:s.offset + s.size // L]
                full[i] = torch.movedim(
                    seg.reshape((s.shape[s.dim],) + rest), 0, s.dim)
        return tree_unflatten(self.treedef, full)

    # -- backward: buffers <-> trees -----------------------------------------
    def flatten_groups(self, tree) -> Tuple[torch.Tensor, ...]:
        """Full-leaf cotangent tree -> one (group.size,) f32 buffer per
        group, sharded groups worker-major."""
        leaves = self._check(tree_leaves(tree))
        L = self.n_shards
        bufs = []
        for g in self.groups:
            if not g.sharded:
                bufs.append(torch.cat([leaves[i].to(torch.float32)
                                       .reshape(-1) for i in g.leaf_ids]))
                continue
            rows = torch.cat([
                torch.movedim(leaves[i].to(torch.float32), self.slots[i].dim,
                              0).reshape(L, -1) for i in g.leaf_ids], dim=1)
            bufs.append(rows.reshape(-1))
        return tuple(bufs)

    def unflatten_outputs(self, outs: Sequence[torch.Tensor], *,
                          param_dtype=torch.float32):
        """Per-group exchange outputs -> a tree shaped like the STORED
        parameters: a sharded group's (size/L,) mean chunk, a replicated
        group's full (size,) mean."""
        if len(outs) != len(self.groups):
            raise ValueError(f"{len(outs)} outputs given, the layout has "
                             f"{len(self.groups)} groups")
        L = self.n_shards
        leaves = []
        for i, s in enumerate(self.slots):
            out = outs[self.leaf_group[i]]
            if s.dim is None:
                leaf = out[s.offset:s.offset + s.size].reshape(s.shape)
            else:
                rest = s.shape[:s.dim] + s.shape[s.dim + 1:]
                seg = out[s.offset:s.offset + s.size // L]
                leaf = torch.movedim(
                    seg.reshape((s.shape[s.dim] // L,) + rest), 0, s.dim)
            leaves.append(leaf.to(param_dtype))
        return tree_unflatten(self.treedef, leaves)

    # -- shards <-> full leaves (state set-up, digests, checkpoints) --------
    def shard_leaves(self, full_leaves, worker: int) -> List[torch.Tensor]:
        """Full leaves -> worker ``worker``'s stored shards (copies)."""
        out = []
        for s, leaf in zip(self.slots, self._check(full_leaves)):
            if s.dim is None:
                out.append(leaf.clone())
                continue
            n = s.shape[s.dim] // self.n_shards
            out.append(leaf.narrow(s.dim, worker * n, n).clone())
        return out

    def unshard_leaves(self, shards, group) -> List[torch.Tensor]:
        """Stored shards -> full leaves in their own dtype, the blocks in
        rank order (one all-gather per sharded leaf)."""
        return [t.clone() if s.dim is None else all_gather_dim(t, s.dim,
                                                               group)
                for s, t in zip(self.slots, self._check(shards))]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FsdpExchange:
    """Per-policy-group fused ZeRO-3 exchange over an ``FsdpLayout``.

    ``group`` is the whole dp process group (the parameter all-gather and
    the flat exchange); in the two-level mode each engine's ``group`` is
    the inter-pod group and its ``intra_group`` the pod:

      * sharded groups: the worker-major buffer ``(L_p, L_i, chunk)`` is
        fp-scatter-meaned over the pod (each worker keeps the rows of its
        data column across pods), then quantized-reduce-scattered over the
        pods, so each worker still ends with its own shards' mean;
      * replicated groups: fp intra scatter -> quantized Algorithm 2 over
        the pods -> fp intra gather (``GradientExchange``'s two-level
        mode).

    ``exchange_with_residuals`` and ``residual_bufs`` share one key
    schedule, so error-feedback residuals are bit-consistent with what
    was sent."""

    layout: FsdpLayout
    engines: Tuple[GradientExchange, ...]    # aligned with layout.groups
    dp_axes: Tuple[str, ...] = ("data",)
    intra_axes: Tuple[str, ...] = ()
    n_intra: int = 1
    pipeline_chunks: int = 1
    group: Any = None

    @classmethod
    def build(cls, policy: QuantPolicy, tree, axis_names=("data",), *,
              paths, shard_dims, n_shards: int, group=None,
              max_chunk_elems: Optional[int] = None, intra_axes=(),
              n_intra: int = 1, pipeline_chunks: int = 1,
              intra_group=None, inter_group=None,
              by_rule: bool = False) -> "FsdpExchange":
        """``axis_names`` is the ordered dp tuple; a non-empty
        ``intra_axes`` (size ``n_intra``) selects the two-level mode, with
        the pod's ``intra_group`` and the ``inter_group`` across pods; the
        axis names alone price it (the accounting needs no process
        group), the exchange itself needs the groups.
        ``max_chunk_elems`` caps replicated groups only: a sharded group
        reduce-scatters in one piece (its rows are the worker chunks).
        ``by_rule`` groups by policy rule (``FsdpLayout.from_tree``)."""
        dp = tuple(axis_names)
        intra = tuple(intra_axes)
        inter = tuple(a for a in dp if a not in intra)
        if intra:
            if dp != inter + intra:
                raise ValueError(
                    f"inter axes {inter} must precede intra axes {intra} "
                    f"in the dp tuple {dp} (worker-major rows are "
                    f"inter-major)")
            if n_intra <= 1 or n_shards % n_intra:
                raise ValueError(f"n_intra must be > 1 and divide "
                                 f"n_shards={n_shards}, got {n_intra}")
        else:
            n_intra = 1
        layout = FsdpLayout.from_tree(tree, policy, paths=paths,
                                      shard_dims=shard_dims,
                                      n_shards=n_shards, by_rule=by_rule)
        engines = tuple(
            GradientExchange(
                g.cfg.to_quantizer(), inter_group if intra else group,
                server_requant=g.cfg.server_requant,
                max_chunk_elems=None if g.sharded else max_chunk_elems,
                pipeline_chunks=pipeline_chunks,
                intra_group=intra_group if intra else None)
            for g in layout.groups)
        return cls(layout=layout, engines=engines, dp_axes=dp,
                   intra_axes=intra, n_intra=n_intra,
                   pipeline_chunks=pipeline_chunks, group=group)

    def specialize(self, policy: QuantPolicy) -> "FsdpExchange":
        """One phase's engine from a ``by_rule`` skeleton (see
        ``PartitionedExchange.specialize``): the same groups and EF sizes
        in every phase (a ramp never materializes to an identity scheme,
        so the None pattern stays too)."""
        layout = self.layout.with_configs(policy)
        return dataclasses.replace(
            self, layout=layout, engines=_respecialized(self.engines,
                                                        layout.groups))

    @property
    def inter_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.dp_axes if a not in self.intra_axes)

    @property
    def n_inter(self) -> int:
        return self.layout.n_shards // self.n_intra

    @property
    def is_identity(self) -> bool:
        return all(e.qz.is_identity for e in self.engines)

    def worker_id(self) -> int:
        """This worker's index over the combined dp axes (its rank)."""
        return world(self.group)[1]

    def _group_key(self, key: torch.Tensor, gi: int) -> torch.Tensor:
        # a single group keeps the unfolded key (PartitionedExchange's rule)
        return key if len(self.engines) == 1 else prng.fold_in(key, gi)

    def _split_wid(self, worker_id: int):
        """Combined worker id -> (inter id, intra id); inter-major."""
        if not self.intra_axes:
            return worker_id, None
        self._pod()
        return worker_id // self.n_intra, worker_id % self.n_intra

    def _pod(self):
        """The pod's process group (two-level mode)."""
        pod = self.engines[0].intra_group if self.engines else None
        if pod is None:
            raise ValueError(
                f"the two-level exchange over {self.intra_axes} needs its "
                f"pod's process group (hierarchical.pod_groups)")
        return pod

    def _sharded_intra_scatter(self, buf: torch.Tensor) -> torch.Tensor:
        """(L_p·L_i·chunk,) worker-major buffer -> this worker's (L_p·chunk,)
        fp intra mean: the rows of its data column across all pods."""
        chunk = buf.shape[0] // self.layout.n_shards
        parts = buf.reshape(self.n_inter, self.n_intra, chunk)
        # slice j of dim 1 goes to intra rank j
        mean = scatter_mean(parts.transpose(0, 1),
                            self._pod())                  # (L_p, chunk)
        return mean.reshape(-1)

    # -- the exchange --------------------------------------------------------
    def exchange_with_residuals(
        self, bufs: Sequence[torch.Tensor], key: torch.Tensor,
        worker_id: Optional[int] = None, ef_bufs=None,
    ) -> Tuple[Tuple[torch.Tensor, ...], Optional[Tuple[Any, ...]]]:
        """Per-group local cotangent buffers -> (per-group outputs, new EF
        residuals or None). ``ef_bufs`` (group-aligned, None for identity
        groups) are added to each group's quantizer input (the raw buffer
        in flat mode, the intra-mean shard in two-level mode) and the
        residuals e = b - Q^-1(Q(b)) come back second. Sharded groups give
        this worker's (size/L,) mean chunk, replicated groups the full
        (size,) mean."""
        want_ef = ef_bufs is not None
        if not want_ef:
            ef_bufs = (None,) * len(self.engines)
        wid = self.worker_id() if worker_id is None else worker_id
        wid_inter, wid_intra = self._split_wid(wid)
        outs: List[torch.Tensor] = []
        res: List[Optional[torch.Tensor]] = []
        for gi, (eng, g) in enumerate(zip(self.engines, self.layout.groups)):
            gk = self._group_key(key, gi)
            ef = ef_bufs[gi]
            quantized_ef = want_ef and not eng.qz.is_identity
            if not self.intra_axes:
                b = bufs[gi] if ef is None else bufs[gi] + ef
                if g.sharded:
                    outs.append(quantized_reduce_scatter_mean(
                        b, eng.qz, gk, group=eng.group, worker_id=wid,
                        pipeline_chunks=self.pipeline_chunks))
                    res.append(b - local_qdq_comm_layout(
                        b, eng.qz, gk, group=eng.group, worker_id=wid)
                        if quantized_ef else None)
                else:
                    outs.append(eng.exchange_flat(b, gk, worker_id=wid))
                    res.append(b - eng.local_qdq_flat(b, gk, worker_id=wid)
                               if quantized_ef else None)
                continue
            # two-level: quantize only across pods
            if g.sharded:
                shard = self._sharded_intra_scatter(bufs[gi])
                b = shard if ef is None else shard + ef
                kk = eng._intra_fold(gk, wid_intra)
                outs.append(quantized_reduce_scatter_mean(
                    b, eng.qz, kk, group=eng.group, worker_id=wid_inter,
                    pipeline_chunks=self.pipeline_chunks))
                res.append(b - local_qdq_comm_layout(
                    b, eng.qz, kk, group=eng.group, worker_id=wid_inter)
                    if quantized_ef else None)
            else:
                shard, valid = eng.intra_scatter(bufs[gi])
                b = shard if ef is None else shard + ef
                mean_shard = eng.exchange_shard(
                    b, gk, valid=valid, worker_id=wid_inter,
                    intra_id=wid_intra)
                outs.append(eng.intra_gather(mean_shard, g.size))
                res.append(b - eng.local_qdq_shard(
                    b, gk, valid=valid, worker_id=wid_inter,
                    intra_id=wid_intra) if quantized_ef else None)
        return tuple(outs), (tuple(res) if want_ef else None)

    def exchange_bufs(self, bufs: Sequence[torch.Tensor], key: torch.Tensor,
                      worker_id: Optional[int] = None
                      ) -> Tuple[torch.Tensor, ...]:
        """Per-group local buffers -> per-group outputs."""
        return self.exchange_with_residuals(bufs, key, worker_id)[0]

    def residual_bufs(self, bufs: Sequence[torch.Tensor], key: torch.Tensor,
                      worker_id: Optional[int] = None
                      ) -> Tuple[Optional[torch.Tensor], ...]:
        """Error-feedback residuals e = b - Q^-1(Q(b)), bit-consistent with
        :meth:`exchange_bufs`; None for identity groups. Two-level
        residuals live on the intra-mean shard (this standalone path runs
        the fp intra scatter again)."""
        wid = self.worker_id() if worker_id is None else worker_id
        wid_inter, wid_intra = self._split_wid(wid)
        res = []
        for gi, (eng, g) in enumerate(zip(self.engines, self.layout.groups)):
            if eng.qz.is_identity:
                res.append(None)
                continue
            gk = self._group_key(key, gi)
            if not self.intra_axes:
                local = (local_qdq_comm_layout(bufs[gi], eng.qz, gk,
                                               group=eng.group, worker_id=wid)
                         if g.sharded
                         else eng.local_qdq_flat(bufs[gi], gk, worker_id=wid))
                res.append(bufs[gi] - local)
            elif g.sharded:
                shard = self._sharded_intra_scatter(bufs[gi])
                kk = eng._intra_fold(gk, wid_intra)
                res.append(shard - local_qdq_comm_layout(
                    shard, eng.qz, kk, group=eng.group, worker_id=wid_inter))
            else:
                shard, valid = eng.intra_scatter(bufs[gi])
                res.append(shard - eng.local_qdq_shard(
                    shard, gk, valid=valid, worker_id=wid_inter,
                    intra_id=wid_intra))
        return tuple(res)

    def ef_group_sizes(self) -> Tuple[Optional[int], ...]:
        """Per-group residual lengths on one worker: the full group size in
        flat mode, the 1/n_intra intra shard in two-level mode, None for
        identity groups."""
        sizes = []
        for eng, g in zip(self.engines, self.layout.groups):
            if eng.qz.is_identity:
                sizes.append(None)
            elif not self.intra_axes:
                sizes.append(g.size)
            elif g.sharded:
                sizes.append(g.size // self.n_intra)
            else:
                sizes.append(-(-g.size // self.n_intra))
        return tuple(sizes)

    def group_stats_stored(self, grads_tree, ef=None) -> torch.Tensor:
        """(n_groups, 3) f32 rows ``[sigma_sq, clip_frac, ef_norm_sq]``
        from the STORED-shard gradient tree the exchange hands back (each
        worker's slices of the across-worker mean): unlike the replicated
        ``PartitionedExchange.group_stats`` a post-exchange approximation,
        as in the reference; the controller reads relative magnitudes."""
        leaves = self.layout._check(tree_leaves(grads_tree))
        return torch.stack([
            _stats_row(eng.qz, torch.cat([leaves[i].to(torch.float32)
                                          .reshape(-1) for i in g.leaf_ids]),
                       None if ef is None else ef[gi])
            for gi, (eng, g) in enumerate(zip(self.engines,
                                              self.layout.groups))])

    # -- static cost accounting --------------------------------------------
    def quantized_group_count(self) -> int:
        return sum(1 for e in self.engines if not e.qz.is_identity)

    def _group_link_stats(self, eng: GradientExchange, g: FsdpGroup) -> dict:
        return link_stats(
            eng.qz, g.size, n_intra=self.n_intra, n_inter=self.n_inter,
            two_level=bool(self.intra_axes),
            server_requant=eng.server_requant, sharded=g.sharded,
            max_chunk_elems=eng.max_chunk_elems,
            pipeline_chunks=eng.pipeline_chunks)

    def collective_launches(self) -> int:
        """Backward launches of one step: a sharded group pays phase 1
        only (2 all_to_all a pipeline chunk; fp: 1 reduce-scatter), a
        replicated group the full Algorithm 2; two-level adds the fp intra
        scatter (and, for replicated groups, gather)."""
        if self.intra_axes:
            return int(sum(self._group_link_stats(eng, g)["launches"]
                           for eng, g in zip(self.engines,
                                             self.layout.groups)))
        L = self.layout.n_shards
        return sum(
            GradientExchange.rs_stats(
                eng.qz, g.size, L,
                pipeline_chunks=eng.pipeline_chunks)[0] if g.sharded
            else eng.collective_launches(g.size, L)
            for eng, g in zip(self.engines, self.layout.groups))

    def wire_bytes_per_worker(self) -> float:
        """Gradient bytes one worker sends a step (sharded groups: the
        phase-1 uplink only; the bf16 parameter all-gather belongs to the
        forward). Two-level counts both links (see
        :meth:`link_bytes_per_worker`)."""
        if self.intra_axes:
            lb = self.link_bytes_per_worker()
            return lb["ici_bytes"] + lb["dcn_bytes"]
        L = self.layout.n_shards
        return sum(
            GradientExchange.rs_stats(eng.qz, g.size, L)[1] if g.sharded
            else eng.wire_bytes_per_worker(g.size, L)
            for eng, g in zip(self.engines, self.layout.groups))

    def link_bytes_per_worker(self) -> dict:
        """{ici_bytes, dcn_bytes, dcn_q_bytes, launches} summed over the
        groups (``exchange.link_stats``)."""
        total = _zero_links()
        for eng, g in zip(self.engines, self.layout.groups):
            st = self._group_link_stats(eng, g)
            for k in total:
                total[k] += st[k]
        return total

    def launches_and_bytes(self) -> Tuple[int, float]:
        return self.collective_launches(), self.wire_bytes_per_worker()


# ---------------------------------------------------------------------------
# the whole-tree gather
# ---------------------------------------------------------------------------

class _TreeGather(torch.autograd.Function):
    """forward: stored shards -> full leaves (one all-gather per sharded
    group); backward: the fused exchange. The inputs after the shards are
    the EF buffers of the quantized groups; their gradient is the NEW
    residual stream."""

    @staticmethod
    def forward(ctx, ex, key, wid, ef_slots, compute_dtype, param_dtype,
                *tensors):
        n = len(ex.layout.slots)
        ctx.ex, ctx.key, ctx.wid = ex, key, wid
        ctx.ef_slots, ctx.param_dtype = ef_slots, param_dtype
        ctx.save_for_backward(*tensors[n:])
        ctx.full_shapes = [s.shape for s in ex.layout.slots]
        ctx.compute_dtype = compute_dtype
        shards = tree_unflatten(ex.layout.treedef, tensors[:n])
        return tuple(tree_leaves(ex.layout.gather_full(
            shards, ex.group, compute_dtype=compute_dtype)))

    @staticmethod
    def backward(ctx, *g_full):
        ex = ctx.ex
        g_full = [torch.zeros(shape, dtype=ctx.compute_dtype,
                              device=ctx.key.device) if g is None else g
                  for g, shape in zip(g_full, ctx.full_shapes)]
        bufs = ex.layout.flatten_groups(g_full)
        ef_bufs = None
        if ctx.ef_slots is not None:
            ef_bufs = [None] * len(ex.engines)
            for gi, e in zip(ctx.ef_slots, ctx.saved_tensors):
                ef_bufs[gi] = e
        outs, new_ef = ex.exchange_with_residuals(bufs, ctx.key, ctx.wid,
                                                  ef_bufs)
        shard_ct = tree_leaves(ex.layout.unflatten_outputs(
            outs, param_dtype=ctx.param_dtype))
        ef_ct = ([new_ef[gi] for gi in ctx.ef_slots]
                 if ctx.ef_slots is not None else [])
        return (None,) * 6 + tuple(shard_ct) + tuple(ef_ct)


def make_fused_tree_gather(ex: FsdpExchange, *,
                           compute_dtype=torch.bfloat16,
                           param_dtype=torch.float32):
    """Returns ``gather(shard_params, ef_bufs, key) -> full_params``.

    fwd: one bf16 all-gather per sharded policy group (replicated leaves
         cast in place), the whole-tree ZeRO-3 parameter broadcast.
    bwd: the cotangents are flattened into the group buffers, the EF
         buffers (if ``ef_bufs`` is not None) are added, each group runs
         its one quantized reduce-scatter (sharded) or all-reduce
         (replicated), and the result lands on the STORED shards.

    The new residuals ride the gradient of the EF input, as in the
    reference: with ``ef_bufs`` entries that require grad,

        torch.autograd.grad(loss, shard_leaves + ef_leaves)

    returns the shards' gradients and the new residuals from one backward
    pass. ``ef_bufs=None`` turns error feedback off."""

    def gather(shard_params, ef_bufs, key):
        ef_slots, ef_in = None, []
        if ef_bufs is not None:
            ef_slots = tuple(gi for gi, e in enumerate(ef_bufs)
                             if e is not None)
            ef_in = [ef_bufs[gi] for gi in ef_slots]
        full = _TreeGather.apply(ex, key, ex.worker_id(), ef_slots,
                                 compute_dtype, param_dtype,
                                 *tree_leaves(shard_params), *ef_in)
        return tree_unflatten(ex.layout.treedef, list(full))

    return gather
