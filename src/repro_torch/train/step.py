"""Data-parallel train step with the paper's quantized gradient exchange
(the reference's ``train/step.py``): replicated (Algorithm 2) and fsdp
(ZeRO-3) modes, flat, two-level or two-level asynchronous, with a static
quantization policy or an adaptive bit schedule.

Each worker (a ``torch.distributed`` rank) computes the loss and its
gradient on its rows of the batch (autograd through the plain PyTorch
forward, the counterpart of ``jax.value_and_grad``).

``mode="replicated"`` (the default here and in both launchers; the
reference's ``TrainConfig`` defaults to fsdp) keeps every parameter on
every worker and exchanges the gradient by one of three schedules:

* fused (default): the gradient flattened into one f32 buffer per policy
  group (``PartitionedExchange``), one two-phase quantized all-reduce per
  group (``pipeline_chunks = K`` issues it as K bucket-row chunks,
  bit-identical to K = 1). Key: ``fold_in(key, step)`` ->
  ``fold_in(., crc32(b"fused_exchange") & 0x7FFFFFFF)`` -> the group key
  (unfolded for a single group) -> the per-worker folds inside the
  collectives.
* per-leaf (``fused_exchange=False``): one quantized all-reduce per
  parameter leaf under its policy-resolved quantizer, keyed by
  ``fold_in(key_step, crc32(path) & 0x7FFFFFFF)``; an fp leaf is an
  all-reduce / L.
* single-device (``make_train_step(..., data_parallel=False)``): the
  counterpart of the reference's mesh with no data axis. Each gradient is
  quantized and dequantized locally, with no collective and no averaging
  of the metrics; no process group is needed. The branch is chosen by that
  argument only, never from whether a process group exists.

``mode="fsdp"`` stores each worker's slice of every parameter leaf
(sharded along its d_model-sized dim, :func:`plan_sharding_shapes`;
leaves with no divisible dim stay whole) and its optimizer state:

* fused (default): the whole tree is gathered in bf16 by one
  ``torch.autograd.Function`` (``fsdp_exchange.make_fused_tree_gather``):
  one all-gather per policy group forward, and backward one quantized
  reduce-scatter per sharded group (phase 1 only) plus one all-reduce per
  replicated group, onto the stored shards; EF residuals (one flat buffer
  per quantized group) come back as the gradient of the EF input;
* per-leaf (``fused_exchange=False``): the model gathers each leaf (each
  stacked layer's slice) at its point of use through ``gather.py``'s
  Functions, keyed by ``fold_in(fold_in(step_key, crc32(path) &
  0x7FFFFFFF), repeat)``; error feedback is ignored there, with a warning,
  as in the reference.

``hierarchy`` "two_level" (or "auto" with ``pods > 1``) splits the dp
world into pods (``hierarchical.py``): the fused exchanges average in
full precision within a pod and quantize only across pods, with EF
residuals on the intra shard. The per-leaf schedules stay flat (an
explicit two_level warns). "two_level_async" with ``local_steps = H > 1``
makes the hierarchy temporal (:class:`AsyncTrainStep`): H - 1 inner steps
average the gradient within the pod only, then a sync step exchanges the
window's parameter delta across pods (quantized, EF on it) into an outer
SGD-momentum / Nesterov step. It needs a pod axis: ``pods > 1``, or
``pod_axis=True`` for a world of one pod (the reference's mesh
``("pod",)``).

Under a model axis (``make_train_step(..., mesh=make_host_mesh(model=N))``)
every rank stores its (dp, tp) block of each leaf by the plan
(:func:`plan_sharding_shapes`) and computes the forward and backward on
its blocks (``models/tp.py``). In replicated mode the TP blocks of the
gradient are gathered over the model group (one all-reduce) and the
unchanged fused exchange runs on the full gradient over the dp group,
identically on every model rank, as the reference's exchange replicates
TP-sharded cotangents over ``model``; each rank keeps its block of the
mean. fsdp mode takes the per-leaf gathers (``_fused_fsdp_active``): each
rank's TP block of a cotangent is reduce-scattered over its dp group,
keyed by its dp index alone. The bit schedule's phase steps are built on
the same layout (the engines on the gathered gradient's). Under
two_level_async the inner steps average each rank's TP blocks within its
pod's dp group; the sync step gathers the window's delta over ``model``
before the unchanged exchange and each rank keeps its block of the new
anchor.

:class:`ScheduledTrainStep` drives a ``BitSchedule`` /
``BitBudgetController`` (``core/policy.py``) over the same machinery: one
engine skeleton grouped by policy rule (so the EF shapes do not change
with the bits), specialized per phase into the engines of that phase's
static policy, held in an LRU keyed by the bits tuple.

Every worker then applies its mean gradient with the configured optimizer
(SGD + momentum 0.9 by default, rounded as the reference's jitted step
rounds it: ``optimizers.step``) to the parameters it stores.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
import zlib
from collections import OrderedDict
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import prng
from repro_torch.core.api import QuantConfig
from repro_torch.core.comm import hierarchical
from repro_torch.core.comm.collectives import _all_gather, world
from repro_torch.core.comm.exchange import (GradientExchange, LeafExchange,
                                            PartitionedExchange,
                                            observed_link_stats)
from repro_torch.core.comm.fsdp_exchange import (FsdpExchange, FsdpLayout,
                                                 make_fused_tree_gather)
from repro_torch.core.comm.gather import (make_fsdp_gather,
                                          make_replicated_gather)
from repro_torch.core.floats import fma_f32
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import tp as tp_mod
from repro_torch.models.model import LM
from repro_torch.optim import optimizers as opt_lib
from repro_torch.optim.schedule import constant_lr
from repro_torch.train.state import OuterState, TrainState
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten
from repro_torch.utils.sharding import (choose_fsdp_dim, dp_axis_names,
                                        spec_dp_dim)

# key-fold salt separating the fused whole-tree exchange stream from the
# per-leaf (crc32-of-path) streams
_FUSED_SALT = zlib.crc32(b"fused_exchange") & 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    policy: Optional[Any] = None    # QuantPolicy or anything coercible
    mode: str = "replicated"        # replicated | fsdp (the reference's
                                    # TrainConfig defaults to fsdp, its
                                    # launcher to replicated)
    hierarchy: str = "auto"         # flat | two_level | two_level_async |
                                    # auto (two_level when the dp world has
                                    # a pod axis, never the async one)
    local_steps: int = 1            # two_level_async window H: H - 1 inner
                                    # steps synced within the pod, then one
                                    # quantized outer exchange of the
                                    # window's delta across pods; H = 1 is
                                    # the two_level path itself
    optimizer: str = "sgd"          # sgd | adamw (paper: SGD+momentum 0.9)
    momentum: float = 0.9
    weight_decay: float = 0.0
    outer_optimizer: str = "nesterov"   # nesterov | sgd, on the outer
                                        # pseudo-gradient (anchor - local
                                        # params) at sync steps
    outer_lr: float = 0.7           # DiLoCo-style outer step size
    outer_momentum: float = 0.9
    error_feedback: bool = False    # beyond-paper: EF residual accumulation
    fused_exchange: bool = True     # one flat-buffer collective per policy
                                    # group (False: one per leaf)
    exchange_chunk_elems: Optional[int] = None  # size cap per collective
    pipeline_chunks: int = 1        # K bucket-row chunks per fused
                                    # exchange, bit-identical to K = 1
    group_by_rule: bool = False     # group the fused exchanges by policy
                                    # RULE instead of resolved config: the
                                    # same groups when the configs differ,
                                    # and the same in every phase of a bit
                                    # schedule (EF shapes survive a change
                                    # of bits)
    collect_stats: bool = False     # emit ``exchange_stats``: (n_groups,
                                    # 3) f32 [sigma_sq, clip_frac,
                                    # ef_norm_sq] per policy group, averaged
                                    # over the workers (the
                                    # BitBudgetController's feed; fused
                                    # paths only)

    def __post_init__(self):
        if self.mode not in ("replicated", "fsdp"):
            raise ValueError(f"mode must be 'replicated' or 'fsdp', got "
                             f"{self.mode!r}")
        if self.hierarchy not in hierarchical.HIERARCHIES:
            raise ValueError(f"hierarchy must be one of "
                             f"{hierarchical.HIERARCHIES}, got "
                             f"{self.hierarchy!r}")
        if self.pipeline_chunks < 1:
            raise ValueError(
                f"pipeline_chunks must be >= 1, got {self.pipeline_chunks}")
        if self.local_steps < 1:
            raise ValueError(
                f"local_steps must be >= 1, got {self.local_steps}")
        if self.local_steps > 1 and self.hierarchy != "two_level_async":
            raise ValueError(
                "local_steps > 1 is the two_level_async inner-window "
                "length — set hierarchy='two_level_async' (got "
                f"hierarchy={self.hierarchy!r})")
        if self.hierarchy == "two_level_async":
            # the temporal tier rides the fused replicated engines; a
            # silent fallback to a per-step exchange would change training
            if self.mode != "replicated":
                raise ValueError(
                    "hierarchy='two_level_async' needs mode='replicated' "
                    "(the outer delta exchange rides the fused replicated "
                    f"engines), got mode={self.mode!r}")
            if not self.fused_exchange:
                raise ValueError(
                    "hierarchy='two_level_async' needs the fused exchange "
                    "(fused_exchange=True)")
        if self.outer_optimizer not in ("nesterov", "sgd"):
            raise ValueError(
                "outer_optimizer must be 'nesterov' or 'sgd', got "
                f"{self.outer_optimizer!r}")

    def resolved_policy(self) -> QuantPolicy:
        """The effective QuantPolicy (``policy``, else uniform fp)."""
        if self.policy is None:
            return QuantPolicy.uniform(QuantConfig(name="fp"))
        return QuantPolicy.coerce(self.policy)


# ---------------------------------------------------------------------------
# the sharding plan (mesh-free)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    specs: Dict[str, Tuple[Any, ...]]       # path -> spec (full coords)
    paths: Any                      # tree of path strings
    gather_dims: Dict[str, Optional[int]]   # path -> fsdp dim (slice coords)
    tp_dims: Dict[str, Optional[int]]       # path -> TP dim (None: no TP)
    dp_axes: Tuple[str, ...]
    n_dp: int
    n_model: int
    axis_sizes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def full_shard_dims(self) -> Dict[str, Optional[int]]:
        """path -> dp-shard dim in FULL leaf coordinates (the stacked
        leading dim included; ``gather_dims`` is in per-repeat slice
        coordinates). The fused fsdp exchange lays its buffers out by
        these."""
        return {p: spec_dp_dim(s, self.dp_axes)
                for p, s in self.specs.items()}

    def full_tp_dims(self) -> Dict[str, Optional[int]]:
        """path -> TP dim in FULL leaf coordinates (None: not split)."""
        return {p: next((i for i, e in enumerate(s) if e == "model"), None)
                for p, s in self.specs.items()}


class ModelShards:
    """This rank's TP blocks of params-shaped trees under a model axis:
    ``block`` slices a full tree, ``full`` gathers the blocks back (one
    all-reduce over the model group); ``model_tp`` is what the model's
    forward reads."""

    def __init__(self, axis: "tp_mod.Axis", plan: ShardingPlan):
        self.axis, self.plan = axis, plan
        full = plan.full_tp_dims()
        self.dims = [full[p] for p in tree_leaves(plan.paths)]
        self.model_tp = tp_mod.ModelTP(axis, dict(plan.tp_dims))

    def block(self, tree):
        return tree_unflatten(tree, [
            x if d is None else tp_mod.own_block(self.axis, x, d).clone()
            for x, d in zip(tree_leaves(tree), self.dims)])

    def full(self, tree, *more):
        """The full trees of ``tree`` (and of ``more``, None passing
        through), gathered in one all-reduce; a tuple when more than one
        is given."""
        trees = (tree,) + more
        leaves, dims = [], []
        for t in trees:
            if t is not None:
                leaves += tree_leaves(t)
                dims += self.dims
        it = iter(tp_mod.gather_leaves(self.axis, leaves, dims))
        out = tuple(None if t is None else tree_unflatten(
            t, [next(it) for _ in self.dims]) for t in trees)
        return out if more else out[0]

    def block_shapes(self, aparams):
        """The tree of ``meta`` tensors of this rank's block shapes."""
        def shape(x, d):
            s = list(x.shape)
            if d is not None:
                s[d] //= self.axis.n
            return torch.empty(s, dtype=x.dtype, device="meta")
        return tree_unflatten(aparams, [shape(x, d) for x, d in zip(
            tree_leaves(aparams), self.dims)])


def plan_sharding_shapes(model: LM, aparams, *, dp_axes: Tuple[str, ...],
                         axis_sizes: Dict[str, int]) -> ShardingPlan:
    """The fsdp and TP dims of every leaf from the parameter shapes and the
    axis sizes (the reference's ``train/step.py:321-365``). The fsdp dim
    of the per-repeat slice: a d_model-sized dim first, else the largest
    divisible one, else None (dp-replicated). The TP dim over ``model``,
    among the other dims divisible by its size: the experts dim first,
    else the largest (the first of equal sizes), else None."""
    n_dp = math.prod(axis_sizes[a] for a in dp_axes) if dp_axes else 1
    n_model = axis_sizes.get("model", 1)
    paths = model.param_paths(aparams)
    gather_dims: Dict[str, Optional[int]] = {}
    tp_dims: Dict[str, Optional[int]] = {}

    def leaf_spec(path: str, leaf):
        shape = tuple(leaf.shape)
        off = 1 if (path.startswith("g") or path.startswith("enc/g")) else 0
        sl = shape[off:]
        fdim = (choose_fsdp_dim(sl, n_dp, prefer_sizes=(model.cfg.d_model,))
                if dp_axes else None)
        gather_dims[path] = fdim
        cand = [i for i, s in enumerate(sl)
                if i != fdim and s % n_model == 0 and s >= n_model]
        tdim = None
        if cand and n_model > 1:
            n_exp = model.cfg.moe.num_experts if model.cfg.moe else -1
            pref = [i for i in cand if sl[i] == n_exp]
            tdim = pref[0] if pref else max(cand, key=lambda i: sl[i])
        tp_dims[path] = tdim
        ent = [None] * len(shape)
        if fdim is not None:
            ent[off + fdim] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
        if tdim is not None:
            ent[off + tdim] = "model"
        return tuple(ent)

    specs = {p: leaf_spec(p, x)
             for p, x in zip(tree_leaves(paths), tree_leaves(aparams))}
    return ShardingPlan(specs=specs, paths=paths, gather_dims=gather_dims,
                        tp_dims=tp_dims, dp_axes=tuple(dp_axes), n_dp=n_dp,
                        n_model=n_model, axis_sizes=dict(axis_sizes))


def plan_sharding(model: LM, aparams, mesh) -> ShardingPlan:
    """:func:`plan_sharding_shapes` on a mesh's axes (a ``launch.mesh``
    ``HostMesh`` or ``MeshShape``)."""
    return plan_sharding_shapes(
        model, aparams, dp_axes=dp_axis_names(mesh.axis_names),
        axis_sizes=dict(zip(mesh.axis_names, mesh.shape)))


def dp_world(n_workers: int, pods: int = 1, pod_axis: bool = False
             ) -> Tuple[Tuple[str, ...], Dict[str, int]]:
    """(dp axes, axis sizes) of ``n_workers`` workers in ``pods`` pods:
    ``("data",)``, or ``("pod", "data")`` when ``pods > 1`` (rank = pod *
    n_data + data). ``pod_axis=True`` names the pod axis with one pod too,
    as the reference's mesh ``("pod", "data")`` of shape ``(1, n)`` does:
    the two-level split then keeps its intra axis, and two_level_async has
    the pod axis it needs."""
    if pods < 1 or n_workers % pods:
        raise ValueError(f"{n_workers} workers do not split into {pods} "
                         f"pods")
    if pods == 1 and not pod_axis:
        return ("data",), {"data": n_workers}
    return dp_axis_names(("pod", "data")), {"pod": pods,
                                            "data": n_workers // pods}


def _fused_fsdp_active(tcfg: TrainConfig, plan: ShardingPlan) -> bool:
    """Whether the fused whole-tree fsdp exchange runs (pure-dp worlds)."""
    return (tcfg.mode == "fsdp" and tcfg.fused_exchange
            and bool(plan.dp_axes) and plan.n_model == 1)


def _async_local_steps(tcfg: TrainConfig, dp_axes) -> int:
    """The effective inner window H: > 1 only when two_level_async stays
    async after resolution (H = 1 resolves to the two_level path)."""
    if hierarchical.resolve_hierarchy(tcfg.hierarchy, dp_axes,
                                      tcfg.local_steps) == "two_level_async":
        return tcfg.local_steps
    return 1


def check_async_axes(tcfg: TrainConfig, dp_axes: Tuple[str, ...]) -> None:
    """two_level_async with H > 1 needs an inter-pod dp axis to run the
    outer sync over (dropping the sync would train the pods apart)."""
    if _async_local_steps(tcfg, dp_axes) > 1 and not any(
            a in hierarchical.INTER_AXIS_NAMES for a in dp_axes):
        raise ValueError(
            "hierarchy='two_level_async' with local_steps="
            f"{tcfg.local_steps} needs an inter-pod dp axis "
            f"({hierarchical.INTER_AXIS_NAMES}) to run the outer sync over "
            f"— dp axes are {tuple(dp_axes)}; build the mesh with "
            "--pods >= 2")


def _exchange_axes(tcfg: TrainConfig, dp_axes: Tuple[str, ...],
                   axis_sizes: Dict[str, int],
                   plan: Optional[ShardingPlan] = None
                   ) -> Tuple[Tuple[str, ...], Tuple[str, ...], int]:
    """``tcfg.hierarchy`` against the dp world and the exchange path:
    ``(intra_axes, inter_axes, n_intra)``; flat (and every degenerate case)
    is ``((), dp_axes, 1)``. Two-level needs a fused engine: an explicit
    "two_level" on a per-leaf path warns and runs flat, "auto" falls back
    silently. two_level_async (H > 1) validates strictly instead; with no
    intra half (pods of one worker) its outer exchange runs flat."""
    flat = (), tuple(dp_axes), 1
    if _async_local_steps(tcfg, dp_axes) > 1:
        check_async_axes(tcfg, dp_axes)
        intra, inter = hierarchical.split_dp_axes(dp_axes, "two_level")
        n_intra = math.prod(axis_sizes[a] for a in intra)
        return flat if not intra or n_intra <= 1 else (intra, inter,
                                                        n_intra)
    if not dp_axes:
        return flat
    intra, inter = hierarchical.split_dp_axes(dp_axes, tcfg.hierarchy)
    if not intra:
        return flat
    if tcfg.mode == "replicated":
        fused_ok = tcfg.fused_exchange
        why = "fused_exchange=False (per-leaf replicated exchange)"
    else:
        fused_ok = plan is not None and _fused_fsdp_active(tcfg, plan)
        why = "the per-leaf fsdp gather path (fused_exchange=False or " \
              "model parallelism active)"
    if not fused_ok:
        if tcfg.hierarchy == "two_level":
            warnings.warn(
                f"hierarchy='two_level' needs the fused exchange but {why} "
                f"is selected — falling back to the flat combined-axis "
                f"exchange", stacklevel=2)
        return flat
    n_intra = math.prod(axis_sizes[a] for a in intra)
    if n_intra <= 1:
        return flat
    return intra, inter, n_intra


class StepLayout(NamedTuple):
    """What the step and the state are laid out by, built once from the
    model, the config and the dp world."""

    aparams: Any                    # full-shape params (meta tensors)
    plan: ShardingPlan
    dp_axes: Tuple[str, ...]
    intra_axes: Tuple[str, ...]     # () = flat
    n_intra: int
    local_steps: int = 1            # two_level_async window H (1: none)

    @property
    def n_dp(self) -> int:
        return self.plan.n_dp

    @property
    def two_level(self) -> bool:
        return bool(self.intra_axes)

    @property
    def is_async(self) -> bool:
        return self.local_steps > 1


def step_layout(model: LM, tcfg: TrainConfig, n_workers: Optional[int], *,
                pods: int = 1, pod_axis: bool = False,
                n_model: int = 1) -> StepLayout:
    """The layout of a dp world of ``n_workers`` (None: the single-device
    step, no dp axes), with a model axis of ``n_model``."""
    aparams = model.abstract_params()
    if n_workers is None:
        if tcfg.mode == "fsdp":
            raise ValueError("fsdp shards the parameters over data-parallel "
                             "workers: it needs data_parallel=True")
        dp_axes, sizes = (), {}
    else:
        dp_axes, sizes = dp_world(n_workers, pods, pod_axis)
    if n_model > 1:
        sizes = {**sizes, "model": n_model}
    plan = plan_sharding_shapes(model, aparams, dp_axes=dp_axes,
                                axis_sizes=sizes)
    intra, _, n_intra = _exchange_axes(tcfg, dp_axes, sizes, plan)
    return StepLayout(aparams, plan, dp_axes, intra, n_intra,
                      _async_local_steps(tcfg, dp_axes))


def _ef_group_sizes(tcfg: TrainConfig, step
                    ) -> Optional[Tuple[Optional[int], ...]]:
    """Per-worker residual-buffer sizes of the TUPLE form of error
    feedback (fused fsdp, the two-level replicated exchange and
    two_level_async), read from ``step``'s engine; None for identity
    groups. None overall when EF is off, a fully-fp policy leaves nothing
    to feed back, or EF is the params-shaped tree (flat replicated mode,
    ``step`` None)."""
    if not tcfg.error_feedback or step is None:
        return None
    eng = step.exchange
    if isinstance(eng, FsdpExchange):
        sizes = eng.ef_group_sizes()
    elif step.layout.two_level or step.layout.is_async:
        # two-level shards, or in async mode with no intra half the full
        # group buffers: the outer delta's residuals are group-aligned
        # either way, never a params-shaped tree
        sizes = eng.ef_shard_sizes(step.layout.n_intra)
    else:
        return None
    return sizes if any(n is not None for n in sizes) else None


def _make_optimizer(tcfg: TrainConfig) -> opt_lib.Optimizer:
    if tcfg.optimizer == "sgd":
        return opt_lib.sgd_momentum(momentum=tcfg.momentum,
                                    weight_decay=tcfg.weight_decay)
    if tcfg.optimizer == "adamw":
        return opt_lib.adamw(weight_decay=tcfg.weight_decay)
    raise ValueError(tcfg.optimizer)


def _map_opt(fn, opt):
    """``fn`` over the params-shaped trees of an optimizer state."""
    if isinstance(opt, opt_lib.AdamState):
        return opt._replace(mu=fn(opt.mu), nu=fn(opt.nu))
    return fn(opt)


def init_state(model: LM, tcfg: TrainConfig, *, seed: int = 0, device=None,
               step=None) -> TrainState:
    """Params from ``torch.Generator(seed)`` on ``device`` (the card unless
    ``device="cpu"``), zero optimizer state, zero EF residuals when
    ``error_feedback`` is on.

    ``step`` (from :func:`make_train_step`, or a
    :class:`ScheduledTrainStep`) lays the state out: in fsdp mode every
    rank draws the full params and keeps its own slices (and slices its
    optimizer state alike); EF is then a tuple of per-group buffers with
    None for identity groups, as in the two-level replicated and the
    two_level_async modes. In two_level_async mode the state also holds
    the outer anchor (the params) and a zero outer momentum. Those modes
    need ``step``; without it the state is the flat replicated (or
    single-device) one. Under a model axis every rank keeps its TP blocks
    (``step.tp``), then its dp shards of them."""
    if step is None and (tcfg.mode == "fsdp" or tcfg.local_steps > 1):
        raise ValueError("an fsdp or two_level_async state is laid out by "
                         "its step: pass step=make_train_step(...)")
    params = model.init(torch.Generator().manual_seed(seed), device=device)
    if step is not None and step.tp is not None:
        params = step.tp.block(params)
    if step is not None and step.shards is not None:
        params = tree_unflatten(params, step.shards.shard_leaves(
            tree_leaves(params), world(step.group)[1]))
    ef_sizes = _ef_group_sizes(tcfg, step)
    dev = tree_leaves(params)[0].device
    laid_out = step is not None and (step.layout.two_level
                                     or step.layout.is_async)
    if ef_sizes is not None:
        ef = tuple(None if n is None
                   else torch.zeros(n, dtype=torch.float32, device=dev)
                   for n in ef_sizes)
    elif tcfg.error_feedback and tcfg.mode == "replicated" and not laid_out:
        ef = tree_map(torch.zeros_like, params)
    else:
        ef = None
    outer = None
    if step is not None and step.layout.is_async:
        outer = OuterState(
            anchor=tree_map(torch.clone, params),
            mom=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params))
    return TrainState(params=params, opt=_make_optimizer(tcfg).init(params),
                      step=0, ef=ef, outer=outer)


# ---------------------------------------------------------------------------
# full (rank-ordered) state <-> this worker's state
# ---------------------------------------------------------------------------

class StateSharding:
    """Moves a ``TrainState`` between this worker's form and the global
    form the reference's arrays have: fsdp params and optimizer state
    gathered in rank order, tuple EF buffers stacked over the ranks
    (replicated params are the same in both). Used for digests and
    checkpoints.

    In two_level_async mode every worker holds its own params and
    optimizer state (pods diverge within a window): the global form
    stacks them over the ranks on a new leading axis, the reference's
    stacked worker axis, and keeps the outer anchor and momentum as they
    are (the same on every worker).

    A params-shaped EF tree (flat replicated mode) holds each worker's own
    residuals. With one worker it is the reference's array; with L > 1
    each leaf is stacked over the ranks on a new leading axis, so a resume
    restores every worker's residuals (the reference's replicated array
    keeps only one worker's copy in a checkpoint).

    Under a model axis the TP blocks are gathered over the model group
    first (and sliced last), the outer anchor and momentum too, so a
    checkpoint holds the global arrays."""

    def __init__(self, step):
        """``step`` from :func:`make_train_step` (its group and shards)."""
        self.group = step.group
        self.n, self.rank = world(step.group)
        self.layout = step.shards          # None: replicated params
        self.fsdp = self.layout is not None
        self.stacked = step.layout.is_async
        self.tp = step.tp                  # None: no model axis

    def full_params(self, params):
        if self.stacked:
            if self.tp is not None:
                params = self.tp.full(params)
            return tree_map(self._stack_leaf, params)
        if self.fsdp:
            params = tree_unflatten(params, self.layout.unshard_leaves(
                tree_leaves(params), self.group))
        return params if self.tp is None else self.tp.full(params)

    def _shard_params(self, params):
        if self.stacked:
            params = tree_map(lambda t: t[self.rank].clone(), params)
            return params if self.tp is None else self.tp.block(params)
        if self.tp is not None:
            params = self.tp.block(params)
        if not self.fsdp:
            return params
        return tree_unflatten(params, self.layout.shard_leaves(
            tree_leaves(params), self.rank))

    def gather(self, state: TrainState) -> TrainState:
        ef = state.ef
        if isinstance(ef, tuple):
            ef = tuple(None if e is None else self._stack(e) for e in ef)
        elif ef is not None:
            if self.tp is not None:
                ef = self.tp.full(ef)
            if self.n > 1:
                ef = tree_map(self._stack_leaf, ef)
        opt = _map_opt(self.full_params, state.opt)
        if self.stacked and isinstance(opt, opt_lib.AdamState):
            opt = opt._replace(count=torch.full(
                (self.n,), opt.count, dtype=torch.int32))
        outer = state.outer
        if outer is not None and self.tp is not None:
            outer = OuterState(*self.tp.full(outer.anchor, outer.mom))
        return TrainState(params=self.full_params(state.params), opt=opt,
                          step=state.step, ef=ef, outer=outer)

    def scatter(self, full: TrainState) -> TrainState:
        ef = full.ef
        if isinstance(ef, tuple):
            ef = tuple(None if e is None
                       else e.reshape(self.n, -1)[self.rank].clone()
                       for e in ef)
        elif ef is not None:
            if self.n > 1:
                ef = tree_map(lambda e: e[self.rank].clone(), ef)
            if self.tp is not None:
                ef = self.tp.block(ef)
        opt = _map_opt(self._shard_params, full.opt)
        if self.stacked and isinstance(opt, opt_lib.AdamState):
            opt = opt._replace(count=int(opt.count[self.rank]))
        outer = full.outer
        if outer is not None and self.tp is not None:
            outer = OuterState(self.tp.block(outer.anchor),
                               self.tp.block(outer.mom))
        return TrainState(params=self._shard_params(full.params), opt=opt,
                          step=full.step, ef=ef, outer=outer)

    def _stack(self, e: torch.Tensor) -> torch.Tensor:
        out = [torch.empty_like(e) for _ in range(self.n)]
        dist.all_gather(out, e.contiguous(), group=self.group)
        return torch.cat([t.reshape(-1) for t in out])

    def _stack_leaf(self, e: torch.Tensor) -> torch.Tensor:
        """(...) on every rank -> (n, ...) in rank order."""
        return self._stack(e).reshape((self.n,) + tuple(e.shape))


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def exchange_engine(model: LM, tcfg: TrainConfig, group=None
                    ) -> PartitionedExchange | LeafExchange:
    """The replicated-mode exchange the step runs on one flat dp group
    (fused, or per leaf when ``fused_exchange`` is off), laid out from the
    model's parameter shapes."""
    params = model.abstract_params()
    paths = model.param_paths(params)
    if not tcfg.fused_exchange:
        return LeafExchange.build(tcfg.resolved_policy(), params, group,
                                  paths=paths)
    return PartitionedExchange.build(
        tcfg.resolved_policy(), params, group, paths=paths,
        max_chunk_elems=tcfg.exchange_chunk_elems,
        pipeline_chunks=tcfg.pipeline_chunks, by_rule=tcfg.group_by_rule)


class ExchangeEngines(NamedTuple):
    """The exchange machinery one train step is built around (the
    reference's ``ExchangeEngines``), from :func:`exchange_engines`.
    ``pex`` is built in every mode: it runs the fused replicated and the
    async exchanges and prices a policy (the bit schedule's cost)."""

    pex: PartitionedExchange        # fused replicated engine
    fex: Optional[FsdpExchange]     # the fused fsdp engine, else None
    layout: StepLayout
    policy: QuantPolicy
    group: Any                      # the dp process group (None: default)
    intra_group: Any                # the pod (two-level), else None
    inter_group: Any                # across pods (two-level), else None
    data_parallel: bool = True


def exchange_engines(model: LM, tcfg: TrainConfig, *, group=None,
                     data_parallel: bool = True, pods: int = 1,
                     pod_axis: bool = False, mesh=None) -> ExchangeEngines:
    """Build the engines as :func:`make_train_step` runs them (the same
    policy, hierarchy split and chunking); a two-level layout creates the
    pods' process groups here (every rank calls this). ``mesh`` (a
    ``launch.mesh.HostMesh``) gives the dp group, the pods and the model
    axis instead of ``group`` / ``pods``."""
    if not data_parallel and (group is not None or mesh is not None):
        raise ValueError("a single-device step takes no process group")
    n_model = 1
    if mesh is not None:
        if group is not None or pods != 1:
            raise ValueError("a mesh gives the dp group and the pods: pass "
                             "neither group nor pods with it")
        group, pods, n_model = mesh.dp_group, mesh.pods, mesh.n_model
    lay = step_layout(model, tcfg, world(group)[0] if data_parallel
                      else None, pods=pods, pod_axis=pod_axis,
                      n_model=n_model)
    intra_group = inter_group = None
    if lay.two_level:
        if mesh is not None:
            intra_group, inter_group = mesh.pod_groups(lay.n_intra)
        elif group is not None:
            raise ValueError("the two-level hierarchy splits the default "
                             "process group into pods: pass group=None")
        else:
            intra_group, inter_group = hierarchical.pod_groups(
                lay.n_dp // lay.n_intra, lay.n_intra)
    policy = tcfg.resolved_policy()
    pex = PartitionedExchange.build(
        policy, lay.aparams, inter_group if lay.two_level else group,
        paths=lay.plan.paths, max_chunk_elems=tcfg.exchange_chunk_elems,
        pipeline_chunks=tcfg.pipeline_chunks, intra_group=intra_group,
        by_rule=tcfg.group_by_rule)
    fex = None
    if _fused_fsdp_active(tcfg, lay.plan):
        fex = FsdpExchange.build(
            policy, lay.aparams, lay.dp_axes, paths=lay.plan.paths,
            shard_dims=lay.plan.full_shard_dims(), n_shards=lay.n_dp,
            group=group, max_chunk_elems=tcfg.exchange_chunk_elems,
            intra_axes=lay.intra_axes, n_intra=lay.n_intra,
            pipeline_chunks=tcfg.pipeline_chunks, intra_group=intra_group,
            inter_group=inter_group, by_rule=tcfg.group_by_rule)
    return ExchangeEngines(pex, fex, lay, policy, group, intra_group,
                           inter_group, data_parallel)


def specialize_engines(eng: ExchangeEngines,
                       policy: QuantPolicy) -> ExchangeEngines:
    """A by-rule engine bundle re-materialized for a new static policy
    without rebuilding layouts or process groups: the same groups, order
    and EF shapes, only the per-group quantizers change (the bit
    schedule's phase specialization)."""
    return eng._replace(
        pex=eng.pex.specialize(policy), policy=policy,
        fex=eng.fex.specialize(policy) if eng.fex is not None else None)


def per_leaf_fsdp_stats(model: LM, tcfg: TrainConfig, lay: StepLayout,
                        n_model: int = 1) -> Tuple[int, float]:
    """(collective launches, wire bytes per worker) of one per-leaf fsdp
    step: each gather call (a stacked leaf once per repeat, a tied
    embedding twice) pays its leaf slice's reduce-scatter (sharded) or
    Algorithm 2 all-reduce (replicated), under its resolved quantizer.
    Under a model axis a sharded leaf exchanges its TP block (the whole
    leaf's cotangent is gathered for a replicated one)."""
    tp_full = lay.plan.full_tp_dims()
    policy = tcfg.resolved_policy()
    L = lay.n_dp
    launches, total = 0, 0.0
    for path, leaf in zip(tree_leaves(lay.plan.paths),
                          tree_leaves(lay.aparams)):
        stacked = path.startswith("g") or path.startswith("enc/g")
        calls = leaf.shape[0] if stacked else 1
        if model.cfg.tie_embeddings and path == "embed":
            calls = 2
        n = leaf.numel() // (leaf.shape[0] if stacked else 1)
        cfg = policy.resolve(path)
        qz = cfg.to_quantizer()
        if lay.plan.gather_dims.get(path) is not None:
            if tp_full.get(path) is not None:
                n //= n_model
            count, b = GradientExchange.rs_stats(qz, n, L)
        else:
            eng = GradientExchange(qz, server_requant=cfg.server_requant)
            count, b = eng.collective_launches(n), eng.wire_bytes_per_worker(
                n, L)
        launches += calls * count
        total += calls * b
    return launches, total


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def make_train_step(model: LM, tcfg: TrainConfig,
                    lr_fn: Optional[Callable[[int], float]] = None, *,
                    group=None, data_parallel: bool = True, pods: int = 1,
                    pod_axis: bool = False,
                    engines: Optional[ExchangeEngines] = None, mesh=None):
    """Returns ``step_fn(state, batch, key) -> (state, metrics)``.

    ``data_parallel=True`` exchanges over the process group ``group``
    (None: the default group; a world of one is a one-process run), which
    must be initialized; with ``pods > 1`` its ranks form that many pods
    (rank = pod * n_intra + data), and a two-level hierarchy creates the
    pods' process groups here (every rank calls this). ``group`` must then
    be the default group. ``pod_axis=True`` names the pod axis with one pod
    (:func:`dp_world`). ``data_parallel=False`` is the single-device step:
    no collective, ``group`` must stay None. ``key`` is a ``core.prng``
    key; it is moved to the params' device, so every rounding stream is
    drawn there. ``engines`` optionally supplies a prebuilt
    :class:`ExchangeEngines` (e.g. one phase's from
    :func:`specialize_engines`; its policy replaces ``tcfg.policy``).

    ``step_fn.exchange`` is the engine of the schedule, ``step_fn.layout``
    its :class:`StepLayout`, ``step_fn.group`` its process group and
    ``step_fn.shards`` the ``FsdpLayout`` of the stored fsdp shards (None
    in replicated mode): :func:`init_state` and :class:`StateSharding` read
    them. ``step_fn.launches_and_bytes(n_workers)`` gives the step's
    collective launches and wire bytes per worker for the schedule it runs
    (0 and 0.0 on a single device; both links in two-level mode, split by
    ``step_fn.link_bytes()``). With two_level_async and ``local_steps >
    1`` the step is an :class:`AsyncTrainStep`, priced per step over its
    window.

    ``mesh`` (``launch.mesh.make_host_mesh``) replaces ``group`` and
    ``pods``: the exchange runs over its dp group, and with a model axis
    the params are this rank's TP blocks (``step_fn.tp``, a
    :class:`ModelShards`; None without one)."""
    lr_fn = lr_fn or constant_lr(0.1)
    eng = engines if engines is not None else exchange_engines(
        model, tcfg, group=group, data_parallel=data_parallel, pods=pods,
        pod_axis=pod_axis, mesh=mesh)
    if engines is not None:
        tcfg = dataclasses.replace(tcfg, policy=eng.policy)
    lay, group, data_parallel = eng.layout, eng.group, eng.data_parallel
    optimizer = _make_optimizer(tcfg)
    collect_stats = tcfg.collect_stats
    fused = (_fused_fsdp_active(tcfg, lay.plan) if tcfg.mode == "fsdp"
             else tcfg.fused_exchange)
    if collect_stats and not fused:
        warnings.warn(
            "collect_stats needs a fused exchange path (there are no "
            "per-group wire buffers to measure on the per-leaf paths) — "
            "ignoring collect_stats", stacklevel=2)
        collect_stats = False
    tp = None
    if mesh is not None and mesh.n_model > 1:
        model.check_tp(mesh.n_model)
        tp = ModelShards(mesh.model_axis, lay.plan)
    if lay.is_async:
        return _make_async_train_step(model, tcfg, lr_fn, optimizer, eng,
                                      collect_stats, tp)
    links = None                  # two-level: () -> the per-link accounting
    shards = None                 # fsdp: the layout of the stored shards
    if tcfg.mode == "fsdp":
        if tcfg.error_feedback and not fused:
            warnings.warn(
                "error_feedback needs the fused fsdp exchange (fused_exchange="
                "True on a pure-dp mesh); the per-leaf fsdp path has no "
                "residual stream — ignoring error_feedback", stacklevel=2)
        if fused:
            ex = eng.fex
            schedule = _fsdp_fused(model, tcfg, ex, collect_stats)
            shards = ex.layout
            if lay.two_level:
                links = ex.link_bytes_per_worker

            def account(n_workers):
                return ex.launches_and_bytes()
        else:
            ex = _LeafGathers(eng.policy, lay, group, tp)
            shards = FsdpLayout.from_tree(
                lay.aparams if tp is None else tp.block_shapes(lay.aparams),
                eng.policy, paths=lay.plan.paths,
                shard_dims=lay.plan.full_shard_dims(), n_shards=lay.n_dp)
            schedule = _fsdp_per_leaf(model, ex, tp)
            stats = per_leaf_fsdp_stats(model, tcfg, lay, lay.plan.n_model)

            def account(n_workers):
                return stats
    else:
        schedule, ex = _replicated(model, tcfg, eng, collect_stats, tp)
        account = ex.launches_and_bytes
        if lay.two_level:
            def links():
                return observed_link_stats(
                    ex, n_intra=lay.n_intra,
                    n_inter=lay.n_dp // lay.n_intra)[0]

            def account(n_workers):
                st = links()
                return int(st["launches"]), st["ici_bytes"] + st["dcn_bytes"]

    def step_fn(state: TrainState, batch, key: torch.Tensor):
        dev = tree_leaves(state.params)[0].device
        step_key = prng.fold_in(key.to(dev), state.step)
        loss, metrics, grads, new_ef, stats = schedule(state, batch,
                                                       step_key)
        lr = lr_fn(state.step)
        new_params, new_opt = opt_lib.step(optimizer, grads, state.opt,
                                           state.params, lr)
        out = _metrics(loss, metrics, lr, stats, dev,
                       group if data_parallel else False)
        return TrainState(params=new_params, opt=new_opt,
                          step=state.step + 1, ef=new_ef), out

    def launches_and_bytes(n_workers: int) -> Tuple[int, float]:
        return account(n_workers) if data_parallel else (0, 0.0)

    return _with_attrs(step_fn, ex, lay, group, shards, launches_and_bytes,
                       links, tp)


def _with_attrs(fn, exchange, layout, group, shards, launches_and_bytes,
                links, tp=None):
    fn.tp = tp
    fn.exchange = exchange
    fn.layout = layout
    fn.group = group
    fn.shards = shards
    fn.launches_and_bytes = launches_and_bytes
    fn.link_bytes = links
    return fn


def _metrics(loss, metrics, lr, stats, dev, group) -> Dict[str, Any]:
    """The step's metrics, averaged over the workers of ``group`` like the
    reference's pmean (``group=False``: a single device, no average, as
    the reference has no pmean without dp axes)."""
    m = torch.stack([loss.detach(), metrics["nll"].detach(),
                     torch.as_tensor(metrics["aux"], device=dev,
                                     dtype=torch.float32).detach(),
                     metrics["tokens"]])
    if group is not False:
        dist.all_reduce(m, group=group)
        m = m / world(group)[0]
        if stats is not None:
            stats = stats.clone()
            dist.all_reduce(stats, group=group)
            stats = stats / world(group)[0]
    out = {"loss": m[0], "nll": m[1], "aux": m[2], "tokens": m[3], "lr": lr}
    if stats is not None:
        out["exchange_stats"] = stats
    return out


def _grad(model: LM, state: TrainState, batch, gather=None,
          tp: Optional[ModelShards] = None):
    """(loss, metrics, grads) of the local batch (this rank's TP blocks of
    the grads under a model axis)."""
    params = tree_map(lambda t: t.detach().requires_grad_(True),
                      state.params)
    kw = {} if tp is None else {"tp": tp.model_tp}
    loss, metrics = (model.loss(params, batch, **kw) if gather is None
                     else model.loss(params, batch, gather, **kw))
    grads = tree_unflatten(state.params, torch.autograd.grad(
        loss, tree_leaves(params)))
    return loss, metrics, grads


def _replicated(model, tcfg, eng: ExchangeEngines, collect_stats, tp=None):
    """The replicated mode's schedule -> (schedule, engine). Under a model
    axis the gradient's TP blocks (and a params-shaped EF's) are gathered
    over the model group before the exchange, and each rank keeps its
    blocks of the mean (and of the new EF)."""
    lay, data_parallel = eng.layout, eng.data_parallel
    paths = lay.plan.paths
    if tcfg.fused_exchange:
        ex = eng.pex
    else:
        ex = LeafExchange.build(eng.policy, lay.aparams, eng.group,
                                paths=paths)

    def fused(grads, step_key, use_ef, ef):
        k = prng.fold_in(step_key, _FUSED_SALT)
        bufs = ex.layout.flatten_groups(grads)
        stats = None
        if lay.two_level:
            # fp intra scatter -> quantized Algorithm 2 on the shard
            # across pods -> fp intra gather; EF lives on the shard
            shards, valids = ex.intra_scatter_parts(bufs)
            new_ef = ef
            if use_ef:
                shards = tuple(s if e is None else s + e
                               for s, e in zip(shards, ef))
                local = ex.local_qdq_shard_parts(shards, k, valids)
                new_ef = tuple(None if e is None else s - q
                               for e, s, q in zip(ef, shards, local))
            if collect_stats:
                # the EF-compensated shards the inter exchange encodes
                stats = ex.group_stats(shards, new_ef if use_ef else None)
            means = ex.exchange_shard_parts(shards, k, valids)
            return (ex.layout.unflatten_groups(
                ex.intra_gather_parts(means)), new_ef, stats)
        if data_parallel:
            local = ex.local_qdq_parts(bufs, k) if use_ef else None
            new_bufs = ex.exchange_parts(bufs, k)
        else:
            new_bufs = local = ex.qdq_local_parts(bufs, k)
        new_ef = ef_bufs = None
        if use_ef:
            ef_bufs = [f - q for f, q in zip(bufs, local)]
            new_ef = ex.layout.unflatten_groups(ef_bufs, restore_dtype=False)
        if collect_stats:
            stats = ex.group_stats(bufs, ef_bufs)
        return ex.layout.unflatten_groups(new_bufs), new_ef, stats

    def per_leaf(grads, step_key, use_ef, ef):
        if not data_parallel:
            q = ex.qdq_local(paths, grads, step_key)
            new_ef = (tree_map(lambda g, x: (g - x).to(torch.float32),
                               grads, q) if use_ef else None)
            return q, new_ef, None
        new_ef = ex.residuals(paths, grads, step_key) if use_ef else None
        return ex.exchange(paths, grads, step_key), new_ef, None

    exchange = fused if tcfg.fused_exchange else per_leaf

    def schedule(state, batch, step_key):
        loss, metrics, grads = _grad(model, state, batch, tp=tp)
        ef_in = state.ef
        tree_ef = ef_in is not None and not isinstance(ef_in, tuple)
        if tp is not None:
            grads, ef_full = tp.full(grads, ef_in if tree_ef else None)
            ef_in = ef_full if tree_ef else ef_in
        new_ef, stats = ef_in, None
        use_ef = (tcfg.error_feedback and ef_in is not None
                  and not ex.is_identity)
        if use_ef and not lay.two_level:
            # compensate last step's local quantization error first
            grads = tree_map(lambda g, e: g + e.to(g.dtype), grads, ef_in)
        if data_parallel or not ex.is_identity:
            grads, ef, stats = exchange(grads, step_key, use_ef, ef_in)
            new_ef = ef if use_ef else new_ef
        if tp is not None:
            grads = tp.block(grads)
            if tree_ef:
                new_ef = tp.block(new_ef)
        return loss, metrics, grads, new_ef, stats

    return schedule, ex


def _fsdp_fused(model: LM, tcfg: TrainConfig, fex: FsdpExchange,
                collect_stats: bool):
    """The fused fsdp schedule: the tree gather's backward is the
    exchange; with EF the new residuals are the EF input's gradient."""
    tree_gather = make_fused_tree_gather(fex)
    use_ef = tcfg.error_feedback and not fex.is_identity

    def schedule(state, batch, step_key):
        k = prng.fold_in(step_key, _FUSED_SALT)
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(state.params)]
        ef_in = None
        if use_ef:
            ef_in = tuple(None if e is None
                          else e.detach().requires_grad_(True)
                          for e in state.ef)
        full = tree_gather(tree_unflatten(state.params, leaves), ef_in, k)
        loss, metrics = model.loss(full, batch)
        ef_leaves = [e for e in ef_in if e is not None] if use_ef else []
        gs = torch.autograd.grad(loss, leaves + ef_leaves)
        grads = tree_unflatten(state.params, list(gs[:len(leaves)]))
        new_ef = state.ef
        if use_ef:
            it = iter(gs[len(leaves):])
            new_ef = tuple(None if e is None else next(it) for e in ef_in)
        stats = None
        if collect_stats:
            # a post-exchange approximation from the stored shards (the
            # pre-exchange buffers live inside the gather's backward)
            stats = fex.group_stats_stored(grads,
                                           new_ef if use_ef else None)
        return loss, metrics, grads, new_ef, stats

    return schedule


class _LeafGathers:
    """The per-leaf fsdp gathers, one per leaf path under its resolved
    quantizer (fsdp gather for a sharded leaf, replicated gather else)."""

    def __init__(self, policy: QuantPolicy, lay: StepLayout, group,
                 tp: Optional[ModelShards] = None):
        self.fns = {}
        for path in tree_leaves(lay.plan.paths):
            cfg = policy.resolve(path)
            qz = cfg.to_quantizer()
            dim = lay.plan.gather_dims.get(path)
            tp_dim = lay.plan.tp_dims.get(path)
            self.fns[path] = (
                make_replicated_gather(
                    qz, group, server_requant=cfg.server_requant,
                    tp_axis=None if tp is None else tp.axis, tp_dim=tp_dim)
                if dim is None else
                make_fsdp_gather(qz, group, dim=dim, tp_dim=tp_dim))

    def hook(self, step_key: torch.Tensor):
        def gather(path, leaf, salt):
            key = prng.fold_in(step_key,
                               zlib.crc32(path.encode()) & 0x7FFFFFFF)
            return self.fns[path](leaf, prng.fold_in(key, salt))
        return gather


def _fsdp_per_leaf(model: LM, gathers: _LeafGathers, tp=None):
    """The per-leaf fsdp schedule: each leaf's gather does its own
    exchange in the backward."""
    def schedule(state, batch, step_key):
        loss, metrics, grads = _grad(model, state, batch,
                                     gathers.hook(step_key), tp)
        return loss, metrics, grads, state.ef, None
    return schedule


# ---------------------------------------------------------------------------
# the temporal hierarchy: two_level_async
# ---------------------------------------------------------------------------

class AsyncTrainStep:
    """Two-time-scale ``step_fn(state, batch, key)`` of the temporal
    ``two_level_async`` hierarchy, a dispatcher over two step functions:

      ``inner_fn``  one optimizer step on this worker's own params, the
                    gradient averaged within the pod only (full precision,
                    in rank order): no quantized collective and no
                    rounding bits;
      ``sync_fn``   the window's H-th inner update, then ONE quantized
                    exchange of the outer pseudo-gradient ``anchor -
                    params`` across pods through the fused engines of the
                    two-level step (policy groups, EF residuals and
                    ``pipeline_chunks`` compose), into the outer
                    SGD-momentum / Nesterov step of ``TrainState.outer``:
                    every worker then holds the same new anchor as params.

    The window position comes from the absolute ``state.step``, so a
    state restored mid-window resumes at its phase: sync runs on steps
    H-1, 2H-1, ... (the H-th update of every window). The attributes of
    :func:`make_train_step`'s ``step_fn`` are set; its accounting is per
    step, the outer exchange amortized over the window."""

    def __init__(self, inner_fn, sync_fn, local_steps: int):
        self.inner_fn, self.sync_fn = inner_fn, sync_fn
        self.local_steps = int(local_steps)

    def is_sync_step(self, step: int) -> bool:
        return (int(step) + 1) % self.local_steps == 0

    def __call__(self, state: TrainState, batch, key):
        if self.is_sync_step(state.step):
            return self.sync_fn(state, batch, key)
        return self.inner_fn(state, batch, key)


def intra_pmean(tree, intra_group):
    """The tree's mean over the pod, full precision: one all-gather of the
    flattened f32 leaves, summed in rank order and divided by the pod size
    (``lax.pmean`` over the intra axes as XLA adds it on the CPU; NCCL's
    all-reduce order would depend on its algorithm)."""
    leaves = tree_leaves(tree)
    flat = torch.cat([x.to(torch.float32).reshape(-1) for x in leaves])
    rows = _all_gather(flat, intra_group)
    total = rows[0]
    for j in range(1, rows.shape[0]):
        total = total + rows[j]
    mean = total / rows.shape[0]
    out, off = [], 0
    for x in leaves:
        out.append(mean[off:off + x.numel()].reshape(x.shape).to(x.dtype))
        off += x.numel()
    return tree_unflatten(tree, out)


def _make_async_train_step(model: LM, tcfg: TrainConfig, lr_fn, optimizer,
                           eng: ExchangeEngines, collect_stats: bool,
                           tp: Optional[ModelShards] = None
                           ) -> AsyncTrainStep:
    """The two halves of :class:`AsyncTrainStep`. Params and optimizer
    state are this worker's own; the outer anchor and momentum are the
    same on every worker (rewritten only at sync steps, from the
    exchange's identical output). Under a model axis (``tp``) every one
    of them is this rank's TP block: the delta is gathered over ``model``
    for the exchange (the same full delta on the model ranks of a dp
    index, so the EF buffers are too) and each rank keeps its block of
    the mean."""
    lay, pex, group = eng.layout, eng.pex, eng.group
    two_level = lay.two_level
    nesterov = tcfg.outer_optimizer == "nesterov"
    outer_lr, outer_mu = tcfg.outer_lr, tcfg.outer_momentum
    ef_sizes = pex.ef_shard_sizes(lay.n_intra)
    use_ef = tcfg.error_feedback and any(s is not None for s in ef_sizes)

    def inner_update(state: TrainState, batch):
        loss, metrics, grads = _grad(model, state, batch, tp=tp)
        if two_level:
            # the only gradient collective of an inner step, within the pod
            grads = intra_pmean(grads, eng.intra_group)
        lr = lr_fn(state.step)
        new_params, new_opt = opt_lib.step(optimizer, grads, state.opt,
                                           state.params, lr)
        return new_params, new_opt, loss, metrics, lr

    def pack(state, params, opt, ef, outer, loss, metrics, lr, stats=None):
        dev = tree_leaves(params)[0].device
        return (TrainState(params=params, opt=opt, step=state.step + 1,
                           ef=ef, outer=outer),
                _metrics(loss, metrics, lr, stats, dev, group))

    def inner_step(state: TrainState, batch, key):
        del key              # inner steps draw no rounding bits at all
        new_params, new_opt, loss, metrics, lr = inner_update(state, batch)
        return pack(state, new_params, new_opt, state.ef, state.outer,
                    loss, metrics, lr)

    def sync_step(state: TrainState, batch, key):
        new_params, new_opt, loss, metrics, lr = inner_update(state, batch)
        # the outer pseudo-gradient: the window's parameter delta, the
        # same within a pod, different across pods
        delta = tree_map(lambda a, p: (a - p).to(torch.float32),
                         state.outer.anchor, new_params)
        if tp is not None:
            delta = tp.full(delta)
        dev = tree_leaves(new_params)[0].device
        k = prng.fold_in(prng.fold_in(key.to(dev), state.step), _FUSED_SALT)
        bufs = pex.layout.flatten_groups(delta)
        new_ef, stats = state.ef, None
        if two_level:
            # the two-level wire path on the delta: fp intra scatter, EF
            # on the shard, quantized across pods, fp intra gather
            shards, valids = pex.intra_scatter_parts(bufs)
            if use_ef:
                shards = tuple(s if e is None else s + e
                               for s, e in zip(shards, state.ef))
                local = pex.local_qdq_shard_parts(shards, k, valids)
                new_ef = tuple(None if e is None else s - q
                               for e, s, q in zip(state.ef, shards, local))
            if collect_stats:
                stats = pex.group_stats(shards, new_ef if use_ef else None)
            mean_bufs = pex.intra_gather_parts(
                pex.exchange_shard_parts(shards, k, valids))
        else:
            # no intra half (pods of one worker): the outer exchange runs
            # flat over all workers, EF on the full buffers
            if use_ef:
                bufs = tuple(b if e is None else b + e
                             for b, e in zip(bufs, state.ef))
                local = pex.local_qdq_parts(bufs, k)
                new_ef = tuple(None if e is None else b - q
                               for e, b, q in zip(state.ef, bufs, local))
            if collect_stats:
                stats = pex.group_stats(bufs, new_ef if use_ef else None)
            mean_bufs = pex.exchange_parts(bufs, k)
        delta_mean = pex.layout.unflatten_groups(mean_bufs,
                                                 restore_dtype=False)
        if tp is not None:
            delta_mean = tp.block(delta_mean)
        # the outer step on the exchanged mean, identical on every worker
        # (rounded once each, as XLA contracts them)
        mom = tree_map(lambda m, d: fma_f32(m, outer_mu, d),
                       state.outer.mom, delta_mean)
        upd = (tree_map(lambda d, m: fma_f32(m, outer_mu, d), delta_mean,
                        mom) if nesterov else mom)
        anchor = tree_map(lambda a, u: fma_f32(u, -outer_lr, a).to(a.dtype),
                          state.outer.anchor, upd)
        return pack(state, anchor, new_opt, new_ef,
                    OuterState(anchor=anchor, mom=mom), loss, metrics, lr,
                    stats)

    n_intra = lay.n_intra

    def links():
        return observed_link_stats(pex, n_intra=n_intra,
                                   n_inter=lay.n_dp // n_intra,
                                   sync_every=lay.local_steps)[0]

    def launches_and_bytes(n_workers: int) -> Tuple[int, float]:
        st = links()
        return int(st["launches"]), st["ici_bytes"] + st["dcn_bytes"]

    return _with_attrs(AsyncTrainStep(inner_step, sync_step,
                                      lay.local_steps),
                       pex, lay, group, None, launches_and_bytes, links, tp)


# ---------------------------------------------------------------------------
# the adaptive bit schedule
# ---------------------------------------------------------------------------

class ScheduledTrainStep:
    """Host-side driver of the adaptive bit budget: a drop-in
    ``step_fn(state, batch, key)`` whose per-group wire bit-width follows
    a :class:`~repro_torch.core.policy.BitBudgetController`.

      * ONE engine skeleton is built up front with ``group_by_rule=True``
        (at the schedule's ceiling assignment): leaves partition by policy
        RULE, so the groups (and every EF residual shape) are the same for
        every assignment the schedule can produce;
      * each phase's assignment becomes a static ``QuantPolicy``
        (``schedule.policy_at``), the skeleton is specialized
        (:func:`specialize_engines`: new quantizers, the same layouts and
        process groups) into a :func:`make_train_step` function, held in
        an LRU of ``max_engines`` keyed by the bits tuple;
      * within a phase the step is bit-identical to a static run at that
        policy; a schedule that never changes bits builds one engine and
        reproduces the static run;
      * with ``tcfg.collect_stats`` the step's ``exchange_stats`` are
        folded per schedule entry (:meth:`entry_stats`) into
        ``controller.observe``, so the next phase's water-filling solve
        follows them.

    The step counter is read from ``state.step``. ``make_train_step``'s
    keyword arguments (``group``, ``data_parallel``, ``pods``,
    ``pod_axis``) place the skeleton; :func:`init_state` and
    :class:`StateSharding` take this object as their ``step``."""

    def __init__(self, model: LM, tcfg: TrainConfig, controller,
                 lr_fn=None, *, max_engines: int = 4, **world_kw):
        if tcfg.policy is not None:
            raise ValueError(
                "ScheduledTrainStep derives the per-phase policy from the "
                "controller's BitSchedule — leave TrainConfig.policy unset")
        self.mesh = world_kw.get("mesh")
        self.model, self.lr_fn = model, lr_fn
        self.controller = controller
        self.schedule = controller.schedule
        base_policy = self.schedule.policy_at(
            self.schedule.ceil_assignment())
        self.tcfg = dataclasses.replace(tcfg, policy=base_policy,
                                        group_by_rule=True)
        self.skeleton = exchange_engines(model, self.tcfg, **world_kw)
        ex = (self.skeleton.fex if self.skeleton.fex is not None
              else self.skeleton.pex)
        groups = ex.layout.groups
        self._group_rules = tuple(g.rule_id for g in groups)
        self._group_sizes = tuple(g.size for g in groups)
        if self.controller.group_sizes is None:
            sizes = [0] * self.schedule.n_entries
            for rid, size in zip(self._group_rules, self._group_sizes):
                sizes[rid] += size
            self.controller.group_sizes = tuple(sizes)
        self.max_engines = max(1, int(max_engines))
        self._cache: "OrderedDict[Tuple[Optional[int], ...], Any]" = \
            OrderedDict()
        self.last_assignment: Optional[Tuple[Optional[int], ...]] = None
        # what init_state / StateSharding read: the skeleton's layout,
        # the same in every phase
        first = self._build(self.schedule.ceil_assignment())
        self.exchange, self.layout = first.exchange, first.layout
        self.group, self.shards = first.group, first.shards
        self.tp = first.tp

    @property
    def init_config(self) -> TrainConfig:
        """The TrainConfig to ``init_state`` with: by-rule grouping and a
        static schedule policy, so the EF buffers have the (bits-
        invariant) shapes every phase's step expects."""
        return self.tcfg

    @property
    def decisions(self):
        return self.controller.decisions

    def step_fn(self, assignment) -> Any:
        """The step function of one bits assignment (LRU'd)."""
        key = tuple(assignment)
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        fn = self._cache[key] = self._build(key)
        while len(self._cache) > self.max_engines:
            self._cache.popitem(last=False)
        return fn

    def _build(self, assignment):
        policy = self.schedule.policy_at(assignment)
        return make_train_step(
            self.model, dataclasses.replace(self.tcfg, policy=policy),
            self.lr_fn, engines=specialize_engines(self.skeleton, policy),
            mesh=self.mesh)

    def current(self):
        """The step function of the last assignment run (the ceiling's
        before the first step)."""
        return self.step_fn(self.last_assignment
                            or self.schedule.ceil_assignment())

    def launches_and_bytes(self, n_workers: int) -> Tuple[int, float]:
        return self.current().launches_and_bytes(n_workers)

    @property
    def link_bytes(self):
        return self.current().link_bytes

    def entry_stats(self, group_stats) -> Tuple[Dict[str, float], ...]:
        """Fold the (n_groups, 3) ``exchange_stats`` metric into one row
        per schedule entry: size-weighted means of sigma_sq and clip_frac,
        the sum of ef_norm_sq (fsdp splits one rule into a sharded and a
        replicated group)."""
        g = torch.as_tensor(group_stats).detach().cpu().to(torch.float64)
        n = self.schedule.n_entries
        acc = torch.zeros((n, 3), dtype=torch.float64)
        w = torch.zeros(n, dtype=torch.float64)
        for rid, size, row in zip(self._group_rules, self._group_sizes, g):
            acc[rid, 0] += row[0] * size
            acc[rid, 1] += row[1] * size
            acc[rid, 2] += row[2]
            w[rid] += size
        nz = w > 0
        acc[nz, 0] /= w[nz]
        acc[nz, 1] /= w[nz]
        return tuple({"sigma_sq": float(r[0]), "clip_frac": float(r[1]),
                      "ef_norm_sq": float(r[2])} for r in acc)

    def __call__(self, state: TrainState, batch, key):
        assignment = self.controller.assignment_at(int(state.step))
        self.last_assignment = assignment
        state, metrics = self.step_fn(assignment)(state, batch, key)
        if "exchange_stats" in metrics:
            self.controller.observe(
                self.entry_stats(metrics["exchange_stats"]))
        return state, metrics
