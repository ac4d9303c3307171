"""Data-parallel train step with the paper's quantized gradient exchange
(the reference's ``train/step.py``): replicated (Algorithm 2) and fsdp
(ZeRO-3) modes, flat or two-level.

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
explicit two_level warns). ``two_level_async``, the bit schedule and
model parallelism are not ported (ROADMAP.md).

Every worker then applies its mean gradient with the configured optimizer
(SGD + momentum 0.9 by default) to the parameters it stores.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
import zlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core import prng
from repro_torch.core.api import QuantConfig
from repro_torch.core.comm import hierarchical
from repro_torch.core.comm.collectives import world
from repro_torch.core.comm.exchange import (GradientExchange, LeafExchange,
                                            PartitionedExchange,
                                            observed_link_stats)
from repro_torch.core.comm.fsdp_exchange import (FsdpExchange, FsdpLayout,
                                                 make_fused_tree_gather)
from repro_torch.core.comm.gather import (make_fsdp_gather,
                                          make_replicated_gather)
from repro_torch.core.policy import QuantPolicy
from repro_torch.models.model import LM
from repro_torch.optim import optimizers as opt_lib
from repro_torch.optim.schedule import constant_lr
from repro_torch.train.state import TrainState
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten
from repro_torch.utils.sharding import (choose_fsdp_dim, dp_axis_names,
                                        spec_dp_dim)

# key-fold salt separating the fused whole-tree exchange stream from the
# per-leaf (crc32-of-path) streams
_FUSED_SALT = zlib.crc32(b"fused_exchange") & 0x7FFFFFFF

_NOT_PORTED = "is not ported to repro_torch yet (see ROADMAP.md)"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    policy: Optional[Any] = None    # QuantPolicy or anything coercible
    mode: str = "replicated"        # replicated | fsdp (the reference's
                                    # TrainConfig defaults to fsdp, its
                                    # launcher to replicated)
    hierarchy: str = "auto"         # flat | two_level | auto (two_level
                                    # when the dp world has a pod axis)
    optimizer: str = "sgd"          # sgd | adamw (paper: SGD+momentum 0.9)
    momentum: float = 0.9
    weight_decay: float = 0.0
    error_feedback: bool = False    # beyond-paper: EF residual accumulation
    fused_exchange: bool = True     # one flat-buffer collective per policy
                                    # group (False: one per leaf)
    exchange_chunk_elems: Optional[int] = None  # size cap per collective
    pipeline_chunks: int = 1        # K bucket-row chunks per fused
                                    # exchange, bit-identical to K = 1

    def __post_init__(self):
        if self.mode not in ("replicated", "fsdp"):
            raise ValueError(f"mode must be 'replicated' or 'fsdp', got "
                             f"{self.mode!r}")
        if self.hierarchy == "two_level_async":
            raise NotImplementedError(
                f"hierarchy='two_level_async' {_NOT_PORTED}")
        if self.hierarchy not in hierarchical.HIERARCHIES:
            raise ValueError(f"hierarchy must be one of "
                             f"{hierarchical.HIERARCHIES}, got "
                             f"{self.hierarchy!r}")
        if self.pipeline_chunks < 1:
            raise ValueError(
                f"pipeline_chunks must be >= 1, got {self.pipeline_chunks}")

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

    def full_shard_dims(self) -> Dict[str, Optional[int]]:
        """path -> dp-shard dim in FULL leaf coordinates (the stacked
        leading dim included; ``gather_dims`` is in per-repeat slice
        coordinates). The fused fsdp exchange lays its buffers out by
        these."""
        return {p: spec_dp_dim(s, self.dp_axes)
                for p, s in self.specs.items()}


def plan_sharding_shapes(model: LM, aparams, *, dp_axes: Tuple[str, ...],
                         axis_sizes: Dict[str, int]) -> ShardingPlan:
    """The fsdp dim of every leaf from the parameter shapes and the dp axis
    sizes: a d_model-sized dim of the per-repeat slice first, else the
    largest divisible one, else None (replicated). Tensor parallelism is
    not ported, so there are no TP dims."""
    n_dp = math.prod(axis_sizes[a] for a in dp_axes) if dp_axes else 1
    n_model = axis_sizes.get("model", 1)
    if n_model > 1:
        raise NotImplementedError(f"model parallelism {_NOT_PORTED}")
    paths = model.param_paths(aparams)
    gather_dims: Dict[str, Optional[int]] = {}
    tp_dims: Dict[str, Optional[int]] = {}

    def leaf_spec(path: str, leaf):
        shape = tuple(leaf.shape)
        off = 1 if (path.startswith("g") or path.startswith("enc/g")) else 0
        fdim = (choose_fsdp_dim(shape[off:], n_dp,
                                prefer_sizes=(model.cfg.d_model,))
                if dp_axes else None)
        gather_dims[path] = fdim
        tp_dims[path] = None
        ent = [None] * len(shape)
        if fdim is not None:
            ent[off + fdim] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
        return tuple(ent)

    specs = {p: leaf_spec(p, x)
             for p, x in zip(tree_leaves(paths), tree_leaves(aparams))}
    return ShardingPlan(specs=specs, paths=paths, gather_dims=gather_dims,
                        tp_dims=tp_dims, dp_axes=tuple(dp_axes), n_dp=n_dp,
                        n_model=n_model)


def dp_world(n_workers: int, pods: int = 1
             ) -> Tuple[Tuple[str, ...], Dict[str, int]]:
    """(dp axes, axis sizes) of ``n_workers`` workers in ``pods`` pods:
    ``("data",)``, or ``("pod", "data")`` when ``pods > 1`` (rank = pod *
    n_data + data)."""
    if pods < 1 or n_workers % pods:
        raise ValueError(f"{n_workers} workers do not split into {pods} "
                         f"pods")
    if pods == 1:
        return ("data",), {"data": n_workers}
    return dp_axis_names(("pod", "data")), {"pod": pods,
                                            "data": n_workers // pods}


def _fused_fsdp_active(tcfg: TrainConfig, plan: ShardingPlan) -> bool:
    """Whether the fused whole-tree fsdp exchange runs (pure-dp worlds)."""
    return (tcfg.mode == "fsdp" and tcfg.fused_exchange
            and bool(plan.dp_axes) and plan.n_model == 1)


def _exchange_axes(tcfg: TrainConfig, dp_axes: Tuple[str, ...],
                   axis_sizes: Dict[str, int],
                   plan: Optional[ShardingPlan] = None
                   ) -> Tuple[Tuple[str, ...], Tuple[str, ...], int]:
    """``tcfg.hierarchy`` against the dp world and the exchange path:
    ``(intra_axes, inter_axes, n_intra)``; flat (and every degenerate case)
    is ``((), dp_axes, 1)``. Two-level needs a fused engine: an explicit
    "two_level" on a per-leaf path warns and runs flat, "auto" falls back
    silently."""
    flat = (), tuple(dp_axes), 1
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
        why = "the per-leaf fsdp gather path (fused_exchange=False)"
    if not fused_ok:
        if tcfg.hierarchy == "two_level":
            warnings.warn(
                f"hierarchy='two_level' needs the fused exchange but {why} "
                f"is selected: falling back to the flat combined-axis "
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

    @property
    def n_dp(self) -> int:
        return self.plan.n_dp

    @property
    def two_level(self) -> bool:
        return bool(self.intra_axes)


def step_layout(model: LM, tcfg: TrainConfig, n_workers: Optional[int], *,
                pods: int = 1) -> StepLayout:
    """The layout of a dp world of ``n_workers`` (None: the single-device
    step, no dp axes)."""
    aparams = model.abstract_params()
    if n_workers is None:
        if tcfg.mode == "fsdp":
            raise ValueError("fsdp shards the parameters over data-parallel "
                             "workers: it needs data_parallel=True")
        dp_axes, sizes = (), {}
    else:
        dp_axes, sizes = dp_world(n_workers, pods)
    plan = plan_sharding_shapes(model, aparams, dp_axes=dp_axes,
                                axis_sizes=sizes)
    intra, _, n_intra = _exchange_axes(tcfg, dp_axes, sizes, plan)
    return StepLayout(aparams, plan, dp_axes, intra, n_intra)


def _build_fsdp_exchange(tcfg: TrainConfig, lay: StepLayout, group=None,
                         intra_group=None, inter_group=None) -> FsdpExchange:
    return FsdpExchange.build(
        tcfg.resolved_policy(), lay.aparams, lay.dp_axes,
        paths=lay.plan.paths, shard_dims=lay.plan.full_shard_dims(),
        n_shards=lay.n_dp, group=group,
        max_chunk_elems=tcfg.exchange_chunk_elems,
        intra_axes=lay.intra_axes, n_intra=lay.n_intra,
        pipeline_chunks=tcfg.pipeline_chunks, intra_group=intra_group,
        inter_group=inter_group)


def _ef_group_sizes(tcfg: TrainConfig, step
                    ) -> Optional[Tuple[Optional[int], ...]]:
    """Per-worker residual-buffer sizes of the TUPLE form of error
    feedback (fused fsdp, and the two-level replicated exchange), read from
    ``step``'s engine; None for identity groups. None overall when EF is
    off, a fully-fp policy leaves nothing to feed back, or EF is the
    params-shaped tree (flat replicated mode, ``step`` None)."""
    if not tcfg.error_feedback or step is None:
        return None
    eng = step.exchange
    if isinstance(eng, FsdpExchange):
        sizes = eng.ef_group_sizes()
    elif step.layout.two_level:
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

    ``step`` (from :func:`make_train_step`) lays the state out: in fsdp
    mode every rank draws the full params and keeps its own slices (and
    slices its optimizer state alike); EF is then a tuple of per-group
    buffers with None for identity groups, as in the two-level replicated
    mode. Those two need ``step``; without it the state is the flat
    replicated (or single-device) one."""
    if tcfg.mode == "fsdp" and step is None:
        raise ValueError("an fsdp state holds its step's shards: pass "
                         "step=make_train_step(...)")
    params = model.init(torch.Generator().manual_seed(seed), device=device)
    if step is not None and step.shards is not None:
        params = tree_unflatten(params, step.shards.shard_leaves(
            tree_leaves(params), world(step.group)[1]))
    ef_sizes = _ef_group_sizes(tcfg, step)
    dev = tree_leaves(params)[0].device
    if ef_sizes is not None:
        ef = tuple(None if n is None
                   else torch.zeros(n, dtype=torch.float32, device=dev)
                   for n in ef_sizes)
    elif (tcfg.error_feedback and tcfg.mode == "replicated"
          and not (step is not None and step.layout.two_level)):
        ef = tree_map(torch.zeros_like, params)
    else:
        ef = None
    return TrainState(params=params, opt=_make_optimizer(tcfg).init(params),
                      step=0, ef=ef)


# ---------------------------------------------------------------------------
# full (rank-ordered) state <-> this worker's state
# ---------------------------------------------------------------------------

class StateSharding:
    """Moves a ``TrainState`` between this worker's form and the global
    form the reference's arrays have: fsdp params and optimizer state
    gathered in rank order, tuple EF buffers stacked over the ranks
    (replicated params are the same in both). Used for digests and
    checkpoints.

    A params-shaped EF tree (flat replicated mode) holds each worker's own
    residuals. With one worker it is the reference's array; with L > 1
    each leaf is stacked over the ranks on a new leading axis, so a resume
    restores every worker's residuals (the reference's replicated array
    keeps only one worker's copy in a checkpoint)."""

    def __init__(self, step):
        """``step`` from :func:`make_train_step` (its group and shards)."""
        self.group = step.group
        self.n, self.rank = world(step.group)
        self.layout = step.shards          # None: replicated params
        self.fsdp = self.layout is not None

    def full_params(self, params):
        if not self.fsdp:
            return params
        return tree_unflatten(params, self.layout.unshard_leaves(
            tree_leaves(params), self.group))

    def _shard_params(self, params):
        if not self.fsdp:
            return params
        return tree_unflatten(params, self.layout.shard_leaves(
            tree_leaves(params), self.rank))

    def gather(self, state: TrainState) -> TrainState:
        ef = state.ef
        if isinstance(ef, tuple):
            ef = tuple(None if e is None else self._stack(e) for e in ef)
        elif ef is not None and self.n > 1:
            ef = tree_map(lambda e: self._stack(e).reshape(
                (self.n,) + tuple(e.shape)), ef)
        return TrainState(params=self.full_params(state.params),
                          opt=_map_opt(self.full_params, state.opt),
                          step=state.step, ef=ef)

    def scatter(self, full: TrainState) -> TrainState:
        ef = full.ef
        if isinstance(ef, tuple):
            ef = tuple(None if e is None
                       else e.reshape(self.n, -1)[self.rank].clone()
                       for e in ef)
        elif ef is not None and self.n > 1:
            ef = tree_map(lambda e: e[self.rank].clone(), ef)
        return TrainState(params=self._shard_params(full.params),
                          opt=_map_opt(self._shard_params, full.opt),
                          step=full.step, ef=ef)

    def _stack(self, e: torch.Tensor) -> torch.Tensor:
        out = [torch.empty_like(e) for _ in range(self.n)]
        dist.all_gather(out, e.contiguous(), group=self.group)
        return torch.cat([t.reshape(-1) for t in out])


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def exchange_engine(model: LM, tcfg: TrainConfig, group=None
                    ) -> Union[PartitionedExchange, LeafExchange]:
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
        pipeline_chunks=tcfg.pipeline_chunks)


def per_leaf_fsdp_stats(model: LM, tcfg: TrainConfig, lay: StepLayout
                        ) -> Tuple[int, float]:
    """(collective launches, wire bytes per worker) of one per-leaf fsdp
    step: each gather call (a stacked leaf once per repeat, a tied
    embedding twice) pays its leaf slice's reduce-scatter (sharded) or
    Algorithm 2 all-reduce (replicated), under its resolved quantizer."""
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
            count, b = GradientExchange.rs_stats(qz, n, L)
        else:
            eng = GradientExchange(qz, server_requant=cfg.server_requant)
            count, b = eng.collective_launches(n), eng.wire_bytes_per_worker(
                n, L)
        launches += calls * count
        total += calls * b
    return launches, total


def make_train_step(model: LM, tcfg: TrainConfig,
                    lr_fn: Optional[Callable[[int], float]] = None, *,
                    group=None, data_parallel: bool = True, pods: int = 1):
    """Returns ``step_fn(state, batch, key) -> (state, metrics)``.

    ``data_parallel=True`` exchanges over the process group ``group``
    (None: the default group; a world of one is a one-process run), which
    must be initialized; with ``pods > 1`` its ranks form that many pods
    (rank = pod * n_intra + data), and a two-level hierarchy creates the
    pods' process groups here (every rank calls this). ``group`` must then
    be the default group. ``data_parallel=False`` is the single-device
    step: no collective, ``group`` must stay None. ``key`` is a
    ``core.prng`` key; it is moved to the params' device, so every
    rounding stream is drawn there.

    ``step_fn.exchange`` is the engine of the schedule, ``step_fn.layout``
    its :class:`StepLayout`, ``step_fn.group`` its process group and
    ``step_fn.shards`` the ``FsdpLayout`` of the stored fsdp shards (None
    in replicated mode): :func:`init_state` and :class:`StateSharding` read
    them. ``step_fn.launches_and_bytes(n_workers)`` gives the step's collective
    launches and wire bytes per worker for the schedule it runs (0 and 0.0
    on a single device; both links in two-level mode, split by
    ``step_fn.link_bytes()``)."""
    if not data_parallel and group is not None:
        raise ValueError("a single-device step takes no process group")
    lr_fn = lr_fn or constant_lr(0.1)
    optimizer = _make_optimizer(tcfg)
    lay = step_layout(model, tcfg, world(group)[0] if data_parallel
                      else None, pods=pods)
    intra_group = inter_group = None
    if lay.two_level:
        if group is not None:
            raise ValueError("the two-level hierarchy splits the default "
                             "process group into pods: pass group=None")
        intra_group, inter_group = hierarchical.pod_groups(
            lay.n_dp // lay.n_intra, lay.n_intra)
    links = None                  # two-level: () -> the per-link accounting
    shards = None                 # fsdp: the layout of the stored shards
    if tcfg.mode == "fsdp":
        fused = _fused_fsdp_active(tcfg, lay.plan)
        if tcfg.error_feedback and not fused:
            warnings.warn(
                "error_feedback needs the fused fsdp exchange "
                "(fused_exchange=True); the per-leaf fsdp path has no "
                "residual stream: ignoring error_feedback", stacklevel=2)
        if fused:
            eng = _build_fsdp_exchange(tcfg, lay, group, intra_group,
                                       inter_group)
            schedule = _fsdp_fused(model, tcfg, eng)
            shards = eng.layout
            if lay.two_level:
                links = eng.link_bytes_per_worker

            def account(n_workers):
                return eng.launches_and_bytes()
        else:
            eng = _LeafGathers(tcfg, lay, group)
            shards = FsdpLayout.from_tree(
                lay.aparams, tcfg.resolved_policy(), paths=lay.plan.paths,
                shard_dims=lay.plan.full_shard_dims(), n_shards=lay.n_dp)
            schedule = _fsdp_per_leaf(model, eng)
            stats = per_leaf_fsdp_stats(model, tcfg, lay)

            def account(n_workers):
                return stats
    else:
        schedule, eng = _replicated(model, tcfg, lay, group, intra_group,
                                    inter_group, data_parallel)
        account = eng.launches_and_bytes
        if lay.two_level:
            def links():
                return observed_link_stats(
                    eng, n_intra=lay.n_intra,
                    n_inter=lay.n_dp // lay.n_intra)[0]

            def account(n_workers):
                st = links()
                return int(st["launches"]), st["ici_bytes"] + st["dcn_bytes"]

    def step_fn(state: TrainState, batch, key: torch.Tensor):
        dev = tree_leaves(state.params)[0].device
        step_key = prng.fold_in(key.to(dev), state.step)
        loss, metrics, grads, new_ef = schedule(state, batch, step_key)
        lr = lr_fn(state.step)
        updates, new_opt = optimizer.update(grads, state.opt, state.params,
                                            lr)
        new_params = opt_lib.apply_updates(state.params, updates)
        m = torch.stack([loss.detach(), metrics["nll"].detach(),
                         torch.as_tensor(metrics["aux"], device=dev,
                                         dtype=torch.float32),
                         metrics["tokens"]])
        if data_parallel:
            # averaged over the workers, like the reference's pmean (the
            # reference has no pmean without dp axes)
            dist.all_reduce(m, group=group)
            m = m / world(group)[0]
        out = {"loss": m[0], "nll": m[1], "aux": m[2], "tokens": m[3],
               "lr": lr}
        return TrainState(params=new_params, opt=new_opt,
                          step=state.step + 1, ef=new_ef), out

    def launches_and_bytes(n_workers: int) -> Tuple[int, float]:
        return account(n_workers) if data_parallel else (0, 0.0)

    step_fn.exchange = eng
    step_fn.layout = lay
    step_fn.group = group
    step_fn.shards = shards
    step_fn.launches_and_bytes = launches_and_bytes
    step_fn.link_bytes = links
    return step_fn


def _grad(model: LM, state: TrainState, batch, gather=None):
    """(loss, metrics, grads) of the local batch."""
    params = tree_map(lambda t: t.detach().requires_grad_(True),
                      state.params)
    loss, metrics = (model.loss(params, batch) if gather is None
                     else model.loss(params, batch, gather))
    grads = tree_unflatten(state.params, torch.autograd.grad(
        loss, tree_leaves(params)))
    return loss, metrics, grads


def _replicated(model, tcfg, lay, group, intra_group, inter_group,
                data_parallel):
    """The replicated mode's schedule -> (schedule, engine)."""
    params = lay.aparams
    paths = lay.plan.paths
    if not tcfg.fused_exchange:
        eng = LeafExchange.build(tcfg.resolved_policy(), params, group,
                                 paths=paths)
    else:
        eng = PartitionedExchange.build(
            tcfg.resolved_policy(), params,
            inter_group if lay.two_level else group, paths=paths,
            max_chunk_elems=tcfg.exchange_chunk_elems,
            pipeline_chunks=tcfg.pipeline_chunks, intra_group=intra_group)

    def fused(grads, step_key, use_ef, ef):
        k = prng.fold_in(step_key, _FUSED_SALT)
        bufs = eng.layout.flatten_groups(grads)
        if lay.two_level:
            # fp intra scatter -> quantized Algorithm 2 on the shard
            # across pods -> fp intra gather; EF lives on the shard
            shards, valids = eng.intra_scatter_parts(bufs)
            new_ef = ef
            if use_ef:
                shards = tuple(s if e is None else s + e
                               for s, e in zip(shards, ef))
                local = eng.local_qdq_shard_parts(shards, k, valids)
                new_ef = tuple(None if e is None else s - q
                               for e, s, q in zip(ef, shards, local))
            means = eng.exchange_shard_parts(shards, k, valids)
            return (eng.layout.unflatten_groups(
                eng.intra_gather_parts(means)), new_ef)
        if data_parallel:
            local = eng.local_qdq_parts(bufs, k) if use_ef else None
            new_bufs = eng.exchange_parts(bufs, k)
        else:
            new_bufs = local = eng.qdq_local_parts(bufs, k)
        new_ef = None
        if use_ef:
            new_ef = eng.layout.unflatten_groups(
                [f - q for f, q in zip(bufs, local)], restore_dtype=False)
        return eng.layout.unflatten_groups(new_bufs), new_ef

    def per_leaf(grads, step_key, use_ef, ef):
        if not data_parallel:
            q = eng.qdq_local(paths, grads, step_key)
            new_ef = (tree_map(lambda g, x: (g - x).to(torch.float32),
                               grads, q) if use_ef else None)
            return q, new_ef
        new_ef = eng.residuals(paths, grads, step_key) if use_ef else None
        return eng.exchange(paths, grads, step_key), new_ef

    exchange = fused if tcfg.fused_exchange else per_leaf

    def schedule(state, batch, step_key):
        loss, metrics, grads = _grad(model, state, batch)
        new_ef = state.ef
        use_ef = (tcfg.error_feedback and state.ef is not None
                  and not eng.is_identity)
        if use_ef and not lay.two_level:
            # compensate last step's local quantization error first
            grads = tree_map(lambda g, e: g + e.to(g.dtype), grads, state.ef)
        if data_parallel or not eng.is_identity:
            grads, ef = exchange(grads, step_key, use_ef, state.ef)
            new_ef = ef if use_ef else new_ef
        return loss, metrics, grads, new_ef

    return schedule, eng


def _fsdp_fused(model: LM, tcfg: TrainConfig, fex: FsdpExchange):
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
        return loss, metrics, grads, new_ef

    return schedule


class _LeafGathers:
    """The per-leaf fsdp gathers, one per leaf path under its resolved
    quantizer (fsdp gather for a sharded leaf, replicated gather else)."""

    def __init__(self, tcfg: TrainConfig, lay: StepLayout, group):
        policy = tcfg.resolved_policy()
        self.fns = {}
        for path in tree_leaves(lay.plan.paths):
            cfg = policy.resolve(path)
            qz = cfg.to_quantizer()
            dim = lay.plan.gather_dims.get(path)
            self.fns[path] = (
                make_replicated_gather(qz, group,
                                       server_requant=cfg.server_requant)
                if dim is None else
                make_fsdp_gather(qz, group, dim=dim,
                                 tp_dim=lay.plan.tp_dims.get(path)))

    def hook(self, step_key: torch.Tensor):
        def gather(path, leaf, salt):
            key = prng.fold_in(step_key,
                               zlib.crc32(path.encode()) & 0x7FFFFFFF)
            return self.fns[path](leaf, prng.fold_in(key, salt))
        return gather


def _fsdp_per_leaf(model: LM, gathers: _LeafGathers):
    """The per-leaf fsdp schedule: each leaf's gather does its own
    exchange in the backward."""
    def schedule(state, batch, step_key):
        loss, metrics, grads = _grad(model, state, batch,
                                     gathers.hook(step_key))
        return loss, metrics, grads, state.ef
    return schedule
