"""Replicated data-parallel train step with the paper's quantized gradient
exchange: Algorithm 2 (the reference's ``train/step.py``, replicated mode
with the flat hierarchy).

Each worker (a ``torch.distributed`` rank) computes the loss and its
gradient on its shard of the batch (autograd through the plain PyTorch
forward, the counterpart of ``jax.value_and_grad``) and exchanges it by
one of three schedules:

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

Every worker then applies the identical mean gradient with the
configured optimizer (SGD + momentum 0.9 by default), so the replicated
parameters stay in sync.

With ``error_feedback`` each worker adds last step's residual to its
gradient before quantizing and keeps e <- g - Q^-1(Q(g)) from the same
layout and key as its contribution (the fused ``qdq``, each leaf's
``local_qdq_comm_layout``, or the local ``qdq``).

Not ported yet (ROADMAP.md): fsdp mode, the two-level / async
hierarchies and the bit schedule. Their ``TrainConfig`` fields do not
exist here, so setting one is an error.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core import prng
from repro_torch.core.api import QuantConfig
from repro_torch.core.comm.collectives import world
from repro_torch.core.comm.exchange import LeafExchange, PartitionedExchange
from repro_torch.core.policy import QuantPolicy
from repro_torch.models.model import LM
from repro_torch.optim import optimizers as opt_lib
from repro_torch.optim.schedule import constant_lr
from repro_torch.train.state import TrainState
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten

# key-fold salt separating the fused whole-tree exchange stream from the
# per-leaf (crc32-of-path) streams
_FUSED_SALT = zlib.crc32(b"fused_exchange") & 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    policy: Optional[Any] = None    # QuantPolicy or anything coercible
    mode: str = "replicated"        # the only mode ported
    hierarchy: str = "flat"         # flat | auto (one dp axis: flat)
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
        if self.mode != "replicated":
            raise NotImplementedError(
                f"mode={self.mode!r}: only the replicated mode is ported to "
                f"repro_torch (fsdp: see ROADMAP.md)")
        if self.hierarchy not in ("flat", "auto"):
            raise NotImplementedError(
                f"hierarchy={self.hierarchy!r} is not ported to repro_torch "
                f"(see ROADMAP.md); one data-parallel group is flat")
        if self.pipeline_chunks < 1:
            raise ValueError(
                f"pipeline_chunks must be >= 1, got {self.pipeline_chunks}")

    def resolved_policy(self) -> QuantPolicy:
        """The effective QuantPolicy (``policy``, else uniform fp)."""
        if self.policy is None:
            return QuantPolicy.uniform(QuantConfig(name="fp"))
        return QuantPolicy.coerce(self.policy)


def _make_optimizer(tcfg: TrainConfig) -> opt_lib.Optimizer:
    if tcfg.optimizer == "sgd":
        return opt_lib.sgd_momentum(momentum=tcfg.momentum,
                                    weight_decay=tcfg.weight_decay)
    if tcfg.optimizer == "adamw":
        return opt_lib.adamw(weight_decay=tcfg.weight_decay)
    raise ValueError(tcfg.optimizer)


def init_state(model: LM, tcfg: TrainConfig, *, seed: int = 0,
               device=None) -> TrainState:
    """Params from ``torch.Generator(seed)`` on ``device`` (the card unless
    ``device="cpu"``), zero optimizer state, zero EF residuals when
    ``error_feedback`` is on."""
    params = model.init(torch.Generator().manual_seed(seed), device=device)
    ef = (tree_map(torch.zeros_like, params) if tcfg.error_feedback
          else None)
    return TrainState(params=params, opt=_make_optimizer(tcfg).init(params),
                      step=0, ef=ef)


def exchange_engine(model: LM, tcfg: TrainConfig, group=None
                    ) -> Union[PartitionedExchange, LeafExchange]:
    """The exchange the step runs (fused, or per leaf when
    ``fused_exchange`` is off), laid out from the model's parameter
    shapes."""
    params = model.abstract_params()
    paths = model.param_paths(params)
    if not tcfg.fused_exchange:
        return LeafExchange.build(tcfg.resolved_policy(), params, group,
                                  paths=paths)
    return PartitionedExchange.build(
        tcfg.resolved_policy(), params, group, paths=paths,
        max_chunk_elems=tcfg.exchange_chunk_elems,
        pipeline_chunks=tcfg.pipeline_chunks)


def make_train_step(model: LM, tcfg: TrainConfig,
                    lr_fn: Optional[Callable[[int], float]] = None, *,
                    group=None, data_parallel: bool = True):
    """Returns ``step_fn(state, batch, key) -> (state, metrics)``.

    ``data_parallel=True`` exchanges over the process group ``group``
    (None: the default group; a world of one is a one-process run), which
    must be initialized. ``data_parallel=False`` is the single-device
    step: no collective, ``group`` must stay None. ``key`` is a
    ``core.prng`` key; it is moved to the params' device, so every
    rounding stream is drawn there.

    ``step_fn.exchange`` is the engine of the schedule
    (:func:`exchange_engine`); ``step_fn.launches_and_bytes(n_workers)``
    gives the step's collective launches and wire bytes per
    worker for the schedule it runs (0 and 0.0 on a single device)."""
    if not data_parallel and group is not None:
        raise ValueError("a single-device step takes no process group")
    lr_fn = lr_fn or constant_lr(0.1)
    eng = exchange_engine(model, tcfg, group)
    optimizer = _make_optimizer(tcfg)
    paths = model.param_paths(model.abstract_params())

    def fused(grads, step_key, use_ef):
        k = prng.fold_in(step_key, _FUSED_SALT)
        bufs = eng.layout.flatten_groups(grads)
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

    def per_leaf(grads, step_key, use_ef):
        if not data_parallel:
            q = eng.qdq_local(paths, grads, step_key)
            new_ef = (tree_map(lambda g, x: (g - x).to(torch.float32),
                               grads, q) if use_ef else None)
            return q, new_ef
        new_ef = eng.residuals(paths, grads, step_key) if use_ef else None
        return eng.exchange(paths, grads, step_key), new_ef

    schedule = fused if tcfg.fused_exchange else per_leaf

    def step_fn(state: TrainState, batch, key: torch.Tensor):
        L = world(group)[0] if data_parallel else 1
        dev = tree_leaves(state.params)[0].device
        step_key = prng.fold_in(key.to(dev), state.step)

        params = tree_map(lambda t: t.detach().requires_grad_(True),
                          state.params)
        loss, metrics = model.loss(params, batch)
        grads = tree_unflatten(state.params, torch.autograd.grad(
            loss, tree_leaves(params)))

        new_ef = state.ef
        use_ef = (tcfg.error_feedback and state.ef is not None
                  and not eng.is_identity)
        if use_ef:
            # compensate last step's local quantization error first
            grads = tree_map(lambda g, e: g + e.to(g.dtype), grads, state.ef)
        if data_parallel or not eng.is_identity:
            grads, ef = schedule(grads, step_key, use_ef)
            new_ef = ef if use_ef else new_ef

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
            m = m / L
        out = {"loss": m[0], "nll": m[1], "aux": m[2], "tokens": m[3],
               "lr": lr}
        return TrainState(params=new_params, opt=new_opt,
                          step=state.step + 1, ef=new_ef), out

    def launches_and_bytes(n_workers: int) -> Tuple[int, float]:
        if not data_parallel:
            return 0, 0.0
        return eng.launches_and_bytes(n_workers)

    step_fn.exchange = eng
    step_fn.launches_and_bytes = launches_and_bytes
    return step_fn
