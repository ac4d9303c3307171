"""Replicated data-parallel train step with the paper's quantized gradient
exchange: Algorithm 2 (the reference's ``train/step.py``, replicated mode
with the flat hierarchy and the fused exchange).

Each worker (a ``torch.distributed`` rank) computes the loss and its
gradient on its shard of the batch (autograd through the plain PyTorch
forward, the counterpart of ``jax.value_and_grad``), flattens the
gradient into one f32 buffer per policy group (``PartitionedExchange``),
and runs the two-phase quantized all-reduce on it; every worker then
applies the identical mean gradient with SGD + momentum, so the
replicated parameters stay in sync. The key schedule is the reference's:
``fold_in(key, step)`` -> ``fold_in(., crc32(b"fused_exchange") &
0x7FFFFFFF)`` -> the group key (unfolded for a single group) -> the
per-worker folds inside the collectives.

With ``error_feedback`` each worker adds last step's residual to its
gradient before quantizing and keeps e <- g - Q^-1(Q(g)) from the fused
``qdq`` (same key, same layout as the phase-1 encode).

Not ported yet (ROADMAP.md): fsdp mode, the two-level / async
hierarchies, the bit schedule, pipelined and per-leaf exchanges. Their
``TrainConfig`` fields do not exist here, so setting one is an error.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core import prng
from repro_torch.core.api import QuantConfig
from repro_torch.core.comm.collectives import world
from repro_torch.core.comm.exchange import PartitionedExchange
from repro_torch.core.policy import QuantPolicy
from repro_torch.models.model import LM
from repro_torch.optim import optimizers as opt_lib
from repro_torch.optim.schedule import constant_lr
from repro_torch.train.state import TrainState
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten

# key-fold salt separating the fused whole-tree exchange stream from the
# reference's per-leaf (crc32-of-path) streams
_FUSED_SALT = zlib.crc32(b"fused_exchange") & 0x7FFFFFFF

#: the paper's optimizer: SGD with momentum 0.9, no weight decay
_OPTIMIZER = opt_lib.sgd_momentum(momentum=0.9)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    policy: Optional[Any] = None    # QuantPolicy or anything coercible
    mode: str = "replicated"        # the only mode ported
    hierarchy: str = "flat"         # flat | auto (one dp axis: flat)
    error_feedback: bool = False    # beyond-paper: EF residual accumulation
    exchange_chunk_elems: Optional[int] = None  # size cap per collective
    pipeline_chunks: int = 1        # only the single-shot schedule

    def __post_init__(self):
        if self.mode != "replicated":
            raise NotImplementedError(
                f"mode={self.mode!r}: only the replicated mode is ported to "
                f"repro_torch (fsdp: see ROADMAP.md)")
        if self.hierarchy not in ("flat", "auto"):
            raise NotImplementedError(
                f"hierarchy={self.hierarchy!r} is not ported to repro_torch "
                f"(see ROADMAP.md); one data-parallel group is flat")
        if self.pipeline_chunks != 1:
            raise NotImplementedError(
                "the pipelined exchange is not ported to repro_torch yet "
                "(see ROADMAP.md)")

    def resolved_policy(self) -> QuantPolicy:
        """The effective QuantPolicy (``policy``, else uniform fp)."""
        if self.policy is None:
            return QuantPolicy.uniform(QuantConfig(name="fp"))
        return QuantPolicy.coerce(self.policy)


def init_state(model: LM, tcfg: TrainConfig, *, seed: int = 0,
               device=None) -> TrainState:
    """Params from ``torch.Generator(seed)`` on ``device`` (the card unless
    ``device="cpu"``), zero optimizer state, zero EF residuals when
    ``error_feedback`` is on."""
    params = model.init(torch.Generator().manual_seed(seed), device=device)
    ef = (tree_map(torch.zeros_like, params) if tcfg.error_feedback
          else None)
    return TrainState(params=params, opt=_OPTIMIZER.init(params),
                      step=0, ef=ef)


def exchange_engine(model: LM, tcfg: TrainConfig,
                    group=None) -> PartitionedExchange:
    """The fused exchange the step runs, laid out from the model's
    parameter shapes."""
    params = model.abstract_params()
    return PartitionedExchange.build(
        tcfg.resolved_policy(), params, group,
        paths=model.param_paths(params),
        max_chunk_elems=tcfg.exchange_chunk_elems)


def make_train_step(model: LM, tcfg: TrainConfig,
                    lr_fn: Optional[Callable[[int], float]] = None, *,
                    group=None):
    """Returns ``step_fn(state, batch, key) -> (state, metrics)`` over the
    process group ``group`` (None: the default group; a world of one is a
    one-process run). ``key`` is a ``core.prng`` key; it is moved to the
    params' device, so every rounding stream is drawn there."""
    lr_fn = lr_fn or constant_lr(0.1)
    pex = exchange_engine(model, tcfg, group)

    def step_fn(state: TrainState, batch, key: torch.Tensor):
        L, _ = world(group)
        dev = tree_leaves(state.params)[0].device
        step_key = prng.fold_in(key.to(dev), state.step)

        params = tree_map(lambda t: t.detach().requires_grad_(True),
                          state.params)
        loss, metrics = model.loss(params, batch)
        grads = tree_unflatten(state.params, torch.autograd.grad(
            loss, tree_leaves(params)))

        new_ef = state.ef
        use_ef = (tcfg.error_feedback and state.ef is not None
                  and not pex.is_identity)
        if use_ef:
            # compensate last step's local quantization error first
            grads = tree_map(lambda g, e: g + e.to(g.dtype), grads, state.ef)
        k = prng.fold_in(step_key, _FUSED_SALT)
        bufs = pex.layout.flatten_groups(grads)
        if use_ef:
            local = pex.local_qdq_parts(bufs, k)
            new_ef = pex.layout.unflatten_groups(
                [f - q for f, q in zip(bufs, local)], restore_dtype=False)
        grads = pex.layout.unflatten_groups(pex.exchange_parts(bufs, k))

        lr = lr_fn(state.step)
        updates, new_opt = _OPTIMIZER.update(grads, state.opt, state.params,
                                             lr)
        new_params = opt_lib.apply_updates(state.params, updates)
        # metrics are averaged over the workers, like the reference's pmean
        m = torch.stack([loss.detach(), metrics["nll"].detach(),
                         torch.as_tensor(metrics["aux"], device=dev,
                                         dtype=torch.float32),
                         metrics["tokens"]])
        dist.all_reduce(m, group=group)
        m = m / L
        out = {"loss": m[0], "nll": m[1], "aux": m[2], "tokens": m[3],
               "lr": lr}
        return TrainState(params=new_params, opt=new_opt,
                          step=state.step + 1, ef=new_ef), out

    step_fn.exchange = pex
    return step_fn
