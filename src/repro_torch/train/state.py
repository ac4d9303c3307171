"""Training state (the reference's ``train/state.py``)."""
from __future__ import annotations

from typing import Any, NamedTuple


class OuterState(NamedTuple):
    """Outer-optimizer state of the temporal ``two_level_async`` hierarchy.

    ``anchor`` is the agreed parameter tree the current H-step inner window
    started from: the outer pseudo-gradient is ``anchor - local params`` at
    the window's end, and every worker holds the same anchor (it is
    rewritten only at sync steps, from the exchange's identical output).
    ``mom`` is the outer SGD-momentum / Nesterov buffer, params-shaped f32,
    the same on every worker too."""

    anchor: Any                 # params-shaped window start (replicated)
    mom: Any                    # params-shaped f32 outer momentum


class TrainState(NamedTuple):
    params: Any                 # f32 master weights: replicated, or this
                                # worker's ZeRO-3 slices in fsdp mode; in
                                # two_level_async mode this worker's own
                                # copy (pods diverge within a window; a
                                # checkpoint stacks the copies over the
                                # ranks, the reference's leading worker
                                # axis)
    opt: Any                    # optimizer state, shaped like params
    step: int                   # steps taken
    ef: Any = None              # error-feedback residuals
                                # (TrainConfig.error_feedback): a
                                # params-shaped f32 tree in flat replicated
                                # mode; in fused fsdp, two-level replicated
                                # and two_level_async mode a tuple of one
                                # flat f32 buffer per policy group (None
                                # for an identity group), this worker's
                                # residual of its own quantizer input: the
                                # full group buffer in flat fsdp (and in
                                # two_level_async with pods of one), the
                                # 1/n_intra intra shard in two-level mode.
                                # A checkpoint stacks the tuple's buffers
                                # over the ranks, the reference's global
                                # layout.
    outer: Any = None           # OuterState in two_level_async mode; None
                                # for every single-time-scale hierarchy
