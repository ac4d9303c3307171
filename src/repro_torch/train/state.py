"""Training state (the reference's ``train/state.py``)."""
from __future__ import annotations

from typing import Any, NamedTuple


class TrainState(NamedTuple):
    params: Any                 # f32 master weights: replicated, or this
                                # worker's ZeRO-3 slices in fsdp mode
    opt: Any                    # optimizer state, shaped like params
    step: int                   # steps taken
    ef: Any = None              # error-feedback residuals
                                # (TrainConfig.error_feedback): a
                                # params-shaped f32 tree in flat replicated
                                # mode; in fused fsdp and two-level
                                # replicated mode a tuple of one flat f32
                                # buffer per policy group (None for an
                                # identity group), this worker's residual
                                # of its own quantizer input: the full
                                # group buffer in flat fsdp, the 1/n_intra
                                # intra shard in two-level mode. A
                                # checkpoint stacks the tuple's buffers
                                # over the ranks, the reference's global
                                # layout.
