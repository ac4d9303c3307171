"""Training state (the reference's ``train/state.py``, replicated mode)."""
from __future__ import annotations

from typing import Any, NamedTuple


class TrainState(NamedTuple):
    params: Any                 # f32 master weights (replicated)
    opt: Any                    # optimizer state, shaped like params
    step: int                   # steps taken
    ef: Any = None              # error-feedback residuals: a params-shaped
                                # f32 tree (TrainConfig.error_feedback)
