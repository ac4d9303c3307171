"""Learning-rate schedules (the reference's ``optim/schedule.py``; paper
§5: base 0.1, x0.1 step decays, and a linear warm-up from base/10).

Each schedule maps an integer step to a Python float holding the float32
value the reference computes (its arithmetic runs in float32)."""
from __future__ import annotations

import numpy as np

f32 = np.float32


def constant_lr(lr: float):
    return lambda step: float(f32(lr))


def step_decay(base: float, boundaries, factor: float = 0.1):
    bounds = list(boundaries)

    def fn(step):
        lr = f32(base)
        for b in bounds:
            if step >= b:
                lr = f32(lr * f32(factor))
        return float(lr)

    return fn


def warmup_cosine(base: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    def fn(step):
        s = f32(step)
        if step < warmup_steps:
            return float(f32(base) * (f32(0.1) + f32(0.9) * s
                                      / f32(max(warmup_steps, 1))))
        frac = np.clip((s - f32(warmup_steps))
                       / f32(max(total_steps - warmup_steps, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(base) * (f32(min_ratio) + f32(1 - min_ratio) * f32(0.5)
                           * (f32(1) + np.cos(f32(np.pi) * frac)))
        return float(cos)

    return fn
