"""Optimizers (the reference's ``optim/optimizers.py``).

Interface mirrors optax and the reference: ``init(params) -> state``,
``update(grads, state, params, lr) -> (updates, state)``; apply with
``apply_updates``. Trees are the port's params dicts; every function is
functional (new tensors, nothing updated in place), as in the reference.
The paper trains with SGD + momentum 0.9, the default throughout.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.pytree import tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]   # (grads, state, params, lr) -> (upd, state)


def sgd_momentum(momentum: float = 0.9, weight_decay: float = 0.0,
                 nesterov: bool = False) -> Optimizer:
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params, lr):
        gw = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        new_state = tree_map(lambda g, m: momentum * m + g, gw, state)
        if nesterov:
            updates = tree_map(lambda g, m: -lr * (g + momentum * m), gw,
                               new_state)
        else:
            updates = tree_map(lambda m: -lr * m, new_state)
        return updates, new_state

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: int


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return AdamState(mu=tree_map(torch.zeros_like, params),
                         nu=tree_map(torch.zeros_like, params), count=0)

    def update(grads, state, params, lr):
        c = state.count + 1
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** c
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** c
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu,
                      grads)

        def upd(m, v, p):
            return -lr * ((m / bc1.to(m.device))
                          / (torch.sqrt(v / bc2.to(v.device)) + eps)
                          + weight_decay * p)

        return tree_map(upd, mu, nu, params), AdamState(mu=mu, nu=nu,
                                                         count=c)

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
