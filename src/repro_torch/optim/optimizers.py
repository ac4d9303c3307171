"""Optimizers (the reference's ``optim/optimizers.py``).

Interface mirrors optax and the reference: ``init(params) -> state``,
``update(grads, state, params, lr) -> (updates, state)``; apply with
``apply_updates``. Trees are the port's params dicts; every function is
functional (new tensors, nothing updated in place), as in the reference.
The paper trains with SGD + momentum 0.9, the default throughout.

:func:`step` is what the train steps call: update and apply in one, with
the rounding of the reference's jitted step. XLA contracts SGD's
``momentum * m + g`` and ``p + (-lr) * m`` into fused multiply-adds there
(each rounded once), so the SGD step computes them with
``floats.fma_f32``; ``update`` + ``apply_updates`` round like the
reference's functions called one by one (each product and sum rounded).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.floats import fma_f32
from repro_torch.utils.pytree import tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]   # (grads, state, params, lr) -> (upd, state)
    fused: Optional[Callable[..., Any]] = None
    # (grads, state, params, lr) -> (new params, state), rounded as the
    # jitted reference rounds it; None: update + apply_updates


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

    def fused(grads, state, params, lr):
        gw = (grads if weight_decay == 0.0 else
              tree_map(lambda g, p: fma_f32(p, weight_decay, g), grads,
                       params))
        new_state = tree_map(lambda g, m: fma_f32(m, momentum, g), gw, state)
        step_dir = (tree_map(lambda g, m: fma_f32(m, momentum, g), gw,
                             new_state) if nesterov else new_state)
        new_params = tree_map(lambda p, d: fma_f32(d, -lr, p).to(p.dtype),
                              params, step_dir)
        return new_params, new_state

    return Optimizer(init, update, fused)


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


def step(opt: Optimizer, grads, state, params, lr):
    """One optimizer step -> (new params, new state), rounded as the
    reference's jitted train step rounds it (``opt.fused``), else
    ``update`` then ``apply_updates``."""
    if opt.fused is not None:
        return opt.fused(grads, state, params, lr)
    updates, new_state = opt.update(grads, state, params, lr)
    return apply_updates(params, updates), new_state
