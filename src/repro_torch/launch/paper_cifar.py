"""The paper's CIFAR setting (§5.1) on one device: a small ResNet trained
with SGD + momentum 0.9 and weight decay 5e-4, comparing fp, TernGrad,
ORQ-3, ORQ-9 and BinGrad-b gradients (each leaf quantized, then
dequantized, every step; bucket d = 2048; no clipping). The PyTorch
counterpart of the reference's ``examples/paper_cifar_repro.py``.

CIFAR itself is not available offline: the stream is the class-conditional
synthetic 32x32x3 one (``repro_torch.data.cifar_like_batches``), drawn bit
for bit as the reference draws it.

    python -m repro_torch.launch.paper_cifar --steps 120 [--device cpu] \\
        [--methods fp orq-9]

Each leaf's qdq is ``buckets.to_buckets`` -> ``core/comm/wire.qdq`` ->
``from_buckets`` under the key ``fold_in(fold_in(key(1), step),
crc32(path))``, where ``path`` is the leaf's ``jax.tree_util.keystr``
(e.g. ``['stages'][0][0]['w1']``). On the card that is one ``qdq_fused``
launch a leaf (mode ``rr`` for orq-3, orq-9 and terngrad, mode ``bin`` for
BinGrad-b, whose levels come from one ``encode_bingrad_fused`` launch a
leaf); on the CPU the plain versions run. The optimizer step is
``optimizers.step``: it rounds as the reference's jitted step does.
"""
from __future__ import annotations

import argparse
import time
import zlib
from typing import List, NamedTuple, Optional

import torch

from repro_torch.core import buckets, prng
from repro_torch.core.api import make_quantizer
from repro_torch.core.comm import wire
from repro_torch.data import cifar_like_batches
from repro_torch.device import resolve_device
from repro_torch.launch.train import params_digest
from repro_torch.models.resnet import (ResNetConfig, float32_convs,
                                       init_resnet, resnet_logits,
                                       resnet_loss)
from repro_torch.optim import optimizers, sgd_momentum
from repro_torch.utils.pytree import tree_flatten_with_path, tree_unflatten

METHODS = ["fp", "terngrad", "orq-3", "orq-9", "bingrad-b"]
EXAMPLE_CFG = ResNetConfig(num_classes=10, width=16, blocks_per_stage=1)
BATCH = 64
LR = 0.05
BUCKET = 2048


class CifarRun(NamedTuple):
    loss: float                 # the last step's loss
    accuracy: float             # on a fresh batch after the last step
    sha256: str                 # of the final params (``params_digest``)
    losses: List[float]         # every step's loss
    step_s: List[float]         # every step's host seconds (to the loss)
    params: dict


def leaf_key(step_key: torch.Tensor, path: str) -> torch.Tensor:
    """The reference example's per-leaf key."""
    return prng.fold_in(step_key, zlib.crc32(path.encode()) & 0x7FFFFFFF)


def qdq_leaf(qz, g: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Quantize -> dequantize one gradient leaf, shape-preserving."""
    bkt, mask = buckets.to_buckets(g.reshape(-1), qz.bucket_size)
    out = wire.qdq(qz, bkt, mask, key)
    return buckets.from_buckets(out, g.numel()).reshape(g.shape)


def qdq_grads(qz, grads, step_key: torch.Tensor):
    """Every leaf through :func:`qdq_leaf` under its own key."""
    flat, treedef = tree_flatten_with_path(grads)
    return tree_unflatten(treedef, [qdq_leaf(qz, g, leaf_key(step_key, p))
                                    for p, g in flat])


def loss_and_grads(params, batch, cfg: ResNetConfig):
    """(loss, gradient tree) by ``torch.autograd``, the convolutions of
    the backward in full float32 as the forward's."""
    flat, treedef = tree_flatten_with_path(params)
    live = [t.detach().requires_grad_(True) for _, t in flat]
    with float32_convs():
        loss = resnet_loss(tree_unflatten(treedef, live), batch, cfg)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def make_step(method: str, cfg: ResNetConfig, lr: float = LR):
    """-> (optimizer, step(params, opt_state, batch, step_key) ->
    (params, opt_state, loss)): the example's jitted step."""
    qz = make_quantizer(method, bucket_size=BUCKET)
    opt = sgd_momentum(momentum=0.9, weight_decay=5e-4)

    def step(params, opt_state, batch, step_key):
        loss, grads = loss_and_grads(params, batch, cfg)
        if not qz.is_identity:
            grads = qdq_grads(qz, grads, step_key)
        params, opt_state = optimizers.step(opt, grads, opt_state, params,
                                            lr)
        return params, opt_state, loss

    return opt, step


def accuracy(params, batch, cfg: ResNetConfig) -> float:
    with torch.no_grad():
        pred = resnet_logits(params, batch["images"], cfg).argmax(-1)
    return float((pred == batch["labels"].long()).to(torch.float32).mean())


def train(method: str, steps: int, seed: int = 0,
          cfg: ResNetConfig = EXAMPLE_CFG, device=None,
          params: Optional[dict] = None) -> CifarRun:
    """Train ``steps`` steps from ``init_resnet(seed)`` (or from
    ``params``, e.g. a reference tree carried across) on the card unless
    ``device="cpu"``."""
    device = resolve_device(device)
    if params is None:
        params = init_resnet(torch.Generator().manual_seed(seed), cfg,
                             device)
    opt, step = make_step(method, cfg)
    opt_state = opt.init(params)
    data = cifar_like_batches(BATCH, seed=seed, device=device)
    base = prng.key(1, device=device)
    losses, times = [], []
    for i in range(steps):
        batch = next(data)
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch,
                                       prng.fold_in(base, i))
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    acc = accuracy(params, next(data), cfg)
    return CifarRun(loss=losses[-1] if losses else float("nan"),
                    accuracy=acc, sha256=params_digest(params),
                    losses=losses, step_s=times, params=params)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--methods", nargs="+", default=METHODS,
                    choices=METHODS)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    print(f"{'method':10s} {'final loss':>11s} {'accuracy':>9s}  sha256")
    for m in args.methods:
        r = train(m, args.steps, seed=args.seed, device=args.device)
        print(f"{m:10s} {r.loss:11.4f} {r.accuracy:9.3f}  {r.sha256}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
