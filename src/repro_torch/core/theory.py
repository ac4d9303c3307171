"""Closed-form quantization-error quantities used to validate the theory
(the reference's ``core/theory.py``). Plain PyTorch, as the reference
computes them outside any kernel.

* ``expected_mse`` — D = E(v − Q(v))² for unbiased random rounding (Eq. 9):
  for v in [b_{k-1}, b_k] the conditional variance is (v−b_{k-1})(b_k−v),
  so D = Σ_k ∫ (v−b_{k-1})(b_k−v) p(v) dv, evaluated exactly on the
  empirical distribution (no sampling noise: what Theorem 1 minimizes).
* ``deterministic_mse`` — E(v − Q(v))² for a deterministic rule (BinGrad-b /
  SignSGD), exact on the empirical distribution.
* ``empirical_bias`` — Monte-Carlo E[Q(v)] − v estimator, on the keys of
  ``prng.split`` (``jax.random.split``'s).
"""
from __future__ import annotations

import torch

from repro_torch.core import buckets as B
from repro_torch.core import prng
from repro_torch.core import rounding as R
from repro_torch.core.quantizers import Quantizer


def _per_bucket_mean(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    err = torch.where(mask, err, 0.0)
    cnt = torch.clamp(mask.sum(-1).to(torch.float32), min=1.0)
    return err.sum(-1) / cnt


def expected_mse(bkt: torch.Tensor, mask: torch.Tensor,
                 levels: torch.Tensor) -> torch.Tensor:
    """Exact E‖v − Q(v)‖² per bucket for random rounding at given levels.

    Values outside [levels[0], levels[-1]] contribute their squared clip
    distance plus the rounding variance of the clipped value (Eq. 14's
    partially biased scheme; for ORQ the ends are min/max, so nothing
    clips)."""
    v = bkt.to(torch.float32)
    k = R.find_interval(v, levels).to(torch.int64)
    lo = torch.gather(levels, -1, k)
    hi = torch.gather(levels, -1, k + 1)
    vc = torch.minimum(torch.maximum(v, lo), hi)
    var = (vc - lo) * (hi - vc)        # rounding variance (Eq. 9 integrand)
    bias2 = (v - vc) ** 2              # clipping error
    return _per_bucket_mean(var + bias2, mask)


def deterministic_mse(bkt: torch.Tensor, mask: torch.Tensor,
                      levels: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """Exact E‖v − Q(v)‖² per bucket for a deterministic assignment."""
    v = bkt.to(torch.float32)
    q = torch.gather(levels, -1, idx.to(torch.int64))
    return _per_bucket_mean((v - q) ** 2, mask)


def scheme_mse(qz: Quantizer, flat: torch.Tensor) -> torch.Tensor:
    """Exact per-tensor expected quantization MSE of a scheme (no
    sampling). With a σ-clip the error is taken against the original
    values, so it includes the clip's bias."""
    bkt, mask = B.to_buckets(flat.reshape(-1).to(torch.float32),
                             qz.bucket_size)
    lv = qz.fit(bkt, mask)            # fit applies the clip itself
    if qz.method in ("bingrad_b", "signsgd"):
        # deterministic: the key is never read (the reference passes
        # key(0)); assign clips over every slot, as the reference's does
        idx = qz.assign(bkt, lv, prng.key(0, device=bkt.device))
        per_bucket = deterministic_mse(bkt, mask, lv, idx)
    else:
        per_bucket = expected_mse(bkt, mask, lv)
    cnt = mask.sum(-1).to(torch.float32)
    return (per_bucket * cnt).sum() / torch.clamp(cnt.sum(), min=1.0)


def empirical_bias(qz: Quantizer, flat: torch.Tensor, key: torch.Tensor,
                   n_samples: int = 256) -> torch.Tensor:
    """Monte-Carlo mean of Q(v) − v over ``n_samples`` rounding draws, one
    per key of ``prng.split(key, n_samples)``."""
    keys = prng.split(key.to(flat.device), n_samples)
    total = torch.zeros_like(flat, dtype=torch.float32)
    for k in keys:
        total = total + qz.qdq(flat, k)
    return total / n_samples - flat
