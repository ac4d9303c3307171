"""Quantization-level solvers (the reference's ``core/levels.py``).

``orq_levels`` is the paper's Algorithm 1: greedy recursive bisection
solving the optimal unbiased random-rounding condition Eq. (11)/(12) on the
*empirical* per-bucket distribution, for s = 2^K + 1 levels, with the
bucket min/max as endpoints (Corollary 1.1).

Inputs are ``(nb, d)`` values with a ``(nb, d)`` validity mask; outputs are
ascending ``(nb, s)`` float32 level tables. The fit is float-close to the
reference, not bit-equal: its prefix sums add in another order, and an
ulp there can move ``round`` at :func:`solve_midpoint` by one index.

The BinGrad and baseline solvers are not ported yet (see ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SortedBuckets(NamedTuple):
    """Sorted per-bucket values with prefix sums; the 'empirical p(v)'."""

    v: torch.Tensor      # (nb, d) ascending; padding sorted to the end as +inf
    psum: torch.Tensor   # (nb, d+1) prefix sums of valid values (pads count 0)
    cnt: torch.Tensor    # (nb,) int64 number of valid values


def sort_buckets(bkt: torch.Tensor, mask: torch.Tensor) -> SortedBuckets:
    bkt = bkt.to(torch.float32)
    v = torch.sort(torch.where(mask, bkt, torch.inf), dim=-1).values
    vz = torch.where(torch.isfinite(v), v, 0.0)
    psum = torch.cat([torch.zeros_like(vz[:, :1]), torch.cumsum(vz, dim=-1)],
                     dim=-1)
    cnt = mask.sum(dim=-1)
    return SortedBuckets(v=v, psum=psum, cnt=cnt)


def _finite_or_inf(v: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(v), v, torch.inf)


def _count_lt(sb: SortedBuckets, x: torch.Tensor) -> torch.Tensor:
    """Per bucket: #(v < x). x: (nb,) -> (nb,) int64."""
    return (_finite_or_inf(sb.v) < x[:, None]).sum(dim=-1)


def _count_le(sb: SortedBuckets, x: torch.Tensor) -> torch.Tensor:
    return (_finite_or_inf(sb.v) <= x[:, None]).sum(dim=-1)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-bucket gather: a (nb, m), idx (nb,) -> (nb,)."""
    return torch.gather(a, 1, idx[:, None])[:, 0]


def _bucket_min(sb: SortedBuckets) -> torch.Tensor:
    v0 = sb.v[:, 0]
    return torch.where(sb.cnt > 0, torch.where(torch.isfinite(v0), v0, 0.0),
                       0.0)


def _bucket_max(sb: SortedBuckets) -> torch.Tensor:
    idx = torch.clamp(sb.cnt - 1, min=0)
    vm = _take(sb.v, idx)
    return torch.where(sb.cnt > 0, torch.where(torch.isfinite(vm), vm, 0.0),
                       0.0)


def solve_midpoint(sb: SortedBuckets, bl: torch.Tensor,
                   br: torch.Tensor) -> torch.Tensor:
    """Solve Eq. (12) for b_k given neighbours (b_{k-1}, b_{k+1}) = (bl, br).

    Discrete optimal condition:
        |{b_k <= v <= br}|  =  Σ_{bl<=v<=br} (v - bl) / (br - bl).

    The LHS is a decreasing step function of b_k over the sorted bucket
    values, so the solution index is closed-form from prefix sums.
    """
    idx_l = _count_lt(sb, bl)            # first index with v >= bl
    idx_r = _count_le(sb, br)            # one past last index with v <= br
    cnt_in = (idx_r - idx_l).to(torch.float32)   # #values in [bl, br]
    sum_in = _take(sb.psum, idx_r) - _take(sb.psum, idx_l)
    width = br - bl
    safe_w = torch.where(width > 0, width, 1.0)
    rhs = (sum_in - bl * cnt_in) / safe_w        # target count in [b_k, br]
    # count{v in [b, br]} = idx_r - j  where j = first index with v >= b.
    j = torch.round(idx_r.to(torch.float32) - rhs).to(torch.int64)
    j = torch.minimum(torch.maximum(j, idx_l),
                      torch.maximum(idx_r - 1, idx_l))
    b = _take(sb.v, torch.clamp(j, 0, sb.v.shape[-1] - 1))
    b = torch.where(torch.isfinite(b), b, 0.0)
    mid = 0.5 * (bl + br)
    # Degenerate interval (no data inside, or zero width): bisect.
    b = torch.where((cnt_in > 0) & (width > 0), b, mid)
    return torch.minimum(torch.maximum(b, torch.minimum(bl, br)),
                         torch.maximum(bl, br))


def orq_levels(bkt: torch.Tensor, mask: torch.Tensor, K: int
               ) -> torch.Tensor:
    """Algorithm 1: greedy recursive level selection. Returns (nb, 2^K + 1).
    """
    if K < 1:
        raise ValueError(f"ORQ needs K >= 1, got {K}")
    s = 2 ** K + 1
    sb = sort_buckets(bkt, mask)
    nb = bkt.shape[0]
    levels = torch.zeros((nb, s), dtype=torch.float32, device=bkt.device)
    levels[:, 0] = _bucket_min(sb)                       # Corollary 1.1
    levels[:, s - 1] = _bucket_max(sb)                   # Corollary 1.1
    step = s - 1
    while step > 1:  # recursion depth K
        half = step // 2
        for lo in range(0, s - 1, step):
            hi = lo + step
            levels[:, lo + half] = solve_midpoint(sb, levels[:, lo],
                                                  levels[:, hi])
        step = half
    return levels
