"""Quantization-level solvers (the reference's ``core/levels.py``).

The paper's solvers:

* ``orq_levels``       — Algorithm 1: greedy recursive bisection solving the
  optimal unbiased random-rounding condition Eq. (11)/(12) on the
  *empirical* per-bucket distribution, for s = 2^K + 1 levels, with the
  bucket min/max as endpoints (Corollary 1.1); ``refine_iters`` adds
  coordinate sweeps (beyond-paper).
* ``bingrad_pb_b1``    — Eq. (15): the partially-biased binary level b₁.
* ``bingrad_b_levels`` — Eq. (17): fully-biased binary levels, b₀ = mean,
  b±₁ = conditional means; ``lloyd_iters`` iterates the fixed point.

Baselines (paper §5): ``terngrad_levels``, ``qsgd_levels`` (ℓ∞ or ℓ2),
``linear_levels`` (CDF quantiles), ``signsgd_scale`` (Eq. 13) and
``minmax_levels`` (Corollary 1.1 endpoints). ``optimality_residual``
checks Theorem 1 at a solver's output.

Inputs are ``(nb, d)`` values with a ``(nb, d)`` validity mask; outputs are
ascending ``(nb, s)`` float32 level tables. Every formula is the
reference's term for term. The fits that sum (ORQ, BinGrad, QSGD-ℓ2,
SignSGD, Linear's quantile index) are float-close to the reference, not
bit-equal: their row and prefix sums add in another order, and an ulp
there can move ``round`` at :func:`solve_midpoint` or BinGrad-pb's
argmin by one sorted index. On values whose every partial sum is exact
in float32 (multiples of 1/64 in [-1, 1], d <= 2048) they are bit-equal.
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


def orq_levels(bkt: torch.Tensor, mask: torch.Tensor, K: int, *,
               refine_iters: int = 0) -> torch.Tensor:
    """Algorithm 1: greedy recursive level selection. Returns (nb, 2^K + 1).

    ``refine_iters`` > 0 adds coordinate-descent sweeps re-solving every
    interior level against its converged neighbours (beyond-paper).
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
    for _ in range(refine_iters):
        for k in range(1, s - 1):
            levels[:, k] = solve_midpoint(sb, levels[:, k - 1],
                                          levels[:, k + 1])
    return levels


def optimality_residual(bkt: torch.Tensor, mask: torch.Tensor,
                        levels: torch.Tensor) -> torch.Tensor:
    """Eq. (8) residual at each interior level, normalized. ~0 at optimum.

    residual_k = b_{k-1}·P[b_{k-1},b_k] + b_{k+1}·P[b_k,b_{k+1}]
                 − E[v; b_{k-1} <= v <= b_{k+1}]       (per unit mass)
    -> (nb, s-2).
    """
    sb = sort_buckets(bkt, mask)
    s = levels.shape[-1]
    res = []
    for k in range(1, s - 1):
        bl, bk, br = levels[:, k - 1], levels[:, k], levels[:, k + 1]
        i_l = _count_lt(sb, bl)
        i_k = _count_lt(sb, bk)
        i_r = _count_le(sb, br)
        n_lo = (i_k - i_l).to(torch.float32)
        n_hi = (i_r - i_k).to(torch.float32)
        sum_in = _take(sb.psum, i_r) - _take(sb.psum, i_l)
        total = torch.clamp(n_lo + n_hi, min=1.0)
        r = (bl * n_lo + br * n_hi - sum_in) / total
        scale = torch.clamp(torch.abs(br - bl), min=1e-12)
        res.append(r / scale)
    return torch.stack(res, dim=-1)


# ---------------------------------------------------------------------------
# BinGrad (binary quantization, §3.2)
# ---------------------------------------------------------------------------

def bingrad_pb_b1(bkt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Eq. (15): b₁ with  b₁·∫₀^∞ p  =  ∫_{b₁}^∞ v·p(v)dv,  solved on the
    empirical distribution by minimizing |LHS − RHS| over candidate data
    values. Returns (nb,) positive scale; levels are ±b₁."""
    sb = sort_buckets(bkt, mask)
    n = sb.v.shape[-1]
    total = _take(sb.psum, sb.cnt)
    finite = torch.isfinite(sb.v)
    cnt_pos = (torch.where(finite, sb.v, -torch.inf) > 0).sum(
        dim=-1).to(torch.float32)
    # suffix sum from index j: S[cnt] - S[j]
    suffix = total[:, None] - sb.psum[:, :n]
    vpos = torch.where(finite & (sb.v > 0), sb.v, torch.nan)
    f = torch.abs(vpos * cnt_pos[:, None] - suffix)
    f = torch.where(torch.isnan(f), torch.inf, f)
    j = torch.argmin(f, dim=-1)
    b1 = _take(sb.v, j)
    b1 = torch.where(torch.isfinite(b1) & (cnt_pos > 0), b1, 0.0)
    # all-nonpositive bucket: fall back to mean |v| scale
    absmean = torch.where(
        sb.cnt > 0,
        torch.abs(torch.where(mask, bkt.to(torch.float32), 0.0)).sum(-1)
        / torch.clamp(sb.cnt, min=1),
        0.0)
    return torch.where(b1 > 0, b1, absmean)


def bingrad_b_levels(bkt: torch.Tensor, mask: torch.Tensor, *,
                     lloyd_iters: int = 0) -> torch.Tensor:
    """Eq. (17): fully-biased binary levels. Returns (nb, 2) = (b₋₁, b₁).

    Paper default: b₀ = mean(G); b₋₁/b₁ = conditional means below/above b₀.
    ``lloyd_iters`` > 0 iterates b₀ ← (b₋₁+b₁)/2 (the exact Eq. 17 fixed
    point, i.e. 1-D 2-means) — beyond-paper refinement."""
    bkt = bkt.to(torch.float32)
    m = mask.to(torch.float32)
    cnt = torch.clamp(m.sum(-1, keepdim=True), min=1.0)
    b0 = (bkt * m).sum(-1, keepdim=True) / cnt

    def cond_means(b0):
        lo = m * (bkt < b0)
        hi = m * (bkt >= b0)
        cl = lo.sum(-1, keepdim=True)
        ch = hi.sum(-1, keepdim=True)
        bm = (bkt * lo).sum(-1, keepdim=True) / torch.clamp(cl, min=1.0)
        bp = (bkt * hi).sum(-1, keepdim=True) / torch.clamp(ch, min=1.0)
        # empty side: collapse to the other side's mean (degenerate bucket)
        bm = torch.where(cl > 0, bm, bp)
        bp = torch.where(ch > 0, bp, bm)
        return bm, bp

    bm, bp = cond_means(b0)
    for _ in range(lloyd_iters):
        b0 = 0.5 * (bm + bp)
        bm, bp = cond_means(b0)
    return torch.cat([bm, bp], dim=-1)


# ---------------------------------------------------------------------------
# Baselines (§5 comparison set)
# ---------------------------------------------------------------------------

def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, num, dtype=float32)``: start·(1 − t) +
    stop·t for t = i / (num − 1), the last entry ``stop`` itself. Bit-equal
    to the reference for num = 2^K + 1 (every registered QSGD-s and
    Linear-s), where every term is exact; for other num XLA's fusion of
    these terms can round an entry one ulp apart."""
    if num < 2:
        return torch.full((num,), start, dtype=torch.float32, device=device)
    div = num - 1
    t = torch.arange(div, dtype=torch.float32, device=device) / float(div)
    out = start * (1.0 - t) + stop * t
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32,
                                      device=device)])


def terngrad_levels(bkt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """TernGrad: {−max|v|, 0, +max|v|}. Returns (nb, 3)."""
    a = torch.where(mask, torch.abs(bkt.to(torch.float32)), 0.0)
    mx = a.amax(dim=-1)
    return torch.stack([-mx, torch.zeros_like(mx), mx], dim=-1)


def qsgd_levels(bkt: torch.Tensor, mask: torch.Tensor, s: int, *,
                norm: str = "linf") -> torch.Tensor:
    """QSGD-s: s levels evenly spaced over ±‖G‖ per bucket. Returns (nb, s)."""
    b = bkt.to(torch.float32)
    if norm == "linf":
        r = torch.where(mask, torch.abs(b), 0.0).amax(dim=-1)
    elif norm == "l2":
        r = torch.sqrt(torch.where(mask, b * b, 0.0).sum(dim=-1))
    else:
        raise ValueError(f"unknown norm {norm!r}")
    ticks = _linspace(-1.0, 1.0, s, b.device)
    return r[:, None] * ticks[None, :]


def linear_levels(bkt: torch.Tensor, mask: torch.Tensor,
                  s: int) -> torch.Tensor:
    """Linear-s: levels linearly dividing the empirical CDF (quantiles)."""
    sb = sort_buckets(bkt, mask)
    q = _linspace(0.0, 1.0, s, bkt.device)
    idx = torch.round(q[None, :] * (sb.cnt[:, None] - 1).to(torch.float32))
    idx = torch.clamp(idx.to(torch.int64), 0, sb.v.shape[-1] - 1)
    lv = torch.gather(sb.v, 1, idx)
    lv = torch.where(torch.isfinite(lv), lv, 0.0)
    return torch.where(sb.cnt[:, None] > 0, lv, torch.zeros_like(lv))


def signsgd_scale(bkt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Scaled SignSGD (Eq. 13): ±‖G‖₁/dim. Returns (nb, 2) = (−m, m)."""
    a = torch.where(mask, torch.abs(bkt.to(torch.float32)), 0.0)
    cnt = torch.clamp(mask.sum(-1).to(torch.float32), min=1.0)
    mmean = a.sum(-1) / cnt
    return torch.stack([-mmean, mmean], dim=-1)


def minmax_levels(bkt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Unbiased binary endpoints {min, max} (Corollary 1.1 for s=2).
    Returns (nb, 2)."""
    sb = sort_buckets(bkt, mask)
    return torch.stack([_bucket_min(sb), _bucket_max(sb)], dim=-1)
