"""Fully fused BinGrad-b ENCODE: b₀ search + conditional-mean levels +
threshold + 1-bit pack, one launch.

Port of the reference's Pallas kernel ``kernels/fused_bingrad.py:
encode_bingrad_fused`` (``pl.pallas_call`` at line 102, body
``_bingrad_encode_kernel``). BinGrad-b's level fit is moments only —
b₀ = mean(G), then the conditional means below/above b₀ (Eq. 17),
optionally iterated ``lloyd_iters`` times to the 2-means fixed point — so
the whole scheme fuses: one sweep computes the level table (b₋₁, b₁),
thresholds at its midpoint and packs 32 elements per uint32 word. The
CUDA kernel is in ``csrc/encode_bingrad.cu``;
:func:`encode_bingrad_fused_plain` is its plain PyTorch version, the
reference's formulas term for term.

Parity: the levels are row sums divided by counts, so they are
float-close across summation orders (kernel vs plain version, card vs
CPU, port vs XLA). The words are exact GIVEN the levels: each is the
threshold ``v >= 0.5 * (b₋₁ + b₁)`` of the (clipped) values. On values
whose every partial sum is exact in float32 (multiples of 1/64 in
[-1, 1], d <= 2048) everything is bit-equal. NaN and infinite values
give the reference's results: its sums are of v * m, v * lo and v * hi,
so one left out of a sum (masked, or on the other side of b₀) makes the
sum NaN.

The kernel adds its row sums in one fixed order on every path
(:func:`kernel_order_levels` repeats it in plain PyTorch, so the tests
hold the card's levels to it bit for bit), and :func:`launch_plan`
chooses its path and launch geometry from (nb, d) and the tensors'
alignment.

The optional σ-clip limit is computed once outside the kernel
(``fused_encode.clip_limit``) and rides in as an (nb, 1) side input, as
in the reference. ``mask=None`` marks every slot valid (the serving
path's KV rows): the fit then counts all d slots.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import encode
from repro_torch.core import levels as L
from repro_torch.kernels import build
from repro_torch.kernels.fused_encode import _clip_round

#: the kernel keeps a row in registers, 8 values a thread, at most 1024
#: threads a block
MAX_D = 8 * 1024
#: the warp paths (a warp per row, 8 * NW values a lane, NW <= 8) take d
#: up to this; wider rows take the block path (a block per row)
WARP_MAX_D = 8 * 32 * 8
#: warps a block on the warp paths
WARP_MAX_WARPS = 4
#: warps an SM holds on the warp paths (three blocks of four, at up to 170
#: registers a thread)
WARPS_PER_SM = 12
#: shared memory of an H100 SM, and a block's without opting in to more
SM_SHARED_BYTES = 228 * 1024
SHARED_BYTES_DEFAULT = 48 * 1024
_PATHS = {"block": 0, "warp_bulk": 1, "warp_async": 2}


def _check(v, mask, lim, lloyd_iters):
    if v.dim() != 2:
        raise ValueError(f"v must be (nb, d), got {tuple(v.shape)}")
    if mask is not None and (mask.shape != v.shape
                             or mask.dtype != torch.bool):
        raise ValueError("mask must be a bool tensor shaped like v")
    if lim is not None and lim.shape != (v.shape[0], 1):
        raise ValueError("lim must be (nb, 1)")
    if lloyd_iters < 0:
        raise ValueError(f"lloyd_iters must be >= 0, got {lloyd_iters}")


def block_threads(d: int) -> int:
    """nt = 32 * ceil(ceil(d / 8) / 32): the block path's threads for a row
    of d, whose order of additions every path keeps (thread t = 32 j + l
    holds columns i * nt + t, i = 0..7)."""
    per_item = -(-d // 8)
    return 32 * -(-per_item // 32)


class LaunchPlan(NamedTuple):
    """How ``repro_encode_bingrad`` launches: ``path`` "warp_bulk" or
    "warp_async" (a warp per row, rows strided over the grid's warps, the
    next row's bytes copied into the warp's 40 nt + 128 bytes of shared
    memory while it fits this one: by 1-D bulk copies, or by 4-byte
    asynchronous copies where a bulk copy's 16-byte alignment is missing)
    or "block" (a block of nt threads per row); ``warps`` a block; ``grid``
    blocks; ``shared_bytes`` of dynamic shared memory a block (within the
    default 48 KB, so no block opts in to more)."""
    path: str
    warps: int
    grid: int
    shared_bytes: int


def launch_plan(nb: int, d: int, sm_count: int,
                align: int = 16) -> LaunchPlan:
    """The kernel's launch for nb rows of d on a card of ``sm_count`` SMs,
    the tensors starting on multiples of ``align`` bytes. d <= WARP_MAX_D
    takes a warp path, in blocks of nb // sm_count warps (1 to 4), so that
    a small nb (the serving path's 16 rows) gives each row a block and an
    SM of its own, with a persistent grid of as many blocks as the SMs
    hold: "warp_bulk" where a row's values and mask bytes start on 16
    bytes (d a multiple of 16, ``align`` 16), else "warp_async" (``align``
    at least 4). Wider rows, and mask bytes off a 4-byte boundary, take
    "block"."""
    if not (0 < d <= MAX_D) or nb < 1 or sm_count < 1:
        raise ValueError(f"no launch for nb = {nb}, d = {d}, "
                         f"{sm_count} SMs")
    if d > WARP_MAX_D or align < 4:
        return LaunchPlan("block", block_threads(d) // 32, nb, 0)
    path = "warp_bulk" if align >= 16 and d % 16 == 0 else "warp_async"
    warps = min(max(nb // sm_count, 1), WARP_MAX_WARPS)
    smem = (5 * 8 * block_threads(d) + 128) * warps
    resident = min(SM_SHARED_BYTES // (smem + 1024), WARPS_PER_SM // warps)
    grid = min(-(-nb // warps), sm_count * resident)
    return LaunchPlan(path, warps, grid, smem)


def walked_rows(plan: LaunchPlan, nb: int) -> torch.Tensor:
    """The rows the launch visits, in order of (block, warp, step): on the
    warp paths warp w of block b takes rows b * warps + w + m * grid *
    warps, m = 0, 1, ... below nb; on the block path block b takes row b.
    Every row once is the plan's contract."""
    if plan.path == "block":
        return torch.arange(plan.grid)
    first = torch.arange(plan.grid * plan.warps)
    steps = -(-nb // (plan.grid * plan.warps))
    rows = first[:, None] + torch.arange(steps)[None] * first.numel()
    return rows[rows < nb]


def kernel_order_levels(v: torch.Tensor, mask: Optional[torch.Tensor],
                        lim: Optional[torch.Tensor], *,
                        lloyd_iters: int = 0) -> torch.Tensor:
    """The kernel's levels (nb, 2) from its own additions, in plain
    PyTorch float32: per thread t = 32 j + l of nt = ``block_threads(d)``
    the terms at columns i * nt + t in order of i, each warp j's 32 lanes
    by the xor tree 16, 8, 4, 2, 1, then the nt / 32 warp totals
    zero-padded to 32 by the same tree; counts are exact. The terms are
    the reference's v * m, v * lo and v * hi of every slot: a zero for a
    finite value left out (which leaves a sum as it was), NaN for a NaN or
    infinite one. Bit-equal to the kernel's levels on any input (NaN
    levels: NaN); for tests and ``chip_smoke.py``, on any device."""
    _check(v, mask, lim, lloyd_iters)
    nb, d = v.shape
    nt = block_threads(d)
    nwarps = nt // 32
    x = v.to(torch.float32)
    if lim is not None:                     # jnp.clip: a NaN propagates
        lim = lim.to(torch.float32)
        x = torch.minimum(torch.maximum(x, -lim), lim)
    ok = (torch.ones_like(x, dtype=torch.bool) if mask is None
          else mask.to(torch.bool))
    pad = 8 * nt - d
    x = torch.nn.functional.pad(x, (0, pad)).reshape(nb, 8, nwarps, 32)
    ok = torch.nn.functional.pad(ok, (0, pad)).reshape(nb, 8, nwarps, 32)
    lane = torch.arange(32, device=x.device)

    def row_sum(sel):
        terms = torch.where(sel, x, x * 0.0)
        s = torch.zeros((nb, nwarps, 32), dtype=torch.float32,
                        device=x.device)
        for i in range(8):
            s = s + terms[:, i]
        for off in (16, 8, 4, 2, 1):
            s = s + s[..., lane ^ off]
        y = torch.zeros((nb, 32), dtype=torch.float32, device=x.device)
        y[:, :nwarps] = s[..., 0]
        for off in (16, 8, 4, 2, 1):
            y = y + y[:, lane ^ off]
        return y[:, :1]

    def count(sel):
        return sel.sum(dim=(1, 2, 3)).to(torch.float32)[:, None]

    def cond_means(b0):
        b0 = b0[:, :, None, None]
        lo, hi = ok & (x < b0), ok & (x >= b0)
        clo, chi = count(lo), count(hi)
        bm = row_sum(lo) / torch.clamp(clo, min=1.0)
        bp = row_sum(hi) / torch.clamp(chi, min=1.0)
        bm = torch.where(clo > 0, bm, bp)
        bp = torch.where(chi > 0, bp, bm)
        return bm, bp

    bm, bp = cond_means(row_sum(ok) / torch.clamp(count(ok), min=1.0))
    for _ in range(lloyd_iters):
        bm, bp = cond_means(0.5 * (bm + bp))
    return torch.cat([bm, bp], dim=1)


def encode_bingrad_fused_plain(v: torch.Tensor,
                               mask: Optional[torch.Tensor],
                               lim: Optional[torch.Tensor], *,
                               lloyd_iters: int = 0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (nb, d) values [+ (nb, d) bool
    mask] [+ (nb, 1) clip limit] -> ((nb, ceil(d / 32)) int32 words,
    (nb, 2) f32 levels (b₋₁, b₁)). A masked slot packs index 0."""
    _check(v, mask, lim, lloyd_iters)
    v = v.to(torch.float32)
    if lim is not None:
        lim = lim.to(torch.float32)
        v = torch.minimum(torch.maximum(v, -lim), lim)
    m = torch.ones_like(v, dtype=torch.bool) if mask is None else mask
    lv = L.bingrad_b_levels(v, m, lloyd_iters=lloyd_iters)
    idx = _clip_round(2, "bin", v, lv, mask, None, None)
    return encode.pack(idx, 1), lv


#: repro_encode_bingrad(v, mask, lim, words, levels, nb, d, lloyd_iters,
#:                      path, warps, grid, smem, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_SM_COUNT = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def encode_bingrad_fused_cuda(v: torch.Tensor,
                              mask: Optional[torch.Tensor],
                              lim: Optional[torch.Tensor], *,
                              lloyd_iters: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/encode_bingrad.cu`` on the current stream; same
    contract as :func:`encode_bingrad_fused_plain`. Every tensor must lie
    on one CUDA device and be contiguous: v/lim float32, mask bool;
    d <= MAX_D."""
    _check(v, mask, lim, lloyd_iters)
    build.check_cuda("encode_bingrad_fused", v=v, mask=mask, lim=lim)
    for name, t in (("v", v), ("lim", lim)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"encode_bingrad_fused: {name} must be float32, "
                            f"got {t.dtype}")
    nb, d = v.shape
    if d > MAX_D:
        raise ValueError(f"encode_bingrad_fused: d = {d} > {MAX_D}")
    words = torch.empty((nb, encode.packed_words(d, 1)), dtype=torch.int32,
                        device=v.device)
    levels = torch.empty((nb, 2), dtype=torch.float32, device=v.device)
    if nb:
        align = min(ptr & -ptr if ptr else 16 for ptr in
                    (v.data_ptr(), 0 if mask is None else mask.data_ptr()))
        _launch(v, mask, lim, words, levels, lloyd_iters,
                launch_plan(nb, d, _sm_count(v.device), min(align, 16)))
    return words, levels


def _launch(v, mask, lim, words, levels, lloyd_iters, plan: LaunchPlan):
    """One launch of the encode with ``plan``, counted."""
    nb, d = v.shape
    launch = build.function("encode_bingrad", "repro_encode_bingrad",
                            _ARGTYPES)
    launch(v.data_ptr(), None if mask is None else mask.data_ptr(),
           None if lim is None else lim.data_ptr(), words.data_ptr(),
           levels.data_ptr(), nb, d, lloyd_iters, _PATHS[plan.path],
           plan.warps, plan.grid, plan.shared_bytes,
           torch.cuda.current_stream().cuda_stream)
    encode_bingrad_fused_cuda.launches += 1


encode_bingrad_fused_cuda.launches = 0
