"""Quantizer objects: the paper's schemes and its baselines behind one API.

The port of the reference's ``core/quantizers.py``: the scheme's static
description (``s``, ``wire_bits_per_element``, ``unbiased``) and the
runtime level ``fit`` of every scheme. The rounding and packing run in
``core/comm/wire.py``'s fused kernels; the reference's ``assign`` /
``quantize`` / ``qdq`` / ``encode_wire`` serve only its single-device
branch, which the port does not take.

Schemes:
    fp          identity (no quantization)
    orq         ORQ-s, s = 2^K+1 (ours, unbiased, Theorem 1 / Alg. 1)
    bingrad_pb  BinGrad-pb (ours, partially biased, Eq. 14/15)
    bingrad_b   BinGrad-b  (ours, fully biased, Eq. 16/17)
    terngrad    TernGrad (3 levels ±max|v|)
    qsgd        QSGD-s (evenly spaced levels)
    linear      Linear-s (CDF quantiles)
    signsgd     scaled SignSGD (Eq. 13, deterministic sign)
    minmax2     unbiased 2-level {min,max} (Corollary 1.1 endpoints)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import clipping, encode, levels as L


@dataclasses.dataclass(frozen=True)
class Quantizer:
    method: str = "orq"
    num_levels: int = 9            # s; must be 2^K+1 for orq
    bucket_size: int = 2048        # paper's d (512 for ImageNet runs)
    clip_c: Optional[float] = None  # TernGrad-style σ-clip factor (None = off)
    refine_iters: int = 0          # beyond-paper ORQ coordinate sweeps
    lloyd_iters: int = 0           # beyond-paper BinGrad-b fixed-point iters
    qsgd_norm: str = "linf"

    @property
    def unbiased(self) -> bool:
        # bingrad_pb is "partially biased" (unbiased only inside [b₋₁, b₁];
        # the clipped tails carry bias — Eq. 14), so it is not listed here.
        return self.method in ("fp", "orq", "terngrad", "qsgd", "linear",
                               "minmax2")

    @property
    def s(self) -> int:
        if self.method in ("bingrad_pb", "bingrad_b", "signsgd", "minmax2"):
            return 2
        if self.method == "terngrad":
            return 3
        return self.num_levels

    @property
    def wire_bits_per_element(self) -> int:
        return encode.bits_for_levels(self.s)

    @property
    def is_identity(self) -> bool:
        return self.method == "fp"

    def fit(self, bkt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.clip_c is not None and self.method not in ("fp",):
            bkt = clipping.sigma_clip(bkt, mask, self.clip_c)
        m = self.method
        if m == "orq":
            K = (self.num_levels - 1).bit_length() - 1
            if 2 ** K + 1 != self.num_levels:
                raise ValueError(
                    f"ORQ needs s = 2^K + 1, got {self.num_levels}")
            return L.orq_levels(bkt, mask, K, refine_iters=self.refine_iters)
        if m == "bingrad_pb":
            b1 = L.bingrad_pb_b1(bkt, mask)
            return torch.stack([-b1, b1], dim=-1)
        if m == "bingrad_b":
            return L.bingrad_b_levels(bkt, mask, lloyd_iters=self.lloyd_iters)
        if m == "terngrad":
            return L.terngrad_levels(bkt, mask)
        if m == "qsgd":
            return L.qsgd_levels(bkt, mask, self.num_levels,
                                 norm=self.qsgd_norm)
        if m == "linear":
            return L.linear_levels(bkt, mask, self.num_levels)
        if m == "signsgd":
            return L.signsgd_scale(bkt, mask)
        if m == "minmax2":
            return L.minmax_levels(bkt, mask)
        raise ValueError(f"unknown method {self.method!r}")
