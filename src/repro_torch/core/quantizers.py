"""Quantizer objects: the paper's schemes and its baselines behind one API.

The port of the reference's ``core/quantizers.py``, reduced to what the
quantized-KV serving path needs: the scheme's static description
(``s``, ``wire_bits_per_element``) and the level ``fit``. Only ORQ's
Algorithm 1 is ported so far; fitting any other scheme raises until its
solver lands (ROADMAP.md, queue 1). The reference's beyond-paper knobs
(``refine_iters``, ``lloyd_iters``, ``qsgd_norm``) come with the solvers
that read them.

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
        if self.method == "orq":
            K = (self.num_levels - 1).bit_length() - 1
            if 2 ** K + 1 != self.num_levels:
                raise ValueError(
                    f"ORQ needs s = 2^K + 1, got {self.num_levels}")
            return L.orq_levels(bkt, mask, K)
        raise NotImplementedError(
            f"the {self.method!r} level solver is not ported to repro_torch "
            f"yet; only 'orq' fits run (see ROADMAP.md, queue 1)")
