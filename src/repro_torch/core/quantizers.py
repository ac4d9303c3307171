"""Quantizer objects: the paper's schemes and its baselines behind one API.

The port of the reference's ``core/quantizers.py``. A ``Quantizer`` is a
stateless recipe with three stages that mirror Algorithm 2's per-worker
step:

    fit(bkt, mask)           -> levels   (runtime level selection — the paper)
    assign(bkt, levels, key) -> idx      (rounding rule, plain PyTorch)
    decode(idx, levels)      -> values   (dequantization, a gather)

plus ``quantize(flat, key)`` / ``dequantize(q)`` over the bucketed layout,
``qdq`` (quantize∘dequantize), ``encode_wire`` / ``decode_wire`` (the
uint32 packing) and ``wire_bytes``. The exchange's hot path does not call
these: ``core/comm/wire.py`` runs the fused kernels, and its multi-pass
path (``wire.encode_multipass``) calls ``assign`` for the deterministic
schemes and ``decode`` for the per-worker decode.

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
from typing import NamedTuple, Optional

import torch

from repro_torch.core import buckets as B
from repro_torch.core import clipping, encode, levels as L
from repro_torch.core import rounding as R


class QuantizedTensor(NamedTuple):
    """Bucketed quantized payload for one flat tensor."""

    idx: torch.Tensor      # (nb, d) int32 level indices (wire: bit-packed)
    levels: torch.Tensor   # (nb, s) float32 level table  (wire: as-is)
    n: int                 # original element count


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

    def assign(self, bkt: torch.Tensor, levels: torch.Tensor,
               key: Optional[torch.Tensor],
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(nb, d) values + (nb, s) levels -> (nb, d) int32 indices. The
        σ-clip sees the real bucket ``mask`` as ``fit`` does (None = every
        slot valid); the random-round schemes draw their stream from
        ``key`` on the values' device."""
        if self.clip_c is not None:
            if mask is None:
                mask = torch.ones_like(bkt, dtype=torch.bool)
            bkt = clipping.sigma_clip(bkt, mask, self.clip_c)
        m = self.method
        if m in ("orq", "terngrad", "qsgd", "linear", "minmax2",
                 "bingrad_pb"):
            bits = R.random_bits(key.to(bkt.device), bkt.shape)
            return R.random_round(bkt, levels, bits)
        if m == "bingrad_b":
            b0 = 0.5 * (levels[:, :1] + levels[:, 1:2])  # Eq. (17): midpoint
            return R.threshold_round(bkt, b0)
        if m == "signsgd":
            return R.threshold_round(
                bkt, torch.zeros((bkt.shape[0], 1), device=bkt.device))
        raise ValueError(f"unknown method {self.method!r}")

    @staticmethod
    def decode(idx: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
        return R.dequantize(idx, levels)

    def quantize(self, flat: torch.Tensor,
                 key: Optional[torch.Tensor]) -> QuantizedTensor:
        bkt, mask = B.to_buckets(flat.reshape(-1), self.bucket_size)
        lv = self.fit(bkt, mask)
        idx = torch.where(mask, self.assign(bkt, lv, key, mask=mask), 0)
        return QuantizedTensor(idx=idx, levels=lv, n=flat.numel())

    def dequantize(self, q: QuantizedTensor) -> torch.Tensor:
        return B.from_buckets(self.decode(q.idx, q.levels), q.n)

    def qdq(self, flat: torch.Tensor,
            key: Optional[torch.Tensor]) -> torch.Tensor:
        """quantize -> dequantize, shape-preserving (single-machine Alg. 2)."""
        if self.is_identity:
            return flat
        out = self.dequantize(self.quantize(flat.reshape(-1), key))
        return out.reshape(flat.shape).to(flat.dtype)

    def encode_wire(self, q: QuantizedTensor) -> torch.Tensor:
        """(nb, d) indices -> (nb, nw) int32 words holding uint32 bits."""
        return encode.pack(q.idx, self.wire_bits_per_element)

    def decode_wire(self, words: torch.Tensor, levels: torch.Tensor,
                    n: int) -> QuantizedTensor:
        idx = encode.unpack(words, self.wire_bits_per_element,
                            self.bucket_size)
        return QuantizedTensor(idx=idx.to(torch.int32), levels=levels, n=n)

    def wire_bytes(self, n_elems: int) -> float:
        """Packed wire bytes for a tensor of n_elems (payload + level
        tables)."""
        nb = B.num_buckets(n_elems, self.bucket_size)
        if self.is_identity:
            return 4.0 * n_elems
        words = encode.packed_words(self.bucket_size,
                                    self.wire_bits_per_element)
        return 4.0 * (nb * words + nb * self.s)
