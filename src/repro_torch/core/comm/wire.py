"""Wire format for quantized values: level fit + rounding + uint32 packing.

One "wire unit" is a pair ``(words, levels)``:

    words   (nb, nw) int32 holding uint32 words — bit-packed level
            indices, ``nw`` words per bucket at
            ``qz.wire_bits_per_element`` bits per element;
    levels  (nb, s)  float32 — the per-bucket runtime level tables.

Port of the reference's ``core/comm/wire.py`` (the fused ``encode`` path):
the level fit is plain PyTorch, everything after it is ONE
``encode_fused`` launch. The decode paths, the multi-pass baseline and
BinGrad-b's fused encode come with the training slice (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import encode as E
from repro_torch.core import rounding as R
from repro_torch.core.quantizers import Quantizer
from repro_torch.kernels import ops

#: schemes that use unbiased random rounding (Eq. 7) on a fitted table
_RR_METHODS = ("orq", "terngrad", "qsgd", "linear", "minmax2", "bingrad_pb")


def _fused_mode(qz: Quantizer) -> str:
    """Static rounding mode of the fused stage for ``qz`` ('' = no fused
    path)."""
    if qz.method in _RR_METHODS:
        return "rr"
    if qz.method == "bingrad_b":
        return "bin"
    if qz.method == "signsgd":
        return "sign"
    return ""


def encode_rbits(qz: Quantizer, key: torch.Tensor, shape):
    """The threefry stream :func:`encode` would draw for a ``shape`` bucket
    layout (None for the deterministic schemes), as int32 bit patterns."""
    if _fused_mode(qz) != "rr":
        return None
    return R.random_bits(key, shape)


def encode(qz: Quantizer, bkt: torch.Tensor, mask: Optional[torch.Tensor],
           key: Optional[torch.Tensor], *,
           rbits: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit levels on masked buckets, round, and bit-pack.

    bkt/mask are (nb, d_eff); returns ``(words, levels)`` with masked-out
    slots forced to index 0. ``mask=None`` marks every slot valid: the fit
    sees an all-true mask and the kernel reads none. ``rbits`` optionally
    supplies the rounding stream; the default draws it from ``key``."""
    mode = _fused_mode(qz)
    if mode == "bin":
        raise NotImplementedError(
            "bingrad-b's fused encode (encode_bingrad_fused) is not ported "
            "to repro_torch yet (see ROADMAP.md)")
    if not mode:
        raise NotImplementedError(
            f"{qz.method!r} has no fused encode; the multi-pass encode is "
            f"not ported to repro_torch yet (see ROADMAP.md)")
    fit_mask = (torch.ones_like(bkt, dtype=torch.bool) if mask is None
                else mask)
    levels = qz.fit(bkt, fit_mask)                        # runtime levels
    if mode == "rr" and rbits is None:
        rbits = encode_rbits(qz, key, bkt.shape)
    words = ops.encode_fused(bkt, levels, rbits if mode == "rr" else None,
                             mask, bits=qz.wire_bits_per_element,
                             clip_c=qz.clip_c, mode=mode)
    return words, levels


def wire_unit_bytes(qz: Quantizer, nb: int, d_eff: int) -> int:
    """Bytes on the wire for one (words, levels) unit of nb buckets."""
    words = E.packed_words(d_eff, qz.wire_bits_per_element)
    return 4 * nb * (words + qz.s)
