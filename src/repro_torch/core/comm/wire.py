"""Wire format for quantized values: level fit + rounding + uint32 packing.

One "wire unit" is a pair ``(words, levels)``:

    words   (nb, nw) int32 holding uint32 words — bit-packed level
            indices, ``nw`` words per bucket at
            ``qz.wire_bits_per_element`` bits per element;
    levels  (nb, s)  float32 — the per-bucket runtime level tables.

Port of the reference's ``core/comm/wire.py`` (the fused paths): the
level fit is plain PyTorch, everything after it is ONE kernel launch:
``encode_fused`` (encode), ``qdq_fused`` (the error-feedback residual),
``decode_fused_mean`` (phase 1's server side) or ``decode_fused_each``
(phase 2's broadcast decode). For BinGrad-b (mode "bin") the fit fuses
too: ``encode_bingrad_fused`` fits, thresholds and packs in one launch,
and ``qdq`` takes its levels from that same launch (see :func:`qdq`).
The rounding stream is drawn on the device of the values it rounds,
whatever device the key was built on. The multi-pass baseline, which the
reference takes for a scheme with no fused mode, is not ported yet
(ROADMAP.md).
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


def bucket_len(chunk: int, d: int) -> int:
    """Effective bucket length for a chunk of ``chunk`` elements."""
    return min(d, max(chunk, 1))


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


def encode_rbits(qz: Quantizer, key: torch.Tensor, shape, device=None):
    """The threefry stream :func:`encode` would draw for a ``shape`` bucket
    layout (None for the deterministic schemes), as int32 bit patterns,
    drawn on ``device`` (default: the key's)."""
    if _fused_mode(qz) != "rr":
        return None
    return R.random_bits(key if device is None else key.to(device), shape)


def _check_mode(qz: Quantizer) -> str:
    mode = _fused_mode(qz)
    if not mode:
        raise NotImplementedError(
            f"{qz.method!r} has no fused encode; the multi-pass encode is "
            f"not ported to repro_torch yet (see ROADMAP.md)")
    return mode


def _fit(qz: Quantizer, bkt: torch.Tensor,
         mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-bucket levels; ``mask=None`` fits on every slot."""
    return qz.fit(bkt, torch.ones_like(bkt, dtype=torch.bool)
                  if mask is None else mask)


def encode(qz: Quantizer, bkt: torch.Tensor, mask: Optional[torch.Tensor],
           key: Optional[torch.Tensor], *,
           rbits: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit levels on masked buckets, round, and bit-pack.

    bkt/mask are (nb, d_eff); returns ``(words, levels)`` with masked-out
    slots forced to index 0. ``mask=None`` marks every slot valid: the fit
    sees an all-true mask and the kernel reads none. ``rbits`` optionally
    supplies the rounding stream; the default draws it from ``key`` on
    ``bkt``'s device. BinGrad-b's fit, threshold and pack are one
    ``encode_bingrad_fused`` launch."""
    mode = _check_mode(qz)
    if mode == "bin":
        return ops.encode_bingrad(bkt, mask, clip_c=qz.clip_c,
                                  lloyd_iters=qz.lloyd_iters)
    levels = _fit(qz, bkt, mask)                          # runtime levels
    if mode == "rr" and rbits is None:
        rbits = encode_rbits(qz, key, bkt.shape, bkt.device)
    words = ops.encode_fused(bkt, levels, rbits if mode == "rr" else None,
                             mask, bits=qz.wire_bits_per_element,
                             clip_c=qz.clip_c, mode=mode)
    return words, levels


def qdq(qz: Quantizer, bkt: torch.Tensor, mask: Optional[torch.Tensor],
        key: Optional[torch.Tensor]) -> torch.Tensor:
    """Fused local quantize -> dequantize on the wire layout: (nb, d_eff)
    values -> (nb, d_eff) f32, bit-identical to what :func:`encode` puts
    on the wire (same fit, same clip, same rounding stream). One
    ``qdq_fused`` launch; masked-out slots decode to level 0.

    BinGrad-b's levels come from the encode's own launch
    (``encode_bingrad_fused``), not from a refit: a fit in another
    summation order lands a few ulps away from the levels on the wire,
    and the error-feedback residual must be taken against those."""
    mode = _check_mode(qz)
    if mode == "bin":
        _, levels = ops.encode_bingrad(bkt, mask, clip_c=qz.clip_c,
                                       lloyd_iters=qz.lloyd_iters)
    else:
        levels = _fit(qz, bkt, mask)
    rbits = encode_rbits(qz, key, bkt.shape, bkt.device)
    return ops.qdq_fused(bkt, levels, rbits, mask, clip_c=qz.clip_c,
                         mode=mode)


def decode(qz: Quantizer, words: torch.Tensor, levels: torch.Tensor,
           d_eff: int, *, average: bool = True) -> torch.Tensor:
    """Decode L stacked wire units in ONE launch: unpack + dequantize
    [+ average]. ``average=True`` is the server side of phase 1 (-> (nb,
    d_eff) mean); ``average=False`` is phase 2's broadcast decode (-> (L,
    nb, d_eff))."""
    bits = qz.wire_bits_per_element
    if average:
        return ops.decode_fused_mean(words, levels, d_eff, bits=bits)
    return ops.decode_fused_each(words, levels, d_eff, bits=bits)


def decode_mean(qz: Quantizer, words: torch.Tensor, levels: torch.Tensor,
                d_eff: int) -> torch.Tensor:
    """(L, nb, nw) words + (L, nb, s) levels -> (nb, d_eff) mean values."""
    return decode(qz, words, levels, d_eff, average=True)


def decode_each(qz: Quantizer, words: torch.Tensor, levels: torch.Tensor,
                d_eff: int) -> torch.Tensor:
    """(L, nb, nw) words + (L, nb, s) levels -> (L, nb, d_eff) values."""
    return decode(qz, words, levels, d_eff, average=False)


def wire_unit_bytes(qz: Quantizer, nb: int, d_eff: int) -> int:
    """Bytes on the wire for one (words, levels) unit of nb buckets."""
    words = E.packed_words(d_eff, qz.wire_bits_per_element)
    return 4 * nb * (words + qz.s)
