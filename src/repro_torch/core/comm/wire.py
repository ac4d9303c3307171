"""Wire format for quantized values: level fit + rounding + uint32 packing.

One "wire unit" is a pair ``(words, levels)``:

    words   (nb, nw) int32 holding uint32 words — bit-packed level
            indices, ``nw`` words per bucket at
            ``qz.wire_bits_per_element`` bits per element;
    levels  (nb, s)  float32 — the per-bucket runtime level tables.

Port of the reference's ``core/comm/wire.py``. On the default (fused)
path the level fit is plain PyTorch and everything after it is ONE kernel
launch: ``encode_fused`` (encode), ``qdq_fused`` (the error-feedback
residual), ``decode_fused_mean`` (phase 1's server side) or
``decode_fused_each`` (phase 2's broadcast decode). For BinGrad-b (mode
"bin") the fit fuses too: ``encode_bingrad_fused`` fits, thresholds and
packs in one launch, and ``qdq`` takes its levels from that same launch
(see :func:`qdq`).

The multi-pass path (``encode_multipass``, ``decode_mean_multipass``,
``decode_each_multipass``) runs the same pipeline one stage per launch,
materializing the (nb, d) indices: fit, then :func:`assign` (the
``quant_rr`` kernel for the random-rounding schemes, ``Quantizer.assign``
for BinGrad-b and SignSGD), a masked select and the ``pack`` kernel; on
the way back the ``unpack`` kernel and ``dequant_avg`` (or the gather of
``Quantizer.decode``). It is the reference's parity baseline, bit-equal
to the fused path given the same key (BinGrad-b's levels aside: its
multi-pass fit is plain PyTorch, the fused one a kernel's row sums), and
what ``encode`` and ``qdq`` fall back to for a scheme with no fused mode.
The rounding stream is drawn on the device of the values it rounds,
whatever device the key was built on.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import buckets, clipping
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


def _fit(qz: Quantizer, bkt: torch.Tensor,
         mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-bucket levels; ``mask=None`` fits on every slot."""
    return qz.fit(bkt, torch.ones_like(bkt, dtype=torch.bool)
                  if mask is None else mask)


def assign(qz: Quantizer, bkt: torch.Tensor, levels: torch.Tensor,
           key: Optional[torch.Tensor],
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The multi-pass rounding stage: (nb, d) values + (nb, s) levels ->
    (nb, d) int32 indices. The random-rounding schemes σ-clip with the real
    bucket ``mask`` (None = every slot valid, as in ``qz.fit``), draw the
    stream from ``key`` on the values' device and launch ``quant_rr``;
    the others go through ``qz.assign``."""
    if qz.method in _RR_METHODS:
        if qz.clip_c is not None:
            if mask is None:
                mask = torch.ones_like(bkt, dtype=torch.bool)
            bkt = clipping.sigma_clip(bkt, mask, qz.clip_c)
        bits = R.random_bits(key.to(bkt.device), bkt.shape)
        return ops.quant_rr(bkt, levels, bits)
    return qz.assign(bkt, levels, key, mask=mask)


def _masked_indices(qz: Quantizer, bkt: torch.Tensor,
                    mask: Optional[torch.Tensor], levels: torch.Tensor,
                    key: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`assign`, masked-out slots forced to index 0."""
    idx = assign(qz, bkt, levels, key, mask=mask)
    return idx if mask is None else torch.where(mask, idx, 0)


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
    ``encode_bingrad_fused`` launch; a scheme with no fused mode takes
    :func:`encode_multipass`."""
    mode = _fused_mode(qz)
    if not mode:
        return encode_multipass(qz, bkt, mask, key)
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


def encode_multipass(qz: Quantizer, bkt: torch.Tensor,
                     mask: Optional[torch.Tensor], key: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The multi-pass encode: fit, :func:`assign`, masked select, then one
    ``pack`` launch; the same ``(words, levels)`` contract as
    :func:`encode`, bit-equal to it given the same key."""
    levels = _fit(qz, bkt, mask)                          # runtime levels
    idx = _masked_indices(qz, bkt, mask, levels, key)
    return ops.pack(idx, qz.wire_bits_per_element), levels


def qdq(qz: Quantizer, bkt: torch.Tensor, mask: Optional[torch.Tensor],
        key: Optional[torch.Tensor]) -> torch.Tensor:
    """Fused local quantize -> dequantize on the wire layout: (nb, d_eff)
    values -> (nb, d_eff) f32, bit-identical to what :func:`encode` puts
    on the wire (same fit, same clip, same rounding stream). One
    ``qdq_fused`` launch; masked-out slots decode to level 0.

    BinGrad-b's levels come from the encode's own launch
    (``encode_bingrad_fused``), not from a refit: a fit in another
    summation order lands a few ulps away from the levels on the wire,
    and the error-feedback residual must be taken against those. A scheme
    with no fused mode decodes the multi-pass indices with
    ``Quantizer.decode``."""
    mode = _fused_mode(qz)
    if not mode:
        levels = _fit(qz, bkt, mask)
        return Quantizer.decode(_masked_indices(qz, bkt, mask, levels, key),
                                levels)
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


def _unpack_stack(qz: Quantizer, words: torch.Tensor,
                  d_eff: int) -> torch.Tensor:
    """(L, nb, nw) words -> (L, nb, d_eff) int32 indices in one ``unpack``
    launch over the L·nb rows (rows are independent, so this equals the
    reference's unpack vmapped over L)."""
    L, nb, nw = words.shape
    idx = ops.unpack(words.reshape(L * nb, nw), qz.wire_bits_per_element,
                     d_eff)
    return idx.reshape(L, nb, d_eff)


def decode_mean_multipass(qz: Quantizer, words: torch.Tensor,
                          levels: torch.Tensor, d_eff: int) -> torch.Tensor:
    """The multi-pass mean decode: one ``unpack`` launch writing the full
    (L, nb, d_eff) indices, then one ``dequant_avg``; bit-equal to
    :func:`decode_mean`."""
    return ops.dequant_avg(_unpack_stack(qz, words, d_eff), levels)


def decode_each_multipass(qz: Quantizer, words: torch.Tensor,
                          levels: torch.Tensor, d_eff: int) -> torch.Tensor:
    """The multi-pass per-worker decode: one ``unpack`` launch, then the
    gather of ``Quantizer.decode``; equal by value to :func:`decode_each`
    (the gather keeps a level of -0.0, the fused lookup may give +0.0)."""
    return Quantizer.decode(_unpack_stack(qz, words, d_eff), levels)


def bucket_stats(bkt: torch.Tensor, mask: torch.Tensor, *,
                 clip_c: Optional[float] = None) -> torch.Tensor:
    """(nb, d) buckets + validity mask -> (3,) f32 ``[sigma_sq, clip_frac,
    l2_sq]``: the count-weighted mean per-bucket variance, the fraction of
    valid elements a ``clip_c``-sigma clip would clamp, and the buffer's
    squared norm (the reference's ``kernels/ops.bucket_stats``). Row
    reductions only, no kernel, as in the reference: float-close to it,
    not bit-equal."""
    m = mask.to(bkt.dtype)
    per = m.sum(dim=-1, keepdim=True)
    cnt = torch.clamp(per, min=1.0)
    mean = (bkt * m).sum(dim=-1, keepdim=True) / cnt
    var = (((bkt - mean) ** 2) * m).sum(dim=-1, keepdim=True) / cnt
    total = torch.clamp(m.sum(), min=1.0)
    sigma_sq = (var[:, 0] * per[:, 0]).sum() / total
    if clip_c is None:
        clip_frac = torch.zeros((), dtype=bkt.dtype, device=bkt.device)
    else:
        lim = clip_c * torch.sqrt(var)
        clip_frac = ((bkt.abs() > lim).to(bkt.dtype) * m).sum() / total
    l2_sq = ((bkt * m) ** 2).sum()
    return torch.stack([sigma_sq, clip_frac, l2_sq]).to(torch.float32)


def encode_stats(qz: Quantizer, flat: torch.Tensor,
                 d_eff: int) -> torch.Tensor:
    """(3,) f32 ``[sigma_sq, clip_frac, l2_sq]`` of a flat buffer under
    ``qz``'s bucket layout (:func:`bucket_stats`): the statistics the
    adaptive ``BitBudgetController`` re-solves per-group bits from."""
    bkt, mask = buckets.to_buckets(flat.to(torch.float32), d_eff)
    return bucket_stats(bkt, mask, clip_c=qz.clip_c)


def wire_unit_bytes(qz: Quantizer, nb: int, d_eff: int) -> int:
    """Bytes on the wire for one (words, levels) unit of nb buckets."""
    words = E.packed_words(d_eff, qz.wire_bits_per_element)
    return 4 * nb * (words + qz.s)
