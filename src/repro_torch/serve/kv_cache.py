"""Paged quantized KV cache for the serving engine (the reference's
``serve/kv_cache.py``).

Layout. The cache is a pool of ``num_pages`` fixed-size page slots per
attention layer; a page holds ``page_size`` consecutive tokens of ONE
sequence. Token at absolute position ``p`` lives in page
``table[p // page_size]`` at slot ``p % page_size``, so gathering a
sequence's pages in table order yields its context contiguously.

Wire format. One bucket row per token spanning all KV heads
(d = num_kv_heads * head_dim), the training exchange's (words, levels)
unit:

    kw, vw    (pages, page_size, nw) int32 — bit-packed level indices
              (uint32 bit patterns)
    klv, vlv  (pages, page_size, s)  f32   — per-token runtime levels

The ``bf16`` scheme is the escape hatch: raw (pages, page_size, KV, hd)
bf16 pools. Page 0 is the reserved TRASH page that inactive decode slots
write into. Per-layer pools carry the model's stacked-repeats leading axis.

Randomness. The random-round schemes draw their threefry stream per
(request seed, absolute position, layer salt, repeat) via
:func:`token_rbits`, bit-equal to the reference's, so a token's quantized
bits do not depend on its decode slot or on what else shares the batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.core import encode as E
from repro_torch.core import prng
from repro_torch.core import rounding as R
from repro_torch.device import resolve_device

TRASH_PAGE = 0


@dataclasses.dataclass(frozen=True)
class KVQuantSpec:
    """Static description of the KV cache quantization scheme."""

    scheme: str                  # "bf16" or a fused-encode quantizer name
    num_kv_heads: int
    head_dim: int
    clip_c: Optional[float] = None

    @property
    def d(self) -> int:
        """Bucket width: one bucket per token spans all KV heads."""
        return self.num_kv_heads * self.head_dim

    @property
    def is_bf16(self) -> bool:
        return self.scheme == "bf16"

    def quantizer(self):
        from repro_torch.core.api import make_quantizer
        from repro_torch.core.comm import wire

        qz = make_quantizer(self.scheme, bucket_size=self.d,
                            clip_c=self.clip_c)
        if qz.is_identity or not wire._fused_mode(qz):
            raise ValueError(
                f"--kv-quant {self.scheme!r}: KV pages need a fused "
                f"one-pass encode (random-round schemes, bingrad-b, "
                f"signsgd) or the 'bf16' escape hatch")
        return qz

    @property
    def bits(self) -> int:
        return self.quantizer().wire_bits_per_element

    @property
    def s(self) -> int:
        return self.quantizer().s

    @property
    def nw(self) -> int:
        return E.packed_words(self.d, self.bits)

    def token_bytes(self) -> int:
        """Cache bytes for one token (K + V) in one attention layer."""
        if self.is_bf16:
            return 2 * self.d * 2
        return 2 * (4 * self.nw + 4 * self.s)


def token_bytes_ratio(spec: KVQuantSpec) -> float:
    """Quantized-vs-bf16 cache bytes at equal batch × context."""
    bf16 = KVQuantSpec("bf16", spec.num_kv_heads, spec.head_dim)
    return spec.token_bytes() / bf16.token_bytes()


# ---------------------------------------------------------------------------
# pools
# ---------------------------------------------------------------------------

def _init_layer_pool(kvq: KVQuantSpec, reps: int, num_pages: int,
                     page_size: int, device) -> Dict[str, torch.Tensor]:
    P, S = num_pages, page_size
    if kvq.is_bf16:
        KV, hd = kvq.num_kv_heads, kvq.head_dim
        return {n: torch.zeros((reps, P, S, KV, hd), dtype=torch.bfloat16,
                               device=device) for n in ("k", "v")}
    nw, s = kvq.nw, kvq.s
    return {
        "kw": torch.zeros((reps, P, S, nw), dtype=torch.int32, device=device),
        "klv": torch.zeros((reps, P, S, s), dtype=torch.float32,
                           device=device),
        "vw": torch.zeros((reps, P, S, nw), dtype=torch.int32, device=device),
        "vlv": torch.zeros((reps, P, S, s), dtype=torch.float32,
                           device=device),
    }


def init_kv_pools(model, kvq: KVQuantSpec, num_pages: int, page_size: int,
                  device=None):
    """Paged pools mirroring the model's scan-group structure:
    tuple-of-groups of {pos_j: pool leaves with leading (repeats,) axis},
    on the card unless the caller passes ``device="cpu"``."""
    device = resolve_device(device)
    pools = []
    for g in model.groups:
        gp = {}
        for j, spec in enumerate(g.unit):
            if spec.kind not in ("attn", "attn_local") or spec.cross_attn:
                raise ValueError(
                    f"paged KV serving supports plain GQA attention "
                    f"layers only (got kind={spec.kind!r}, "
                    f"cross_attn={spec.cross_attn})")
            gp[f"pos{j}"] = _init_layer_pool(kvq, g.repeats, num_pages,
                                             page_size, device)
        pools.append(gp)
    return tuple(pools)


def pool_bytes(pools) -> int:
    """Total device bytes held by the paged pools."""
    return sum(t.numel() * t.element_size()
               for gp in pools for pool in gp.values()
               for t in pool.values())


def append_rows(pool: Dict[str, torch.Tensor], pages: torch.Tensor,
                slots: torch.Tensor, parts: Dict[str, torch.Tensor]) -> None:
    """Scatter R new tokens' rows into one layer's pool IN PLACE (the
    reference returns new pools, which its jit donates): pool leaf
    (P, S, ...), a view of the stacked pool; pages/slots (R,) int64;
    parts name -> (R, ...) new rows."""
    for k, v in parts.items():
        pool[k][pages, slots] = v.to(pool[k].dtype)


def gather_context(pool: Dict[str, torch.Tensor],
                   page_table: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Gather per-sequence contiguous context views from one layer's pool:
    page_table (B, max_pages) -> leaf (B, max_pages*page_size, ...).
    Context index c IS absolute position c (pages are sequence-ordered)."""
    out = {}
    for k, leaf in pool.items():
        g = leaf[page_table]                  # (B, maxp, S, ...)
        out[k] = g.reshape(g.shape[0], g.shape[1] * g.shape[2],
                           *g.shape[3:])
    return out


# ---------------------------------------------------------------------------
# deterministic per-token rounding stream
# ---------------------------------------------------------------------------

def token_rbits(seeds: torch.Tensor, positions: torch.Tensor, salt: int,
                rep: int, d: int) -> torch.Tensor:
    """(R,) request seeds + (R,) absolute token positions -> (R, d) int32
    threefry stream (uint32 bit patterns) for the random-round schemes,
    keyed on (seed, position, static layer salt, repeat index); bit-equal
    to the reference's ``token_rbits``."""
    k = prng.key(seeds)
    k = prng.fold_in(k, positions)
    k = prng.fold_in(k, salt)
    k = prng.fold_in(k, rep)
    return R.random_bits(k, (d,))


# ---------------------------------------------------------------------------
# host-side page allocator
# ---------------------------------------------------------------------------

class PageAllocator:
    """Free-list allocator over the page pool. Page 0 (TRASH_PAGE) is
    reserved — inactive decode slots write into it, sequences never do."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (1 is the trash page), "
                             f"got {num_pages}")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, TRASH_PAGE, -1))

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop n pages, or None (allocation is all-or-nothing)."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("freeing the trash page")
            self._free.append(p)
