"""Public quantization API: config + the scheme registry and its grammar.

``QuantConfig`` is what flows through launcher flags and policies;
``make_quantizer`` turns it into the stateless ``Quantizer`` recipe by
looking the scheme family up in a registry, exactly as the reference's
``core/api.py`` does. Built-in names (paper §5 nomenclature):

    fp | orq-3 | orq-5 | orq-9 | orq-17 | bingrad-pb | bingrad-b |
    terngrad | qsgd-5 | qsgd-9 | linear-5 | linear-9 | signsgd | minmax2
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.quantizers import Quantizer

_NAME_RE = re.compile(r"^([a-z]+[a-z0-9]*?)(?:-(pb|b|\d+))?$")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    name: str = "fp"               # e.g. "orq-9"
    bucket_size: int = 2048
    clip_c: Optional[float] = None
    refine_iters: int = 0
    lloyd_iters: int = 0
    server_requant: bool = True    # Algorithm 2 option (b): quantize the
                                   # averaged gradient on the way back down

    def to_quantizer(self) -> Quantizer:
        return make_quantizer(
            self.name,
            bucket_size=self.bucket_size,
            clip_c=self.clip_c,
            refine_iters=self.refine_iters,
            lloyd_iters=self.lloyd_iters,
        )


@dataclasses.dataclass(frozen=True)
class SchemeSpec:
    """One scheme family: ``base`` name, a builder mapping the optional
    ``-suffix`` (level count / variant tag) to a Quantizer, and the
    advertised variant names."""

    base: str
    builder: Callable[..., Quantizer]   # builder(suffix, **kw) -> Quantizer
    variants: Tuple[str, ...]
    doc: str = ""


_REGISTRY: Dict[str, SchemeSpec] = {}


def register_scheme(base: str, builder: Callable[..., Quantizer], *,
                    variants: Tuple[str, ...] = (),
                    doc: str = "") -> SchemeSpec:
    """Register (or replace) a scheme family; every advertised variant must
    parse back to ``base``."""
    if not _NAME_RE.match(base) or "-" in base:
        raise ValueError(f"bad scheme base name {base!r}")
    variants = tuple(variants) or (base,)
    for v in variants:
        m = _NAME_RE.match(v)
        if not m or m.group(1) != base:
            raise ValueError(
                f"variant {v!r} cannot be parsed back to scheme {base!r} "
                f"(allowed suffixes: -pb, -b, or -<digits>)")
    spec = SchemeSpec(base=base, builder=builder, variants=variants, doc=doc)
    _REGISTRY[base] = spec
    return spec


def all_methods() -> list:
    """Every advertised scheme name, derived from the registry."""
    return [v for spec in _REGISTRY.values() for v in spec.variants]


def make_quantizer(name: str, **kw) -> Quantizer:
    m = _NAME_RE.match(name.strip().lower().replace("_", "-"))
    if not m:
        raise ValueError(
            f"bad quantizer name {name!r}; valid schemes: "
            f"{', '.join(all_methods())}")
    base, suffix = m.group(1), m.group(2)
    spec = _REGISTRY.get(base)
    if spec is None:
        raise ValueError(
            f"unknown quantizer {name!r}; valid schemes: "
            f"{', '.join(all_methods())}")
    return spec.builder(suffix, **kw)


# -- built-in families -------------------------------------------------------

def _fixed(method: str):
    def build(suffix, **kw):
        if suffix is not None:
            raise ValueError(f"scheme {method!r} takes no -suffix")
        return Quantizer(method=method, **kw)
    return build


def _leveled(method: str, default_s: int):
    def build(suffix, **kw):
        return Quantizer(method=method,
                         num_levels=int(suffix) if suffix else default_s,
                         **kw)
    return build


def _bingrad(suffix, **kw):
    if suffix not in ("pb", "b"):
        raise ValueError("bingrad needs a -pb or -b suffix")
    return Quantizer(method=f"bingrad_{suffix}", **kw)


register_scheme("fp", _fixed("fp"), doc="identity (no quantization)")
register_scheme("orq", _leveled("orq", 9),
                variants=("orq-3", "orq-5", "orq-9", "orq-17"),
                doc="ORQ-s, s = 2^K+1 (Theorem 1 / Alg. 1)")
register_scheme("bingrad", _bingrad, variants=("bingrad-pb", "bingrad-b"),
                doc="BinGrad partially/fully biased (Eq. 14-17)")
register_scheme("terngrad", _fixed("terngrad"),
                doc="TernGrad (3 levels ±max|v|)")
register_scheme("qsgd", _leveled("qsgd", 9), variants=("qsgd-5", "qsgd-9"),
                doc="QSGD-s (evenly spaced levels)")
register_scheme("linear", _leveled("linear", 9),
                variants=("linear-5", "linear-9"),
                doc="Linear-s (CDF quantiles)")
register_scheme("signsgd", _fixed("signsgd"),
                doc="scaled SignSGD (Eq. 13)")
register_scheme("minmax2", _fixed("minmax2"),
                doc="unbiased 2-level {min,max} (Corollary 1.1)")
