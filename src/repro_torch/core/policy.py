"""QuantPolicy: declarative per-parameter-group quantization policy (the
reference's ``core/policy.py``, its static grammar; the adaptive bit
schedule and controller are not ported yet, see ROADMAP.md).

An ordered list of ``(path-pattern -> QuantConfig)`` rules plus a
default, resolved against each parameter leaf's path string (the strings
``LM.param_paths`` gives). The first matching rule wins; unmatched leaves
get the default.

Grammar (launcher ``--quant``, JSON):

    POLICY  := SCHEME                      # uniform shorthand
             | RULE ("," RULE)*
    RULE    := PATTERN "=" SCHEME
             | "default" "=" SCHEME
    PATTERN := python regex, matched with re.search against the leaf path
    SCHEME  := any registered scheme name (repro_torch.core.api.all_methods)

Examples: ``"orq-9"``, ``"norm|bias=fp, default=orq-9"``,
``'{"norm|bias": "fp", "default": "orq-9"}'``.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Mapping, Tuple

from repro_torch.core.api import QuantConfig

_GRAMMAR = ("policy grammar: 'pattern=scheme[,pattern=scheme...]"
            "[,default=scheme]' (regex patterns, first match wins) "
            "or a single scheme name for a uniform policy")


@dataclasses.dataclass(frozen=True)
class PolicyRule:
    """One ordered rule: regex ``pattern`` (re.search) -> ``cfg``."""

    pattern: str
    cfg: QuantConfig

    def __post_init__(self):
        if not self.pattern.strip():
            # re.search("") matches every path: a stray '=' would
            # silently hijack the whole policy
            raise ValueError(f"empty policy pattern; {_GRAMMAR}")
        try:
            re.compile(self.pattern)
        except re.error as e:
            raise ValueError(
                f"bad policy pattern {self.pattern!r}: {e}; {_GRAMMAR}"
            ) from e

    def matches(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Ordered rules + default, resolvable against any model's param paths."""

    rules: Tuple[PolicyRule, ...] = ()
    default: QuantConfig = QuantConfig(name="fp")

    @classmethod
    def uniform(cls, cfg) -> "QuantPolicy":
        """Every leaf gets ``cfg`` (a QuantConfig or a scheme name)."""
        if isinstance(cfg, str):
            cfg = QuantConfig(name=cfg)
        return cls(rules=(), default=cfg)

    @classmethod
    def parse(cls, spec: str, **defaults) -> "QuantPolicy":
        """Parse a policy string (see the module grammar). ``defaults`` are
        extra QuantConfig fields (bucket_size, clip_c, ...) applied to
        every rule built from a bare scheme name."""
        spec = spec.strip()
        if spec.startswith("{"):
            try:
                d = json.loads(spec)
            except json.JSONDecodeError as e:
                raise ValueError(f"bad policy JSON {spec!r}: {e}") from e
            return cls.from_dict(d, **defaults)
        if "=" not in spec:
            return cls.uniform(_cfg(spec, defaults))
        rules, default = [], None
        for entry in _split_entries(spec):
            # split on the LAST '=': the scheme never contains one, so
            # regex patterns with lookarounds (e.g. ``norm(?=\d)``) work
            pattern, scheme = (s.strip() for s in entry.rsplit("=", 1))
            if pattern == "default":
                if default is not None:
                    raise ValueError(
                        f"duplicate 'default' entry in policy {spec!r}")
                default = _cfg(scheme, defaults)
            else:
                rules.append(PolicyRule(pattern, _cfg(scheme, defaults)))
        if default is None:
            default = _cfg("fp", defaults)
        return cls(rules=tuple(rules), default=default)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any], **defaults) -> "QuantPolicy":
        """Dict/JSON form: {pattern: scheme-or-config-dict, ...,
        'default': ...}. Insertion order is rule order."""
        rules, default = [], None
        for pattern, val in d.items():
            if isinstance(val, str):
                cfg = _cfg(val, defaults)
            elif isinstance(val, QuantConfig):
                cfg = val
            elif isinstance(val, Mapping):
                cfg = _cfg_from_dict(val, defaults)
            else:
                raise ValueError(
                    f"bad policy value {val!r} for pattern {pattern!r}: "
                    f"expected a scheme name, QuantConfig, or field dict; "
                    f"{_GRAMMAR}")
            if pattern == "default":
                default = cfg
            else:
                rules.append(PolicyRule(pattern, cfg))
        return cls(rules=tuple(rules),
                   default=default if default is not None
                   else _cfg("fp", defaults))

    @classmethod
    def coerce(cls, obj, **defaults) -> "QuantPolicy":
        """Anything-to-policy: QuantPolicy (as-is), QuantConfig (uniform),
        str (parse), Mapping (from_dict)."""
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, QuantConfig):
            return cls.uniform(obj)
        if isinstance(obj, str):
            return cls.parse(obj, **defaults)
        if isinstance(obj, Mapping):
            return cls.from_dict(obj, **defaults)
        raise TypeError(f"cannot build a QuantPolicy from {type(obj)!r}")

    @property
    def is_uniform(self) -> bool:
        return not self.rules

    def resolve(self, path: str) -> QuantConfig:
        """First matching rule's config, else the default."""
        return self.cfg_for_rule(self.resolve_ix(path))

    def resolve_ix(self, path: str) -> int:
        """Index of the first matching rule; ``len(rules)`` means the
        default."""
        for i, rule in enumerate(self.rules):
            if rule.matches(path):
                return i
        return len(self.rules)

    def cfg_for_rule(self, rule_ix: int) -> QuantConfig:
        if rule_ix == len(self.rules):
            return self.default
        return self.rules[rule_ix].cfg

    def unmatched_rules(self, paths) -> Tuple[str, ...]:
        """Patterns that match NONE of ``paths`` (a typo'd pattern would
        otherwise silently fall through to the default)."""
        paths = list(paths)
        return tuple(r.pattern for r in self.rules
                     if not any(r.matches(p) for p in paths))

    def describe(self) -> str:
        parts = [f"{r.pattern}={r.cfg.name}" for r in self.rules]
        parts.append(f"default={self.default.name}")
        return ",".join(parts)


_SCHEME_TOKEN = re.compile(r"[A-Za-z0-9_\-]+(?:@\d+(?:\.\.\d+)?)?")


def _split_entries(spec: str) -> list:
    """Split a policy string into 'pattern=scheme' entries. Commas and '='
    INSIDE a pattern (regex quantifiers like ``{1,2}``, lookarounds like
    ``(?=x)``) are kept: segments are merged until the text after the last
    '=' looks like a bare scheme token."""
    entries, buf = [], ""
    for seg in spec.split(","):
        if not buf and not seg.strip():
            continue
        buf = f"{buf},{seg}" if buf else seg
        if "=" in buf and _SCHEME_TOKEN.fullmatch(
                buf.rsplit("=", 1)[1].strip()):
            entries.append(buf.strip())
            buf = ""
    if buf.strip():
        raise ValueError(
            f"bad policy entry {buf.strip()!r} (missing '=scheme'); "
            f"{_GRAMMAR}")
    return entries


def _cfg(scheme: str, defaults: Mapping[str, Any]) -> QuantConfig:
    if "@" in scheme:
        raise ValueError(
            f"{scheme.strip()!r} is a bit-ramp token (family@HI..LO); bit "
            f"schedules are not ported to repro_torch yet (see ROADMAP.md)")
    cfg = QuantConfig(name=scheme.strip().lower().replace("_", "-"),
                      **defaults)
    try:
        cfg.to_quantizer()   # validate the name against the registry now
    except ValueError as e:
        raise ValueError(
            f"bad scheme {scheme!r} in policy: {e}; {_GRAMMAR}") from e
    return cfg


def _cfg_from_dict(val: Mapping[str, Any],
                   defaults: Mapping[str, Any]) -> QuantConfig:
    kw = dict(defaults)
    kw.update(val)
    name = kw.pop("name", "fp")
    fields = {f.name for f in dataclasses.fields(QuantConfig)}
    bad = sorted(set(kw) - fields)
    if bad:
        raise ValueError(
            f"unknown QuantConfig field(s) {bad} in policy entry; valid "
            f"fields: {sorted(fields)}")
    return _cfg(name, kw)
