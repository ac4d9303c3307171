"""QuantPolicy: declarative per-parameter-group quantization policy, and
the adaptive bit schedule over it (the reference's ``core/policy.py``).

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

ADAPTIVE BIT BUDGET (``BitSchedule`` / ``BitBudgetController``): the same
grammar also carries per-group bit RAMPS, ``family@HI..LO`` tokens whose
wire bit-width is a function of the training step
(``"embed=orq@5..3,default=orq@4..1"``). ``BitSchedule.parse`` takes ramp
tokens and plain scheme names (static entries); ``QuantPolicy.parse``
rejects ramp tokens with a pointer here. A schedule materializes into an
ordinary static ``QuantPolicy`` per PHASE (:meth:`BitSchedule.policy_at`);
the train step specializes its engines at phase boundaries
(``train/step.py:ScheduledTrainStep``) and is bit-identical to the
equivalent static policy within each phase. ``BitBudgetController``
re-solves the per-group bits every ``resolve_every`` steps from cheap
statistics of the exchanged buffers (per-bucket sigma^2, clip fraction,
EF-residual norm) under a global DCN-bytes/step budget.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import (Any, Callable, Dict, List, Mapping, Optional, Tuple,
                    Union)

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
        """The config a :meth:`resolve_ix` result maps to under this policy
        (phase specialization: the same rules, new configs)."""
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


# a scheme token, optionally with a bit-ramp suffix ``@HI..LO`` (or the
# constant shorthand ``@B``): only BitSchedule.parse accepts ramps, but both
# grammars split entries the same way
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
            f"{scheme.strip()!r} is a bit-ramp token (family@HI..LO); "
            f"bit ramps are step-dependent and belong to BitSchedule.parse "
            f"(launcher --bit-schedule), not a static QuantPolicy")
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


# ---------------------------------------------------------------------------
# adaptive bit budget: BitRamp / BitSchedule / BitBudgetController
# ---------------------------------------------------------------------------

_SCHED_GRAMMAR = (
    "bit-schedule grammar: 'pattern=ITEM[,pattern=ITEM...][,default=ITEM]' "
    "where ITEM is a static scheme name OR a ramp 'family@HI..LO' "
    "(wire bits decaying linearly from HI at step 0 to LO at the last "
    "step; 'family@B' is the constant shorthand B..B), e.g. "
    "'embed=orq@5..3,default=orq@4..1'")

_RAMP_RE = re.compile(r"^([A-Za-z0-9_\-]+)@(\d+)(?:\.\.(\d+))?$")


def ramp_levels(bits: int) -> int:
    """Level count a ``bits``-wide wire element carries for the odd-level
    families: s = 2^(b-1)+1 (so ceil(log2 s) == b, see
    ``encode.bits_for_levels``). 1 bit has no odd-level scheme; ramps map
    it to ``minmax2`` (the 2-level unbiased degenerate, Corollary 1.1)."""
    if bits < 1:
        raise ValueError(f"wire bits must be >= 1, got {bits}")
    return 2 if bits == 1 else 2 ** (bits - 1) + 1


@dataclasses.dataclass(frozen=True)
class BitRamp:
    """A step-dependent scheme: ``family`` at ``hi`` wire bits decaying
    linearly to ``lo`` bits over the run. Materializes to a concrete
    ``QuantConfig`` per phase via :meth:`config` (b=1 -> ``minmax2``,
    else ``{family}-{2^(b-1)+1}``)."""

    family: str
    hi: int
    lo: int

    def __post_init__(self):
        if not (1 <= self.lo <= self.hi):
            raise ValueError(
                f"bad bit ramp {self.family}@{self.hi}..{self.lo}: need "
                f"1 <= LO <= HI; {_SCHED_GRAMMAR}")
        if self.hi > 5:
            # the fused encode holds at most kMaxLevels = 17 levels a
            # bucket (csrc/round.cuh, the reference's 32-lane level tile):
            # 5 bits -> s=17 is the largest table it supports
            raise ValueError(
                f"bad bit ramp {self.family}@{self.hi}..{self.lo}: HI must "
                f"be <= 5 (s=17 levels, the fused kernels' level-tile "
                f"contract); {_SCHED_GRAMMAR}")

    def bits_at(self, frac: float) -> int:
        """Linear interpolation: hi at frac=0, lo at frac=1 (round to
        nearest, clamped)."""
        frac = min(max(float(frac), 0.0), 1.0)
        b = int(round(self.hi + (self.lo - self.hi) * frac))
        return max(self.lo, min(self.hi, b))

    def config(self, bits: int, defaults: Mapping[str, Any]) -> QuantConfig:
        bits = max(self.lo, min(self.hi, int(bits)))
        name = ("minmax2" if bits == 1
                else f"{self.family}-{ramp_levels(bits)}")
        return _cfg(name, defaults)

    def describe(self) -> str:
        return (f"{self.family}@{self.hi}" if self.hi == self.lo
                else f"{self.family}@{self.hi}..{self.lo}")


def _sched_item(token: str,
                defaults: Mapping[str, Any]) -> Union[QuantConfig, BitRamp]:
    """One schedule ITEM: a ramp token or a static scheme name."""
    token = token.strip()
    m = _RAMP_RE.fullmatch(token)
    if m is None:
        return _cfg(token, defaults)
    family = m.group(1).strip().lower().replace("_", "-")
    hi = int(m.group(2))
    lo = int(m.group(3)) if m.group(3) is not None else hi
    ramp = BitRamp(family=family, hi=hi, lo=lo)
    # validate both endpoints against the registry NOW (e.g. a family
    # whose level count must be 2^K+1 — _cfg's error names the schemes)
    ramp.config(hi, defaults)
    ramp.config(lo, defaults)
    return ramp


def _check_pattern(pattern: str):
    if not pattern.strip():
        raise ValueError(f"empty schedule pattern; {_SCHED_GRAMMAR}")
    try:
        re.compile(pattern)
    except re.error as e:
        raise ValueError(
            f"bad schedule pattern {pattern!r}: {e}; {_SCHED_GRAMMAR}"
        ) from e


@dataclasses.dataclass(frozen=True)
class BitSchedule:
    """Ordered (pattern -> QuantConfig | BitRamp) rules + default: a
    ``QuantPolicy`` whose per-group wire bit-width is a function of the
    training step.

    It materializes a concrete static ``QuantPolicy`` per PHASE
    (:meth:`policy_at` on the :meth:`assignment` bits tuple); the train
    step specializes its engines at phase boundaries and is bit-identical
    to the equivalent static policy within each phase. ``defaults`` are
    the extra QuantConfig fields (bucket_size, clip_c, ...) applied when a
    ramp materializes."""

    rules: Tuple[Tuple[str, Union[QuantConfig, BitRamp]], ...] = ()
    default: Union[QuantConfig, BitRamp] = QuantConfig(name="fp")
    defaults: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        for pattern, _ in self.rules:
            _check_pattern(pattern)

    # -- constructors ------------------------------------------------------
    @classmethod
    def parse(cls, spec: str, **defaults) -> "BitSchedule":
        """Parse a schedule string (see ``_SCHED_GRAMMAR``); plain scheme
        names make static entries, ``family@HI..LO`` tokens make ramps."""
        spec = spec.strip()
        dflt = tuple(sorted(defaults.items()))
        if "=" not in spec:
            return cls(rules=(), default=_sched_item(spec, defaults),
                       defaults=dflt)
        rules: List[Tuple[str, Any]] = []
        default = None
        for entry in _split_entries(spec):
            pattern, token = (s.strip() for s in entry.rsplit("=", 1))
            if pattern == "default":
                if default is not None:
                    raise ValueError(
                        f"duplicate 'default' entry in schedule {spec!r}")
                default = _sched_item(token, defaults)
            else:
                rules.append((pattern, _sched_item(token, defaults)))
        if default is None:
            default = _cfg("fp", defaults)
        return cls(rules=tuple(rules), default=default, defaults=dflt)

    # -- structure ---------------------------------------------------------
    @property
    def items(self) -> Tuple[Union[QuantConfig, BitRamp], ...]:
        """All entries in rule order, the default LAST — the canonical
        per-entry axis every bits tuple (assignment) aligns with."""
        return tuple(it for _, it in self.rules) + (self.default,)

    @property
    def n_entries(self) -> int:
        return len(self.rules) + 1

    @property
    def is_static(self) -> bool:
        """True when no entry's bit-width actually moves (every ramp is
        degenerate HI==LO) — a single engine serves the whole run."""
        return all(not isinstance(it, BitRamp) or it.hi == it.lo
                   for it in self.items)

    # -- resolution --------------------------------------------------------
    def _frac(self, step: int, total_steps: int) -> float:
        if total_steps <= 1:
            return 0.0
        return min(max(step, 0), total_steps - 1) / (total_steps - 1)

    def assignment(self, step: int, total_steps: int
                   ) -> Tuple[Optional[int], ...]:
        """Per-entry wire bits at ``step`` (None for static entries): the
        tuple that keys the engine LRU."""
        frac = self._frac(step, total_steps)
        return tuple(it.bits_at(frac) if isinstance(it, BitRamp) else None
                     for it in self.items)

    def floor_assignment(self) -> Tuple[Optional[int], ...]:
        return tuple(it.lo if isinstance(it, BitRamp) else None
                     for it in self.items)

    def ceil_assignment(self) -> Tuple[Optional[int], ...]:
        return tuple(it.hi if isinstance(it, BitRamp) else None
                     for it in self.items)

    def policy_at(self, assignment: Tuple[Optional[int], ...]
                  ) -> QuantPolicy:
        """Materialize the concrete static QuantPolicy for one bits
        tuple. All phases share the SAME rule patterns in the SAME order,
        so engines grouped by rule (``PolicyLayout.from_tree(by_rule=
        True)``) keep identical group structure across phases."""
        if len(assignment) != self.n_entries:
            raise ValueError(
                f"assignment length {len(assignment)} != schedule entries "
                f"{self.n_entries}")
        dflt = dict(self.defaults)

        def cfg_of(item, bits):
            if isinstance(item, BitRamp):
                if bits is None:
                    raise ValueError("ramp entry needs a bits value")
                return item.config(bits, dflt)
            return item

        rules = tuple(
            PolicyRule(pattern, cfg_of(item, bits))
            for (pattern, item), bits in zip(self.rules, assignment))
        return QuantPolicy(rules=rules,
                           default=cfg_of(self.default, assignment[-1]))

    def phases(self, total_steps: int, resolve_every: int
               ) -> List[Tuple[int, Tuple[Optional[int], ...]]]:
        """Deduplicated [(start_step, assignment), ...] for the
        deterministic schedule: one entry per distinct engine, in
        execution order. Audit + accounting iterate these."""
        if resolve_every < 1:
            raise ValueError(
                f"resolve_every must be >= 1, got {resolve_every}")
        out: List[Tuple[int, Tuple[Optional[int], ...]]] = []
        for start in range(0, max(total_steps, 1), resolve_every):
            a = self.assignment(start, total_steps)
            if not out or out[-1][1] != a:
                out.append((start, a))
        return out

    def describe(self) -> str:
        parts = [f"{p}={it.describe() if isinstance(it, BitRamp) else it.name}"
                 for p, it in self.rules]
        d = self.default
        parts.append(
            f"default={d.describe() if isinstance(d, BitRamp) else d.name}")
        return ",".join(parts)


class BitBudgetController:
    """Resolves the per-entry wire bits every ``resolve_every`` steps.

    Deterministic baseline: the schedule's linear ramps, quantized to
    phase boundaries (``assignment_at``). With ``dcn_budget_bytes`` set
    (a quantized-DCN bytes/step budget) and per-entry ``group_sizes``
    known, each phase instead GREEDY WATER-FILLS bits from every ramp's
    LO toward its deterministic phase value: the next bit goes to the
    entry with the largest marginal quantization-MSE reduction per DCN
    byte (variance ~ 4^-bits, weighted by the observed per-bucket
    sigma^2 x group size — :meth:`observe` feeds the step's
    ``exchange_stats``), while the assignment's cost stays under budget.
    Static quantized entries are a fixed cost subtracted from the
    budget first; identity (fp) entries don't ride the quantized wire.

    ``cost_fn(policy) -> dcn bytes/step`` optionally replaces the
    payload-only default (size x bits / 8) so the controller prices
    assignments with the SAME accounting the benchmarks report
    (``exchange.policy_link_stats`` — see launch/train.py)."""

    def __init__(self, schedule: BitSchedule, total_steps: int, *,
                 resolve_every: int = 50,
                 dcn_budget_bytes: Optional[float] = None,
                 group_sizes: Optional[Tuple[int, ...]] = None,
                 cost_fn: Optional[Callable[[QuantPolicy], float]] = None):
        if resolve_every < 1:
            raise ValueError(
                f"resolve_every must be >= 1, got {resolve_every}")
        self.schedule = schedule
        self.total_steps = int(total_steps)
        self.resolve_every = int(resolve_every)
        self.dcn_budget_bytes = dcn_budget_bytes
        self.group_sizes = tuple(group_sizes) if group_sizes else None
        self.cost_fn = cost_fn
        self.decisions: List[Dict[str, Any]] = []
        self._stats: Optional[Tuple[Dict[str, float], ...]] = None
        self._phase: Optional[int] = None
        self._cached: Optional[Tuple[Optional[int], ...]] = None

    # -- statistics feed ---------------------------------------------------
    def observe(self, stats) -> None:
        """Feed the latest per-entry statistics rows, aligned with
        ``schedule.items``: each row is a mapping (or indexable triple)
        with ``sigma_sq`` (mean per-bucket gradient variance),
        ``clip_frac`` and ``ef_norm_sq`` — exactly what
        ``PartitionedExchange.group_stats`` emits per group."""
        rows = []
        for r in stats:
            if isinstance(r, Mapping):
                rows.append({"sigma_sq": float(r.get("sigma_sq", 0.0)),
                             "clip_frac": float(r.get("clip_frac", 0.0)),
                             "ef_norm_sq": float(r.get("ef_norm_sq", 0.0))})
            else:
                vals = [float(v) for v in r]
                vals += [0.0] * (3 - len(vals))
                rows.append({"sigma_sq": vals[0], "clip_frac": vals[1],
                             "ef_norm_sq": vals[2]})
        if len(rows) != self.schedule.n_entries:
            raise ValueError(
                f"stats rows {len(rows)} != schedule entries "
                f"{self.schedule.n_entries}")
        self._stats = tuple(rows)

    # -- resolution --------------------------------------------------------
    def phase_start(self, step: int) -> int:
        return (max(int(step), 0) // self.resolve_every) * self.resolve_every

    def assignment_at(self, step: int) -> Tuple[Optional[int], ...]:
        """The bits tuple governing ``step`` (cached per phase; appends a
        decision record the first time each phase is resolved)."""
        start = self.phase_start(step)
        if self._phase == start and self._cached is not None:
            return self._cached
        a = self._solve(start)
        self._phase, self._cached = start, a
        self.decisions.append({
            "step": start,
            "bits": list(a),
            "est_dcn_bytes": self._assignment_bytes(a),
            "budget": self.dcn_budget_bytes,
            "stats_driven": self._stats is not None
            and self.dcn_budget_bytes is not None
            and self.group_sizes is not None,
        })
        return a

    def _assignment_bytes(self, assignment) -> Optional[float]:
        if self.group_sizes is None:
            return None
        if self.cost_fn is not None:
            return float(self.cost_fn(self.schedule.policy_at(assignment)))
        total = 0.0
        for item, bits, n in zip(self.schedule.items, assignment,
                                 self.group_sizes):
            if isinstance(item, BitRamp):
                total += n * bits / 8.0
            elif item.name != "fp":
                total += n * item.to_quantizer().wire_bits_per_element / 8.0
        return total

    def _solve(self, start: int) -> Tuple[Optional[int], ...]:
        det = self.schedule.assignment(start, self.total_steps)
        if self.dcn_budget_bytes is None or self.group_sizes is None:
            return det
        items = self.schedule.items
        # start every ramp at LO; static entries are fixed
        bits = [it.lo if isinstance(it, BitRamp) else None for it in items]
        sizes = self.group_sizes

        def weight(i):
            if self._stats is not None:
                s = self._stats[i]
                # importance of one more bit for entry i: observed bucket
                # variance x element count (EF pressure folded in — a
                # group whose residual keeps growing is under-quantized)
                return ((s["sigma_sq"] + s["ef_norm_sq"] / max(sizes[i], 1))
                        * sizes[i]) or float(sizes[i])
            return float(sizes[i])

        def cost():
            return self._assignment_bytes(
                tuple(b if b is not None else None for b in bits))

        blocked: set = set()
        while True:
            best, best_gain = None, 0.0
            for i, it in enumerate(items):
                if (not isinstance(it, BitRamp) or sizes[i] == 0
                        or i in blocked):
                    continue
                cap = det[i] if det[i] is not None else it.hi
                if bits[i] >= cap:
                    continue
                # MSE(b) ~ 4^-b: marginal gain per byte of the extra bit
                gain = weight(i) * (4.0 ** -bits[i] - 4.0 ** -(bits[i] + 1))
                gain /= max(sizes[i] / 8.0, 1e-9)
                if gain > best_gain:
                    best, best_gain = i, gain
            if best is None:
                break
            bits[best] += 1
            if cost() > self.dcn_budget_bytes:
                # this entry's next bit doesn't fit; a smaller group's might
                bits[best] -= 1
                blocked.add(best)
        return tuple(bits[i] if isinstance(items[i], BitRamp) else None
                     for i in range(len(items)))
