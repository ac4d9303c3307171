"""The port's adaptive bit schedule (``core/policy.py``: ``BitRamp``,
``BitSchedule``, ``BitBudgetController``) and its statistics feed against
the JAX reference, in process.

* The grammar: parsing, ``describe``, ``is_static``, the per-step
  ``assignment``, the floor and ceiling, ``phases`` and every
  ``policy_at`` materialization equal the reference's over its own test's
  specs; the refusals are the reference's.
* The controller: given the same injected statistics, the same decisions
  (bits, ``est_dcn_bytes``, ``stats_driven``), with and without a budget.
* The bytes the launcher's ``cost_fn`` prices: the per-link accounting of
  smoke lm-100m, bucket 2048, ``norm|bias=fp`` on the benchmark's flat
  4-worker link, from a policy and from a by-rule skeleton specialized per
  phase, equal ``benchmarks/BENCH_convergence.json`` exactly.
* By-rule grouping, ``with_configs`` and ``specialize`` keep the groups
  (and so the EF sizes) of the reference.
* ``wire.encode_stats``, ``PartitionedExchange.group_stats`` and
  ``FsdpExchange.group_stats_stored`` within STATS_RTOL of the
  reference's: f32 row reductions summed in another order.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core import comm as jcomm
from repro.core import make_quantizer as jmake_quantizer
from repro.core import policy as jpolicy
from repro.models.model import LM as JLM
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import policy
from repro_torch.core.api import make_quantizer
from repro_torch.core.comm import exchange, wire
from repro_torch.core.comm.fsdp_exchange import FsdpExchange
from repro_torch.models import LM
from repro_torch.utils.pytree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS_RTOL = 1e-5

SPECS = ["embed=orq@5..3,norm|bias=fp,default=orq@4..1", "default=orq@4",
         "norm=fp,default=orq@5..1", "default=orq@4..3", "orq@5..1",
         "embed=orq@3,default=terngrad", "norm|bias=fp,default=orq@4",
         "w=orq@2..1,default=orq-9"]


def _cfg_row(cfg):
    return (cfg.name, cfg.bucket_size, cfg.clip_c, cfg.server_requant)


def _item_row(it):
    if isinstance(it, (policy.BitRamp, jpolicy.BitRamp)):
        return ("ramp", it.family, it.hi, it.lo, it.describe())
    return ("static",) + _cfg_row(it)


def _policy_rows(pol):
    return ([(r.pattern,) + _cfg_row(r.cfg) for r in pol.rules]
            + [_cfg_row(pol.default)])


@pytest.mark.parametrize("bucket", [None, 512])
@pytest.mark.parametrize("spec", SPECS)
def test_schedule_matches_reference(spec, bucket):
    kw = {} if bucket is None else {"bucket_size": bucket}
    got, want = (policy.BitSchedule.parse(spec, **kw),
                 jpolicy.BitSchedule.parse(spec, **kw))
    assert got.describe() == want.describe()
    assert policy.BitSchedule.parse(got.describe(), **kw).describe() == \
        got.describe()
    assert got.n_entries == want.n_entries
    assert got.is_static == want.is_static
    assert [_item_row(i) for i in got.items] == \
        [_item_row(i) for i in want.items]
    assert got.floor_assignment() == want.floor_assignment()
    assert got.ceil_assignment() == want.ceil_assignment()
    seen = set()
    for total in (1, 2, 7, 100):
        for step in range(-1, total + 2):
            a = got.assignment(step, total)
            assert a == want.assignment(step, total), (step, total)
            seen.add(a)
        for every in (1, 3, 25):
            assert got.phases(total, every) == want.phases(total, every)
    for a in seen:
        assert _policy_rows(got.policy_at(a)) == \
            _policy_rows(want.policy_at(a))


@pytest.mark.parametrize("spec", [
    "default=orq@6..2", "default=orq@2..4", "default=orq@4..0",
    "default=bogus@4", "default=orq@4,default=fp", "=orq@4", "",
    "x(=orq@4"])
def test_schedule_rejects_like_reference(spec):
    with pytest.raises(ValueError) as want:
        jpolicy.BitSchedule.parse(spec)
    with pytest.raises(ValueError) as got:
        policy.BitSchedule.parse(spec)
    if "<= 5" in str(want.value):
        assert "<= 5" in str(got.value)


def test_ramp_levels_and_refusals_match_reference():
    for b in range(1, 7):
        assert policy.ramp_levels(b) == jpolicy.ramp_levels(b)
    with pytest.raises(ValueError, match="bits must be >= 1"):
        policy.ramp_levels(0)
    s = policy.BitSchedule.parse("norm=fp,default=orq@5..1")
    with pytest.raises(ValueError, match="length"):
        s.policy_at((None, 5, 4))
    with pytest.raises(ValueError, match="resolve_every"):
        s.phases(10, 0)
    with pytest.raises(ValueError, match="bit-ramp token"):
        policy.QuantPolicy.parse("default=orq@5..1")


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

_NAME_BITS = {"minmax2": 1, "orq-3": 2, "orq-5": 3, "orq-9": 4, "orq-17": 5}


def _bit_cost(sizes):
    """cost_fn pricing a phase policy at bits-proportional bytes (the
    reference test's)."""
    def fn(pol):
        cfgs = [r.cfg for r in pol.rules] + [pol.default]
        return sum(_NAME_BITS.get(c.name, 0) * n / 8.0
                   for c, n in zip(cfgs, sizes))
    return fn


STATS_A = [{"sigma_sq": 10.0, "clip_frac": 0.0, "ef_norm_sq": 0.0},
           {"sigma_sq": 0.01, "clip_frac": 0.0, "ef_norm_sq": 0.0}]
STATS_B = [(0.5, 0.1, 3e4), (2.0, 0.0)]

CONTROLLERS = {
    # the reference test's cases
    "deterministic": ("norm=fp,default=orq@5..1", 100, 25, None, None,
                      False, None),
    "budget": ("embed=orq@5..1,default=orq@5..1", 100, 50, 6 * 1000 / 8.0,
               (1000, 1000), True, None),
    "variance": ("embed=orq@5..1,default=orq@5..1", 100, 50,
                 5 * 1000 / 8.0, (1000, 1000), True, STATS_A),
    "blocked": ("embed=orq@5..1,default=orq@5..1", 100, 50,
                (10000 + 5 * 100) / 8.0, (100, 10000), True, None),
    # the payload-only default cost, EF pressure in the weights
    "payload": ("embed=orq@5..2,default=orq@4..1", 40, 7, 9000.0,
                (10000, 30000), False, STATS_B),
    "static_entry": ("norm=orq-9,default=orq@5..1", 30, 4, 6000.0,
                     (4000, 8000), False, STATS_B),
}


@pytest.mark.parametrize("case", sorted(CONTROLLERS))
def test_controller_decisions_match_reference(case):
    spec, total, every, budget, sizes, priced, stats = CONTROLLERS[case]
    ctls = []
    for mod in (policy, jpolicy):
        kw = dict(resolve_every=every, dcn_budget_bytes=budget,
                  group_sizes=sizes)
        if priced:
            kw["cost_fn"] = _bit_cost(sizes)
        ctls.append(mod.BitBudgetController(mod.BitSchedule.parse(spec),
                                            total, **kw))
    got, want = ctls
    for step in range(total):
        if stats is not None and step == every:
            got.observe(stats)
            want.observe(stats)
        assert got.assignment_at(step) == want.assignment_at(step), step
    assert got.decisions == want.decisions
    assert len(got.decisions) == -(-total // every)
    if budget is not None and sizes is not None:
        assert all(d["est_dcn_bytes"] <= budget for d in got.decisions)


def test_controller_refusals_match_reference():
    for mod in (policy, jpolicy):
        s = mod.BitSchedule.parse("norm=fp,default=orq@5..1")
        with pytest.raises(ValueError, match="stats rows"):
            mod.BitBudgetController(s, 100).observe([{"sigma_sq": 1.0}])
        with pytest.raises(ValueError, match="resolve_every"):
            mod.BitBudgetController(s, 100, resolve_every=0)


# ---------------------------------------------------------------------------
# the launcher's pricing: BENCH_convergence.json's bytes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    model = LM(get_smoke_config("lm-100m"))
    ap = model.abstract_params()
    paths = model.param_paths(ap)
    ps = [(p, int(x.numel())) for p, x in zip(tree_leaves(paths),
                                                tree_leaves(ap))]
    return model, ap, paths, ps


def _bench():
    with open(os.path.join(ROOT, "benchmarks", "BENCH_convergence.json")) as f:
        return json.load(f)


def test_cost_fn_bytes_equal_bench_convergence(smoke):
    model, ap, paths, ps = smoke
    d = _bench()
    acc = d["accounting"]
    assert (acc["n_intra"], acc["n_inter"], acc["two_level"]) == (1, 4, False)
    kw = dict(n_intra=1, n_inter=4, two_level=False)
    want = {"orq-17": 301_560, "orq-9": 222_600, "orq-5": 176_400}
    sched = policy.BitSchedule.parse(d["schedule"],
                                     bucket_size=d["bucket_size"])
    skeleton = exchange.PartitionedExchange.build(
        sched.policy_at(sched.ceil_assignment()), ap, paths=paths,
        by_rule=True)
    for name, nbytes in want.items():
        pol = policy.QuantPolicy.parse(d["static"][name]["policy"],
                                       bucket_size=d["bucket_size"])
        st, _ = exchange.policy_link_stats(pol, ps, **kw)
        assert st["dcn_q_bytes"] == nbytes == \
            d["static"][name]["dcn_bytes_per_step"]
    by_bits = {}
    for bits in (5, 4, 3, 2):
        phase = sched.policy_at((None, bits))
        st, _ = exchange.policy_link_stats(phase, ps, **kw)
        obs, rows = exchange.observed_link_stats(
            skeleton.specialize(phase), n_intra=1, n_inter=4)
        assert obs["dcn_q_bytes"] == st["dcn_q_bytes"]
        assert [r["rule_id"] for r in rows] == [1, 0]
        by_bits[bits] = st["dcn_q_bytes"]
    assert by_bits == {5: 301_560, 4: 222_600, 3: 176_400, 2: 110_040}
    for dec in d["dynamic"]["decisions"]:
        assert by_bits[dec["bits"][1]] == dec["est_dcn_bytes"]


# ---------------------------------------------------------------------------
# by-rule grouping and phase specialization
# ---------------------------------------------------------------------------

def _groups(layout):
    return [(g.cfg.name, g.leaf_ids, g.size, g.rule_id)
            for g in layout.groups]


@pytest.mark.parametrize("spec", ["norm|bias=fp,default=orq-9",
                                  "embed=orq-9,lm_head=orq-9,default=fp",
                                  "orq-9"])
@pytest.mark.parametrize("by_rule", [False, True])
def test_policy_layout_groups_match_reference(smoke, spec, by_rule):
    model, ap, paths, _ = smoke
    jm = JLM(jget_smoke_config("lm-100m"))
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    pol = policy.QuantPolicy.parse(spec)
    jpol = jpolicy.QuantPolicy.parse(spec)
    got = exchange.PolicyLayout.from_tree(ap, pol, paths=paths,
                                          by_rule=by_rule)
    want = jcomm.PolicyLayout.from_tree(shapes, jpol,
                                        paths=jm.param_paths(shapes),
                                        by_rule=by_rule)
    assert _groups(got) == _groups(want)
    if by_rule:
        phase = policy.QuantPolicy.parse(spec.replace("orq-9", "orq-3"))
        jphase = jpolicy.QuantPolicy.parse(spec.replace("orq-9", "orq-3"))
        assert _groups(got.with_configs(phase)) == \
            _groups(want.with_configs(jphase))
    else:
        with pytest.raises(ValueError, match="by_rule"):
            got.with_configs(pol)


def test_specialize_keeps_groups_and_ef_sizes(smoke):
    """Two ramps that materialize onto one scheme stay two groups; the
    fsdp skeleton keeps its sharded / replicated split and EF sizes."""
    model, ap, paths, _ = smoke
    sched = policy.BitSchedule.parse("embed=orq@5..2,default=orq@4..2")
    skel = exchange.PartitionedExchange.build(
        sched.policy_at(sched.ceil_assignment()), ap, paths=paths,
        by_rule=True)
    low = skel.specialize(sched.policy_at((2, 2)))
    assert [e.qz.s for e in skel.engines] == [17, 9]
    assert [e.qz.s for e in low.engines] == [3, 3]
    assert low.ef_shard_sizes(1) == skel.ef_shard_sizes(1)
    assert [g.leaf_ids for g in low.layout.groups] == \
        [g.leaf_ids for g in skel.layout.groups]
    by_cfg = exchange.PartitionedExchange.build(
        sched.policy_at((2, 2)), ap, paths=paths)
    assert len(by_cfg.engines) == 1
    from repro_torch.train.step import plan_sharding_shapes
    plan = plan_sharding_shapes(model, ap, dp_axes=("data",),
                                axis_sizes={"data": 2})
    fex = FsdpExchange.build(
        sched.policy_at(sched.ceil_assignment()), ap, paths=paths,
        shard_dims=plan.full_shard_dims(), n_shards=2, by_rule=True)
    fl = fex.specialize(sched.policy_at((2, 2)))
    assert fl.ef_group_sizes() == fex.ef_group_sizes()
    assert [(g.sharded, g.rule_id) for g in fl.layout.groups] == \
        [(g.sharded, g.rule_id) for g in fex.layout.groups]
    assert {e.qz.s for e in fl.engines} == {3}


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme,clip,n", [("orq-9", None, 5000),
                                           ("orq-9", 2.5, 4096),
                                           ("terngrad", 2.5, 777),
                                           ("minmax2", None, 3)])
def test_encode_stats_match_reference(scheme, clip, n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    x[:: 97] *= 40
    qz = make_quantizer(scheme, bucket_size=512, clip_c=clip)
    jqz = jmake_quantizer(scheme, bucket_size=512, clip_c=clip)
    d = wire.bucket_len(n, 512)
    got = wire.encode_stats(qz, torch.from_numpy(x), d).numpy()
    want = np.asarray(jcomm.wire.encode_stats(jqz, jnp.asarray(x), d))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=STATS_RTOL)
    if clip is not None:
        assert got[1] > 0


def test_group_stats_match_reference(smoke):
    model, ap, paths, _ = smoke
    jm = JLM(jget_smoke_config("lm-100m"))
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    spec = "norm|bias=fp,embed=orq-5,default=orq-9"
    pex = exchange.PartitionedExchange.build(
        policy.QuantPolicy.parse(spec, bucket_size=512), ap, paths=paths,
        by_rule=True)
    jpex = jcomm.PartitionedExchange.build(
        jpolicy.QuantPolicy.parse(spec, bucket_size=512), shapes, ("data",),
        paths=jm.param_paths(shapes), by_rule=True)
    rng = np.random.default_rng(5)
    bufs = [rng.standard_normal(g.size).astype(np.float32)
            for g in pex.layout.groups]
    ef = [None if e.qz.is_identity else
          rng.standard_normal(g.size).astype(np.float32)
          for e, g in zip(pex.engines, pex.layout.groups)]
    got = pex.group_stats([torch.from_numpy(b) for b in bufs],
                          [None if e is None else torch.from_numpy(e)
                           for e in ef]).numpy()
    want = np.asarray(jpex.group_stats(
        [jnp.asarray(b) for b in bufs],
        [None if e is None else jnp.asarray(e) for e in ef]))
    assert got.shape == want.shape == (3, 3)
    np.testing.assert_allclose(got, want, rtol=STATS_RTOL)
    np.testing.assert_allclose(
        pex.group_stats([torch.from_numpy(b) for b in bufs]).numpy(),
        np.asarray(jpex.group_stats([jnp.asarray(b) for b in bufs])),
        rtol=STATS_RTOL)


def test_group_stats_stored_match_reference(smoke):
    from repro.train.step import plan_sharding_shapes as jplan
    from repro_torch.train.step import plan_sharding_shapes
    model, ap, paths, _ = smoke
    jm = JLM(jget_smoke_config("lm-100m"))
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    spec = "norm|bias=fp,default=orq-9"
    plan = plan_sharding_shapes(model, ap, dp_axes=("data",),
                                axis_sizes={"data": 2})
    jp = jplan(jm, shapes, dp_axes=("data",),
               axis_sizes={"data": 2, "model": 1})
    fex = FsdpExchange.build(policy.QuantPolicy.parse(spec, bucket_size=512),
                             ap, paths=paths,
                             shard_dims=plan.full_shard_dims(), n_shards=2,
                             by_rule=True)
    jfex = jcomm.FsdpExchange.build(
        jpolicy.QuantPolicy.parse(spec, bucket_size=512), shapes, ("data",),
        paths=jp.paths, shard_dims=jp.full_shard_dims(), n_shards=2,
        by_rule=True)
    rng = np.random.default_rng(9)
    stored = []
    for s in fex.layout.slots:
        shape = list(s.shape)
        if s.dim is not None:
            shape[s.dim] //= 2
        stored.append(rng.standard_normal(shape).astype(np.float32))
    ef = [None if e is None else rng.standard_normal(e).astype(np.float32)
          for e in fex.ef_group_sizes()]
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes), [jnp.asarray(x)
                                               for x in stored])
    from repro_torch.utils.pytree import tree_unflatten
    got = fex.group_stats_stored(
        tree_unflatten(ap, [torch.from_numpy(x) for x in stored]),
        [None if e is None else torch.from_numpy(e) for e in ef]).numpy()
    want = np.asarray(jfex.group_stats_stored(
        tree, [None if e is None else jnp.asarray(e) for e in ef]))
    assert got.shape == want.shape == (len(fex.layout.groups), 3)
    np.testing.assert_allclose(got, want, rtol=STATS_RTOL)
