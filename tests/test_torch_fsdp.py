"""The port's fused FSDP (ZeRO-3) exchange against the JAX reference.

* Sharding plan, layout and accounting (mesh-free): the fsdp dims of every
  lm-100m leaf, the group sizes, collective launches, wire bytes per
  worker and EF buffer sizes equal the reference's for every registry
  scheme at L = 1, 2 and 4 (and the lm-100m numbers of the bring-up
  table exactly); the worker-major buffers of a carried-over tree equal
  the reference's ``flatten_groups`` bit for bit, and
  ``unflatten_outputs`` hands each worker its own shard.
* Collectives: ``FsdpExchange.exchange_with_residuals`` (with error
  feedback), ``exchange_bufs`` and ``residual_bufs`` on 4 gloo processes
  against the reference on 4 fake XLA devices, for orq-9 and BinGrad-b on
  the smoke LM's plan and for the reference's mixed toy (a replicated fp
  leaf and a sharded orq-9 one). The buffers are multiples of 1/64 in
  [-1, 1]: every sum of the level fits is then exact in float32 in any
  order, so everything must be bit-equal.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core import comm as jcomm
from repro.core.policy import QuantPolicy as JPolicy
from repro.models.model import LM as JLM
from repro.train.step import plan_sharding_shapes as jplan_sharding_shapes
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.api import all_methods
from repro_torch.core.comm.fsdp_exchange import FsdpExchange, FsdpLayout
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import LM
from repro_torch.train.step import plan_sharding_shapes
from repro_torch.utils import sharding
from torch_test_env import port_test_env  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 4


def _jplan(jmodel, shapes, n, pods=1):
    dp = ("data",) if pods == 1 else ("pod", "data")
    sizes = ({"data": n, "model": 1} if pods == 1
             else {"pod": pods, "data": n // pods, "model": 1})
    return jplan_sharding_shapes(jmodel, shapes, dp_axes=dp,
                                 axis_sizes=sizes)


def _plan(model, ap, n, pods=1):
    dp = ("data",) if pods == 1 else ("pod", "data")
    sizes = {"data": n} if pods == 1 else {"pod": pods, "data": n // pods}
    return plan_sharding_shapes(model, ap, dp_axes=dp, axis_sizes=sizes)


@pytest.fixture(scope="module")
def lm100m():
    jmodel = JLM(jget_config("lm-100m"))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0))
    model = LM(get_config("lm-100m"))
    return jmodel, shapes, model, model.abstract_params()


# ---------------------------------------------------------------------------
# sharding helpers, plan, layout and accounting (in process)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,n,prefer", [
    ((768, 2304), 4, (768,)), ((12, 768, 3072), 4, (768,)),
    ((2304, 768), 8, ()), ((10, 3), 4, ()), ((7,), 1, (5,)),
    ((3, 8, 5), 4, (3,))])
def test_sharding_helpers_match_reference(shape, n, prefer):
    from jax.sharding import PartitionSpec as P
    from repro.utils import sharding as jsharding
    want = jsharding.choose_fsdp_dim(shape, n, prefer_sizes=prefer)
    assert sharding.choose_fsdp_dim(shape, n, prefer_sizes=prefer) == want
    for dp in (("data",), ("pod", "data")):
        jspec = jsharding.leaf_fsdp_spec(shape, n, dp, prefer_sizes=prefer)
        spec = sharding.leaf_fsdp_spec(shape, n, dp, prefer_sizes=prefer)
        assert spec == tuple(jspec)
        assert sharding.spec_dp_dim(spec, dp) == \
            jsharding.spec_dp_dim(P(*jspec), dp)
    assert sharding.dp_axis_names(("model", "data", "pod")) == \
        jsharding.DP_AXIS_ORDER


@pytest.mark.parametrize("n,pods", [(1, 1), (2, 1), (4, 1), (4, 2)])
def test_plan_matches_reference(lm100m, n, pods):
    jmodel, shapes, model, ap = lm100m
    jp, p = _jplan(jmodel, shapes, n, pods), _plan(model, ap, n, pods)
    assert p.full_shard_dims() == jp.full_shard_dims()
    assert p.gather_dims == jp.gather_dims
    assert p.n_dp == jp.n_dp == n and p.dp_axes == jp.dp_axes
    specs = jax.tree_util.tree_leaves(
        jp.specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for path, spec in zip(jax.tree_util.tree_leaves(jp.paths), specs):
        assert p.specs[path] == tuple(spec)


def test_lm100m_shards_every_leaf_on_d_model(lm100m):
    """At L <= 4 every lm-100m leaf divides on its d_model (768) dim."""
    _, _, model, ap = lm100m
    for n in (1, 2, 4):
        dims = _plan(model, ap, n).full_shard_dims()
        assert all(d is not None for d in dims.values())
        want = {"embed": 1, "lm_head": 0, "final_norm": 0}
        for path, d in dims.items():
            if path in want:
                assert d == want[path], path
            elif path.endswith("['wo']") and "ffn" in path:
                assert d == 2, path
            else:
                assert d == 1, path


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("scheme", all_methods())
def test_fsdp_accounting_matches_reference(lm100m, scheme, n):
    jmodel, shapes, model, ap = lm100m
    jp, p = _jplan(jmodel, shapes, n), _plan(model, ap, n)
    jfex = jcomm.FsdpExchange.build(
        JPolicy.parse(scheme), shapes, ("data",), paths=jp.paths,
        shard_dims=jp.full_shard_dims(), n_shards=n)
    fex = FsdpExchange.build(
        QuantPolicy.parse(scheme), ap, ("data",), paths=p.paths,
        shard_dims=p.full_shard_dims(), n_shards=n)
    assert [(g.cfg.name, g.sharded, g.size, g.leaf_ids)
            for g in fex.layout.groups] == \
        [(g.cfg.name, g.sharded, g.size, g.leaf_ids)
         for g in jfex.layout.groups]
    assert [(s.path, s.shape, s.dim, s.offset, s.size)
            for s in fex.layout.slots] == \
        [(s.path, s.shape, s.dim, s.offset, s.size)
         for s in jfex.layout.slots]
    assert fex.collective_launches() == jfex.collective_launches()
    assert fex.wire_bytes_per_worker() == jfex.wire_bytes_per_worker()
    assert fex.ef_group_sizes() == jfex.ef_group_sizes()
    assert fex.quantized_group_count() == jfex.quantized_group_count()
    assert fex.link_bytes_per_worker() == jfex.link_bytes_per_worker()


# lm-100m, bucket 2048: (launches, wire bytes per worker, EF sizes)
LM100M_FSDP = {("orq-9", 1): (2, 70_021_480, (135_285_504,)),
               ("orq-9", 4): (2, 70_023_600, (135_285_504,)),
               ("bingrad-b", 1): (2, 17_439_312, (135_285_504,)),
               ("bingrad-b", 4): (2, 17_439_840, (135_285_504,)),
               ("fp", 1): (1, 541_142_016, (None,)),
               ("fp", 4): (1, 541_142_016, (None,))}


@pytest.mark.parametrize("row", sorted(LM100M_FSDP))
def test_lm100m_fsdp_table(lm100m, row):
    scheme, n = row
    _, _, model, ap = lm100m
    p = _plan(model, ap, n)
    fex = FsdpExchange.build(QuantPolicy.parse(scheme, bucket_size=2048), ap,
                             ("data",), paths=p.paths,
                             shard_dims=p.full_shard_dims(), n_shards=n)
    assert len(fex.layout.groups) == 1 and fex.layout.groups[0].sharded
    assert (fex.collective_launches(), fex.wire_bytes_per_worker(),
            fex.ef_group_sizes()) == LM100M_FSDP[row]


def _toy(n_shards=L, fp_b=True):
    """The reference's toy: {"b": (40,) replicated, "w": (16, 56) sharded
    on dim 0}, policy b=fp (or orq-9), default orq-9, bucket 64."""
    spec = "b=fp,default=orq-9" if fp_b else "orq-9"
    tree = {"b": torch.empty(40, device="meta"),
            "w": torch.empty(16, 56, device="meta")}
    lay = FsdpLayout.from_tree(
        tree, QuantPolicy.parse(spec, bucket_size=64),
        paths={"b": "b", "w": "w"}, shard_dims={"b": None, "w": 0},
        n_shards=n_shards)
    return lay, tree


def test_toy_grouping_and_sizes():
    lay, _ = _toy()
    assert [(g.cfg.name, g.sharded, g.size) for g in lay.groups] == \
        [("fp", False, 40), ("orq-9", True, 16 * 56)]
    assert lay.size == 40 + 16 * 56 and lay.leaf_group == (0, 1)


def test_indivisible_leaf_rejected():
    with pytest.raises(ValueError, match="not divisible"):
        FsdpLayout.from_tree({"w": torch.empty(10, 3, device="meta")},
                             QuantPolicy.parse("orq-9"), paths={"w": "w"},
                             shard_dims={"w": 0}, n_shards=4)


def test_rows_are_worker_shards_and_outputs_invert_them():
    lay, _ = _toy()
    g = torch.Generator().manual_seed(0)
    w, b = torch.randn(16, 56, generator=g), torch.randn(40, generator=g)
    bufs = lay.flatten_groups({"b": b, "w": w})
    assert torch.equal(bufs[0], b)
    rows = bufs[1].reshape(L, -1)
    for wk in range(L):
        assert torch.equal(rows[wk], w[wk * 4:(wk + 1) * 4].reshape(-1))
        out = lay.unflatten_outputs([bufs[0], rows[wk]])
        assert torch.equal(out["b"], b)
        assert torch.equal(out["w"], w[wk * 4:(wk + 1) * 4])
    shards = lay.shard_leaves([b, w], 2)
    assert torch.equal(shards[1], w[8:12]) and torch.equal(shards[0], b)


def test_moveaxis_dim_round_trip():
    lay = FsdpLayout.from_tree({"w": torch.empty(3, 8, 5, device="meta")},
                               QuantPolicy.parse("fp"), paths={"w": "w"},
                               shard_dims={"w": 1}, n_shards=L)
    w = torch.randn(3, 8, 5, generator=torch.Generator().manual_seed(4))
    rows = lay.flatten_groups({"w": w})[0].reshape(L, -1)
    for wk in range(L):
        out = lay.unflatten_outputs([rows[wk]])
        assert torch.equal(out["w"], w[:, wk * 2:(wk + 1) * 2])


def test_smoke_buffers_equal_reference():
    """The smoke LM's worker-major group buffers (mixed policy: an fp
    group and an orq-9 group) and the outputs' unflatten equal the
    reference's bit for bit."""
    spec = "norm|bias=fp,default=orq-9"
    jmodel = JLM(jget_smoke_config("lm-100m"))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0))
    model = LM(get_smoke_config("lm-100m"))
    ap = model.abstract_params()
    jp, p = _jplan(jmodel, shapes, L), _plan(model, ap, L)
    jlay = jcomm.FsdpLayout.from_tree(
        shapes, JPolicy.parse(spec), paths=jp.paths,
        shard_dims=jp.full_shard_dims(), n_shards=L)
    lay = FsdpLayout.from_tree(ap, QuantPolicy.parse(spec), paths=p.paths,
                               shard_dims=p.full_shard_dims(), n_shards=L)
    rng = np.random.default_rng(3)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    jb = jlay.flatten_groups(jax.tree_util.tree_map(jnp.asarray, tree))
    tb = lay.flatten_groups(params_from_jax(tree, device="cpu"))
    assert len(jb) == len(tb) == 2
    for a, w in zip(tb, jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    for wk in (0, 3):
        outs = [b.reshape(L, -1)[wk] if g.sharded else b
                for b, g in zip(tb, lay.groups)]
        jouts = [jnp.asarray(o.numpy()) for o in outs]
        got = jax.tree_util.tree_leaves(lay.unflatten_outputs(outs))
        want = jax.tree_util.tree_leaves(jlay.unflatten_outputs(jouts))
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# collectives: 4 gloo processes against 4 fake devices
# ---------------------------------------------------------------------------

CASES = {"orq9": ("orq-9", 512), "bingrad_b": ("bingrad-b", 512),
         "mixed": ("b=fp,default=orq-9", 64)}

JAX_PROG = """
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs.base import get_smoke_config
from repro.core import comm
from repro.core.policy import QuantPolicy
from repro.models.model import LM
from repro.train.step import plan_sharding_shapes
from repro.utils.compat import shard_map

CASES, out_path, in_path = {cases!r}, sys.argv[1], sys.argv[2]
mesh = jax.make_mesh((4,), ("data",))
model = LM(get_smoke_config("lm-100m"))
shapes = jax.eval_shape(model.init, jax.random.key(0))
plan = plan_sharding_shapes(model, shapes, dp_axes=("data",),
                            axis_sizes={{"data": 4, "model": 1}})
toy = {{"b": jax.ShapeDtypeStruct((40,), jnp.float32),
       "w": jax.ShapeDtypeStruct((16, 56), jnp.float32)}}
data = np.load(in_path)
res = {{}}
for name, (spec, bucket) in CASES.items():
    pol = QuantPolicy.parse(spec, bucket_size=bucket)
    if name == "mixed":
        fex = comm.FsdpExchange.build(pol, toy, ("data",),
                                      paths={{"b": "b", "w": "w"}},
                                      shard_dims={{"b": None, "w": 0}},
                                      n_shards=4)
    else:
        fex = comm.FsdpExchange.build(pol, shapes, ("data",),
                                      paths=plan.paths,
                                      shard_dims=plan.full_shard_dims(),
                                      n_shards=4)
    ng = len(fex.layout.groups)
    sizes = fex.ef_group_sizes()

    def body(*xs):
        bufs, efs = [x[0] for x in xs[:ng]], [x[0] for x in xs[ng:]]
        wid = jax.lax.axis_index("data")
        key = jax.random.key(7)
        it = iter(efs)
        ef = tuple(None if n is None else next(it) for n in sizes)
        outs, new_ef = fex.exchange_with_residuals(bufs, key, wid, ef)
        plain = fex.exchange_bufs(bufs, key, wid)
        res_ = fex.residual_bufs(bufs, key, wid)
        parts = list(outs) + [e for e in new_ef if e is not None]
        parts += list(plain) + [r for r in res_ if r is not None]
        return jnp.concatenate(parts)[None]

    n_in = ng + sum(n is not None for n in sizes)
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),) * n_in,
                           out_specs=P("data"), axis_names={{"data"}},
                           check_vma=False))
    ins = [jnp.asarray(data[f"{{name}}/g{{i}}"]) for i in range(ng)]
    ins += [jnp.asarray(data[f"{{name}}/e{{i}}"]) for i, n in
            enumerate(sizes) if n is not None]
    res[name] = np.asarray(fn(*ins))
np.savez(out_path, **res)
"""

TORCH_PROG = """
import sys, numpy as np, torch, torch.distributed as dist
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import prng
from repro_torch.core.comm.fsdp_exchange import FsdpExchange
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import LM
from repro_torch.train.step import plan_sharding_shapes

CASES = {cases!r}
rank, out_path, in_path, rdv = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=4)
model = LM(get_smoke_config("lm-100m"))
ap = model.abstract_params()
plan = plan_sharding_shapes(model, ap, dp_axes=("data",),
                            axis_sizes={{"data": 4}})
toy = {{"b": torch.empty(40, device="meta"),
       "w": torch.empty(16, 56, device="meta")}}
data = np.load(in_path)
res = {{}}
for name, (spec, bucket) in CASES.items():
    pol = QuantPolicy.parse(spec, bucket_size=bucket)
    if name == "mixed":
        fex = FsdpExchange.build(pol, toy, ("data",),
                                 paths={{"b": "b", "w": "w"}},
                                 shard_dims={{"b": None, "w": 0}}, n_shards=4)
    else:
        fex = FsdpExchange.build(pol, ap, ("data",), paths=plan.paths,
                                 shard_dims=plan.full_shard_dims(),
                                 n_shards=4)
    ng = len(fex.layout.groups)
    sizes = fex.ef_group_sizes()
    bufs = [torch.from_numpy(data[f"{{name}}/g{{i}}"][rank].copy())
            for i in range(ng)]
    ef = tuple(None if n is None else
               torch.from_numpy(data[f"{{name}}/e{{i}}"][rank].copy())
               for i, n in enumerate(sizes))
    key = prng.key(7)
    outs, new_ef = fex.exchange_with_residuals(bufs, key, None, ef)
    plain = fex.exchange_bufs(bufs, key)
    res_ = fex.residual_bufs(bufs, key)
    parts = list(outs) + [e for e in new_ef if e is not None]
    parts += list(plain) + [r for r in res_ if r is not None]
    res[name] = torch.cat(parts).numpy()
np.savez(out_path, **res)
dist.destroy_process_group()
"""


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra or {})
    return env


def _inputs():
    """Per case: each group's (L, size) buffers and (L, size) EF buffers
    of multiples of 1/64 (EF of 1/512), from one numpy seed."""
    rng = np.random.default_rng(0)
    model = LM(get_smoke_config("lm-100m"))
    ap = model.abstract_params()
    plan = _plan(model, ap, L)
    toy = _toy()[1]
    out = {}
    for name, (spec, bucket) in CASES.items():
        pol = QuantPolicy.parse(spec, bucket_size=bucket)
        if name == "mixed":
            fex = FsdpExchange.build(pol, toy, ("data",),
                                     paths={"b": "b", "w": "w"},
                                     shard_dims={"b": None, "w": 0},
                                     n_shards=L)
        else:
            fex = FsdpExchange.build(pol, ap, ("data",), paths=plan.paths,
                                     shard_dims=plan.full_shard_dims(),
                                     n_shards=L)
        for i, g in enumerate(fex.layout.groups):
            out[f"{name}/g{i}"] = (rng.integers(-64, 65, (L, g.size))
                                   .astype(np.float32) / 64)
        for i, n in enumerate(fex.ef_group_sizes()):
            if n is not None:
                out[f"{name}/e{i}"] = (rng.integers(-8, 9, (L, n))
                                       .astype(np.float32) / 512)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides once, concurrently: the reference on 4 fake devices, the
    port on 4 gloo processes (own ``file://`` rendezvous)."""
    tmp = tmp_path_factory.mktemp("fsdp")
    inp = tmp / "inputs.npz"
    np.savez(inp, **_inputs())
    fmt = dict(cases=CASES)
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_PROG.format(**fmt)),
         str(tmp / "jax.npz"), str(inp)],
        env=_env({"XLA_FLAGS": "--xla_force_host_platform_device_count=4"}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    for r in range(L):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(TORCH_PROG.format(**fmt)),
             str(r), str(tmp / f"torch{r}.npz"), str(inp), str(tmp / "rdv")],
            env=_env({"OMP_NUM_THREADS": "1"}), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out
    return (dict(np.load(tmp / "jax.npz")),
            [dict(np.load(tmp / f"torch{r}.npz")) for r in range(L)])


@pytest.mark.parametrize("case", sorted(CASES))
def test_fsdp_exchange_bit_equal_to_fake_devices(runs, case):
    """Outputs, EF residuals, the plain exchange and ``residual_bufs``:
    every worker's values equal the reference's bit for bit."""
    jx, tr = runs
    want = jx[case].reshape(L, -1)
    for r in range(L):
        np.testing.assert_array_equal(tr[r][case], want[r])


def test_fsdp_mixed_replicated_group_agrees_across_workers(runs):
    """The toy's fp group is replicated: every worker holds the same mean
    (the sharded orq-9 chunk is each worker's own)."""
    _, tr = runs
    for r in range(1, L):
        np.testing.assert_array_equal(tr[r]["mixed"][:40],
                                      tr[0]["mixed"][:40])
    assert not np.array_equal(tr[1]["mixed"][40:40 + 224],
                              tr[0]["mixed"][40:40 + 224])
