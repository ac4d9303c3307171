"""The port's two-level (intra-pod fp, inter-pod quantized) hierarchy
against the JAX reference.

* Axis splitting and the per-link accounting (``link_stats``,
  ``policy_link_stats``, ``observed_link_stats``, ``ef_shard_sizes``, the
  two-level ``FsdpExchange``'s launches, bytes and EF sizes) equal the
  reference's exactly, lm-100m's table numbers included.
* Collectives on 2 pods x 2 workers: 4 gloo processes (rank = pod * 2 +
  data, the pods' groups from ``hierarchical.pod_groups``) against the
  reference on a ``("pod", "data")`` (2, 2) mesh of 4 fake XLA devices.
  The two-level fsdp exchange (outputs and EF residuals) and the
  two-level replicated exchange (the step's intra scatter, EF on the
  shard, quantized shard exchange, intra gather) are bit-equal on buffers
  of multiples of 1/64 (every sum exact in any order). At n_intra = 2 the
  ordered intra sum is the reference's ``psum_scatter`` (a + b commutes).
* One pod is the flat exchange: ``--hierarchy two_level`` with one pod,
  and ``--pods 2`` with pods of one worker, end with the flat run's
  params sha256 (two gloo workers).
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import comm as jcomm
from repro.core import make_quantizer as jmake_quantizer
from repro.core.policy import QuantPolicy as JPolicy
from repro.models.model import LM as JLM
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.api import all_methods, make_quantizer
from repro_torch.core.comm import exchange, hierarchical
from repro_torch.core.comm.fsdp_exchange import FsdpExchange
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import LM
from repro_torch.train.step import plan_sharding_shapes
from repro_torch.utils.pytree import tree_leaves
from torch_test_env import port_test_env  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# stands in for a pod's process group where an engine is only priced or
# guarded: neither reaches a collective
_POD = object()


# ---------------------------------------------------------------------------
# axis splitting and accounting (in process)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp", [("data",), ("pod",), ("pod", "data")])
@pytest.mark.parametrize("hierarchy", ["flat", "two_level", "auto",
                                       "two_level_async"])
def test_split_matches_reference(dp, hierarchy):
    assert hierarchical.resolve_hierarchy(hierarchy, dp) == \
        jcomm.resolve_hierarchy(hierarchy, dp)
    assert hierarchical.resolve_hierarchy(hierarchy, dp, 4) == \
        jcomm.resolve_hierarchy(hierarchy, dp, 4)
    assert hierarchical.split_dp_axes(dp, hierarchy) == \
        jcomm.split_dp_axes(dp, hierarchy)


def test_split_rejects_like_reference():
    with pytest.raises(ValueError, match="hierarchy must be one of"):
        hierarchical.resolve_hierarchy("ring", ("data",))
    with pytest.raises(ValueError, match="must precede"):
        hierarchical.split_dp_axes(("data", "pod"), "two_level")
    for n in (1, 7, 8, 9):
        for k in (1, 2, 4):
            assert hierarchical.intra_chunk_len(n, k) == \
                jcomm.hierarchical.intra_chunk_len(n, k)


def test_local_qdq_flat_guarded_on_two_level():
    """A two-level engine is one with its pod's group; the flat residual
    is refused there, and an fsdp exchange priced two-level (axis names
    only) refuses to run without its pods' groups."""
    assert not exchange.GradientExchange(make_quantizer("orq-9")).two_level
    eng = exchange.GradientExchange(make_quantizer("orq-9"),
                                    intra_group=_POD)
    assert eng.two_level
    with pytest.raises(ValueError, match="intra shard"):
        eng.local_qdq_flat(torch.zeros(8), None)
    toy = {"b": torch.empty(40, device="meta"),
           "w": torch.empty(16, 56, device="meta")}
    fex = FsdpExchange.build(
        QuantPolicy.parse("orq-9"), toy, ("pod", "data"),
        paths={"b": "b", "w": "w"}, shard_dims={"b": None, "w": 0},
        n_shards=4, intra_axes=("data",), n_intra=2)
    assert fex.collective_launches() > 0
    bufs = [torch.zeros(g.size) for g in fex.layout.groups]
    with pytest.raises(ValueError, match="pod's process group"):
        fex.exchange_with_residuals(bufs, None, 0)


LINK_SHAPES = [(2, 2), (4, 2), (2, 4), (1, 4), (4, 1)]


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("scheme", all_methods())
def test_link_stats_match_reference(scheme, two_level, sharded):
    for n_intra, n_inter in LINK_SHAPES:
        for n, cap, k, h in ((10_001, None, 1, 1), (1 << 20, 300_000, 3, 1),
                             (65_536, None, 1, 4)):
            if sharded:
                n = -(-n // (n_intra * n_inter)) * n_intra * n_inter
            kw = dict(n_intra=n_intra, n_inter=n_inter, two_level=two_level,
                      sharded=sharded, max_chunk_elems=cap,
                      pipeline_chunks=k, sync_every=h)
            got = exchange.link_stats(make_quantizer(scheme), n, **kw)
            want = jcomm.link_stats(jmake_quantizer(scheme), n, **kw)
            assert got == want, (n_intra, n_inter, n, cap, k, h)


@pytest.fixture(scope="module")
def lm100m():
    jmodel = JLM(jget_config("lm-100m"))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0))
    model = LM(get_config("lm-100m"))
    ps = list(zip(jax.tree_util.tree_leaves(jmodel.param_paths(shapes)),
                  [int(np.prod(x.shape))
                   for x in jax.tree_util.tree_leaves(shapes)]))
    return jmodel, shapes, model, model.abstract_params(), ps


@pytest.mark.parametrize("spec", ["orq-9", "norm|bias=fp,default=orq-9",
                                  "bingrad-b", "fp"])
def test_policy_and_observed_link_stats_match_reference(lm100m, spec):
    from repro.train.step import plan_sharding_shapes as jplan
    jmodel, shapes, model, ap, ps = lm100m
    sharded = {p for p, d in jplan(
        jmodel, shapes, dp_axes=("pod", "data"),
        axis_sizes={"pod": 2, "data": 2, "model": 1}).full_shard_dims()
        .items() if d is not None}
    for tl in (False, True):
        for sp in (None, sharded):
            for h in (1, 4):
                kw = dict(n_intra=2, n_inter=2, two_level=tl,
                          sharded_paths=sp, sync_every=h)
                assert exchange.policy_link_stats(
                    QuantPolicy.parse(spec), ps, **kw) == \
                    jcomm.policy_link_stats(JPolicy.parse(spec), ps, **kw)
        jpex = jcomm.PartitionedExchange.build(
            JPolicy.parse(spec), shapes, ("pod",),
            paths=jmodel.param_paths(shapes),
            intra_axes=("data",) if tl else ())
        pex = exchange.PartitionedExchange.build(
            QuantPolicy.parse(spec), ap, paths=model.param_paths(ap),
            intra_group=_POD if tl else None)
        got = exchange.observed_link_stats(pex, n_intra=2, n_inter=2)
        want = jcomm.observed_link_stats(jpex, n_intra=2, n_inter=2)
        assert got == want
        assert pex.ef_shard_sizes(2) == jpex.ef_shard_sizes(2)


def test_lm100m_link_table(lm100m):
    """The bring-up table: replicated orq-9 on 2 pods x 2, two-level
    against flat, and the two-level fsdp engine."""
    _, _, model, ap, ps = lm100m
    pol = QuantPolicy.parse("orq-9", bucket_size=2048)
    two, _ = exchange.policy_link_stats(pol, ps, n_intra=2, n_inter=2,
                                        two_level=True)
    assert (two["launches"], two["ici_bytes"], two["dcn_bytes"]) == \
        (6, 567_400_866, 26_258_850)
    flat, _ = exchange.policy_link_stats(pol, ps, n_intra=2, n_inter=2,
                                         two_level=False)
    assert (flat["launches"], flat["ici_bytes"], flat["dcn_bytes"]) == \
        (4, 43_764_750, 43_764_750)
    pex = exchange.PartitionedExchange.build(pol, ap,
                                             paths=model.param_paths(ap))
    assert pex.ef_shard_sizes(2) == (67_642_752,)
    plan = plan_sharding_shapes(model, ap, dp_axes=("pod", "data"),
                                axis_sizes={"pod": 2, "data": 2})
    fex = FsdpExchange.build(pol, ap, ("pod", "data"), paths=plan.paths,
                             shard_dims=plan.full_shard_dims(), n_shards=4,
                             intra_axes=("data",), n_intra=2)
    lb = fex.link_bytes_per_worker()
    assert fex.collective_launches() == 3
    assert (lb["ici_bytes"], lb["dcn_bytes"]) == (288_076_908, 17_505_900)
    assert fex.wire_bytes_per_worker() == 305_582_808
    assert fex.ef_group_sizes() == (67_642_752,)


@pytest.mark.parametrize("scheme", ["orq-9", "bingrad-b", "fp",
                                    "norm|bias=fp,default=orq-9"])
def test_two_level_fsdp_accounting_matches_reference(lm100m, scheme):
    from repro.train.step import plan_sharding_shapes as jplan
    jmodel, shapes, model, ap, _ = lm100m
    for pods, n_intra in ((2, 2), (2, 4), (4, 2)):
        n = pods * n_intra
        jp = jplan(jmodel, shapes, dp_axes=("pod", "data"),
                   axis_sizes={"pod": pods, "data": n_intra, "model": 1})
        p = plan_sharding_shapes(model, ap, dp_axes=("pod", "data"),
                                 axis_sizes={"pod": pods, "data": n_intra})
        jfex = jcomm.FsdpExchange.build(
            JPolicy.parse(scheme), shapes, ("pod", "data"), paths=jp.paths,
            shard_dims=jp.full_shard_dims(), n_shards=n,
            intra_axes=("data",), n_intra=n_intra)
        fex = FsdpExchange.build(
            QuantPolicy.parse(scheme), ap, ("pod", "data"), paths=p.paths,
            shard_dims=p.full_shard_dims(), n_shards=n,
            intra_axes=("data",), n_intra=n_intra)
        assert fex.collective_launches() == jfex.collective_launches()
        assert fex.wire_bytes_per_worker() == jfex.wire_bytes_per_worker()
        assert fex.link_bytes_per_worker() == jfex.link_bytes_per_worker()
        assert fex.ef_group_sizes() == jfex.ef_group_sizes()


def test_fsdp_build_validation():
    model = LM(get_smoke_config("lm-100m"))
    ap = model.abstract_params()
    plan = plan_sharding_shapes(model, ap, dp_axes=("pod", "data"),
                                axis_sizes={"pod": 2, "data": 2})
    kw = dict(paths=plan.paths, shard_dims=plan.full_shard_dims(),
              n_shards=4)
    pol = QuantPolicy.parse("orq-9")
    with pytest.raises(ValueError, match="must precede"):
        FsdpExchange.build(pol, ap, ("data", "pod"), intra_axes=("data",),
                           n_intra=2, **kw)
    with pytest.raises(ValueError, match="n_intra"):
        FsdpExchange.build(pol, ap, ("pod", "data"), intra_axes=("data",),
                           n_intra=3, **kw)
    flat = FsdpExchange.build(pol, ap, ("pod", "data"), n_intra=2, **kw)
    assert flat.n_intra == 1 and not flat.intra_axes


# ---------------------------------------------------------------------------
# collectives: 2 pods x 2 workers, gloo against fake devices
# ---------------------------------------------------------------------------

CASES = {"fsdp_orq9": ("fsdp", "orq-9", 512),
         "fsdp_mixed": ("fsdp", "b=fp,default=orq-9", 64),
         "repl_orq9": ("replicated", "orq-9", 512),
         "repl_mixed": ("replicated", "norm|bias=fp,default=orq-9", 512)}

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
DP = ("pod", "data")
mesh = jax.make_mesh((2, 2), DP)
model = LM(get_smoke_config("lm-100m"))
shapes = jax.eval_shape(model.init, jax.random.key(0))
paths = model.param_paths(shapes)
plan = plan_sharding_shapes(model, shapes, dp_axes=DP,
                            axis_sizes={{"pod": 2, "data": 2, "model": 1}})
toy = {{"b": jax.ShapeDtypeStruct((40,), jnp.float32),
       "w": jax.ShapeDtypeStruct((16, 56), jnp.float32)}}
data = np.load(in_path)
res = {{}}
for name, (mode, spec, bucket) in CASES.items():
    pol = QuantPolicy.parse(spec, bucket_size=bucket)
    key = jax.random.key(9)
    if mode == "fsdp":
        if name.endswith("mixed"):
            ex = comm.FsdpExchange.build(
                pol, toy, DP, paths={{"b": "b", "w": "w"}},
                shard_dims={{"b": None, "w": 0}}, n_shards=4,
                intra_axes=("data",), n_intra=2)
        else:
            ex = comm.FsdpExchange.build(
                pol, shapes, DP, paths=plan.paths,
                shard_dims=plan.full_shard_dims(), n_shards=4,
                intra_axes=("data",), n_intra=2)
        ng, sizes = len(ex.layout.groups), ex.ef_group_sizes()

        def body(*xs, ex=ex, ng=ng, sizes=sizes):
            bufs, it = [x[0] for x in xs[:ng]], iter(x[0] for x in xs[ng:])
            ef = tuple(None if n is None else next(it) for n in sizes)
            wid = jax.lax.axis_index(DP)
            outs, new_ef = ex.exchange_with_residuals(bufs, key, wid, ef)
            res_ = ex.residual_bufs(bufs, key, wid)
            parts = list(outs) + [e for e in new_ef if e is not None]
            parts += [r for r in res_ if r is not None]
            return jnp.concatenate(parts)[None]
    else:
        ex = comm.PartitionedExchange.build(pol, shapes, ("pod",),
                                            paths=paths,
                                            intra_axes=("data",))
        ng, sizes = len(ex.layout.groups), ex.ef_shard_sizes(2)

        def body(*xs, ex=ex, ng=ng, sizes=sizes):
            bufs, it = [x[0] for x in xs[:ng]], iter(x[0] for x in xs[ng:])
            ef = tuple(None if n is None else next(it) for n in sizes)
            shards, valids = ex.intra_scatter_parts(bufs)
            shards = tuple(s if e is None else s + e
                           for s, e in zip(shards, ef))
            local = ex.local_qdq_shard_parts(shards, key, valids)
            new_ef = [s - q for e, s, q in zip(ef, shards, local)
                      if e is not None]
            means = ex.exchange_shard_parts(shards, key, valids)
            outs = ex.intra_gather_parts(means)
            return jnp.concatenate(list(outs) + new_ef)[None]

    n_in = ng + sum(n is not None for n in sizes)
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(DP),) * n_in,
                           out_specs=P(DP), axis_names=set(DP),
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
from repro_torch.core.comm import hierarchical
from repro_torch.core.comm.exchange import PartitionedExchange
from repro_torch.core.comm.fsdp_exchange import FsdpExchange
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import LM
from repro_torch.train.step import plan_sharding_shapes

CASES = {cases!r}
DP = ("pod", "data")
rank, out_path, in_path, rdv = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=4)
intra, inter = hierarchical.pod_groups(2, 2)
model = LM(get_smoke_config("lm-100m"))
ap = model.abstract_params()
paths = model.param_paths(ap)
plan = plan_sharding_shapes(model, ap, dp_axes=DP,
                            axis_sizes={{"pod": 2, "data": 2}})
toy = {{"b": torch.empty(40, device="meta"),
       "w": torch.empty(16, 56, device="meta")}}
data = np.load(in_path)
res = {{}}
for name, (mode, spec, bucket) in CASES.items():
    pol = QuantPolicy.parse(spec, bucket_size=bucket)
    key = prng.key(9)
    kw = dict(intra_axes=("data",), n_intra=2, intra_group=intra,
              inter_group=inter)
    if mode == "fsdp":
        if name.endswith("mixed"):
            ex = FsdpExchange.build(
                pol, toy, DP, paths={{"b": "b", "w": "w"}},
                shard_dims={{"b": None, "w": 0}}, n_shards=4, **kw)
        else:
            ex = FsdpExchange.build(
                pol, ap, DP, paths=plan.paths,
                shard_dims=plan.full_shard_dims(), n_shards=4, **kw)
        sizes = ex.ef_group_sizes()
    else:
        ex = PartitionedExchange.build(pol, ap, inter, paths=paths,
                                       intra_group=intra)
        sizes = ex.ef_shard_sizes(2)
    ng = len(ex.layout.groups)
    bufs = [torch.from_numpy(data[f"{{name}}/g{{i}}"][rank].copy())
            for i in range(ng)]
    ef = tuple(None if n is None else
               torch.from_numpy(data[f"{{name}}/e{{i}}"][rank].copy())
               for i, n in enumerate(sizes))
    if mode == "fsdp":
        outs, new_ef = ex.exchange_with_residuals(bufs, key, None, ef)
        res_ = ex.residual_bufs(bufs, key)
        parts = list(outs) + [e for e in new_ef if e is not None]
        parts += [r for r in res_ if r is not None]
    else:
        shards, valids = ex.intra_scatter_parts(bufs)
        shards = tuple(s if e is None else s + e for s, e in zip(shards, ef))
        local = ex.local_qdq_shard_parts(shards, key, valids)
        new_ef = [s - q for e, s, q in zip(ef, shards, local)
                  if e is not None]
        means = ex.exchange_shard_parts(shards, key, valids)
        parts = list(ex.intra_gather_parts(means)) + new_ef
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
    rng = np.random.default_rng(1)
    model = LM(get_smoke_config("lm-100m"))
    ap = model.abstract_params()
    plan = plan_sharding_shapes(model, ap, dp_axes=("pod", "data"),
                                axis_sizes={"pod": 2, "data": 2})
    toy = {"b": torch.empty(40, device="meta"),
           "w": torch.empty(16, 56, device="meta")}
    out = {}
    for name, (mode, spec, bucket) in CASES.items():
        pol = QuantPolicy.parse(spec, bucket_size=bucket)
        if mode == "fsdp":
            if name.endswith("mixed"):
                ex = FsdpExchange.build(
                    pol, toy, ("pod", "data"), paths={"b": "b", "w": "w"},
                    shard_dims={"b": None, "w": 0}, n_shards=4,
                    intra_axes=("data",), n_intra=2)
            else:
                ex = FsdpExchange.build(
                    pol, ap, ("pod", "data"), paths=plan.paths,
                    shard_dims=plan.full_shard_dims(), n_shards=4,
                    intra_axes=("data",), n_intra=2)
            sizes = ex.ef_group_sizes()
        else:
            ex = exchange.PartitionedExchange.build(
                pol, ap, paths=model.param_paths(ap))
            sizes = ex.ef_shard_sizes(2)
        for i, g in enumerate(ex.layout.groups):
            out[f"{name}/g{i}"] = (rng.integers(-64, 65, (4, g.size))
                                   .astype(np.float32) / 64)
        for i, n in enumerate(sizes):
            if n is not None:
                out[f"{name}/e{i}"] = (rng.integers(-8, 9, (4, n))
                                       .astype(np.float32) / 512)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_level")
    inp = tmp / "inputs.npz"
    np.savez(inp, **_inputs())
    fmt = dict(cases=CASES)
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_PROG.format(**fmt)),
         str(tmp / "jax.npz"), str(inp)],
        env=_env({"XLA_FLAGS": "--xla_force_host_platform_device_count=4"}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    for r in range(4):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(TORCH_PROG.format(**fmt)),
             str(r), str(tmp / f"torch{r}.npz"), str(inp), str(tmp / "rdv")],
            env=_env({"OMP_NUM_THREADS": "1"}), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out
    return (dict(np.load(tmp / "jax.npz")),
            [dict(np.load(tmp / f"torch{r}.npz")) for r in range(4)])


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_level_bit_equal_to_fake_devices(runs, case):
    jx, tr = runs
    want = jx[case].reshape(4, -1)
    for r in range(4):
        np.testing.assert_array_equal(tr[r][case], want[r])


def test_two_level_replicated_mean_agrees_across_workers(runs):
    """The replicated two-level exchange ends with the same mean on every
    worker (the EF shards are each worker's own)."""
    _, tr = runs
    size = sum(t.numel() for t in tree_leaves(
        LM(get_smoke_config("lm-100m")).abstract_params()))
    for r in range(1, 4):
        np.testing.assert_array_equal(tr[r]["repl_orq9"][:size],
                                      tr[0]["repl_orq9"][:size])


_WORKER = """
import importlib, sys
import torch.distributed as dist
rank, n, rdv = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=n)
try:
    rc = importlib.import_module("repro_torch.launch.train").main(sys.argv[4:])
finally:
    dist.destroy_process_group()
sys.exit(rc)
"""


def _start(tmp_path, n, *flags):
    env = _env({"OMP_NUM_THREADS": "1"})
    tmp_path.mkdir(parents=True, exist_ok=True)
    return [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(n),
         str(tmp_path / "rdv"), "--smoke", "--device", "cpu", "--steps",
         "2", "--batch", "4", "--seq", "16", "--quant", "orq-9", "--bucket",
         "512", "--error-feedback", *flags], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]


def _sha(procs):
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * len(procs), outs
    return [ln for ln in outs[0].splitlines()
            if ln.startswith("params sha256")][0]


SINGLE_POD = {"flat": ["--hierarchy", "flat"],
              "two_level": ["--hierarchy", "two_level"],
              # pods of one worker: nothing to average within a pod
              "pods": ["--pods", "2", "--hierarchy", "two_level"]}


@pytest.fixture(scope="module")
def single_pod(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("single_pod")
    procs = {(mode, k): _start(tmp / f"{mode}_{k}", 2, "--mode", mode, *f)
             for mode in ("replicated", "fsdp")
             for k, f in SINGLE_POD.items()}
    return {k: _sha(p) for k, p in procs.items()}


@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_single_pod_two_level_is_flat(single_pod, mode):
    flat = single_pod[(mode, "flat")]
    assert single_pod[(mode, "two_level")] == flat
    assert single_pod[(mode, "pods")] == flat
