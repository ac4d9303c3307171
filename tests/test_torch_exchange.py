"""The port's fused Algorithm-2 exchange against the JAX reference.

* Layouts: ``GradLayout`` / ``PolicyLayout.flatten_groups`` of a carried-
  over params tree equal the reference's buffers bit for bit (the
  reference flattens dicts in sorted-key order; so does the port).
* Collectives: the port on 4 gloo processes against the reference on 4
  fake XLA devices (a subprocess, as ``tests/test_comm.py`` runs them),
  same inputs and keys. On a buffer of multiples of 1/64 in [-1, 1] every
  prefix sum of the ORQ fit is exact in float32 in any order, so the
  level fits, and with them everything downstream, must be bit-equal. On
  a normal buffer the fits are float-close (their row sums add in another
  order), so an ulp can flip a rounding decision: there the outputs must
  agree on at least 99% of the elements and within 1e-3 in mean.
* Byte accounting at full size (lm-100m) equals the reference exactly.
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
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.comm import collectives, exchange
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import LM
from repro_torch.utils.pytree import tree_leaves
from torch_test_env import port_test_env  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 4
N = 3 * 2 * 512 * L + 301          # ragged: the last chunk is partial
TREE = {"w": (3, 700), "c_bias": (50,), "a": (1000,)}
POLICY = "bias=fp,default=orq-9"


def _buffers():
    rng = np.random.default_rng(0)
    q64 = rng.integers(-64, 65, (L, N)).astype(np.float32) / 64
    normal = (rng.standard_normal((L, N)) * 0.1).astype(np.float32)
    ef0 = (rng.integers(-8, 9, (L, N)).astype(np.float32) / 512)
    return {"q64": q64, "normal": normal}, ef0


JAX_PROG = """
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import comm, make_quantizer
from repro.core.policy import QuantPolicy
from repro.utils.compat import shard_map

TREE, POLICY, out_path, in_path = {tree!r}, {policy!r}, sys.argv[1], sys.argv[2]
mesh = jax.make_mesh((4,), ("data",))
DP = ("data",)
qz = make_quantizer("orq-9", bucket_size=512)
names = sorted(TREE)
sizes = [int(np.prod(TREE[k])) for k in names]
tree = {{k: jax.ShapeDtypeStruct(TREE[k], jnp.float32) for k in TREE}}
pex = comm.PartitionedExchange.build(
    QuantPolicy.parse(POLICY, bucket_size=512), tree, DP)

def smap(f, n_in):
    return jax.jit(shard_map(f, mesh=mesh, in_specs=(P("data"),) * n_in,
                             out_specs=P("data"), axis_names={{"data"}},
                             check_vma=False))

def to_tree(flat):
    out, o = {{}}, 0
    for k, n in zip(names, sizes):
        out[k] = flat[o:o + n].reshape(TREE[k])
        o += n
    return out

def allreduce(g):
    return comm.quantized_all_reduce_mean(g[0], qz, jax.random.key(11),
                                          DP)[None]

def allreduce_norequant(g):
    return comm.quantized_all_reduce_mean(g[0], qz, jax.random.key(11), DP,
                                          server_requant=False)[None]

def parts(g):
    bufs = pex.layout.flatten_groups(to_tree(g[0]))
    return jnp.concatenate(pex.exchange_parts(bufs, jax.random.key(5)))[None]

def parts_ef(g, e):
    g = g[0] + e[0]
    bufs = pex.layout.flatten_groups(to_tree(g))
    local = pex.local_qdq_parts(bufs, jax.random.key(5))
    res = jnp.concatenate([b - q for b, q in zip(bufs, local)])
    out = jnp.concatenate(pex.exchange_parts(bufs, jax.random.key(5)))
    return jnp.concatenate([out, res])[None]

data = np.load(in_path)
res = {{}}
for kind in ("q64", "normal"):
    g = jnp.asarray(data[kind])
    res[kind + "/allreduce"] = np.asarray(smap(allreduce, 1)(g))
    res[kind + "/norequant"] = np.asarray(smap(allreduce_norequant, 1)(g))
    res[kind + "/parts"] = np.asarray(smap(parts, 1)(g))
    res[kind + "/parts_ef"] = np.asarray(smap(parts_ef, 2)(
        g, jnp.asarray(data["ef0"])))
np.savez(out_path, **res)
"""

TORCH_PROG = """
import sys, numpy as np, torch, torch.distributed as dist
from repro_torch.core import prng
from repro_torch.core.api import make_quantizer
from repro_torch.core.comm import collectives, exchange
from repro_torch.core.policy import QuantPolicy

TREE, POLICY = {tree!r}, {policy!r}
rank, out_path, in_path, rdv = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=4)
qz = make_quantizer("orq-9", bucket_size=512)
tree = {{k: torch.empty(v) for k, v in TREE.items()}}
pex = exchange.PartitionedExchange.build(
    QuantPolicy.parse(POLICY, bucket_size=512), tree)
names = sorted(TREE)
sizes = [int(np.prod(TREE[k])) for k in names]

def to_tree(flat):
    out, o = {{}}, 0
    for k, n in zip(names, sizes):
        out[k] = flat[o:o + n].reshape(TREE[k])
        o += n
    return out

data = np.load(in_path)
res = {{}}
for kind in ("q64", "normal"):
    g = torch.from_numpy(data[kind][rank].copy())
    res[kind + "/allreduce"] = collectives.quantized_all_reduce_mean(
        g, qz, prng.key(11)).numpy()
    res[kind + "/norequant"] = collectives.quantized_all_reduce_mean(
        g, qz, prng.key(11), server_requant=False).numpy()
    bufs = pex.layout.flatten_groups(to_tree(g))
    res[kind + "/parts"] = torch.cat(
        pex.exchange_parts(bufs, prng.key(5))).numpy()
    ge = g + torch.from_numpy(data["ef0"][rank].copy())
    bufs = pex.layout.flatten_groups(to_tree(ge))
    local = pex.local_qdq_parts(bufs, prng.key(5))
    resid = torch.cat([b - q for b, q in zip(bufs, local)])
    out = torch.cat(pex.exchange_parts(bufs, prng.key(5)))
    res[kind + "/parts_ef"] = torch.cat([out, resid]).numpy()
np.savez(out_path, **res)
dist.destroy_process_group()
"""


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra or {})
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides once: the reference on 4 fake devices, the port on 4
    gloo processes (own ``file://`` rendezvous), run concurrently."""
    tmp = tmp_path_factory.mktemp("exchange")
    bufs, ef0 = _buffers()
    inp = tmp / "inputs.npz"
    np.savez(inp, ef0=ef0, **bufs)
    fmt = dict(tree=TREE, policy=POLICY)
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_PROG.format(**fmt)),
         str(tmp / "jax.npz"), str(inp)],
        env=_env({"XLA_FLAGS": "--xla_force_host_platform_device_count=4"}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    for r in range(L):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(TORCH_PROG.format(**fmt)),
             str(r), str(tmp / f"torch{r}.npz"), str(inp),
             str(tmp / "rdv")],
            env=_env({"OMP_NUM_THREADS": "1"}), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out
    jx = dict(np.load(tmp / "jax.npz"))
    tr = [dict(np.load(tmp / f"torch{r}.npz")) for r in range(L)]
    return jx, tr


OUTPUTS = ["allreduce", "norequant", "parts", "parts_ef"]


@pytest.mark.parametrize("what", OUTPUTS)
def test_gloo_matches_fake_devices_exactly_on_q64(runs, what):
    jx, tr = runs
    want = jx[f"q64/{what}"]                     # (L, n) or (L, 2n)
    for r in range(L):
        np.testing.assert_array_equal(tr[r][f"q64/{what}"], want[r])


@pytest.mark.parametrize("what", OUTPUTS)
def test_gloo_close_to_fake_devices_on_normal(runs, what):
    jx, tr = runs
    for r in range(L):
        got, want = tr[r][f"normal/{what}"], jx[f"normal/{what}"][r]
        assert got.shape == want.shape
        assert np.mean(got != want) <= 0.01
        assert np.mean(np.abs(got - want)) <= 1e-3


@pytest.mark.parametrize("kind", ["q64", "normal"])
def test_workers_agree(runs, kind):
    """Phase 2's decode is deterministic: every worker holds the same
    mean (the EF residuals are each worker's own)."""
    _, tr = runs
    for what in ("allreduce", "norequant", "parts"):
        for r in range(1, L):
            np.testing.assert_array_equal(tr[r][f"{kind}/{what}"],
                                          tr[0][f"{kind}/{what}"])
    n_tree = sum(int(np.prod(v)) for v in TREE.values())
    for r in range(1, L):
        np.testing.assert_array_equal(tr[r][f"{kind}/parts_ef"][:n_tree],
                                      tr[0][f"{kind}/parts_ef"][:n_tree])


def test_exchange_mean_is_close_to_true_mean(runs):
    """Quantization noise, not a bug: the exchanged mean tracks the exact
    mean of the workers' buffers."""
    _, tr = runs
    bufs, _ = _buffers()
    true = bufs["normal"].mean(0)
    got = tr[0]["normal/allreduce"]
    # two random roundings onto 9 levels per 512-bucket: noise ~1/3 of the
    # signal here, unbiased, so the two stay strongly correlated
    assert np.abs(got - true).mean() < 0.5 * np.abs(true).mean()
    assert np.corrcoef(got, true)[0, 1] > 0.85


# ---------------------------------------------------------------------------
# layouts (in process)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_params():
    model = JLM(jget_smoke_config("lm-100m"))
    params = jax.jit(model.init)(jax.random.key(0))
    return model, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("policy", ["orq-9", "norm=fp,default=orq-9",
                                    "embed|lm_head=fp,wq=orq-5,default=orq-9"])
def test_policy_layout_flatten_bit_equal(smoke_params, policy):
    jmodel, jp = smoke_params
    jpol = JPolicy.parse(policy, bucket_size=512)
    jlay = jcomm.PolicyLayout.from_tree(jp, jpol,
                                        paths=jmodel.param_paths(jp))
    want = [np.asarray(b) for b in jlay.flatten_groups(jp)]
    model = LM(get_smoke_config("lm-100m"))
    tp = params_from_jax(jp, device="cpu")
    lay = exchange.PolicyLayout.from_tree(
        tp, QuantPolicy.parse(policy, bucket_size=512),
        paths=model.param_paths(tp))
    assert [s.path for s in lay.slots] == [s.path for s in jlay.slots]
    assert [g.size for g in lay.groups] == [g.size for g in jlay.groups]
    assert [g.cfg.name for g in lay.groups] == \
        [g.cfg.name for g in jlay.groups]
    got = lay.flatten_groups(tp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    back = tree_leaves(lay.unflatten_groups(got))
    for a, b in zip(jax.tree_util.tree_leaves(jp), back, strict=True):
        np.testing.assert_array_equal(b.numpy(), a)


def test_grad_layout_flatten_bit_equal(smoke_params):
    _, jp = smoke_params
    jlay = jcomm.GradLayout.from_tree(jp)
    tp = params_from_jax(jp, device="cpu")
    lay = exchange.GradLayout.from_tree(tp)
    assert [s.path for s in lay.slots] == [s.path for s in jlay.slots]
    assert lay.size == jlay.size
    np.testing.assert_array_equal(lay.flatten(tp).numpy(),
                                  np.asarray(jlay.flatten(jp)))


def test_param_paths_match(smoke_params):
    jmodel, jp = smoke_params
    tp = params_from_jax(jp, device="cpu")
    want = jax.tree_util.tree_leaves(jmodel.param_paths(jp))
    assert tree_leaves(LM(get_smoke_config("lm-100m")).param_paths(tp)) \
        == want


# ---------------------------------------------------------------------------
# byte accounting at full size
# ---------------------------------------------------------------------------

LM100M_WIRE = {1: 140_042_960, 4: 87_529_500, 8: 78_781_320}


@pytest.mark.parametrize("L_", sorted(LM100M_WIRE))
def test_lm100m_wire_bytes_equal_reference(L_):
    model = LM(get_config("lm-100m"))
    ap = model.abstract_params()
    pol = QuantPolicy.parse("orq-9", bucket_size=2048)
    pex = exchange.PartitionedExchange.build(pol, ap,
                                             paths=model.param_paths(ap))
    assert pex.layout.size == 135_285_504
    assert len(pex.layout.slots) == 12
    assert pex.collective_launches() == 4
    assert pex.wire_bytes_per_worker(L_) == LM100M_WIRE[L_]
    jmodel = JLM(jget_config("lm-100m"))
    jap = jax.eval_shape(jmodel.init, jax.random.key(0))
    jpex = jcomm.PartitionedExchange.build(
        JPolicy.parse("orq-9", bucket_size=2048), jap, ("data",),
        paths=jmodel.param_paths(jap))
    assert jpex.wire_bytes_per_worker(L_) == LM100M_WIRE[L_]


def test_chunk_cap_spans_and_bytes_match_reference():
    from repro.core.api import make_quantizer as jmq
    from repro_torch.core.api import make_quantizer
    for cap in (None, 1000, 4096):
        eng = exchange.GradientExchange(make_quantizer("orq-5",
                                                       bucket_size=512),
                                        max_chunk_elems=cap)
        jeng = jcomm.GradientExchange(jmq("orq-5", bucket_size=512),
                                      ("data",), max_chunk_elems=cap)
        assert eng.spans(10_001) == jeng.spans(10_001)
        assert eng.collective_launches(10_001) == \
            jeng.collective_launches(10_001)
        for n_workers in (1, 3, 4):
            assert eng.wire_bytes_per_worker(10_001, n_workers) == \
                jeng.wire_bytes_per_worker(10_001, n_workers)


def test_chunk_spans_match_reference():
    from repro.core.comm.collectives import _chunk_spans as j_spans
    for rows in (1, 7, 66058):
        for k in (1, 2, 3, 8, 100):
            assert collectives._chunk_spans(rows, k) == j_spans(rows, k)


def test_unported_schedules_raise():
    """The pipelined and the two-level exchange are ported (a K below 1 is
    refused, as the reference refuses it); an engine is two-level exactly
    when it holds its pod's process group (``test_torch_hierarchical.py``
    runs it)."""
    from repro_torch.core.api import make_quantizer
    qz = make_quantizer("orq-9")
    assert exchange.GradientExchange(qz, pipeline_chunks=2).pipeline_chunks \
        == 2
    with pytest.raises(ValueError, match="pipeline_chunks"):
        exchange.GradientExchange(qz, pipeline_chunks=0)
    assert not exchange.GradientExchange(qz).two_level
    with pytest.raises(TypeError, match="intra_axes"):
        exchange.GradientExchange(qz, intra_axes=("data",))


@pytest.mark.parametrize("n,d", [(1, 4), (10, 4), (12, 4), (4097, 2048)])
def test_buckets_match_reference(n, d):
    from repro.core import buckets as jbuckets
    from repro_torch.core import buckets
    flat = np.arange(n, dtype=np.float32) - n / 2
    jv, jm = jbuckets.to_buckets(jnp.asarray(flat), d)
    v, m = buckets.to_buckets(torch.from_numpy(flat), d)
    assert buckets.num_buckets(n, d) == jbuckets.num_buckets(n, d)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(buckets.from_buckets(v, n).numpy(), flat)


POLICIES = ["orq-9", "norm|bias=fp,default=orq-9",
            "embed=orq-5, g0/pos0\\['attn'\\]=fp, default=orq-17",
            '{"wq|wk": "orq-3", "default": {"name": "orq-9", '
            '"server_requant": false}}', "a{1,2}b=fp,default=orq-9"]
PATHS = ["embed", "final_norm", "lm_head", "g0/pos0['attn']['wq']",
         "g0/pos0['ffn']['wo']", "g0/pos0['norm1']['scale']", "aab_bias"]


@pytest.mark.parametrize("spec", POLICIES)
def test_policy_resolves_like_reference(spec):
    pol = QuantPolicy.parse(spec, bucket_size=512, clip_c=2.5)
    jpol = JPolicy.parse(spec, bucket_size=512, clip_c=2.5)
    assert pol.describe() == jpol.describe()
    assert pol.unmatched_rules(PATHS) == jpol.unmatched_rules(PATHS)
    for path in PATHS:
        a, b = pol.resolve(path), jpol.resolve(path)
        assert pol.resolve_ix(path) == jpol.resolve_ix(path)
        assert (a.name, a.bucket_size, a.clip_c, a.server_requant) == \
            (b.name, b.bucket_size, b.clip_c, b.server_requant)
        assert a.to_quantizer().s == b.to_quantizer().s


@pytest.mark.parametrize("spec", ["", "=orq-9", "orq-9,default=fp,x",
                                  "default=orq-9,default=fp", "bogus-3",
                                  "embed=orq@5..3", '{"x": 3}'])
def test_policy_rejects_like_reference(spec):
    with pytest.raises(ValueError):
        JPolicy.parse(spec)
    with pytest.raises(ValueError):
        QuantPolicy.parse(spec)
