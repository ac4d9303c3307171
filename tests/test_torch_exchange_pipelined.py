"""The port's pipelined exchange, and the byte accounting of every
exchange schedule, against the JAX reference (the per-leaf exchange's
collectives are in ``test_torch_exchange_per_leaf.py``).

* Collectives: the port on 4 gloo processes against the reference on 4
  fake XLA devices (a subprocess, as ``tests/test_comm.py`` runs them),
  same inputs and keys, on buffers of multiples of 1/64 in [-1, 1] (every
  sum of a level fit exact in float32 in any order).
  - Pipelined (``pipeline_chunks`` K = 2, 3, 8, the last clamped to the
    7 bucket rows of a chunk): bit-equal to the port's K = 1, and to the
    reference's pipelined exchange at the same K, for orq-9 and
    BinGrad-b (without the phase-2 re-quantization at K = 1 and 3), and
    through ``PartitionedExchange`` with error feedback.
  Exact for orq-9. Where levels are means (BinGrad-b, SignSGD) phase 2
  re-fits an average that lies off the grid, so the means are held within
  RTOL of the buffer's magnitude; phase 1 and the EF residuals stay
  bit-equal (see ``test_torch_exchange_schemes.py``).
* Byte accounting (in process): ``collective_launches`` (with the clamp of
  K), ``rs_stats``, ``per_leaf_stats``, ``fused_stats`` and
  ``policy_stats`` (with ``sharded_paths``) equal the reference's, and
  lm-100m's table of launches and wire bytes.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.configs.base import get_config as jget_config
from repro.core import comm as jcomm
from repro.core.api import make_quantizer as jmake_quantizer
from repro.core.policy import QuantPolicy as JPolicy
from repro.models.model import LM as JLM
from repro_torch.configs.base import get_config
from repro_torch.core.api import make_quantizer
from repro_torch.core.comm import exchange
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import LM
from torch_test_env import port_test_env  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 4
N = 3 * 2 * 512 * L + 301          # 7 bucket rows a chunk, the last ragged
KS = (1, 2, 3, 8)
PIPE_SCHEMES = ("orq-9", "bingrad-b")
MEAN_LEVELS = ("bingrad-b", "signsgd")
RTOL = 1e-5
PARTS_POLICY = "bias=fp,default=orq-9"
NOREQUANT_KS = (1, 3)

JAX_PROG = """
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import comm, make_quantizer
from repro.core.policy import QuantPolicy
from repro.utils.compat import shard_map

KS, NOREQUANT_KS = {ks!r}, {noreq!r}
PIPE_SCHEMES, PARTS_POLICY = {pipe!r}, {parts!r}
out_path, in_path = sys.argv[1], sys.argv[2]
mesh = jax.make_mesh((4,), ("data",))
DP = ("data",)

def smap(f, n_in):
    return jax.jit(shard_map(f, mesh=mesh, in_specs=(P("data"),) * n_in,
                             out_specs=P("data"), axis_names={{"data"}},
                             check_vma=False))

data = np.load(in_path)
g, e = jnp.asarray(data["q64"]), jnp.asarray(data["ef0"])
res = {{}}
for name in PIPE_SCHEMES:
    qz = make_quantizer(name, bucket_size=512)
    for requant, ks in ((True, KS), (False, NOREQUANT_KS)):
        for K in ks:
            def f(x, K=K, requant=requant):
                return comm.quantized_all_reduce_mean(
                    x[0], qz, jax.random.key(11), DP, server_requant=requant,
                    pipeline_chunks=K)[None]
            res[f"pipe/{{name}}/{{requant}}/K{{K}}"] = np.asarray(smap(f, 1)(g))
for K in NOREQUANT_KS:
    pex = comm.PartitionedExchange.build(
        QuantPolicy.parse(PARTS_POLICY, bucket_size=512),
        {{"a_bias": jax.ShapeDtypeStruct((301,), jnp.float32),
          "w": jax.ShapeDtypeStruct((g.shape[1] - 301,), jnp.float32)}},
        DP, pipeline_chunks=K)
    def parts_ef(x, y):
        x = x[0] + y[0]
        bufs = pex.layout.flatten_groups({{"a_bias": x[:301], "w": x[301:]}})
        local = pex.local_qdq_parts(bufs, jax.random.key(5))
        resid = jnp.concatenate([b - q for b, q in zip(bufs, local)])
        out = jnp.concatenate(pex.exchange_parts(bufs, jax.random.key(5)))
        return jnp.concatenate([out, resid])[None]
    res[f"parts_ef/K{{K}}"] = np.asarray(smap(parts_ef, 2)(g, e))
np.savez(out_path, **res)
"""

TORCH_PROG = """
import sys, numpy as np, torch, torch.distributed as dist
from repro_torch.core import prng
from repro_torch.core.api import make_quantizer
from repro_torch.core.comm import collectives, exchange
from repro_torch.core.policy import QuantPolicy

KS, NOREQUANT_KS = {ks!r}, {noreq!r}
PIPE_SCHEMES, PARTS_POLICY = {pipe!r}, {parts!r}
rank, out_path, in_path, rdv = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=4)
data = np.load(in_path)
g = torch.from_numpy(data["q64"][rank].copy())
e = torch.from_numpy(data["ef0"][rank].copy())
res = {{}}
for name in PIPE_SCHEMES:
    qz = make_quantizer(name, bucket_size=512)
    for requant in (True, False):
        for K in KS:
            res[f"pipe/{{name}}/{{requant}}/K{{K}}"] = (
                collectives.quantized_all_reduce_mean(
                    g, qz, prng.key(11), server_requant=requant,
                    pipeline_chunks=K).numpy())
for K in KS:
    tree = {{"a_bias": torch.empty(301), "w": torch.empty(g.shape[0] - 301)}}
    pex = exchange.PartitionedExchange.build(
        QuantPolicy.parse(PARTS_POLICY, bucket_size=512), tree,
        pipeline_chunks=K)
    x = g + e
    bufs = pex.layout.flatten_groups({{"a_bias": x[:301], "w": x[301:]}})
    local = pex.local_qdq_parts(bufs, prng.key(5))
    resid = torch.cat([b - q for b, q in zip(bufs, local)])
    out = torch.cat(pex.exchange_parts(bufs, prng.key(5)))
    res[f"parts_ef/K{{K}}"] = torch.cat([out, resid]).numpy()
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
    """Both sides once, concurrently: the reference on 4 fake devices, the
    port on 4 gloo processes (own ``file://`` rendezvous)."""
    tmp = tmp_path_factory.mktemp("exchange_pipelined")
    rng = np.random.default_rng(2)
    inp = tmp / "inputs.npz"
    np.savez(inp, q64=rng.integers(-64, 65, (L, N)).astype(np.float32) / 64,
             ef0=rng.integers(-8, 9, (L, N)).astype(np.float32) / 512)
    fmt = dict(ks=KS, noreq=NOREQUANT_KS, pipe=PIPE_SCHEMES,
               parts=PARTS_POLICY)
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


def _hold(got, want, exact: bool):
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.all(np.abs(got - want) <= RTOL * np.abs(want).max())


@pytest.mark.parametrize("requant", [True, False])
@pytest.mark.parametrize("K", KS[1:])
@pytest.mark.parametrize("scheme", PIPE_SCHEMES)
def test_pipelined_bit_equal_to_single_shot(runs, scheme, K, requant):
    _, tr = runs
    for r in range(L):
        np.testing.assert_array_equal(
            tr[r][f"pipe/{scheme}/{requant}/K{K}"],
            tr[r][f"pipe/{scheme}/{requant}/K1"])


@pytest.mark.parametrize("requant", [True, False])
@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("scheme", PIPE_SCHEMES)
def test_pipelined_matches_reference(runs, scheme, K, requant):
    """Without the re-quantization the reference runs K = 1 and 3; the
    port's K = 2 and 8 are held to the reference's K = 1 there."""
    jx, tr = runs
    key = f"pipe/{scheme}/{requant}/K{K}"
    ref = key if key in jx else f"pipe/{scheme}/{requant}/K1"
    exact = scheme not in MEAN_LEVELS or not requant
    for r in range(L):
        _hold(tr[r][key], jx[ref][r], exact)


@pytest.mark.parametrize("K", KS)
def test_pipelined_parts_and_ef_match(runs, K):
    """The mixed-policy engine with error feedback: bit-equal to the port's
    own K = 1, and to the reference (which runs K = 1 and 3)."""
    jx, tr = runs
    ref = f"parts_ef/K{K}" if f"parts_ef/K{K}" in jx else "parts_ef/K1"
    for r in range(L):
        np.testing.assert_array_equal(tr[r][f"parts_ef/K{K}"], jx[ref][r])
        np.testing.assert_array_equal(tr[r][f"parts_ef/K{K}"],
                                      tr[r]["parts_ef/K1"])


# ---------------------------------------------------------------------------
# byte accounting (in process)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("requant", [True, False])
@pytest.mark.parametrize("K", [1, 2, 3, 8, 100])
def test_launches_with_clamp_match_reference(K, requant):
    for name in ("orq-9", "bingrad-b", "fp"):
        eng = exchange.GradientExchange(
            make_quantizer(name, bucket_size=512), server_requant=requant,
            pipeline_chunks=K)
        jeng = jcomm.GradientExchange(
            jmake_quantizer(name, bucket_size=512), ("data",),
            server_requant=requant, pipeline_chunks=K)
        for n in (1, 700, 512 * 24, N):
            for workers in (None, 1, 3, 4, 8):
                assert eng.collective_launches(n, workers) == \
                    jeng.collective_launches(n, workers), (name, n, workers)
                if workers:
                    assert eng.wire_bytes_per_worker(n, workers) == \
                        jeng.wire_bytes_per_worker(n, workers)


@pytest.mark.parametrize("K", [1, 3, 100])
def test_rs_stats_match_reference(K):
    for name in ("orq-9", "bingrad-b", "terngrad", "fp"):
        qz, jqz = (make_quantizer(name, bucket_size=512),
                   jmake_quantizer(name, bucket_size=512))
        for n, workers in ((512 * 24, 8), (N, 4), (301, 1), (10_001, 3)):
            assert exchange.GradientExchange.rs_stats(qz, n, workers, K) == \
                jcomm.GradientExchange.rs_stats(jqz, n, workers, K)


def _lm100m_path_sizes():
    model = LM(get_config("lm-100m"))
    ap = model.abstract_params()
    pex = exchange.PartitionedExchange.build(QuantPolicy.parse("fp"), ap,
                                             paths=model.param_paths(ap))
    return [(s.path, s.size) for s in pex.layout.slots]


#: lm-100m's 12 leaves: (scheme, exchange, L) -> (launches, wire bytes per
#: worker), as the reference accounts them
LM100M_TABLE = {
    ("orq-9", "fused", 1): (4, 140_042_960),
    ("orq-9", "fused", 4): (4, 87_529_500),
    ("orq-9", "fused_k4", 1): (16, 140_042_960),
    ("orq-9", "per_leaf", 1): (48, 140_043_800),
    ("orq-9", "per_leaf", 4): (48, 87_535_460),
    ("bingrad-b", "fused", 1): (4, 34_878_624),
    ("bingrad-b", "fused", 4): (4, 21_799_800),
    ("bingrad-b", "fused_k4", 1): (16, 34_878_624),
    ("bingrad-b", "per_leaf", 1): (48, 34_878_832),
    ("bingrad-b", "per_leaf", 4): (48, 21_801_280),
}


@pytest.mark.parametrize("row", sorted(LM100M_TABLE))
def test_lm100m_table_equals_reference(row):
    scheme, kind, workers = row
    path_sizes = _lm100m_path_sizes()
    sizes = [s for _, s in path_sizes]
    assert len(sizes) == 12 and sum(sizes) == 135_285_504
    qz = make_quantizer(scheme, bucket_size=2048)
    jqz = jmake_quantizer(scheme, bucket_size=2048)
    if kind == "per_leaf":
        got = exchange.per_leaf_stats(qz, sizes, workers)
        want = jcomm.per_leaf_stats(jqz, sizes, workers)
        model = LM(get_config("lm-100m"))
        ap = model.abstract_params()
        lex = exchange.LeafExchange.build(QuantPolicy.parse(scheme), ap,
                                          paths=model.param_paths(ap))
        assert lex.path_sizes == tuple(path_sizes)
        assert lex.launches_and_bytes(workers) == got
    elif kind == "fused":
        got = exchange.fused_stats(qz, sizes, workers)
        want = jcomm.fused_stats(jqz, sizes, workers)
    else:
        model = LM(get_config("lm-100m"))
        ap = model.abstract_params()
        pex = exchange.PartitionedExchange.build(
            QuantPolicy.parse(scheme), ap, paths=model.param_paths(ap),
            pipeline_chunks=4)
        jmodel = JLM(jget_config("lm-100m"))
        jap = jax.eval_shape(jmodel.init, jax.random.key(0))
        jpex = jcomm.PartitionedExchange.build(
            JPolicy.parse(scheme), jap, ("data",),
            paths=jmodel.param_paths(jap), pipeline_chunks=4)
        got = pex.launches_and_bytes(workers)
        want = (jpex.collective_launches(),
                jpex.wire_bytes_per_worker(workers))
    assert got == want == LM100M_TABLE[row]


MIXED_POLICY = "norm|bias=fp,default=orq-9"      # benchmarks/comm_cost.py


@pytest.mark.parametrize("arch", ["lm-100m", "lm-100m-smoke"])
@pytest.mark.parametrize("sharded", [False, True])
def test_policy_stats_match_reference(arch, sharded):
    """The mixed recipe of ``benchmarks/comm_cost.py`` at 4 workers, with
    the fsdp plan's sharded leaves as the reference plans them."""
    from repro.configs.base import get_smoke_config as jget_smoke_config
    from repro.train.step import plan_sharding_shapes
    from repro_torch.configs.base import get_smoke_config
    smoke = arch.endswith("-smoke")
    jcfg = (jget_smoke_config if smoke else jget_config)("lm-100m")
    jmodel = JLM(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0))
    jps = list(zip(jax.tree_util.tree_leaves(jmodel.param_paths(shapes)),
                   [int(np.prod(x.shape))
                    for x in jax.tree_util.tree_leaves(shapes)]))
    model = LM((get_smoke_config if smoke else get_config)("lm-100m"))
    ap = model.abstract_params()
    pex = exchange.PartitionedExchange.build(QuantPolicy.parse("fp"), ap,
                                             paths=model.param_paths(ap))
    assert [(s.path, s.size) for s in pex.layout.slots] == jps
    paths = None
    if sharded:
        plan = plan_sharding_shapes(jmodel, shapes, dp_axes=("data",),
                                    axis_sizes={"data": 4, "model": 1})
        paths = {p for p, d in plan.full_shard_dims().items()
                 if d is not None}
        assert paths
    got = {cap: exchange.policy_stats(
        QuantPolicy.parse(MIXED_POLICY, bucket_size=512), jps, 4,
        max_chunk_elems=cap, sharded_paths=paths) for cap in (None, 1 << 20)}
    for cap, stats in got.items():
        assert stats == jcomm.policy_stats(
            JPolicy.parse(MIXED_POLICY, bucket_size=512), jps, 4,
            max_chunk_elems=cap, sharded_paths=paths)
    if not smoke and not sharded:
        # comm_cost's row for lm-100m: 92.04 MiB per worker
        assert round(got[None][1] / 2 ** 20, 2) == 92.04
