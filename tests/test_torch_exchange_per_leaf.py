"""The port's per-leaf exchange (``LeafExchange``: the reference step's
``fused_exchange=False`` branch) against the JAX reference.

* Collectives: the port on 4 gloo processes against the reference on 4
  fake XLA devices (a subprocess, as ``tests/test_comm.py`` runs them),
  the reference's branch written out in its own terms
  (``quantized_all_reduce_mean`` / ``local_qdq_comm_layout`` per leaf,
  keys folded by the crc32 of each path), same inputs and keys, on
  gradients of multiples of 1/64 in [-1, 1] (every sum of a level fit
  exact in float32 in any order): each leaf's mean and its EF residual,
  under a mixed policy (fp biases), orq-9, BinGrad-b and SignSGD. At
  L = 4 and buckets of 512 the leaves include one-row leaves of 192 and
  13 values a worker and a leaf of 5 rows whose last has 256 valid.
  Exact for orq-9 and the mixed policy. Where levels are means
  (BinGrad-b, SignSGD) phase 2 re-fits an average that lies off the grid,
  so the means are held within RTOL of their magnitude; the EF residuals
  stay bit-equal (see ``test_torch_exchange_schemes.py``).
* The single-device per-leaf quantize-dequantize (in process): each
  leaf's ``Quantizer.qdq`` under the same key, bit-equal on such values.
"""
import os
import subprocess
import sys
import textwrap
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import QuantPolicy as JPolicy
from repro_torch.core import prng
from repro_torch.core.comm import exchange
from repro_torch.core.policy import QuantPolicy
from torch_test_env import port_test_env  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 4
MEAN_LEVELS = ("bingrad-b", "signsgd")
RTOL = 1e-5
TREE = {"w": (3, 700), "c_bias": (50,), "a": (1000,), "norm": (768,),
        "emb": (12, 768)}
LEAF_POLICIES = ("bias=fp,default=orq-9", "orq-9", "bingrad-b", "signsgd")
N_TREE = sum(int(np.prod(s)) for s in TREE.values())

COMMON = """
import sys, zlib, numpy as np
TREE, LEAF_POLICIES = {tree!r}, {leaf!r}
names = sorted(TREE)
sizes = [int(np.prod(TREE[k])) for k in names]

def split_tree(flat):
    out, o = {{}}, 0
    for k, n in zip(names, sizes):
        out[k] = flat[o:o + n].reshape(TREE[k])
        o += n
    return out

PATHS = {{k: k for k in TREE}}
"""

JAX_PROG = COMMON + """
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import comm
from repro.core.policy import QuantPolicy
from repro.utils.compat import shard_map

out_path, in_path = sys.argv[1], sys.argv[2]
mesh = jax.make_mesh((4,), ("data",))
DP = ("data",)

def smap(f, n_in):
    return jax.jit(shard_map(f, mesh=mesh, in_specs=(P("data"),) * n_in,
                             out_specs=P("data"), axis_names={{"data"}},
                             check_vma=False))

def per_leaf(g, e, spec):
    # the reference step's fused_exchange=False branch (train/step.py)
    policy = QuantPolicy.parse(spec, bucket_size=512)
    step_key = jax.random.fold_in(jax.random.key(0), 3)
    grads = jax.tree_util.tree_map(lambda a, b: a + b, split_tree(g),
                                   split_tree(e))
    def leaf_key(path):
        return jax.random.fold_in(step_key,
                                  zlib.crc32(path.encode()) & 0x7FFFFFFF)
    def exchange(path, x):
        cfg = policy.resolve(path)
        flat = x.astype(jnp.float32).reshape(-1)
        return comm.quantized_all_reduce_mean(
            flat, cfg.to_quantizer(), leaf_key(path), DP,
            server_requant=cfg.server_requant).reshape(x.shape)
    def residual(path, x):
        qz = policy.resolve(path).to_quantizer()
        if qz.is_identity:
            return jnp.zeros(x.shape, jnp.float32)
        flat = x.astype(jnp.float32).reshape(-1)
        return (flat - comm.local_qdq_comm_layout(
            flat, qz, leaf_key(path), DP)).reshape(x.shape)
    outs = jax.tree_util.tree_map(exchange, PATHS, grads)
    res = jax.tree_util.tree_map(residual, PATHS, grads)
    leaves = jax.tree_util.tree_leaves(outs) + jax.tree_util.tree_leaves(res)
    return jnp.concatenate([x.reshape(-1) for x in leaves])

data = np.load(in_path)
g, e = jnp.asarray(data["tree"]), jnp.asarray(data["tree_ef"])
res = {{}}
for spec in LEAF_POLICIES:
    res[spec] = np.asarray(smap(
        lambda x, y, spec=spec: per_leaf(x[0], y[0], spec)[None], 2)(g, e))
np.savez(out_path, **res)
"""

TORCH_PROG = COMMON + """
import torch, torch.distributed as dist
from repro_torch.core import prng
from repro_torch.core.comm import exchange
from repro_torch.core.policy import QuantPolicy

rank, out_path, in_path, rdv = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=4)
data = np.load(in_path)
g = split_tree(torch.from_numpy(data["tree"][rank].copy()))
e = split_tree(torch.from_numpy(data["tree_ef"][rank].copy()))
grads = {{k: g[k] + e[k] for k in names}}
step_key = prng.fold_in(prng.key(0), 3)
res = {{}}
for spec in LEAF_POLICIES:
    lex = exchange.LeafExchange(QuantPolicy.parse(spec, bucket_size=512))
    outs = lex.exchange(PATHS, grads, step_key)
    resid = lex.residuals(PATHS, grads, step_key)
    res[spec] = torch.cat([outs[k].reshape(-1) for k in names]
                          + [resid[k].reshape(-1) for k in names]).numpy()
np.savez(out_path, **res)
dist.destroy_process_group()
"""


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra or {})
    return env


def _q64(rng, *shape):
    return rng.integers(-64, 65, shape).astype(np.float32) / 64


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides once, concurrently: the reference on 4 fake devices, the
    port on 4 gloo processes (own ``file://`` rendezvous)."""
    tmp = tmp_path_factory.mktemp("exchange_per_leaf")
    rng = np.random.default_rng(3)
    inp = tmp / "inputs.npz"
    np.savez(inp, tree=_q64(rng, L, N_TREE),
             tree_ef=rng.integers(-8, 9, (L, N_TREE)).astype(np.float32)
             / 512)
    fmt = dict(tree=TREE, leaf=LEAF_POLICIES)
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


@pytest.mark.parametrize("spec", LEAF_POLICIES)
def test_per_leaf_exchange_and_ef_match(runs, spec):
    """Each leaf's mean (first half) and EF residual (second half)."""
    jx, tr = runs
    for r in range(L):
        got, want = tr[r][spec], jx[spec][r]
        assert got.shape == want.shape == (2 * N_TREE,)
        if spec in MEAN_LEVELS:
            assert np.all(np.abs(got[:N_TREE] - want[:N_TREE])
                          <= RTOL * np.abs(want[:N_TREE]).max())
        else:
            np.testing.assert_array_equal(got[:N_TREE], want[:N_TREE])
        np.testing.assert_array_equal(got[N_TREE:], want[N_TREE:])


@pytest.mark.parametrize("spec", LEAF_POLICIES)
def test_per_leaf_workers_agree(runs, spec):
    """Phase 2's decode is deterministic: every worker holds the same
    means."""
    _, tr = runs
    for r in range(1, L):
        np.testing.assert_array_equal(tr[r][spec][:N_TREE],
                                      tr[0][spec][:N_TREE])


@pytest.mark.parametrize("spec", LEAF_POLICIES)
def test_single_device_per_leaf_qdq_matches(spec):
    """The single-device branch's per-leaf quantize-dequantize: the
    reference's ``qz.qdq`` of each leaf under its crc32 key."""
    rng = np.random.default_rng(4)
    grads = {k: _q64(rng, *s) for k, s in TREE.items()}
    paths = {k: k for k in TREE}
    jpol = JPolicy.parse(spec, bucket_size=512)
    jkey = jax.random.fold_in(jax.random.key(0), 3)
    lex = exchange.LeafExchange(QuantPolicy.parse(spec, bucket_size=512))
    got = lex.qdq_local(paths, {k: torch.from_numpy(v)
                                for k, v in grads.items()},
                        prng.fold_in(prng.key(0), 3))
    for k, g in grads.items():
        qz = jpol.resolve(k).to_quantizer()
        want = (g if qz.is_identity else np.asarray(qz.qdq(
            jnp.asarray(g).reshape(-1), jax.random.fold_in(
                jkey, zlib.crc32(k.encode()) & 0x7FFFFFFF))).reshape(g.shape))
        np.testing.assert_array_equal(got[k].numpy(), want)
