"""The port's Algorithm-2 exchange with BinGrad-b, TernGrad and SignSGD on 4
gloo processes against the reference on 4 fake XLA devices (a subprocess,
as ``tests/test_comm.py`` runs them), same inputs and keys; orq-9 is in
``test_torch_exchange.py``.

The buffer holds multiples of 1/64 in [-1, 1], so every row sum and
prefix sum of phase 1's fit is exact in float32 in any order: phase 1
(the mean the server decodes, ``norequant``) and each worker's EF qdq are
bit-equal for every scheme. Phase 2 re-fits the averaged chunk: for
TernGrad that fit is a max, exact again, so the full exchange is
bit-equal; BinGrad-b's and SignSGD's phase-1 levels are means (row sums
over counts) and their average lies off the grid, so the phase-2 re-fit
sums in another order than XLA's. There the full exchange is held within
``RTOL`` of the buffer's magnitude (a level an ulp apart moves every
value of its bucket) and the share of values that differ is printed.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from torch_test_env import port_test_env  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 4
N = 3 * 2 * 512 * L + 301          # ragged: the last chunk is partial
SCHEMES = ("bingrad-b", "terngrad", "signsgd")
EXACT_PHASE2 = ("terngrad",)
RTOL = 1e-5

JAX_PROG = """
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import comm, make_quantizer
from repro.utils.compat import shard_map

SCHEMES, out_path, in_path = {schemes!r}, sys.argv[1], sys.argv[2]
mesh = jax.make_mesh((4,), ("data",))
DP = ("data",)

def smap(f, n_in):
    return jax.jit(shard_map(f, mesh=mesh, in_specs=(P("data"),) * n_in,
                             out_specs=P("data"), axis_names={{"data"}},
                             check_vma=False))

data = np.load(in_path)
g, e = jnp.asarray(data["q64"]), jnp.asarray(data["ef0"])
res = {{}}
for name in SCHEMES:
    qz = make_quantizer(name, bucket_size=512)
    def allreduce(g):
        return comm.quantized_all_reduce_mean(g[0], qz, jax.random.key(11),
                                              DP)[None]
    def norequant(g):
        return comm.quantized_all_reduce_mean(
            g[0], qz, jax.random.key(11), DP, server_requant=False)[None]
    def ef(g, e):
        x = g[0] + e[0]
        return (x - comm.local_qdq_comm_layout(x, qz, jax.random.key(5),
                                               DP))[None]
    res[name + "/allreduce"] = np.asarray(smap(allreduce, 1)(g))
    res[name + "/norequant"] = np.asarray(smap(norequant, 1)(g))
    res[name + "/ef"] = np.asarray(smap(ef, 2)(g, e))
np.savez(out_path, **res)
"""

TORCH_PROG = """
import sys, numpy as np, torch, torch.distributed as dist
from repro_torch.core import prng
from repro_torch.core.api import make_quantizer
from repro_torch.core.comm import collectives

SCHEMES = {schemes!r}
rank, out_path, in_path, rdv = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=4)
data = np.load(in_path)
g = torch.from_numpy(data["q64"][rank].copy())
x = g + torch.from_numpy(data["ef0"][rank].copy())
res = {{}}
for name in SCHEMES:
    qz = make_quantizer(name, bucket_size=512)
    res[name + "/allreduce"] = collectives.quantized_all_reduce_mean(
        g, qz, prng.key(11)).numpy()
    res[name + "/norequant"] = collectives.quantized_all_reduce_mean(
        g, qz, prng.key(11), server_requant=False).numpy()
    res[name + "/ef"] = (x - collectives.local_qdq_comm_layout(
        x, qz, prng.key(5))).numpy()
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
    tmp = tmp_path_factory.mktemp("exchange_schemes")
    rng = np.random.default_rng(1)
    inp = tmp / "inputs.npz"
    np.savez(inp, q64=rng.integers(-64, 65, (L, N)).astype(np.float32) / 64,
             ef0=rng.integers(-8, 9, (L, N)).astype(np.float32) / 512)
    fmt = dict(schemes=SCHEMES)
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


@pytest.mark.parametrize("what", ["norequant", "ef"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_phase1_and_ef_bit_equal(runs, scheme, what):
    jx, tr = runs
    want = jx[f"{scheme}/{what}"]
    for r in range(L):
        np.testing.assert_array_equal(tr[r][f"{scheme}/{what}"], want[r])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_full_exchange_matches(runs, scheme):
    jx, tr = runs
    want = jx[f"{scheme}/allreduce"]
    for r in range(L):
        got = tr[r][f"{scheme}/allreduce"]
        if scheme in EXACT_PHASE2:
            np.testing.assert_array_equal(got, want[r])
        else:
            print(f"{scheme}: {int((got != want[r]).sum())} of {got.size} "
                  f"values differ")
            assert np.all(np.abs(got - want[r]) <= RTOL * np.abs(want).max())


@pytest.mark.parametrize("scheme", SCHEMES)
def test_workers_agree(runs, scheme):
    """Phase 2's decode is deterministic: every worker holds the same
    mean."""
    _, tr = runs
    for what in ("allreduce", "norequant"):
        for r in range(1, L):
            np.testing.assert_array_equal(tr[r][f"{scheme}/{what}"],
                                          tr[0][f"{scheme}/{what}"])
