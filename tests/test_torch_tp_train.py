"""Model parallelism in training: the port on gloo worlds with a model
axis, held against the JAX reference and against the port's own worlds
without one.

Two worlds run once per module, concurrently: a 1 (data) x 2 (model)
world of two processes and a 2 x 2 world of four, each on its own
``file://`` rendezvous (``launch.mesh.make_host_mesh(model=2)``).

* The TP forward and its gradients (1 x 2, smoke lm-100m and mixtral,
  the reference's initial params and tokens): the loss and the logits
  within the bf16 bounds of ``test_torch_archs.py`` / ``test_torch_moe.py``
  against the reference's unsharded ones (``ATOL_BF16`` of the largest
  logit, ``GRAD_REL`` relative norm per leaf); against the port's world
  of one the stated, tighter TP_LOGITS_ATOL and TP_GRAD_REL. The
  readings on this CPU: logits bit-equal (0.0), gradients <= 2.6e-5
  (lm-100m) and <= 3.6e-3 (mixtral: the MoE dispatch's bf16 parts of dx
  are rounded before they are added over the model axis).
* Replicated mode on the loss ``sum(p * G)`` (every rank's gradient is
  its block of G): two orq-9 steps with error feedback and two BinGrad-b
  steps give params (gathered over ``model``), EF and accounting
  BIT-EQUAL to the port's world without a model axis of the same dp size
  (its dp group), which ``test_torch_train_ef.py`` holds to the reference.
* fsdp: the per-leaf gather's backward on each rank's TP block of a
  cotangent is bit-equal to the reference's ``reduce_scatter_mean_block``
  of that block on ``jax.make_mesh((n_dp,), ("data",))`` (fake devices),
  keyed ``fold_in(key, dp index)`` on every model rank.
* Wire bytes per dp worker and collective launches: replicated, the
  reference's ``policy_stats`` of the full tree at L = n_dp; per-leaf
  fsdp, the reference's ``rs_stats`` of each TP block.
* ``launch.train --model-parallel 2``: ``--state-checkpoint`` /
  ``--resume`` reproduce the uninterrupted run's digest bit for bit
  (replicated with error feedback, and fsdp), replicas in sync.
* Every refusal under a model axis names ROADMAP.md.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jsave
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core.comm.exchange import GradientExchange as JGradientExchange
from repro.core.comm.exchange import policy_stats as jpolicy_stats
from repro.core.policy import QuantPolicy as JPolicy
from repro.models.model import LM as JLM
from repro.train.step import plan_sharding_shapes as jplan
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.models import LM
from repro_torch.models import tp as tp_mod
from repro_torch.models.blocks import check_tp_layer
from repro_torch.utils.pytree import tree_leaves
from torch_test_env import port_test_env  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
ARCHS = ("lm-100m", "mixtral-8x22b")
ATOL_BF16 = 0.02          # of the logits' largest magnitude
GRAD_REL = 2e-2           # relative norm per leaf, against the reference
TP_LOGITS_ATOL = 1e-3     # of the largest logit, against the world of one
TP_GRAD_REL = 5e-3        # relative norm per leaf, against the world of one
LOSS_RTOL = 1e-3
LR = 0.05
BUCKET = 512
FSDP_LEAVES = ("embed", "g0/pos0['attn']['wq']", "g0/pos0['ffn']['wo']")
RS_KEY = 5


class TPLinear(LM):
    """The port's model with the loss ``sum(p * G)``; under a model axis
    each rank adds its blocks, so its gradient is its block of G."""

    def __init__(self, cfg, G):
        super().__init__(cfg)
        self.G = G

    def loss(self, params, batch, gather=None, *, tp=None, **kw):
        G = tree_leaves(self.G)
        if tp is not None:
            paths = tree_leaves(self.param_paths(self.G))
            G = [g if tp.dims.get(p) is None else tp_mod.own_block(
                tp.axis, g, tp.dims[p] + p.startswith("g"))
                for p, g in zip(paths, G)]
        loss = sum((p * g).sum() for p, g in zip(tree_leaves(params), G,
                                                  strict=True))
        return loss, {"nll": loss, "aux": 0.0, "tokens": torch.tensor(1.0)}


def shared_gradient(cfg):
    """G: one seeded normal draw per leaf, scaled by 1e-2."""
    rng = np.random.default_rng(3)
    return _tree_map_np(
        lambda t: torch.from_numpy(
            rng.standard_normal(tuple(t.shape)).astype(np.float32) * 1e-2),
        LM(cfg).abstract_params())


def _tree_map_np(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map_np(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map_np(fn, v) for v in tree)
    return fn(tree)


def cotangent(shape, worker):
    """A per-repeat leaf's cotangent on dp worker ``worker`` (f32)."""
    return (np.random.default_rng(1000 + worker).standard_normal(shape)
            .astype(np.float32) * 1e-2)


TORCH_PROG = """
import json, sys
import numpy as np, torch, torch.distributed as dist
sys.path.insert(0, {tests!r})
torch.set_num_threads(1)
rank, ws, out, rdv = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=ws)
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import prng
from repro_torch.core.comm.gather import make_fsdp_gather
from repro_torch.core.policy import BitBudgetController, BitSchedule
from repro_torch.core.policy import QuantPolicy
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LM
from repro_torch.models import tp as tp_mod
from repro_torch.optim.schedule import constant_lr
from repro_torch.train import TrainConfig, init_state, make_train_step
from repro_torch.train.step import (ModelShards, ScheduledTrainStep,
                                    StateSharding, plan_sharding)
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten
from test_torch_tp_train import (BUCKET, FSDP_LEAVES, LR, RS_KEY, TPLinear,
                                 cotangent, shared_gradient)

mesh = make_host_mesh(model=2)
rows, arrays = dict(coords=mesh.coords, n_dp=mesh.n_dp), dict()

def put(name, t):
    arrays[name] = t.detach().to(torch.float32).numpy()

if mesh.n_dp == 1:
    for arch in ("lm-100m", "mixtral-8x22b"):
        model = LM(get_smoke_config(arch))
        like = model.init(torch.Generator().manual_seed(0), device="cpu")
        params, _ = load_checkpoint(out + "/" + arch + "_params", like)
        tokens = torch.from_numpy(np.load(out + "/" + arch + "_tokens.npy"))
        sh = ModelShards(mesh.model_axis, plan_sharding(
            model, model.abstract_params(), mesh))
        paths = tree_leaves(model.param_paths(params))
        for name, p0, kw in (("tp", sh.block(params), dict(tp=sh.model_tp)),
                             ("one", params, dict())):
            p = tree_map(lambda t: t.detach().requires_grad_(True), p0)
            loss, _ = model.loss(p, dict(tokens=tokens), **kw)
            g = tree_unflatten(p0, list(torch.autograd.grad(
                loss, tree_leaves(p))))
            if name == "tp":
                g = sh.full(g)
            lg, _ = model.logits(p0, tokens, **kw)
            put(arch + "/" + name + "/loss", loss)
            put(arch + "/" + name + "/logits", lg)
            for path, x in zip(paths, tree_leaves(g)):
                put(arch + "/" + name + "/grad/" + path, x)

# replicated: the TP step against the dp group's own step, sum(p * G)
cfg = get_smoke_config("lm-100m")
model = TPLinear(cfg, shared_gradient(cfg))
tokens = torch.zeros((1, 16), dtype=torch.int64)
rows["replicated"] = {{}}
for quant, ef in (("orq-9", True), ("bingrad-b", False)):
    tcfg = TrainConfig(policy=QuantPolicy.parse(quant, bucket_size=BUCKET),
                       error_feedback=ef)
    fn_tp = make_train_step(model, tcfg, constant_lr(LR), mesh=mesh)
    fn_dp = make_train_step(model, tcfg, constant_lr(LR),
                            group=mesh.dp_group)
    s_tp = init_state(model, tcfg, device="cpu", step=fn_tp)
    s_dp = init_state(model, tcfg, device="cpu", step=fn_dp)
    c0 = mesh.model_axis.collectives
    for i in range(2):
        s_tp, _ = fn_tp(s_tp, dict(tokens=tokens), prng.key(0))
        s_dp, _ = fn_dp(s_dp, dict(tokens=tokens), prng.key(0))
    full = StateSharding(fn_tp).full_params(s_tp.params)
    ef_equal = None
    if ef:
        ef_equal = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(fn_tp.tp.full(s_tp.ef)), tree_leaves(s_dp.ef)))
    rows["replicated"][quant] = dict(
        params_equal=all(torch.equal(a, b) for a, b in zip(
            tree_leaves(full), tree_leaves(s_dp.params))),
        ef_equal=ef_equal,
        tp_stats=list(fn_tp.launches_and_bytes(mesh.n_dp)),
        dp_stats=list(fn_dp.launches_and_bytes(mesh.n_dp)),
        model_collectives=(mesh.model_axis.collectives - c0) // 2)

# fsdp: the per-leaf gather's backward on this rank's TP blocks
tcfg = TrainConfig(policy=QuantPolicy.parse("orq-9", bucket_size=BUCKET),
                   mode="fsdp")
fn = make_train_step(model, tcfg, constant_lr(LR), mesh=mesh)
plan = fn.layout.plan
rows["fsdp_stats"] = list(fn.launches_and_bytes(mesh.n_dp))
aparams = dict(zip(tree_leaves(plan.paths),
                   tree_leaves(model.abstract_params())))
qz = tcfg.resolved_policy().resolve("x").to_quantizer()
for path in FSDP_LEAVES:
    off = int(path.startswith("g"))
    shape = tuple(aparams[path].shape[off:])
    fdim, tdim = plan.gather_dims[path], plan.tp_dims[path]
    cot = torch.from_numpy(cotangent(shape, mesh.dp_axis.index))
    cot = tp_mod.own_block(mesh.model_axis, cot, tdim).to(torch.bfloat16)
    sshape = list(cot.shape)
    sshape[fdim] //= mesh.n_dp
    w = torch.zeros(sshape, requires_grad=True)
    gather = make_fsdp_gather(qz, mesh.dp_group, dim=fdim, tp_dim=tdim)
    y = gather(w, prng.key(RS_KEY))
    y.backward(cot)
    put("fsdp/" + path, w.grad)

# refusals under the model axis
refusals = {{}}
try:
    sched = BitSchedule.parse("default=orq@5..3", bucket_size=BUCKET)
    ScheduledTrainStep(model, TrainConfig(), BitBudgetController(
        sched, total_steps=4, resolve_every=2), mesh=mesh)
except NotImplementedError as e:
    refusals["bit_schedule"] = str(e)
if ws == 4:
    pmesh = make_host_mesh(model=2, pods=2)
    try:
        make_train_step(model, TrainConfig(
            hierarchy="two_level_async", local_steps=2), mesh=pmesh)
    except NotImplementedError as e:
        refusals["two_level_async"] = str(e)
rows["refusals"] = refusals

# the launcher: --resume against the uninterrupted run
base = ["--smoke", "--device", "cpu", "--quant", "orq-9", "--bucket",
        str(BUCKET), "--batch", "2", "--seq", "16", "--model-parallel", "2",
        "--log-every", "100", "--steps", "2"]
rows["launcher"] = {{}}
for mode, extra in (("replicated", ["--error-feedback"]),
                    ("fsdp", ["--mode", "fsdp"])):
    ck = out + "/ck_" + mode + "_" + str(ws)
    runs = [launcher.train(base + extra),
            launcher.train(base + extra + ["--state-checkpoint", ck,
                                           "--checkpoint-at", "1"]),
            launcher.train(base + extra + ["--resume", ck])]
    rows["launcher"][mode] = dict(
        digests=[r["params_sha256"] for r in runs],
        in_sync=[r["replicas_in_sync"] for r in runs],
        wire=runs[0]["wire_bytes_per_worker"],
        launches=runs[0]["collective_launches_per_step"],
        model_collectives=runs[0]["model_collectives_per_step"])
np.savez(out + "/r" + str(ws) + "_" + str(rank) + ".npz", **arrays)
print("ROWS " + json.dumps(rows), flush=True)
dist.destroy_process_group()
"""

JAX_RS_PROG = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, {tests!r})
from repro.configs.base import get_smoke_config
from repro.core.comm.fsdp_exchange import reduce_scatter_mean_block
from repro.core.policy import QuantPolicy
from repro.models.model import LM
from repro.train.step import plan_sharding_shapes
from repro.utils.compat import shard_map
from test_torch_tp_train import BUCKET, FSDP_LEAVES, RS_KEY, cotangent

out = sys.argv[1]
model = LM(get_smoke_config("lm-100m"))
shapes = jax.eval_shape(model.init, jax.random.key(0))
paths = jax.tree_util.tree_leaves(model.param_paths(shapes))
leaves = dict(zip(paths, jax.tree_util.tree_leaves(shapes)))
qz = QuantPolicy.parse("orq-9", bucket_size=BUCKET).resolve("x") \\
    .to_quantizer()
res = {{}}
for n_dp in (1, 2):
    mesh = jax.make_mesh((n_dp,), ("data",), devices=jax.devices()[:n_dp])
    plan = plan_sharding_shapes(model, shapes, dp_axes=("data",),
                                axis_sizes={{"data": n_dp, "model": 2}})
    for path in FSDP_LEAVES:
        off = int(path.startswith("g"))
        shape = tuple(leaves[path].shape[off:])
        fdim, tdim = plan.gather_dims[path], plan.tp_dims[path]
        cots = np.stack([cotangent(shape, w) for w in range(n_dp)])
        for m in range(2):
            blk = np.split(cots, 2, axis=1 + tdim)[m]

            def body(g, fdim=fdim):
                key = jax.random.fold_in(jax.random.key(RS_KEY),
                                         jax.lax.axis_index("data"))
                return reduce_scatter_mean_block(
                    g[0], qz, key, ("data",), dim=fdim)[None]

            fn = jax.jit(shard_map(body, mesh=mesh, in_specs=P("data"),
                                   out_specs=P("data"),
                                   axis_names={{"data"}}, check_vma=False))
            got = np.asarray(fn(jnp.asarray(blk).astype(jnp.bfloat16)))
            for w in range(n_dp):
                res[f"{{n_dp}}/{{path}}/{{w}}/{{m}}"] = got[w]
np.savez(out + "/ref_rs.npz", **res)
"""


def _env(extra):
    return {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
            "JAX_PLATFORMS": "cpu", **extra}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's params and tokens; then both gloo worlds and the
    reference's reduce-scatters, while the reference's loss, logits and
    gradients are computed here."""
    tmp = tmp_path_factory.mktemp("tp_train")
    jparams, toks = {}, {}
    for i, arch in enumerate(ARCHS):
        jm = JLM(jget_smoke_config(arch))
        jparams[arch] = p = jm.init(jax.random.key(i))
        toks[arch] = np.asarray(jax.random.randint(
            jax.random.key(10 + i), (2, 17), 0, jm.cfg.vocab_size))
        jsave(str(tmp / f"{arch}_params"),
              jax.tree_util.tree_map(np.asarray, p))
        np.save(tmp / f"{arch}_tokens.npy", toks[arch])
    fmt = dict(tests=TESTS)
    jax_rs = subprocess.Popen(
        [sys.executable, "-c", JAX_RS_PROG.format(**fmt), str(tmp)],
        env=_env({"XLA_FLAGS": "--xla_force_host_platform_device_count=2"}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    src = TORCH_PROG.format(**fmt)
    procs = {}
    for ws in (2, 4):
        rdv = tmp / f"rdv{ws}"
        procs[ws] = [subprocess.Popen(
            [sys.executable, "-c", src, str(r), str(ws), str(tmp), str(rdv)],
            env=_env({"OMP_NUM_THREADS": "1"}), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(ws)]
    ref = {}
    for arch in ARCHS:
        jm, p, tokens = JLM(jget_smoke_config(arch)), jparams[arch], \
            jnp.asarray(toks[arch])
        loss, g = jax.value_and_grad(
            lambda p: jm.loss(p, {"tokens": tokens})[0])(p)
        lg, _ = jm.logits(p, tokens)
        paths = jax.tree_util.tree_leaves(jm.param_paths(p))
        ref[arch] = dict(loss=float(loss), logits=np.asarray(lg, np.float32),
                         grads=dict(zip(paths, map(
                             np.asarray, jax.tree_util.tree_leaves(g)))))
    rows = {}
    for ws, ps in procs.items():
        outs = [p.communicate(timeout=900)[0] for p in ps]
        assert [p.returncode for p in ps] == [0] * ws, outs
        rows[ws] = [json.loads([ln for ln in o.splitlines()
                                if ln.startswith("ROWS ")][-1][5:])
                    for o in outs]
    jout = jax_rs.communicate(timeout=900)[0]
    assert jax_rs.returncode == 0, jout
    arrays = {ws: [dict(np.load(tmp / f"r{ws}_{r}.npz")) for r in range(ws)]
              for ws in (2, 4)}
    return dict(ref=ref, rows=rows, arrays=arrays,
                ref_rs=dict(np.load(tmp / "ref_rs.npz")))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_forward_and_gradients(run, arch):
    a, ref = run["arrays"][2][0], run["ref"][arch]
    tp = {k[len(arch) + 4:]: v for k, v in a.items()
          if k.startswith(arch + "/tp/")}
    one = {k[len(arch) + 5:]: v for k, v in a.items()
           if k.startswith(arch + "/one/")}
    np.testing.assert_allclose(float(tp["loss"]), ref["loss"],
                               rtol=LOSS_RTOL)
    big = np.abs(ref["logits"]).max()
    np.testing.assert_allclose(tp["logits"], ref["logits"], rtol=0,
                               atol=ATOL_BF16 * big)
    np.testing.assert_allclose(tp["logits"], one["logits"], rtol=0,
                               atol=TP_LOGITS_ATOL * big)
    np.testing.assert_allclose(float(tp["loss"]), float(one["loss"]),
                               rtol=1e-6)
    for path, w in ref["grads"].items():
        g = tp["grad/" + path]
        assert _rel(g, w) <= GRAD_REL, path
        assert _rel(g, one["grad/" + path]) <= TP_GRAD_REL, path


@pytest.mark.parametrize("quant", ["orq-9", "bingrad-b"])
@pytest.mark.parametrize("ws", [2, 4])
def test_replicated_tp_bit_equal_to_dp_world(run, ws, quant):
    n_dp = ws // 2
    cfg = get_smoke_config("lm-100m")
    sizes = [(p, x.numel()) for p, x in zip(
        tree_leaves(LM(cfg).param_paths(LM(cfg).abstract_params())),
        tree_leaves(LM(cfg).abstract_params()))]
    want = jpolicy_stats(JPolicy.parse(quant, bucket_size=BUCKET), sizes,
                         n_dp)
    for r in run["rows"][ws]:
        row = r["replicated"][quant]
        assert row["params_equal"], (r["coords"], quant)
        assert row["ef_equal"] in (None, True), (r["coords"], quant)
        assert row["tp_stats"] == row["dp_stats"] == [want[0], want[1]]
        # one all-reduce gathers the gradient's TP blocks, plus the
        # forward's and backward's model-group collectives
        assert row["model_collectives"] > 0


@pytest.mark.parametrize("path", FSDP_LEAVES)
@pytest.mark.parametrize("ws", [2, 4])
def test_fsdp_tp_block_gradient_bit_equal(run, ws, path):
    n_dp = ws // 2
    for r, a in zip(run["rows"][ws], run["arrays"][ws]):
        w, m = r["coords"]["data"], r["coords"]["model"]
        want = run["ref_rs"][f"{n_dp}/{path}/{w}/{m}"]
        got = a["fsdp/" + path]
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ws", [2, 4])
def test_per_leaf_fsdp_accounting(run, ws):
    """The reference's ``rs_stats`` of each TP block (each leaf once a
    repeat), its Algorithm 2 cost for a dp-replicated leaf."""
    n_dp = ws // 2
    jm = JLM(jget_smoke_config("lm-100m"))
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    plan = jplan(jm, shapes, dp_axes=("data",),
                 axis_sizes={"data": n_dp, "model": 2})
    qz = JPolicy.parse("orq-9", bucket_size=BUCKET).resolve("x") \
        .to_quantizer()
    launches, total = 0, 0.0
    for path, leaf in zip(jax.tree_util.tree_leaves(jm.param_paths(shapes)),
                          jax.tree_util.tree_leaves(shapes)):
        calls = leaf.shape[0] if path.startswith("g") else 1
        n = leaf.size // calls // (2 if plan.tp_dims[path] is not None
                                   else 1)
        assert plan.gather_dims[path] is not None
        c, b = JGradientExchange.rs_stats(qz, n, n_dp)
        launches, total = launches + calls * c, total + calls * b
    for r in run["rows"][ws]:
        assert r["fsdp_stats"] == [launches, total]
        assert r["launcher"]["fsdp"]["wire"] == total
        assert r["launcher"]["fsdp"]["launches"] == launches


@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
@pytest.mark.parametrize("ws", [2, 4])
def test_launcher_resume_bit_exact(run, ws, mode):
    digests = {tuple(r["launcher"][mode]["digests"])
               for r in run["rows"][ws]}
    assert len(digests) == 1
    (d,) = digests
    assert d[0] == d[1] == d[2]
    for r in run["rows"][ws]:
        assert all(r["launcher"][mode]["in_sync"])
        assert all(c > 0 for c in r["launcher"][mode]["model_collectives"])


def test_step_refusals_name_roadmap(run):
    for ws in (2, 4):
        for r in run["rows"][ws]:
            want = {"bit_schedule"} | ({"two_level_async"} if ws == 4
                                       else set())
            assert set(r["refusals"]) == want
            assert all("ROADMAP.md" in m for m in r["refusals"].values())


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-3b",
                                  "deepseek-v2-236b", "whisper-base"])
def test_layer_refusals_name_roadmap(arch):
    """MLA, Mamba, RWKV-6 and whisper are refused under a model axis
    (their plans are held in ``test_torch_tp_plan.py``)."""
    model = LM(get_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        model.check_tp(2)
    for spec in model.specs:
        if spec.kind in ("mamba", "rwkv"):
            with pytest.raises(NotImplementedError, match="ROADMAP.md"):
                check_tp_layer(model.cfg, spec, 2)
