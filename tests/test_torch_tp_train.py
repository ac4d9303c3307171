"""Model parallelism in training: the port on gloo worlds with a model
axis, held against the JAX reference and against the port's own worlds
without one.

Two worlds run once per module, concurrently: a 1 (data) x 2 (model)
world of two processes and a 2 x 2 world of four, each on its own
``file://`` rendezvous (``launch.mesh.make_host_mesh(model=2)``); the
world of four also lays a (1, 4) mesh and a (pod, data, model) = (2, 1,
2) one over its ranks.

* The TP forward and its gradients (smoke lm-100m, mixtral, jamba, rwkv6,
  deepseek and whisper, the reference's initial params, tokens and, for
  whisper, frames; over 2 model ranks, and over 4 on the (1, 4) mesh,
  where mixtral's and jamba's 2 KV heads do not split), and whisper's
  smoke config cut so that its heads do not split (``tp_cuts.CUTS``;
  its weights the port's init, zero leaves drawn): against the port's world
  of one the stated
  TP_LOGITS_ATOL and TP_GRAD_REL; over 2 ranks also the loss, the logits
  and the gradients (for jamba, rwkv6, deepseek and whisper on their own
  tests' weights and tokens, ``DRAWN``) within the bf16 bounds of
  ``test_torch_archs.py`` / ``test_torch_moe.py`` against the
  reference's unsharded ones (``ATOL_BF16`` of the largest logit,
  ``GRAD_REL`` relative norm per leaf), jamba and deepseek routed as the
  reference routed (its expert ids recorded in its forward, as
  ``test_torch_moe.py`` holds them; mixtral routes freely). The
  readings on this CPU: logits bit-equal (0.0) to the world of one,
  gradients <= 2.1e-3 (every place where several ranks add parts of a
  gradient adds them in float32 and rounds once, where the world of one
  rounds).
* Replicated mode on the loss ``sum(p * G)`` (every rank's gradient is
  its block of G), for lm-100m, jamba, rwkv6, deepseek and whisper: two
  orq-9 steps with error feedback and two BinGrad-b steps give params
  (gathered over ``model``), EF and accounting BIT-EQUAL to the port's
  world without a model axis of the same dp size (its dp group), which
  ``test_torch_train_ef.py`` holds to the reference; one per-leaf fsdp
  step each.
* The bit schedule (``ScheduledTrainStep``, orq@5..3 resolved every 2
  steps) and two_level_async (H = 2 on (2, 1, 2), error feedback) under
  the model axis: params bit-equal to the dp group's own steps, bytes a
  width equal; async H = 1 ends on two_level's params.
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
* ``LM.check_tp`` passes every registered config, full and smoke, over
  2 and 4 model ranks, and refuses experts, RWKV-6 heads and MLA heads
  that do not split (``tp_cuts.REFUSED``).
"""
import hashlib
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
from repro_torch.configs.base import get_config, get_smoke_config, list_archs
from repro_torch.models import LM
from repro_torch.models import tp as tp_mod
from repro_torch.utils.pytree import tree_leaves, tree_unflatten
from test_torch_archs import _weights
from test_torch_moe import _record_routing
from torch_test_env import port_test_env  # noqa: F401
from tp_cuts import CUTS, REFUSED, smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
ARCHS = ("lm-100m", "mixtral-8x22b", "jamba-v0.1-52b", "rwkv6-3b",
         "deepseek-v2-236b", "whisper-base")
# held against the reference on their own tests' inputs, under whose
# bounds they are held there: weights drawn as ``test_torch_archs.
# _weights`` draws them (the port's init, its zero leaves drawn)
DRAWN = ("jamba-v0.1-52b", "rwkv6-3b", "deepseek-v2-236b", "whisper-base")
# the MoE models among them, routed as the reference routed, as their own
# tests hold them (bf16 drift flips a near-tied router on those weights);
# mixtral, on the reference's initial params, routes freely
ROUTED = ("jamba-v0.1-52b", "deepseek-v2-236b")
SEQ_DRAWN = 65            # and tokens (test_torch_moe.py _tokens(6, SEQ + 1))
STEP_ARCHS = ("lm-100m", "jamba-v0.1-52b", "rwkv6-3b", "deepseek-v2-236b",
              "whisper-base")
ATOL_BF16 = 0.02          # of the logits' largest magnitude
GRAD_REL = 2e-2           # relative norm per leaf, against the reference
TP_LOGITS_ATOL = 1e-3     # of the largest logit, against the world of one
TP_GRAD_REL = 5e-3        # relative norm per leaf, against the world of one
LOSS_RTOL = 1e-3
LR = 0.05
BUCKET = 512
FSDP_LEAVES = ("embed", "g0/pos0['attn']['wq']", "g0/pos0['ffn']['wo']")
RS_KEY = 5


def _arch_id(*parts):
    """A case's id without lm-100m's name (the ids its cases had before the
    other archs joined them)."""
    return "-".join(p for p in parts if p != "lm-100m")


def _stacked(path):
    return path.startswith("g") or path.startswith("enc/g")


class TPLinear(LM):
    """The port's model with the loss ``sum(p * G)``; under a model axis
    each rank adds its blocks, so its gradient is its block of G (through
    the per-leaf fsdp gathers, each repeat's slice)."""

    def __init__(self, cfg, G):
        super().__init__(cfg)
        self.G = G

    def loss(self, params, batch, gather=None, *, tp=None, **kw):
        G = tree_leaves(self.G)
        paths = tree_leaves(self.param_paths(self.G))
        if gather is not None:
            params = tree_unflatten(params, [
                torch.stack([gather(p, x[r], r) for r in range(x.shape[0])])
                if _stacked(p) else gather(p, x, 0)
                for p, x in zip(paths, tree_leaves(params))])
        if tp is not None:
            G = [g if tp.dims.get(p) is None else tp_mod.own_block(
                tp.axis, g, tp.dims[p] + _stacked(p))
                for p, g in zip(paths, G)]
        loss = sum((p * g.to(p.dtype)).sum()
                   for p, g in zip(tree_leaves(params), G, strict=True))
        return loss, {"nll": loss, "aux": 0.0, "tokens": torch.tensor(1.0)}


def params_digest_of(tree):
    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


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
import itertools, json, os, sys, time
import numpy as np, torch, torch.distributed as dist
sys.path.insert(0, {tests!r})
torch.set_num_threads(1)
rank, ws, out, rdv = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=ws)
from repro_torch.checkpoint import load_checkpoint
from repro_torch.core import prng
from repro_torch.core.comm.gather import make_fsdp_gather
from repro_torch.core.policy import BitBudgetController, BitSchedule
from repro_torch.core.policy import QuantPolicy
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LM, moe
from repro_torch.models import tp as tp_mod
from repro_torch.optim.schedule import constant_lr
from repro_torch.train import TrainConfig, init_state, make_train_step
from repro_torch.train.step import (ModelShards, ScheduledTrainStep,
                                    StateSharding, plan_sharding)
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten
from test_torch_tp_train import (ARCHS, BUCKET, FSDP_LEAVES, LR, ROUTED,
                                 RS_KEY, STEP_ARCHS, TPLinear, cotangent,
                                 params_digest_of, shared_gradient)
from tp_cuts import CUTS, smoke

mesh = make_host_mesh(model=2)
rows, arrays = dict(coords=mesh.coords, n_dp=mesh.n_dp), dict()
# the dp world's steps, the baselines, run on model index 0 (every model
# rank gathers the same full params: their digests are compared instead)
lead = mesh.model_axis.index == 0
top_k = moe.top_k

def put(name, t):
    arrays[name] = t.detach().to(torch.float32).numpy()

def routed_as_reference(arch):
    # the expert ids of the reference's MoE calls (its forward), waited
    # for while the reference computes; top_k then returns them call by
    # call, cycling over the forwards
    done = out + "/" + arch + "_routes.done"
    while not os.path.exists(done):
        time.sleep(0.2)
    ids = np.load(out + "/" + arch + "_routes.npz")
    calls = itertools.cycle([torch.from_numpy(ids[k]).long()
                             for k in sorted(ids, key=int)])

    def forced(probs, k):
        idx = next(calls)
        return torch.gather(probs, -1, idx), idx

    return forced

def load(arch, pre, model):
    # params (or the port's init, its zero leaves drawn, for a cut
    # config) and the batch saved under "<arch><pre>", once written
    while not os.path.exists(out + "/inputs.done"):
        time.sleep(0.2)
    src = arch.split("/")[0]
    like = model.init(torch.Generator().manual_seed(0), device="cpu")
    if src == arch:
        params, _ = load_checkpoint(out + "/" + arch + pre + "_params", like)
    else:
        g = torch.Generator().manual_seed(4)
        params = tree_map(lambda t: t if t.any() else 0.1 * torch.randn(
            t.shape, generator=g), like)
    batch = dict(tokens=torch.from_numpy(
        np.load(out + "/" + src + pre + "_tokens.npy")))
    if model.cfg.encoder:
        batch["enc_embeds"] = torch.from_numpy(
            np.load(out + "/" + src + "_enc.npy"))
    return params, batch

def forward_and_grads(tag, m, archs):
    # the TP loss, logits and gradients (gathered over the model axis)
    # against the world of one ("tp", "one"), on the reference's initial
    # params (a cut config: the port's) and tokens; over 2 ranks also on
    # the inputs held against the reference ("ref"), jamba and deepseek
    # routed as the reference routed
    for arch in archs:
        model = LM(smoke(arch))
        sh = ModelShards(m.model_axis, plan_sharding(
            model, model.abstract_params(), m))
        params, batch = load(arch, "", model)
        paths = tree_leaves(model.param_paths(params))
        sides = [("tp", params, batch), ("one", params, batch)]
        if tag == "" and "/" not in arch:
            sides.append(("ref",) + load(arch, "_ref", model))
        for name, p0, bt in sides:
            moe.top_k = (routed_as_reference(arch)
                         if name == "ref" and arch in ROUTED else top_k)
            kw = dict() if name == "one" else dict(tp=sh.model_tp)
            if name != "one":
                p0 = sh.block(p0)
            p = tree_map(lambda t: t.detach().requires_grad_(True), p0)
            c0 = m.model_axis.collectives
            loss, _ = model.loss(p, bt, **kw)
            g = tree_unflatten(p0, list(torch.autograd.grad(
                loss, tree_leaves(p))))
            if name != "one":
                rows.setdefault(tag + "collectives", dict())[arch] = \\
                    m.model_axis.collectives - c0
                g = sh.full(g)
            lg, _ = model.logits(p0, bt["tokens"],
                                 enc_embeds=bt.get("enc_embeds"), **kw)
            key = tag + arch + "/" + name + "/"
            put(key + "loss", loss)
            put(key + "logits", lg)
            for path, x in zip(paths, tree_leaves(g)):
                put(key + "grad/" + path, x)
    moe.top_k = top_k

# replicated: the TP step against the dp group's own step, sum(p * G)
tokens = torch.zeros((1, 16), dtype=torch.int64)
rows["replicated"], rows["fsdp_stats"] = dict(), dict()
for arch in STEP_ARCHS:
    model = TPLinear(smoke(arch), shared_gradient(smoke(arch)))
    for quant, ef in (("orq-9", True), ("bingrad-b", False)):
        tcfg = TrainConfig(policy=QuantPolicy.parse(quant,
                                                    bucket_size=BUCKET),
                           error_feedback=ef)
        fn_tp = make_train_step(model, tcfg, constant_lr(LR), mesh=mesh)
        s_tp = init_state(model, tcfg, device="cpu", step=fn_tp)
        c0 = mesh.model_axis.collectives
        for i in range(2):
            s_tp, _ = fn_tp(s_tp, dict(tokens=tokens), prng.key(0))
        full = StateSharding(fn_tp).full_params(s_tp.params)
        full_ef = fn_tp.tp.full(s_tp.ef) if ef else None
        row = rows["replicated"][arch + "/" + quant] = dict(
            digest=params_digest_of(full),
            ef_digest=None if full_ef is None else params_digest_of(full_ef),
            tp_stats=list(fn_tp.launches_and_bytes(mesh.n_dp)),
            model_collectives=(mesh.model_axis.collectives - c0) // 2)
        if lead:
            fn_dp = make_train_step(model, tcfg, constant_lr(LR),
                                    group=mesh.dp_group)
            s_dp = init_state(model, tcfg, device="cpu", step=fn_dp)
            for i in range(2):
                s_dp, _ = fn_dp(s_dp, dict(tokens=tokens), prng.key(0))
            row.update(
                params_equal=all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(full), tree_leaves(s_dp.params))),
                ef_equal=None if full_ef is None else all(
                    torch.equal(a, b) for a, b in zip(
                        tree_leaves(full_ef), tree_leaves(s_dp.ef))),
                dp_stats=list(fn_dp.launches_and_bytes(mesh.n_dp)))
    # one per-leaf fsdp step on the TP blocks
    tcfg = TrainConfig(policy=QuantPolicy.parse("orq-9", bucket_size=BUCKET),
                       mode="fsdp")
    fn = make_train_step(model, tcfg, constant_lr(LR), mesh=mesh)
    state, _ = fn(init_state(model, tcfg, device="cpu", step=fn),
                  dict(tokens=tokens), prng.key(0))
    rows["fsdp_stats"][arch] = list(fn.launches_and_bytes(mesh.n_dp)) + [
        all(bool(torch.isfinite(t).all()) for t in tree_leaves(
            state.params))]

# fsdp: the per-leaf gather's backward on this rank's TP blocks
model = TPLinear(smoke("lm-100m"), shared_gradient(smoke("lm-100m")))
tcfg = TrainConfig(policy=QuantPolicy.parse("orq-9", bucket_size=BUCKET),
                   mode="fsdp")
plan = make_train_step(model, tcfg, constant_lr(LR), mesh=mesh).layout.plan
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

# the adaptive bit schedule under the model axis against the dp group's
sched = []
for m_kw in (dict(mesh=mesh), dict(group=mesh.dp_group))[:1 + lead]:
    ctl = BitBudgetController(BitSchedule.parse("default=orq@5..3",
                                                bucket_size=BUCKET),
                              total_steps=4, resolve_every=2)
    st = ScheduledTrainStep(model, TrainConfig(), ctl, constant_lr(LR),
                            **m_kw)
    s = init_state(model, st.init_config, device="cpu", step=st)
    widths = []
    for i in range(4):
        s, _ = st(s, dict(tokens=tokens), prng.key(0))
        widths.append([list(st.last_assignment)]
                      + list(st.launches_and_bytes(mesh.n_dp)))
    sched.append((params_digest_of(StateSharding(st).full_params(
        s.params)), widths))
rows["bit_schedule"] = dict(digests=[d for d, _ in sched],
                            widths=[w for _, w in sched])

if ws == 4:
    # two_level_async on (pod, data, model) = (2, 1, 2) against the dp
    # group's own async step, and H = 1 against two_level
    pmesh = make_host_mesh(model=2, pods=2)
    rows["async"] = dict()
    runs = [("tp_h2", 2, "two_level_async", dict(mesh=pmesh)),
            ("tp_h1", 1, "two_level_async", dict(mesh=pmesh)),
            ("tp_two_level", 1, "two_level", dict(mesh=pmesh))]
    if pmesh.model_axis.index == 0:
        runs.append(("dp_h2", 2, "two_level_async",
                     dict(group=pmesh.dp_group, pods=2)))
    for name, h, hier, m_kw in runs:
        tcfg = TrainConfig(policy=QuantPolicy.parse("orq-9",
                                                    bucket_size=BUCKET),
                           error_feedback=True, hierarchy=hier,
                           local_steps=h)
        fn = make_train_step(model, tcfg, constant_lr(LR), **m_kw)
        s = init_state(model, tcfg, device="cpu", step=fn)
        for i in range(4):
            s, _ = fn(s, dict(tokens=tokens), prng.key(0))
        full = StateSharding(fn).full_params(s.params)
        rows["async"][name] = dict(
            digest=params_digest_of(full),
            stats=list(fn.launches_and_bytes(pmesh.n_dp)))

if mesh.n_dp == 1:
    forward_and_grads("", mesh, ARCHS + tuple(CUTS))
else:
    # the (data, model) = (1, 4) mesh over the same four ranks: uneven KV
    # heads (KV 2), and the cuts
    forward_and_grads("m4/", make_host_mesh(model=4),
                      ARCHS + tuple(CUTS))

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


def _reference(arch, i, tmp):
    """The reference's initial params and tokens (and frames) saved for
    the worlds, and the inputs it is held against the port on ("_ref":
    for ``DRAWN`` its own tests' weights and tokens, else the same) ->
    a function computing its loss, logits and gradients on those."""
    jm = JLM(jget_smoke_config(arch))
    p = jm.init(jax.random.key(i))
    toks = jax.random.randint(jax.random.key(10 + i), (2, 17), 0,
                              jm.cfg.vocab_size)
    if arch in DRAWN:
        jm, p_ref, _, _ = _weights(arch, seed=5)
        toks_ref = jnp.asarray(np.random.default_rng(6).integers(
            0, jm.cfg.vocab_size, (2, SEQ_DRAWN)).astype(np.int32))
    else:
        p_ref, toks_ref = p, toks
    for pre, pp, tt in (("", p, toks), ("_ref", p_ref, toks_ref)):
        jsave(str(tmp / f"{arch}{pre}_params"),
              jax.tree_util.tree_map(np.asarray, pp))
        np.save(tmp / f"{arch}{pre}_tokens.npy", np.asarray(tt))
    batch = {"tokens": toks_ref}
    if jm.cfg.encoder:
        enc = (jax.random.normal(jax.random.key(20 + i), (
            2, jm.cfg.encoder.num_frames, jm.cfg.d_model)) * 0.02)
        np.save(tmp / f"{arch}_enc.npy", np.asarray(enc, np.float32))
        batch["enc_embeds"] = enc

    def compute():
        def f(p):
            loss = jm.loss(p, batch)[0]
            lg = jm.logits(p, toks_ref,
                           enc_embeds=batch.get("enc_embeds"))[0]
            return loss, lg
        jlog = []
        with pytest.MonkeyPatch.context() as mp:
            _record_routing(mp, jlog, [])
            (loss, lg), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
                p_ref)
            jax.effects_barrier()
        # the loss's forward, then the logits' (the same tokens): the
        # first forward's ids (the replays of the backward come after)
        n_moe = sum(s.moe for s in jm.specs)
        np.savez(tmp / f"{arch}_routes.npz",
                 **{str(j): np.asarray(t) for j, (_, t) in
                    enumerate(jlog[:n_moe])})
        (tmp / f"{arch}_routes.done").touch()
        paths = jax.tree_util.tree_leaves(jm.param_paths(p_ref))
        return dict(loss=float(loss), logits=np.asarray(lg, np.float32),
                    grads=dict(zip(paths, map(
                        np.asarray, jax.tree_util.tree_leaves(g)))))

    return compute


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both gloo worlds and the reference's reduce-scatters start first;
    the reference's params and tokens are written and its loss, logits,
    gradients and routing computed here while they run (the worlds wait
    for what they read)."""
    tmp = tmp_path_factory.mktemp("tp_train")
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
    # the reference's inputs while the worlds run their steps first
    refs = {arch: _reference(arch, i, tmp) for i, arch in enumerate(ARCHS)}
    (tmp / "inputs.done").touch()
    ref = {arch: compute() for arch, compute in refs.items()}
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


def _side(a, key):
    return {k[len(key):]: v for k, v in a.items() if k.startswith(key)}


def _hold_tp(tp, one, what):
    """TP against the port's world of one."""
    big = np.abs(one["logits"]).max()
    np.testing.assert_allclose(tp["logits"], one["logits"], rtol=0,
                               atol=TP_LOGITS_ATOL * big, err_msg=what)
    np.testing.assert_allclose(float(tp["loss"]), float(one["loss"]),
                               rtol=1e-6, err_msg=what)
    grads = [k for k in one if k.startswith("grad/")]
    assert grads and set(grads) == {k for k in tp if k.startswith("grad/")}
    rels = {k: _rel(tp[k], one[k]) for k in grads}
    worst = max(rels, key=rels.get)
    print(f"{what}: logits within "
          f"{np.abs(tp['logits'] - one['logits']).max() / big:.3g} of the "
          f"largest, gradients within {rels[worst]:.3g} ({worst})")
    assert all(v <= TP_GRAD_REL for v in rels.values()), (what, rels)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_forward_and_gradients(run, arch):
    a, ref = run["arrays"][2][0], run["ref"][arch]
    tp = _side(a, arch + "/ref/")
    np.testing.assert_allclose(float(tp["loss"]), ref["loss"],
                               rtol=LOSS_RTOL)
    big = np.abs(ref["logits"]).max()
    np.testing.assert_allclose(tp["logits"], ref["logits"], rtol=0,
                               atol=ATOL_BF16 * big)
    rels = {path: _rel(tp["grad/" + path], w)
            for path, w in ref["grads"].items()}
    worst = max(rels, key=rels.get)
    print(f"{arch} over 2 against the reference: logits within "
          f"{np.abs(tp['logits'] - ref['logits']).max() / big:.3g} of the "
          f"largest, gradients within {rels[worst]:.3g} ({worst})")
    assert all(v <= GRAD_REL for v in rels.values()), rels


@pytest.mark.parametrize("arch", ARCHS + tuple(CUTS))
@pytest.mark.parametrize("n", [2, 4])
def test_tp_against_world_of_one(run, n, arch):
    """Over 2 model ranks (the 1 x 2 world) and 4 (the (1, 4) mesh of the
    world of four): the uneven KV heads of mixtral and jamba over 4, and
    whisper's cuts of ``tp_cuts.CUTS``."""
    ws, tag = (2, "") if n == 2 else (4, "m4/")
    for a in run["arrays"][ws]:
        _hold_tp(_side(a, tag + arch + "/tp/"),
                 _side(a, tag + arch + "/one/"), f"{arch} over {n}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", [2, 4])
def test_model_group_collectives(run, n, arch):
    """The model-group all-reduces of one TP loss and backward, the same
    on every rank (printed per architecture)."""
    ws, tag = (2, "") if n == 2 else (4, "m4/")
    counts = {r[tag + "collectives"][arch] for r in run["rows"][ws]}
    assert len(counts) == 1 and counts.pop() > 0
    print(f"{arch} over {n}: {run['rows'][ws][0][tag + 'collectives'][arch]}"
          f" model-group all-reduces a step")


@pytest.mark.parametrize("arch,quant", [
    pytest.param(a, q, id=_arch_id(a, q)) for a in STEP_ARCHS
    for q in ("orq-9", "bingrad-b")])
@pytest.mark.parametrize("ws", [2, 4])
def test_replicated_tp_bit_equal_to_dp_world(run, ws, arch, quant):
    n_dp = ws // 2
    model = LM(get_smoke_config(arch))
    aps = model.abstract_params()
    sizes = [(p, x.numel()) for p, x in zip(
        tree_leaves(model.param_paths(aps)), tree_leaves(aps))]
    want = jpolicy_stats(JPolicy.parse(quant, bucket_size=BUCKET), sizes,
                         n_dp)
    rows = [r["replicated"][arch + "/" + quant] for r in run["rows"][ws]]
    # every rank gathers the same params, the model ranks of a dp index the
    # same EF, and model index 0 holds them equal to its dp group's steps
    assert len({row["digest"] for row in rows}) == 1
    for w in range(n_dp):
        assert len({row["ef_digest"] for r, row in zip(run["rows"][ws], rows)
                    if r["coords"]["data"] == w}) == 1
    leads = [row for r, row in zip(run["rows"][ws], rows)
             if r["coords"]["model"] == 0]
    assert len(leads) == n_dp
    for row in leads:
        assert row["params_equal"], quant
        assert row["ef_equal"] in (None, True), quant
        assert row["dp_stats"] == [want[0], want[1]]
    for row in rows:
        assert row["tp_stats"] == [want[0], want[1]]
        # one all-reduce gathers the gradient's TP blocks
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


def _rs_accounting(arch, n_dp):
    """The reference's ``rs_stats`` of each TP block (each leaf once a
    repeat), its Algorithm 2 cost for a dp-replicated leaf."""
    jm = JLM(jget_smoke_config(arch))
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    plan = jplan(jm, shapes, dp_axes=("data",),
                 axis_sizes={"data": n_dp, "model": 2})
    policy = JPolicy.parse("orq-9", bucket_size=BUCKET)
    launches, total = 0, 0.0
    for path, leaf in zip(jax.tree_util.tree_leaves(jm.param_paths(shapes)),
                          jax.tree_util.tree_leaves(shapes)):
        calls = leaf.shape[0] if _stacked(path) else 1
        n = leaf.size // calls // (2 if plan.tp_dims[path] is not None
                                   else 1)
        qz = policy.resolve(path).to_quantizer()
        if plan.gather_dims[path] is not None:
            c, b = JGradientExchange.rs_stats(qz, n, n_dp)
        else:
            eng = JGradientExchange(qz)
            c, b = eng.collective_launches(n), eng.wire_bytes_per_worker(
                n, n_dp)
        launches, total = launches + calls * c, total + calls * b
    return [launches, total]


@pytest.mark.parametrize("ws,arch", [
    pytest.param(w, a, id=_arch_id(str(w), a)) for w in (2, 4)
    for a in STEP_ARCHS])
def test_per_leaf_fsdp_accounting(run, ws, arch):
    want = _rs_accounting(arch, ws // 2)
    for r in run["rows"][ws]:
        assert r["fsdp_stats"][arch] == want + [True]
        if arch == "lm-100m":
            assert r["launcher"]["fsdp"]["wire"] == want[1]
            assert r["launcher"]["fsdp"]["launches"] == want[0]


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


@pytest.mark.parametrize("ws", [2, 4])
def test_bit_schedule_under_model_axis(run, ws):
    """Params equal to the dp group's scheduled steps (on model index 0;
    every rank's the same), and each step's width and bytes; the ramp
    moves the bytes."""
    for r in run["rows"][ws]:
        bs = r["bit_schedule"]
        if r["coords"]["model"] == 0:
            assert bs["digests"][0] == bs["digests"][1]
            assert bs["widths"][0] == bs["widths"][1]
        assert len({tuple(w[0]) for w in bs["widths"][0]}) > 1
        assert len({w[2] for w in bs["widths"][0]}) > 1
    assert len({r["bit_schedule"]["digests"][0]
                for r in run["rows"][ws]}) == 1


def test_async_under_model_axis(run):
    """two_level_async (H = 2) on (pod, data, model) = (2, 1, 2): params
    bit-equal to the dp group's own async steps and the same on every
    rank; H = 1 ends on two_level's params; the bytes a step are the dp
    world's."""
    rows = [r["async"] for r in run["rows"][4]]
    assert sum("dp_h2" in a for a in rows) == 2     # model index 0
    for a in rows:
        if "dp_h2" in a:
            assert a["tp_h2"]["digest"] == a["dp_h2"]["digest"]
            assert a["tp_h2"]["stats"] == a["dp_h2"]["stats"]
        assert a["tp_h1"]["digest"] == a["tp_two_level"]["digest"]
        assert a["tp_h2"]["digest"] != a["tp_h1"]["digest"]
    assert len({a["tp_h2"]["digest"] for a in rows}) == 1


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", list_archs())
def test_check_tp_passes_every_config(arch, size):
    """Every registered config runs under a model axis of 2 and of 4 (no
    refusal before compute)."""
    model = LM((get_config if size == "full" else get_smoke_config)(arch))
    for n in (2, 4):
        model.check_tp(n)


@pytest.mark.parametrize("arch", sorted(REFUSED))
def test_check_tp_refuses_what_does_not_split(arch):
    """Experts, RWKV-6 heads or MLA heads that do not split over the model
    axis are refused before compute, naming ROADMAP.md (no registered
    config has them)."""
    n = REFUSED[arch][0]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        LM(smoke(arch)).check_tp(n)
