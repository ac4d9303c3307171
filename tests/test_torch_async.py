"""The port's temporal hierarchy (``hierarchy="two_level_async"``,
``AsyncTrainStep``) against the JAX reference.

* ``TrainConfig`` refuses what the reference's refuses (its
  ``tests/test_two_level_async.py`` cases), with its messages.
* The DCN bytes a step of smoke lm-100m on 2 pods x 4 workers,
  ``norm|bias=fp,default=orq-9``, bucket 2048, the outer exchange
  amortized over the window: 44,520 / 22,260 / 11,130 / 5,565 for H = 1 /
  2 / 4 / 8, from the policy and from an engine as built, equal to the
  reference's and to ``benchmarks/BENCH_convergence.json``.
* On 4 gloo workers in 2 pods (rank = pod * 2 + data), smoke lm-100m with
  error feedback: H = 1 ends on the two_level run's params, optimizer
  state and EF bit for bit (it IS that path); H = 4 keeps the window's
  contract: pods diverge at inner steps while the workers of a pod stay
  equal, every sync makes all workers equal to the new anchor, and the
  anchor moves only at syncs.
* Against the reference on ``jax.make_mesh((2, 2), ("pod", "data"))``
  (4 fake devices), H = 2, both outer optimizers, loss ``c * sum(p * G)``
  with ``G`` on a 1/64 grid and ``c`` = 1 + (the worker's first token %
  4), so the pods' gradients differ: from each of the reference's states
  (its state checkpoints, sliced by ``StateSharding.scatter``), one port
  step gives the reference's next params, optimizer state, EF, anchor and
  outer momentum bit for bit, inner and sync steps alike.
* The pod-of-one world (``pod_axis=True``, a gloo world of one) against
  the reference on ``jax.make_mesh((1,), ("pod",))``: the same, in
  process.
"""
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core import comm as jcomm
from repro.core.policy import QuantPolicy as JPolicy
from repro.models.model import LM as JLM
from repro.optim.schedule import constant_lr as jconstant_lr
from repro.train import step as jstep
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import prng
from repro_torch.core.comm import exchange
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import LM
from repro_torch.optim.schedule import constant_lr
from repro_torch.train import TrainConfig, init_state, make_train_step
from repro_torch.train.step import AsyncTrainStep
from repro_torch.utils.pytree import tree_leaves
from torch_test_env import port_test_env  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.05
POLICY = "norm|bias=fp,default=orq-9"

# ---------------------------------------------------------------------------
# configuration and accounting (in process)
# ---------------------------------------------------------------------------

CONFIGS = {
    "local_steps_lower_bound": (dict(local_steps=0), "local_steps"),
    "needs_async_hierarchy": (dict(hierarchy="two_level", local_steps=4),
                              "two_level_async"),
    "rejects_fsdp": (dict(mode="fsdp", hierarchy="two_level_async",
                          local_steps=4), "replicated"),
    "rejects_per_leaf": (dict(hierarchy="two_level_async", local_steps=4,
                              fused_exchange=False), "fused_exchange"),
    "bad_outer_optimizer": (dict(hierarchy="two_level_async", local_steps=4,
                                 outer_optimizer="adamw"),
                            "outer_optimizer"),
    "valid": (dict(hierarchy="two_level_async", local_steps=4), None),
}


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_train_config_validation_matches_reference(case):
    kw, match = CONFIGS[case]
    jkw = {"mode": "replicated", **kw}
    if match is None:
        got = TrainConfig(policy="orq-9", **kw)
        want = jstep.TrainConfig(policy="orq-9", **jkw)
        for f in ("outer_optimizer", "outer_lr", "outer_momentum",
                  "local_steps", "hierarchy", "group_by_rule",
                  "collect_stats"):
            assert getattr(got, f) == getattr(want, f), f
        return
    with pytest.raises(ValueError, match=match) as want:
        jstep.TrainConfig(policy="orq-9", **jkw)
    with pytest.raises(ValueError, match=match) as got:
        TrainConfig(policy="orq-9", **kw)
    assert str(got.value) == str(want.value)


def test_dcn_bytes_a_step_match_reference_and_bench():
    model = LM(get_smoke_config("lm-100m"))
    ap = model.abstract_params()
    paths = model.param_paths(ap)
    ps = [(p, int(x.numel())) for p, x in zip(tree_leaves(paths),
                                                tree_leaves(ap))]
    pol = QuantPolicy.parse(POLICY, bucket_size=2048)
    jpol = JPolicy.parse(POLICY, bucket_size=2048)
    # a stand-in for the pod's process group: pricing reaches no collective
    pex = exchange.PartitionedExchange.build(pol, ap, paths=paths,
                                             intra_group=object())
    with open(os.path.join(ROOT, "benchmarks", "BENCH_convergence.json")) as f:
        hier = json.load(f)["hier"]
    kw = dict(n_intra=4, n_inter=2, two_level=True)
    want = {1: 44_520, 2: 22_260, 4: 11_130, 8: 5_565}
    for h, nbytes in want.items():
        st, _ = exchange.policy_link_stats(pol, ps, sync_every=h, **kw)
        jst, _ = jcomm.policy_link_stats(jpol, ps, sync_every=h, **kw)
        obs, _ = exchange.observed_link_stats(pex, n_intra=4, n_inter=2,
                                              sync_every=h)
        assert st == jst
        assert obs["dcn_q_bytes"] == st["dcn_q_bytes"] == nbytes
        assert hier["async"][str(h)]["dcn_bytes_per_step"] == nbytes


# ---------------------------------------------------------------------------
# 4 gloo workers in 2 pods, and against 4 fake devices
# ---------------------------------------------------------------------------

_COMMON = """
import hashlib, json, sys
import numpy as np
"""

# the reference's steps on its (2, 2) mesh, the loss c * sum(p * G): from
# grid states (one inner, one sync step) and along a chained run
JAX_PROG = _COMMON + """
import jax, jax.numpy as jnp
from repro.checkpoint import save_checkpoint
from repro.configs.base import get_smoke_config
from repro.core.policy import QuantPolicy
from repro.data import SyntheticLM
from repro.models.model import LM
from repro.optim.schedule import constant_lr
from repro.train import step as jstep
from repro.train.state import OuterState

{grid_src}

class Scaled(LM):
    def __init__(self, cfg, G):
        super().__init__(cfg)
        self.G = G

    def loss(self, params, batch, *args, **kwargs):
        c = (1 + batch["tokens"][0, 0] % 4).astype(jnp.float32)
        loss = c * sum(jnp.sum(p * g) for p, g in zip(
            jax.tree_util.tree_leaves(params),
            jax.tree_util.tree_leaves(self.G)))
        return loss, {{"nll": loss, "aux": jnp.float32(0),
                       "tokens": jnp.float32(1)}}

out, name = sys.argv[1], sys.argv[2]
outer, kind, lr, kw, steps = {runs!r}[name]
cfg = get_smoke_config("lm-100m")
shapes = jax.eval_shape(LM(cfg).init, jax.random.key(0))
rng = np.random.default_rng(0)
G = jax.tree_util.tree_map(lambda s: grid(rng, s.shape, 8, 64), shapes)
save_checkpoint(f"{{out}}/G_{{name}}", G)
model = Scaled(cfg, G)
mesh = jax.make_mesh((2, 2), ("pod", "data"))
data = SyntheticLM(512, 16, 4, 0)
tcfg = jstep.TrainConfig(
    policy=QuantPolicy.parse({policy!r}, bucket_size=512),
    mode="replicated", hierarchy="two_level_async", local_steps=2,
    error_feedback=True, outer_optimizer=outer, **kw)
state = jstep.init_state(model, mesh, tcfg, jax.random.key(0))
fn, _ = jstep.make_train_step(model, mesh, tcfg, constant_lr(lr))
losses = []
for i in range(steps + 1):
    if kind == "grid":
        state = jax.tree_util.tree_map(
            lambda new, old: jax.device_put(new, old.sharding),
            grid_state(state, i, OuterState), state)
    save_checkpoint(f"{{out}}/{{name}}{{i}}", state, step=i)
    if i < steps:
        state, m = fn(state, data.batch(i), jax.random.key(0))
        losses.append(float(m["loss"]))
        if kind == "grid":
            save_checkpoint(f"{{out}}/{{name}}{{i}}_out", state, step=i + 1)
with open(f"{{out}}/losses_{{name}}.json", "w") as f:
    json.dump(losses, f)
"""


def grid(rng, shape, k, den):
    """Integers in [-k, k] over ``den``, f32: every sum the level fits
    make of such values (and of the updates below) is exact in f32."""
    return (rng.integers(-k, k + 1, shape) / den).astype(np.float32)


def grid_state(state, step, outer_cls):
    """A state on the grid at ``step`` (params and momentum the same within
    a pod, different across pods; EF, anchor and outer momentum on the
    grid too): with lr 1 and momentum 0.5 the window's delta stays on a
    1/128 grid, so both packages' level fits are exact."""
    rng = np.random.default_rng(100 + step)

    def pods(x, k, den):
        n = x.shape[0]                  # the stacked workers, 1 or 2 pods
        rows = grid(rng, (min(n, 2),) + tuple(x.shape[1:]), k, den)
        return np.repeat(rows, n // min(n, 2), axis=0)

    tm = jax.tree_util.tree_map
    return state._replace(
        params=tm(lambda x: pods(x, 16, 64), state.params),
        opt=tm(lambda x: pods(x, 16, 32), state.opt),
        ef=tuple(None if e is None else grid(rng, e.shape, 8, 64)
                 for e in state.ef),
        outer=outer_cls(anchor=tm(lambda x: grid(rng, x.shape, 16, 64),
                                  state.outer.anchor),
                        mom=tm(lambda x: grid(rng, x.shape, 16, 64),
                               state.outer.mom)),
        step=np.int32(step))


_TORCH_HEAD = _COMMON + """
import torch, torch.distributed as dist
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import prng
from repro_torch.core.policy import QuantPolicy
from repro_torch.data import SyntheticLM
from repro_torch.models import LM
from repro_torch.optim.schedule import constant_lr
from repro_torch.train import TrainConfig, init_state, make_train_step
from repro_torch.train.step import AsyncTrainStep, StateSharding
from repro_torch.utils.pytree import tree_leaves

rank, out, rdv = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=4)
data = SyntheticLM(512, 16, 4, 0)

def rows(i):
    return {{"tokens": data.batch(i, device="cpu")["tokens"][rank:rank + 1]}}

def tcfg_of(hier, h, **kw):
    return TrainConfig(policy=QuantPolicy.parse({policy!r}, bucket_size=512),
                       hierarchy=hier, local_steps=h, error_feedback=True,
                       **kw)

def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()

def everyone(hexdigest):
    mine = torch.tensor(list(bytes.fromhex(hexdigest)), dtype=torch.uint8)
    got = [torch.empty_like(mine) for _ in range(4)]
    dist.all_gather(got, mine)
    return [bytes(t.tolist()).hex()[:16] for t in got]
"""

# pure port: H = 1 against two_level, and the H = 4 window on smoke lm-100m
WINDOW_PROG = _TORCH_HEAD + """
model = LM(get_smoke_config("lm-100m"))
res = {{"h1": {{}}, "window": []}}
for hier, h in (("two_level", 1), ("two_level_async", 1)):
    tcfg = tcfg_of(hier, h)
    fn = make_train_step(model, tcfg, constant_lr({lr}), pods=2)
    state = init_state(model, tcfg, device="cpu", step=fn)
    for i in range(3):
        state, m = fn(state, rows(i), prng.key(42))
    full = StateSharding(fn).gather(state)
    res["h1"][hier] = [isinstance(fn, AsyncTrainStep), fn.layout.two_level,
                       digest(tree_leaves((full.params, full.opt, full.ef)))]
tcfg = tcfg_of("two_level_async", 4)
fn = make_train_step(model, tcfg, constant_lr({lr}), pods=2)
state = init_state(model, tcfg, device="cpu", step=fn)
for i in range(8):
    sync = fn.is_sync_step(state.step)
    anchor_before = digest(tree_leaves(state.outer.anchor))
    state, m = fn(state, rows(i), prng.key(42))
    res["window"].append({{
        "step": i, "sync": sync, "loss": float(m["loss"]),
        "params": everyone(digest(tree_leaves(state.params))),
        "anchor_moved": digest(tree_leaves(state.outer.anchor))
        != anchor_before,
        "params_are_anchor": all(torch.equal(a, p) for a, p in zip(
            tree_leaves(state.outer.anchor), tree_leaves(state.params)))}})
res["link"] = fn.link_bytes()
res["stacked"] = [list(t.shape) for t in
                  tree_leaves(StateSharding(fn).gather(state).params)][:2]
if rank == 0:
    print("RESULT " + json.dumps(res), flush=True)
dist.destroy_process_group()
"""

# from each reference state, one port step on the same loss
REF_PROG = _TORCH_HEAD + """
from repro_torch.checkpoint import load_checkpoint

class Scaled(LM):
    def __init__(self, cfg, G):
        super().__init__(cfg)
        self.G = G

    def loss(self, params, batch, **kwargs):
        c = float(1 + int(batch["tokens"][0, 0]) % 4)
        loss = c * sum((p * g).sum() for p, g in zip(
            tree_leaves(params), tree_leaves(self.G)))
        return loss, {{"nll": loss, "aux": 0.0, "tokens": torch.tensor(1.0)}}

cfg = get_smoke_config("lm-100m")
found = []
for name, (outer, kind, lr, kw, steps) in {runs!r}.items():
    G, _ = load_checkpoint(f"{{out}}/G_{{name}}", LM(cfg).init(
        torch.Generator().manual_seed(0), device="cpu"))
    model = Scaled(cfg, G)
    losses = json.load(open(f"{{out}}/losses_{{name}}.json"))
    tcfg = tcfg_of("two_level_async", 2, outer_optimizer=outer, **kw)
    fn = make_train_step(model, tcfg, constant_lr(lr), pods=2)
    sh = StateSharding(fn)
    like = sh.gather(init_state(model, tcfg, device="cpu", step=fn))

    def load(tag):
        return sh.scatter(load_checkpoint(f"{{out}}/{{name}}{{tag}}",
                                          like)[0])

    for i in range(steps):
        before = load(i)
        want = load(f"{{i}}_out" if kind == "grid" else i + 1)
        new, m = fn(before, rows(i), prng.key(0))
        same = {{}}
        for f in ("params", "opt", "ef", "outer"):
            pairs = list(zip(tree_leaves(getattr(new, f)),
                             tree_leaves(getattr(want, f)), strict=True))
            same[f] = (sum(int((a == b).sum()) for a, b in pairs)
                       / sum(a.numel() for a, _ in pairs))
        found.append({{"run": name, "step": i, "rank": rank,
                       "sync": fn.is_sync_step(i), "same": same,
                       "loss": float(m["loss"]),
                       "ref_loss": losses[i],
                       "ef_nonzero": any(bool(e.abs().max() > 0)
                                         for e in tree_leaves(new.ef)),
                       "params": everyone(digest(tree_leaves(
                           new.params)))}})
print("ROWS " + json.dumps(found), flush=True)
dist.destroy_process_group()
"""

OUTERS = ("nesterov", "sgd")
# name -> (outer optimizer, kind, lr, TrainConfig fields, steps). From grid
# states (an inner step, then a sync step), bit-equal; along the
# reference's own run at the default lr and momentum (two windows), the
# sync steps' exchange input is off the grid and the level fits are
# float-close
RUNS = {"nesterov_grid": ("nesterov", "grid", 1.0, {"momentum": 0.5}, 2),
        "sgd_grid": ("sgd", "grid", 1.0, {"momentum": 0.5}, 2),
        "nesterov_chain": ("nesterov", "chain", LR, {}, 4)}
# the least share of equal elements along the chained run: the inner steps
# all, a sync step all but the buckets whose level fit moved (each moves
# its 512 elements; a rank's EF shard holds 448 buckets)
CHAIN_SAME = 0.99


def _env(extra):
    return {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
            "JAX_PLATFORMS": "cpu", **extra}


def _ranks(src, tmp, name):
    (tmp / name).mkdir()
    return [subprocess.Popen(
        [sys.executable, "-c", src, str(r), str(tmp), str(tmp / name / "rdv")],
        env=_env({"OMP_NUM_THREADS": "1"}), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]


def _outs(procs):
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    return outs


def _tagged(outs, tag):
    return [json.loads(ln[len(tag):]) for out in outs
            for ln in out.splitlines() if ln.startswith(tag)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The pure-port window run and the reference's states concurrently,
    then the port's steps from the reference's states."""
    tmp = tmp_path_factory.mktemp("async")
    import inspect
    fmt = dict(lr=LR, policy=POLICY, runs=RUNS,
               grid_src=inspect.getsource(grid)
               + "\n\n" + inspect.getsource(grid_state))
    window = _ranks(WINDOW_PROG.format(**fmt), tmp, "window")
    refs = [subprocess.Popen(
        [sys.executable, "-c", JAX_PROG.format(**fmt), str(tmp), name],
        env=_env({"XLA_FLAGS": "--xla_force_host_platform_device_count=4"}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in RUNS]
    for ref in refs:
        out = ref.communicate(timeout=600)[0]
        assert ref.returncode == 0, out
    rows = _tagged(_outs(_ranks(REF_PROG.format(**fmt), tmp, "ref")),
                   "ROWS ")
    (result,) = _tagged(_outs(window), "RESULT ")
    by_step = {}
    for r in (x for part in rows for x in part):
        by_step.setdefault((r["run"], r["step"]), []).append(r)
    return result, by_step


def test_h1_bit_identical_to_two_level(worlds):
    result, _ = worlds
    two, h1 = result["h1"]["two_level"], result["h1"]["two_level_async"]
    assert two[:2] == h1[:2] == [False, True]
    assert h1[2] == two[2]


def test_h4_window_divergence_and_sync(worlds):
    result, _ = worlds
    rows = result["window"]
    assert [r["sync"] for r in rows] == [(i + 1) % 4 == 0 for i in range(8)]
    for r in rows:
        p = r["params"]
        assert p[0] == p[1] and p[2] == p[3], r     # a pod stays together
        if r["sync"]:
            assert len(set(p)) == 1, r
            assert r["params_are_anchor"] and r["anchor_moved"], r
        else:
            assert p[0] != p[2], r                  # the pods diverge
            assert not r["anchor_moved"], r
    assert all(np.isfinite(r["loss"]) for r in rows)
    # the step's accounting: the outer exchange amortized over the window
    # of 4, plus the inner fp intra all-reduce
    model = LM(get_smoke_config("lm-100m"))
    ap = model.abstract_params()
    ps = [(p, int(x.numel())) for p, x in zip(
        tree_leaves(model.param_paths(ap)), tree_leaves(ap))]
    want, _ = exchange.policy_link_stats(
        QuantPolicy.parse(POLICY, bucket_size=512), ps, n_intra=2,
        n_inter=2, two_level=True, sync_every=4)
    assert result["link"] == want
    assert result["stacked"][0][0] == 4


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("outer", OUTERS)
def test_async_steps_match_fake_devices(worlds, outer, step):
    """From grid states: every field bit-equal, inner and sync steps."""
    _, by_step = worlds
    rows = by_step[(outer + "_grid", step)]
    assert sorted(r["rank"] for r in rows) == [0, 1, 2, 3]
    for r in rows:
        assert r["sync"] == (step % 2 == 1)
        assert r["same"] == {"params": 1.0, "opt": 1.0, "ef": 1.0,
                             "outer": 1.0}, r
        np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=1e-6)
        assert r["ef_nonzero"]
        p = r["params"]
        assert p[0] == p[1] and p[2] == p[3]
        assert (p[0] == p[2]) == r["sync"]      # pods differ mid-window


def test_async_chained_run_matches_fake_devices(worlds):
    """Along the reference's own run (lr 0.05, momentum 0.9, Nesterov, two
    windows): the inner steps bit-equal, the sync steps float-close as
    the level fits are."""
    _, by_step = worlds
    for step in range(4):
        rows = by_step[("nesterov_chain", step)]
        for r in rows:
            if not r["sync"]:
                assert r["same"] == {"params": 1.0, "opt": 1.0, "ef": 1.0,
                                     "outer": 1.0}, r
            assert min(r["same"].values()) >= CHAIN_SAME, r
            assert r["same"]["opt"] == 1.0
            np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=1e-5)
            assert r["ef_nonzero"] == (step >= 1)


# ---------------------------------------------------------------------------
# the pod-of-one world (in process)
# ---------------------------------------------------------------------------

class _JLinear(JLM):
    def __init__(self, cfg, G):
        super().__init__(cfg)
        self.G = G

    def loss(self, params, batch, *args, **kwargs):
        loss = sum(jnp.sum(p * g) for p, g in zip(
            jax.tree_util.tree_leaves(params),
            jax.tree_util.tree_leaves(self.G), strict=True))
        return loss, {"nll": loss, "aux": jnp.float32(0),
                      "tokens": jnp.float32(1)}


class _Linear(LM):
    def __init__(self, cfg, G):
        super().__init__(cfg)
        self.G = G

    def loss(self, params, batch, **kwargs):
        loss = sum((p * g).sum() for p, g in zip(
            tree_leaves(params), tree_leaves(self.G), strict=True))
        return loss, {"nll": loss, "aux": 0.0, "tokens": torch.tensor(1.0)}


@pytest.fixture(scope="module")
def world1():
    """A gloo world of one process on its own ``file://`` rendezvous."""
    if not dist.is_initialized():
        tmp = tempfile.mkdtemp(prefix="repro_torch_test_world_")
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
    return dist.get_world_size()


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.mark.parametrize("outer", ["nesterov"])
def test_pod_of_one_matches_reference(world1, outer):
    """From grid states at an inner and a sync step: the reference on
    ``("pod",)`` and the port on its pod-of-one world (the outer exchange
    flat, EF on the full group buffers) agree bit for bit. (Both outer
    optimizers are held on the (2, 2) mesh above; one suffices here.)"""
    from repro.train.state import OuterState as JOuter
    from repro_torch.train.state import OuterState
    cfg = jget_smoke_config("lm-100m")
    shapes = jax.eval_shape(JLM(cfg).init, jax.random.key(0))
    rng = np.random.default_rng(1)
    G = jax.tree_util.tree_map(lambda s: grid(rng, s.shape, 8, 64), shapes)
    jmodel = _JLinear(cfg, G)
    mesh = jax.make_mesh((1,), ("pod",))
    kw = dict(mode="replicated", hierarchy="two_level_async", local_steps=2,
              error_feedback=True, outer_optimizer=outer, momentum=0.5)
    jt = jstep.TrainConfig(policy=JPolicy.parse(POLICY, bucket_size=512),
                           **kw)
    jstate = jstep.init_state(jmodel, mesh, jt, jax.random.key(0))
    jfn, _ = jstep.make_train_step(jmodel, mesh, jt, jconstant_lr(1.0))
    model = _Linear(get_smoke_config("lm-100m"),
                    params_from_jax(G, device="cpu"))
    tcfg = TrainConfig(policy=QuantPolicy.parse(POLICY, bucket_size=512),
                       **kw)
    fn = make_train_step(model, tcfg, constant_lr(1.0), pod_axis=True)
    assert isinstance(fn, AsyncTrainStep) and not fn.layout.two_level
    like = init_state(model, tcfg, device="cpu", step=fn)
    batch = {"tokens": jnp.zeros((1, 17), jnp.int32)}
    tokens = {"tokens": torch.zeros((1, 17), dtype=torch.int64)}
    for step in (0, 1):
        start = _np(grid_state(_np(jstate), step, JOuter))
        state = like._replace(
            params=params_from_jax(jax.tree_util.tree_map(
                lambda x: x[0], start.params), "cpu"),
            opt=params_from_jax(jax.tree_util.tree_map(lambda x: x[0],
                                                       start.opt), "cpu"),
            ef=params_from_jax(start.ef, "cpu"), step=step,
            outer=OuterState(*params_from_jax(tuple(start.outer), "cpu")))
        want, _ = jfn(jax.tree_util.tree_map(
            lambda new, old: jax.device_put(new, old.sharding), start,
            jstate), batch, jax.random.key(0))
        want = _np(want)
        got, _ = fn(state, tokens, prng.key(0))
        assert fn.is_sync_step(step) == bool(step)
        pairs = list(zip(
            tree_leaves((got.params, got.opt)),
            jax.tree_util.tree_leaves((want.params, want.opt)),
            strict=True))
        pairs += list(zip(
            tree_leaves((got.ef, got.outer)),
            jax.tree_util.tree_leaves((want.ef, want.outer)), strict=True))
        for a, b in pairs:
            np.testing.assert_array_equal(a.numpy(), b.reshape(a.shape))
        assert any(np.abs(e).max() > 0 for e in want.ef if e is not None)


def test_async_state_sharding_round_trip_adamw(world1, tmp_path):
    """The global form of an async AdamW state on the pod-of-one world:
    params and both moments stacked on a leading worker axis, the step
    count a (workers,) int32 array (the reference stacks its optimizer
    state whole), the outer state as it is; a checkpoint of it restores
    the state bit for bit."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.data import SyntheticLM
    from repro_torch.train.step import StateSharding
    model = LM(get_smoke_config("lm-100m"))
    tcfg = TrainConfig(policy=QuantPolicy.parse(POLICY, bucket_size=512),
                       hierarchy="two_level_async", local_steps=2,
                       error_feedback=True, optimizer="adamw")
    fn = make_train_step(model, tcfg, constant_lr(LR), pod_axis=True)
    state = init_state(model, tcfg, device="cpu", step=fn)
    for i in range(3):
        state, _ = fn(state, SyntheticLM(512, 16, 2, 0).batch(i, device="cpu"),
                      prng.key(0))
    sh = StateSharding(fn)
    full = sh.gather(state)
    assert full.opt.count.dtype == torch.int32
    assert full.opt.count.tolist() == [state.opt.count] == [3]
    assert all(a.shape == (1,) + tuple(b.shape) for a, b in zip(
        tree_leaves((full.params, full.opt.mu)),
        tree_leaves((state.params, state.opt.mu))))
    path = str(tmp_path / "async_adamw")
    save_checkpoint(path, full, step=full.step)
    like = sh.gather(init_state(model, tcfg, device="cpu", step=fn))
    back = sh.scatter(load_checkpoint(path, like)[0])
    assert back.step == state.step == 3
    assert back.opt.count == state.opt.count
    for a, b in zip(tree_leaves((back.params, back.opt.mu, back.opt.nu,
                                 back.ef, back.outer)),
                    tree_leaves((state.params, state.opt.mu, state.opt.nu,
                                 state.ef, state.outer)), strict=True):
        assert torch.equal(a, b)
