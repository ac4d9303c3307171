"""Error feedback through the port's data-parallel train steps, held
against the JAX reference's steps on one shared gradient.

Both sides train a model whose loss is ``sum(p * G)`` (G: the reference's
gradient of smoke lm-100m at its initial params), so every worker's
gradient is G, whatever its rows of the batch, and every rounding input
is the same on both sides. orq-9 (bucket 512) with error feedback, two
steps: the second starts from the reference's post-step state, whose
residuals are non-zero, so a residual that is dropped, negated, misplaced
or never added shows.

* fsdp on a gloo world of one (the reference on ``jax.make_mesh((1,),
  ("data",))``): the new EF buffer bit-equal to the reference's, the
  update within SHARED_UPDATE_RTOL per leaf.
* 4 gloo workers through ``make_train_step``: fsdp flat, fsdp with
  ``pods=2`` and replicated with ``pods=2`` (two-level, rank = pod * 2 +
  data), against the reference's step on a ``("data",)`` (4,) or
  ``("pod", "data")`` (2, 2) mesh of 4 fake devices. The reference's
  states travel as its state checkpoints; each worker restores them with
  the port's ``load_checkpoint`` and ``StateSharding.scatter`` (the
  ``--resume`` path) and steps from each: its EF shard bit-equal to the
  reference's, the update of every stored shard within DP_UPDATE_RTOL,
  the loss within LOSS_RTOL.

The tolerances are relative norms per leaf. SHARED_UPDATE_RTOL (as in
``test_torch_train_local.py``): the optimizer's f32 arithmetic in another
order. DP_UPDATE_RTOL: besides, the dequantized values' mean across
workers adds in another order (readings on the CPU <= 1.18e-6; a residual
dropped from the update moves it by about |EF| / |G|, tens of percent).
LOSS_RTOL: ``sum(p * G)`` over ~1e6 terms summed in another order
(readings <= 1.1e-7).
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
from repro.core.policy import QuantPolicy as JPolicy
from repro.data import SyntheticLM as JSyntheticLM
from repro.models.model import LM as JLM
from repro.optim.schedule import constant_lr as jconstant_lr
from repro.train import step as jstep
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import prng
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import LM
from repro_torch.optim.schedule import constant_lr
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.utils.pytree import tree_leaves
from torch_test_env import port_test_env  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.05
SHARED_UPDATE_RTOL = 1e-6
DP_UPDATE_RTOL = 1e-5
LOSS_RTOL = 1e-5


class _JLinear(JLM):
    """The reference's model with the loss ``sum(p * G)``: its gradient is
    ``G`` (cast to the dtype of ``p``)."""

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
    """The port's counterpart of :class:`_JLinear`."""

    def __init__(self, cfg, G):
        super().__init__(cfg)
        self.G = G

    def loss(self, params, batch, **kwargs):
        loss = sum((p * g).sum() for p, g in zip(
            tree_leaves(params), tree_leaves(self.G), strict=True))
        return loss, {"nll": loss, "aux": 0.0, "tokens": torch.tensor(1.0)}


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _np(tree):
    # copies: the reference's step donates its input state
    return jax.tree_util.tree_map(np.array, tree)


# ---------------------------------------------------------------------------
# fsdp on a world of one (in process)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world1():
    """A gloo world of one process on its own ``file://`` rendezvous."""
    if not dist.is_initialized():
        tmp = tempfile.mkdtemp(prefix="repro_torch_test_world_")
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
    return dist.get_world_size()


@pytest.fixture(scope="module")
def fsdp_runs():
    """G, the batches' tokens, and the reference's fsdp states through two
    steps on the shared gradient."""
    cfg = jget_smoke_config("lm-100m")
    batches = [JSyntheticLM(512, 16, 2, 0).batch(i) for i in range(2)]
    p0 = JLM(cfg).init(jax.random.key(0))
    G = _np(jax.grad(lambda p: JLM(cfg).loss(p, batches[0])[0])(p0))
    jmodel = _JLinear(cfg, G)
    mesh = jax.make_mesh((1,), ("data",))
    tcfg = jstep.TrainConfig(policy=JPolicy.parse("orq-9", bucket_size=512),
                             mode="fsdp", error_feedback=True)
    state = jstep.init_state(jmodel, mesh, tcfg, jax.random.key(0))
    fn, _ = jstep.make_train_step(jmodel, mesh, tcfg,
                                  lr_fn=jconstant_lr(LR))
    states, losses = [_np(state)], []
    for b in batches:
        state, metrics = fn(state, b, jax.random.key(0))
        states.append(_np(state))
        losses.append(float(metrics["loss"]))
    return G, [np.array(b["tokens"]) for b in batches], states, losses


@pytest.mark.parametrize("step", [0, 1])
def test_fsdp_ef_step_on_shared_gradient(world1, fsdp_runs, step):
    G, tokens, states, losses = fsdp_runs
    before, after = states[step:step + 2]
    if step:
        assert any(np.abs(e).max() > 0 for e in before.ef)
    model = _Linear(get_smoke_config("lm-100m"),
                    params_from_jax(G, device="cpu"))
    tcfg = TrainConfig(policy=QuantPolicy.parse("orq-9", bucket_size=512),
                       mode="fsdp", error_feedback=True)
    fn = make_train_step(model, tcfg, constant_lr(LR))
    state, metrics = fn(state_from_jax(before, device="cpu"),
                        {"tokens": torch.from_numpy(tokens[step])},
                        prng.key(0))
    np.testing.assert_allclose(float(metrics["loss"]), losses[step],
                               rtol=LOSS_RTOL)
    assert state.step == int(after.step) == step + 1
    for p, p0, w in zip(tree_leaves(state.params),
                        jax.tree_util.tree_leaves(before.params),
                        jax.tree_util.tree_leaves(after.params), strict=True):
        assert _rel(p.numpy() - p0, w - p0) < SHARED_UPDATE_RTOL
    assert len(state.ef) == len(after.ef)
    for e, w in zip(state.ef, after.ef, strict=True):
        assert e.dtype == torch.float32
        np.testing.assert_array_equal(e.numpy(), w)


# ---------------------------------------------------------------------------
# 4 gloo workers against 4 fake devices
# ---------------------------------------------------------------------------

CASES = {"fsdp": ("fsdp", 1), "fsdp_pods2": ("fsdp", 2),
         "replicated_pods2": ("replicated", 2)}

# the subprocesses take the model classes from this file
_COMMON = """
import json, sys
import numpy as np
sys.path.insert(0, {tests!r})
"""

JAX_PROG = _COMMON + """
import jax, jax.numpy as jnp
from repro.checkpoint import save_checkpoint
from repro.configs.base import get_smoke_config
from repro.core.policy import QuantPolicy
from repro.data import SyntheticLM
from repro.models.model import LM
from repro.optim.schedule import constant_lr
from repro.train import step as jstep
from test_torch_train_ef import _JLinear

out = sys.argv[1]
cfg = get_smoke_config("lm-100m")
batch = SyntheticLM(512, 16, 4, 0).batch(0)
p0 = LM(cfg).init(jax.random.key(0))
G = jax.tree_util.tree_map(
    np.array, jax.grad(lambda p: LM(cfg).loss(p, batch)[0])(p0))
save_checkpoint(out + "/G", G)
model = _JLinear(cfg, G)
losses = {{}}
for name, (mode, pods) in {cases!r}.items():
    mesh = (jax.make_mesh((4,), ("data",)) if pods == 1
            else jax.make_mesh((2, 2), ("pod", "data")))
    tcfg = jstep.TrainConfig(
        policy=QuantPolicy.parse("orq-9", bucket_size=512), mode=mode,
        error_feedback=True, hierarchy="two_level" if pods > 1 else "flat")
    state = jstep.init_state(model, mesh, tcfg, jax.random.key(0))
    fn, _ = jstep.make_train_step(model, mesh, tcfg,
                                  lr_fn=constant_lr({lr}))
    losses[name] = []
    for i in range(3):
        save_checkpoint(f"{{out}}/{{name}}{{i}}", state, step=i)
        if i < 2:
            state, m = fn(state, batch, jax.random.key(0))
            losses[name].append(float(m["loss"]))
with open(out + "/losses.json", "w") as f:
    json.dump(losses, f)
"""

TORCH_PROG = _COMMON + """
import torch, torch.distributed as dist
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import prng
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import LM
from repro_torch.optim.schedule import constant_lr
from repro_torch.train import TrainConfig, init_state, make_train_step
from repro_torch.train.step import StateSharding
from repro_torch.utils.pytree import tree_leaves
from test_torch_train_ef import _Linear

rank, out, rdv = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=4)
cfg = get_smoke_config("lm-100m")
G, _ = load_checkpoint(out + "/G", LM(cfg).init(
    torch.Generator().manual_seed(0), device="cpu"))
model = _Linear(cfg, G)
losses = json.load(open(out + "/losses.json"))
tokens = torch.zeros((1, 16), dtype=torch.int64)
rows = []
for name, (mode, pods) in {cases!r}.items():
    tcfg = TrainConfig(policy=QuantPolicy.parse("orq-9", bucket_size=512),
                       mode=mode, error_feedback=True,
                       hierarchy="two_level" if pods > 1 else "flat")
    fn = make_train_step(model, tcfg, constant_lr({lr}), pods=pods)
    sh = StateSharding(fn)
    like = sh.gather(init_state(model, tcfg, device="cpu", step=fn))
    states = [sh.scatter(load_checkpoint(f"{{out}}/{{name}}{{i}}", like)[0])
              for i in range(3)]
    for i in range(2):
        before, after = states[i], states[i + 1]
        new, m = fn(before, {{"tokens": tokens}}, prng.key(0))
        upd = []
        for p, p0, w in zip(tree_leaves(new.params),
                            tree_leaves(before.params),
                            tree_leaves(after.params), strict=True):
            d, want = (p - p0).numpy(), (w - p0).numpy()
            upd.append(float(np.linalg.norm(d - want)
                             / max(np.linalg.norm(want), 1e-30)))
        rows.append({{
            "case": name, "step": i, "rank": rank,
            "two_level": fn.layout.two_level, "loss": float(m["loss"]),
            "ref_loss": losses[name][i], "new_step": new.step,
            "ref_step": after.step, "update_rel": max(upd),
            "ef_sizes": [e.numel() for e in new.ef],
            "ref_ef_sizes": [e.numel() for e in after.ef],
            "ef_in_nonzero": any(bool(e.abs().max() > 0) for e in before.ef),
            "ef_equal": all(torch.equal(a, b)
                            for a, b in zip(new.ef, after.ef))}})
print("ROWS " + json.dumps(rows), flush=True)
dist.destroy_process_group()
"""

def _env(extra):
    return {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
            "JAX_PLATFORMS": "cpu", **extra}


@pytest.fixture(scope="module")
def dp_rows(tmp_path_factory):
    """The reference's states on 4 fake devices, then one port step from
    each on 4 gloo workers -> {(case, step): [row of each rank]}."""
    tmp = tmp_path_factory.mktemp("train_ef")
    fmt = dict(cases=CASES, lr=LR, tests=os.path.join(ROOT, "tests"))
    jax_src = JAX_PROG.format(**fmt)
    subprocess.run(
        [sys.executable, "-c", jax_src, str(tmp)], check=True, timeout=600,
        env=_env({"XLA_FLAGS": "--xla_force_host_platform_device_count=4"}))
    torch_src = TORCH_PROG.format(**fmt)
    procs = [subprocess.Popen(
        [sys.executable, "-c", torch_src, str(r), str(tmp), str(tmp / "rdv")],
        env=_env({"OMP_NUM_THREADS": "1"}), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    rows = {}
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("ROWS ")][-1]
        for row in json.loads(line[len("ROWS "):]):
            rows.setdefault((row["case"], row["step"]), []).append(row)
    return rows


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dp_ef_step_matches_fake_devices(dp_rows, case, step):
    rows = dp_rows[(case, step)]
    assert sorted(r["rank"] for r in rows) == [0, 1, 2, 3]
    for r in rows:
        assert r["two_level"] == (CASES[case][1] > 1)
        assert r["new_step"] == r["ref_step"] == step + 1
        np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=LOSS_RTOL)
        assert r["update_rel"] < DP_UPDATE_RTOL
        assert r["ef_sizes"] == r["ref_ef_sizes"]
        assert r["ef_in_nonzero"] == bool(step)
        assert r["ef_equal"], r
