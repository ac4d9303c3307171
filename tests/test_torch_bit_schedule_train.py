"""The port's ``ScheduledTrainStep`` on a gloo world of one, alone and
against the JAX reference's.

* A frozen schedule (``default=orq@4``) builds one engine and ends on the
  static ``default=orq-9`` run's params, optimizer state and EF residuals
  bit for bit, replicated and fsdp, with error feedback.
* The EF residuals carry across a change of bits (orq@4..2 over 4 steps,
  resolved every 2: 4 bits, then 3): zeroing them
  at the phase boundary changes the params, and they are live after it.
* Against the reference's ``ScheduledTrainStep`` on
  ``jax.make_mesh((1,), ("data",))``, both on the loss ``sum(p * G)`` with
  ``G`` on a 1/64 grid (every worker's gradient is ``G``, so both sides
  quantize the same buffers), over the ramp ``orq@5..1`` resolved every
  step (orq-17, orq-9, orq-5, orq-3, then minmax2 under the EF residual
  the orq-3 phase left): the assignments, the EF residuals and the params
  bit-equal after each of the 5 steps (the SGD step rounded as XLA
  contracts it, ``optimizers.step``), and the ``exchange_stats`` metric
  within STATS_RTOL.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core.policy import BitBudgetController as JController
from repro.core.policy import BitSchedule as JSchedule
from repro.models.model import LM as JLM
from repro.optim.schedule import constant_lr as jconstant_lr
from repro.train import step as jstep
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import prng
from repro_torch.core.policy import (BitBudgetController, BitSchedule,
                                     QuantPolicy)
from repro_torch.data import SyntheticLM
from repro_torch.models import LM
from repro_torch.optim.schedule import constant_lr
from repro_torch.train import TrainConfig, init_state, make_train_step
from repro_torch.train.step import ScheduledTrainStep
from repro_torch.utils.pytree import tree_leaves, tree_map

LR = 0.05
STATS_RTOL = 1e-5


@pytest.fixture(scope="module")
def world1():
    """A gloo world of one process on its own ``file://`` rendezvous."""
    if not dist.is_initialized():
        tmp = tempfile.mkdtemp(prefix="repro_torch_test_world_")
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
    return dist.get_world_size()


def _leaves(state):
    return tree_leaves((state.params, state.opt, state.ef))


def _run(fn, state, steps, data, reset_ef_at=None):
    seen = []
    for i in range(steps):
        if reset_ef_at == i:
            state = state._replace(ef=tree_map(torch.zeros_like, state.ef))
        state, _ = fn(state, data.batch(i, device="cpu"), prng.key(7))
        seen.append(getattr(fn, "last_assignment", None))
    return state, seen


@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_frozen_schedule_bit_identical_to_static(world1, mode):
    model = LM(get_smoke_config("lm-100m"))
    data = SyntheticLM(512, 16, 2, 3)
    tcfg = TrainConfig(policy=QuantPolicy.parse("norm|bias=fp,default=orq-9",
                                                bucket_size=512),
                       mode=mode, error_feedback=True, group_by_rule=True)
    fn = make_train_step(model, tcfg, constant_lr(LR))
    static, _ = _run(fn, init_state(model, tcfg, device="cpu", step=fn), 3,
                     data)
    ctl = BitBudgetController(
        BitSchedule.parse("norm|bias=fp,default=orq@4", bucket_size=512), 3,
        resolve_every=1)
    sched = ScheduledTrainStep(model, TrainConfig(mode=mode,
                                                  error_feedback=True),
                               ctl, constant_lr(LR))
    dyn, seen = _run(sched, init_state(model, sched.init_config,
                                       device="cpu", step=sched), 3, data)
    assert set(seen) == {(None, 4)} and len(sched._cache) == 1
    assert [d["bits"] for d in sched.decisions] == [[None, 4]] * 3
    for a, b in zip(_leaves(static), _leaves(dyn), strict=True):
        assert torch.equal(a, b)


def test_ef_carries_across_bits_change(world1):
    model = LM(get_smoke_config("lm-100m"))
    data = SyntheticLM(512, 16, 2, 3)
    out = {}
    for reset in (None, 2):
        ctl = BitBudgetController(
            BitSchedule.parse("norm|bias=fp,default=orq@4..2",
                              bucket_size=512), 4, resolve_every=2)
        sched = ScheduledTrainStep(model, TrainConfig(error_feedback=True),
                                   ctl, constant_lr(LR))
        state = init_state(model, sched.init_config, device="cpu",
                           step=sched)
        out[reset] = _run(sched, state, 4, data, reset_ef_at=reset)
    (carried, seen), (zeroed, _) = out[None], out[2]
    assert seen == [(None, 4), (None, 4), (None, 3), (None, 3)]
    c, z = tree_leaves(carried.params), tree_leaves(zeroed.params)
    assert all(torch.isfinite(x).all() for x in c)
    assert any(not torch.equal(a, b) for a, b in zip(c, z))
    assert any(float(e.abs().max()) > 0 for e in tree_leaves(carried.ef))


# ---------------------------------------------------------------------------
# against the reference on a shared gradient
# ---------------------------------------------------------------------------

class _JLinear(JLM):
    """The reference's model with the loss ``sum(p * G)``."""

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


SPEC = "norm|bias=fp,default=orq@5..1"
STEPS = 5


@pytest.fixture(scope="module")
def ref_run():
    """G on a 1/64 grid and the reference's states, assignments and stats
    through STEPS scheduled steps."""
    cfg = jget_smoke_config("lm-100m")
    shapes = jax.eval_shape(JLM(cfg).init, jax.random.key(0))
    rng = np.random.default_rng(0)
    G = jax.tree_util.tree_map(
        lambda s: (rng.integers(-64, 65, s.shape) / 64).astype(np.float32),
        shapes)
    model = _JLinear(cfg, G)
    mesh = jax.make_mesh((1,), ("data",))
    ctl = JController(JSchedule.parse(SPEC, bucket_size=512), STEPS,
                      resolve_every=1)
    fn = jstep.ScheduledTrainStep(
        model, mesh, jstep.TrainConfig(mode="replicated",
                                       error_feedback=True,
                                       collect_stats=True),
        ctl, jconstant_lr(LR))
    state = jstep.init_state(model, mesh, fn.init_config, jax.random.key(0))
    batch = {"tokens": jnp.zeros((1, 17), jnp.int32)}
    states, seen, stats = [jax.tree_util.tree_map(np.array, state)], [], []
    for _ in range(STEPS):
        state, m = fn(state, batch, jax.random.key(0))
        states.append(jax.tree_util.tree_map(np.array, state))
        seen.append(fn.last_assignment)
        stats.append(np.array(m["exchange_stats"]))
    return G, states, seen, stats, ctl.decisions


def test_scheduled_step_matches_reference(world1, ref_run):
    G, states, seen, stats, decisions = ref_run
    assert seen == [(None, 5), (None, 4), (None, 3), (None, 2), (None, 1)]
    model = _Linear(get_smoke_config("lm-100m"),
                    params_from_jax(G, device="cpu"))
    ctl = BitBudgetController(BitSchedule.parse(SPEC, bucket_size=512),
                              STEPS, resolve_every=1)
    fn = ScheduledTrainStep(model, TrainConfig(error_feedback=True,
                                               collect_stats=True),
                            ctl, constant_lr(LR))
    state = init_state(model, fn.init_config, device="cpu", step=fn)
    state = state._replace(params=params_from_jax(states[0].params, "cpu"))
    tokens = torch.zeros((1, 17), dtype=torch.int64)
    for i in range(STEPS):
        state, m = fn(state, {"tokens": tokens}, prng.key(0))
        want = states[i + 1]
        assert fn.last_assignment == seen[i]
        assert state.step == int(want.step) == i + 1
        for a, b in zip(tree_leaves(state.ef),
                        jax.tree_util.tree_leaves(want.ef), strict=True):
            np.testing.assert_array_equal(a.numpy(), b)
        assert any(np.abs(e).max() > 0
                   for e in jax.tree_util.tree_leaves(want.ef))
        for a, b in zip(tree_leaves((state.params, state.opt)),
                        jax.tree_util.tree_leaves((want.params, want.opt)),
                        strict=True):
            np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_allclose(m["exchange_stats"].numpy(), stats[i],
                                   rtol=STATS_RTOL)
    assert ctl.decisions == decisions


def test_launcher_bit_schedule_and_budget(world1, tmp_path):
    """``--bit-schedule`` with ``--bit-budget`` on the CPU: every logged
    row carries its bits, the metrics carry the controller's decisions
    (statistics-driven once the first step has reported), each priced
    within the budget by the per-link accounting of the engines as built
    (on a world of one nothing crosses pods: 0 bytes)."""
    from repro_torch.launch import train as launcher
    out = tmp_path / "m.json"
    rec = launcher.train([
        "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
        "--seq", "16", "--bucket", "512", "--error-feedback",
        "--bit-schedule", "norm|bias=fp,default=orq@5..3",
        "--resolve-every", "1", "--bit-budget", "1e5", "--log-every", "1",
        "--metrics-out", str(out)])
    import json
    m = json.loads(out.read_text())
    assert [h["bits"] for h in m["history"]] == [[None, 5], [None, 4],
                                                 [None, 3]]
    assert [d["stats_driven"] for d in m["bit_decisions"]] == [False, True,
                                                               True]
    assert all(d["est_dcn_bytes"] == 0.0 <= d["budget"]
               for d in m["bit_decisions"])
    assert rec["replicas_in_sync"] and len(rec["step_s"]) == 3
