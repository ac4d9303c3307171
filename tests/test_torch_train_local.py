"""The single-device train step (``make_train_step(...,
data_parallel=False)``), the optimizer choice and the launcher's
pipelined and per-leaf exchanges, against the JAX reference.

* The reference's step on a mesh with no data axis
  (``jax.make_mesh((1,), ("model",))``) quantizes and dequantizes
  locally; the port's single-device step is its counterpart. Both run two
  steps of orq-9 with error feedback, fused and per-leaf, the second from
  the reference's post-step state, so that its residual enters the
  update.

  - On the model's own gradients (smoke lm-100m): the loss within rtol
    1e-3 (bf16 matmuls round at other places in XLA and PyTorch). Per
    leaf, the update within UPDATE_RTOL and the new residual within
    EF_RTOL in relative norm. The ~1% gradient differences move ORQ's
    levels and flip rounding decisions, each by a level gap; the residual
    takes every flip whole. Readings on the CPU: update <= 0.0999,
    residual <= 0.398, both schedules and steps. A zeroed residual reads
    1 and one of the wrong sign 2.
  - On one shared gradient (a loss ``sum(p * G)`` on both sides, G the
    reference's gradient at the initial params): the residuals bit-equal
    to the reference's and the update within SHARED_UPDATE_RTOL (readings
    <= 6.1e-7: the optimizer's f32 arithmetic in another order).
  - On the reference's own gradient the local quantize-dequantize of both
    schedules reproduces the reference's: at least 99.9% of the elements
    equal, the rest within a level gap (the ORQ fit is float-close across
    frameworks).
* ``TrainConfig.optimizer`` / ``momentum`` / ``weight_decay`` build the
  reference's optimizers (float-close over three updates).
* The launcher on the CPU: ``--pipeline-chunks`` 3 and 4 give the
  ``K = 1`` params sha256, 4K launches and the same wire bytes;
  ``--per-leaf-exchange`` gives 4 launches per leaf and the reference's
  per-leaf bytes; both keep two gloo workers in sync.
"""
import json
import os
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core import comm as jcomm
from repro.core.api import make_quantizer as jmake_quantizer
from repro.core.policy import QuantPolicy as JPolicy
from repro.data import SyntheticLM as JSyntheticLM
from repro.models.model import LM as JLM
from repro.optim.schedule import constant_lr as jconstant_lr
from repro.train import step as jstep
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import prng
from repro_torch.core.comm.exchange import LeafExchange
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import LM
from repro_torch.optim.schedule import constant_lr
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.step import _FUSED_SALT, exchange_engine
from repro_torch.utils.pytree import tree_leaves
from torch_test_env import port_test_env  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.05
SCHEDULES = ("fused", "per_leaf")
UPDATE_RTOL = 0.12
EF_RTOL = 0.45
SHARED_UPDATE_RTOL = 1e-6


def _np(tree):
    # copies: the reference's step donates its input state
    return jax.tree_util.tree_map(np.array, tree)


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _jcfg(sched):
    return jstep.TrainConfig(
        policy=JPolicy.parse("orq-9", bucket_size=512), mode="replicated",
        error_feedback=True, fused_exchange=sched == "fused")


def _tcfg(sched):
    return TrainConfig(policy=QuantPolicy.parse("orq-9", bucket_size=512),
                       error_feedback=True, fused_exchange=sched == "fused")


def _ref_steps(jmodel, sched, batches):
    """The reference's states through ``len(batches)`` single-device steps
    from ``init_state(key(0))``, and each step's loss."""
    mesh = jax.make_mesh((1,), ("model",))      # no data axis
    state = jstep.init_state(jmodel, mesh, _jcfg(sched), jax.random.key(0))
    fn, _ = jstep.make_train_step(jmodel, mesh, _jcfg(sched),
                                  lr_fn=jconstant_lr(LR))
    states, losses = [_np(state)], []
    for b in batches:
        state, metrics = fn(state, b, jax.random.key(0))
        states.append(_np(state))
        losses.append(float(metrics["loss"]))
    return states, losses


def _check_update_and_ef(state, before, after, update_rtol, ef_rtol):
    for p, p0, w in zip(tree_leaves(state.params),
                        jax.tree_util.tree_leaves(before.params),
                        jax.tree_util.tree_leaves(after.params), strict=True):
        assert _rel(p.numpy() - p0, w - p0) < update_rtol
    for e, w in zip(tree_leaves(state.ef),
                    jax.tree_util.tree_leaves(after.ef), strict=True):
        assert e.shape == w.shape and e.dtype == torch.float32
        if ef_rtol == 0:
            np.testing.assert_array_equal(e.numpy(), w)
        else:
            assert _rel(e.numpy(), w) < ef_rtol


@pytest.fixture(scope="module")
def ref_runs():
    """Per schedule, the reference's states and losses through two
    single-device steps (orq-9 + EF, batches 0 and 1); the batches' tokens
    and the reference's gradient at the initial params."""
    jmodel = JLM(jget_smoke_config("lm-100m"))
    batches = [JSyntheticLM(512, 16, 2, 0).batch(i) for i in range(2)]
    out = {sched: _ref_steps(jmodel, sched, batches) for sched in SCHEDULES}
    p0 = jax.tree_util.tree_map(jnp.asarray, out["fused"][0][0].params)
    grads = jax.grad(lambda p: jmodel.loss(p, batches[0])[0])(p0)
    return (jmodel, [np.array(b["tokens"]) for b in batches], out,
            _np(grads))


@pytest.mark.parametrize("sched", SCHEDULES)
def test_single_device_step_close(ref_runs, sched):
    _, tokens, out, _ = ref_runs
    states, losses = out[sched]
    model = LM(get_smoke_config("lm-100m"))
    fn = make_train_step(model, _tcfg(sched), constant_lr(LR),
                         data_parallel=False)
    assert fn.launches_and_bytes(1) == (0, 0.0)
    for i, tok in enumerate(tokens):
        before, after = states[i], states[i + 1]
        state, metrics = fn(state_from_jax(before, device="cpu"),
                            {"tokens": torch.from_numpy(tok)}, prng.key(0))
        np.testing.assert_allclose(float(metrics["loss"]), losses[i],
                                   rtol=1e-3)
        assert state.step == int(after.step) == i + 1
        _check_update_and_ef(state, before, after, UPDATE_RTOL, EF_RTOL)


class _JLinear(JLM):
    """The reference's model with the loss ``sum(p * G)``: its gradient is
    ``G`` exactly."""

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


@pytest.fixture(scope="module")
def shared_runs(ref_runs):
    """Per schedule, the reference's states through two single-device
    steps on the shared gradient G (the residual of the first enters the
    second)."""
    _, tokens, _, jgrads = ref_runs
    jmodel = _JLinear(jget_smoke_config("lm-100m"), jgrads)
    batches = [{"tokens": jnp.asarray(t)} for t in tokens]
    return {sched: _ref_steps(jmodel, sched, batches)[0]
            for sched in SCHEDULES}


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("sched", SCHEDULES)
def test_single_device_step_on_shared_gradient(ref_runs, shared_runs,
                                               sched, step):
    _, tokens, _, jgrads = ref_runs
    before, after = shared_runs[sched][step:step + 2]
    if step:
        assert any(np.abs(e).max() > 0
                   for e in jax.tree_util.tree_leaves(before.ef))
    model = _Linear(get_smoke_config("lm-100m"),
                    params_from_jax(jgrads, device="cpu"))
    fn = make_train_step(model, _tcfg(sched), constant_lr(LR),
                         data_parallel=False)
    state, _ = fn(state_from_jax(before, device="cpu"),
                  {"tokens": torch.from_numpy(tokens[step])}, prng.key(0))
    assert state.step == int(after.step) == step + 1
    _check_update_and_ef(state, before, after, SHARED_UPDATE_RTOL, 0)


def _hold(got, want):
    same = got == want
    assert same.mean() >= 0.999
    gap = np.abs(want).max() / 4           # coarser than any level gap
    assert np.all(np.abs(got - want)[~same] <= gap)


def test_fused_local_qdq_of_reference_grads_matches(ref_runs):
    jmodel, _, _, jgrads = ref_runs
    jpex = jcomm.PartitionedExchange.build(
        JPolicy.parse("orq-9", bucket_size=512), jgrads, (),
        paths=jmodel.param_paths(jgrads))
    k = jax.random.fold_in(jax.random.fold_in(jax.random.key(0), 0),
                           jstep._FUSED_SALT)
    want = [np.asarray(x) for x in jpex.qdq_local_parts(
        jpex.layout.flatten_groups(jgrads), k)]
    model = LM(get_smoke_config("lm-100m"))
    pex = exchange_engine(model, TrainConfig(
        policy=QuantPolicy.parse("orq-9", bucket_size=512)))
    tk = prng.fold_in(prng.fold_in(prng.key(0), 0), _FUSED_SALT)
    got = pex.qdq_local_parts(
        pex.layout.flatten_groups(params_from_jax(jgrads, device="cpu")), tk)
    for g, w in zip(got, want, strict=True):
        _hold(g.numpy(), w)


def test_per_leaf_local_qdq_of_reference_grads_matches(ref_runs):
    jmodel, _, _, jgrads = ref_runs
    step_key = jax.random.fold_in(jax.random.key(0), 0)
    jqz = jmake_quantizer("orq-9", bucket_size=512)
    model = LM(get_smoke_config("lm-100m"))
    tg = params_from_jax(jgrads, device="cpu")
    paths = model.param_paths(tg)
    assert tree_leaves(paths) == jax.tree_util.tree_leaves(
        jmodel.param_paths(jgrads))
    lex = LeafExchange(QuantPolicy.parse("orq-9", bucket_size=512))
    got = lex.qdq_local(paths, tg, prng.fold_in(prng.key(0), 0))
    for path, g, w in zip(tree_leaves(paths), tree_leaves(got),
                          jax.tree_util.tree_leaves(jgrads), strict=True):
        k = jax.random.fold_in(step_key,
                               zlib.crc32(path.encode()) & 0x7FFFFFFF)
        want = np.asarray(jqz.qdq(jnp.asarray(w).reshape(-1), k)).reshape(
            w.shape)
        _hold(g.numpy(), want)


def test_single_device_step_needs_no_group_and_takes_none():
    """The branch is chosen by the argument alone: without it a step with
    no process group raises, as before; with it a group is refused."""
    model = LM(get_smoke_config("lm-100m"))
    tcfg = TrainConfig(policy="orq-9")
    with pytest.raises(ValueError, match="single-device"):
        make_train_step(model, tcfg, group=object(), data_parallel=False)
    if not torch.distributed.is_initialized():
        from repro_torch.train import init_state
        state = init_state(model, tcfg, device="cpu")
        batch = {"tokens": torch.zeros((2, 9), dtype=torch.int64)}
        with pytest.raises(RuntimeError, match="process group"):
            make_train_step(model, tcfg)(state, batch, prng.key(0))
        state, m = make_train_step(model, tcfg, data_parallel=False)(
            state, batch, prng.key(0))
        assert np.isfinite(float(m["loss"])) and state.step == 1


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"momentum": 0.8, "weight_decay": 1e-2}),
    ("adamw", {"weight_decay": 1e-2})])
def test_optimizer_choice_matches_reference(name, kw):
    from repro.optim import optimizers as jopt
    from repro_torch.optim import optimizers as opt
    from repro_torch.train.step import _make_optimizer
    jo = jstep._make_optimizer(jstep.TrainConfig(optimizer=name, **kw))
    to = _make_optimizer(TrainConfig(optimizer=name, **kw))
    rng = np.random.default_rng(0)
    p0 = {"b": rng.standard_normal((3,)).astype(np.float32),
          "a": {"w": rng.standard_normal((4, 5)).astype(np.float32)}}
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = params_from_jax(p0, device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), p0)
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                           jnp.float32(LR))
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update(params_from_jax(g, device="cpu"), ts, tp, LR)
        tp = opt.apply_updates(tp, tu)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError):
        _make_optimizer(TrainConfig(optimizer="lion"))


# ---------------------------------------------------------------------------
# the launcher's schedules
# ---------------------------------------------------------------------------

_WORKER = """
import importlib, sys
import torch.distributed as dist
rank, n, rdv = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=n)
try:
    rc = importlib.import_module("repro_torch.launch.train").main(
        sys.argv[4:])
finally:
    dist.destroy_process_group()
sys.exit(rc)
"""

BASE = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
        "--seq", "16", "--quant", "orq-9", "--bucket", "512",
        "--error-feedback"]


def _start(tmp_path, tag, n, *args):
    """The launcher on ``n`` gloo processes (own ``file://`` rendezvous)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    rdv = str(tmp_path / f"rdv_{tag}")
    out = tmp_path / f"{tag}.json"
    return out, [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(n), rdv, *args,
         "--metrics-out", str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]


@pytest.fixture(scope="module", autouse=True)
def launcher_started(port_test_env, tmp_path_factory):
    """Each schedule on two gloo workers, the four worlds started together
    when the module's first test runs (they run while the reference
    computes in process)."""
    tmp = tmp_path_factory.mktemp("train_schedules")
    runs = {"K1": [], "K3": ["--pipeline-chunks", "3"],
            "K4": ["--pipeline-chunks", "4"],
            "per_leaf": ["--per-leaf-exchange"]}
    started = {tag: _start(tmp, tag, 2, *BASE, *extra)
               for tag, extra in runs.items()}
    yield started
    for _, procs in started.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def launcher_runs(launcher_started):
    """-> rank 0's metrics per schedule."""
    started = launcher_started
    out = {}
    for tag, (path, procs) in started.items():
        log = "".join(p.communicate(timeout=300)[0] for p in procs)
        assert [p.returncode for p in procs] == [0, 0], log
        assert "replicas in sync: True (2 workers)" in log
        out[tag] = json.loads(path.read_text())
    return out


@pytest.mark.parametrize("K", [3, 4])
def test_launcher_pipelined_bit_identical(launcher_runs, K):
    base, run = launcher_runs["K1"], launcher_runs[f"K{K}"]
    assert run["params_sha256"] == base["params_sha256"]
    assert run["pipeline_chunks"] == K
    assert run["collective_launches_per_step"] == 4 * K
    assert base["collective_launches_per_step"] == 4
    assert run["wire_bytes_per_worker"] == base["wire_bytes_per_worker"]
    assert [h["loss"] for h in run["history"]] == \
        [h["loss"] for h in base["history"]]


def test_launcher_per_leaf_accounting(launcher_runs):
    run = launcher_runs["per_leaf"]
    model = LM(get_smoke_config("lm-100m"))
    sizes = [t.numel() for t in tree_leaves(model.abstract_params())]
    want = jcomm.per_leaf_stats(jmake_quantizer("orq-9", bucket_size=512),
                                sizes, 2)
    assert run["exchange"] == "per-leaf"
    assert (run["collective_launches_per_step"],
            run["wire_bytes_per_worker"]) == want
    assert run["collective_launches_per_step"] == 4 * len(sizes)
    assert all(np.isfinite(h["loss"]) for h in run["history"])
    assert run["params_sha256"] != launcher_runs["K1"]["params_sha256"]
