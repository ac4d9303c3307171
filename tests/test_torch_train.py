"""The port's Algorithm-2 training step against the JAX reference.

* ``SyntheticLM`` tokens are bit-equal for several steps.
* One smoke-config step from the same state (``convert.state_from_jax``),
  the port on a gloo world of one process, the reference on a one-device
  mesh (which still runs the full two-phase exchange, L = 1): the loss is
  float-close (rtol 1e-3: bf16 matmuls round at other places in XLA and
  PyTorch), the gradients are close in relative norm (2e-2, the same
  bf16 cause), and with the fp policy the updated params are close
  (the update within 2e-2 in relative norm per leaf). With orq-9 the
  port's exchange, and its error-feedback qdq, of the reference's own
  gradient buffer reproduce the reference's outputs (the ORQ fit is
  float-close across frameworks: at least 99.9% of the elements equal,
  the rest within a level gap); a whole orq-9 step with error feedback
  updates within 0.2 in relative norm (the bf16 gradient differences
  flip some rounding decisions).
* The launcher CLI runs on the CPU.
"""
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
from jax.sharding import PartitionSpec as P

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core.policy import QuantPolicy as JPolicy
from repro.data import SyntheticLM as JSyntheticLM
from repro.models.model import LM as JLM
from repro.optim.schedule import constant_lr as jconstant_lr
from repro.train import step as jstep
from repro.utils.compat import shard_map
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import prng
from repro_torch.core.policy import QuantPolicy
from repro_torch.data import SyntheticLM
from repro_torch.models import LM
from repro_torch.optim.schedule import constant_lr, step_decay
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.step import _FUSED_SALT, exchange_engine
from repro_torch.utils.pytree import tree_leaves
from torch_test_env import port_test_env  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.05


@pytest.fixture(scope="module")
def world1():
    """A gloo world of one process on its own ``file://`` rendezvous."""
    if not dist.is_initialized():
        tmp = tempfile.mkdtemp(prefix="repro_torch_test_world_")
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
    return dist.get_world_size()


@pytest.mark.parametrize("V,S,B,seed", [(512, 16, 3, 0), (32768, 40, 2, 7)])
def test_synthetic_tokens_bit_equal(V, S, B, seed):
    j, t = JSyntheticLM(V, S, B, seed), SyntheticLM(V, S, B, seed)
    for step in range(3):
        want = np.asarray(j.batch(step)["tokens"])
        got = t.batch(step, device="cpu")["tokens"].numpy()
        assert got.shape == want.shape == (B, S + 1)
        np.testing.assert_array_equal(got, want)


def test_synthetic_batch_defaults_to_the_card():
    """Like every entry point: the card unless the caller asks for the
    CPU, and an error when there is no card."""
    data = SyntheticLM(512, 16, 2, 0)
    if torch.cuda.is_available():
        assert data.batch(0)["tokens"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            data.batch(0)


def test_schedules_match_reference():
    from repro.optim.schedule import step_decay as jstep_decay
    from repro.optim.schedule import warmup_cosine as jwarmup
    from repro_torch.optim.schedule import warmup_cosine
    fns = [(step_decay(0.05, [5, 8]), jstep_decay(0.05, [5, 8])),
           (warmup_cosine(0.1, 3, 10), jwarmup(0.1, 3, 10))]
    for ours, theirs in fns:
        for s in range(12):
            np.testing.assert_allclose(ours(s), float(theirs(s)), rtol=1e-6)


@pytest.mark.parametrize("name", ["sgd", "sgd_nesterov_wd", "adamw"])
def test_optimizers_match_reference(name):
    """Three updates of a small tree, f32 throughout: float-close (the
    reference's XLA may fuse multiply-adds the port rounds twice)."""
    from repro.optim import optimizers as jopt
    from repro_torch.optim import optimizers as opt
    make = {"sgd": lambda m: m.sgd_momentum(),
            "sgd_nesterov_wd": lambda m: m.sgd_momentum(
                momentum=0.8, weight_decay=1e-2, nesterov=True),
            "adamw": lambda m: m.adamw(weight_decay=1e-2)}[name]
    rng = np.random.default_rng(0)
    p0 = {"b": rng.standard_normal((3,)).astype(np.float32),
          "a": {"w": rng.standard_normal((4, 5)).astype(np.float32)}}
    jo, to = make(jopt), make(opt)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = params_from_jax(p0, device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        g = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), p0)
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                           jnp.float32(0.05))
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update(params_from_jax(g, device="cpu"), ts, tp, 0.05)
        tp = opt.apply_updates(tp, tu)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref_runs():
    """Reference states before and after one step, per policy."""
    jmodel = JLM(jget_smoke_config("lm-100m"))
    mesh = jax.make_mesh((1,), ("data",))   # one device, one dp axis
    batch = JSyntheticLM(512, 16, 2, 0).batch(0)
    out = {}
    for name, policy, ef in (("fp", "fp", False), ("orq", "orq-9", True)):
        tcfg = jstep.TrainConfig(policy=JPolicy.parse(policy,
                                                      bucket_size=512),
                                 mode="replicated", error_feedback=ef)
        state = jstep.init_state(jmodel, mesh, tcfg, jax.random.key(0))
        before = _np(state)
        fn, _ = jstep.make_train_step(jmodel, mesh, tcfg,
                                      lr_fn=jconstant_lr(LR))
        after, metrics = fn(state, batch, jax.random.key(0))
        out[name] = (before, _np(after), float(metrics["loss"]))
    grads = jax.grad(lambda p: jmodel.loss(p, batch)[0])(
        jax.tree_util.tree_map(jnp.asarray, out["fp"][0].params))
    return jmodel, mesh, np.array(batch["tokens"]), out, _np(grads)


def _port_step(policy, ef, before, tokens):
    model = LM(get_smoke_config("lm-100m"))
    tcfg = TrainConfig(policy=QuantPolicy.parse(policy, bucket_size=512),
                       error_feedback=ef)
    fn = make_train_step(model, tcfg, constant_lr(LR))
    state = state_from_jax(before, device="cpu")
    return fn(state, {"tokens": torch.from_numpy(tokens)}, prng.key(0))


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_grads_close(world1, ref_runs):
    _, _, tokens, out, jgrads = ref_runs
    model = LM(get_smoke_config("lm-100m"))
    params = params_from_jax(out["fp"][0].params, device="cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss, _ = model.loss(params, {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(loss, leaves)
    for g, w in zip(grads, jax.tree_util.tree_leaves(jgrads), strict=True):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) < 2e-2


def test_fp_step_close(world1, ref_runs):
    _, _, tokens, out, _ = ref_runs
    before, after, jloss = out["fp"]
    state, metrics = _port_step("fp", False, before, tokens)
    np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=1e-3)
    assert state.step == int(after.step) == 1
    for p, p0, w in zip(tree_leaves(state.params),
                        jax.tree_util.tree_leaves(before.params),
                        jax.tree_util.tree_leaves(after.params), strict=True):
        assert _rel(p.numpy() - p0, w - p0) < 2e-2
    for m, w in zip(tree_leaves(state.opt),
                    jax.tree_util.tree_leaves(after.opt), strict=True):
        assert _rel(m.numpy(), w) < 2e-2


def test_orq_ef_step_close(world1, ref_runs):
    _, _, tokens, out, _ = ref_runs
    before, after, jloss = out["orq"]
    state, metrics = _port_step("orq-9", True, before, tokens)
    np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=1e-3)
    assert state.ef is not None
    # the ~1% bf16 gradient differences move ORQ's levels (bucket values)
    # and flip some rounding decisions, each by a level gap: the update
    # agrees within 0.2 in relative norm (the exchange itself is held
    # exact on one buffer below)
    for p, p0, w in zip(tree_leaves(state.params),
                        jax.tree_util.tree_leaves(before.params),
                        jax.tree_util.tree_leaves(after.params), strict=True):
        assert _rel(p.numpy() - p0, w - p0) < 0.2
    for e, w in zip(tree_leaves(state.ef),
                    jax.tree_util.tree_leaves(after.ef), strict=True):
        assert e.shape == w.shape and np.isfinite(e.numpy()).all()


def test_orq_exchange_of_reference_grads_matches(world1, ref_runs):
    """Same gradient buffer, same key: the port's fused exchange
    reproduces the reference's (keys folded as the step folds them)."""
    jmodel, mesh, _, _, jgrads = ref_runs
    jpol = JPolicy.parse("orq-9", bucket_size=512)
    from repro.core import comm as jcomm
    jpex = jcomm.PartitionedExchange.build(
        jpol, jgrads, ("data",), paths=jmodel.param_paths(jgrads))
    jbufs = jpex.layout.flatten_groups(jgrads)
    k = jax.random.fold_in(jax.random.fold_in(jax.random.key(0), 0),
                           jstep._FUSED_SALT)
    fn = jax.jit(shard_map(lambda *b: jpex.exchange_parts(b, k), mesh=mesh,
                           in_specs=(P(),) * len(jbufs),
                           out_specs=(P(),) * len(jbufs),
                           axis_names={"data"}, check_vma=False))
    want = [np.asarray(x) for x in fn(*jbufs)]
    fn = jax.jit(shard_map(lambda *b: jpex.local_qdq_parts(b, k), mesh=mesh,
                           in_specs=(P(),) * len(jbufs),
                           out_specs=(P(),) * len(jbufs),
                           axis_names={"data"}, check_vma=False))
    want_qdq = [np.asarray(x) for x in fn(*jbufs)]

    model = LM(get_smoke_config("lm-100m"))
    tcfg = TrainConfig(policy=QuantPolicy.parse("orq-9", bucket_size=512))
    pex = exchange_engine(model, tcfg)
    tk = prng.fold_in(prng.fold_in(prng.key(0), 0), _FUSED_SALT)
    bufs = pex.layout.flatten_groups(params_from_jax(jgrads, device="cpu"))
    got = [x.numpy() for x in pex.exchange_parts(bufs, tk)]
    got_qdq = [x.numpy() for x in pex.local_qdq_parts(bufs, tk)]
    for g, w in zip(got + got_qdq, want + want_qdq, strict=True):
        same = g == w
        assert same.mean() >= 0.999
        gap = np.abs(w).max() / 4          # coarser than any level gap
        assert np.all(np.abs(g - w)[~same] <= gap)


def test_step_draws_on_params_device(world1, ref_runs, monkeypatch):
    """A key built on another device object is moved to the params'
    device: every threefry draw of the step runs there."""
    _, _, tokens, out, _ = ref_runs
    seen = []
    real = prng.bits

    def spy(k, shape):
        seen.append((k.device, tuple(shape)))
        return real(k, shape)

    monkeypatch.setattr(prng, "bits", spy)
    model = LM(get_smoke_config("lm-100m"))
    tcfg = TrainConfig(policy=QuantPolicy.parse("orq-9", bucket_size=512),
                       error_feedback=True)
    fn = make_train_step(model, tcfg, constant_lr(LR))
    state = state_from_jax(out["orq"][0], device="cpu")
    fn(state, {"tokens": torch.from_numpy(tokens)},
       prng.key(0, device=torch.device("cpu", 0)))
    dev = tree_leaves(state.params)[0].device
    # phase 1, phase 2 and the EF qdq each draw one full-buffer stream
    assert len(seen) == 3
    assert all(d == dev for d, _ in seen)


def test_train_config_refuses_unported(world1):
    # fsdp, the two-level hierarchy and its async window are ported
    # (test_torch_fsdp_train.py, test_torch_hierarchical.py,
    # test_torch_async.py); TrainConfig refuses what the reference's
    # refuses, with its messages; model parallelism is ported, and its
    # TP dims are the reference's (every config: test_torch_tp_plan.py)
    assert TrainConfig(mode="fsdp", hierarchy="two_level").mode == "fsdp"
    tcfg = TrainConfig(policy="orq-9", hierarchy="two_level_async",
                       local_steps=4)
    assert (tcfg.outer_optimizer, tcfg.outer_lr, tcfg.outer_momentum) == \
        (jstep.TrainConfig(policy="orq-9", mode="replicated",
                           hierarchy="two_level_async", local_steps=4)
         .outer_optimizer, 0.7, 0.9)
    for kw, match in (
            (dict(hierarchy="two_level_async", local_steps=4, mode="fsdp"),
             "replicated"),
            (dict(hierarchy="two_level_async", local_steps=4,
                  fused_exchange=False), "fused_exchange"),
            (dict(hierarchy="two_level", local_steps=4), "two_level_async"),
            (dict(local_steps=0), "local_steps"),
            (dict(hierarchy="two_level_async", local_steps=4,
                  outer_optimizer="adamw"), "outer_optimizer")):
        with pytest.raises(ValueError, match=match):
            jstep.TrainConfig(policy="orq-9", **{"mode": "replicated", **kw})
        with pytest.raises(ValueError, match=match):
            TrainConfig(policy="orq-9", **kw)
    with pytest.raises(ValueError, match="mode"):
        TrainConfig(mode="zero2")
    with pytest.raises(TypeError):
        TrainConfig(compute_dtype="bf16")
    from repro_torch.train.step import plan_sharding_shapes
    model = LM(get_smoke_config("lm-100m"))
    sizes = {"data": 1, "model": 2}
    jm = JLM(jget_smoke_config("lm-100m"))
    want = jstep.plan_sharding_shapes(
        jm, jax.eval_shape(jm.init, jax.random.key(0)), dp_axes=("data",),
        axis_sizes=sizes).tp_dims
    assert plan_sharding_shapes(model, model.abstract_params(),
                                dp_axes=("data",),
                                axis_sizes=sizes).tp_dims == want
    # the pipelined schedule is ported; a K below 1 is refused, as the
    # reference's engine refuses it
    with pytest.raises(ValueError, match="pipeline_chunks"):
        exchange_engine(model, TrainConfig(policy="orq-9",
                                           pipeline_chunks=0))
    # every level solver is ported: each scheme's exchange builds
    for name, method in (("terngrad", "terngrad"), ("bingrad-b", "bingrad_b"),
                         ("signsgd", "signsgd")):
        pex = exchange_engine(model, TrainConfig(policy=name))
        assert [e.qz.method for e in pex.engines] == [method]
    # a scheme with no fused encode takes the multi-pass path, whose fit
    # refuses a method it does not know, as the reference's does
    from repro_torch.core.comm.exchange import GradientExchange
    from repro_torch.core.quantizers import Quantizer
    with pytest.raises(ValueError, match="unknown method"):
        GradientExchange(Quantizer(method="custom")).exchange_flat(
            torch.zeros(8), prng.key(0))


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        env=env, capture_output=True, text=True, timeout=300)


def test_cli_runs_on_cpu(tmp_path):
    out = tmp_path / "m.json"
    r = _cli("--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
             "--seq", "16", "--quant", "orq-9", "--bucket", "512",
             "--log-every", "1", "--metrics-out", str(out))
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert sum(ln.startswith("step ") for ln in lines) == 2
    assert any(ln.startswith("params sha256 ") for ln in lines)
    import json
    m = json.loads(out.read_text())
    assert len(m["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in m["history"])
    assert m["wire_bytes_per_worker"] > 0 and m["world_size"] == 1


# the reference launcher's exits with code 2, by what the message names
# (--model-parallel 3 on a world of one: the host mesh's factor check)
CLI_REFUSALS = {
    ("--bit-schedule", "default=orq@5..3", "--quant", "orq-9"):
        "mutually exclusive",
    ("--hierarchy", "two_level_async", "--local-steps", "4"):
        "needs an inter-pod dp axis",
    ("--local-steps", "4"): "set hierarchy='two_level_async'",
    ("--model-parallel", "3"): "does not divide the device count 1",
    ("--bit-schedule", "default=orq@5..3", "--bit-budget", "1e5",
     "--per-leaf-exchange"): "--bit-budget needs the fused exchange",
}


@pytest.mark.parametrize("flags", [list(f) for f in CLI_REFUSALS])
def test_cli_refuses_unported_flags(flags, capsys):
    """Refused while parsing, before any process group or model exists:
    the reference launcher's refusals of the bit schedule and async flags
    (``--pods 1`` has no pod axis), and the host mesh's factor check.
    (Every ``--quant`` scheme trains; see ``test_torch_train_schemes.py``;
    ``--pipeline-chunks`` and ``--per-leaf-exchange`` run:
    ``test_torch_train_local.py``; ``--bit-schedule`` and the async
    hierarchy run in ``test_torch_bit_schedule_train.py`` and
    ``test_torch_async_checkpoint.py``.)"""
    from repro_torch.launch import train as launcher
    with pytest.raises(SystemExit) as e:
        launcher.train(["--smoke", "--device", "cpu", *flags])
    assert e.value.code == 2
    assert CLI_REFUSALS[tuple(flags)] in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--mode", "fsdp"],
                                   ["--hierarchy", "two_level"],
                                   ["--resume", "CKPT"],
                                   ["--pods", "2"]])
def test_cli_runs_ported_flags(flags, tmp_path):
    """The flags that were refused before fsdp, the two-level hierarchy
    and checkpoints were ported: each runs two smoke steps on the CPU
    (``--pods 2`` on two gloo workers, ``--resume`` from a one-step state
    checkpoint)."""
    n = 2 if "--pods" in flags else 1
    common = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
              "--quant", "orq-9", "--bucket", "512", "--log-every", "1"]
    if "--resume" in flags:
        ck = str(tmp_path / "state")
        rcs, out = _world(tmp_path / "first", 1, "repro_torch.launch.train",
                          *common, "--steps", "1", "--state-checkpoint", ck)
        assert rcs == [0], out
        flags = ["--resume", ck]
    rcs, out = _world(tmp_path, n, "repro_torch.launch.train", *common,
                      "--steps", "2", *flags)
    assert rcs == [0] * n, out
    assert any(ln.startswith("params sha256 ") for ln in out.splitlines())
    assert f"replicas in sync: True ({n} workers)" in out


_WORKER = """
import importlib, sys
import torch.distributed as dist
rank, n, rdv, module = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=n)
try:
    rc = importlib.import_module(module).main(sys.argv[5:])
finally:
    dist.destroy_process_group()
sys.exit(rc)
"""


def _world(tmp_path, n, module, *args):
    """``module.main(args)`` on ``n`` gloo processes joined through their
    own ``file://`` rendezvous; returns (exit codes, rank 0's output)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    tmp_path.mkdir(parents=True, exist_ok=True)
    rdv = str(tmp_path / "rendezvous")
    logs = [tmp_path / f"rank{r}.log" for r in range(n)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(r), str(n), rdv, module,
                 *args], env=env, stdout=f, stderr=subprocess.STDOUT))
    rcs = [p.wait(timeout=300) for p in procs]
    return rcs, "".join(log.read_text() for log in logs)


def test_torchrun_world_keeps_replicas_in_sync(tmp_path):
    """Two gloo workers, each on its rows of the global batch: the
    phase-2 decode is deterministic, so the params stay bit-identical."""
    rcs, out = _world(tmp_path, 2, "repro_torch.launch.train", "--smoke",
                      "--device", "cpu", "--steps", "2", "--batch", "4",
                      "--seq", "16", "--quant", "orq-9", "--bucket", "512",
                      "--error-feedback")
    assert rcs == [0, 0], out
    assert "replicas in sync: True (2 workers)" in out


def test_exchange_check_script_on_cpu(tmp_path):
    import json
    rcs, out = _world(tmp_path, 2, "repro_torch.launch.exchange_check",
                      "--device", "cpu")
    assert rcs == [0, 0], out
    line = json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])
    assert line["world_size"] == 2 and line["mismatched"] == 0
    assert line["workers_disagree"] == 0
