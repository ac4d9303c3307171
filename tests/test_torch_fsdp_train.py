"""The port's fsdp (ZeRO-3) training step against the JAX reference.

* One smoke-config fsdp step from the same state (``convert.state_from_jax``;
  on one worker the shards are the full leaves), the port on a gloo world
  of one, the reference on ``jax.make_mesh((1,), ("data",))``: the loss is
  float-close (rtol 1e-3: bf16 matmuls round at other places in XLA and
  PyTorch); with fp the update is within 2e-2 in relative norm per leaf;
  with orq-9 and error feedback within 0.2 (the bf16 gradient differences
  flip some rounding decisions, each by a level gap), the EF buffers have
  the reference's shapes. The per-leaf fsdp step (``fused_exchange=False``)
  likewise.
* fp per-leaf fsdp is bit-equal to fp fused fsdp over 3 steps on 4 gloo
  workers (params sha256): the fp reduce-scatter is an all_to_all and a
  sum in rank order, so the two layouts add in the same order.
* The per-leaf fsdp accounting equals the reference's per-gather
  ``rs_stats`` / ``collective_launches``; error feedback is ignored there
  with a warning, as in the reference.
* ``StateSharding`` gathers fsdp shards and EF buffers in rank order and
  scatters them back (2 gloo workers).
* ``launch.exchange_check`` runs its fsdp and two-level modes on 4 gloo
  workers (both of its sides on the CPU).
"""
import json
import os
import subprocess
import sys
import tempfile
import warnings
import zlib

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core import comm as jcomm
from repro.core.policy import QuantPolicy as JPolicy
from repro.data import SyntheticLM as JSyntheticLM
from repro.models.model import LM as JLM
from repro.optim.schedule import constant_lr as jconstant_lr
from repro.train import step as jstep
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.convert import state_from_jax
from repro_torch.core import prng
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import LM
from repro_torch.optim.schedule import constant_lr
from repro_torch.train import TrainConfig, init_state, make_train_step
from repro_torch.train.step import per_leaf_fsdp_stats, step_layout
from repro_torch.utils.pytree import tree_leaves
from torch_test_env import port_test_env  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.05
CASES = {"fp": ("fp", False, True), "orq_ef": ("orq-9", True, True),
         "orq_per_leaf": ("orq-9", False, False)}


@pytest.fixture(scope="module")
def world1():
    """A gloo world of one process on its own ``file://`` rendezvous."""
    if not dist.is_initialized():
        tmp = tempfile.mkdtemp(prefix="repro_torch_test_world_")
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
    return dist.get_world_size()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's fsdp states before and after one step, per case."""
    jmodel = JLM(jget_smoke_config("lm-100m"))
    mesh = jax.make_mesh((1,), ("data",))
    batch = JSyntheticLM(512, 16, 2, 0).batch(0)
    out = {}
    for name, (policy, ef, fused) in CASES.items():
        tcfg = jstep.TrainConfig(
            policy=JPolicy.parse(policy, bucket_size=512), mode="fsdp",
            error_feedback=ef, fused_exchange=fused)
        state = jstep.init_state(jmodel, mesh, tcfg, jax.random.key(0))
        before = _np(state)
        fn, _ = jstep.make_train_step(jmodel, mesh, tcfg,
                                      lr_fn=jconstant_lr(LR))
        after, metrics = fn(state, batch, jax.random.key(0))
        out[name] = (before, _np(after), float(metrics["loss"]))
    return np.array(batch["tokens"]), out


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fsdp_step_close_to_reference(world1, ref_runs, case):
    tokens, out = ref_runs
    before, after, jloss = out[case]
    policy, ef, fused = CASES[case]
    model = LM(get_smoke_config("lm-100m"))
    tcfg = TrainConfig(policy=QuantPolicy.parse(policy, bucket_size=512),
                       mode="fsdp", error_feedback=ef, fused_exchange=fused)
    fn = make_train_step(model, tcfg, constant_lr(LR))
    state = state_from_jax(before, device="cpu")
    new, metrics = fn(state, {"tokens": torch.from_numpy(tokens)},
                      prng.key(0))
    np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=1e-3)
    assert new.step == int(after.step) == 1
    bound = 2e-2 if policy == "fp" else 0.2
    for p, p0, w in zip(tree_leaves(new.params),
                        jax.tree_util.tree_leaves(before.params),
                        jax.tree_util.tree_leaves(after.params), strict=True):
        assert p.shape == w.shape
        assert _rel(p.numpy() - p0, w - p0) < bound
    if ef:
        assert [e.shape for e in new.ef] == [w.shape for w in after.ef]
        assert all(np.isfinite(e.numpy()).all() for e in new.ef)
    else:
        assert new.ef is None and after.ef is None


def test_fsdp_init_state_matches_reference_layout(world1):
    """One worker: every stored shard is the full leaf; the EF tuple has
    the reference's per-group sizes (and is None for an fp policy)."""
    jmodel = JLM(jget_smoke_config("lm-100m"))
    mesh = jax.make_mesh((1,), ("data",))
    model = LM(get_smoke_config("lm-100m"))
    for spec in ("orq-9", "norm|bias=fp,default=orq-9", "fp"):
        tcfg = TrainConfig(policy=QuantPolicy.parse(spec), mode="fsdp",
                           error_feedback=True)
        st = init_state(model, tcfg, device="cpu",
                        step=make_train_step(model, tcfg))
        js = jax.eval_shape(lambda: jstep.init_state(
            jmodel, mesh, jstep.TrainConfig(policy=JPolicy.parse(spec),
                                            mode="fsdp", error_feedback=True),
            jax.random.key(0)))
        assert [tuple(t.shape) for t in tree_leaves(st.params)] == \
            [x.shape for x in jax.tree_util.tree_leaves(js.params)]
        if js.ef is None:
            assert st.ef is None
        else:
            assert [None if e is None else tuple(e.shape) for e in st.ef] \
                == [None if e is None else e.shape for e in js.ef]


@pytest.mark.parametrize("arch,n", [("lm-100m", 1), ("lm-100m", 4),
                                    ("smoke", 4)])
@pytest.mark.parametrize("spec", ["orq-9", "bingrad-b", "fp",
                                  "norm|bias=fp,default=orq-9"])
def test_per_leaf_fsdp_accounting_matches_reference(arch, n, spec):
    """Each gather call pays its slice's reduce-scatter (a stacked leaf
    once per repeat), priced by the reference's own formulas on its plan."""
    smoke = arch == "smoke"
    jmodel = JLM((jget_smoke_config if smoke else jget_config)("lm-100m"))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0))
    plan = jstep.plan_sharding_shapes(jmodel, shapes, dp_axes=("data",),
                                      axis_sizes={"data": n, "model": 1})
    jpol = JPolicy.parse(spec)
    launches, total = 0, 0.0
    for path, leaf in zip(jax.tree_util.tree_leaves(plan.paths),
                          jax.tree_util.tree_leaves(shapes)):
        reps = leaf.shape[0] if path.startswith("g") else 1
        size = int(np.prod(leaf.shape)) // reps
        cfg = jpol.resolve(path)
        qz = cfg.to_quantizer()
        if plan.gather_dims[path] is not None:
            c, b = jcomm.GradientExchange.rs_stats(qz, size, n)
        else:
            eng = jcomm.GradientExchange(qz, ("data",),
                                         server_requant=cfg.server_requant)
            c, b = eng.collective_launches(size), \
                eng.wire_bytes_per_worker(size, n)
        launches += reps * c
        total += reps * b
    model = LM((get_smoke_config if smoke else get_config)("lm-100m"))
    tcfg = TrainConfig(policy=QuantPolicy.parse(spec), mode="fsdp",
                       fused_exchange=False)
    got = per_leaf_fsdp_stats(model, tcfg, step_layout(model, tcfg, n))
    assert got == (launches, total)


def test_per_leaf_fsdp_ignores_error_feedback(world1):
    model = LM(get_smoke_config("lm-100m"))
    tcfg = TrainConfig(policy="orq-9", mode="fsdp", fused_exchange=False,
                       error_feedback=True)
    with pytest.warns(UserWarning, match="ignoring error_feedback"):
        fn = make_train_step(model, tcfg)
    assert init_state(model, tcfg, device="cpu", step=fn).ef is None
    with pytest.raises(ValueError, match="step=make_train_step"):
        init_state(model, tcfg, device="cpu")
    with pytest.raises(ValueError, match="data_parallel"):
        make_train_step(model, TrainConfig(mode="fsdp"),
                        data_parallel=False)


def test_per_leaf_key_schedule(world1, monkeypatch):
    """The per-leaf fsdp gather keys fold the crc32 of the path, then the
    repeat index (``step.py:638-667`` of the reference)."""
    from repro_torch.core.comm import fsdp_exchange
    seen = {}
    real = fsdp_exchange.reduce_scatter_mean_block

    def spy(g, qz, key, group=None, **kw):
        seen.setdefault(tuple(g.shape), []).append(key.clone())
        return real(g, qz, key, group, **kw)

    monkeypatch.setattr(fsdp_exchange, "reduce_scatter_mean_block", spy)
    from repro_torch.core.comm import gather as gather_mod
    monkeypatch.setattr(gather_mod, "reduce_scatter_mean_block", spy)
    model = LM(get_smoke_config("lm-100m"))
    tcfg = TrainConfig(policy="orq-9", mode="fsdp", fused_exchange=False)
    fn = make_train_step(model, tcfg)
    state = init_state(model, tcfg, device="cpu", step=fn)
    tokens = torch.zeros((2, 9), dtype=torch.int64)
    fn(state, {"tokens": tokens}, prng.key(3))
    step_key = prng.fold_in(prng.key(3), 0)
    path = "embed"
    want = prng.fold_in(prng.fold_in(prng.fold_in(
        step_key, zlib.crc32(path.encode()) & 0x7FFFFFFF), 0), 0)
    shape = tuple(state.params["embed"].shape)
    assert any(torch.equal(k, want) for k in seen[shape])


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


def _start(tmp_path, n, module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    tmp_path.mkdir(parents=True, exist_ok=True)
    return [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(n),
         str(tmp_path / "rdv"), module, *args], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]


def _finish(procs):
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * len(procs), outs
    return outs[0]


def test_fp_per_leaf_fsdp_bit_equal_to_fused(tmp_path):
    """3 fp steps on 4 workers: the per-leaf and the fused fsdp exchange
    give the same parameters bit for bit."""
    common = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
              "--seq", "16", "--quant", "fp", "--mode", "fsdp"]
    runs = {name: _start(tmp_path / name, 4, "repro_torch.launch.train",
                         *common, "--metrics-out",
                         str(tmp_path / f"{name}.json"), *extra)
            for name, extra in (("fused", []),
                                ("per_leaf", ["--per-leaf-exchange"]))}
    for procs in runs.values():
        _finish(procs)
    m = {k: json.loads((tmp_path / f"{k}.json").read_text()) for k in runs}
    assert m["fused"]["params_sha256"] == m["per_leaf"]["params_sha256"]
    assert m["fused"]["collective_launches_per_step"] == 1
    assert m["per_leaf"]["collective_launches_per_step"] > 1
    assert m["fused"]["replicas_in_sync"] and m["fused"]["world_size"] == 4


STATE_PROG = """
import sys, torch, torch.distributed as dist
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import LM
from repro_torch.train import TrainConfig, init_state, make_train_step
from repro_torch.train.step import StateSharding
from repro_torch.utils.pytree import tree_leaves

rank, rdv = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=2)
model = LM(get_smoke_config("lm-100m"))
tcfg = TrainConfig(policy="orq-9", mode="fsdp", error_feedback=True)
fn = make_train_step(model, tcfg)
st = init_state(model, tcfg, device="cpu", step=fn)
st = st._replace(ef=tuple(e + rank + 1 for e in st.ef))
sh = StateSharding(fn)
full = sh.gather(st)
ref = model.init(torch.Generator().manual_seed(0), device="cpu")
ok = all(torch.equal(a, b) for a, b in zip(tree_leaves(full.params),
                                           tree_leaves(ref)))
n = st.ef[0].numel()
ok &= full.ef[0].shape == (2 * n,)
ok &= bool((full.ef[0][:n] == 1).all() and (full.ef[0][n:] == 2).all())
back = sh.scatter(full)
ok &= back.step == st.step
ok &= all(torch.equal(a, b) for a, b in zip(
    tree_leaves((back.params, back.opt, back.ef)),
    tree_leaves((st.params, st.opt, st.ef))))
print("STATE_OK" if ok else "STATE_BAD", flush=True)
dist.destroy_process_group()
"""


def test_state_sharding_round_trip(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", STATE_PROG, str(r),
                               str(tmp_path / "rdv")], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert all("STATE_OK" in o for o in outs), outs


CHECK_MODES = [("fsdp", "1"), ("replicated", "2"), ("fsdp", "2")]


@pytest.fixture(scope="module")
def exchange_checks(tmp_path_factory):
    """``launch.exchange_check --device cpu`` on 4 gloo workers in each
    new mode, concurrently."""
    tmp = tmp_path_factory.mktemp("exchange_check")
    procs = {m: _start(tmp / f"{m[0]}{m[1]}", 4,
                       "repro_torch.launch.exchange_check", "--device",
                       "cpu", "--mode", m[0], "--pods", m[1])
             for m in CHECK_MODES}
    return {m: _finish(p) for m, p in procs.items()}


@pytest.mark.parametrize("mode,pods", CHECK_MODES)
def test_exchange_check_modes_on_cpu(exchange_checks, mode, pods):
    line = json.loads([ln for ln in exchange_checks[(mode, pods)]
                       .splitlines() if ln.startswith("{")][-1])
    assert (line["mode"], line["pods"], line["world_size"]) == \
        (mode, int(pods), 4)
    assert line["mismatched"] == 0 and line["workers_disagree"] == 0
    assert line["wire_bytes_per_worker"] > 0


def test_no_warning_on_fused_fsdp(world1):
    model = LM(get_smoke_config("lm-100m"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_train_step(model, TrainConfig(policy="orq-9", mode="fsdp",
                                           error_feedback=True))
