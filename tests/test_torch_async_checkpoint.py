"""Checkpoints of the port's temporal hierarchy (``two_level_async``)
against the JAX reference's file format, and ``--resume`` mid-window.

In async mode each worker holds its own params and optimizer state; a
state checkpoint stacks them over the ranks on a leading worker axis (the
reference's stacked layout), stacks the tuple EF buffers over the ranks,
and keeps the outer anchor and momentum as they are.

* ``--resume`` mid-window: 4 gloo workers in 2 pods, H = 4, error
  feedback; the state written after step 6 (position 2 of the second
  window) resumes to the uninterrupted 8-step run's params sha256 (the
  digest of the stacked params, as the reference's).
* A reference async state (its ``init_state`` on a ``("pod", "data")``
  (2, 2) mesh of 4 fake devices, every float leaf then drawn from a numpy
  seed) loads into the port's global form strictly, each worker's slice
  is its row, and gathered again it is the same tree bit for bit; the
  port writes it back and the reference loads that file against its own
  tree, equal to what it wrote. The launcher's own mid-window checkpoint
  loads against the reference's tree too.
* ``launch/async_check.py``, the four-card check, on 4 gloo workers.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint import load_checkpoint as jload
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core import comm as jcomm
from repro.core.policy import QuantPolicy as JPolicy
from repro.models.model import LM as JLM
from repro.train import step as jstep
from repro.train.state import OuterState as JOuter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY = "norm|bias=fp,default=orq-9"

# the reference's async state on its (2, 2) mesh, randomized, written out
JAX_PROG = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint import save_checkpoint
from repro.configs.base import get_smoke_config
from repro.core.policy import QuantPolicy
from repro.models.model import LM
from repro.train import step as jstep

model = LM(get_smoke_config("lm-100m"))
mesh = jax.make_mesh((2, 2), ("pod", "data"))
tcfg = jstep.TrainConfig(policy=QuantPolicy.parse({policy!r}, bucket_size=512),
                         mode="replicated", hierarchy="two_level_async",
                         local_steps=4, error_feedback=True)
state = jstep.init_state(model, mesh, tcfg, jax.random.key(0))
rng = np.random.default_rng(7)
state = jax.tree_util.tree_map(
    lambda x: (rng.standard_normal(x.shape).astype(x.dtype)
               if jnp.issubdtype(x.dtype, jnp.floating)
               else np.asarray(6, x.dtype)), state)
save_checkpoint(sys.argv[1], state, step=6)
"""

# the port's 4 workers: load the reference's file, slice, gather, write
PORT_PROG = """
import json, sys
import torch, torch.distributed as dist
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import get_smoke_config
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import LM
from repro_torch.train import TrainConfig, init_state, make_train_step
from repro_torch.train.step import StateSharding
from repro_torch.utils.pytree import tree_leaves

rank, ref, out, rdv = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=4)
model = LM(get_smoke_config("lm-100m"))
tcfg = TrainConfig(policy=QuantPolicy.parse({policy!r}, bucket_size=512),
                   hierarchy="two_level_async", local_steps=4,
                   error_feedback=True)
fn = make_train_step(model, tcfg, pods=2)
sh = StateSharding(fn)
full, step = load_checkpoint(ref, sh.gather(init_state(model, tcfg,
                                                       device="cpu",
                                                       step=fn)))
mine = sh.scatter(full)
again = sh.gather(mine)
rows = all(torch.equal(a, b[rank]) for a, b in zip(
    tree_leaves((mine.params, mine.opt)),
    tree_leaves((full.params, full.opt))))
ef_rows = all(torch.equal(a, b.reshape(4, -1)[rank])
              for a, b in zip(tree_leaves(mine.ef), tree_leaves(full.ef)))
def body(st):
    return tree_leaves((st.params, st.opt, st.ef, st.outer))
same = again.step == full.step and all(
    torch.equal(a, b) for a, b in zip(body(again), body(full), strict=True))
if rank == 0:
    save_checkpoint(out, again, step=again.step)
print("PORT " + json.dumps({{"rank": rank, "step": step,
                             "state_step": mine.step, "rows": rows,
                             "ef_rows": ef_rows, "same": same,
                             "n_ef": len(mine.ef),
                             "outer": mine.outer is not None}}), flush=True)
dist.barrier()
dist.destroy_process_group()
"""

_WORKER = """
import importlib, sys
import torch.distributed as dist
rank, n, rdv, module = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:5]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=n)
try:
    rc = importlib.import_module(module).main(sys.argv[5:])
finally:
    dist.destroy_process_group()
sys.exit(rc)
"""

ASYNC_FLAGS = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "16",
               "--quant", POLICY, "--bucket", "512", "--error-feedback",
               "--log-every", "1", "--pods", "2", "--hierarchy",
               "two_level_async", "--local-steps", "4", "--steps", "8"]


def _env(extra=None):
    return {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
            "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1", **(extra or {})}


def _launch(tmp, name, *flags, module="repro_torch.launch.train"):
    (tmp / name).mkdir()
    args = ASYNC_FLAGS if module.endswith(".train") else []
    return [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), "4", str(tmp / name / "rdv"),
         module, *args, *flags], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]


def _port(tmp, ref, out):
    (tmp / "port").mkdir()
    src = PORT_PROG.format(policy=POLICY)
    return [subprocess.Popen(
        [sys.executable, "-c", src, str(r), ref, out,
         str(tmp / "port" / "rdv")], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]


def _wait(procs):
    outs = [p.communicate(timeout=600)[0] for p in procs]
    return [p.returncode for p in procs], outs


def _sha(out):
    return [ln for ln in out.splitlines() if ln.startswith("params sha256")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted run (writing its state after step 6) and the
    reference's state concurrently, then the resume and the port's
    cross-load concurrently."""
    tmp = tmp_path_factory.mktemp("async_ckpt")
    ck, ref, port = (str(tmp / "mid.state"), str(tmp / "ref.npz"),
                     str(tmp / "port.npz"))
    first = _launch(tmp, "whole", "--state-checkpoint", ck,
                    "--checkpoint-at", "6")
    check = _launch(tmp, "check", "--smoke", "--device", "cpu", "--bucket",
                    "512", "--batch", "4", "--seq", "16", "--steps", "4",
                    "--local-steps", "1,2",
                    module="repro_torch.launch.async_check")
    jax_run = subprocess.run(
        [sys.executable, "-c", JAX_PROG.format(policy=POLICY), ref],
        env=_env({"XLA_FLAGS": "--xla_force_host_platform_device_count=4"}),
        capture_output=True, text=True, timeout=600)
    assert jax_run.returncode == 0, jax_run.stdout + jax_run.stderr
    whole = _wait(first)
    then, cross = _launch(tmp, "resumed", "--resume", ck), _port(tmp, ref,
                                                                 port)
    return dict(ck=ck, ref=ref, port=port, whole=whole, resumed=_wait(then),
                cross=_wait(cross), check=_wait(check))


def test_mid_window_resume_bit_exact(runs):
    (rcs, outs), (rcs2, outs2) = runs["whole"], runs["resumed"]
    assert rcs == [0] * 4, outs
    assert rcs2 == [0] * 4, outs2
    whole, resumed = outs[0], outs2[0]
    assert f"checkpoint -> {runs['ck']} at step 6" in whole
    assert f"resumed {runs['ck']} at step 6" in resumed
    assert sum(ln.startswith("step ") for ln in resumed.splitlines()) == 2
    assert _sha(resumed) and _sha(resumed) == _sha(whole)
    # every worker ends on the same stacked tree
    assert "replicas in sync: True (4 workers)" in resumed


def test_reference_state_loads_in_port(runs):
    rcs, outs = runs["cross"]
    assert rcs == [0] * 4, outs
    rows = [json.loads(ln[len("PORT "):]) for out in outs
            for ln in out.splitlines() if ln.startswith("PORT ")]
    assert sorted(r["rank"] for r in rows) == [0, 1, 2, 3]
    for r in rows:
        assert r["step"] == r["state_step"] == 6
        assert r["rows"] and r["ef_rows"] and r["same"] and r["outer"], r
        assert r["n_ef"] == 2


def _reference_like():
    """The reference's global async tree on 2 pods x 2 workers, as its
    ``init_state`` lays it out (the stacked worker axis; per-worker EF
    shards of the two-level outer exchange stacked over the 4 workers)."""
    jm = JLM(jget_smoke_config("lm-100m"))
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    stk = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct((4,) + s.shape, s.dtype), shapes)
    pex = jcomm.PartitionedExchange.build(
        JPolicy.parse(POLICY, bucket_size=512), shapes, ("pod",),
        paths=jm.param_paths(shapes), intra_axes=("data",))
    ef = tuple(None if n is None
               else jax.ShapeDtypeStruct((4 * n,), jnp.float32)
               for n in pex.ef_shard_sizes(2))
    return jstep.TrainState(params=stk, opt=stk,
                            step=jax.ShapeDtypeStruct((), jnp.int32), ef=ef,
                            outer=JOuter(anchor=shapes, mom=shapes))


def test_port_state_loads_in_reference(runs):
    assert runs["cross"][0] == [0] * 4
    like = _reference_like()
    want, step = jload(runs["ref"], like=like)
    back, step2 = jload(runs["port"], like=like)
    assert step == step2 == 6
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the launcher's own mid-window state loads against it as well
    mid, step = jload(runs["ck"], like=like)
    assert step == 6 and int(mid.step) == 6
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(mid)]
    assert all(np.isfinite(x).all() for x in leaves)
    params = np.asarray(jax.tree_util.tree_leaves(mid.params)[0])
    assert np.array_equal(params[0], params[1])       # pod 0 together
    assert not np.array_equal(params[0], params[2])   # pods apart


def test_async_check_script_on_cpu(runs):
    """``launch/async_check.py`` (the four-card check) on 4 gloo workers:
    H = 1 is two_level, H = 2 keeps the window's contract."""
    rcs, outs = runs["check"]
    assert rcs == [0] * 4, outs
    last = json.loads([ln for ln in outs[0].splitlines()
                       if ln.startswith("{")][-1])
    assert last == {"checks": {"async_h2_window": True,
                               "h1_equals_two_level": True}, "ok": True}
