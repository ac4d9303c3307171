"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's file format, and ``--resume``.

* The reference's ``tests/test_checkpoint.py`` cases, on the port's
  save/load: atomic saves (a crash mid-write keeps the previous file; a
  crash between the npz and the external manifest still loads
  consistently), the external-manifest fallback, strict restore (shape,
  dtype, missing and extra keys raise ``ValueError`` naming the key, also
  under ``python -O``), and an exact round trip.
* Cross-loading: params and whole training states written by the port
  load with ``repro.checkpoint.load_checkpoint`` against the reference's
  own trees (replicated with params-shaped EF, fsdp with the tuple EF of
  the reference's global layout, AdamW's NamedTuple state), and the
  reference's files load into the port's trees, bit for bit.
* ``--resume`` from a ``--checkpoint-at 2`` state checkpoint reproduces
  the uninterrupted 4-step run's params sha256, replicated and fsdp, with
  error feedback, on 1 and 2 gloo workers.
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

from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core.policy import QuantPolicy as JPolicy
from repro.models.model import LM as JLM
from repro.train import step as jstep
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.models import LM
from repro_torch.optim import optimizers as opt_lib
from repro_torch.train.state import TrainState
from repro_torch.utils.pytree import tree_leaves
from torch_test_env import port_test_env  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "b": (torch.ones(4, dtype=torch.int32),
                  {"c": torch.zeros(())})}


def _like(tree):
    return {"a": torch.zeros(2, 3),
            "b": (torch.zeros(4, dtype=torch.int32), {"c": torch.zeros(())})}


# ---------------------------------------------------------------------------
# the reference's cases on the port
# ---------------------------------------------------------------------------

def test_crash_mid_npz_write_keeps_previous(tmp_path, monkeypatch):
    path = str(tmp_path / "ck.npz")
    tree1 = _tree()
    save_checkpoint(path, tree1, step=1)

    def dying_savez(f, **kw):
        f.write(b"PK\x03\x04 truncated garbage")
        raise RuntimeError("simulated crash mid-write")

    real = np.savez_compressed
    monkeypatch.setattr(np, "savez_compressed", dying_savez)
    tree2 = {"a": tree1["a"] + 100, "b": (tree1["b"][0] + 100,
                                          {"c": tree1["b"][1]["c"] + 100})}
    with pytest.raises(RuntimeError, match="simulated crash"):
        save_checkpoint(path, tree2, step=2)
    monkeypatch.setattr(np, "savez_compressed", real)
    back, step = load_checkpoint(path, _like(tree1))
    assert step == 1
    for want, got in zip(tree_leaves(tree1), tree_leaves(back)):
        assert torch.equal(want, got)
    leftovers = [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert leftovers == ["ck.npz.tmp"], leftovers
    save_checkpoint(path, tree2, step=2)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert load_checkpoint(path, _like(tree1))[1] == 2


def test_crash_between_npz_and_manifest_still_consistent(tmp_path,
                                                         monkeypatch):
    path = str(tmp_path / "ck.npz")
    tree1 = _tree()
    save_checkpoint(path, tree1, step=1)
    real_replace = os.replace

    def replace_npz_only(src, dst):
        if dst.endswith(".manifest.json"):
            raise RuntimeError("simulated crash before manifest commit")
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", replace_npz_only)
    tree2 = dict(tree1, a=tree1["a"] + 100)
    with pytest.raises(RuntimeError, match="simulated crash"):
        save_checkpoint(path, tree2, step=2)
    monkeypatch.setattr(os, "replace", real_replace)
    back, step = load_checkpoint(path, _like(tree1))
    assert step == 2
    assert torch.equal(back["a"], tree1["a"] + 100)


def test_external_manifest_fallback(tmp_path):
    path = str(tmp_path / "old.npz")
    flat = {"['a']": np.arange(6.0, dtype=np.float32).reshape(2, 3),
            "['b'][0]": np.ones(4, np.int32),
            "['b'][1]['c']": np.zeros((), np.float32)}
    order = sorted(flat)
    np.savez_compressed(path, **{f"arr_{i}": flat[k]
                                 for i, k in enumerate(order)})
    with open(path + ".manifest.json", "w") as f:
        json.dump({"keys": order, "step": 5}, f)
    back, step = load_checkpoint(path, _like(_tree()))
    assert step == 5
    assert torch.equal(back["a"], _tree()["a"])


def test_shape_mismatch_raises_valueerror(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, _tree(), step=0)
    bad = _tree()
    bad["a"] = torch.zeros(3, 2)
    with pytest.raises(ValueError, match=r"'a'.*\(2, 3\).*\(3, 2\)"):
        load_checkpoint(path, bad)


def test_shape_check_survives_python_O(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, {"a": torch.zeros(4)}, step=0)
    prog = ("import torch\n"
            "from repro_torch.checkpoint import load_checkpoint\n"
            "try:\n"
            f"    load_checkpoint({path!r}, {{'a': torch.zeros(5)}})\n"
            "except ValueError:\n"
            "    print('RAISED')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-O", "-c", prog], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "RAISED" in out.stdout


def test_dtype_mismatch_raises_not_casts(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, {"w": torch.ones(8)}, step=0)
    with pytest.raises(ValueError, match="float32.*float64"):
        load_checkpoint(path, {"w": torch.zeros(8, dtype=torch.float64)})
    with pytest.raises(ValueError, match="dtype"):
        load_checkpoint(path, {"w": torch.zeros(8, dtype=torch.int32)})


def test_missing_and_extra_keys_raise_with_names(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, {"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="missing keys.*'c'"):
        load_checkpoint(path, {"a": torch.zeros(3), "b": torch.zeros(2),
                               "c": torch.zeros(1)})
    with pytest.raises(ValueError, match="extra keys.*'b'"):
        load_checkpoint(path, {"a": torch.zeros(3)})


def test_exact_roundtrip_still_works(tmp_path):
    path = str(tmp_path / "ck.npz")
    tree = _tree()
    save_checkpoint(path, tree, step=3)
    back, step = load_checkpoint(path, _like(tree))
    assert step == 3
    for want, got in zip(tree_leaves(tree), tree_leaves(back)):
        assert got.dtype == want.dtype and torch.equal(want, got)


# ---------------------------------------------------------------------------
# cross-loading with the reference
# ---------------------------------------------------------------------------

def _ref_state(mode, ef, optimizer="sgd"):
    jmodel = JLM(jget_smoke_config("lm-100m"))
    tcfg = jstep.TrainConfig(policy=JPolicy.parse("orq-9", bucket_size=512),
                             mode=mode, error_feedback=ef,
                             optimizer=optimizer)
    return jstep.init_state(jmodel, jax.make_mesh((1,), ("data",)), tcfg,
                            jax.random.key(0))


def _randomized(state, seed):
    """The state with every float leaf drawn from a numpy seed and step 7
    (so a round trip cannot pass on zeros)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (jnp.asarray(rng.standard_normal(x.shape).astype(x.dtype))
                   if jnp.issubdtype(x.dtype, jnp.floating)
                   else jnp.asarray(7, x.dtype)), state)


def _port_state(jstate):
    st = jax.tree_util.tree_map(np.asarray, jstate)
    if isinstance(st.opt, tuple) and hasattr(st.opt, "mu"):
        opt = opt_lib.AdamState(mu=params_from_jax(st.opt.mu, "cpu"),
                                nu=params_from_jax(st.opt.nu, "cpu"),
                                count=int(st.opt.count))
        return TrainState(params=params_from_jax(st.params, "cpu"), opt=opt,
                          step=int(st.step),
                          ef=(None if st.ef is None
                              else params_from_jax(st.ef, "cpu")))
    return state_from_jax(st, device="cpu")


STATES = [("replicated", True, "sgd"), ("fsdp", True, "sgd"),
          ("replicated", False, "adamw")]


@pytest.mark.parametrize("mode,ef,optimizer", STATES)
def test_port_state_loads_in_reference(tmp_path, mode, ef, optimizer):
    jstate = _randomized(_ref_state(mode, ef, optimizer), 1)
    path = str(tmp_path / "state.npz")
    save_checkpoint(path, _port_state(jstate), step=7)
    back, step = jload(path, like=_ref_state(mode, ef, optimizer))
    assert step == 7
    for want, got in zip(jax.tree_util.tree_leaves(jstate),
                         jax.tree_util.tree_leaves(back), strict=True):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("mode,ef,optimizer", STATES)
def test_reference_state_loads_in_port(tmp_path, mode, ef, optimizer):
    jstate = _randomized(_ref_state(mode, ef, optimizer), 2)
    path = str(tmp_path / "state.npz")
    jsave(path, jstate, step=7)
    like = _port_state(_ref_state(mode, ef, optimizer))
    back, step = load_checkpoint(path, like)
    assert step == 7 and back.step == 7
    want = _port_state(jstate)
    assert type(back.opt) is type(want.opt)
    for a, b in zip(tree_leaves((back.params, back.opt, back.ef)),
                    tree_leaves((want.params, want.opt, want.ef)),
                    strict=True):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


def test_params_checkpoint_cross_loads(tmp_path):
    jmodel = JLM(jget_smoke_config("lm-100m"))
    jparams = jmodel.init(jax.random.key(3))
    model = LM(get_smoke_config("lm-100m"))
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    save_checkpoint(str(tmp_path / "port.npz"), params, step=4)
    back, step = jload(str(tmp_path / "port.npz"), like=jparams)
    assert step == 4
    for a, b in zip(jax.tree_util.tree_leaves(back), tree_leaves(params),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jsave(str(tmp_path / "ref.npz"), jparams, step=5)
    back, step = load_checkpoint(str(tmp_path / "ref.npz"), params)
    assert step == 5
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(jparams),
                    strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fsdp_two_worker_state_matches_reference_layout(tmp_path):
    """A 2-worker fsdp state checkpoint (rank 0 writes the global arrays:
    full params and momentum, EF buffers stacked over the ranks) loads
    against the reference's global tree for 2 workers."""
    rcs, out = _world(tmp_path, 2, "--mode", "fsdp", "--steps", "1",
                      "--state-checkpoint", str(tmp_path / "ck"))
    assert rcs == [0, 0], out
    jmodel = JLM(jget_smoke_config("lm-100m"))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0))
    plan = jstep.plan_sharding_shapes(jmodel, shapes, dp_axes=("data",),
                                      axis_sizes={"data": 2, "model": 1})
    from repro.core import comm as jcomm
    fex = jcomm.FsdpExchange.build(
        JPolicy.parse("orq-9", bucket_size=512), shapes, ("data",),
        paths=plan.paths, shard_dims=plan.full_shard_dims(), n_shards=2)
    like = jstep.TrainState(
        params=shapes, opt=shapes,
        step=jax.ShapeDtypeStruct((), jnp.int32),
        ef=tuple(jax.ShapeDtypeStruct((2 * n,), jnp.float32)
                 for n in fex.ef_group_sizes()))
    back, step = jload(str(tmp_path / "ck"), like=like)
    assert step == 1 and int(back.step) == 1
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree_util.tree_leaves(back))


def test_launcher_params_checkpoint_is_the_digested_params(tmp_path):
    """``--checkpoint`` on 2 fsdp workers writes the full params in rank
    order: they load against the reference's params tree, and their bytes
    hash to the printed params sha256."""
    import hashlib
    path = str(tmp_path / "params")
    rcs, out = _world(tmp_path / "w", 2, "--mode", "fsdp", "--steps", "1",
                      "--checkpoint", path)
    assert rcs == [0, 0], out
    shapes = jax.eval_shape(JLM(jget_smoke_config("lm-100m")).init,
                            jax.random.key(0))
    back, step = jload(path, like=shapes)
    assert step == 1
    h = hashlib.sha256()
    for leaf in jax.tree_util.tree_leaves(back):
        h.update(np.asarray(leaf).tobytes())
    assert f"params sha256 {h.hexdigest()}" in out


# ---------------------------------------------------------------------------
# --resume
# ---------------------------------------------------------------------------

_WORKER = """
import importlib, sys
import torch.distributed as dist
rank, n, rdv = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=n)
try:
    rc = importlib.import_module("repro_torch.launch.train").main(sys.argv[4:])
finally:
    dist.destroy_process_group()
sys.exit(rc)
"""


def _start(tmp_path, n, *flags):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    tmp_path.mkdir(parents=True, exist_ok=True)
    return [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(n),
         str(tmp_path / "rdv"), "--smoke", "--device", "cpu", "--batch",
         "4", "--seq", "16", "--quant", "orq-9", "--bucket", "512",
         "--error-feedback", "--log-every", "1", *flags], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]


def _wait(procs):
    outs = [p.communicate(timeout=300)[0] for p in procs]
    return [p.returncode for p in procs], outs[0] + "".join(outs[1:])


def _world(tmp_path, n, *flags):
    return _wait(_start(tmp_path, n, *flags))


def _sha(out):
    return [ln for ln in out.splitlines() if ln.startswith("params sha256")]


RESUME = [(mode, n) for mode in ("replicated", "fsdp") for n in (1, 2)]


@pytest.fixture(scope="module")
def resume_runs(tmp_path_factory):
    """Every configuration's uninterrupted run (writing its state after
    step 2) concurrently, then every resume concurrently."""
    tmp = tmp_path_factory.mktemp("resume")
    ck = {c: str(tmp / f"{c[0]}{c[1]}.state") for c in RESUME}
    first = {c: _start(tmp / f"a_{c[0]}{c[1]}", c[1], "--mode", c[0],
                       "--steps", "4", "--state-checkpoint", ck[c],
                       "--checkpoint-at", "2") for c in RESUME}
    whole = {c: _wait(p) for c, p in first.items()}
    then = {c: _start(tmp / f"b_{c[0]}{c[1]}", c[1], "--mode", c[0],
                      "--steps", "4", "--resume", ck[c]) for c in RESUME}
    return ck, whole, {c: _wait(p) for c, p in then.items()}


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_resume_reproduces_uninterrupted_run(resume_runs, mode, n):
    cks, wholes, resumes = resume_runs
    ck, (rcs, whole), (rcs2, resumed) = (cks[(mode, n)], wholes[(mode, n)],
                                         resumes[(mode, n)])
    assert rcs == [0] * n, whole
    assert f"checkpoint -> {ck} at step 2" in whole
    assert rcs2 == [0] * n, resumed
    assert f"resumed {ck} at step 2" in resumed
    assert sum(ln.startswith("step ") for ln in resumed.splitlines()) == 2
    assert _sha(resumed)[0] == _sha(whole)[0]
