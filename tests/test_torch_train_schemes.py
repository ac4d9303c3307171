"""The port's Algorithm-2 training step with BinGrad-b, and a mixed
policy, against the JAX reference (orq-9 is in ``test_torch_train.py``).

One smoke-config step from the same state (``convert.state_from_jax``),
the port on a gloo world of one process, the reference on a one-device
data-only mesh (which still runs the full two-phase exchange, L = 1).

Tolerances, with their reasons:

* Loss: rtol 1e-3 (bf16 matmuls round at other places in XLA and
  PyTorch).
* The update and the EF residual, with and without error feedback:
  within 0.2 in relative norm per leaf, as for orq-9 in
  ``test_torch_train.py``. BinGrad-b sends one bit per element; the ~1%
  bf16 gradient differences move some elements across their bucket's
  threshold, each by a whole level gap.
* The exchange of the reference's own gradient buffer, same key: the
  levels are row sums over counts (float-close), so the outputs agree
  within ``RTOL`` of the buffer's max |value| on at least 99.9% of the
  elements; the rest (an element whose side flipped on an ulp-moved
  threshold) within a level gap.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core import comm as jcomm
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
from repro_torch.models import LM
from repro_torch.optim.schedule import constant_lr
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.step import _FUSED_SALT, exchange_engine
from repro_torch.utils.pytree import tree_leaves
from torch_test_env import port_test_env  # noqa: F401

LR = 0.05
RTOL = 1e-5
MIXED = "norm|bias=fp,embed=bingrad-b,default=orq-9"


@pytest.fixture(scope="module")
def world1():
    if not dist.is_initialized():
        tmp = tempfile.mkdtemp(prefix="repro_torch_test_world_")
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
    return dist.get_world_size()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref_runs():
    """Reference states before and after one BinGrad-b step, without and
    with error feedback, and the gradient at the starting state."""
    jmodel = JLM(jget_smoke_config("lm-100m"))
    mesh = jax.make_mesh((1,), ("data",))
    batch = JSyntheticLM(512, 16, 2, 0).batch(0)
    out = {}
    for ef in (False, True):
        tcfg = jstep.TrainConfig(policy=JPolicy.parse("bingrad-b",
                                                      bucket_size=512),
                                 mode="replicated", error_feedback=ef)
        state = jstep.init_state(jmodel, mesh, tcfg, jax.random.key(0))
        before = _np(state)
        fn, _ = jstep.make_train_step(jmodel, mesh, tcfg,
                                      lr_fn=jconstant_lr(LR))
        after, metrics = fn(state, batch, jax.random.key(0))
        out[ef] = (before, _np(after), float(metrics["loss"]))
    grads = jax.grad(lambda p: jmodel.loss(p, batch)[0])(
        jax.tree_util.tree_map(jnp.asarray, out[False][0].params))
    return jmodel, mesh, np.array(batch["tokens"]), out, _np(grads)


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("ef", [False, True])
def test_bingrad_step_close(world1, ref_runs, ef):
    _, _, tokens, out, _ = ref_runs
    before, after, jloss = out[ef]
    model = LM(get_smoke_config("lm-100m"))
    tcfg = TrainConfig(policy=QuantPolicy.parse("bingrad-b",
                                                bucket_size=512),
                       error_feedback=ef)
    fn = make_train_step(model, tcfg, constant_lr(LR))
    state, metrics = fn(state_from_jax(before, device="cpu"),
                        {"tokens": torch.from_numpy(tokens)}, prng.key(0))
    np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=1e-3)
    rels = [_rel(p.numpy() - p0, w - p0) for p, p0, w in zip(
        tree_leaves(state.params), jax.tree_util.tree_leaves(before.params),
        jax.tree_util.tree_leaves(after.params), strict=True)]
    print(f"bingrad-b ef={ef}: worst update rel. difference {max(rels)}")
    assert max(rels) < 0.2
    if ef:
        for e, w in zip(tree_leaves(state.ef),
                        jax.tree_util.tree_leaves(after.ef), strict=True):
            assert e.shape == w.shape and np.isfinite(e.numpy()).all()
            assert _rel(e.numpy(), w) < 0.2


@pytest.mark.parametrize("policy", ["bingrad-b", MIXED])
def test_exchange_of_reference_grads_matches(world1, ref_runs, policy):
    """Same gradient buffer, same key: the port's fused exchange and EF
    qdq reproduce the reference's."""
    jmodel, mesh, _, _, jgrads = ref_runs
    jpex = jcomm.PartitionedExchange.build(
        JPolicy.parse(policy, bucket_size=512), jgrads, ("data",),
        paths=jmodel.param_paths(jgrads))
    jbufs = jpex.layout.flatten_groups(jgrads)
    k = jax.random.fold_in(jax.random.fold_in(jax.random.key(0), 0),
                           jstep._FUSED_SALT)
    want = []
    for f in (jpex.exchange_parts, jpex.local_qdq_parts):
        fn = jax.jit(shard_map(lambda *b: f(b, k), mesh=mesh,
                               in_specs=(P(),) * len(jbufs),
                               out_specs=(P(),) * len(jbufs),
                               axis_names={"data"}, check_vma=False))
        want += [np.asarray(x) for x in fn(*jbufs)]

    model = LM(get_smoke_config("lm-100m"))
    pex = exchange_engine(model, TrainConfig(
        policy=QuantPolicy.parse(policy, bucket_size=512)))
    assert [e.qz.method for e in pex.engines] == \
        [e.qz.method for e in jpex.engines]
    tk = prng.fold_in(prng.fold_in(prng.key(0), 0), _FUSED_SALT)
    bufs = pex.layout.flatten_groups(params_from_jax(jgrads, device="cpu"))
    got = [x.numpy() for x in pex.exchange_parts(bufs, tk)]
    got += [x.numpy() for x in pex.local_qdq_parts(bufs, tk)]
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        close = np.abs(g - w) <= RTOL * np.abs(w).max()
        print(f"{policy}: {int((~close).sum())} of {g.size} outside RTOL")
        assert close.mean() >= 0.999
        gap = np.abs(w).max() * 2          # at most a level gap
        assert np.all(np.abs(g - w) <= gap)


def test_mixed_policy_step_runs(world1):
    """A mixed policy trains: its groups take their own schemes (fp,
    BinGrad-b, ORQ-9), each with its own collectives, and the replicated
    state updates."""
    model = LM(get_smoke_config("lm-100m"))
    tcfg = TrainConfig(policy=QuantPolicy.parse(MIXED, bucket_size=512),
                       error_feedback=True)
    fn = make_train_step(model, tcfg, constant_lr(LR))
    assert sorted(e.qz.method for e in fn.exchange.engines) == \
        ["bingrad_b", "fp", "orq"]
    from repro_torch.train import init_state
    state = init_state(model, tcfg, device="cpu")
    tokens = torch.from_numpy(np.array(JSyntheticLM(512, 16, 2, 0)
                                       .batch(0)["tokens"]))
    new, metrics = fn(state, {"tokens": tokens}, prng.key(0))
    assert np.isfinite(float(metrics["loss"])) and new.step == 1
    moved = [not torch.equal(a, b) for a, b in zip(
        tree_leaves(new.params), tree_leaves(state.params))]
    assert all(moved)
