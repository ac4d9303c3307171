"""The port's sharding plans against the reference's, spec by spec, for
every registered config (full and smoke) on the meshes (data, model) in
{(1, 2), (2, 2), (4, 2), (1, 4)} and (pod, data, model) = (2, 1, 2).

* Training: ``train.step.plan_sharding_shapes`` (fsdp dims over the dp
  axes, TP dims over ``model``) against the reference's, every leaf's
  spec and TP dim.
* Serving: ``serve.step.plan_serve_sharding`` (pure TP params, the cache's
  batch over dp and slots over ``model``), with and without
  ``seq_sharded``, every parameter and cache leaf.

Shape-only on both sides: the reference's trees come from
``jax.eval_shape`` and its serve plan reads a stub mesh (only
``axis_names`` and ``devices.shape``); the port's are ``meta`` tensors
(``LM.abstract_params`` / ``abstract_cache``), so the full configs plan
without allocating.
"""
import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.configs.base import list_archs
from repro.models.model import LM as JLM
from repro.serve.step import plan_serve_sharding as jplan_serve
from repro.train.step import plan_sharding_shapes as jplan
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import LM
from repro_torch.serve.step import plan_serve_sharding
from repro_torch.train.step import plan_sharding_shapes
from repro_torch.utils.pytree import tree_flatten_with_path
from torch_test_env import port_test_env  # noqa: F401

MESHES = [(("data", "model"), (1, 2)), (("data", "model"), (2, 2)),
          (("data", "model"), (4, 2)), (("data", "model"), (1, 4)),
          (("pod", "data", "model"), (2, 1, 2))]
BATCH, MAX_LEN = 8, 64


class _StubMesh:
    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape)


def _spec(spec, ndim):
    """A spec as a tuple of one entry per dim (tuples for several axes)."""
    ent = tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                for e in spec)
    return ent + (None,) * (ndim - len(ent))


def _is_spec(x):
    return isinstance(x, P)


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", list_archs())
def test_plans_match_reference(arch, size):
    jm = JLM((jget_config if size == "full" else jget_smoke_config)(arch))
    m = LM((get_config if size == "full" else get_smoke_config)(arch))
    ap = jax.eval_shape(jm.init, jax.random.key(0))
    ac = jax.eval_shape(lambda: jm.init_cache(BATCH, MAX_LEN))
    tap, tac = m.abstract_params(), m.abstract_cache(BATCH, MAX_LEN)
    paths = jax.tree_util.tree_leaves(jm.param_paths(ap))
    leaves = jax.tree_util.tree_leaves(ap)
    cache_leaves = jax.tree_util.tree_leaves_with_path(ac)
    port_cache, _ = tree_flatten_with_path(tac)
    assert [jax.tree_util.keystr(p) for p, _ in cache_leaves] == \
        [p for p, _ in port_cache]
    for names, shape in MESHES:
        sizes = dict(zip(names, shape))
        dp = tuple(a for a in ("pod", "data") if a in names)
        want = jplan(jm, ap, dp_axes=dp, axis_sizes=sizes)
        got = plan_sharding_shapes(m, tap, dp_axes=dp, axis_sizes=sizes)
        wspecs = jax.tree_util.tree_leaves(want.specs, is_leaf=_is_spec)
        assert len(wspecs) == len(got.specs)
        for path, ws, leaf in zip(paths, wspecs, leaves):
            assert _spec(got.specs[path], leaf.ndim) == \
                _spec(ws, leaf.ndim), (shape, path)
            assert got.tp_dims[path] == want.tp_dims[path], (shape, path)
            assert got.gather_dims[path] == want.gather_dims[path]
        for seq in (False, True):
            wsv = jplan_serve(jm, ap, ac, _StubMesh(names, shape),
                              seq_sharded=seq)
            gsv = plan_serve_sharding(m, tap, tac, MeshShape(names, shape),
                                      seq_sharded=seq)
            wps = jax.tree_util.tree_leaves(wsv.param_specs,
                                            is_leaf=_is_spec)
            for path, ws, leaf in zip(paths, wps, leaves):
                assert _spec(gsv.param_specs[path], leaf.ndim) == \
                    _spec(ws, leaf.ndim), (shape, seq, path)
            wcs = jax.tree_util.tree_leaves(wsv.cache_specs,
                                            is_leaf=_is_spec)
            gcs = _cache_specs(gsv.cache_specs)
            assert len(wcs) == len(gcs) == len(cache_leaves)
            for (kp, leaf), ws, gs in zip(cache_leaves, wcs, gcs):
                assert _spec(gs, leaf.ndim) == _spec(ws, leaf.ndim), (
                    shape, seq, jax.tree_util.keystr(kp))


def _cache_specs(tree):
    """The specs of a cache-aligned tree in canonical leaf order (a spec
    is itself a tuple, so the pytree helpers would walk into it)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _cache_specs(tree[k])]
    if isinstance(tree, tuple) and tree and isinstance(tree[0], dict):
        return [s for t in tree for s in _cache_specs(t)]
    return [tree]


def test_lm100m_plan_quirks():
    """The quirks the compute must accept (not the Megatron layout):
    training splits attn/wo on its output, ffn/wo on F, embed and lm_head
    on V and no norm; serving splits wq..wo on their input and the norm
    scales too, and the slot-position table over data on its slot dim."""
    m = LM(get_config("lm-100m"))
    mesh = MeshShape(("data", "model"), (2, 2))
    tp = plan_sharding_shapes(m, m.abstract_params(), dp_axes=("data",),
                              axis_sizes={"data": 2, "model": 2}).tp_dims
    assert tp["g0/pos0['attn']['wo']"] == 1
    assert tp["g0/pos0['ffn']['wo']"] == 0
    assert tp["embed"] == 0 and tp["lm_head"] == 1
    assert tp["g0/pos0['norm1']['scale']"] is None
    sv = plan_serve_sharding(m, m.abstract_params(),
                             m.abstract_cache(BATCH, 512), mesh)
    dims = sv.tp_dims()
    assert [dims[f"g0/pos0['attn']['{w}']"] for w in
            ("wq", "wk", "wv", "wo")] == [0, 0, 0, 0]
    assert dims["g0/pos0['norm1']['scale']"] == 0
    assert sv.cache_specs[0]["pos0"]["pos"] == (None, "data")
    assert sv.cache_specs[0]["pos0"]["k"] == (None, "data", "model", None,
                                              None)


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_shard_params_round_trip(kind):
    """``convert.shard_params`` cuts each rank's blocks by the plan (a 1 x
    2 mesh), ``unshard_params`` concatenates the model axis back: the
    whole tree again. On a 2 x 2 mesh the cache's blocks
    (``shard_cache``) tile the whole cache."""
    import torch

    from repro_torch.convert import shard_cache, shard_params, unshard_params
    from repro_torch.train.step import plan_sharding

    m = LM(get_smoke_config("mixtral-8x22b"))
    mesh = MeshShape(("data", "model"), (1, 2))
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    plan = (plan_sharding(m, m.abstract_params(), mesh) if kind == "train"
            else plan_serve_sharding(m, m.abstract_params(),
                                     m.abstract_cache(4, 16), mesh))
    blocks = [shard_params(params, plan, {"data": 0, "model": k})
              for k in range(2)]
    assert any(a.shape != b.shape for (_, a), (_, b) in zip(
        tree_flatten_with_path(blocks[0])[0],
        tree_flatten_with_path(params)[0]))
    whole = unshard_params(blocks, plan)
    for (_, a), (_, b) in zip(tree_flatten_with_path(whole)[0],
                              tree_flatten_with_path(params)[0]):
        assert torch.equal(a, b)
    cache = m.init_cache(4, 16, device="cpu")
    cache[0]["pos0"]["k"].normal_()
    mesh = MeshShape(("data", "model"), (2, 2))
    sv = plan_serve_sharding(m, m.abstract_params(), m.abstract_cache(4, 16),
                             mesh)
    got = torch.cat([torch.cat([shard_cache(cache, sv, {
        "data": d, "model": j})[0]["pos0"]["k"] for j in range(2)], dim=2)
        for d in range(2)], dim=1)
    assert torch.equal(got, cache[0]["pos0"]["k"])
