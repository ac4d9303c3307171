"""Sharded serving (``serve/step.py``) on gloo worlds with a model axis,
held against the JAX reference's unsharded decode.

A 1 (data) x 2 (model) world and a 2 x 2 world run once per module,
concurrently, each rank on its blocks of the reference's bf16 params
(``convert.shard_params``) and of the cache (``convert.shard_cache``):

* batched decode (batch 4 over the dp axes, the cache's slots over
  ``model``): a 6-token chunked prefill (``make_chunked_prefill_step``),
  then 4 decode steps (``make_serve_step``), each rank's rows;
* long-context decode (``seq_sharded=True``, batch 1, the slots over
  data x model): 8 decode steps from position 0, the batch on every rank;
* the prefill forward (``make_prefill_step``) over the whole prompts.

Smoke lm-100m and mixtral. Every logit within ``atol 0.1`` of the
reference's unsharded ``prefill_chunk`` / ``decode_step`` / ``logits``
(the reference's own bound, ``tests/test_moe_serve.py:175``); the greedy
pick equal wherever the reference's top-2 margin exceeds twice 0.06, the
bf16 noise bound of ``test_torch_serve_dense.py``. Both sides are fed the
same tokens.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint import save_checkpoint as jsave
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.models.model import LM as JLM
from torch_test_env import port_test_env  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("lm-100m", "mixtral-8x22b")
ATOL = 0.1
MARGIN = 2 * 0.06
B, C, T0, STEPS, SEQ_STEPS = 4, 64, 6, 4, 8

TORCH_PROG = """
import json, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, ws, out, rdv = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                        world_size=ws)
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import shard_cache, shard_params
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LM
from repro_torch.models.model import map_tree
from repro_torch.serve.step import (make_chunked_prefill_step,
                                    make_prefill_step, make_serve_step,
                                    plan_serve_sharding)
B, C, T0, STEPS, SEQ_STEPS = {shape!r}
mesh = make_host_mesh(model=2)
arrays, counts = dict(), dict()
for arch in {archs!r}:
    model = LM(get_smoke_config(arch))
    like = model.init(torch.Generator().manual_seed(0), device="cpu")
    params, _ = load_checkpoint(out + "/" + arch + "_params", like)
    params = map_tree(lambda t: t.to(torch.bfloat16), params)
    toks = torch.from_numpy(np.load(out + "/" + arch + "_tokens.npy")).long()
    nb = B // mesh.n_dp
    rows = slice(mesh.dp_axis.index * nb, (mesh.dp_axis.index + 1) * nb)
    c0 = mesh.model_axis.collectives
    for seq in (False, True):
        b = 1 if seq else B
        plan = plan_serve_sharding(model, model.abstract_params(),
                                   model.abstract_cache(b, C), mesh,
                                   seq_sharded=seq)
        pb = shard_params(params, plan, mesh.coords)
        cache = shard_cache(model.init_cache(b, C, device="cpu"), plan,
                            mesh.coords)
        step = make_serve_step(model, mesh, plan, batch_dp=not seq)
        name = arch + ("/seq" if seq else "/batch")
        if seq:
            lg = [step(pb, cache, toks[:1, i:i + 1], i)[0]
                  for i in range(SEQ_STEPS)]
        else:
            pre = make_chunked_prefill_step(model, mesh, plan)
            lg = [pre(pb, cache, toks[rows, :T0], 0)[0]]
            lg += [step(pb, cache, toks[rows, i:i + 1], i)[0]
                   for i in range(T0, T0 + STEPS)]
            arrays[arch + "/prefill"] = make_prefill_step(
                model, mesh, plan)(pb, dict(tokens=toks[rows])).numpy()
        arrays[name] = torch.cat(lg, dim=1).numpy()
    counts[arch] = mesh.model_axis.collectives - c0
np.savez(out + "/s" + str(ws) + "_" + str(rank) + ".npz", **arrays)
print("ROWS " + json.dumps(dict(coords=mesh.coords, counts=counts)),
      flush=True)
dist.destroy_process_group()
"""


def _env(extra):
    return {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
            "JAX_PLATFORMS": "cpu", **extra}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both worlds (started first), then the reference's unsharded logits
    while they run."""
    tmp = tmp_path_factory.mktemp("tp_serve")
    jparams, toks = {}, {}
    for i, arch in enumerate(ARCHS):
        jm = JLM(jget_smoke_config(arch))
        p = jm.init(jax.random.key(20 + i))
        jsave(str(tmp / f"{arch}_params"),
              jax.tree_util.tree_map(np.asarray, p))
        toks[arch] = np.asarray(jax.random.randint(
            jax.random.key(30 + i), (B, max(T0 + STEPS, SEQ_STEPS)), 0,
            jm.cfg.vocab_size))
        np.save(tmp / f"{arch}_tokens.npy", toks[arch])
        jparams[arch] = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16)
            if jnp.issubdtype(x.dtype, jnp.floating) else x, p)
    src = TORCH_PROG.format(shape=(B, C, T0, STEPS, SEQ_STEPS), archs=ARCHS)
    procs = {ws: [subprocess.Popen(
        [sys.executable, "-c", src, str(r), str(ws), str(tmp),
         str(tmp / f"rdv{ws}")], env=_env({"OMP_NUM_THREADS": "1"}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(ws)] for ws in (2, 4)}
    ref = {}
    for arch in ARCHS:
        jm, p, t = JLM(jget_smoke_config(arch)), jparams[arch], toks[arch]
        step = jax.jit(jm.decode_step)
        cache = jm.init_cache(B, C)
        lg, cache = jax.jit(jm.prefill_chunk)(p, cache,
                                             jnp.asarray(t[:, :T0]), 0)
        out = [np.asarray(lg, np.float32)]
        for i in range(T0, T0 + STEPS):
            lg, cache = step(p, cache, jnp.asarray(t[:, i:i + 1]),
                             jnp.int32(i))
            out.append(np.asarray(lg, np.float32))
        ref[arch + "/batch"] = np.concatenate(out, axis=1)
        cache, out = jm.init_cache(1, C), []
        for i in range(SEQ_STEPS):
            lg, cache = step(p, cache, jnp.asarray(t[:1, i:i + 1]),
                             jnp.int32(i))
            out.append(np.asarray(lg, np.float32))
        ref[arch + "/seq"] = np.concatenate(out, axis=1)
        ref[arch + "/prefill"] = np.asarray(
            jm.logits(p, jnp.asarray(t))[0], np.float32)
    rows, arrays = {}, {}
    for ws, ps in procs.items():
        outs = [q.communicate(timeout=900)[0] for q in ps]
        assert [q.returncode for q in ps] == [0] * ws, outs
        rows[ws] = [json.loads([ln for ln in o.splitlines()
                                if ln.startswith("ROWS ")][-1][5:])
                    for o in outs]
        arrays[ws] = [dict(np.load(tmp / f"s{ws}_{r}.npz"))
                      for r in range(ws)]
    return ref, rows, arrays


def _hold(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=what)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > MARGIN
    assert clear.any(), what
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear], err_msg=what)


@pytest.mark.parametrize("layout", ["batch", "seq", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ws", [2, 4])
def test_sharded_decode_matches_reference(run, ws, arch, layout):
    ref, rows, arrays = run
    want = ref[f"{arch}/{layout}"]
    nb = B // (ws // 2)
    for r, a in zip(rows[ws], arrays[ws]):
        got = a[f"{arch}/{layout}"]
        if layout != "seq":
            d = r["coords"]["data"]
            want_r = want[d * nb:(d + 1) * nb]
        else:
            want_r = want
        assert got.shape == want_r.shape, (got.shape, want_r.shape)
        _hold(got, want_r, f"{arch} {layout} rank {r['coords']}")
        assert r["counts"][arch] > 0
