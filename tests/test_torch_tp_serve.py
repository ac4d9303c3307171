"""Sharded serving (``serve/step.py``) on gloo worlds with a model axis,
held against the JAX reference's unsharded decode.

A 1 (data) x 2 (model) world and a 2 x 2 world run once per module,
concurrently, each rank on its blocks of the reference's bf16 params
(``convert.shard_params``) and of the cache (``convert.shard_cache``):

* batched decode (batch 4 over the dp axes, the cache's slots over
  ``model``): a 6-token chunked prefill (``make_chunked_prefill_step``;
  token by token through the decode step for MLA, Mamba and RWKV, which
  have no chunked prefill), then 4 decode steps (``make_serve_step``),
  each rank's rows; whisper's cross K/V first (``make_warm_step``: the
  encoder on each rank's rows, each rank projecting its block of the
  frames);
* long-context decode (``seq_sharded=True``, batch 1, the slots over
  data x model): 8 decode steps from position 0, the batch on every rank;
* the prefill forward (``make_prefill_step``) over the whole prompts.

Smoke lm-100m, mixtral, jamba (Mamba state split on d_inner), rwkv6
(WKV state split on heads, the token shifts on D), deepseek (MLA's latent
cache split on slots) and whisper (the cross K/V split on frames). Every
logit within ``atol 0.1`` of the
reference's unsharded ``prefill_chunk`` / ``decode_step`` / ``logits``
(the reference's own bound, ``tests/test_moe_serve.py:175``); the greedy
pick equal wherever the reference's top-2 margin exceeds twice 0.06, the
bf16 noise bound of ``test_torch_serve_dense.py``. Both sides are fed the
same tokens. Both sides' routing is recorded call by call: mixtral routes
every token as the reference does, and every logit is held. jamba's and
deepseek's routers near a tie may pick another expert set under the bf16
drift (the port's world of one does so too on jamba's weights here;
``FLIPS``): every token whose expert set differs must be a near-tie (the
reference's k-th and (k+1)-th probs within ROUTE_TIE,
``test_torch_moe.py``'s bound), at most 1 - ROUTE_AGREE of a layout's
routed tokens, and that token (and the later ones of its row, when a
later layer reads it) is left out of the logits' bound. The world of four also decodes the cuts of
``tp_cuts.CUTS`` on a (1, 4) mesh against the port's world of one.
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
from test_torch_moe import ROUTE_AGREE, ROUTE_TIE, _record_routing
from torch_test_env import port_test_env  # noqa: F401
from tp_cuts import CUTS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("lm-100m", "mixtral-8x22b", "jamba-v0.1-52b", "rwkv6-3b",
         "deepseek-v2-236b", "whisper-base")
# the MoE models whose near-tied routers may flip (see above)
FLIPS = ("jamba-v0.1-52b", "deepseek-v2-236b")
ATOL = 0.1
MARGIN = 2 * 0.06
B, C, T0, STEPS, SEQ_STEPS = 4, 64, 6, 4, 8

TORCH_PROG = """
import json, os, sys, time
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
                                    make_warm_step, plan_serve_sharding)
from repro_torch.models import moe
B, C, T0, STEPS, SEQ_STEPS = {shape!r}
mesh = make_host_mesh(model=2)
arrays, counts = dict(), dict()
routes, route = [], moe._route


def recorded(logits, spec):
    r = route(logits, spec)
    routes.append(r.topi.numpy())
    return r


moe._route = recorded


def keep_routes(name):
    for j, t in enumerate(routes):
        arrays[name + "/route" + str(j)] = t
    routes.clear()


for arch in {archs!r}:
    while not os.path.exists(out + "/" + arch + ".ready"):
        time.sleep(0.2)
    model = LM(get_smoke_config(arch))
    like = model.init(torch.Generator().manual_seed(0), device="cpu")
    params, _ = load_checkpoint(out + "/" + arch + "_params", like)
    params = map_tree(lambda t: t.to(torch.bfloat16), params)
    toks = torch.from_numpy(np.load(out + "/" + arch + "_tokens.npy")).long()
    enc = None
    if model.cfg.encoder:
        enc = torch.from_numpy(np.load(out + "/" + arch + "_enc.npy")).to(
            torch.bfloat16)
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
        r = slice(0, 1) if seq else rows
        if enc is not None:
            make_warm_step(model, mesh, plan, batch_dp=not seq)(
                pb, cache, enc[r])
        if seq:
            lg = [step(pb, cache, toks[:1, i:i + 1], i)[0]
                  for i in range(SEQ_STEPS)]
        else:
            if model.supports_chunked_prefill():
                pre = make_chunked_prefill_step(model, mesh, plan)
                lg = [pre(pb, cache, toks[rows, :T0], 0)[0]]
            else:
                lg = [step(pb, cache, toks[rows, i:i + 1], i)[0]
                      for i in range(T0)]
            lg += [step(pb, cache, toks[rows, i:i + 1], i)[0]
                   for i in range(T0, T0 + STEPS)]
        keep_routes(name)
        arrays[name] = torch.cat(lg, dim=1).numpy()
        if not seq:
            arrays[arch + "/prefill"] = make_prefill_step(
                model, mesh, plan)(pb, dict(
                    tokens=toks[rows],
                    enc_embeds=None if enc is None else enc[rows])).numpy()
            keep_routes(arch + "/prefill")
    counts[arch] = mesh.model_axis.collectives - c0
if ws == 4:
    # the cuts on the (1, 4) mesh of these ranks, token by token, against
    # the port's world of one on the same weights (the port's init, zero
    # leaves drawn; the world of one on rank 0)
    sys.path.insert(0, {tests!r})
    from tp_cuts import CUTS, smoke
    mesh4 = make_host_mesh(model=4)
    for arch in sorted(CUTS):
        model = LM(smoke(arch))
        g = torch.Generator().manual_seed(4)
        params = map_tree(lambda t: (t if t.any() else 0.1 * torch.randn(
            t.shape, generator=g)).to(torch.bfloat16), model.init(
                torch.Generator().manual_seed(0), device="cpu"))
        src = out + "/" + arch.split("/")[0]
        toks = torch.from_numpy(np.load(src + "_tokens.npy")).long()
        plan = plan_serve_sharding(model, model.abstract_params(),
                                   model.abstract_cache(B, C), mesh4)
        pb = shard_params(params, plan, mesh4.coords)
        cache = shard_cache(model.init_cache(B, C, device="cpu"), plan,
                            mesh4.coords)
        one = model.init_cache(B, C, device="cpu") if rank == 0 else None
        if model.cfg.encoder:
            enc = torch.from_numpy(np.load(src + "_enc.npy")).to(
                torch.bfloat16)
            make_warm_step(model, mesh4, plan)(pb, cache, enc)
            if one is not None:
                model.warm_cache(params, one, enc)
        step = make_serve_step(model, mesh4, plan)
        lg, lg1 = [], []
        for i in range(T0 + STEPS):
            lg.append(step(pb, cache, toks[:, i:i + 1], i)[0])
            if one is not None:
                lg1.append(model.decode_step(params, one, toks[:, i:i + 1],
                                             i)[0])
        arrays["cut/" + arch] = torch.cat(lg, 1).numpy()
        if one is not None:
            arrays["one/" + arch] = torch.cat(lg1, 1).numpy()
    routes.clear()
np.savez(out + "/s" + str(ws) + "_" + str(rank) + ".npz", **arrays)
print("ROWS " + json.dumps(dict(coords=mesh.coords, counts=counts)),
      flush=True)
dist.destroy_process_group()
"""


def _reference(arch, p, t, enc, ref, jroutes, jlog):
    """The reference's unsharded logits of the three layouts, and its
    routing of each (``jlog`` records every MoE call)."""
    jm = JLM(jget_smoke_config(arch))
    step = jax.jit(jm.decode_step)
    warm = jax.jit(jm.warm_cache)

    def fresh(b):
        c = jm.init_cache(b, C)
        return c if enc is None else warm(p, c, jnp.asarray(enc[:b]))

    def keep(name, out):
        ref[name] = np.concatenate(out, axis=1)
        jax.effects_barrier()
        jroutes[name] = list(jlog)
        jlog.clear()

    cache = fresh(B)
    if _chunked(arch):
        lg, cache = jax.jit(jm.prefill_chunk)(p, cache,
                                             jnp.asarray(t[:, :T0]), 0)
        out = [np.asarray(lg, np.float32)]
    else:
        out = []
        for i in range(T0):
            lg, cache = step(p, cache, jnp.asarray(t[:, i:i + 1]),
                             jnp.int32(i))
            out.append(np.asarray(lg, np.float32))
    for i in range(T0, T0 + STEPS):
        lg, cache = step(p, cache, jnp.asarray(t[:, i:i + 1]), jnp.int32(i))
        out.append(np.asarray(lg, np.float32))
    keep(arch + "/batch", out)
    cache, out = fresh(1), []
    for i in range(SEQ_STEPS):
        lg, cache = step(p, cache, jnp.asarray(t[:1, i:i + 1]), jnp.int32(i))
        out.append(np.asarray(lg, np.float32))
    keep(arch + "/seq", out)
    keep(arch + "/prefill", [np.asarray(jax.jit(jm.logits)(
        p, jnp.asarray(t), enc_embeds=None if enc is None
        else jnp.asarray(enc))[0], np.float32)])


def _chunked(arch):
    """Whether the arch has the chunked prefill (GQA attention layers
    only: MLA, Mamba and RWKV prefill token by token)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import LM
    return LM(get_smoke_config(arch)).supports_chunked_prefill()


def _env(extra):
    return {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
            "JAX_PLATFORMS": "cpu", **extra}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both worlds (started first; each arch's inputs are written while
    they start, and they wait for them), then the reference's unsharded
    logits while they run."""
    tmp = tmp_path_factory.mktemp("tp_serve")
    src = TORCH_PROG.format(shape=(B, C, T0, STEPS, SEQ_STEPS), archs=ARCHS,
                            tests=os.path.join(ROOT, "tests"))
    procs = {ws: [subprocess.Popen(
        [sys.executable, "-c", src, str(r), str(ws), str(tmp),
         str(tmp / f"rdv{ws}")], env=_env({"OMP_NUM_THREADS": "1"}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(ws)] for ws in (2, 4)}
    jparams, toks, encs = {}, {}, {}
    for i, arch in enumerate(ARCHS):
        jm = JLM(jget_smoke_config(arch))
        p = jm.init(jax.random.key(20 + i))
        jsave(str(tmp / f"{arch}_params"),
              jax.tree_util.tree_map(np.asarray, p))
        toks[arch] = np.asarray(jax.random.randint(
            jax.random.key(30 + i), (B, max(T0 + STEPS, SEQ_STEPS)), 0,
            jm.cfg.vocab_size))
        np.save(tmp / f"{arch}_tokens.npy", toks[arch])
        if jm.cfg.encoder:
            encs[arch] = np.asarray((jax.random.normal(
                jax.random.key(40 + i), (B, jm.cfg.encoder.num_frames,
                                         jm.cfg.d_model)) * 0.02).astype(
                jnp.bfloat16))
            np.save(tmp / f"{arch}_enc.npy", encs[arch].astype(np.float32))
        jparams[arch] = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16)
            if jnp.issubdtype(x.dtype, jnp.floating) else x, p)
        (tmp / f"{arch}.ready").touch()
    ref, jroutes = {}, {}
    for arch in ARCHS:
        with pytest.MonkeyPatch.context() as mpatch:
            jlog = []
            _record_routing(mpatch, jlog, [])
            _reference(arch, jparams[arch], toks[arch], encs.get(arch), ref,
                       jroutes, jlog)
    rows, arrays = {}, {}
    for ws, ps in procs.items():
        outs = [q.communicate(timeout=900)[0] for q in ps]
        assert [q.returncode for q in ps] == [0] * ws, outs
        rows[ws] = [json.loads([ln for ln in o.splitlines()
                                if ln.startswith("ROWS ")][-1][5:])
                    for o in outs]
        arrays[ws] = [dict(np.load(tmp / f"s{ws}_{r}.npz"))
                      for r in range(ws)]
    return ref, rows, arrays, jroutes


def _tokens_of(arch, layout, call, n):
    """The (row, position) of each of the n tokens of a layout's MoE call
    ``call`` (every MoE layer is called once per forward, in order)."""
    fwd = call // len(_moe_layers(arch)[0])
    idx = np.arange(n)
    if layout == "prefill":
        return idx // (T0 + STEPS), idx % (T0 + STEPS)
    if layout == "batch" and _chunked(arch):
        if fwd == 0:
            return idx // T0, idx % T0
        return idx, np.full(n, T0 + fwd - 1)
    return idx, np.full(n, fwd)


def _moe_layers(arch):
    specs = JLM(jget_smoke_config(arch)).specs
    return [j for j, s in enumerate(specs) if s.moe], len(specs)


def _excluded(arch, layout, jlog, arrays):
    """(rows, positions) mask of the tokens left out, the routed tokens and
    the flipped ones: each token routed to another expert set than the
    reference's (a near-tie, asserted; none outside ``FLIPS``) and, when a
    later layer reads it, the later positions of its row."""
    moe_at, n_layers = _moe_layers(arch)
    flips = total = 0
    rows = 1 if layout == "seq" else B
    cols = SEQ_STEPS if layout == "seq" else T0 + STEPS
    out = np.zeros((rows, cols), bool)
    got = [arrays[f"{arch}/{layout}/route{j}"] for j in range(len(jlog))]
    assert f"{arch}/{layout}/route{len(jlog)}" not in arrays
    for c, ((probs, want), mine) in enumerate(zip(jlog, got)):
        k = want.shape[-1]
        flip = ~(np.sort(want, -1) == np.sort(mine, -1)).all(-1)
        srt = -np.sort(-probs, -1)
        margin = srt[:, k - 1] - srt[:, k]
        assert (margin[flip] < ROUTE_TIE).all(), (arch, layout, margin[flip])
        assert arch in FLIPS or not flip.any(), (arch, layout, c, flip.sum())
        flips, total = flips + int(flip.sum()), total + len(flip)
        last = moe_at[c % len(moe_at)] == n_layers - 1
        rr, tt = _tokens_of(arch, layout, c, len(want))
        for r, t in zip(rr[flip], tt[flip]):
            out[r, t:t + 1 if last else None] = True
    return out, total, flips


def _hold(got, want, what, excluded):
    keep = ~excluded
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=ATOL,
                               err_msg=what)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = ((top2[..., 1] - top2[..., 0]) > MARGIN) & keep
    assert clear.any(), what
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear], err_msg=what)


@pytest.mark.parametrize("layout", ["batch", "seq", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ws", [2, 4])
def test_sharded_decode_matches_reference(run, ws, arch, layout):
    ref, rows, arrays, jroutes = run
    want = ref[f"{arch}/{layout}"]
    nb = B // (ws // 2)
    for r, a in zip(rows[ws], arrays[ws]):
        got = a[f"{arch}/{layout}"]
        excluded, _, _ = _excluded(arch, layout,
                                   jroutes[f"{arch}/{layout}"], a)
        if layout != "seq":
            d = r["coords"]["data"]
            want_r = want[d * nb:(d + 1) * nb]
            excluded = excluded[d * nb:(d + 1) * nb]
        else:
            want_r = want
        assert got.shape == want_r.shape, (got.shape, want_r.shape)
        _hold(got, want_r, f"{arch} {layout} rank {r['coords']}", excluded)
        assert r["counts"][arch] > 0


@pytest.mark.parametrize("arch", [a for a in ARCHS if _moe_layers(a)[0]])
@pytest.mark.parametrize("ws", [2, 4])
def test_routing_flips_are_rare(run, ws, arch):
    """Over the three layouts, every rank routes at least ROUTE_AGREE of
    the tokens to the reference's expert sets (mixtral all of them)."""
    _, rows, arrays, jroutes = run
    for a in arrays[ws]:
        counts = [_excluded(arch, layout, jroutes[f"{arch}/{layout}"], a)[1:]
                  for layout in ("batch", "seq", "prefill")]
        total, flips = (sum(c) for c in zip(*counts))
        assert total > 0 and flips <= (1 - ROUTE_AGREE) * total, counts


@pytest.mark.parametrize("arch", sorted(CUTS))
def test_sharded_decode_of_cuts(run, arch):
    """Heads that do not split over 4 model ranks (``tp_cuts.CUTS``:
    whisper's query or KV heads):
    the sharded decode on the (1, 4) mesh against the port's world of one,
    the same bounds."""
    _, _, arrays, _ = run
    one = arrays[4][0]["one/" + arch]
    for a in arrays[4]:
        _hold(a["cut/" + arch], one, arch, np.zeros(one.shape[:2], bool))
