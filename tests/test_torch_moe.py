"""Mixture-of-Experts (mixtral-8x22b) and Multi-head Latent Attention with
shared experts (deepseek-v2-236b) in the port against the reference, at
their ``SMOKE`` sizes.

Both packages run the same weights: the port's ``LM.init`` with its zero
leaves drawn away from zero (``test_torch_archs._weights``, which also
holds the two params trees equal by path and shape), handed to the
reference as jnp arrays.

Tolerances, with their reasons:

* ``moe_ffn`` alone in float32 on identical inputs: the routing (softmax,
  a stable top-k, an integer cumsum) must be exact, so expert ids and the
  capacity mask are equal; the expert products round at other places in
  XLA and PyTorch: y and aux within 1e-5, the gradients within 1e-5 in
  relative norm per leaf.
* MLA's training attention in float32: ``atol 2e-5``, as the attention of
  ``test_torch_archs.py``.
* The bf16 forward: logits within ``ATOL_BF16`` of their largest
  magnitude, the aux loss within 1e-4, the gradients within ``GRAD_REL``
  in relative norm per leaf (the bounds of ``test_torch_archs.py``). bf16
  matmuls differ by 1-2 ulps between XLA and PyTorch, so a near-tied
  router may pick another expert from the second layer on: the routing
  agreement is printed layer by layer and must stay above ROUTE_AGREE,
  every flip must be a near-tie of the reference's router (margin under
  ROUTE_TIE), and the logits are held on the tokens routed alike.
* The dense serve: logits within ``ATOL_BF16`` of their largest
  magnitude; the greedy picks equal wherever the reference's top-2 margin
  exceeds twice 0.06 (the bound of ``test_torch_serve_dense.py``), both
  fed the reference's tokens; the first layer's cache (deepseek's latent
  ``ckv`` and ``kr``) within one bf16 ulp of each value, deeper layers
  within CACHE_RTOL of the cache's magnitude (their input carries the
  drift), the ``pos`` arrays equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core.comm import exchange as jexchange
from repro.core.policy import QuantPolicy as JPolicy
from repro.models import LM as JLM
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import moe as jmoe
from repro.serve import Engine as JEngine
from repro.train.step import plan_sharding_shapes as jplan_sharding_shapes
from repro_torch.configs.base import (cut_depth, get_config,
                                      get_smoke_config, list_archs)
from repro_torch.core.comm import exchange
from repro_torch.core.policy import QuantPolicy
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import LM, moe
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.serve import Engine
from repro_torch.train.step import plan_sharding_shapes
from repro_torch.utils.pytree import tree_leaves
from test_torch_archs import _weights
from torch_test_env import port_test_env  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["mixtral-8x22b", "deepseek-v2-236b"]
ATOL_F32 = 1e-5
ATOL_ATTN = 2e-5
ATOL_BF16 = 0.02          # of the logits' largest magnitude
ATOL_AUX = 1e-4
GRAD_REL = 2e-2
MARGIN = 2 * 0.06         # test_torch_serve_dense.py's greedy margin
ROUTE_AGREE = 0.9
CACHE_RTOL = 2 ** -6      # test_torch_serve_dense.py's cache bound
ROUTE_TIE = 1e-2          # a router margin the bf16 drift may close
SEQ = 64


def _np(t):
    return t.detach().float().numpy()


def _tokens(seed, B=2, S=SEQ, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ---------------------------------------------------------------------------
# moe_ffn alone, float32
# ---------------------------------------------------------------------------

def _jax_routing(p, x, spec):
    """The reference ``moe_ffn``'s routing lines: expert ids and the
    capacity mask of each (token, slot)."""
    C = jmoe.capacity(x.shape[0], spec)
    probs = jax.nn.softmax(x.astype(jnp.float32)
                           @ p["router"].astype(jnp.float32), axis=-1)
    _, topi = jax.lax.top_k(probs, spec.top_k)
    flat_e = topi.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, spec.num_experts, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - 1
    pos_in_e = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    return topi, pos_in_e < C


#: (experts, top-k, shared experts, tokens)
MOE_CASES = {"mixtral_like": (4, 2, 0, 64), "deepseek_like": (8, 3, 2, 48)}


def _moe_inputs(E, k, shared, T, D=32, F=24, seed=0):
    """Float32 leaves and tokens: dimension 0 of x is shifted up and the
    router's row 0 favours expert 0, so its queue overflows (drops); the
    last four tokens are zero, so their probs tie at 1/E."""
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, E)).astype(np.float32) * 0.3,
         "wg": rng.standard_normal((E, D, F)).astype(np.float32) * 0.2,
         "wu": rng.standard_normal((E, D, F)).astype(np.float32) * 0.2,
         "wo": rng.standard_normal((E, F, D)).astype(np.float32) * 0.2}
    p["router"][0, 0] = 4.0
    if shared:
        Fs = F * shared
        p["shared_wg"] = rng.standard_normal((D, Fs)).astype(np.float32) * .2
        p["shared_wu"] = rng.standard_normal((D, Fs)).astype(np.float32) * .2
        p["shared_wo"] = rng.standard_normal((Fs, D)).astype(np.float32) * .2
    x = rng.standard_normal((T, D)).astype(np.float32)
    x[:, 0] += 1.5
    x[-4:] = 0.0
    r = rng.standard_normal((T, D)).astype(np.float32)
    return p, x, r


@pytest.fixture(scope="module", params=sorted(MOE_CASES))
def moe_case(request):
    E, k, shared, T = MOE_CASES[request.param]
    p, x, r = _moe_inputs(E, k, shared, T)
    jspec = jmoe.MoESpec(num_experts=E, top_k=k, d_ff_expert=24,
                         num_shared=shared)
    tspec = moe.MoESpec(*jspec)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(p, x, jspec)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(p, x)
    jtopi, jkeep = jax.jit(lambda p, x: _jax_routing(p, x, jspec))(p, x)
    tp = {n: torch.from_numpy(a).requires_grad_(True) for n, a in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = moe.moe_ffn(tp, tx, tspec)
    loss = (ty * torch.from_numpy(r)).sum() + taux
    names = sorted(p)
    grads = torch.autograd.grad(loss, [tp[n] for n in names] + [tx])
    route = moe.route(tp, tx, tspec)
    return dict(spec=tspec, jy=np.asarray(jy), jaux=float(jaux),
                jg={**{n: np.asarray(jg[0][n]) for n in names},
                    "x": np.asarray(jg[1])},
                jtopi=np.asarray(jtopi), jkeep=np.asarray(jkeep),
                ty=_np(ty), taux=float(taux),
                tg=dict(zip(names + ["x"], [_np(g) for g in grads])),
                route=route, T=T)


def test_moe_routing_exact_with_drops_and_ties(moe_case):
    c = moe_case
    r = c["route"]
    np.testing.assert_array_equal(r.topi.numpy(), c["jtopi"])
    np.testing.assert_array_equal(r.keep.numpy(), c["jkeep"])
    k = c["spec"].top_k
    assert not r.keep.all(), "no (token, slot) was dropped"
    # the zero tokens tie: every prob 1/E, experts 0..k-1 as jax picks
    np.testing.assert_array_equal(r.topi[-4:].numpy(),
                                  np.tile(np.arange(k), (4, 1)))
    assert r.capacity == jmoe.capacity(c["T"], c["spec"])


def test_moe_outputs_and_aux_match(moe_case):
    c = moe_case
    np.testing.assert_allclose(c["ty"], c["jy"], rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(c["taux"], c["jaux"], rtol=0, atol=ATOL_F32)
    assert c["jaux"] > 0


def test_moe_gradients_match(moe_case):
    c = moe_case
    assert set(c["tg"]) == set(c["jg"])
    for name, w in c["jg"].items():
        assert _rel(c["tg"][name], w) <= ATOL_F32, name


def test_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    _, idx = moe.top_k(probs, 2)
    want = np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1])
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(idx.numpy(), [[0, 1], [1, 3]])


# ---------------------------------------------------------------------------
# MLA's training attention, float32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [16, 64])
def test_mla_attention_function_matches(chunk):
    """Partial rope over the last ``rope_dims``, a scale that is not the
    head dim's, k's rope part one head broadcast over H."""
    rng = np.random.default_rng(chunk)
    B, S, H, dn, dr = 2, 64, 4, 32, 16
    q = rng.standard_normal((B, S, H, dn + dr)).astype(np.float32)
    k = rng.standard_normal((B, S, H, dn + dr)).astype(np.float32)
    k[..., dn:] = k[:, :, :1, dn:]
    v = rng.standard_normal((B, S, H, dn + dr)).astype(np.float32)
    spec = dict(num_heads=H, num_kv_heads=H, head_dim=dn + dr,
                scale=0.3 * (dn + dr) ** -0.5, rope_dims=dr, q_chunk=chunk,
                kv_chunk=chunk)
    ref = np.asarray(jax.jit(
        lambda *a: jattn.chunked_attention(*a, jattn.AttnSpec(**spec)))(
        q, k, v))
    out = tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                  tattn.AttnSpec(**spec))
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=ATOL_ATTN)


def test_mla_attention_block_matches():
    """The whole MLA attention block of deepseek's smoke config in
    float32: the low-rank projections and their norms, the partial rope,
    the scale and v's padding to the qk head dim."""
    cfg = get_smoke_config("deepseek-v2-236b")
    jcfg = jget_smoke_config("deepseek-v2-236b")
    spec = tblocks.LayerSpec(kind="attn", moe=True, d_ff=cfg.d_ff)
    jspec = jblocks.LayerSpec(kind="attn", moe=True, d_ff=cfg.d_ff)
    p = tblocks.init_layer(cfg, spec, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    for n in ("q_norm", "kv_norm"):
        p["attn"][n] = torch.from_numpy(
            0.1 * rng.standard_normal(p["attn"][n].shape).astype(np.float32))
    x = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    jp = {"attn": {n: jnp.asarray(t.numpy()) for n, t in p["attn"].items()}}
    ref = np.asarray(jax.jit(lambda p, x: jblocks._attn_block_train(
        jcfg, jspec, p, x))(jp, x))
    out = tblocks._attn_block_train(cfg, spec, p, torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=ATOL_ATTN)


# ---------------------------------------------------------------------------
# both architectures: the bf16 forward, aux, gradients, routing
# ---------------------------------------------------------------------------

def _record_routing(monkeypatch, jlog, tlog):
    """(router probs, expert ids) of every MoE call, in layer order, on
    both sides: the reference's through a debug callback at its
    ``moe_ffn`` call site, the port's from ``moe.route``."""
    orig_j, orig_t = jblocks.moe_ffn, moe.route

    def jrec(p, x, spec):
        probs = jax.nn.softmax(x.astype(jnp.float32)
                               @ p["router"].astype(jnp.float32), axis=-1)
        topi, _ = _jax_routing(p, x, spec)
        jax.debug.callback(
            lambda a, b: jlog.append((np.asarray(a), np.asarray(b))),
            probs, topi, ordered=True)
        return orig_j(p, x, spec)

    def trec(p, x, spec):
        r = orig_t(p, x, spec)
        tlog.append((r.probs.detach().numpy(), r.topi.detach().numpy()))
        return r

    monkeypatch.setattr(jblocks, "moe_ffn", jrec)
    monkeypatch.setattr(moe, "route", trec)


def _flips(jlog, tlog):
    """Per MoE layer: the share of tokens routed to the same expert set
    (the slots' order changes nothing: each expert takes a token once),
    and the tokens whose sets differ, with the reference's margin between
    its k-th and (k+1)-th prob there."""
    out = []
    for (jp, ji), (_, ti) in zip(jlog, tlog):
        same = (np.sort(ji, -1) == np.sort(ti, -1)).all(-1)
        k = ji.shape[-1]
        srt = -np.sort(-jp, -1)
        margin = srt[:, k - 1] - srt[:, k]
        out.append((float(same.mean()), np.flatnonzero(~same),
                    margin[~same]))
    return out


def _force_routing(monkeypatch, topis):
    """The port's top-k returns the given expert ids, call by call (its
    own probs at them): the port routed as the reference routed."""
    it = iter(topis)

    def forced(probs, k):
        idx = torch.from_numpy(next(it)).long()
        assert idx.shape == (probs.shape[0], k)
        return torch.gather(probs, -1, idx), idx

    monkeypatch.setattr(moe, "top_k", forced)


@pytest.fixture(scope="module", params=ARCHS)
def arch_run(request):
    """On the same weights and tokens: one forward of each side with the
    routing recorded; then the port's forward and its gradient of the loss
    routed as the reference's (recorded in its forward and in its
    ``value_and_grad``), against the reference's."""
    arch = request.param
    jm, jp, tm, tp = _weights(arch, seed=5)
    toks = _tokens(6, S=SEQ + 1)
    n_moe = sum(s.moe for s in tm.specs)
    jlog, tlog = [], []
    with pytest.MonkeyPatch.context() as mp:
        _record_routing(mp, jlog, tlog)
        jl, jaux = jax.jit(jm.logits)(jp, jnp.asarray(toks[:, :-1]))
        (jloss, jmet), jg = jax.jit(jax.value_and_grad(
            jm.loss, has_aux=True))(jp, {"tokens": jnp.asarray(toks)})
        jax.effects_barrier()
        jlog_loss = jlog[n_moe:2 * n_moe]     # (remat replays come after)
        del jlog[n_moe:]
        tl, _ = tm.logits(tp, torch.from_numpy(toks[:, :-1]).long())
    with pytest.MonkeyPatch.context() as mp:
        _force_routing(mp, [t for _, t in jlog])
        tl_forced, taux = tm.logits(tp,
                                    torch.from_numpy(toks[:, :-1]).long())
    with pytest.MonkeyPatch.context() as mp:
        _force_routing(mp, [t for _, t in jlog_loss])
        leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
        tloss, tmet = tm.loss(tp, {"tokens": torch.from_numpy(toks)})
        grads = torch.autograd.grad(tloss, leaves)
    return dict(arch=arch, jm=jm, tm=tm, jl=np.asarray(jl), tl=_np(tl),
                tl_forced=_np(tl_forced), jaux=float(jaux),
                taux=float(taux), jlog=jlog, tlog=tlog,
                jloss=float(jloss), tloss=float(tloss),
                jmaux=float(jmet["aux"]), tmaux=float(tmet["aux"]),
                jg=[np.asarray(w) for w in jax.tree_util.tree_leaves(jg)],
                tg=[g.numpy() for g in grads],
                paths=[p for p in tree_leaves(tm.param_paths(tp))])


def test_arch_registered(arch_run):
    assert arch_run["arch"] in list_archs()
    cfg = get_smoke_config(arch_run["arch"])
    assert cfg.moe is not None and any(s.moe for s in LM(cfg).specs)


def test_arch_logits_and_aux_match(arch_run):
    """Logits within ATOL_BF16: on every token with the port routed as the
    reference, and with its own routing on every token no flip reaches (a
    token whose expert set flipped at a near-tie takes another expert:
    test_arch_routing_agreement holds those)."""
    r = arch_run
    assert r["tl"].shape == r["jl"].shape
    np.testing.assert_allclose(r["tl_forced"], r["jl"], rtol=0,
                               atol=ATOL_BF16 * np.abs(r["jl"]).max())
    B, S = r["jl"].shape[:2]
    alike = np.ones((B, S), bool)
    flips = _flips(r["jlog"], r["tlog"])
    for i, (_, flipped, _) in enumerate(flips):
        for b, t in zip(*np.divmod(flipped, S)):
            # a flip before the last MoE layer reaches the later
            # positions of its row through the next layers' attention
            if i < len(flips) - 1:
                alike[b, t:] = False
            alike[b, t] = False
    np.testing.assert_allclose(r["tl"][alike], r["jl"][alike], rtol=0,
                               atol=ATOL_BF16 * np.abs(r["jl"]).max())
    assert r["jaux"] > 0 and r["taux"] > 0
    np.testing.assert_allclose(r["taux"], r["jaux"], rtol=0, atol=ATOL_AUX)
    np.testing.assert_allclose(r["tmaux"], r["jmaux"], rtol=0, atol=ATOL_AUX)


def test_arch_routing_agreement(arch_run):
    """Expert sets equal on at least ROUTE_AGREE of the tokens of every
    MoE layer, and every token that differs a near-tie of the reference's
    router (its k-th and (k+1)-th probs within ROUTE_TIE)."""
    r = arch_run
    moe_layers = sum(s.moe for s in r["tm"].specs)
    assert len(r["jlog"]) == len(r["tlog"]) == moe_layers
    flips = _flips(r["jlog"], r["tlog"])
    print(f"{r['arch']} routing agreement by MoE layer: "
          f"{[f[0] for f in flips]}; flipped tokens "
          f"{[f[1].tolist() for f in flips]} at reference margins "
          f"{[f[2].tolist() for f in flips]}")
    for share, _, margin in flips:
        assert share >= ROUTE_AGREE
        assert (margin < ROUTE_TIE).all(), margin


def test_arch_gradients_match(arch_run):
    r = arch_run
    np.testing.assert_allclose(r["tloss"], r["jloss"], rtol=1e-3)
    assert len(r["tg"]) == len(r["jg"])
    assert any("router" in p for p in r["paths"])
    for path, g, w in zip(r["paths"], r["tg"], r["jg"], strict=True):
        assert g.shape == w.shape, path
        assert np.linalg.norm(g - w) <= GRAD_REL * np.linalg.norm(w), path


# ---------------------------------------------------------------------------
# the dense serve path
# ---------------------------------------------------------------------------

PROMPT, GEN, MAX_LEN = 12, 4, 32


def _bf16_weights(arch):
    jm, jp, tm, _ = _weights(arch, seed=7)
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jm, jp, tm, tp


def _ulp_bf16(a):
    """One bf16 ulp of each value (of the smallest normal at zero)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _hold_step(jl, tl):
    jl, tl = np.asarray(jl), tl.numpy()
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, rtol=0,
                               atol=ATOL_BF16 * np.abs(jl).max())
    top2 = np.sort(jl[:, -1], axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > MARGIN
    np.testing.assert_array_equal(tl[:, -1].argmax(-1)[clear],
                                  jl[:, -1].argmax(-1)[clear])
    return int(clear.sum())


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """The prompt through the reference's ``prefill`` (MLA: its
    token-by-token loop) or ``prefill_chunk`` (mixtral: one chunk) and the
    port's, then GEN decode steps of the reference's greedy tokens through
    both ``decode_step``s."""
    arch = request.param
    jm, jp, tm, tp = _bf16_weights(arch)
    toks = _tokens(9, S=PROMPT)
    jc = jm.init_cache(2, MAX_LEN)
    tc = tm.init_cache(2, MAX_LEN, device="cpu")
    steps = []
    if tm.supports_chunked_prefill():
        jl, jc = jax.jit(jm.prefill_chunk)(jp, jc, jnp.asarray(toks),
                                           jnp.int32(0))
        tl, tc = tm.prefill_chunk(tp, tc, torch.from_numpy(toks), 0)
        jl, tl = jl[:, -1:], tl[:, -1:]
    else:
        jl, jc = jax.jit(jm.prefill)(jp, jc, jnp.asarray(toks))
        tl, tc = tm.prefill(tp, tc, torch.from_numpy(toks))
    steps.append((jl, tl))
    jstep = jax.jit(jm.decode_step)
    for i in range(GEN):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)[:, None]).astype(
            np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.int32(PROMPT + i))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), PROMPT + i)
        steps.append((jl, tl))
    return dict(arch=arch, tm=tm, jm=jm, steps=steps, jc=jc, tc=tc)


def test_dense_serve_matches_reference(served):
    held = sum(_hold_step(jl, tl) for jl, tl in served["steps"])
    print(f"{served['arch']} greedy picks held: {held}")
    assert held > 0


def test_dense_serve_caches_match(served):
    """The first layer's cache (MLA: ``ckv`` and the roped ``kr``; GQA: K
    and V) within one bf16 ulp of each value; deeper layers, whose input
    carries the bf16 drift, within CACHE_RTOL of the leaf's magnitude (the
    bound of ``test_torch_serve_dense.py``); the ``pos`` arrays equal."""
    jleaves = jax.tree_util.tree_leaves_with_path(served["jc"])
    tleaves = tree_leaves(served["tc"])
    assert len(jleaves) == len(tleaves)
    names = set()
    for (path, w), g in zip(jleaves, tleaves):
        name = jax.tree_util.keystr(path)
        names.add(name.split("'")[-2])
        w, g = np.asarray(w), g.float().numpy()
        assert g.shape == w.shape, name
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        w = w.astype(np.float32)
        deep = w[1:] if name.startswith("[0]") else w
        if name.startswith("[0]"):
            assert (np.abs(g[0] - w[0]) <= _ulp_bf16(w[0])).all(), name
            g = g[1:]
        np.testing.assert_allclose(g, deep, rtol=0,
                                   atol=CACHE_RTOL * np.abs(w).max(),
                                   err_msg=name)
    want = {"ckv", "kr", "pos"} if served["tm"].cfg.mla else {"k", "v",
                                                              "pos"}
    assert names == want


def test_dense_cache_layout_and_token_bytes():
    """The MLA cache is the reference's ``init_layer_cache`` shapes: 1152
    bytes a token and layer at full width, against 2·H·hd·2 for GQA
    heads of the same count."""
    for arch in ARCHS:
        cfg = get_config(arch)
        tm, jm = LM(cfg), JLM(jget_config(arch))
        want = jax.eval_shape(lambda: jm.init_cache(1, 16))
        got = tm.init_cache(1, 16, device="cpu")
        jl = jax.tree_util.tree_leaves(want)
        tl = tree_leaves(got)
        assert [tuple(t.shape) for t in tl] == [w.shape for w in jl]
    ds = get_config("deepseek-v2-236b")
    assert serve_launcher.dense_token_bytes(ds) == 1152
    assert 2 * ds.num_heads * ds.resolved_head_dim * 2 == 65536
    mx = get_config("mixtral-8x22b")
    assert serve_launcher.dense_token_bytes(mx) == 2 * 8 * 128 * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_dense_serve_runs(arch):
    r = serve_launcher.serve(["--arch", arch, "--smoke", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "8", "--gen",
                              "3", "--max-len", "16", "--prefill-chunk",
                              "8"])
    assert r["path"] == "dense" and r["tokens"].shape == (2, 3)
    cfg = get_smoke_config(arch)
    assert r["token_bytes"] == serve_launcher.dense_token_bytes(cfg)
    assert r["prefill_chunk"] == (0 if cfg.mla else 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_refuses_with_the_reference_message(arch):
    cfg = get_smoke_config(arch)
    with pytest.raises(ValueError) as want:
        JEngine._validate(JLM(jget_smoke_config(arch)))
    with pytest.raises(ValueError) as got:
        Engine._validate(LM(cfg))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# training through the launcher; the fsdp plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,layers", [(a, None) for a in ARCHS]
                         + [("mixtral-8x22b", 1)])
def test_launcher_train_wire_bytes_match_reference(arch, layers):
    """``--smoke --device cpu`` on one gloo worker (with ``--layers`` its
    depth cut): finite loss, aux > 0, the fused path's 4 collective
    launches, and wire bytes equal to the reference's ``policy_stats`` on
    the reference's path sizes."""
    cut = ["--layers", str(layers)] if layers else []
    r = train_launcher.train(["--arch", arch, "--smoke", "--device", "cpu",
                              "--quant", "orq-9", "--bucket", "512",
                              "--steps", "2", "--batch", "2", "--seq", "32",
                              "--log-every", "1", *cut])
    assert all(np.isfinite(h["loss"]) and h["aux"] > 0
               for h in r["history"])
    assert r["collective_launches_per_step"] == 4
    jcfg = jget_smoke_config(arch)
    jm = JLM(dataclasses.replace(jcfg, num_layers=layers or jcfg.num_layers))
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    jps = list(zip(jax.tree_util.tree_leaves(jm.param_paths(shapes)),
                   [int(np.prod(x.shape))
                    for x in jax.tree_util.tree_leaves(shapes)]))
    want = jexchange.policy_stats(JPolicy.parse("orq-9", bucket_size=512),
                                  jps, 1)
    tm = LM(cut_depth(get_smoke_config(arch), layers))
    assert r["n_params"] == sum(n for _, n in jps)
    ap = tm.abstract_params()
    tps = [(p, int(t.numel())) for p, t in zip(
        tree_leaves(tm.param_paths(ap)), tree_leaves(ap))]
    assert tps == jps
    assert exchange.policy_stats(QuantPolicy.parse("orq-9", bucket_size=512),
                                 tps, 1) == want
    assert r["wire_bytes_per_worker"] == want[1]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_dp", [2, 8])
def test_fsdp_plan_matches_reference(arch, n_dp):
    """The fsdp dim of every leaf (MoE's (E, D, F) experts, MLA's low-rank
    projections) at full width, as the reference plans it."""
    jm = JLM(jget_config(arch))
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    want = jplan_sharding_shapes(jm, shapes, dp_axes=("data",),
                                 axis_sizes={"data": n_dp, "model": 1})
    tm = LM(get_config(arch))
    got = plan_sharding_shapes(tm, tm.abstract_params(), dp_axes=("data",),
                               axis_sizes={"data": n_dp})
    assert got.gather_dims == want.gather_dims
    assert any("wg" in p and d is not None
               for p, d in got.gather_dims.items())
