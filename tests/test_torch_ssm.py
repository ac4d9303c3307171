"""Mamba (jamba-v0.1-52b) in the port against the reference: the layer's
functions in float32, then the jamba ``SMOKE`` model (a Mamba layer, then
an attention layer with a Mixture-of-Experts FFN). The model-level
helpers here serve ``test_torch_rwkv.py`` too.

Weights are numpy draws in the reference's tree (``test_torch_archs.
_weights``: the port's ``LM.init`` with its zero leaves drawn away from
zero, checked against ``jax.eval_shape`` of the reference's init by path
and shape), handed to both sides.

Tolerances, with their reasons (every bound is on the largest |difference|
over the largest magnitude of the reference's value, unless stated):

* ``mamba_forward`` and the decode chain in float32, ATOL_F32 = 1e-5: the
  port runs the selective scan step by step, the reference an associative
  scan within each chunk of 256 (a throwaway probe read 2.5e-7).
* The bf16 forward: logits within ATOL_BF16 (2%, the bound of
  ``test_torch_moe.py``), the loss within rtol 1e-3, the gradients (of the
  logits' cross entropy) within GRAD_REL in relative norm per leaf, with
  jamba's MoE layer routed as the reference's (``test_torch_moe.
  _force_routing``; a near-tied router may flip under the bf16 drift).
* The dense serve (the prompt token by token, then decode steps): logits
  within ATOL_BF16, greedy picks equal wherever the reference's top-2
  margin exceeds MARGIN, both fed the reference's tokens; the cache's
  first-layer tensors that depend on no earlier mixer output (the conv
  window, RWKV's time-mix shift) within one bf16 ulp of each value, every
  other tensor within CACHE_RTOL (the bound of ``test_torch_serve_dense.
  py``).
* One orq-9 training step against the reference's on a one-device data
  mesh, both on the reference's gradient G of the model (the loss
  ``sum(p * G)``, as ``test_torch_train_ef.py`` does): the model's own
  gradients are held above, and an orq-9 step turns their bf16
  differences into level flips (``test_torch_train.py`` held its
  lm-100m step within 0.2); on the same gradient the update is within
  SHARED_UPDATE_RTOL in relative norm per leaf and the loss within
  SHARED_LOSS_RTOL.
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
from repro.models import blocks as jblocks
from repro.models import ssm as jssm
from repro.optim.schedule import constant_lr as jconstant_lr
from repro.train import step as jstep
from repro.train.state import TrainState as JTrainState
from repro_torch.configs.base import get_config, get_smoke_config, list_archs
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import prng
from repro_torch.core.comm import exchange
from repro_torch.core.policy import QuantPolicy
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import LM, ssm
from repro_torch.optim.schedule import constant_lr
from repro_torch.serve import Engine
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.utils.pytree import tree_leaves
from test_torch_archs import _weights
from test_torch_moe import _flips, _force_routing, _record_routing
from test_torch_train import world1  # noqa: F401
from test_torch_train_ef import _JLinear, _Linear
from torch_test_env import port_test_env  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

ARCH = "jamba-v0.1-52b"
ATOL_F32 = 1e-5
ATOL_BF16 = 0.02          # of the logits' largest magnitude
GRAD_REL = 2e-2
SHARED_UPDATE_RTOL = 1e-6    # test_torch_train_ef.py's bounds
SHARED_LOSS_RTOL = 1e-5
MARGIN = 2 * 0.06         # test_torch_serve_dense.py's greedy margin
CACHE_RTOL = 2 ** -6      # test_torch_serve_dense.py's cache bound
ROUTE_AGREE = 0.9
ROUTE_TIE = 1e-2
SEQ = 64
LR = 0.05


def _np(t):
    return t.detach().float().numpy()


def _tokens(seed, B=2, S=SEQ, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tensors(tree):
    return {k: (torch.from_numpy(np.array(v)) if not isinstance(v, dict)
                else _tensors(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the layer's functions, float32
# ---------------------------------------------------------------------------

D, N = 32, 8


def _mamba_inputs(seed=0):
    """Float32 layer params (no norm) of a Mamba layer of width D, with a
    spread ``dt_bias`` so that dt varies over channels."""
    rng = np.random.default_rng(seed)
    spec = jssm.MambaSpec(d_model=D, d_state=N)
    d_in, r = spec.d_inner, spec.rank
    p = {"in_proj": rng.standard_normal((D, 2 * d_in)) / np.sqrt(D),
         "conv_w": 0.1 * rng.standard_normal((4, d_in)),
         "conv_b": 0.1 * rng.standard_normal(d_in),
         "x_proj": rng.standard_normal((d_in, r + 2 * N)) / np.sqrt(d_in),
         "dt_proj": rng.standard_normal((r, d_in)) / np.sqrt(r),
         "dt_bias": -4.6 + 2.0 * rng.standard_normal(d_in),
         "A_log": np.log(np.tile(np.arange(1, N + 1)[None], (d_in, 1))),
         "D": 1.0 + 0.1 * rng.standard_normal(d_in),
         "out_proj": rng.standard_normal((d_in, D)) / np.sqrt(d_in)}
    return spec, {k: v.astype(np.float32) for k, v in p.items()}


def test_mamba_spec_rank():
    assert ssm.MambaSpec(d_model=4096).rank == 256
    assert ssm.MambaSpec(d_model=128).rank == 8
    assert ssm.MambaSpec(d_model=4096).d_inner == 8192
    from repro_torch.models import blocks
    spec = blocks.mamba_spec(get_config(ARCH))
    assert tuple(spec) == tuple(jblocks.mamba_spec(jget_config(ARCH)))


@pytest.mark.parametrize("S", [300, 64], ids=["S300_two_chunks",
                                              "S64_one_chunk"])
def test_mamba_forward_matches(S):
    """S = 300 pads to two chunks of 256 in the reference; S = 64 runs
    inside one."""
    spec, p = _mamba_inputs(S)
    x = np.random.default_rng(S + 1).standard_normal((2, S, D)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, x: jssm.mamba_forward(p, x, spec))(
        p, x))
    got = ssm.mamba_forward(_tensors(p), torch.from_numpy(x),
                            ssm.MambaSpec(*spec))
    assert got.shape == want.shape
    assert _err(_np(got), want) <= ATOL_F32


def test_mamba_decode_chain_matches():
    """12 tokens through ``mamba_decode_step`` from a zero state: each
    output and the final ``ssm`` state and ``conv`` window."""
    spec, p = _mamba_inputs(7)
    tspec, tp = ssm.MambaSpec(*spec), _tensors(p)
    x = np.random.default_rng(8).standard_normal((3, 12, D)).astype(
        np.float32)
    jst = jssm.init_mamba_state(3, spec, jnp.float32)
    tst = ssm.init_mamba_state(3, tspec, torch.float32, device="cpu")
    assert {k: v.shape for k, v in jst.items()} == {
        k: tuple(v.shape) for k, v in tst.items()}
    step = jax.jit(lambda p, x, s: jssm.mamba_decode_step(p, x, s, spec))
    for i in range(12):
        jy, jst = step(p, x[:, i:i + 1], jst)
        ty, tst = ssm.mamba_decode_step(tp, torch.from_numpy(
            x[:, i:i + 1]), tst, tspec)
        assert _err(_np(ty), np.asarray(jy)) <= ATOL_F32, i
    for k in ("ssm", "conv"):
        assert _err(_np(tst[k]), np.asarray(jst[k])) <= ATOL_F32, k
    # the chain reproduces the port's own forward over the same tokens
    full = ssm.mamba_forward(tp, torch.from_numpy(x), tspec)
    y = torch.cat([ssm.mamba_decode_step(tp, torch.from_numpy(
        x[:, i:i + 1]), s, tspec)[0] for i, s in enumerate(
        _states(tp, x, tspec))], dim=1)
    assert _err(_np(y), _np(full)) <= ATOL_F32


def _states(tp, x, spec):
    """The decode states before each token of x."""
    st = ssm.init_mamba_state(x.shape[0], spec, torch.float32, device="cpu")
    out = []
    for i in range(x.shape[1]):
        out.append(st)
        _, st = ssm.mamba_decode_step(tp, torch.from_numpy(x[:, i:i + 1]),
                                      st, spec)
    return out


# ---------------------------------------------------------------------------
# the smoke model: forward, loss, gradients (helpers shared with
# test_torch_rwkv.py)
# ---------------------------------------------------------------------------

def _ce(lg, targets, mask, xp):
    """Masked mean next-token cross entropy of logits lg (B, S, V) against
    targets (B, S), for ``xp`` jnp or torch."""
    if xp is jnp:
        lse = jax.nn.logsumexp(lg, axis=-1)
        tgt = jnp.take_along_axis(lg, targets[..., None], axis=-1)[..., 0]
    else:
        lse = torch.logsumexp(lg, dim=-1)
        tgt = torch.gather(lg, -1, targets[..., None])[..., 0]
    return ((lse - tgt) * mask).sum() / mask.sum()


def model_run(arch, record=None, flagged=None):
    """On the same weights and tokens (B, SEQ + 1): the reference's logits,
    with every MoE call's routing and what ``record(mp, log)`` installs
    recorded; the port's logits with its own routing and routed as the
    reference's; the loss's value (the port's ``LM.loss``, the reference's
    from its logits); and both gradients of the cross entropy of the
    logits over the tokens that ``flagged(log, B, S)`` does not mark (its
    marks reach no kept token: an ill-conditioned path has no gradient),
    the port routed as the reference's ``value_and_grad`` routed."""
    jm, jp, tm, tp = _weights(arch, seed=5)
    toks = _tokens(6, S=SEQ + 1)
    B, S = toks.shape
    n_moe = sum(s.moe for s in tm.specs)
    jlog, tlog, extra = [], [], []
    with pytest.MonkeyPatch.context() as mp:
        _record_routing(mp, jlog, tlog)
        if record is not None:
            record(mp, extra)
        jl, _ = jax.jit(jm.logits)(jp, jnp.asarray(toks))
        jax.effects_barrier()
        tl, _ = tm.logits(tp, torch.from_numpy(toks).long())
    jl = np.asarray(jl)
    excluded = (np.zeros((B, S), bool) if flagged is None
                else flagged(extra, B, S))
    mask = (~excluded[:, :-1]).astype(np.float32)
    tgt = toks[:, 1:]
    jlog_grad = []
    with pytest.MonkeyPatch.context() as mp:
        _record_routing(mp, jlog_grad, [])
        jce, jg = jax.jit(jax.value_and_grad(lambda p: _ce(
            jm.logits(p, jnp.asarray(toks))[0][:, :-1], jnp.asarray(tgt),
            jnp.asarray(mask), jnp)))(jp)
        jax.effects_barrier()
    del jlog_grad[n_moe:]                       # the remat replays
    with pytest.MonkeyPatch.context() as mp:
        _force_routing(mp, [t for _, t in jlog])
        tl_forced, _ = tm.logits(tp, torch.from_numpy(toks).long())
    with pytest.MonkeyPatch.context() as mp:
        _force_routing(mp, [t for _, t in jlog])
        _, met = tm.loss(tp, {"tokens": torch.from_numpy(toks)})
    with pytest.MonkeyPatch.context() as mp:
        _force_routing(mp, [t for _, t in jlog_grad])
        leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
        tce = _ce(tm.logits(tp, torch.from_numpy(toks).long())[0][:, :-1],
                  torch.from_numpy(tgt).long(), torch.from_numpy(mask),
                  torch)
        grads = torch.autograd.grad(tce, leaves)
    ones = np.ones_like(mask)
    return dict(arch=arch, jm=jm, tm=tm, toks=toks, jl=jl, tl=_np(tl),
                params=jax.tree_util.tree_map(np.asarray, jp),
                tl_forced=_np(tl_forced), jlog=jlog, tlog=tlog,
                extra=extra, excluded=excluded,
                jloss=float(_ce(jnp.asarray(jl[:, :-1]), jnp.asarray(tgt),
                                jnp.asarray(ones), jnp)),
                tloss=float(met["nll"]), jce=float(jce),
                tce=float(tce.detach()),
                jg=jax.tree_util.tree_map(np.asarray, jg),
                tg=[g.numpy() for g in grads],
                paths=list(tree_leaves(tm.param_paths(tp))))


def full_width_params(arch):
    """The full-width parameter count (``LM.abstract_params``; the smoke
    tree's paths and shapes are held against the reference's by
    ``_weights``)."""
    return sum(t.numel() for t in tree_leaves(
        LM(get_config(arch)).abstract_params()))


def hold_logits(r):
    """Logits within ATOL_BF16 with the port routed as the reference, and
    with its own routing on the tokens no routing flip reaches, on every
    token the run's ``flagged`` did not mark; the loss (every token)
    within rtol 1e-3."""
    jl = r["jl"]
    B, S = jl.shape[:2]
    keep = ~r["excluded"]
    bound = ATOL_BF16 * np.abs(jl).max()
    assert r["tl"].shape == jl.shape
    np.testing.assert_allclose(r["tl_forced"][keep], jl[keep], rtol=0,
                               atol=bound)
    flips = _flips(r["jlog"], r["tlog"])
    for i, (share, flipped, margin) in enumerate(flips):
        assert share >= ROUTE_AGREE and (margin < ROUTE_TIE).all(), margin
        for b, t in zip(*np.divmod(flipped, S)):
            if i < len(flips) - 1:
                keep[b, t:] = False
            keep[b, t] = False
    np.testing.assert_allclose(r["tl"][keep], jl[keep], rtol=0, atol=bound)
    np.testing.assert_allclose(r["tloss"], r["jloss"], rtol=1e-3)
    print(f"{r['arch']}: logits routed alike within "
          f"{_err(r['tl_forced'][keep], jl[keep]):.3g} of the largest "
          f"(bound {ATOL_BF16}); loss {r['tloss']:.6f} against "
          f"{r['jloss']:.6f}")
    return int((~keep).sum())


def hold_grads(r):
    np.testing.assert_allclose(r["tce"], r["jce"], rtol=1e-3)
    jg = jax.tree_util.tree_leaves(r["jg"])
    assert len(r["tg"]) == len(jg) == len(r["paths"])
    rels = {}
    for path, g, w in zip(r["paths"], r["tg"], jg, strict=True):
        assert g.shape == w.shape, path
        rels[path] = _rel(g, w)
    worst = max(rels, key=rels.get)
    print(f"{r['arch']}: gradients within {rels[worst]:.3g} in relative "
          f"norm ({worst}; bound {GRAD_REL})")
    assert all(v <= GRAD_REL for v in rels.values()), rels


@pytest.fixture(scope="module")
def jamba_run():
    return model_run(ARCH)


def test_jamba_registered_and_params_tree(jamba_run):
    assert ARCH in list_archs()
    assert full_width_params(ARCH) == 4_358_066_176
    cfg = get_config(ARCH)
    specs = LM(cfg).specs
    # the reference's MoE flag (i % 2 == 1) falls on Mamba layers only in
    # the full pattern, whose Mamba layer has no FFN: no MoE runs there
    assert [s.kind for s in specs[:8]] == list(cfg.layer_pattern)
    assert all(s.kind == "mamba" for s in specs if s.moe)
    smoke = LM(get_smoke_config(ARCH)).specs
    assert [(s.kind, s.moe) for s in smoke] == [("mamba", False),
                                               ("attn", True)]


def test_jamba_logits_and_loss_match(jamba_run):
    assert len(jamba_run["jlog"]) == 1           # the attention layer's MoE
    hold_logits(jamba_run)


def test_jamba_gradients_match(jamba_run):
    assert any("A_log" in p for p in jamba_run["paths"])
    hold_grads(jamba_run)


# ---------------------------------------------------------------------------
# the dense serve path
# ---------------------------------------------------------------------------

PROMPT, GEN, MAX_LEN = 12, 4, 32


def _ulp_bf16(a):
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def serve_run(arch):
    """The prompt through the reference's token-by-token ``prefill`` and
    the port's, then GEN decode steps of the reference's greedy tokens
    through both ``decode_step``s, on bf16 weights."""
    jm, jp, tm, _ = _weights(arch, seed=7)
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    toks = _tokens(9, S=PROMPT)
    jc = jm.init_cache(2, MAX_LEN)
    tc = tm.init_cache(2, MAX_LEN, device="cpu")
    assert not tm.supports_chunked_prefill()
    jl, jc = jax.jit(jm.prefill)(jp, jc, jnp.asarray(toks))
    tl, tc = tm.prefill(tp, tc, torch.from_numpy(toks))
    steps = [(np.asarray(jl), tl.numpy())]
    jstep_ = jax.jit(jm.decode_step)
    for i in range(GEN):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)[:, None]).astype(
            np.int32)
        jl, jc = jstep_(jp, jc, jnp.asarray(tok), jnp.int32(PROMPT + i))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), PROMPT + i)
        steps.append((np.asarray(jl), tl.numpy()))
    return dict(arch=arch, tm=tm, steps=steps, jc=jc, tc=tc)


def hold_serve_logits(served):
    held = 0
    for jl, tl in served["steps"]:
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl, jl, rtol=0,
                                   atol=ATOL_BF16 * np.abs(jl).max())
        top2 = np.sort(jl[:, -1], axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > MARGIN
        np.testing.assert_array_equal(tl[:, -1].argmax(-1)[clear],
                                      jl[:, -1].argmax(-1)[clear])
        held += int(clear.sum())
    print(f"{served['arch']} greedy picks held: {held}")
    assert held > 0


def hold_serve_caches(served, first_exact):
    """Every cache leaf of the reference's tree, by path: int leaves
    equal; the first layer's ``first_exact`` leaves within one bf16 ulp;
    every other float leaf within CACHE_RTOL of its magnitude."""
    jleaves = jax.tree_util.tree_leaves_with_path(served["jc"])
    tleaves = tree_leaves(served["tc"])
    assert len(jleaves) == len(tleaves)
    names = set()
    for (path, w), g in zip(jleaves, tleaves):
        name = jax.tree_util.keystr(path)
        leaf = name.split("'")[-2]
        names.add(leaf)
        assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype), name
        w, g = np.asarray(w), g.float().numpy()
        assert g.shape == w.shape, name
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        w = w.astype(np.float32)
        if leaf in first_exact and name.startswith("[0]['pos0']"):
            assert (np.abs(g[0] - w[0]) <= _ulp_bf16(w[0])).all(), name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=CACHE_RTOL * np.abs(w).max(),
                                   err_msg=name)
    return names


@pytest.fixture(scope="module")
def jamba_served():
    return serve_run(ARCH)


def test_jamba_dense_serve_matches_reference(jamba_served):
    hold_serve_logits(jamba_served)


def test_jamba_dense_serve_caches_match(jamba_served):
    names = hold_serve_caches(jamba_served, first_exact={"conv"})
    assert names == {"conv", "ssm", "k", "v", "pos"}


def decode_matches_forward(arch):
    """The port's token-by-token prefill reproduces its own training
    forward's last logits, as the reference's ``test_arch_smoke.
    test_decode_matches_forward`` holds it (MoE with a drop-free
    capacity)."""
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    m = LM(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_tokens(1, B=1, S=12, vocab=cfg.vocab_size))
    lg_fwd, _ = m.logits(params, toks)
    lg_last, _ = m.prefill(params, m.init_cache(1, 33, device="cpu"), toks)
    err = float((lg_last[:, 0] - lg_fwd[:, -1]).abs().max())
    scale = float(lg_fwd[:, -1].abs().max()) + 1e-6
    assert err / scale < 0.05, (arch, err, scale)


def test_jamba_decode_matches_forward():
    decode_matches_forward(ARCH)


# ---------------------------------------------------------------------------
# byte accounting, refusals, launchers, one training step
# ---------------------------------------------------------------------------

#: the dense path's bytes per layer at full width, and ``init_cache(8,
#: 128)`` in all
FULL_BYTES = {"jamba-v0.1-52b": (4096, 573_440, 145_229_824),
              "rwkv6-3b": (0, 665_600, 170_393_600)}


@pytest.mark.parametrize("arch", sorted(FULL_BYTES))
def test_dense_state_and_token_bytes_match_reference(arch):
    """The dense path's byte accounting against the reference's
    ``init_cache`` shapes (``jax.eval_shape``, nothing allocated): K/V
    bytes a token of an attention layer, a recurrent layer's state bytes
    a sequence, and ``init_cache(8, 128)`` in all."""
    cfg = get_config(arch)
    token, state, total = FULL_BYTES[arch]
    assert serve_launcher.dense_token_bytes(cfg) == token
    assert serve_launcher.dense_state_bytes(cfg) == state
    jm = JLM(jget_config(arch))
    cache = jax.eval_shape(lambda: jm.init_cache(8, 128))
    by = {}
    for path, s in jax.tree_util.tree_leaves_with_path(cache):
        name = jax.tree_util.keystr(path).split("'")[-2]
        by[name] = by.get(name, 0) + int(np.prod(s.shape)) * s.dtype.itemsize
    assert sum(by.values()) == total
    specs = LM(cfg).specs
    n_rec = sum(s.kind in ("mamba", "rwkv") for s in specs)
    n_attn = len(specs) - n_rec
    assert by.get("k", 0) + by.get("v", 0) == n_attn * 8 * 128 * token
    assert total - sum(by.get(k, 0) for k in ("k", "v", "pos")) == (
        n_rec * 8 * state)


@pytest.mark.parametrize("arch", sorted(FULL_BYTES))
def test_paged_engine_refuses_recurrent_stacks(arch):
    from repro.serve import Engine as JEngine

    with pytest.raises(ValueError) as want:
        JEngine._validate(JLM(jget_smoke_config(arch)))
    with pytest.raises(ValueError) as got:
        Engine._validate(LM(get_smoke_config(arch)))
    assert str(got.value) == str(want.value)
    assert "GQA attention stacks only" in str(got.value)


def launchers_run(arch):
    """``--smoke --device cpu``: the dense serve (token by token, its
    byte accounting) and two orq-9 steps on one gloo worker (4 collective
    launches a step, wire bytes equal to the reference's ``policy_stats``
    on the reference's path sizes)."""
    cfg = get_smoke_config(arch)
    r = serve_launcher.serve(["--arch", arch, "--smoke", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "6", "--gen",
                              "3", "--max-len", "16", "--prefill-chunk",
                              "4"])
    assert r["path"] == "dense" and r["tokens"].shape == (2, 3)
    assert r["prefill_chunk"] == 0
    assert r["token_bytes"] == serve_launcher.dense_token_bytes(cfg)
    assert r["state_bytes"] == serve_launcher.dense_state_bytes(cfg) > 0
    assert r["cache_bytes"] == sum(
        t.numel() * t.element_size() for t in tree_leaves(
            LM(cfg).init_cache(2, 16, device="cpu")))
    t = train_launcher.train(["--arch", arch, "--smoke", "--device", "cpu",
                              "--quant", "orq-9", "--bucket", "512",
                              "--steps", "2", "--batch", "2", "--seq", "32",
                              "--log-every", "1"])
    assert all(np.isfinite(h["loss"]) for h in t["history"])
    assert t["collective_launches_per_step"] == 4 and t["replicas_in_sync"]
    jm = JLM(jget_smoke_config(arch))
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    jps = list(zip(jax.tree_util.tree_leaves(jm.param_paths(shapes)),
                   [int(np.prod(x.shape))
                    for x in jax.tree_util.tree_leaves(shapes)]))
    want = jexchange.policy_stats(JPolicy.parse("orq-9", bucket_size=512),
                                  jps, 1)
    tm = LM(cfg)
    ap = tm.abstract_params()
    tps = [(p, int(x.numel())) for p, x in zip(
        tree_leaves(tm.param_paths(ap)), tree_leaves(ap))]
    assert tps == jps and t["n_params"] == sum(n for _, n in jps)
    assert exchange.policy_stats(QuantPolicy.parse("orq-9", bucket_size=512),
                                 tps, 1) == want
    assert t["wire_bytes_per_worker"] == want[1]
    return t


def test_jamba_launchers_run():
    t = launchers_run(ARCH)
    assert all(h["aux"] > 0 for h in t["history"])   # the MoE layer's


def train_step_run(arch, params, G, batch=2, seq=32):
    """One orq-9 step, the port's ``make_train_step`` on one gloo worker
    against the reference's step on ``jax.make_mesh((1,), ("data",))``,
    from ``params`` with zero momentum (the reference's replicated
    ``init_state`` without its init), both on the loss ``sum(p * G)``
    (``test_torch_train_ef.py``'s models; params and G params-shaped trees
    of numpy arrays, G the reference's gradient of the model), so that
    both steps exchange the same gradient."""
    jcfg, cfg = jget_smoke_config(arch), get_smoke_config(arch)
    jm = _JLinear(jcfg, jax.tree_util.tree_map(jnp.asarray, G))
    tm = _Linear(cfg, params_from_jax(G, device="cpu"))
    mesh = jax.make_mesh((1,), ("data",))
    pol = QuantPolicy.parse("orq-9", bucket_size=512)
    tcfg = jstep.TrainConfig(policy=JPolicy.parse("orq-9", bucket_size=512),
                             mode="replicated")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = JTrainState(params=jp,
                        opt=jstep._make_optimizer(tcfg).init(jp),
                        step=jnp.int32(0))
    before = jax.tree_util.tree_map(np.asarray, state)
    toks = _tokens(11, B=batch, S=seq)
    fn, _ = jstep.make_train_step(jm, mesh, tcfg, lr_fn=jconstant_lr(LR))
    after, metrics = fn(state, {"tokens": jnp.asarray(toks)},
                        jax.random.key(0))
    tfn = make_train_step(tm, TrainConfig(policy=pol), constant_lr(LR))
    tstate, tmetrics = tfn(state_from_jax(before, device="cpu"),
                           {"tokens": torch.from_numpy(toks)}, prng.key(0))
    return dict(before=before.params,
                after=jax.tree_util.tree_map(np.asarray, after.params),
                jloss=float(metrics["loss"]), tloss=float(tmetrics["loss"]),
                tparams=tstate.params, paths=list(tree_leaves(
                    tm.param_paths(tstate.params))))


def hold_train_step(r):
    """The loss ``sum(p * G)`` within SHARED_LOSS_RTOL, the update of every
    leaf within SHARED_UPDATE_RTOL in relative norm (a leaf the reference
    leaves as it was, bit-equal)."""
    np.testing.assert_allclose(r["tloss"], r["jloss"], rtol=SHARED_LOSS_RTOL)
    for path, p, p0, w in zip(r["paths"], tree_leaves(r["tparams"]),
                              jax.tree_util.tree_leaves(r["before"]),
                              jax.tree_util.tree_leaves(r["after"]),
                              strict=True):
        assert p.shape == w.shape, path
        if np.array_equal(w, p0):
            np.testing.assert_array_equal(p.numpy(), w, err_msg=path)
        else:
            assert _rel(p.numpy() - p0, w - p0) <= SHARED_UPDATE_RTOL, path


def test_jamba_train_step_matches_reference(world1, jamba_run):
    hold_train_step(train_step_run(ARCH, jamba_run["params"],
                                   jamba_run["jg"]))
