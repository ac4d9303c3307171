"""whisper-base (encoder, cross-attention, layer norm) in the port against
the reference: the layer functions, the chunked attention with keys of
another length than the queries, the ``SMOKE`` model's encoder, logits,
loss and gradients, the dense serve path over the warmed cache, the byte
and parameter accounting at full width, the sharding plan and one train
step whose batch carries the frame embeddings.

Weights are numpy draws in the reference's tree (``test_torch_archs.
_weights``: the port's ``LM.init`` with its zero leaves drawn away from
zero, checked against ``jax.eval_shape`` of the reference's init by path
and shape), handed to both sides; tokens and frame embeddings are numpy
draws from fixed seeds.

Tolerances, with their reasons (a bound "of the largest" is on the
largest |difference| over the largest magnitude of the reference's
value):

* Float32 functions (``layer_norm``, ``dense_mlp``, the attention):
  ATOL_F32 = 1e-5 of the largest; the attention adds a ragged last key
  chunk where the reference pads and masks, so its sums run in another
  order.
* The bf16 model (encoder output, logits, the warmed cross K/V, the
  served logits): ATOL_BF16 = 2% of the largest. bf16 matmuls round
  differently in XLA and PyTorch (1-2 ulps) and the drift grows through
  the layers. The loss within rtol 1e-3; every gradient, the encoder's
  too, within GRAD_REL = 2e-2 in relative norm.
* The train step: on the reference's gradient G of the model (the loss
  ``sum(p * G)``, ``test_torch_train_ef.py``'s models) both steps
  exchange the same gradient, so the exchange and the SGD step are held
  bit-equal.
* Counts (parameters, cache bytes, wire bytes, the fsdp layout): exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core import comm as jcomm
from repro.core.comm import exchange as jexchange
from repro.core.policy import QuantPolicy as JPolicy
from repro.models import LM as JLM
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.optim.schedule import constant_lr as jconstant_lr
from repro.train import step as jstep
from repro.train.state import TrainState as JTrainState
from repro.train.step import plan_sharding_shapes as jplan_sharding_shapes
from repro_torch.configs.base import get_config, get_smoke_config, list_archs
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import prng
from repro_torch.core.comm import exchange
from repro_torch.core.comm.fsdp_exchange import FsdpExchange
from repro_torch.core.policy import QuantPolicy
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import LM
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.optim.schedule import constant_lr
from repro_torch.train import TrainConfig, init_state, make_train_step
from repro_torch.train.step import plan_sharding_shapes
from repro_torch.utils.pytree import tree_leaves
from test_torch_archs import _weights
from test_torch_train import world1  # noqa: F401
from test_torch_train_ef import _JLinear, _Linear
from torch_test_env import port_test_env  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

ARCH = "whisper-base"
ATOL_F32 = 1e-5
ATOL_BF16 = 0.02          # of the largest magnitude
GRAD_REL = 2e-2
MARGIN = 2 * 0.06         # test_torch_serve_dense.py's greedy margin
SEQ = 32
PROMPT, GEN, MAX_LEN = 12, 4, 32
LR = 0.05
#: full width and SMOKE: parameters, ``init_cache(8, 128)`` bytes
FULL = dict(n_params=97_981_440, cache=160_041_984, cross=3_072_000)
SMOKE_COUNTS = dict(n_params=233_600, cache=648_192, cross=7_680)
#: orq-9 and BinGrad-b wire bytes a worker and step of the smoke model at
#: bucket 512, L = 1
SMOKE_WIRE = {"orq-9": 266_888, "bingrad-b": 65_808}


def _np(t):
    return t.detach().float().numpy()


def _err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _tokens(seed, B=2, S=SEQ + 1):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def _frames(seed, B=2, cfg=None):
    cfg = cfg or get_smoke_config(ARCH)
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder.num_frames, cfg.d_model))).astype(np.float32)


# ---------------------------------------------------------------------------
# the functions, float32
# ---------------------------------------------------------------------------

def test_layer_norm_matches():
    rng = np.random.default_rng(0)
    x = (3.0 + rng.standard_normal((2, 7, 64))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    want = np.asarray(jax.jit(jlayers.layer_norm)(x, scale, bias, 1e-5))
    got = tlayers.layer_norm(_t(x), _t(scale), _t(bias), 1e-5).numpy()
    print(f"layer_norm f32 within {_err(got, want):.3g} of the largest")
    assert _err(got, want) <= ATOL_F32
    # bf16 in, bf16 out: the same formula, the same bits
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(jlayers.layer_norm)(xb, scale, bias, 1e-5)
                      ).astype(np.float32)
    got = _np(tlayers.layer_norm(_t(x).bfloat16(), _t(scale), _t(bias),
                                 1e-5))
    np.testing.assert_array_equal(got, want)


def _mlp_params(rng, D=64, F=128):
    p = {"wi": rng.standard_normal((D, F)) / np.sqrt(D),
         "bi": 0.1 * rng.standard_normal(F),
         "wo": rng.standard_normal((F, D)) / np.sqrt(F),
         "bo": 0.1 * rng.standard_normal(D)}
    return {k: v.astype(np.float32) for k, v in p.items()}


def test_dense_mlp_matches():
    """float32 within ATOL_F32; in bf16 (the leaves as the model casts
    them), the pre-activation's bias add and gelu's ops rounded one by
    one as XLA rounds them: within ATOL_BF16, most values bit-equal."""
    rng = np.random.default_rng(1)
    p = _mlp_params(rng)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    want = np.asarray(jax.jit(jlayers.dense_mlp)(p, x))
    got = tlayers.dense_mlp({k: _t(v) for k, v in p.items()}, _t(x)).numpy()
    assert _err(got, want) <= ATOL_F32
    jb = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p.items()}
    want = np.asarray(jax.jit(jlayers.dense_mlp)(
        jb, jnp.asarray(x).astype(jnp.bfloat16))).astype(np.float32)
    got = _np(tlayers.dense_mlp({k: _t(v).bfloat16() for k, v in p.items()},
                                _t(x).bfloat16()))
    same = float((got == want).mean())
    print(f"dense_mlp f32 ok; bf16 within {_err(got, want):.3g} of the "
          f"largest, {same:.4f} of the values bit-equal")
    assert _err(got, want) <= ATOL_BF16 and same >= 0.9


@pytest.mark.parametrize("S,T,chunk,causal,rope", [
    (12, 30, 32, False, False),    # whisper smoke's cross-attention: 1 chunk
    (20, 75, 32, False, False),    # 3 key chunks, the last ragged (11)
    (75, 75, 32, False, True),     # the encoder's self-attention: roped
    (40, 40, 16, True, True),      # causal, S == T (the decoder's)
], ids=["cross_one_chunk", "cross_ragged", "encoder_self", "causal"])
def test_chunked_attention_matches(S, T, chunk, causal, rope):
    rng = np.random.default_rng(S + T + chunk)
    B, H, KV, hd = 2, 4, 2, 16
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    kw = dict(num_heads=H, num_kv_heads=KV, head_dim=hd, causal=causal,
              use_rope=rope, q_chunk=chunk, kv_chunk=chunk)
    want = np.asarray(jax.jit(lambda q, k, v: jattn.chunked_attention(
        q, k, v, jattn.AttnSpec(**kw)))(q, k, v))
    got = tattn.chunked_attention(_t(q), _t(k), _t(v),
                                  tattn.AttnSpec(**kw)).numpy()
    assert got.shape == want.shape == (B, S, H, hd)
    print(f"attention S {S} T {T} chunk {chunk}: within "
          f"{_err(got, want):.3g} of the largest")
    assert _err(got, want) <= ATOL_F32


# ---------------------------------------------------------------------------
# the smoke model
# ---------------------------------------------------------------------------

def _ce(lg, targets, xp):
    if xp is jnp:
        lse = jax.nn.logsumexp(lg, axis=-1)
        tgt = jnp.take_along_axis(lg, targets[..., None], axis=-1)[..., 0]
    else:
        lse = torch.logsumexp(lg, dim=-1)
        tgt = torch.gather(lg, -1, targets[..., None])[..., 0]
    return (lse - tgt).mean()


@pytest.fixture(scope="module")
def model_run():
    """On the same weights, tokens (2, SEQ + 1) and frames (2, 30, 64):
    both encoders' outputs, logits, losses and the gradients of the
    logits' cross entropy; the gather paths each side's loss reads."""
    jm, jp, tm, tp = _weights(ARCH, seed=5)
    toks, enc = _tokens(6), _frames(7)
    jtoks, jenc = jnp.asarray(toks), jnp.asarray(enc)
    ttoks, tenc = _t(toks).long(), _t(enc)

    def jce_fn(p):
        lg = jm.logits(p, jtoks, enc_embeds=jenc)[0]
        return _ce(lg[:, :-1], jtoks[:, 1:], jnp), lg

    # one compile: the encoder alone, then the logits and the gradients
    jenc_out, ((jce, jl), jg) = jax.jit(lambda p: (
        jm.encode(p, jenc), jax.value_and_grad(jce_fn, has_aux=True)(p)))(jp)
    jenc_out = np.asarray(jenc_out).astype(np.float32)
    with torch.no_grad():
        tenc_out = _np(tm.encode(tp, tenc))
        tl, _ = tm.logits(tp, ttoks, enc_embeds=tenc)
        tloss, _ = tm.loss(tp, {"tokens": ttoks, "enc_embeds": tenc})
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tce = _ce(tm.logits(tp, ttoks, enc_embeds=tenc)[0][:, :-1],
              ttoks[:, 1:], torch)
    grads = torch.autograd.grad(tce, leaves)
    for t in leaves:
        t.requires_grad_(False)

    def recorder(seen):
        def gather(path, leaf, salt):
            seen.add(path)
            return leaf
        return gather

    jseen, tseen = set(), set()
    jax.eval_shape(lambda p: jm.loss(p, {"tokens": jtoks, "enc_embeds": jenc},
                                     recorder(jseen))[0], jp)
    with torch.no_grad():
        tm.loss(tp, {"tokens": ttoks, "enc_embeds": tenc}, recorder(tseen))
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, toks=toks, enc=enc,
                jenc_out=jenc_out, tenc_out=tenc_out, jl=np.asarray(jl),
                tl=_np(tl), jloss=float(jce), tloss=float(tloss),
                jce=float(jce), tce=float(tce.detach()),
                jg=jax.tree_util.tree_leaves(jg),
                tg=[g.numpy() for g in grads],
                paths=list(tree_leaves(tm.param_paths(tp))),
                jpaths=jax.tree_util.tree_leaves(jm.param_paths(jp)),
                jseen=jseen, tseen=tseen)


def test_registered_and_params_tree(model_run):
    """The config is the reference's; the tree carried across by
    ``convert.params_from_jax`` holds the encoder subtree leaf for leaf."""
    assert ARCH in list_archs()
    for get, jget in ((get_config, jget_config),
                      (get_smoke_config, jget_smoke_config)):
        t, j = get(ARCH), jget(ARCH)
        assert {f.name: getattr(t, f.name) for f in dataclasses.fields(t)
                if f.name != "encoder"} == {
            f.name: getattr(j, f.name) for f in dataclasses.fields(j)
            if f.name != "encoder"}
        assert (t.encoder.num_layers, t.encoder.num_frames) == (
            j.encoder.num_layers, j.encoder.num_frames)
    tp, jp = model_run["tp"], model_run["jp"]
    jenc = jax.tree_util.tree_leaves_with_path(jp["encoder"])
    tenc = tree_leaves(tp["encoder"])
    assert len(jenc) == len(tenc) > 0
    for (path, w), g in zip(jenc, tenc, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))


def test_param_count_and_paths(model_run):
    """233,600 parameters at smoke and 97,981,440 at full width (the smoke
    tree's paths and shapes are the reference's, ``_weights``);
    ``param_paths`` equal to the
    reference's leaf for leaf, and the loss's gather hook called on the
    same set of paths on both sides."""
    assert sum(t.numel() for t in tree_leaves(
        LM(get_smoke_config(ARCH)).abstract_params())) == \
        SMOKE_COUNTS["n_params"]
    assert sum(t.numel() for t in tree_leaves(LM(
        get_config(ARCH)).abstract_params())) == FULL["n_params"]
    assert model_run["paths"] == model_run["jpaths"]
    assert "enc/['pos_embed']" in model_run["paths"]
    assert "enc/['final_norm']['scale']" in model_run["paths"]
    assert "final_norm['bias']" in model_run["paths"]
    assert model_run["tseen"] == model_run["jseen"] == (
        set(model_run["paths"]))


def test_encode_matches(model_run):
    got, want = model_run["tenc_out"], model_run["jenc_out"]
    assert got.shape == want.shape == (2, 30, 64)
    print(f"encode: within {_err(got, want):.3g} of the largest "
          f"(bound {ATOL_BF16})")
    assert _err(got, want) <= ATOL_BF16


def test_logits_and_loss_match(model_run):
    jl, tl = model_run["jl"], model_run["tl"]
    assert tl.shape == jl.shape == (2, SEQ + 1, 512)
    print(f"logits within {_err(tl, jl):.3g} of the largest (bound "
          f"{ATOL_BF16}); loss {model_run['tloss']:.6f} against "
          f"{model_run['jloss']:.6f}")
    assert _err(tl, jl) <= ATOL_BF16
    np.testing.assert_allclose(model_run["tloss"], model_run["jloss"],
                               rtol=1e-3)


def test_gradients_match(model_run):
    np.testing.assert_allclose(model_run["tce"], model_run["jce"],
                               rtol=1e-3)
    rels = {}
    for path, g, w in zip(model_run["paths"], model_run["tg"],
                          model_run["jg"], strict=True):
        assert g.shape == w.shape, path
        rels[path] = _rel(g, w)
    enc = max((p for p in rels if p.startswith("enc/")), key=rels.get)
    worst = max(rels, key=rels.get)
    print(f"gradients within {rels[worst]:.3g} in relative norm ({worst}); "
          f"the encoder's within {rels[enc]:.3g} ({enc}); bound {GRAD_REL}")
    assert all(v <= GRAD_REL for v in rels.values()), rels


# ---------------------------------------------------------------------------
# the dense serve path over the warmed cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """The reference's ``warm_cache`` (f32 weights, as it projects) and
    its bf16 ``prefill_chunk`` / ``decode_step`` over the warmed cache,
    against the port's, the decode fed the reference's greedy tokens."""
    jm, jp, tm, tp = _weights(ARCH, seed=8)
    toks, enc = _tokens(9, S=PROMPT), _frames(10)
    jc = jax.jit(jm.warm_cache)(jp, jm.init_cache(2, MAX_LEN),
                                jnp.asarray(enc).astype(jnp.bfloat16))
    tc = tm.warm_cache(tp, tm.init_cache(2, MAX_LEN, device="cpu"),
                       _t(enc).bfloat16())
    warmed = [(np.asarray(jc[0][f"pos0"][k]).astype(np.float32),
               _np(tc[0]["pos0"][k])) for k in ("xk", "xv")]
    jpb = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    tpb = params_from_jax(jax.tree_util.tree_map(np.asarray, jpb),
                          device="cpu")
    jl, jc = jax.jit(jm.prefill_chunk)(jpb, jc, jnp.asarray(toks),
                                       jnp.int32(0))
    tl, tc = tm.prefill_chunk(tpb, tc, _t(toks), 0)
    steps = [(np.asarray(jl), tl.numpy())]
    jdecode = jax.jit(jm.decode_step)
    for i in range(GEN):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)[:, None]).astype(
            np.int32)
        jl, jc = jdecode(jpb, jc, jnp.asarray(tok), jnp.int32(PROMPT + i))
        tl, tc = tm.decode_step(tpb, tc, _t(tok), PROMPT + i)
        steps.append((np.asarray(jl), tl.numpy()))
    return dict(warmed=warmed, steps=steps, jc=jc, tc=tc, tm=tm)


def test_warm_cache_matches(served):
    for name, (want, got) in zip(("xk", "xv"), served["warmed"]):
        assert got.shape == want.shape == (2, 2, 30, 4, 16)
        print(f"warm_cache {name}: within {_err(got, want):.3g} of the "
              f"largest, {(got == want).mean():.4f} bit-equal")
        assert _err(got, want) <= ATOL_BF16


def test_prefill_chunk_and_decode_match(served):
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
    print(f"served logits within {max(_err(t, j) for j, t in served['steps']):.3g}"
          f" of the largest; greedy picks held: {held}")
    # the cross K/V are read, not written, by the decode
    jleaves = jax.tree_util.tree_leaves_with_path(served["jc"])
    tleaves = tree_leaves(served["tc"])
    assert len(jleaves) == len(tleaves)
    for (path, w), g in zip(jleaves, tleaves):
        name = jax.tree_util.keystr(path)
        assert tuple(g.shape) == np.asarray(w).shape, name
        if np.asarray(w).dtype == np.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)


# ---------------------------------------------------------------------------
# accounting: cache bytes, wire bytes, the fsdp plan and layout
# ---------------------------------------------------------------------------

def _cache_bytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def test_init_cache_bytes_match_reference():
    """``init_cache(8, 128)``: 648,192 B at smoke, 160,041,984 B at full
    width (the reference's from ``jax.eval_shape``, nothing allocated);
    the cross K/V are 3,072,000 B a sequence and decoder layer."""
    tm = LM(get_smoke_config(ARCH))
    assert _cache_bytes(tm.init_cache(8, 128, device="cpu")) == \
        SMOKE_COUNTS["cache"]
    for cfg, jcfg, want in ((get_smoke_config(ARCH), jget_smoke_config(ARCH),
                             SMOKE_COUNTS),
                            (get_config(ARCH), jget_config(ARCH), FULL)):
        jm = JLM(jcfg)
        cache = jax.eval_shape(lambda: jm.init_cache(8, 128))
        assert sum(int(np.prod(s.shape)) * s.dtype.itemsize
                   for s in jax.tree_util.tree_leaves(cache)) == want["cache"]
        assert serve_launcher.dense_cross_bytes(cfg) == want["cross"]
        assert serve_launcher.dense_token_bytes(cfg) == (
            2 * cfg.num_kv_heads * cfg.resolved_head_dim * 2)
        per_layer = 8 * (128 * serve_launcher.dense_token_bytes(cfg)
                         + want["cross"]) + 128 * 4
        assert cfg.num_layers * per_layer == want["cache"]


def _path_sizes_j(jm):
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    return list(zip(jax.tree_util.tree_leaves(jm.param_paths(shapes)),
                    [int(np.prod(x.shape))
                     for x in jax.tree_util.tree_leaves(shapes)]))


@pytest.mark.parametrize("scheme", sorted(SMOKE_WIRE))
def test_policy_stats_wire_bytes(scheme):
    tm = LM(get_smoke_config(ARCH))
    ap = tm.abstract_params()
    tps = [(p, int(x.numel())) for p, x in zip(
        tree_leaves(tm.param_paths(ap)), tree_leaves(ap))]
    jps = _path_sizes_j(JLM(jget_smoke_config(ARCH)))
    assert tps == jps
    want = jexchange.policy_stats(JPolicy.parse(scheme, bucket_size=512),
                                  jps, 1)
    got = exchange.policy_stats(QuantPolicy.parse(scheme, bucket_size=512),
                                tps, 1)
    assert got == want and got[1] == SMOKE_WIRE[scheme]


def test_fsdp_plan_and_layout_at_six_workers():
    """At n_dp = 6 the smoke model's d = 64 leaves have no dim that 6
    divides and land in replicated groups, while the 30-frame
    ``pos_embed`` shards: the plan and the ``FsdpExchange`` layout equal
    the reference's mesh-free ones, both group kinds present."""
    jm = JLM(jget_smoke_config(ARCH))
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    jplan = jplan_sharding_shapes(jm, shapes, dp_axes=("data",),
                                  axis_sizes={"data": 6, "model": 1})
    tm = LM(get_smoke_config(ARCH))
    ap = tm.abstract_params()
    plan = plan_sharding_shapes(tm, ap, dp_axes=("data",),
                                axis_sizes={"data": 6})
    assert plan.full_shard_dims() == jplan.full_shard_dims()
    assert plan.gather_dims == jplan.gather_dims
    assert plan.full_shard_dims()["enc/['pos_embed']"] == 0
    assert plan.full_shard_dims()["final_norm['scale']"] is None
    pol = "orq-5"
    jfex = jcomm.FsdpExchange.build(
        JPolicy.parse(pol), shapes, ("data",), paths=jplan.paths,
        shard_dims=jplan.full_shard_dims(), n_shards=6)
    fex = FsdpExchange.build(
        QuantPolicy.parse(pol), ap, ("data",), paths=plan.paths,
        shard_dims=plan.full_shard_dims(), n_shards=6)
    groups = [(g.cfg.name, g.sharded, g.size, g.leaf_ids)
              for g in fex.layout.groups]
    assert groups == [(g.cfg.name, g.sharded, g.size, g.leaf_ids)
                      for g in jfex.layout.groups]
    assert {g[1] for g in groups} == {True, False}
    assert [(s.path, s.shape, s.dim, s.offset, s.size)
            for s in fex.layout.slots] == \
        [(s.path, s.shape, s.dim, s.offset, s.size)
         for s in jfex.layout.slots]
    assert (fex.collective_launches(), fex.wire_bytes_per_worker(),
            fex.ef_group_sizes()) == (jfex.collective_launches(),
                                      jfex.wire_bytes_per_worker(),
                                      jfex.ef_group_sizes())
    print(f"fsdp at 6: groups {groups}")


# ---------------------------------------------------------------------------
# training: the batch carries the frame embeddings
# ---------------------------------------------------------------------------

def test_train_step_matches_reference(world1, model_run):
    """One replicated orq-9 step, the port's ``make_train_step`` on one
    gloo worker against the reference's on ``jax.make_mesh((1,),
    ("data",))``, from the same params with zero momentum, both on the
    reference's gradient G of the model and a batch of tokens and frame
    embeddings: params and momentum bit-equal."""
    jp = jax.tree_util.tree_map(np.asarray, model_run["jp"])
    G = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jp), model_run["jg"])
    jm = _JLinear(jget_smoke_config(ARCH),
                  jax.tree_util.tree_map(jnp.asarray, G))
    tm = _Linear(get_smoke_config(ARCH), params_from_jax(G, device="cpu"))
    tcfg = jstep.TrainConfig(policy=JPolicy.parse("orq-9", bucket_size=512),
                             mode="replicated")
    params = jax.tree_util.tree_map(jnp.asarray, jp)
    state = JTrainState(params=params,
                        opt=jstep._make_optimizer(tcfg).init(params),
                        step=jnp.int32(0))
    before = jax.tree_util.tree_map(np.asarray, state)
    toks, enc = _tokens(11, S=16), _frames(12)
    fn, _ = jstep.make_train_step(jm, jax.make_mesh((1,), ("data",)), tcfg,
                                  lr_fn=jconstant_lr(LR))
    after, metrics = fn(state, {"tokens": jnp.asarray(toks),
                                "enc_embeds": jnp.asarray(enc)},
                        jax.random.key(0))
    tfn = make_train_step(tm, TrainConfig(policy=QuantPolicy.parse(
        "orq-9", bucket_size=512)), constant_lr(LR))
    tstate, tmetrics = tfn(state_from_jax(before, device="cpu"),
                           {"tokens": _t(toks), "enc_embeds": _t(enc)},
                           prng.key(0))
    # the loss sum(p * G) adds its products in another order
    np.testing.assert_allclose(float(tmetrics["loss"]),
                               float(metrics["loss"]), rtol=1e-5)
    for what, got, want in (("params", tstate.params, after.params),
                            ("momentum", tstate.opt, after.opt)):
        for path, g, w in zip(model_run["paths"], tree_leaves(got),
                              jax.tree_util.tree_leaves(want), strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{what} {path}")
    assert tfn.launches_and_bytes(1) == (4, SMOKE_WIRE["orq-9"])


@pytest.mark.parametrize("kw", [
    dict(mode="replicated"), dict(mode="replicated", fused_exchange=False),
    dict(mode="fsdp"), dict(mode="fsdp", fused_exchange=False)],
    ids=["replicated", "per_leaf", "fsdp", "fsdp_per_leaf"])
def test_every_step_path_carries_the_frames(world1, kw):
    """The replicated, per-leaf and fsdp steps each reach the encoder
    through the batch: the step's loss is the model's loss on the same
    batch, not on other frames."""
    cfg = get_smoke_config(ARCH)
    model = LM(cfg)
    tcfg = TrainConfig(policy=QuantPolicy.parse("orq-9", bucket_size=512),
                       **kw)
    fn = make_train_step(model, tcfg, constant_lr(LR))
    state = init_state(model, tcfg, seed=0, device="cpu", step=fn)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = _t(_tokens(13, S=16))
    with torch.no_grad():
        want, other = (model.loss(params, {"tokens": toks,
                                           "enc_embeds": _t(_frames(s))})[0]
                       for s in (14, 15))
    _, metrics = fn(state, {"tokens": toks, "enc_embeds": _t(_frames(14))},
                    prng.key(0))
    assert float(metrics["loss"]) == pytest.approx(float(want), rel=1e-6)
    assert float(want) != float(other)
