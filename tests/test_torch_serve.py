"""The port's quantized-KV serving slice against the JAX engine, end to end.

Both packages start from the same weights (the reference's smoke
``LM.init``, cast to bf16 as its launcher does, carried over with
``params_from_jax``) and serve with the same seeds, page tables and pools.

Tolerances, with their reasons:

* The first attention layer's quantized pages are bit-equal: its K/V rows
  are a bf16 projection of the same embeddings, and everything after is
  exact given equal inputs.
* Logits (magnitude <= ~4): bf16 matmuls round differently in XLA and
  PyTorch (1-2 bf16 ulps, ~0.03 here, after two layers). With the bf16
  KV pages that is all: ``atol 0.06``. With orq-9 pages, those ulps move
  a few of the 4-bit random-rounding decisions of later layers (each a
  whole level step), so ``atol 0.25`` for one forward from equal pools,
  and ``atol 0.5`` over a whole greedy run, where each engine's pages
  keep their own flips.
* Greedy tokens of a random-weight model have top-2 margins down to ~0.1,
  so a decision can flip; agreement is required on the fixed prompts used
  here and the rate is printed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import LM as JaxLM
from repro.serve import Engine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve.kv_cache import KVQuantSpec as JaxKVQuantSpec
from repro.serve.kv_cache import token_bytes_ratio as jax_token_bytes_ratio
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import LM
from repro_torch.models.attention import masked_decode_attention
from repro_torch.models.blocks import (_apply_norm, _ffn_train, _gqa_project,
                                       attn_spec)
from repro_torch.models.layers import apply_rope
from repro_torch.models.model import map_tree
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.kv_cache import KVQuantSpec, token_bytes_ratio
from torch_test_env import port_test_env  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

ATOL_BF16 = 0.06
ATOL_ORQ = 0.25
ATOL_ORQ_RUN = 0.5
AGREE_PROMPTS = (101, 103, 104, 107)   # fixed prompts (numpy seeds)


def _prompt(seed, n=8, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


@pytest.fixture(scope="module")
def weights():
    jm = JaxLM(jax_smoke_config("lm-100m"))
    jp = jax.jit(jm.init)(jax.random.key(0))
    jp = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, jp)
    np_tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = params_from_jax(np_tree, device="cpu")
    return jm, jp, np_tree, LM(get_smoke_config("lm-100m")), tp


def _cfg(cls, kv, **kw):
    base = dict(kv_quant=kv, page_size=4, max_batch=4, max_pages_per_seq=4,
                prefill_chunk=8)
    base.update(kw)
    return cls(**base)


@pytest.fixture(scope="module")
def greedy_runs(weights):
    """One JAX and one port engine run over the fixed prompts (shared so
    the reference traces its forward once)."""
    jm, jp, _, tm, tp = weights
    je = JaxEngine(jm, jp, _cfg(JaxServeConfig, "orq-9", record_logits=True))
    te = Engine(tm, tp, _cfg(ServeConfig, "orq-9", record_logits=True),
                device="cpu")
    prompts = [_prompt(s) for s in AGREE_PROMPTS]
    jr = [je.submit(p, max_new=6) for p in prompts]
    tr = [te.submit(p, max_new=6) for p in prompts]
    jres, tres = je.run(), te.run()
    return [(jres[a], tres[b]) for a, b in zip(jr, tr)], je, te


def test_params_from_jax_carries_the_tree(weights):
    _, _, np_tree, _, tp = weights
    flat_j = jax.tree_util.tree_leaves(np_tree)
    flat_t = jax.tree_util.tree_leaves(
        map_tree(lambda t: t.float().numpy(), tp))
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.astype(np.float32), b)
    g = tp["groups"][0]["pos0"]
    assert g["attn"]["wq"].dtype == torch.bfloat16
    assert g["attn"]["wq"].shape[0] == 2       # the stacked repeats axis


def _pools_to_port(jpools, tpools):
    """Copy the reference's pools into the port's, in place."""
    for jg, tg in zip(jpools, tpools):
        for pos, leaves in jg.items():
            for k, leaf in leaves.items():
                a = np.asarray(leaf)
                if a.dtype == np.uint32:
                    a = a.view(np.int32)
                elif a.dtype.name == "bfloat16":
                    tg[pos][k].copy_(params_from_jax(a, device="cpu"))
                    continue
                tg[pos][k].copy_(torch.from_numpy(np.array(a)))


@pytest.mark.parametrize("kv,atol", [("orq-9", ATOL_ORQ),
                                     ("bf16", ATOL_BF16)])
def test_forward_matches_jax(weights, kv, atol):
    """One prefill chunk and three teacher-forced decode steps through both
    engines' forward, from the same pools before each call."""
    jm, jp, _, tm, tp = weights
    je = JaxEngine(jm, jp, _cfg(JaxServeConfig, kv))
    te = Engine(tm, tp, _cfg(ServeConfig, kv), device="cpu")
    i64 = dict(dtype=torch.int64)
    table = np.zeros((4, 4), np.int32)
    table[0, :3] = [1, 2, 3]
    table[2, :2] = [4, 5]
    seeds = np.asarray([1234, 0, 99, 0], np.int32)
    # prefill sequence 0 (8 tokens), then sequence 2 (5 tokens)
    for slot, n in ((0, 8), (2, 5)):
        toks = _prompt(slot, n)[None]
        args = (table[slot:slot + 1], np.asarray([0], np.int32),
                seeds[slot:slot + 1], toks)
        _pools_to_port(je.pools, te.pools)
        lj, nj, je.pools = je._fwd(je.params, je.pools,
                                   *map(jnp.asarray, args))
        lt, nt, _ = te._forward(te.params, te.pools,
                                *[torch.as_tensor(a, **i64) for a in args])
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=atol,
                                   rtol=0)
        if kv == "orq-9" and slot == 0:
            # layer 0's pages are bit-equal (pages 1, 2 hold the chunk)
            for name in ("kw", "klv", "vw", "vlv"):
                a = np.asarray(je.pools[0]["pos0"][name][0, 1:3])
                b = te.pools[0]["pos0"][name][0, 1:3].numpy()
                np.testing.assert_array_equal(
                    b.view(np.uint32) if a.dtype == np.uint32 else b, a)
    pos = np.asarray([8, 0, 5, 0], np.int32)
    for step in range(3):
        toks = np.asarray([[7 + step], [0], [300 - step], [0]], np.int32)
        dec_table = table.copy()
        dec_table[[1, 3]] = 0                      # inactive: trash page
        args = (dec_table, pos + step, seeds, toks)
        _pools_to_port(je.pools, te.pools)
        lj, nj, je.pools = je._fwd(je.params, je.pools,
                                   *map(jnp.asarray, args))
        lt, nt, _ = te._forward(te.params, te.pools,
                                *[torch.as_tensor(a, **i64) for a in args])
        for slot in (0, 2):
            np.testing.assert_allclose(lt[slot].numpy(),
                                       np.asarray(lj)[slot], atol=atol,
                                       rtol=0)


def test_greedy_tokens_agree(greedy_runs):
    pairs, _, _ = greedy_runs
    agree = sum(int(a == b) for j, t in pairs
                for a, b in zip(j.generated, t.generated))
    total = sum(len(j.generated) for j, _ in pairs)
    print(f"greedy orq-9 token agreement: {agree}/{total}")
    for j, t in pairs:
        assert t.generated == j.generated
        assert len(t.logits) == len(j.logits)
        np.testing.assert_allclose(np.stack(t.logits), np.stack(j.logits),
                                   atol=ATOL_ORQ_RUN, rtol=0)


def test_cache_bytes_match_jax(greedy_runs):
    _, je, te = greedy_runs
    assert te.cache_bytes() == je.cache_bytes()
    assert te.kvq.token_bytes() == je.kvq.token_bytes()


@pytest.mark.parametrize("scheme", ["orq-9", "orq-5", "orq-3", "orq-17",
                                    "bf16", "bingrad-b"])
def test_token_bytes_full_width(scheme):
    """lm-100m accounting equals the reference's exactly: orq-9 is 840 of
    3072 bytes per token-layer (ratio 0.2734)."""
    mc = get_config("lm-100m")
    args = (scheme, mc.num_kv_heads, mc.resolved_head_dim)
    t, j = KVQuantSpec(*args), JaxKVQuantSpec(*args)
    assert t.token_bytes() == j.token_bytes()
    assert token_bytes_ratio(t) == jax_token_bytes_ratio(j)
    if scheme == "orq-9":
        assert t.token_bytes() == 840
        assert round(token_bytes_ratio(t), 4) == 0.2734


def test_mixed_equals_alone(weights):
    """Staggered arrivals in a shared batch give each request the tokens
    it gets alone (the rounding stream is keyed on content)."""
    _, _, _, tm, tp = weights
    lens = (8, 4, 12)
    prompts = [_prompt(23 + i, n) for i, n in enumerate(lens)]
    cfg = ServeConfig(kv_quant="orq-9", page_size=4, max_batch=3,
                      max_pages_per_seq=8, prefill_chunk=4)
    mixed = Engine(tm, tp, cfg, device="cpu")
    rids = [mixed.submit(p, max_new=5, arrival=2 * i)
            for i, p in enumerate(prompts)]
    mres = mixed.run()
    alone = Engine(tm, tp, cfg, device="cpu")
    for i, p in enumerate(prompts):
        rid = alone.submit(p, max_new=5)
        assert mres[rids[i]].generated == alone.run()[rid].generated
    assert alone.sched.alloc.num_free == cfg.resolved_num_pages - 1


def _dense_logits(model, params, tokens):
    """Last-position logits of a whole sequence through the port's layers
    with dense (unpaged) bf16 K/V and ``masked_decode_attention``."""
    mc = model.cfg
    x = model._cast(params["embed"])[tokens[None]]
    S = tokens.shape[0]
    qpos = torch.arange(S)[None]
    mask = qpos[:, :, None] >= torch.arange(S)[None, None, :]
    g = model.groups[0]
    for rep in range(g.repeats):
        p = model._cast_tree(map_tree(lambda t: t[rep],
                                      params["groups"][0]["pos0"]))
        spec = g.unit[0]
        asp = attn_spec(mc, spec)
        q, k, v = _gqa_project(mc, p["attn"], _apply_norm(mc, p["norm1"], x))
        q = apply_rope(q, qpos, asp.rope_theta)
        k = apply_rope(k, qpos, asp.rope_theta)
        o = masked_decode_attention(q, k, v, mask, asp)
        h = x + o.reshape(1, S, -1) @ p["attn"]["wo"]
        x = h + _ffn_train(mc, spec, p["ffn"],
                           _apply_norm(mc, p["norm2"], h))[0]
    x = model._final_norm(model._cast(params["final_norm"]), x[:, -1:])
    return (x @ model._head(params)).float()[0, 0]


def test_bf16_escape_hatch_matches_dense_attention(weights):
    """The bf16 pages, gathered through the page table, give the logits of
    a dense causal pass over the same tokens."""
    _, _, _, tm, tp = weights
    te = Engine(tm, tp, _cfg(ServeConfig, "bf16", record_logits=True),
                device="cpu")
    prompt = _prompt(17)
    rid = te.submit(prompt, max_new=4)
    st = te.run()[rid]
    seq = list(prompt)
    for tok, lg in zip(st.generated, st.logits):
        want = _dense_logits(tm, te.params, torch.tensor(seq))
        np.testing.assert_allclose(lg, want.numpy(), atol=ATOL_BF16, rtol=0)
        assert tok == int(torch.argmax(want))
        seq.append(tok)


def test_unported_schemes_raise(weights):
    """Every scheme with a fused encode serves now (BinGrad-b and SignSGD
    round deterministically and draw no rounding stream; the random-round
    schemes do); ``fp`` KV pages, which have no fused encode, still
    raise."""
    _, _, _, tm, tp = weights
    for scheme, rr in (("bingrad-b", False), ("signsgd", False),
                       ("terngrad", True), ("qsgd-5", True)):
        eng = Engine(tm, tp, _cfg(ServeConfig, scheme), device="cpu")
        assert eng._rr == rr
    with pytest.raises(ValueError, match="fused one-pass encode"):
        Engine(tm, tp, _cfg(ServeConfig, "fp"), device="cpu")
