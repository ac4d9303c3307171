"""The port's paged engine with BinGrad-b and SignSGD KV pages against the
JAX engine, end to end (the orq-9 and bf16 pages are in
``test_torch_serve.py``).

Both packages start from the same weights (the reference's smoke
``LM.init`` in bf16, carried over with ``params_from_jax``) and serve with
the same seeds, page tables and pools.

Tolerances, with their reasons:

* Pages. BinGrad-b's levels are conditional means of a K/V row (row sums
  over counts), SignSGD's the mean |v|: float-close across XLA and
  PyTorch, within ``RTOL`` of the row's max |v|. The words are the exact
  threshold of the port's own levels; a bit may differ from the
  reference's only at an element within that tolerance of the threshold.
  The first layer's K/V rows are the same bf16 projection in both.
* Logits: bf16 matmuls round differently in XLA and PyTorch (1-2 bf16
  ulps). From the second layer on, that moves K/V values across their
  row's 1-bit threshold, and each such flip moves a value by a whole
  level gap (b₁ − b₋₁), more than a 4-bit random-rounding flip does
  (``ATOL_ORQ`` 0.25 in ``test_torch_serve.py``): ``ATOL_BIN`` for one
  forward from equal pools, ``ATOL_BIN_RUN`` over a greedy run, where each
  engine's pages keep their own flips.
* Greedy tokens: the port's tokens equal the reference's up to the first
  step where the reference's top-2 logit margin is below 2·ATOL_BIN_RUN
  (there the stated logit tolerance admits a flip, and after it the two
  histories differ); the agreement is printed.
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
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import encode
from repro_torch.models import LM
from repro_torch.serve import Engine, ServeConfig
from torch_test_env import port_test_env  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

SCHEMES = ("bingrad-b", "signsgd")
RTOL = 1e-5
ATOL_BIN = 0.5
ATOL_BIN_RUN = 0.75
AGREE_PROMPTS = (101, 103, 104, 107)


def _prompt(seed, n=8, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


@pytest.fixture(scope="module")
def weights():
    jm = JaxLM(jax_smoke_config("lm-100m"))
    jp = jax.jit(jm.init)(jax.random.key(0))
    jp = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jm, jp, LM(get_smoke_config("lm-100m")), tp


def _cfg(cls, kv, **kw):
    base = dict(kv_quant=kv, page_size=4, max_batch=4, max_pages_per_seq=4,
                prefill_chunk=8)
    base.update(kw)
    return cls(**base)


def _pools_to_port(jpools, tpools):
    for jg, tg in zip(jpools, tpools):
        for pos, leaves in jg.items():
            for k, leaf in leaves.items():
                a = np.asarray(leaf)
                if a.dtype == np.uint32:
                    a = a.view(np.int32)
                tg[pos][k].copy_(torch.from_numpy(np.array(a)))


def _check_pages(jpool, tpool, pages):
    """Layer 0's pages: levels within RTOL of the level magnitude (which
    bounds the row's |v| from below), words bit-equal on the rows whose
    levels agree."""
    for w, lv in (("kw", "klv"), ("vw", "vlv")):
        jl = np.asarray(jpool[lv][0, pages]).reshape(-1, 2)
        tl = tpool[lv][0, pages].numpy().reshape(-1, 2)
        jw = np.asarray(jpool[w][0, pages])
        jw = jw.reshape(-1, jw.shape[-1])
        tw = tpool[w][0, pages].numpy().view(np.uint32)
        tw = tw.reshape(-1, tw.shape[-1])
        scale = np.abs(jl).max(axis=1, keepdims=True)
        assert np.all(np.abs(tl - jl) <= 4 * RTOL * scale)
        same = (tl == jl).all(axis=1)
        np.testing.assert_array_equal(tw[same], jw[same])
        print(f"{w}: {int((~same).sum())} of {len(same)} rows with levels "
              f"an ulp apart")


@pytest.mark.parametrize("kv", SCHEMES)
def test_forward_matches_jax(weights, kv):
    """One prefill chunk and three teacher-forced decode steps through both
    engines' forward, from the same pools before each call."""
    jm, jp, tm, tp = weights
    je = JaxEngine(jm, jp, _cfg(JaxServeConfig, kv))
    te = Engine(tm, tp, _cfg(ServeConfig, kv), device="cpu")
    assert not te._rr                       # deterministic: no rbits drawn
    i64 = dict(dtype=torch.int64)
    table = np.zeros((4, 4), np.int32)
    table[0, :3] = [1, 2, 3]
    table[2, :2] = [4, 5]
    seeds = np.asarray([1234, 0, 99, 0], np.int32)
    errs = []
    for slot, n in ((0, 8), (2, 5)):
        toks = _prompt(slot, n)[None]
        args = (table[slot:slot + 1], np.asarray([0], np.int32),
                seeds[slot:slot + 1], toks)
        _pools_to_port(je.pools, te.pools)
        lj, _, je.pools = je._fwd(je.params, je.pools,
                                  *map(jnp.asarray, args))
        lt, _, _ = te._forward(te.params, te.pools,
                               *[torch.as_tensor(a, **i64) for a in args])
        errs.append(float(np.abs(lt.numpy() - np.asarray(lj)).max()))
        if slot == 0:                       # pages 1, 2 hold the chunk
            _check_pages(je.pools[0]["pos0"], te.pools[0]["pos0"], [1, 2])
    pos = np.asarray([8, 0, 5, 0], np.int32)
    for step in range(3):
        toks = np.asarray([[7 + step], [0], [300 - step], [0]], np.int32)
        dec_table = table.copy()
        dec_table[[1, 3]] = 0
        args = (dec_table, pos + step, seeds, toks)
        _pools_to_port(je.pools, te.pools)
        lj, _, je.pools = je._fwd(je.params, je.pools,
                                  *map(jnp.asarray, args))
        lt, _, _ = te._forward(te.params, te.pools,
                               *[torch.as_tensor(a, **i64) for a in args])
        errs.append(max(float(np.abs(lt[s].numpy() - np.asarray(lj)[s])
                              .max()) for s in (0, 2)))
    print(f"{kv}: max logit differences {errs}")
    assert max(errs) <= ATOL_BIN


@pytest.mark.parametrize("kv", SCHEMES)
def test_greedy_tokens_and_cache_bytes_agree(weights, kv):
    jm, jp, tm, tp = weights
    je = JaxEngine(jm, jp, _cfg(JaxServeConfig, kv, record_logits=True))
    te = Engine(tm, tp, _cfg(ServeConfig, kv, record_logits=True),
                device="cpu")
    assert te.cache_bytes() == je.cache_bytes()
    assert te.kvq.token_bytes() == je.kvq.token_bytes()
    # one bit per element plus two levels per row: d = 2 x 64 here
    nw = encode.packed_words(te.kvq.d, 1)
    assert te.kvq.token_bytes() == 2 * (4 * nw + 4 * 2)
    prompts = [_prompt(s) for s in AGREE_PROMPTS]
    jr = [je.submit(p, max_new=6) for p in prompts]
    tr = [te.submit(p, max_new=6) for p in prompts]
    jres, tres = je.run(), te.run()
    agree, total, worst = 0, 0, 0.0
    for a, b in zip(jr, tr):
        j, t = jres[a], tres[b]
        assert len(t.generated) == len(j.generated)
        total += len(j.generated)
        for i, (x, y) in enumerate(zip(j.generated, t.generated)):
            top2 = np.sort(j.logits[i])[-2:]
            if x != y:
                assert top2[1] - top2[0] < 2 * ATOL_BIN_RUN, (i, top2)
                break
            agree += 1
            worst = max(worst, float(np.abs(t.logits[i] - j.logits[i])
                                     .max()))
    print(f"greedy {kv}: {agree}/{total} tokens agree before a "
          f"divergence, max logit difference {worst}")
    assert worst <= ATOL_BIN_RUN


@pytest.mark.parametrize("kv", SCHEMES)
def test_mixed_equals_alone(weights, kv):
    """The reference's acceptance (tests/test_serve_engine.py): staggered
    arrivals in a shared batch give each request the tokens it gets
    alone."""
    _, _, tm, tp = weights
    lens = (8, 4, 12)
    prompts = [_prompt(23 + i, n) for i, n in enumerate(lens)]
    cfg = ServeConfig(kv_quant=kv, page_size=4, max_batch=3,
                      max_pages_per_seq=8, prefill_chunk=4)
    mixed = Engine(tm, tp, cfg, device="cpu")
    rids = [mixed.submit(p, max_new=5, arrival=2 * i)
            for i, p in enumerate(prompts)]
    mres = mixed.run()
    alone = Engine(tm, tp, cfg, device="cpu")
    for i, p in enumerate(prompts):
        rid = alone.submit(p, max_new=5)
        assert mres[rids[i]].generated == alone.run()[rid].generated


def test_one_bit_pages_differ_from_bf16(weights):
    """The quantized cache is in the loop: 1-bit pages do not reproduce the
    bf16 trajectory (the reference's own sanity check)."""
    _, _, tm, tp = weights
    prompt = _prompt(31)
    outs = {}
    for kv in ("bf16", "bingrad-b"):
        eng = Engine(tm, tp, _cfg(ServeConfig, kv, max_batch=1),
                     device="cpu")
        rid = eng.submit(prompt, max_new=6)
        outs[kv] = eng.run()[rid].generated
    assert outs["bf16"] != outs["bingrad-b"]
