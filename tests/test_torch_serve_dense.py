"""The port's dense ring-buffer serve path (``LM.init_cache`` /
``decode_step`` / ``prefill_chunk`` / ``prefill`` and the launcher's
dense path) against the JAX reference.

Both packages start from the same weights (the reference's smoke
``LM.init``, cast to bf16 as its launcher does, carried over with
``params_from_jax``). Tolerances, as in ``test_torch_serve.py``: bf16
matmuls round differently in XLA and PyTorch (1-2 bf16 ulps), so the
logits agree within ATOL_BF16 = 0.06 and the caches within a few bf16
ulps of their magnitude; the ``pos`` arrays and the cache layout agree
exactly. Greedy tokens of a random-weight model have top-2 margins down
to ~0.01, so both packages are fed the reference's greedy tokens, and
their picks must agree wherever the reference's margin exceeds twice
ATOL_BF16.

Within the port, exactly as the reference's own ``tests/
test_serve_engine.py`` holds the reference:

* ``prefill_chunk`` fills the same cache bytes as the sequential decode
  loop, with logits within 2e-5 and the same greedy token (its
  ``test_matches_sequential_decode``);
* the bf16 paged engine is greedy-identical to the dense decode loop at
  equal context (its ``test_bf16_paged_matches_dense_decode_greedy``).

A second configuration (GQA with 2 KV heads, a sliding-window layer of
window 4 beside a global one, a cache of 8 slots) runs past the end of
the ring, so the slot ``pos % C``, the ``pos`` array that starts at -1
and the window mask are held against the reference too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.models import LM as JLM
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import LM
from repro_torch.serve import Engine, ServeConfig
from repro_torch.utils.pytree import tree_leaves
from torch_test_env import port_test_env  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

ATOL_BF16 = 0.06
CACHE_RTOL = 2 ** -6          # a few bf16 ulps of the cache's magnitude
PROMPT_SEEDS = (101, 103)
#: GQA, a sliding-window layer beside a global one
LOCAL = dict(layer_pattern=("attn_local", "attn"), window=4, num_kv_heads=2)


def _prompt(seed, n=8, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def _models(variant):
    jcfg, cfg = jget_smoke_config("lm-100m"), get_smoke_config("lm-100m")
    if variant == "local":
        jcfg = dataclasses.replace(jcfg, **LOCAL)
        cfg = dataclasses.replace(cfg, **LOCAL)
    jm = JLM(jcfg)
    jp = jax.jit(jm.init)(jax.random.key(0))
    jp = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jm, jp, LM(cfg), tp


@pytest.fixture(scope="module")
def weights():
    return _models("global")


@pytest.fixture(scope="module")
def local_weights():
    return _models("local")


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _decode_both(w, tokens, max_len, steps):
    """Decode through both packages: the prompt token by token, then
    ``steps`` tokens the reference picks greedily, fed to both (so a
    near-tie that one package breaks the other way changes no input)."""
    jm, jp, tm, tp = w
    B, S = tokens.shape
    jc = jm.init_cache(B, max_len)
    tc = tm.init_cache(B, max_len, device="cpu")
    jstep = jax.jit(jm.decode_step)
    logits, tok = [], tokens[:, :1]
    for i in range(S + steps):
        if i < S:
            tok = tokens[:, i:i + 1]
        jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.int32(i))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), i)
        logits.append((np.asarray(jl), tl.numpy()))
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)[:, None]).astype(
            np.int32)
    return logits, jc, tc


def _hold_logits(logits):
    """Every step within ATOL_BF16; the greedy pick equal wherever the
    reference's top-2 margin exceeds twice that (no tie to break)."""
    for jl, tl in logits:
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL_BF16)
        top2 = np.sort(jl[:, -1], axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * ATOL_BF16
        np.testing.assert_array_equal(tl[:, -1].argmax(-1)[clear],
                                      jl[:, -1].argmax(-1)[clear])


def _hold_caches(tc, jc):
    for g, w in zip(tree_leaves(tc), jax.tree_util.tree_leaves(jc),
                    strict=True):
        g, w = _np(g), _jnp(w)
        if w.dtype == np.int32:                     # the pos arrays
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=CACHE_RTOL * np.abs(w).max())


def test_init_cache_layout_matches_reference(weights, local_weights):
    for jm, _, tm, _ in (weights, local_weights):
        want = jax.tree_util.tree_leaves(jm.init_cache(3, 16))
        got = tree_leaves(tm.init_cache(3, 16, device="cpu"))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_array_equal(_np(g), _jnp(w))


@pytest.mark.parametrize("seed", PROMPT_SEEDS)
def test_decode_step_matches_reference(weights, seed):
    tokens = np.stack([_prompt(seed), _prompt(seed + 1)])
    logits, jc, tc = _decode_both(weights, tokens, 16, 6)
    assert logits[0][1].shape == (2, 1, 512)
    _hold_logits(logits)
    _hold_caches(tc, jc)


def test_ring_wrap_and_window_match_reference(local_weights):
    """8 cache slots (4 on the window layer), 8 prompt tokens then 6
    generated: the ring wraps on both layers."""
    tokens = np.stack([_prompt(7), _prompt(8)])
    logits, jc, tc = _decode_both(local_weights, tokens, 8, 6)
    _hold_logits(logits)
    assert tc[0]["pos0"]["k"].shape[2] == 4            # window slots
    assert int(tc[0]["pos0"]["pos"].min()) == 10       # wrapped
    _hold_caches(tc, jc)


@pytest.mark.parametrize("variant", ["global", "local"])
def test_prefill_chunk_matches_reference(weights, local_weights, variant):
    """One chunk of 8 from position 0, then a chunk of 4 from 8: logits
    and the filled cache against the reference's ``prefill_chunk``."""
    jm, jp, tm, tp = weights if variant == "global" else local_weights
    tokens = np.stack([_prompt(11, 12), _prompt(12, 12)])
    C = 16
    if variant == "local":
        tm = LM(dataclasses.replace(tm.cfg, window=C))
        jm = JLM(dataclasses.replace(jm.cfg, window=C))
    jc = jm.init_cache(2, C)
    tc = tm.init_cache(2, C, device="cpu")
    for a, b in ((0, 8), (8, 12)):
        jl, jc = jm.prefill_chunk(jp, jc, jnp.asarray(tokens[:, a:b]),
                                  jnp.int32(a))
        tl, tc = tm.prefill_chunk(tp, tc, torch.from_numpy(tokens[:, a:b]),
                                  a)
        assert tl.shape == jl.shape == (2, b - a, 512)
        _hold_logits([(np.asarray(jl), tl.numpy())])
    _hold_caches(tc, jc)


@pytest.mark.parametrize("variant", ["global", "local"])
def test_prefill_chunk_fills_same_cache_as_decode(weights, local_weights,
                                                  variant):
    """The reference's ``test_matches_sequential_decode`` on the port."""
    _, _, tm, tp = weights if variant == "global" else local_weights
    if variant == "local":       # chunked prefill needs the whole window
        tm = LM(dataclasses.replace(tm.cfg, window=16))
    assert tm.supports_chunked_prefill()
    B, S, C, chunk = 2, 8, 16, 4
    toks = torch.from_numpy(np.stack([_prompt(3 + b, S) for b in range(B)]))
    seq = tm.init_cache(B, C, device="cpu")
    lg_seq, seq = tm.prefill(tp, seq, toks)
    chk = tm.init_cache(B, C, device="cpu")
    for off in range(0, S, chunk):
        lg_chk, chk = tm.prefill_chunk(tp, chk, toks[:, off:off + chunk],
                                       off)
    for a, b in zip(tree_leaves(seq), tree_leaves(chk)):
        assert torch.equal(a, b)
    np.testing.assert_allclose(lg_seq[:, -1].numpy(), lg_chk[:, -1].numpy(),
                               rtol=2e-5, atol=2e-5)
    assert torch.equal(lg_seq[:, -1].argmax(-1), lg_chk[:, -1].argmax(-1))


@pytest.mark.parametrize("seed", (17,) + PROMPT_SEEDS)
def test_bf16_paged_matches_dense_decode_greedy(weights, seed):
    """The reference's ``test_bf16_paged_matches_dense_decode_greedy`` on
    the port: the bf16 escape hatch is greedy-identical to the dense
    decode loop at equal context."""
    _, _, tm, tp = weights
    S, gen = 8, 4
    prompt = _prompt(seed, S)
    cfg = ServeConfig(kv_quant="bf16", page_size=4, max_batch=1,
                      max_pages_per_seq=4, prefill_chunk=4)
    eng = Engine(tm, tp, cfg, device="cpu")
    rid = eng.submit(prompt, max_new=gen)
    got = eng.run()[rid].generated
    cache = tm.init_cache(1, cfg.max_context, device="cpu")
    lg, cache = tm.prefill(tp, cache, torch.from_numpy(prompt[None]))
    want = [int(lg[0, -1].argmax())]
    for i in range(gen - 1):
        lg, cache = tm.decode_step(tp, cache, torch.tensor([[want[-1]]]),
                                   S + i)
        want.append(int(lg[0, -1].argmax()))
    assert got == want


def test_launcher_dense_path_runs_and_agrees_with_paged():
    """``launch.serve`` without ``--kv-quant`` (chunked prefill, and the
    token loop) gives the bf16 paged engine's greedy tokens."""
    from repro_torch.launch import serve as launcher
    base = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
            "8", "--gen", "4", "--max-len", "32"]
    chunked = launcher.serve(base + ["--prefill-chunk", "4"])
    loop = launcher.serve(base)
    paged = launcher.serve(base + ["--prefill-chunk", "4", "--kv-quant",
                                   "bf16", "--page-size", "4"])
    assert chunked["path"] == loop["path"] == "dense"
    assert chunked["forward_calls"] == 2 + 2 + 3     # warm-up, prefill, gen
    assert loop["forward_calls"] == 1 + 8 + 3
    for r in (chunked, loop):
        np.testing.assert_array_equal(r["tokens"], paged["tokens"])
        assert r["sha256"] == paged["sha256"]
        assert r["cache_bytes"] == 2 * (2 * (2 * 32 * 4 * 32 * 2) + 32 * 4)
        assert r["token_bytes"] == 2 * 4 * 32 * 2
        assert r["step_p50_ms"] > 0 and r["decode_tok_s"] > 0
