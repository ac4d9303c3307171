"""The dense GQA and sliding-window architectures in the port against the
reference, at their ``SMOKE`` sizes: qwen1.5 (QKV bias), command-r+ (GQA),
chameleon (qk-norm), gemma2 (alternating local / global layers, both
softcaps, gelu, tied and scaled embeddings) and gemma3 (5:1 local /
global, a local rope theta, qk-norm).

Both packages run the same weights: the port's ``LM.init`` (whose tree is
checked against the reference's ``init`` by path and shape), with every
norm scale and bias drawn away from its zero init so that QKV bias and
qk-norm act, handed to the reference as jnp arrays.

Tolerances, with their reasons:

* The attention function alone, in float32: the online softmax adds its
  chunks in the reference's order, but the exp and the einsums round at
  other places in XLA and PyTorch: ``atol 2e-5``.
* Logits of the bf16 forward: bf16 matmuls round differently in XLA and
  PyTorch (1-2 bf16 ulps, as in ``test_torch_serve.py``): ``atol
  ATOL_BF16`` of the logits' largest magnitude.
* Gradients of the bf16 forward: within 2e-2 in relative norm per leaf,
  the bound of ``test_torch_train.py``.
* The paged orq-9 serve of gemma2 against the reference engine, as
  ``test_torch_serve.py`` holds lm-100m: one forward's logits within 0.25
  from equal pools (the ulps above move a few 4-bit rounding decisions of
  the second layer). Over each engine's own greedy run the logits here
  are about 1 in magnitude (random weights under the final softcap) and
  drift by up to ~0.04: held within 0.1, with the tokens equal wherever
  the reference's top-2 margin exceeds 0.2, up to where the runs part.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.models import LM as JLM
from repro.models import attention as jattn
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs.base import get_smoke_config, list_archs
from repro_torch.convert import params_from_jax
from repro_torch.models import LM
from repro_torch.models import attention as tattn
from repro_torch.serve import Engine, ServeConfig
from repro_torch.utils.pytree import tree_flatten_with_path, tree_leaves
from test_torch_serve import _pools_to_port
from torch_test_env import port_test_env  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["qwen1.5-32b", "command-r-plus-104b", "chameleon-34b", "gemma2-9b",
         "gemma3-27b"]
ATOL_ATTN = 2e-5
ATOL_BF16 = 0.02          # of the logits' largest magnitude
GRAD_REL = 2e-2
ATOL_ORQ = 0.25
ATOL_ORQ_RUN = 0.1
SEQ = 64
LONG_SEQ = 128            # above gemma2's smoke window of 32


def _np(t):
    return t.detach().float().numpy()


def _weights(arch, cfg=None, seed=0):
    """(reference model, its params, port model, port params) from one
    port init; the leaves it inits to zero (norm scales, biases) are
    drawn from N(0, 0.1^2) instead."""
    tcfg = cfg or get_smoke_config(arch)
    jcfg = dataclasses.replace(jget_smoke_config(arch),
                               **{f.name: getattr(tcfg, f.name)
                                  for f in dataclasses.fields(tcfg)})
    tm, jm = LM(tcfg), JLM(jcfg)
    tp = tm.init(torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    flat, treedef = tree_flatten_with_path(tp)
    np_leaves = []
    for _, t in flat:
        a = t.numpy()
        if not a.any():
            a = 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        np_leaves.append(a)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    jflat = jax.tree_util.tree_leaves_with_path(shapes)
    assert ([jax.tree_util.keystr(p) for p, _ in jflat]
            == [p for p, _ in flat])
    assert [tuple(s.shape) for _, s in jflat] == [a.shape for a in np_leaves]
    jtreedef = jax.tree_util.tree_structure(shapes)
    jp = jax.tree_util.tree_unflatten(jtreedef,
                                      [jnp.asarray(a) for a in np_leaves])
    return jm, jp, tm, params_from_jax(
        jax.tree_util.tree_unflatten(jtreedef, np_leaves), device="cpu")


def _tokens(seed, B=2, S=SEQ, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_registered_and_smoke_logits_match(arch):
    assert arch in list_archs()
    jm, jp, tm, tp = _weights(arch)
    toks = _tokens(1)
    jl, _ = jax.jit(jm.logits)(jp, jnp.asarray(toks))
    tl, _ = tm.logits(tp, torch.from_numpy(toks).long())
    jl = np.asarray(jl)
    assert tl.shape == jl.shape
    np.testing.assert_allclose(_np(tl), jl, rtol=0,
                               atol=ATOL_BF16 * np.abs(jl).max())


@pytest.mark.parametrize("S,window,chunk", [
    (LONG_SEQ, 32, 16),     # banded: 3 of 8 chunks a query chunk
    (LONG_SEQ, 32, 64),     # banded, the smoke config's chunks
    (LONG_SEQ, None, 32),   # full causal
    (120, 40, 16),          # banded, a ragged last chunk: 4 chunks visited
])
def test_chunked_attention_matches(S, window, chunk):
    """The attention function alone in float32, with a softcap and GQA."""
    rng = np.random.default_rng(S + chunk)
    B, H, KV, hd = 2, 4, 2, 16
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    spec = dict(num_heads=H, num_kv_heads=KV, head_dim=hd, window=window,
                attn_softcap=50.0, q_chunk=chunk, kv_chunk=chunk)
    ref = np.asarray(jax.jit(
        lambda *a: jattn.chunked_attention(*a, jattn.AttnSpec(**spec)))(
        q, k, v))
    out = tattn.chunked_attention(
        *map(torch.from_numpy, (q, k, v)), tattn.AttnSpec(**spec))
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=ATOL_ATTN)


def test_banded_scan_refuses_unequal_chunks():
    spec = tattn.AttnSpec(num_heads=2, num_kv_heads=2, head_dim=8, window=8,
                          q_chunk=16, kv_chunk=8)
    x = torch.zeros((1, 32, 2, 8))
    with pytest.raises(ValueError, match="equal q/kv chunk"):
        tattn.chunked_attention(x, x, x, spec)


def test_gemma2_long_sequence_logits_and_grads():
    """S = 128 above the window of 32, chunks of 16: the local layer's
    banded scan visits 3 of 8 KV chunks a query chunk, forward and
    backward (the smoke config's chunks of 64: the attention test)."""
    cfg = dataclasses.replace(get_smoke_config("gemma2-9b"), q_chunk=16,
                              kv_chunk=16)
    jm, jp, tm, tp = _weights("gemma2-9b", cfg, seed=2)
    toks = _tokens(3, S=LONG_SEQ + 1)
    jl, _ = jax.jit(jm.logits)(jp, jnp.asarray(toks[:, :-1]))
    tl, _ = tm.logits(tp, torch.from_numpy(toks[:, :-1]).long())
    jl = np.asarray(jl)
    np.testing.assert_allclose(_np(tl), jl, rtol=0,
                               atol=ATOL_BF16 * np.abs(jl).max())
    (jloss, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {"tokens": jnp.asarray(toks)})
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tloss, _ = tm.loss(tp, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-3)
    for g, w in zip(grads, jax.tree_util.tree_leaves(jg), strict=True):
        w = np.asarray(w)
        assert np.linalg.norm(g.numpy() - w) <= GRAD_REL * np.linalg.norm(w)


# ---------------------------------------------------------------------------
# the paged quantized-KV serve of gemma2 (windowed, softcapped)
# ---------------------------------------------------------------------------

PROMPTS = (201, 202)
PROMPT_LEN = 40           # above the window of 32


def _serve_cfg(cls):
    return cls(kv_quant="orq-9", page_size=8, max_batch=2,
               max_pages_per_seq=8, prefill_chunk=16, record_logits=True)


@pytest.fixture(scope="module")
def gemma2_serve():
    jm, jp, tm, tp = _weights("gemma2-9b", seed=4)
    bf16 = lambda x: x.astype(jnp.bfloat16)              # noqa: E731
    jp = jax.tree_util.tree_map(bf16, jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    je = JEngine(jm, jp, _serve_cfg(JServeConfig))
    te = Engine(tm, tp, _serve_cfg(ServeConfig), device="cpu")
    return je, te


def _prompt(seed):
    return _tokens(seed, B=1, S=PROMPT_LEN)[0]


def test_gemma2_serve_forward_from_equal_pools(gemma2_serve):
    """The first prefill chunks of a 40-token prompt through both engines'
    forward, the port's pools copied from the reference's before each."""
    je, te = gemma2_serve
    table = np.zeros((2, 8), np.int32)
    table[0, :6] = np.arange(1, 7)
    seeds = np.asarray([77], np.int32)
    toks = _prompt(PROMPTS[0])
    for start in range(0, PROMPT_LEN, 16):
        chunk = np.zeros((1, 16), np.int32)
        part = toks[start:start + 16]
        chunk[0, :len(part)] = part
        args = (table[:1], np.asarray([start], np.int32), seeds, chunk)
        _pools_to_port(je.pools, te.pools)
        lj, _, je.pools = je._fwd(je.params, je.pools,
                                  *map(jnp.asarray, args))
        lt, _, _ = te._forward(te.params, te.pools,
                               *[torch.as_tensor(a, dtype=torch.int64)
                                 for a in args])
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=ATOL_ORQ)


def test_gemma2_serve_greedy_runs_agree(gemma2_serve):
    je, te = gemma2_serve
    jr = [je.submit(_prompt(s), max_new=6) for s in PROMPTS]
    tr = [te.submit(_prompt(s), max_new=6) for s in PROMPTS]
    jres, tres = je.run(), te.run()
    held = 0
    for a, b in zip(jr, tr):
        j, t = jres[a], tres[b]
        for jt, tt, jl, tl in zip(j.generated, t.generated, j.logits,
                                  t.logits):
            np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL_ORQ_RUN)
            top2 = np.sort(np.asarray(jl).reshape(-1))[-2:]
            if top2[1] - top2[0] > 2 * ATOL_ORQ_RUN:
                assert tt == jt
                held += 1
            if tt != jt:
                break                  # parted at a near-tie
    print(f"gemma2 orq-9 greedy tokens held: {held}")
    assert held > 0
