"""RWKV-6 (rwkv6-3b) in the port against the reference: the layer's
functions in float32, then the rwkv6 ``SMOKE`` model through the helpers
of ``test_torch_ssm.py`` (same weights, tokens, bounds and reasons).

Tolerances of the functions in float32 (largest |difference| over the
largest magnitude of the reference's value):

* ``_wkv_scan`` against the reference's ``_wkv_scan``: ATOL_F32 = 1e-5
  (the port runs a shorter last chunk where the reference pads with
  log w = 0, and adds in another order); against the reference's
  step-by-step ``_wkv_scan_sequential``: ATOL_SEQ = 2e-4, as the
  reference's own ``tests/test_models_numerics.py`` holds its two forms.
* ``time_mix``, ``channel_mix_train`` and one decode step (``time_mix_
  decode`` + ``channel_mix_decode``) with its ``wkv`` state: ATOL_F32;
  the shifts a decode step returns are its own inputs, bit-equal.

The model-level bf16 checks meet one more case than jamba's. At a
sequence's first token the WKV output of a head is rank one, (r . (u *
k)) v, and where that sum is near zero the head's group norm divides by
sqrt(var + 1e-5) of a near-zero vector: a 1-ulp difference of r or k
turns its output around. The reference's per-head variance of the group
norm's input is recorded (a ``jax.debug.callback``, as
``test_torch_moe.py`` records the routing), and a token where some head
reads under GN_COND is flagged: in the last layer that token and the
next (the channel mix's token shift reads it), in an earlier one the rest
of its row (the next layers' state carries it). The
logits are held on every other token and the gradients are those of the
cross entropy over them; at most MAX_FLAGGED of the tokens may be
flagged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import blocks as jblocks
from repro.models import rwkv as jrwkv
from repro_torch.configs.base import get_config, get_smoke_config, list_archs
from repro_torch.models import LM, blocks, rwkv
from test_torch_ssm import (_err, _np, decode_matches_forward,
                            full_width_params, hold_grads, hold_logits,
                            hold_serve_caches, hold_serve_logits,
                            hold_train_step, launchers_run, model_run,
                            serve_run, train_step_run)
from test_torch_train import world1  # noqa: F401
from torch_test_env import port_test_env  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

ARCH = "rwkv6-3b"
ATOL_F32 = 1e-5
ATOL_SEQ = 2e-4
GN_EPS = 1e-5
GN_COND = 10 * GN_EPS     # the norm's gain 1/sqrt(var + eps) is over 95
MAX_FLAGGED = 0.05


# ---------------------------------------------------------------------------
# the WKV scan, float32
# ---------------------------------------------------------------------------

def _wkv_inputs(S, seed):
    """r, k, v (B, S, H, hd), log w <= 0, u (H, hd), a nonzero s0."""
    rng = np.random.default_rng(seed)
    B, H, hd = 2, 2, 8
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, S, H, hd)) - 1.0).astype(
        np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, logw, u, s0


@pytest.fixture(scope="module")
def wkv_reference():
    """The reference's chunked and sequential scans of every case, each
    jitted once."""
    out = {}
    for S in (1, 7, 50, 64):
        r, k, v, logw, u, s0 = _wkv_inputs(S, S)
        # the sequential form pads S to its chunk and steps token by token:
        # its chunk changes nothing
        seq = jax.jit(lambda r, k, v, w, u, s0: jrwkv._wkv_scan_sequential(
            r, k, v, w, u, 32, s0))(r, k, v, np.exp(logw), u, s0)
        for chunk in (4, 16, 32):
            chunked = jax.jit(lambda r, k, v, lw, u, s0: jrwkv._wkv_scan(
                r, k, v, None, u, chunk, s0, logw=lw))(r, k, v, logw, u, s0)
            out[chunk, S] = [np.asarray(a) for a in (*chunked, *seq)]
    return out


@pytest.mark.parametrize("S", [1, 7, 50, 64])
@pytest.mark.parametrize("chunk", [4, 16, 32])
def test_wkv_scan_matches(wkv_reference, chunk, S):
    r, k, v, logw, u, s0 = map(torch.from_numpy, _wkv_inputs(S, S))
    out, s_last = rwkv._wkv_scan(r, k, v, None, u, chunk, s0, logw=logw)
    jout, js, jout_seq, js_seq = wkv_reference[chunk, S]
    assert out.shape == jout.shape and s_last.shape == js.shape
    assert _err(_np(out), jout) <= ATOL_F32
    assert _err(_np(s_last), js) <= ATOL_F32
    assert _err(_np(out), jout_seq) <= ATOL_SEQ
    assert _err(_np(s_last), js_seq) <= ATOL_SEQ
    # the port's own sequential twin, and the decay given as w
    seq, s_seq = rwkv._wkv_scan_sequential(r, k, v, torch.exp(logw), u,
                                           chunk, s0)
    assert _err(_np(seq), jout_seq) <= ATOL_F32
    assert _err(_np(s_seq), js_seq) <= ATOL_F32
    out_w, _ = rwkv._wkv_scan(r, k, v, torch.exp(logw), u, chunk, s0)
    assert _err(_np(out_w), jout) <= ATOL_SEQ


def test_wkv_scan_strong_decay_stays_finite():
    """log w about -12 a token: exp(c_{t-1} - c_j) spans e^-372 within a
    chunk of 32; nothing overflows, the output is finite and within
    ATOL_SEQ of the reference's sequential form, its gradient finite."""
    r, k, v, _, u, s0 = _wkv_inputs(64, 5)
    logw = (-12.0 + 0.5 * np.random.default_rng(6).standard_normal(
        r.shape)).astype(np.float32)
    jout, js = jax.jit(lambda r, k, v, w, u, s0: jrwkv._wkv_scan_sequential(
        r, k, v, w, u, 32, s0))(r, k, v, np.exp(logw), u, s0)
    t = [torch.from_numpy(a) for a in (r, k, v, logw, u, s0)]
    t[0].requires_grad_(True)
    out, s_last = rwkv._wkv_scan(t[0], t[1], t[2], None, t[4], 32, t[5],
                                 logw=t[3])
    assert torch.isfinite(out).all() and torch.isfinite(s_last).all()
    assert _err(_np(out), np.asarray(jout)) <= ATOL_SEQ
    assert _err(_np(s_last), np.asarray(js)) <= ATOL_SEQ
    (g,) = torch.autograd.grad(out.sum(), t[0])
    assert torch.isfinite(g).all()


# ---------------------------------------------------------------------------
# the mixes, float32
# ---------------------------------------------------------------------------

def _layer_params(seed=3):
    """One rwkv6 smoke layer's float32 params, the zero / constant leaves
    drawn around their init so that every term acts."""
    cfg = get_smoke_config(ARCH)
    spec = LM(cfg).specs[0]
    p = blocks.init_layer(cfg, spec, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    for n in ("tm_mu", "w0", "ln_x", "cm_mu_k", "cm_mu_r"):
        p[n] = p[n] + torch.from_numpy(
            0.1 * rng.standard_normal(tuple(p[n].shape)).astype(np.float32))
    return cfg, p, {n: (np.asarray(t.numpy()) if not isinstance(t, dict)
                        else {m: np.asarray(u.numpy()) for m, u in t.items()})
                    for n, t in p.items()}


def test_rwkv_spec_matches():
    assert tuple(blocks.rwkv_spec(get_config(ARCH))) == tuple(
        jblocks.rwkv_spec(jget_config(ARCH)))
    assert blocks.rwkv_spec(get_config(ARCH)).chunk == 32
    assert blocks.rwkv_spec(get_config(ARCH)).num_heads == 40


def test_time_and_channel_mix_match():
    cfg, tp, jp = _layer_params()
    spec = blocks.rwkv_spec(cfg)
    jspec = jrwkv.RWKVSpec(*spec)
    x = np.random.default_rng(4).standard_normal((2, 40, cfg.d_model)).astype(
        np.float32)
    jtm, jcm = jax.jit(lambda p, x: (jrwkv.time_mix(p, x, jspec),
                                     jrwkv.channel_mix_train(p, x)))(jp, x)
    tx = torch.from_numpy(x)
    assert _err(_np(rwkv.time_mix(tp, tx, spec)), np.asarray(jtm)) <= ATOL_F32
    assert _err(_np(rwkv.channel_mix_train(tp, tx)),
                np.asarray(jcm)) <= ATOL_F32


def test_decode_step_matches():
    """One ``time_mix_decode`` + ``channel_mix_decode`` from a nonzero
    state: outputs and the new ``wkv`` within ATOL_F32, the new shifts
    bit-equal (each is its step's input)."""
    cfg, tp, jp = _layer_params(6)
    spec = blocks.rwkv_spec(cfg)
    jspec = jrwkv.RWKVSpec(*spec)
    rng = np.random.default_rng(7)
    B, D = 3, cfg.d_model
    x, h = (rng.standard_normal((B, 1, D)).astype(np.float32)
            for _ in range(2))
    st = {"wkv": rng.standard_normal((B, spec.num_heads, spec.head_dim,
                                      spec.head_dim)).astype(np.float32),
          "shift": rng.standard_normal((B, D)).astype(np.float32),
          "cm": rng.standard_normal((B, D)).astype(np.float32)}

    def jstep(p, x, h, st):
        tm, tst = jrwkv.time_mix_decode(
            p, x, {"wkv": st["wkv"], "shift": st["shift"]}, jspec)
        cm, cst = jrwkv.channel_mix_decode(p, h, {"shift": st["cm"]})
        return tm, tst, cm, cst

    jtm, jtst, jcm, jcst = jax.jit(jstep)(jp, x, h, st)
    tst_in = {k: torch.from_numpy(v) for k, v in st.items()}
    ttm, ttst = rwkv.time_mix_decode(
        tp, torch.from_numpy(x),
        {"wkv": tst_in["wkv"], "shift": tst_in["shift"]}, spec)
    tcm, tcst = rwkv.channel_mix_decode(tp, torch.from_numpy(h),
                                        {"shift": tst_in["cm"]})
    assert _err(_np(ttm), np.asarray(jtm)) <= ATOL_F32
    assert _err(_np(ttst["wkv"]), np.asarray(jtst["wkv"])) <= ATOL_F32
    assert _err(_np(tcm), np.asarray(jcm)) <= ATOL_F32
    np.testing.assert_array_equal(_np(ttst["shift"]), np.asarray(
        jtst["shift"]))
    np.testing.assert_array_equal(_np(tcst["shift"]), np.asarray(
        jcst["shift"]))
    assert set(rwkv.init_rwkv_state(B, spec, device="cpu")) == {
        "wkv", "tm_shift", "cm_shift"}


def test_norm_of_a_residual_sum_as_xla_computes_it():
    """The reference's ``rms_norm(x + y)`` in bf16 normalizes the float32
    sum (XLA drops the bf16 rounding of an add that feeds only the norm's
    cast): ``blocks._norm_of_sum`` equals it bit for bit, the norm of the
    rounded sum does not."""
    from repro.models.layers import rms_norm as jrms_norm
    from repro_torch.models.layers import rms_norm

    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(8)
    x, y = (jnp.asarray(rng.standard_normal((64, cfg.d_model)),
                        jnp.bfloat16) for _ in range(2))
    sc = jnp.asarray(0.1 * rng.standard_normal(cfg.d_model), jnp.bfloat16)
    want = np.asarray(jax.jit(lambda x, y, s: jrms_norm(
        x + y, s, cfg.norm_eps))(x, y, sc).astype(jnp.float32))
    tx, ty, ts = (torch.from_numpy(np.asarray(a.astype(jnp.float32))
                                   ).bfloat16() for a in (x, y, sc))
    got = blocks._norm_of_sum(cfg, {"scale": ts}, tx, ty)
    np.testing.assert_array_equal(_np(got), want)
    rounded = _np(rms_norm(tx + ty, ts, cfg.norm_eps))
    share = float((rounded != want).mean())
    print(f"norm of the rounded sum: {share:.3g} of the values differ")
    assert share > 0


# ---------------------------------------------------------------------------
# the smoke model
# ---------------------------------------------------------------------------

def _record_group_norm(mp, log):
    """Record the reference's smallest per-head variance of each group
    norm's input, (B, S), call by call."""
    orig = jrwkv._group_norm

    def rec(x, scale, n_heads, eps=GN_EPS):
        B, S, D = x.shape
        xh = x.reshape(B, S, n_heads, -1).astype(jnp.float32)
        var = ((xh - xh.mean(-1, keepdims=True)) ** 2).mean(-1).min(-1)
        jax.debug.callback(lambda v: log.append(np.asarray(v)), var,
                           ordered=True)
        return orig(x, scale, n_heads, eps)

    mp.setattr(jrwkv, "_group_norm", rec)


def _flag_ill_conditioned(log, B, S):
    excluded = np.zeros((B, S), bool)
    for i, var in enumerate(log):
        for b, t in np.argwhere(var < GN_COND):
            excluded[b, t:t + 2 if i == len(log) - 1 else S] = True
    return excluded


@pytest.fixture(scope="module")
def rwkv_run():
    return model_run(ARCH, record=_record_group_norm,
                     flagged=_flag_ill_conditioned)


def test_rwkv_registered_and_params_tree(rwkv_run):
    assert ARCH in list_archs()
    assert full_width_params(ARCH) == 3_099_609_600
    cfg = get_config(ARCH)
    assert (cfg.num_heads, cfg.num_kv_heads) == (0, 0)
    assert all(s.kind == "rwkv" and not s.moe for s in LM(cfg).specs)


def test_rwkv_logits_and_loss_match(rwkv_run):
    r = rwkv_run
    assert len(r["extra"]) == r["tm"].cfg.num_layers
    print(f"{ARCH}: {int(r['excluded'].sum())} of {r['excluded'].size} "
          f"tokens flagged ill-conditioned; smallest head variance by "
          f"layer {[float(v.min()) for v in r['extra']]}")
    assert r["excluded"].mean() <= MAX_FLAGGED
    hold_logits(r)


def test_rwkv_gradients_match(rwkv_run):
    assert any("tm_w2" in p for p in rwkv_run["paths"])
    hold_grads(rwkv_run)


@pytest.fixture(scope="module")
def rwkv_served():
    return serve_run(ARCH)


def test_rwkv_dense_serve_matches_reference(rwkv_served):
    hold_serve_logits(rwkv_served)


def test_rwkv_dense_serve_caches_match(rwkv_served):
    names = hold_serve_caches(rwkv_served, first_exact={"tm_shift"})
    assert names == {"wkv", "tm_shift", "cm_shift"}


def test_rwkv_decode_matches_forward():
    decode_matches_forward(ARCH)


def test_rwkv_launchers_run():
    t = launchers_run(ARCH)
    assert all(h["aux"] == 0 for h in t["history"])


def test_rwkv_train_step_matches_reference(world1, rwkv_run):
    hold_train_step(train_step_run(ARCH, rwkv_run["params"], rwkv_run["jg"]))
