"""whisper-base on the card against the CPU, at its ``SMOKE`` size: the
forward (encoder, logits, gradients), the dense decode over the warmed
cache and the training step, whose batch carries the frame embeddings.

Tests marked ``gpu`` need a CUDA device and skip without one; they import
no JAX, so they run on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_whisper_gpu.py

The model is plain PyTorch (the reference's is plain ``jnp``); on the card
its bf16 matmuls round apart from the CPU's by 1-2 ulps, and that drift
grows through the layers. Tolerances, each of the largest |difference|
over the largest magnitude of the CPU's value unless stated:

* the encoder's output, the logits, the warmed cross K/V and the served
  logits: ATOL_BF16 = 2%, the bound the CPU tests hold the port to
  against the reference;
* the gradients: GRAD_REL = 2e-2 in relative norm per leaf;
* one training step on the card (NCCL world of one) and on the CPU (a
  gloo group of it), orq-9 and BinGrad-b with error feedback: the loss
  within rtol 1e-3, and every kernel call of the card's step against the
  kernel's plain version on the same inputs: ``encode_fused``,
  ``qdq_fused`` and both decodes bit-equal, ``encode_bingrad_fused``'s
  levels bit-equal to ``kernel_order_levels`` (its order of additions)
  and its words the exact threshold of its levels.
"""
import tempfile

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_smoke_config
from repro_torch.core import prng
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import fused_bingrad as fb
from repro_torch.kernels import fused_decode as fd
from repro_torch.kernels import fused_encode as fe
from repro_torch.kernels import ops
from repro_torch.models import LM
from repro_torch.models.model import map_tree
from repro_torch.optim.schedule import constant_lr
from repro_torch.train import TrainConfig, init_state, make_train_step
from repro_torch.utils.pytree import tree_leaves

ARCH = "whisper-base"
ATOL_BF16 = 0.02
GRAD_REL = 2e-2
HELD = ("encode_fused", "qdq_fused", "encode_bingrad", "decode_fused_mean",
        "decode_fused_each")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _err(got, want):
    got, want = got.detach().float().cpu(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max())


def _inputs(seed=0, B=2, S=24):
    cfg = get_smoke_config(ARCH)
    model = LM(cfg)
    g = torch.Generator().manual_seed(seed)
    params = model.init(g, device="cpu")
    # move the zero leaves (biases, layer norm biases) off their init
    params = map_tree(lambda t: t if t.any() else 0.1 * torch.randn(
        t.shape, generator=g), params)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    enc = 0.02 * torch.randn((B, cfg.encoder.num_frames, cfg.d_model),
                             generator=g)
    return model, params, toks, enc


@pytest.mark.gpu
def test_forward_and_gradients_card_vs_cpu(cuda):
    model, params, toks, enc = _inputs()
    out = {}
    for where in ("cpu", cuda):
        p = map_tree(lambda t: t.to(where).requires_grad_(True), params)
        leaves = tree_leaves(p)
        e, t = enc.to(where), toks.to(where)
        with torch.no_grad():
            enc_out = model.encode(p, e)
        lg, _ = model.logits(p, t, enc_embeds=e)
        loss, _ = model.loss(p, {"tokens": t, "enc_embeds": e})
        grads = torch.autograd.grad(loss, leaves)
        out[str(where)] = (enc_out, lg, loss, grads)
    (we, wl, wloss, wg), (ge, gl, gloss, gg) = out["cpu"], out[str(cuda)]
    assert _err(ge, we) <= ATOL_BF16
    assert _err(gl, wl) <= ATOL_BF16
    assert abs(float(gloss.detach()) - float(wloss.detach())) <= 1e-3 * abs(
        float(wloss.detach()))
    for g, w in zip(gg, wg, strict=True):
        rel = float((g.cpu() - w).norm() / max(float(w.norm()), 1e-30))
        assert rel <= GRAD_REL


@pytest.mark.gpu
def test_warm_cache_and_decode_card_vs_cpu(cuda):
    model, params, toks, enc = _inputs(1, S=12)
    bf = map_tree(lambda t: t.to(torch.bfloat16), params)
    runs = {}
    for where in ("cpu", cuda):
        p = map_tree(lambda t: t.to(where), bf)
        cache = model.init_cache(2, 32, device=where)
        cache = model.warm_cache(p, cache, enc.to(torch.bfloat16).to(where))
        xkv = (cache[0]["pos0"]["xk"].clone(), cache[0]["pos0"]["xv"].clone())
        lg, cache = model.prefill_chunk(p, cache, toks[:, :8].to(where), 0)
        steps = [lg[:, -1]]
        for i in range(8, 12):
            lg, cache = model.decode_step(p, cache, toks[:, i:i + 1].to(
                where), i)
            steps.append(lg[:, 0])
        runs[str(where)] = (xkv, steps, cache)
    (wx, ws, wc), (gx, gs, gc) = runs["cpu"], runs[str(cuda)]
    for g, w in zip(gx, wx):
        assert _err(g, w) <= ATOL_BF16
    for g, w in zip(gs, ws):
        assert _err(g, w) <= ATOL_BF16
    # the decode reads the cross K/V and leaves them as warmed
    assert torch.equal(gc[0]["pos0"]["xk"], gx[0])


def _record(calls):
    origs = {n: getattr(ops, n) for n in HELD}

    def recorder(name, orig):
        def rec(*args, **kw):
            calls.append((name, tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args), dict(kw)))
            return orig(*args, **kw)
        return rec

    for n, f in origs.items():
        setattr(ops, n, recorder(n, f))
    return lambda: [setattr(ops, n, f) for n, f in origs.items()]


def _hold_call(name, args, kw):
    """One recorded call: the kernel against its plain version."""
    if name in ("encode_fused", "qdq_fused"):
        v, lv, rb, mask = args
        a = (v, lv, rb, mask, fe.clip_limit(v, mask, kw.get("clip_c")))
        if name == "encode_fused":
            k = dict(bits=kw["bits"], mode=kw.get("mode", "rr"))
            return torch.equal(fe.encode_fused_cuda(*a, **k),
                               fe.encode_fused_plain(*a, **k))
        k = dict(mode=kw.get("mode", "rr"))
        return torch.equal(fe.qdq_fused_cuda(*a, **k).view(torch.int32),
                           fe.qdq_fused_plain(*a, **k).view(torch.int32))
    if name == "encode_bingrad":
        v, mask = args
        lim = fe.clip_limit(v, mask, kw.get("clip_c"))
        li = kw.get("lloyd_iters", 0)
        words, lv = fb.encode_bingrad_fused_cuda(v, mask, lim,
                                                 lloyd_iters=li)
        order = fb.kernel_order_levels(v, mask, lim, lloyd_iters=li)
        own = fe.encode_fused_plain(v, lv, None, mask, lim, bits=1,
                                    mode="bin")
        return (torch.equal(lv.view(torch.int32), order.view(torch.int32))
                and torch.equal(words, own))
    words, lv, d = args
    cuda, plain = ((fd.decode_fused_mean_cuda, fd.decode_fused_mean_plain)
                   if name == "decode_fused_mean" else
                   (fd.decode_fused_each_cuda, fd.decode_fused_each_plain))
    k = dict(d=d, bits=kw["bits"])
    return torch.equal(cuda(words, lv, **k), plain(words, lv, **k))


@pytest.fixture(scope="module")
def nccl_world():
    """A NCCL world of one (file store) and a gloo group of it; a running
    process group of another module is used as it is."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    created = not dist.is_initialized()
    if created:
        torch.cuda.set_device(0)
        tmp = tempfile.mkdtemp(prefix="repro_torch_gpu_world_")
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
    gloo = dist.new_group(ranks=[0], backend="gloo")
    yield gloo
    dist.destroy_process_group(gloo)
    if created:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["orq-9", "bingrad-b"])
def test_train_step_card_vs_cpu_and_kernel_calls(nccl_world, scheme):
    torch.backends.cuda.matmul.allow_tf32 = False
    model, _, toks, enc = _inputs(2, S=32)
    tcfg = TrainConfig(policy=QuantPolicy.parse(scheme, bucket_size=512),
                       error_feedback=True)
    losses, calls = {}, []
    for where, group in (("cpu", nccl_world), ("cuda", None)):
        fn = make_train_step(model, tcfg, constant_lr(0.05), group=group)
        state = init_state(model, tcfg, seed=0, device=where, step=fn)
        batch = {"tokens": toks.to(where), "enc_embeds": enc.to(where)}
        state, m = fn(state, batch, prng.key(0, device=where))
        restore = _record(calls) if where == "cuda" else (lambda: None)
        try:
            state, m = fn(state, batch, prng.key(1, device=where))
        finally:
            restore()
        losses[where] = float(m["loss"])
        assert fn.launches_and_bytes(1)[0] == 4
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-3 * abs(losses["cpu"])
    names = [c[0] for c in calls]
    assert "decode_fused_mean" in names and "qdq_fused" in names
    bad = [n for n, a, k in calls if not _hold_call(n, a, k)]
    assert not bad, bad
